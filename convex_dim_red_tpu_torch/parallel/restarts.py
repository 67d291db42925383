"""Best-of-``n_init`` archetypal analysis and GPNH convex coding.

Port of the single-device grouped paths of
convex_dim_red_tpu/parallel/restarts.py.  The initial states of all
restarts are drawn at once on the device (random, or picked by
FurthestSum from one start index per restart), and the weights QPs of
every restart in a batch are solved in one grouped call per iteration
(:func:`_aa_grouped_iterate`, :func:`_gpnh_grouped_iterate`), with each
restart frozen once it has converged (``sharded_aa._keep_best_loop``).
One scheduler drives the batch, :func:`_compacted_best`: restarts run
in rounds of M iterations, after each of which the converged ones retire
and the survivors are re-packed into dense chunks of ``restart_chunk``.
``compact_iterations=M`` sets the round; the default
(``compact_iterations=None``, the JAX package's one-shot grouped runner)
runs rounds of :data:`_ONE_SHOT_ROUND`.  Every restart follows the
trajectory of one unchunked fit, so both settings give the JAX
one-shot runner's results restart for restart, and the fit stops once
every restart is done, as that runner's loop does.  The host reads only
per-round scalars.

Screening, padded ``k``, ``kernel_aa_fit_restarts`` and meshes are later
slices of the port (ROADMAP.md, queue 1, items 11 and 17); the vmapped
per-restart path (``grouped=False``) is not ported (item 18).
"""

import numpy as np
import torch

from ..models._common import (QPSolverConfig, SPGSolverConfig,
                              STOPPING_CRITERIA, _reject_mesh, make_config)
from ..models.archetypal_analysis import (_cost_from_parts, _scalar_dtype,
                                          _spg_cfg_to_quad_kwargs)
from ..models.gpnh_convex_coding import (_SCALAR_DTYPE as _GPNH_SDT,
                                         _cost_from_parts as
                                         _gpnh_cost_from_parts,
                                         _gpnh_gram, gpnh_regularization,
                                         update_gpnh_dictionary)
from ..ops.furthest_sum import (dissimilarities_from_kernel,
                                furthest_sum_device)
from ..ops.simplex_projection import simplex_project_rows
from ..ops.stochastic_matrices import right_stochastic_matrix
from ..solvers.spg import (quad_simplex_spg_batch_grouped, quad_spg,
                           resolve_qp_backend)
from ..utils.precision import apply_matmul_precision
from ..utils.validation import as_input
from .sharded_aa import _keep_best_loop

__all__ = ["aa_fit_restarts", "gpnh_fit_restarts"]

#: Iterations a round under ``compact_iterations=None``: the JAX
#: package's one-shot runner reads no scalar until every restart is
#: done; here the host reads the round's scalars once every 32.
_ONE_SHOT_ROUND = 32


def _init_aa_state(generator, n_init, delta, *, n_samples, n_components,
                   init, diss, n_extra_steps, do_scale, dtype, device):
    """Initial states of ``n_init`` restarts: row-stochastic
    ``Z (R, n, k)``, ``C (R, k, n)`` and ``alpha (R, k)`` uniform in
    ``[1 - delta, 1 + delta]`` (ones without scale factors).  With
    ``init='furthest_sum'`` each restart draws a start index and ``C``
    is one-hot on the samples that :func:`furthest_sum_device` picks
    from the dissimilarities ``diss``; with ``'random'`` ``C`` is
    random.  Matches the JAX package's ``_init_aa_state`` in
    distribution."""
    if init == 'furthest_sum':
        starts = torch.randint(0, n_samples, (n_init,),
                               generator=generator,
                               device=generator.device).to(device)
        selected = furthest_sum_device(diss, n_components, starts,
                                       extra_steps=n_extra_steps)
        C = torch.nn.functional.one_hot(selected, n_samples).to(dtype)
    else:
        C = right_stochastic_matrix(
            generator, (n_init, n_components, n_samples), dtype=dtype,
            device=device)
    Z = right_stochastic_matrix(generator, (n_init, n_samples, n_components),
                                dtype=dtype, device=device)
    if do_scale:
        u = torch.rand((n_init, n_components), generator=generator,
                       dtype=dtype, device=generator.device).to(device)
        alpha = (1.0 - delta) + 2.0 * delta * u
    else:
        alpha = torch.ones((n_init, n_components), dtype=dtype,
                           device=device)
    return Z, C, alpha


def _aa_grouped_iterate(X, K, *, delta, do_scale, has_data, dict_kwargs,
                        weights_backend, weights_kwargs, scale_kwargs,
                        trace_K):
    """Restart-batched AA alternating iterate with the weights QP
    grouped across restarts.

    Every operand carries the restart axis first.  Per iteration, in the
    reference's order: the scale factors (with ``do_scale``, a
    :func:`quad_spg` over a box), the dictionary (one
    :func:`quad_spg` step batch over the simplex rows of ``C``), then
    the weights QPs of all restarts in one
    :func:`quad_simplex_spg_batch_grouped` call, then the cost.

    ``has_data``: ``X`` is the data and the cost is the residual form
    ``0.5 ||Z diag(alpha) C X - X||^2 / n`` (reliable in float32);
    otherwise the cost is the trace form from ``trace_K``.

    Returns ``(iterate, cost0)``: ``iterate(Zs, Cs, alphas) -> (Zs, Cs,
    alphas, costs)`` and ``cost0(Zs, Cs, alphas)``, the initial costs.
    """
    n_samples = K.shape[0]
    sdt = _scalar_dtype(K.dtype)

    def pre(Z, C, alpha):
        ZtZ = Z.transpose(1, 2) @ Z
        KZ = K @ Z
        if do_scale:
            CK0 = C @ K
            CKZ = CK0 @ Z
            CKCt0 = CK0 @ C.transpose(1, 2)
            M = ZtZ * CKCt0

            def project(a):
                return torch.clamp(a, 1.0 - delta, 1.0 + delta)

            alpha = quad_spg(
                lambda a: (M @ a[:, :, None])[:, :, 0] / n_samples,
                torch.diagonal(CKZ, dim1=1, dim2=2) / n_samples, alpha,
                project, **scale_kwargs)
        KZD = KZ * alpha[:, None, :]
        DZtZD = (alpha[:, :, None] * ZtZ) * alpha[:, None, :]
        C = quad_spg(lambda Cm: DZtZD @ (Cm @ K) / n_samples,
                     KZD.transpose(1, 2) / n_samples, C,
                     simplex_project_rows, **dict_kwargs)
        CK = C @ K
        CKCt = CK @ C.transpose(1, 2)
        A = (alpha[:, :, None] * CKCt) * alpha[:, None, :]
        Bw = -(alpha[:, :, None] * CK).transpose(1, 2)
        return C, alpha, A, Bw, CK, CKCt

    def cost_of(Z, C, alpha, CK, CKCt):
        if has_data:
            CX = C @ X
            resid = Z @ (alpha[:, :, None] * CX)
            # In place: the (R, n, d) residual is the largest buffer of
            # the fit.
            resid -= X
            resid.square_()
            return (0.5 * torch.sum(resid, dim=(1, 2))
                    / n_samples).to(sdt)
        CKZ = CK @ Z
        ZtZ = Z.transpose(1, 2) @ Z
        return _cost_from_parts(trace_K, CKZ, ZtZ, CKCt, alpha, n_samples)

    def iterate(Zs, Cs, alphas):
        Cs, alphas, As, Bws, CKs, CKCts = pre(Zs, Cs, alphas)
        Zs = quad_simplex_spg_batch_grouped(
            As, Bws, Zs, backend=weights_backend, **weights_kwargs)
        costs = cost_of(Zs, Cs, alphas, CKs, CKCts)
        return Zs, Cs, alphas, costs

    def cost0(Zs, Cs, alphas):
        CK = Cs @ K
        return cost_of(Zs, Cs, alphas, CK, CK @ Cs.transpose(1, 2))

    return iterate, cost0


def _grouped_solver_kwargs(dict_cfg, weights_cfg, scale_cfg):
    return (_spg_cfg_to_quad_kwargs(dict_cfg), weights_cfg.kwargs(),
            _spg_cfg_to_quad_kwargs(scale_cfg))


def _prepare_grouped(X, has_data, K):
    """The data operand of the residual-form cost and ``trace K`` for
    the trace form.  ``K`` is the Gram, computed once per fit (or the
    kernel itself when ``not has_data``)."""
    data = X if has_data else None
    trace_K = None if has_data else torch.trace(K).to(_scalar_dtype(K.dtype))
    return K, data, trace_K


@apply_matmul_precision
def _gram_once(X):
    """``X X'``, once per fit, under the library's matmul precision."""
    return X @ X.T


def _round_run(iterate, cost0, *, tolerance, criterion):
    """One bounded compaction round of a restart family's grouped
    iterate.

    Returns ``run(states_all, idx, max_iterations) -> (states_all,
    costs, trace, n_iters, done)``: it gathers the chunk ``idx`` from the
    population tensors, advances it up to ``max_iterations`` iterations
    under ``sharded_aa._keep_best_loop``, and scatters the states back
    in place.  Nothing in a round waits on the host.  Duplicate indices
    (a tiled tail chunk) compute identical trajectories, so the scatter
    writes equal values.
    """
    def run(states_all, idx, max_iterations):
        states = tuple(s[idx] for s in states_all)
        states, costs, trace, n_iters, done = _keep_best_loop(
            states, cost0(*states), iterate, tolerance=tolerance,
            criterion=criterion, max_iterations=max_iterations)
        for s_all, s in zip(states_all, states):
            s_all[idx] = s
        return states_all, costs, trace, n_iters, done

    return run


def _compacted_best(R, states_all, *, max_iterations, restart_chunk,
                    round_iterations, round_call):
    """Convergence-compaction scheduler over a restart population.

    Restarts run in rounds of ``round_iterations``; after each round the
    converged ones retire with their final state and the survivors are
    re-packed into chunks of ``restart_chunk``, so the batch width
    tracks the population that still needs work.  Each restart follows
    the same state-resuming chain as one unchunked fit, so the results
    match it restart for restart.

    ``round_call(states_all, idx, M) -> (states_all, costs, trace,
    n_iters, done)`` runs one round of ``M`` iterations on the chunk
    ``idx`` (a device tensor; :func:`_round_run`).  All chunks of a
    round are queued before any result is read; the host then reads
    each chunk's scalars once.

    Returns ``(states_all, costs, n_iters, traces, best)`` with ``best``
    the argmin-cost restart and ``traces[i]`` restart ``i``'s list of
    cost-delta segments.
    """
    device = states_all[0].device
    chunk = min(int(restart_chunk or R), R)
    M = int(round_iterations)

    costs = np.full((R,), np.inf)
    n_iters = np.zeros((R,), np.int64)
    traces = [[] for _ in range(R)]

    pending = list(range(R))
    used = 0
    while pending and used < max_iterations:
        M_round = min(M, max_iterations - used)
        outs = []
        for w in range(0, len(pending), chunk):
            # Tile the tail so every chunk has the same width; duplicate
            # rows recompute the same trajectory and are skipped below.
            idx_np = np.resize(np.asarray(pending[w:w + chunk]), chunk)
            idx = torch.as_tensor(idx_np, device=device)
            states_all, *out = round_call(states_all, idx, M_round)
            outs.append((idx_np, out))

        next_pending = []
        for idx_np, out in outs:
            cs, tr, ni, done = (t.cpu().numpy() for t in out)
            seen = set()
            for j, i in enumerate(idx_np):
                if i in seen:
                    continue
                seen.add(i)
                n_iters[i] += ni[j]
                traces[i].append(tr[j, :ni[j]])
                if done[j] or used + M_round >= max_iterations:
                    costs[i] = cs[j]
                else:
                    next_pending.append(i)
        pending = next_pending
        used += M_round

    best = int(np.argmin(costs))
    return states_all, costs, n_iters, traces, best


def _best_of_compacted(states, round_call, *, max_iterations,
                       restart_chunk, round_iterations):
    """:func:`_compacted_best` from the initial ``states`` (not
    modified).  Returns ``((*best_state, trace, best_cost,
    best_n_iter), costs, n_iters)``, ``costs`` and ``n_iters`` numpy
    arrays over all restarts."""
    states_all = tuple(s.clone() for s in states)
    states_all, costs, n_iters, traces, best = _compacted_best(
        states_all[0].shape[0], states_all, max_iterations=max_iterations,
        restart_chunk=restart_chunk, round_iterations=round_iterations,
        round_call=round_call)
    trace_b = (np.concatenate(traces[best]) if traces[best]
               else np.zeros((0,)))
    return ((*(s[best] for s in states_all), trace_b, float(costs[best]),
             int(n_iters[best])), costs, n_iters)


def _aa_grouped_parts(X, delta, statics, grouped_backend, gram):
    """``(iterate, cost0)`` of :func:`_aa_grouped_iterate` for a fit's
    ``statics`` (``max_iterations``, ``criterion``, ``do_scale``,
    ``has_data`` and the three solver configs).  ``gram`` is ``X X'`` if
    the caller already has it: it is made once per fit."""
    has_data = statics['has_data']
    dict_kwargs, weights_kwargs, scale_kwargs = _grouped_solver_kwargs(
        statics['dict_cfg'], statics['weights_cfg'], statics['scale_cfg'])
    if gram is None:
        gram = _gram_once(X) if has_data else X
    K, data, trace_K = _prepare_grouped(X, has_data, gram)
    return _aa_grouped_iterate(
        data, K, delta=delta, do_scale=statics['do_scale'],
        has_data=has_data, dict_kwargs=dict_kwargs,
        weights_backend=grouped_backend, weights_kwargs=weights_kwargs,
        scale_kwargs=scale_kwargs, trace_K=trace_K)


def _make_aa_grouped_round_run(X, gram, *, delta, tolerance, statics,
                               grouped_backend):
    """One bounded compaction round of grouped AA restarts
    (:func:`_round_run`)."""
    iterate, cost0 = _aa_grouped_parts(X, delta, statics,
                                       grouped_backend, gram)
    return _round_run(iterate, cost0, tolerance=tolerance,
                      criterion=statics['criterion'])


@apply_matmul_precision
def _compacted_aa_best(X, states, delta, tolerance, *, statics,
                       grouped_backend, restart_chunk, round_iterations,
                       gram=None):
    """Multi-restart AA with convergence compaction, from given initial
    states ``(Zs, Cs, alphas)`` (see :func:`_compacted_best`;
    ``statics`` as in :func:`_aa_grouped_parts`).  Returns ``(best,
    costs, n_iters)`` with ``best = (Z, C, alpha, trace, best_cost,
    best_n_iter)``."""
    run = _make_aa_grouped_round_run(X, gram, delta=delta,
                                     tolerance=tolerance, statics=statics,
                                     grouped_backend=grouped_backend)
    return _best_of_compacted(
        states, run, max_iterations=int(statics['max_iterations']),
        restart_chunk=restart_chunk, round_iterations=round_iterations)


def _reject_unported(mesh, screen_iterations, pad_components_to, grouped):
    _reject_mesh(mesh)
    if screen_iterations is not None:
        raise ValueError("screen_iterations is not ported yet (ROADMAP.md "
                         "queue 1, item 11: screening)")
    if pad_components_to is not None:
        raise ValueError("pad_components_to is not ported yet (ROADMAP.md "
                         "queue 1, item 11: padded-k buckets)")
    if grouped is not None and not grouped:
        raise ValueError("grouped=False selects the vmapped per-restart "
                         "path, which is not ported (ROADMAP.md queue 1, "
                         "item 18); the grouped runners are the only "
                         "restart structure")


def _check_fit_args(stopping_criterion, n_init):
    if stopping_criterion not in STOPPING_CRITERIA:
        raise ValueError("unsupported stopping criterion %r"
                         % (stopping_criterion,))
    if int(n_init) < 1:
        raise ValueError("n_init must be >= 1, got %r" % (n_init,))


def _round_iterations(compact_iterations):
    """The compaction round: ``compact_iterations``, or
    :data:`_ONE_SHOT_ROUND` for the one-shot default (None)."""
    if compact_iterations is None:
        return _ONE_SHOT_ROUND
    return int(compact_iterations)


def _as_restart_generator(generator, device):
    """A ``torch.Generator`` as given, or one on ``device`` seeded with
    the integer ``generator``."""
    if isinstance(generator, torch.Generator):
        return generator
    return torch.Generator(device=device).manual_seed(int(generator))


@apply_matmul_precision
def aa_fit_restarts(data, n_components, generator, n_init, delta=0.0,
                    init='furthest_sum', tolerance=1e-6,
                    max_iterations=500, n_extra_steps=10,
                    stopping_criterion='abs_delta_f',
                    dictionary_solver_kwargs=None,
                    weights_solver_kwargs=None,
                    scale_factors_solver_kwargs=None,
                    mesh=None, restart_chunk=None, pad_components_to=None,
                    screen_iterations=None, grouped=None,
                    compact_iterations=None, device=None):
    """Best-of-``n_init`` archetypal analysis on one device.

    ``data``: (n_samples, n_features) tensor or array; the fit runs in
    its dtype, on ``device`` if given, else on a tensor's own device,
    else (a numpy array, a list) on the card: ``'cuda'``, which raises
    ``RuntimeError`` where there is none (pass ``device='cpu'``).
    ``generator``: a ``torch.Generator`` or an integer seed (the JAX
    package takes a PRNG key).  ``init``: 'furthest_sum' (on the device,
    ``n_extra_steps`` refinement passes) or 'random'.

    The restarts run in the grouped structure, the weights QPs of a
    chunk in one grouped call, under convergence compaction
    (:func:`_compacted_best`): rounds of ``compact_iterations``
    iterations over chunks of ``restart_chunk`` restarts (all at once
    when None).  The default ``compact_iterations=None`` stands for the
    JAX package's one-shot runner and runs rounds of
    :data:`_ONE_SHOT_ROUND`; every restart follows the same trajectory
    whatever the round and chunk, so the results are that runner's.
    ``weights_solver_kwargs['backend']`` 'auto' resolves
    with the JAX package's grouped-fit rule: the kernels on a CUDA
    device (k <= 128), the row solver on the CPU.  Where the weights do
    not run on the kernels (the CPU, ``backend='xla'``), the JAX package
    falls back to its vmapped per-restart path under ``grouped=None``;
    the port keeps the grouped structure with the row solver.
    ``grouped`` is None or True; False (the vmapped path),
    ``screen_iterations``, ``pad_components_to`` and ``mesh`` raise
    ``ValueError`` naming the ROADMAP.md item that ports them.

    Returns a dict with the best restart's ``weights``, ``dictionary``,
    ``alpha``, ``archetypes`` (tensors), ``cost`` and ``n_iter``, its
    ``cost_deltas``, and ``costs``, ``n_iters`` and ``best_index`` over
    all restarts (numpy).
    """
    _reject_unported(mesh, screen_iterations, pad_components_to, grouped)
    if init not in ('random', 'furthest_sum'):
        raise ValueError("init must be 'random' or 'furthest_sum', got %r"
                         % (init,))
    _check_fit_args(stopping_criterion, n_init)

    X = as_input(data, device)
    generator = _as_restart_generator(generator, X.device)

    dict_cfg = make_config(SPGSolverConfig, dictionary_solver_kwargs)
    weights_cfg = make_config(QPSolverConfig, weights_solver_kwargs)
    scale_cfg = make_config(SPGSolverConfig, scale_factors_solver_kwargs)
    do_scale = float(delta) != 0.0

    # The Gram, once per fit: every round and chunk takes it.
    gram = _gram_once(X)
    diss = dissimilarities_from_kernel(gram) if init == 'furthest_sum' \
        else None
    states = _init_aa_state(
        generator, int(n_init), float(delta), n_samples=X.shape[0],
        n_components=int(n_components), init=init, diss=diss,
        n_extra_steps=int(n_extra_steps), do_scale=do_scale,
        dtype=X.dtype, device=X.device)
    statics = dict(max_iterations=int(max_iterations),
                   criterion=stopping_criterion, do_scale=do_scale,
                   has_data=True, dict_cfg=dict_cfg,
                   weights_cfg=weights_cfg, scale_cfg=scale_cfg)
    grouped_backend = resolve_qp_backend(
        weights_cfg.backend, k=int(n_components), regime='sharded_fit',
        device=X.device)
    common = dict(statics=statics, grouped_backend=grouped_backend,
                  restart_chunk=restart_chunk, gram=gram)
    best, costs, n_iters = _compacted_aa_best(
        X, states, float(delta), float(tolerance),
        round_iterations=_round_iterations(compact_iterations), **common)

    Z, C, alpha, trace, best_cost, n_iter_best = best
    dictionary = alpha[:, None] * C if do_scale else C
    return {
        'weights': Z,
        'dictionary': dictionary,
        'alpha': alpha,
        'archetypes': dictionary @ X,
        'cost': best_cost,
        'n_iter': n_iter_best,
        'cost_deltas': np.asarray(trace)[:n_iter_best],
        'costs': costs,
        'n_iters': n_iters,
        'best_index': int(np.argmin(costs)),
    }


# ---------------------------------------------------------------------------
# GPNH convex coding
# ---------------------------------------------------------------------------


def _init_gpnh_state(generator, X, diss, n_init, *, n_components, init,
                     n_extra_steps):
    """Initial states of ``n_init`` GPNH restarts: row-stochastic
    ``Z (R, n, k)`` and ``W (R, d, k)``, either ``sqrt(mean|X| / k)
    N(0, 1)`` or, with ``init='furthest_sum'``, the data rows that
    :func:`furthest_sum_device` picks from the dissimilarities ``diss``,
    one random start index per restart.  The numbers are drawn on
    ``generator``'s device and moved to ``X``'s.  Matches the JAX
    package's ``_init_gpnh_state`` in distribution."""
    n_samples, n_features = X.shape
    dtype = X.dtype
    if init == 'furthest_sum':
        starts = torch.randint(0, n_samples, (n_init,),
                               generator=generator,
                               device=generator.device).to(X.device)
        selected = furthest_sum_device(diss, n_components, starts,
                                       extra_steps=n_extra_steps)
        W = X[selected].transpose(1, 2).contiguous()
    else:
        avg = torch.sqrt(torch.mean(torch.abs(X)) / n_components)
        W = avg * torch.randn((n_init, n_features, n_components),
                              generator=generator, dtype=dtype,
                              device=generator.device).to(X.device)
    Z = right_stochastic_matrix(generator, (n_init, n_samples, n_components),
                                dtype=dtype, device=X.device)
    return Z, W


def _gpnh_grouped_iterate(X, *, lambda_W, weights_backend, weights_kwargs,
                          n_components):
    """Restart-batched GPNH iterate with the weights QP grouped across
    restarts: per iteration the exact k x k dictionary solve of every
    restart (``update_gpnh_dictionary``: one batched SVD),
    then the weights QPs of all restarts in one
    :func:`quad_simplex_spg_batch_grouped` call, then the trace-form
    cost in float64.  ``lambda_W`` is a number.

    Returns ``(iterate, cost0)``: ``iterate(Zs, Ws) -> (Zs, Ws, costs)``
    and ``cost0(Zs, Ws)``, the initial costs.
    """
    n_samples, n_features = X.shape
    sdt = _GPNH_SDT
    lambda_W = float(lambda_W)
    trace_XtX = torch.sum(X.to(sdt) * X.to(sdt))
    GW = _gpnh_gram(n_features, n_components, X.dtype, X.device)

    def penalty(Ws):
        if lambda_W == 0:
            return torch.zeros(Ws.shape[:1], dtype=sdt, device=Ws.device)
        return lambda_W * gpnh_regularization(Ws).to(sdt)

    def dict_update(Zs):
        Ws = update_gpnh_dictionary(X, Zs, Zs.transpose(1, 2) @ Zs, GW,
                                    lambda_W=lambda_W)
        return Ws, Ws.transpose(1, 2) @ Ws, -(X @ Ws)

    def cost_of(Zs, Ws, WtWs, XWs):
        WtXtZ_tr = torch.sum(XWs.to(sdt) * Zs.to(sdt), dim=(1, 2))
        return _gpnh_cost_from_parts(trace_XtX, WtXtZ_tr,
                                     Zs.transpose(1, 2) @ Zs, WtWs,
                                     penalty(Ws), n_samples)

    def iterate(Zs, Ws):
        Ws, WtWs, Bs = dict_update(Zs)
        Zs = quad_simplex_spg_batch_grouped(
            WtWs, Bs, Zs, backend=weights_backend, **weights_kwargs)
        return Zs, Ws, cost_of(Zs, Ws, WtWs, -Bs)

    def cost0(Zs, Ws):
        return cost_of(Zs, Ws, Ws.transpose(1, 2) @ Ws, X @ Ws)

    return iterate, cost0


def _gpnh_parts(X, lambda_W, statics, grouped_backend):
    """``(iterate, cost0)`` of :func:`_gpnh_grouped_iterate` for a fit's
    ``statics`` (``max_iterations``, ``criterion``, ``weights_cfg``,
    ``n_components``)."""
    return _gpnh_grouped_iterate(
        X, lambda_W=lambda_W, weights_backend=grouped_backend,
        weights_kwargs=statics['weights_cfg'].kwargs(),
        n_components=statics['n_components'])


def _make_gpnh_grouped_round_run(X, *, lambda_W, tolerance, statics,
                                 grouped_backend):
    """One bounded compaction round of grouped GPNH restarts
    (:func:`_round_run`; the population is ``(Z_all, W_all)``)."""
    iterate, cost0 = _gpnh_parts(X, lambda_W, statics, grouped_backend)
    return _round_run(iterate, cost0, tolerance=tolerance,
                      criterion=statics['criterion'])


@apply_matmul_precision
def _compacted_gpnh_best(X, states, lambda_W, tolerance, *, statics,
                         grouped_backend, restart_chunk, round_iterations):
    """Multi-restart GPNH with convergence compaction, from given
    initial states ``(Zs, Ws)`` (not modified; see
    :func:`_compacted_best`).  Returns ``(best, costs, n_iters)`` with
    ``best = (Z, W, trace, best_cost, best_n_iter)``."""
    run = _make_gpnh_grouped_round_run(
        X, lambda_W=lambda_W, tolerance=tolerance, statics=statics,
        grouped_backend=grouped_backend)
    return _best_of_compacted(
        states, run, max_iterations=int(statics['max_iterations']),
        restart_chunk=restart_chunk, round_iterations=round_iterations)


@apply_matmul_precision
def gpnh_fit_restarts(data, n_components, generator, n_init, lambda_W=0.0,
                      init='random', tolerance=1e-6, max_iterations=500,
                      n_extra_steps=10, stopping_criterion='abs_delta_f',
                      weights_solver_kwargs=None, mesh=None,
                      restart_chunk=None, pad_components_to=None,
                      screen_iterations=None, grouped=None,
                      compact_iterations=None, device=None):
    """Best-of-``n_init`` GPNH convex coding on one device.

    ``data``, ``generator``, ``device``, the schedulers
    (``compact_iterations``, ``restart_chunk``), ``grouped``, the
    weights backend and the options that raise are as in
    :func:`aa_fit_restarts`.  ``init``: 'random' (the default) or
    'furthest_sum' (on the device, ``n_extra_steps`` refinement passes).

    Returns a dict with the best restart's ``weights`` and
    ``dictionary`` (tensors), ``cost``, ``n_iter`` and ``cost_deltas``,
    and ``costs``, ``n_iters`` and ``best_index`` over all restarts
    (numpy).
    """
    _reject_unported(mesh, screen_iterations, pad_components_to, grouped)
    if init not in ('random', 'furthest_sum'):
        raise ValueError(
            "gpnh_fit_restarts supports init='random' or "
            "'furthest_sum' (the reference drivers' choices)")
    _check_fit_args(stopping_criterion, n_init)

    X = as_input(data, device)
    generator = _as_restart_generator(generator, X.device)
    k = int(n_components)
    weights_cfg = make_config(QPSolverConfig, weights_solver_kwargs)

    diss = (dissimilarities_from_kernel(_gram_once(X))
            if init == 'furthest_sum' else None)
    states = _init_gpnh_state(generator, X, diss, int(n_init),
                              n_components=k, init=init,
                              n_extra_steps=int(n_extra_steps))
    statics = dict(max_iterations=int(max_iterations),
                   criterion=stopping_criterion, weights_cfg=weights_cfg,
                   n_components=k)
    grouped_backend = resolve_qp_backend(weights_cfg.backend, k=k,
                                         regime='sharded_fit',
                                         device=X.device)
    best, costs, n_iters = _compacted_gpnh_best(
        X, states, float(lambda_W), float(tolerance), statics=statics,
        grouped_backend=grouped_backend, restart_chunk=restart_chunk,
        round_iterations=_round_iterations(compact_iterations))

    Z, W, trace, best_cost, n_iter_best = best
    return {
        'weights': Z,
        'dictionary': W,
        'cost': best_cost,
        'n_iter': n_iter_best,
        'cost_deltas': np.asarray(trace)[:n_iter_best],
        'costs': costs,
        'n_iters': n_iters,
        'best_index': int(np.argmin(costs)),
    }
