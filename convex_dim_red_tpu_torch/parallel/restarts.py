"""Best-of-``n_init`` archetypal analysis with convergence compaction.

Port of the single-device compacted path of
convex_dim_red_tpu/parallel/restarts.py.  The restart population lives
in fixed-width ``(R, ...)`` tensors on the device for the whole fit:
``Z (R, n, k)``, ``C (R, k, n)``, ``alpha (R, k)``.  Restarts run in
bounded rounds; each round gathers a chunk of the restarts still
iterating, advances it with the weights QP of every restart solved in
one grouped kernel launch per iteration (:func:`_aa_grouped_iterate`),
and scatters the states back.  After each round the converged restarts
retire and the survivors are re-packed into dense chunks.  The host
sees only the per-chunk scheduler scalars, fetched once per chunk and
round.

FurthestSum initialisation, screening, padded ``k``, the one-shot
grouped runner, ``KernelAA``'s kernel-input fits and meshes are later
slices of the port (ROADMAP.md, queue 1).
"""

import numpy as np
import torch

from ..models._common import (QPSolverConfig, SPGSolverConfig,
                              STOPPING_CRITERIA, make_config)
from ..models.archetypal_analysis import (_cost_from_parts, _scalar_dtype,
                                          _spg_cfg_to_quad_kwargs)
from ..ops.simplex_projection import simplex_project_rows
from ..ops.stochastic_matrices import right_stochastic_matrix
from ..solvers.spg import quad_simplex_spg_batch_grouped, quad_spg
from ..utils.precision import apply_matmul_precision
from .sharded_aa import _keep_best_loop

__all__ = ["aa_fit_restarts"]


def _init_aa_state(generator, n_init, delta, *, n_samples, n_components,
                   do_scale, dtype, device):
    """Random initial states of ``n_init`` restarts: row-stochastic
    ``Z (R, n, k)`` and ``C (R, k, n)``, and ``alpha (R, k)`` uniform in
    ``[1 - delta, 1 + delta]`` (ones without scale factors).  Matches the
    JAX package's ``init='random'`` in distribution."""
    C = right_stochastic_matrix(generator, (n_init, n_components, n_samples),
                                dtype=dtype, device=device)
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
    return (_spg_cfg_to_quad_kwargs(dict_cfg), weights_cfg.kernel_kwargs(),
            _spg_cfg_to_quad_kwargs(scale_cfg))


def _prepare_grouped(X, has_data, K):
    """The data operand of the residual-form cost and ``trace K`` for
    the trace form.  ``K`` is the Gram, computed once per fit by the
    compaction scheduler (or the kernel itself when ``not has_data``).
    """
    data = X if has_data else None
    trace_K = None if has_data else torch.trace(K).to(_scalar_dtype(K.dtype))
    return K, data, trace_K


@apply_matmul_precision
def _gram_once(X):
    """``X X'``, once per fit, under the library's matmul precision."""
    return X @ X.T


def _make_aa_grouped_round_run(X, gram, *, criterion, do_scale, has_data,
                               delta, tolerance, dict_kwargs,
                               weights_backend, weights_kwargs,
                               scale_kwargs):
    """One bounded compaction round of grouped restarts.

    Returns ``run(states_all, idx, max_iterations) -> (states_all,
    costs, trace, n_iters, done)``: it gathers the chunk ``idx`` from the
    population tensors, advances it up to ``max_iterations`` iterations
    under :func:`sharded_aa._keep_best_loop`, and scatters the states
    back in place.  Nothing in a round waits on the host.  Duplicate
    indices (a tiled tail chunk) compute identical trajectories, so the
    scatter writes equal values.
    """
    K, data, trace_K = _prepare_grouped(X, has_data, gram)
    iterate, cost0 = _aa_grouped_iterate(
        data, K, delta=delta, do_scale=do_scale, has_data=has_data,
        dict_kwargs=dict_kwargs, weights_backend=weights_backend,
        weights_kwargs=weights_kwargs, scale_kwargs=scale_kwargs,
        trace_K=trace_K)

    def run(states_all, idx, max_iterations):
        Zs, Cs, alphas = (s[idx] for s in states_all)
        states, costs, trace, n_iters, done = _keep_best_loop(
            (Zs, Cs, alphas), cost0(Zs, Cs, alphas), iterate,
            tolerance=tolerance, criterion=criterion,
            max_iterations=max_iterations)
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
    ``idx`` (a device tensor).  All chunks of a round are queued before
    any result is read; the host then reads each chunk's scalars once.

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


@apply_matmul_precision
def _compacted_aa_best(X, states, delta, tolerance, *, statics,
                       grouped_backend, restart_chunk, round_iterations):
    """Multi-restart AA with convergence compaction, from given initial
    states ``(Zs, Cs, alphas)`` (see :func:`_compacted_best`).

    ``statics`` holds ``max_iterations``, ``criterion``, ``do_scale``,
    ``has_data`` and the three solver configs.  The initial states are
    not modified.  Returns ``(best, costs, n_iters)`` with ``best = (Z,
    C, alpha, trace, best_cost, best_n_iter)``.
    """
    has_data = statics['has_data']
    dict_kwargs, weights_kwargs, scale_kwargs = _grouped_solver_kwargs(
        statics['dict_cfg'], statics['weights_cfg'], statics['scale_cfg'])
    # Gram once per fit: every round takes it device-resident.
    gram = _gram_once(X) if has_data else X
    run = _make_aa_grouped_round_run(
        X, gram, criterion=statics['criterion'],
        do_scale=statics['do_scale'], has_data=has_data, delta=delta,
        tolerance=tolerance, dict_kwargs=dict_kwargs,
        weights_backend=grouped_backend, weights_kwargs=weights_kwargs,
        scale_kwargs=scale_kwargs)

    states_all = tuple(s.clone() for s in states)
    states_all, costs, n_iters, traces, best = _compacted_best(
        states_all[0].shape[0], states_all,
        max_iterations=int(statics['max_iterations']),
        restart_chunk=restart_chunk, round_iterations=round_iterations,
        round_call=run)

    Z_all, C_all, a_all = states_all
    trace_b = (np.concatenate(traces[best]) if traces[best]
               else np.zeros((0,)))
    best_tuple = (Z_all[best], C_all[best], a_all[best],
                  trace_b, float(costs[best]), int(n_iters[best]))
    return best_tuple, costs, n_iters


@apply_matmul_precision
def aa_fit_restarts(data, n_components, generator, n_init, delta=0.0,
                    init='furthest_sum', tolerance=1e-6,
                    max_iterations=500, stopping_criterion='abs_delta_f',
                    dictionary_solver_kwargs=None,
                    weights_solver_kwargs=None,
                    scale_factors_solver_kwargs=None,
                    mesh=None, restart_chunk=None, pad_components_to=None,
                    screen_iterations=None, compact_iterations=None):
    """Best-of-``n_init`` archetypal analysis on one device.

    ``data``: (n_samples, n_features) tensor (or array); the fit runs
    on its device and in its dtype.  ``generator``: a
    ``torch.Generator`` or an integer seed (the JAX package takes a
    PRNG key).  Restarts run with convergence compaction: rounds of
    ``compact_iterations`` iterations, chunks of ``restart_chunk``
    restarts (see :func:`_compacted_best`).

    Returns a dict with the best restart's ``weights``, ``dictionary``,
    ``alpha``, ``archetypes`` (tensors), ``cost`` and ``n_iter``, its
    ``cost_deltas``, and ``costs``, ``n_iters`` and ``best_index`` over
    all restarts (numpy).

    This slice of the port runs ``init='random'`` with compaction only;
    the other options raise ``ValueError`` naming the ROADMAP.md item
    that ports them.  The default ``init`` is the JAX package's
    ('furthest_sum'), so it must be given.
    """
    if mesh is not None:
        raise ValueError("mesh= is not ported yet (ROADMAP.md queue 1, "
                         "item 17: multi-GPU)")
    if screen_iterations is not None:
        raise ValueError("screen_iterations is not ported yet (ROADMAP.md "
                         "queue 1, item 11: screening)")
    if pad_components_to is not None:
        raise ValueError("pad_components_to is not ported yet (ROADMAP.md "
                         "queue 1, item 11: padded-k buckets)")
    if compact_iterations is None:
        raise ValueError("only the compacted scheduler is ported; pass "
                         "compact_iterations (the one-shot grouped runner "
                         "is ROADMAP.md queue 1, item 11)")
    if init != 'random':
        raise ValueError("init=%r is not ported yet; use init='random' "
                         "(FurthestSum is ROADMAP.md queue 1, item 10)"
                         % (init,))
    if stopping_criterion not in STOPPING_CRITERIA:
        raise ValueError("unsupported stopping criterion %r"
                         % (stopping_criterion,))
    if int(n_init) < 1:
        raise ValueError("n_init must be >= 1, got %r" % (n_init,))

    X = torch.as_tensor(data)
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=X.device).manual_seed(
            int(generator))

    dict_cfg = make_config(SPGSolverConfig, dictionary_solver_kwargs)
    weights_cfg = make_config(QPSolverConfig, weights_solver_kwargs)
    scale_cfg = make_config(SPGSolverConfig, scale_factors_solver_kwargs)
    do_scale = float(delta) != 0.0

    states = _init_aa_state(
        generator, int(n_init), float(delta), n_samples=X.shape[0],
        n_components=int(n_components), do_scale=do_scale,
        dtype=X.dtype, device=X.device)
    statics = dict(max_iterations=int(max_iterations),
                   criterion=stopping_criterion, do_scale=do_scale,
                   has_data=True, dict_cfg=dict_cfg,
                   weights_cfg=weights_cfg, scale_cfg=scale_cfg)
    best, costs, n_iters = _compacted_aa_best(
        X, states, float(delta), float(tolerance), statics=statics,
        grouped_backend=weights_cfg.backend, restart_chunk=restart_chunk,
        round_iterations=int(compact_iterations))

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
