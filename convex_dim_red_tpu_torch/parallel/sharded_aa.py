"""Mesh-sharded model fits on ``torch.distributed``: SPMD over
(restarts, samples).

Port of convex_dim_red_tpu/parallel/sharded_aa.py, under the rules of
:mod:`.mesh` (every rank passes the full inputs, slices its shard and
returns the global result).  Mesh axes:

- ``restarts``: independent fits, no collectives but the final keep-best
  selection;
- ``samples``: rows of the data matrix.  The per-row weights QPs are
  local (the restart-grouped kernel, K1 at ``k <= 64`` and K3 above,
  on the rank's ``(R_loc, n_loc, k)`` operands); the k-sized
  contractions cross shards by ``all_reduce`` (Z'Z, C K, the costs) and
  ``all_gather`` (the (n, k) blocks Z and K Z D).

Every rank of a sample group computes the same replicated values (each
comes from all-reduced or all-gathered operands), and every stop flag
read on the host is agreed over the group: the dictionary SPG's every 8
steps, the keep-best loop's once a round.  GPNH's k x k least-squares
solve runs on every rank, and the group's first rank's result is
broadcast.  Restart groups never communicate inside the loops.

:func:`sharded_aa_fit` and :func:`sharded_gpnh_fit` run the full
alternating fit (with the scale factors for ``delta != 0``) and the
cross-mesh keep-best selection.  Their iterates, :func:`_aa_iterate`
and :func:`_gpnh_iterate`, are the ones the single-device restart
runners of parallel/restarts.py run (with a :class:`_Shard` of no mesh,
where every collective is the identity), so a sharded fit's cost
trajectories agree with the single-device fit's up to reduction order,
and a (1, 1) mesh gives its bits.
"""

import numpy as np
import torch

from ..models._common import (QPSolverConfig, SPGSolverConfig,
                              has_converged, make_config)
from ..models.archetypal_analysis import (_SCALE_CHECK_EVERY,
                                          _cost_from_parts,
                                          _spg_cfg_to_quad_kwargs)
from ..models.gpnh_convex_coding import (
    _SCALAR_DTYPE as _GPNH_SDT, _cost_from_parts as _gpnh_cost_from_parts,
    _gpnh_gram, _gpnh_gram_masked, _solve_gpnh_dictionary,
    gpnh_regularization, gpnh_regularization_masked)
from ..ops.residual_cost import residual_sq_sums
from ..ops.simplex_projection import simplex_project_rows
from ..solvers.spg import (_quad_spg_reads_host, _weights_qp_reads_host,
                           quad_simplex_spg_batch_grouped, quad_spg,
                           resolve_qp_backend)
from ..utils import profiling
from ..utils.precision import apply_matmul_precision
from ..utils.profiling import host_read, span
from ..utils.validation import as_input
from .mesh import (_all_gather, _all_true, _axis, _block, _broadcast,
                   _psum, mesh_device)

__all__ = ["distributed_gram", "sharded_aa_train_step", "sharded_aa_fit",
           "sharded_kernel_aa_fit", "sharded_gpnh_fit"]

#: Iterations between two host reads of a restart loop: of "is every
#: restart done" in the sharded keep-best loop (agreed over the sample
#: group), and the round of the single-device restart runners
#: (parallel/restarts.py) under ``compact_iterations=None`` and in both
#: phases of a screened fit.  A frozen restart does not change, so the
#: read moves no result.
_ROUND = 32


def _keep_best_step(iterate_batch, states, cost, done, n_iters, *,
                    tolerance, criterion):
    """One iteration of :func:`_keep_best_loop` on its carried tensors:
    the iterate, the freeze of every restart already done, its count
    and its stop test.  Returns ``((states, cost, done, n_iters),
    delta)``, ``delta`` the (R,) cost deltas (0 where frozen)."""
    out = iterate_batch(*states)
    new_states, new_cost = tuple(out[:-1]), out[-1]
    states = tuple(
        torch.where(done.view((-1,) + (1,) * (n.ndim - 1)), o, n)
        for o, n in zip(states, new_states))
    new_cost = torch.where(done, cost, new_cost)
    delta = torch.where(done, 0.0, new_cost - cost)
    n_iters = n_iters + (~done).to(torch.int32)
    done = done | has_converged(cost, new_cost, tolerance, criterion)
    return (states, new_cost, done, n_iters), delta


def _keep_best_loop(states, cost0, iterate_batch, *, tolerance, criterion,
                    max_iterations, check_every=None, agree=None,
                    advance=None):
    """Advance a batch of restarts up to ``max_iterations`` alternating
    iterations, freezing each restart once it has converged.

    ``states`` is a tuple of tensors with a leading restart axis;
    ``iterate_batch(*states) -> (*states, costs)`` advances the whole
    batch one iteration.  Returns ``(states, costs, trace, n_iters,
    done)`` with ``trace (R, max_iterations)`` the per-iteration cost
    deltas (0 once frozen).

    The JAX loop leaves as soon as every restart is done.  Here all
    ``max_iterations`` run unless ``check_every`` is given, so the round
    never waits on the host; with ``check_every`` the host reads whether
    every restart is done once per that many iterations (``agree`` maps
    the flag to the one a sharded fit's whole group takes) and leaves.
    A frozen restart does not change, so the outputs are the JAX
    loop's either way.

    Each iteration is :func:`_keep_best_step` on the carried ``(states,
    cost, done, n_iters)``, called directly or, with ``advance``, as
    ``advance(step, carry) -> (carry, delta)``
    (``iterate_graph.StepGraphs``, which may replay it as a CUDA
    graph).  Each iteration is the span ``cdr.restarts.iteration`` and
    adds the batch's width to ``profiling.RESTART_SLOTS``.
    """
    R = cost0.shape[0]
    device = cost0.device
    trace = torch.zeros((R, max_iterations), dtype=cost0.dtype,
                        device=device)
    n_iters = torch.zeros((R,), dtype=torch.int32, device=device)
    done = torch.zeros((R,), dtype=torch.bool, device=device)

    def step(carry):
        return _keep_best_step(iterate_batch, *carry, tolerance=tolerance,
                               criterion=criterion)

    carry = (tuple(states), cost0, done, n_iters)
    for it in range(max_iterations):
        if check_every and it and it % check_every == 0:
            stop = bool(host_read(carry[2].all()))
            if agree is not None:
                stop = agree(stop)
            if stop:
                break
        profiling.RESTART_SLOTS += R
        with span("cdr.restarts.iteration"):
            carry, delta = (step(carry) if advance is None
                            else advance(step, carry))
            trace[:, it] = delta
    states, cost, done, n_iters = carry
    return states, cost, trace, n_iters, done


class _Shard:
    """A rank's place on a (restarts, samples) mesh: its device, its
    block of rows and of restarts, and the collectives of each axis.

    ``mesh=None`` is one device (``device``) holding every row and
    restart, where every collective is the identity: the single-device
    restart runners of parallel/restarts.py run the iterates below
    through it, so a sharded fit and a single-device one share every
    update."""

    def __init__(self, mesh=None, restart_axis="restarts",
                 sample_axis="samples", device=None):
        self.mesh = mesh
        self.restart_axis = restart_axis
        self.sample_axis = sample_axis
        if mesh is None:
            self.device = torch.device(device)
            self.n_sample_shards, self.sample_index = 1, 0
            self.n_restart_shards, self.restart_index = 1, 0
            return
        self.device = mesh_device(mesh)
        self.n_sample_shards, self.sample_index, _ = _axis(mesh,
                                                           sample_axis)
        self.n_restart_shards, self.restart_index, _ = _axis(mesh,
                                                             restart_axis)

    def rows(self, n):
        return _block(n, self.n_sample_shards, self.sample_index, "rows")

    def restarts(self, R):
        return _block(R, self.n_restart_shards, self.restart_index,
                      "restarts")

    def psum(self, t):
        return t if self.mesh is None else _psum(t, self.mesh,
                                                 self.sample_axis)

    def gather_rows(self, t, dim):
        return t if self.mesh is None else _all_gather(
            t, self.mesh, self.sample_axis, dim)

    def first(self, t):
        """``t`` as the sample group's first rank holds it."""
        return t if self.mesh is None else _broadcast(
            t, self.mesh, self.sample_axis, 0)

    def agree(self, flag):
        return bool(flag) if self.mesh is None else _all_true(
            flag, self.mesh, self.sample_axis)

    def take(self, a, dtype=None):
        """``a`` on this rank's device (in ``dtype`` when given)."""
        t = as_input(a, self.device)
        return t if dtype is None else t.to(dtype)


def _solver_kwargs(k, device, dictionary_solver_kwargs=None,
                   weights_solver_kwargs=None,
                   scale_factors_solver_kwargs=None):
    """The iterates' solver arguments from a fit's public settings (each
    a dict, a config or None for the defaults): the dictionary and
    scale-factor SPGs' as :func:`quad_spg` arguments, and the weights
    QP's backend and arguments, 'auto' resolved with grouped-fit
    semantics at ``k`` on ``device`` (the kernels on a CUDA device, k <=
    128; the row solver elsewhere).  An unknown backend raises
    ``ValueError`` here, before any iteration.  Returns ``(dict_kwargs,
    weights_backend, weights_kwargs, scale_kwargs)``."""
    weights = make_config(QPSolverConfig, weights_solver_kwargs)
    if weights.backend not in ('xla', 'pallas', 'auto'):
        raise ValueError(
            "unknown weights-QP backend %r; use 'xla', 'pallas' or "
            "'auto'" % (weights.backend,))
    return (_spg_cfg_to_quad_kwargs(
                make_config(SPGSolverConfig, dictionary_solver_kwargs)),
            resolve_qp_backend(weights.backend, k=k, regime='sharded_fit',
                               device=device),
            weights.kwargs(),
            _spg_cfg_to_quad_kwargs(
                make_config(SPGSolverConfig, scale_factors_solver_kwargs)))


@apply_matmul_precision
def distributed_gram(mesh, X, feature_axis="samples"):
    """The Gram matrix ``X X'`` with the features split over
    ``feature_axis``: each rank forms the partial Gram of its feature
    block, one ``all_reduce`` adds them.  Returns the (n, n) Gram on
    every rank."""
    size, index, _ = _axis(mesh, feature_axis)
    X = as_input(X, mesh_device(mesh))
    X_loc = X[:, _block(X.shape[1], size, index, "features")]
    return _psum(X_loc @ X_loc.T, mesh, feature_axis)


# ---------------------------------------------------------------------------
# One AA alternating iteration on local shards (restart-batched)
# ---------------------------------------------------------------------------


def _aa_pre_weights(K_loc, Z_loc, C, alpha, *, delta, do_scale,
                    dict_kwargs, scale_kwargs, sh):
    """Scale factors, dictionary and the weights-QP operands of one AA
    iteration for a batch of restarts, in the reference's order:
    ``K_loc`` (n_loc, n) the rank's kernel rows, ``Z_loc`` (R, n_loc,
    k), ``C`` (R, k, n) and ``alpha`` (R, k) replicated within the
    sample group; the k-sized contractions all-reduced and the (n, k)
    blocks all-gathered.  Returns ``(C, alpha, A, B_w, CK, CKCt)``,
    ``B_w`` (R, n_loc, k).  The spans ``cdr.aa.scale`` and
    ``cdr.aa.dictionary`` hold the two steps; ``Z'Z`` and ``K Z``, which
    both take, come before them."""
    n_samples = C.shape[-1]
    rows = sh.rows(n_samples)

    def cols(M):
        return M[..., rows]

    ZtZ = sh.psum(Z_loc.transpose(1, 2) @ Z_loc)
    KZ_loc = K_loc @ sh.gather_rows(Z_loc, 1)             # (R, n_loc, k)
    if do_scale:
        with span("cdr.aa.scale"):
            CK = sh.psum(cols(C) @ K_loc)                  # (R, k, n)
            CKZ = sh.psum(cols(CK) @ Z_loc)
            M = ZtZ * (CK @ C.transpose(1, 2))

            def project(a):
                return torch.clamp(a, 1.0 - delta, 1.0 + delta)

            alpha = quad_spg(
                lambda a: (M @ a[:, :, None])[:, :, 0] / n_samples,
                torch.diagonal(CKZ, dim1=1, dim2=2) / n_samples, alpha,
                project, agree=sh.agree, check_every=_SCALE_CHECK_EVERY,
                **scale_kwargs)

    with span("cdr.aa.dictionary"):
        KZD = sh.gather_rows(KZ_loc * alpha[:, None, :], 1)  # (R, n, k)
        DZtZD = (alpha[:, :, None] * ZtZ) * alpha[:, None, :]

        def matvec(Cm):
            return DZtZD @ sh.psum(cols(Cm) @ K_loc) / n_samples

        C = quad_spg(matvec, KZD.transpose(1, 2) / n_samples, C,
                     simplex_project_rows, agree=sh.agree, **dict_kwargs)
        CK = sh.psum(cols(C) @ K_loc)
        CKCt = CK @ C.transpose(1, 2)
        A = (alpha[:, :, None] * CKCt) * alpha[:, None, :]
        B_w = -(alpha[:, :, None] * cols(CK)).transpose(1, 2)
    return C, alpha, A, B_w, CK, CKCt


def _aa_iter_cost(X_loc, Z_loc, C, alpha, CK, CKCt, trace_K, sh):
    """The cost of each restart after its weights update: the residual
    form ``0.5 ||Z D C X - X||^2 / n`` when the data rows ``X_loc`` are
    given (reliable in float32; its sums of squares are K5's on the
    card, so no (R, n_loc, d) residual is formed there), the kernel
    trace form from ``trace_K`` otherwise.  The span ``cdr.aa.cost``."""
    n_samples = C.shape[-1]
    rows = sh.rows(n_samples)
    with span("cdr.aa.cost"):
        if X_loc is not None:
            CX = sh.psum(C[..., rows] @ X_loc)             # (R, k, d)
            sums = residual_sq_sums(X_loc, Z_loc.contiguous(), CX,
                                    alpha.contiguous())
            return 0.5 * sh.psum(sums) / n_samples
        CKZ = sh.psum(CK[..., rows] @ Z_loc)
        ZtZ = sh.psum(Z_loc.transpose(1, 2) @ Z_loc)
        return _cost_from_parts(trace_K, CKZ, ZtZ, CKCt, alpha, n_samples)


def _aa_iterate(X_loc, K_loc, *, n_components, delta, do_scale, sh,
                dictionary_solver_kwargs=None, weights_solver_kwargs=None,
                scale_factors_solver_kwargs=None, trace_K=None,
                component_mask=None):
    """The restart-batched AA iterate, on a mesh or (``sh`` without one)
    on one device: the scale and dictionary updates of every restart,
    then all their weights QPs in one
    :func:`quad_simplex_spg_batch_grouped` call on the rank's rows, then
    the costs.  The solvers run with a fit's public settings, resolved
    by :func:`_solver_kwargs` at ``n_components``.  ``X_loc`` (the
    rank's data rows, or None) selects the residual-form cost, else the
    kernel trace form from ``trace_K`` on the kernel rows ``K_loc``.
    ``component_mask`` (a padded fit) goes only to the weights QP, which
    pins the padded columns of ``Z`` to 0; the padded rows of ``C`` then
    get a zero gradient and do not reach the cost.

    Returns ``(iterate, cost0)``: ``iterate(Zs, Cs, alphas) -> (Zs, Cs,
    alphas, costs)`` for :func:`_keep_best_loop`, and ``cost0(Zs, Cs,
    alphas)``, the costs of initial states.  The weights QPs are the span
    ``cdr.aa.weights``.  ``iterate.reads_host`` says whether an
    iteration reads anything on the host: on a mesh (its collectives
    and agreed stops) or where a solver's cap exceeds its stop-read
    cadence (the dictionary's, with ``do_scale`` the scale factors',
    and the weights' on the row solver); otherwise an iteration may be
    captured as a CUDA graph (``iterate_graph``)."""
    dict_kwargs, weights_backend, weights_kwargs, scale_kwargs = \
        _solver_kwargs(n_components, sh.device, dictionary_solver_kwargs,
                       weights_solver_kwargs, scale_factors_solver_kwargs)
    if X_loc is not None:
        X_loc = X_loc.contiguous()  # K5's operand; once, not an iteration

    def iterate(Zs, Cs, alphas):
        Cs, alphas, As, Bws, CKs, CKCts = _aa_pre_weights(
            K_loc, Zs, Cs, alphas, delta=delta, do_scale=do_scale,
            dict_kwargs=dict_kwargs, scale_kwargs=scale_kwargs, sh=sh)
        with span("cdr.aa.weights"):
            Zs = quad_simplex_spg_batch_grouped(
                As, Bws, Zs, backend=weights_backend, mask=component_mask,
                **weights_kwargs)
        costs = _aa_iter_cost(X_loc, Zs, Cs, alphas, CKs, CKCts, trace_K,
                              sh)
        return Zs, Cs, alphas, costs

    iterate.reads_host = (
        sh.mesh is not None
        or _quad_spg_reads_host(dict_kwargs["max_iterations"])
        or (do_scale and _quad_spg_reads_host(
            scale_kwargs["max_iterations"], _SCALE_CHECK_EVERY))
        or _weights_qp_reads_host(weights_backend, weights_kwargs))

    def cost0(Zs, Cs, alphas):
        rows = sh.rows(Cs.shape[-1])
        CK = None if X_loc is not None else sh.psum(Cs[..., rows] @ K_loc)
        CKCt = None if CK is None else CK @ Cs.transpose(1, 2)
        return _aa_iter_cost(X_loc, Zs, Cs, alphas, CK, CKCt, trace_K, sh)

    return iterate, cost0


def _gpnh_iterate(X_loc, *, lambda_W, n_components, sh,
                  weights_solver_kwargs=None, component_mask=None):
    """The restart-batched GPNH iterate, on a mesh or (``sh`` without
    one) on one device: the exact k x k dictionary solve of every
    restart (``(Z'Z/n + lambda_W G_W) W' = Z'X/n`` on all-reduced
    ``Z'Z`` and ``Z'X``, one batched SVD, run replicated and taken from
    the sample group's first rank), then the weights QPs of all restarts
    in one :func:`quad_simplex_spg_batch_grouped` call on the rank's
    rows (the fit's ``weights_solver_kwargs`` resolved by
    :func:`_solver_kwargs`), then the trace-form cost in float64 from
    all-reduced parts.  ``lambda_W`` is a number.

    ``component_mask`` runs a padded fit: the masked GPNH Gram and
    penalty (active-k prefactor over the active columns), the padded
    columns of ``W`` set to 0 after each dictionary solve (``Z'Z`` is
    zero there, so the solve's system is singular by construction and
    the least-squares cutoff drops those directions), and the mask in
    the weights QP.

    Returns ``(iterate, cost0)``: ``iterate(Zs, Ws) -> (Zs, Ws, costs)``
    and ``cost0(Zs, Ws)``.  The spans ``cdr.gpnh.dictionary``,
    ``cdr.gpnh.weights`` and ``cdr.gpnh.cost`` hold the three steps.
    ``iterate.reads_host`` is always true: the dictionary solve's SVD
    waits on the host.
    """
    _, weights_backend, weights_kwargs, _ = _solver_kwargs(
        n_components, sh.device, weights_solver_kwargs=weights_solver_kwargs)
    n_loc, n_features = X_loc.shape
    n_samples = n_loc * sh.n_sample_shards
    sdt = _GPNH_SDT
    lambda_W = float(lambda_W)
    trace_XtX = sh.psum(torch.sum(X_loc.to(sdt) * X_loc.to(sdt)))
    if component_mask is None:
        GW = _gpnh_gram(n_features, n_components, X_loc.dtype, sh.device)
    else:
        mask = component_mask.to(sh.device)
        keep = mask.to(X_loc.dtype)
        GW = _gpnh_gram_masked(n_features, mask, X_loc.dtype, sh.device)

    def penalty(Ws):
        if lambda_W == 0:
            return torch.zeros(Ws.shape[:1], dtype=sdt, device=Ws.device)
        if component_mask is None:
            return lambda_W * gpnh_regularization(Ws).to(sdt)
        return lambda_W * gpnh_regularization_masked(Ws, mask).to(sdt)

    def dict_update(Zs):
        ZtZ = sh.psum(Zs.transpose(1, 2) @ Zs)
        ZtX = sh.psum(Zs.transpose(1, 2) @ X_loc)
        Ws = sh.first(_solve_gpnh_dictionary(ZtZ, ZtX, GW, lambda_W,
                                             n_samples))
        if component_mask is not None:
            Ws = Ws * keep
        return Ws, Ws.transpose(1, 2) @ Ws, -(X_loc @ Ws)

    def cost_of(Zs, Ws, WtWs, XWs):
        with span("cdr.gpnh.cost"):
            WtXtZ_tr = sh.psum(torch.sum(XWs.to(sdt) * Zs.to(sdt),
                                         dim=(1, 2)))
            return _gpnh_cost_from_parts(
                trace_XtX, WtXtZ_tr, sh.psum(Zs.transpose(1, 2) @ Zs),
                WtWs, penalty(Ws), n_samples)

    def iterate(Zs, Ws):
        with span("cdr.gpnh.dictionary"):
            Ws, WtWs, Bs = dict_update(Zs)
        with span("cdr.gpnh.weights"):
            Zs = quad_simplex_spg_batch_grouped(
                WtWs, Bs, Zs, backend=weights_backend, mask=component_mask,
                **weights_kwargs)
        return Zs, Ws, cost_of(Zs, Ws, WtWs, -Bs)

    iterate.reads_host = True

    def cost0(Zs, Ws):
        return cost_of(Zs, Ws, Ws.transpose(1, 2) @ Ws, X_loc @ Ws)

    return iterate, cost0


# ---------------------------------------------------------------------------
# Keep-best selection across the restart axis
# ---------------------------------------------------------------------------


def _select_best(states, costs, trace, n_iters, *, n_valid, sh):
    """Cross-mesh keep-best: gather every restart's cost, mask the
    padded restarts (global index >= ``n_valid``), take the argmin (the
    lowest global index among equal costs, as the JAX ``pmin`` on the
    group index does) and broadcast the winner's state from its restart
    group.  Returns ``(best_states, best_cost, best_n_iter, best_trace,
    all_costs, all_n_iters)``, the last two over every restart."""
    R_loc = costs.shape[0]
    mesh, axis = sh.mesh, sh.restart_axis
    all_costs = _all_gather(costs, mesh, axis)
    all_n_iters = _all_gather(n_iters, mesh, axis)
    idx = torch.arange(all_costs.shape[0], device=all_costs.device)
    masked = torch.where(idx < n_valid, all_costs,
                         torch.full_like(all_costs, float('inf')))
    best = int(host_read(torch.argmin(masked)))
    owner, local = divmod(best, R_loc)

    def pick(t):
        return _broadcast(t[local], mesh, axis, owner)

    best_states = tuple(pick(s) for s in states)
    return (best_states, float(host_read(masked[best])),
            int(host_read(all_n_iters[best])), pick(trace), all_costs,
            all_n_iters)


def _fit_outputs(Z_loc_best, sh, best, extra, n_valid):
    """The result dict of a sharded fit: the winner's weights gathered
    over the samples, and the per-restart costs and iteration counts as
    numpy arrays.  The iterations of this rank's real restarts (global
    index below ``n_valid``) go to ``profiling.RESTART_ADVANCES``."""
    _, cost, n_iter, trace, costs, n_iters = best
    out = {'weights': sh.gather_rows(Z_loc_best, 0)}
    out.update(extra)
    out.update(cost=cost, n_iter=n_iter,
               cost_deltas=host_read(trace).numpy(),
               costs=host_read(costs).numpy(),
               n_iters=host_read(n_iters).numpy().astype(np.int64))
    mine = np.arange(len(out['n_iters']))[sh.restarts(len(out['n_iters']))]
    profiling.RESTART_ADVANCES += int(
        out['n_iters'][mine[mine < n_valid]].sum())
    return out


def _local_states(sh, Zs, Cs, alphas, dtype, n):
    """This rank's block of restarts, with its rows of ``Zs``."""
    R = int(np.shape(Zs)[0])
    blk = sh.restarts(R)
    Zs = sh.take(Zs, dtype)[blk][:, sh.rows(n)].contiguous()
    return R, (Zs, sh.take(Cs, dtype)[blk].contiguous(),
               sh.take(alphas, dtype)[blk].contiguous())


def _sharded_aa(mesh, data, Zs, Cs, alphas, *, has_data, delta, tolerance,
                max_iterations, stopping_criterion, dictionary_solver_kwargs,
                weights_solver_kwargs, scale_factors_solver_kwargs,
                n_valid_restarts, restart_axis, sample_axis):
    """The fit of :func:`sharded_aa_fit` (``data`` the data matrix) and
    :func:`sharded_kernel_aa_fit` (``data`` the kernel)."""
    sh = _Shard(mesh, restart_axis, sample_axis)
    D = sh.take(data)
    n = D.shape[0]
    R, states = _local_states(sh, Zs, Cs, alphas, D.dtype, n)
    n_valid = R if n_valid_restarts is None else int(n_valid_restarts)
    do_scale = float(delta) != 0.0
    rows = sh.rows(n)
    D_loc = D[rows]
    if has_data:
        X_loc, K_loc, trace_K = D_loc, D_loc @ D.T, None
    else:
        X_loc, K_loc = None, D_loc
        trace_K = sh.psum(torch.trace(D_loc[:, rows]))

    iterate, cost0 = _aa_iterate(
        X_loc, K_loc, n_components=states[0].shape[-1], delta=float(delta),
        do_scale=do_scale, sh=sh,
        dictionary_solver_kwargs=dictionary_solver_kwargs,
        weights_solver_kwargs=weights_solver_kwargs,
        scale_factors_solver_kwargs=scale_factors_solver_kwargs,
        trace_K=trace_K)
    states, costs, trace, n_iters, _ = _keep_best_loop(
        states, cost0(*states), iterate, tolerance=tolerance,
        criterion=stopping_criterion, max_iterations=int(max_iterations),
        check_every=_ROUND, agree=sh.agree)
    best = _select_best(states, costs, trace, n_iters, n_valid=n_valid,
                        sh=sh)
    Z, C, alpha = best[0]
    return _fit_outputs(Z, sh, best, {
        'dictionary': alpha[:, None] * C if do_scale else C,
        'alpha': alpha}, n_valid)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


@apply_matmul_precision
def sharded_aa_train_step(mesh, X, Zs, Cs, alphas, *, delta=0.0,
                          do_scale=False, dict_iterations=5,
                          weights_iterations=50, weights_backend='auto',
                          restart_axis="restarts", sample_axis="samples"):
    """One full AA alternating iteration over a (restarts, samples) mesh.

    ``X`` (n_samples, n_features), its rows split over ``sample_axis``;
    ``Zs`` (R, n, k), restarts over ``restart_axis`` and rows over
    ``sample_axis``; ``Cs`` (R, k, n) and ``alphas`` (R, k), restarts
    split, each replicated within its sample group (updated only with
    ``do_scale``, in the box ``[1 - delta, 1 + delta]``).  ``R`` must
    divide over the restart axis and ``n`` over the sample axis.
    ``weights_backend`` 'auto' resolves as in :func:`sharded_aa_fit`.
    Returns the updated ``(Zs, Cs, alphas, costs)``, whole on every
    rank (``costs``: per-restart objective).
    """
    sh = _Shard(mesh, restart_axis, sample_axis)
    X = sh.take(X)
    n = X.shape[0]
    _, states = _local_states(sh, Zs, Cs, alphas, X.dtype, n)
    X_loc = X[sh.rows(n)]
    iterate, _ = _aa_iterate(
        X_loc, X_loc @ X.T, n_components=states[0].shape[-1],
        delta=float(delta), do_scale=do_scale, sh=sh,
        dictionary_solver_kwargs={'max_iterations': dict_iterations},
        weights_solver_kwargs={'backend': weights_backend,
                               'max_iterations': weights_iterations})
    Z_loc, C, alpha, costs = iterate(*states)

    def whole(t):
        return _all_gather(t, mesh, restart_axis)

    return (whole(sh.gather_rows(Z_loc, 1)), whole(C), whole(alpha),
            whole(costs))


@apply_matmul_precision
def sharded_aa_fit(mesh, X, Zs, Cs, alphas, *, delta=0.0, tolerance=1e-6,
                   max_iterations=100, stopping_criterion='abs_delta_f',
                   dictionary_solver_kwargs=None,
                   weights_solver_kwargs=None,
                   scale_factors_solver_kwargs=None,
                   n_valid_restarts=None,
                   restart_axis="restarts", sample_axis="samples"):
    """Full sharded AA fit to convergence with cross-mesh keep-best.

    The state layout of :func:`sharded_aa_train_step`.  Each restart
    runs the alternating loop until its ``stopping_criterion`` delta
    falls below ``tolerance`` (converged restarts freeze while the rest
    go on); the selection masks restarts of global index >=
    ``n_valid_restarts`` (padding for the restart axis) and broadcasts
    the winner.  The weights QP backend 'auto' runs the grouped kernels
    on a CUDA mesh (K1 at ``k <= 64``, K3 to 128) on each rank's rows,
    the row solver on a CPU mesh.

    Returns a dict with the best restart's ``weights`` (n, k),
    ``dictionary`` (``diag(alpha) C`` when ``delta != 0``), ``alpha``,
    ``cost``, ``n_iter`` and ``cost_deltas`` (``max_iterations`` long,
    0 after ``n_iter``), and per-restart ``costs`` and ``n_iters``
    (numpy), the same on every rank.
    """
    return _sharded_aa(
        mesh, X, Zs, Cs, alphas, has_data=True, delta=delta,
        tolerance=tolerance, max_iterations=max_iterations,
        stopping_criterion=stopping_criterion,
        dictionary_solver_kwargs=dictionary_solver_kwargs,
        weights_solver_kwargs=weights_solver_kwargs,
        scale_factors_solver_kwargs=scale_factors_solver_kwargs,
        n_valid_restarts=n_valid_restarts, restart_axis=restart_axis,
        sample_axis=sample_axis)


@apply_matmul_precision
def sharded_kernel_aa_fit(mesh, K, Zs, Cs, alphas, *, delta=0.0,
                          tolerance=1e-6, max_iterations=100,
                          stopping_criterion='abs_delta_f',
                          dictionary_solver_kwargs=None,
                          weights_solver_kwargs=None,
                          scale_factors_solver_kwargs=None,
                          n_valid_restarts=None,
                          restart_axis="restarts",
                          sample_axis="samples"):
    """Full sharded kernel-AA fit on a precomputed (n, n) kernel ``K``,
    its rows split over ``sample_axis``: :func:`sharded_aa_fit`'s
    contract and updates with the kernel trace-form cost.  A kernel from
    feature-split data can be formed with :func:`distributed_gram`."""
    return _sharded_aa(
        mesh, K, Zs, Cs, alphas, has_data=False, delta=delta,
        tolerance=tolerance, max_iterations=max_iterations,
        stopping_criterion=stopping_criterion,
        dictionary_solver_kwargs=dictionary_solver_kwargs,
        weights_solver_kwargs=weights_solver_kwargs,
        scale_factors_solver_kwargs=scale_factors_solver_kwargs,
        n_valid_restarts=n_valid_restarts, restart_axis=restart_axis,
        sample_axis=sample_axis)


@apply_matmul_precision
def sharded_gpnh_fit(mesh, X, Zs, Ws, *, lambda_W=0.0, tolerance=1e-6,
                     max_iterations=100, stopping_criterion='abs_delta_f',
                     weights_solver_kwargs=None, n_valid_restarts=None,
                     restart_axis="restarts", sample_axis="samples"):
    """Full sharded GPNH convex-coding fit with cross-mesh keep-best.

    ``X`` (n, d), rows split over ``sample_axis``; ``Zs`` (R, n, k) split
    over (restarts, samples); ``Ws`` (R, d, k) split over restarts and
    replicated within a sample group.  The iterate of
    ``parallel.gpnh_fit_restarts`` (:func:`_gpnh_iterate`): the exact
    k x k least-squares dictionary solve on all-reduced ``Z'Z`` and
    ``Z'X`` (broadcast from the sample group's first rank), the local
    weights QPs, and the trace-form cost in float64 with the GPNH
    penalty (the JAX function costs the residual form; the two agree to
    rounding).  Returns :func:`sharded_aa_fit`'s dict with
    ``dictionary`` the best ``W`` and no ``alpha``.
    """
    sh = _Shard(mesh, restart_axis, sample_axis)
    X = sh.take(X)
    n = X.shape[0]
    R = int(np.shape(Zs)[0])
    blk = sh.restarts(R)
    Zs = sh.take(Zs, X.dtype)[blk][:, sh.rows(n)].contiguous()
    Ws = sh.take(Ws, X.dtype)[blk].contiguous()
    n_valid = R if n_valid_restarts is None else int(n_valid_restarts)
    iterate, cost0 = _gpnh_iterate(
        X[sh.rows(n)], lambda_W=lambda_W, n_components=Zs.shape[-1],
        sh=sh, weights_solver_kwargs=weights_solver_kwargs)
    states, costs, trace, n_iters, _ = _keep_best_loop(
        (Zs, Ws), cost0(Zs, Ws), iterate, tolerance=tolerance,
        criterion=stopping_criterion, max_iterations=int(max_iterations),
        check_every=_ROUND, agree=sh.agree)
    best = _select_best(states, costs, trace, n_iters, n_valid=n_valid,
                        sh=sh)
    Z, W = best[0]
    return _fit_outputs(Z, sh, best, {'dictionary': W}, n_valid)
