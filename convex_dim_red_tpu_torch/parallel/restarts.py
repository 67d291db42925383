"""Best-of-``n_init`` archetypal analysis, kernel AA and GPNH convex
coding.

Port of the single-device grouped paths of
convex_dim_red_tpu/parallel/restarts.py.  The initial states of all
restarts are drawn at once on the device (random, or picked by
FurthestSum from one start index per restart).  A fit is two parts:

- the iterate, ``sharded_aa._aa_iterate`` or ``_gpnh_iterate`` on a
  ``_Shard`` of one device, built from the fit's solver settings: every
  restart of a batch advances one alternating iteration, the weights QPs
  of all in one grouped call;
- the schedule, :func:`_best_of_restarts`, which runs any iterate from
  given initial states, each restart frozen once it has converged
  (``sharded_aa._keep_best_loop``).

One scheduler drives the batch, :func:`_compacted_best`: restarts run
in rounds of M iterations, after each of which the converged ones retire
and the survivors are re-packed into dense chunks of ``restart_chunk``.
``compact_iterations=M`` sets the round; the default
(``compact_iterations=None``, the JAX package's one-shot grouped runner)
runs rounds of ``sharded_aa._ROUND``.  Every restart follows the
trajectory of one unchunked fit, so both settings give the JAX
one-shot runner's results restart for restart, and the fit stops once
every restart is done, as that runner's loop does.  The host reads only
per-round scalars.

Screened restarts (``screen_iterations``) run that scheduler twice
(:func:`_screened_best`): a bounded screening pass over every restart,
then a fresh run of the best few from their screened states.  Padded
``k`` (``pad_components_to``) runs every restart at a padded component
count with a mask that pins the padded weights to zero in the weights
QP (:func:`_padded_components`), so the fit is exactly an
``n_components`` model; the outputs are sliced back to
``n_components``.

With ``mesh=`` the restarts split over the mesh's ``restart_axis``
(:class:`_RestartGroups`, the JAX package's per-group compaction): every
rank draws the initial states of all restarts from the same generator
and seed, pads them to a multiple of the axis by tiling, keeps its
contiguous block and runs :func:`_compacted_best` on its own restarts,
with no collective inside the loops; the costs are then gathered, the
argmin chosen and the winner's state broadcast from its group.  A
screened fit prunes globally: every screen cost is gathered and ranked,
and the survivors are dealt out to the restart groups afresh.  So
``n_kept``, the survivors and the winner are the single-device run's.
A sample axis of the mesh, if any, replicates the work.  The vmapped
per-restart path (``grouped=False``) is not ported (ROADMAP.md queue 1,
item 18).
"""

import numpy as np
import torch

from ..models._common import STOPPING_CRITERIA, _fit_device, _generator_on
from ..models.archetypal_analysis import _scalar_dtype
from ..ops.furthest_sum import (dissimilarities_from_kernel,
                                furthest_sum_device)
from ..ops.stochastic_matrices import right_stochastic_matrix
from ..utils import profiling
from ..utils.precision import apply_matmul_precision
from ..utils.profiling import host_read, span, to_device
from ..utils.validation import as_input
from .iterate_graph import StepGraphs
from .mesh import (_all_gather, _axis, _broadcast, mesh_device,
                   require_device_mesh)
from .sharded_aa import (_ROUND, _aa_iterate, _gpnh_iterate,
                         _keep_best_loop, _Shard)

__all__ = ["aa_fit_restarts", "kernel_aa_fit_restarts",
           "gpnh_fit_restarts", "select_best"]


def select_best(costs, state):
    """The argmin-cost slice of each tensor of a stacked result: ``state``
    a tensor, or a tuple, list or dict of tensors, with the restart axis
    first."""
    best = int(torch.argmin(torch.as_tensor(costs)))
    if isinstance(state, dict):
        return {k: v[best] for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return type(state)(v[best] for v in state)
    return state[best]


class _RestartGroups:
    """The restart axis of a mesh as a restart population sees it: the
    population is padded by tiling to a multiple of the axis and split
    in contiguous blocks, one a group (the JAX package's ``_pad_keys``
    and per-group compaction); a rank runs only its block's real
    restarts.  Every collective runs on the restart axis."""

    def __init__(self, mesh, restart_axis):
        self.mesh = mesh
        self.axis = restart_axis
        self.size, self.index, _ = _axis(mesh, restart_axis)
        self.device = mesh_device(mesh)

    def block(self, R):
        """``(ids, R_loc)``: the global indices of this group's real
        restarts and the padded block width."""
        R_loc = -(-R // self.size)
        lo = self.index * R_loc
        return np.arange(lo, min(lo + R_loc, R)), R_loc

    def gather(self, values, R_loc, R, fill):
        """Every group's block of per-restart numbers, in global order
        (numpy float64, length ``R``)."""
        t = torch.full((R_loc,), fill, dtype=torch.float64,
                       device=self.device)
        t[:len(values)] = torch.as_tensor(np.asarray(values, np.float64))
        return host_read(_all_gather(t, self.mesh, self.axis)).numpy()[:R]

    def gather_states(self, states, R_loc, R):
        """Every group's block of each state tensor, in global order."""
        out = []
        for s in states:
            pad = s.new_zeros((R_loc,) + tuple(s.shape[1:]))
            pad[:s.shape[0]] = s
            out.append(_all_gather(pad, self.mesh, self.axis)[:R])
        return tuple(out)

    def broadcast(self, tensors, owner):
        return [_broadcast(t, self.mesh, self.axis, owner) for t in tensors]


def _padded_components(n_components, pad_components_to):
    """The component count of the fit and its mask, ``(k_fit, mask)``.

    ``mask`` is a (k_fit,) bool tensor on the CPU, true on the first
    ``n_components``: all true when ``pad_components_to ==
    n_components`` (as in the JAX package, where an exact multiple of a
    bucket shares the bucket's masked program), None when
    ``pad_components_to`` is None or below ``n_components``.  It stays
    on the host, where the QP kernels' wrappers read it."""
    if pad_components_to is None or int(pad_components_to) < n_components:
        return n_components, None
    k_pad = int(pad_components_to)
    return k_pad, torch.arange(k_pad) < n_components


def _masked_uniform_weights(generator, shape, component_mask, dtype,
                            device):
    """Row-stochastic weights of a padded fit: uniform draws times the
    mask, normalised per row, so the padded columns start at 0."""
    u = to_device(torch.rand(shape, generator=generator, dtype=dtype,
                             device=generator.device), device)
    u = u * component_mask.to(device, dtype)
    return u / u.sum(dim=-1, keepdim=True)


def _init_aa_state(generator, n_init, delta, *, n_samples, n_components,
                   init, diss, n_extra_steps, do_scale, dtype, device,
                   component_mask=None):
    """Initial states of ``n_init`` restarts: row-stochastic
    ``Z (R, n, k)``, ``C (R, k, n)`` and ``alpha (R, k)`` uniform in
    ``[1 - delta, 1 + delta]`` (ones without scale factors).  With
    ``init='furthest_sum'`` each restart draws a start index and ``C``
    is one-hot on the samples that :func:`furthest_sum_device` picks
    from the dissimilarities ``diss``; with ``'random'`` ``C`` is
    random.  ``component_mask`` (a padded fit, ``k`` the padded count):
    ``Z`` is uniform on the active columns and 0 on the padded ones, and
    FurthestSum picks ``k`` samples, the padded count.  Matches the JAX
    package's ``_init_aa_state`` in distribution."""
    if init == 'furthest_sum':
        starts = to_device(torch.randint(0, n_samples, (n_init,),
                                         generator=generator,
                                         device=generator.device), device)
        selected = furthest_sum_device(diss, n_components, starts,
                                       extra_steps=n_extra_steps)
        C = torch.nn.functional.one_hot(selected, n_samples).to(dtype)
    else:
        C = right_stochastic_matrix(
            generator, (n_init, n_components, n_samples), dtype=dtype,
            device=device)
    shape = (n_init, n_samples, n_components)
    if component_mask is None:
        Z = right_stochastic_matrix(generator, shape, dtype=dtype,
                                    device=device)
    else:
        Z = _masked_uniform_weights(generator, shape, component_mask,
                                    dtype, device)
    if do_scale:
        u = to_device(torch.rand((n_init, n_components),
                                 generator=generator, dtype=dtype,
                                 device=generator.device), device)
        alpha = (1.0 - delta) + 2.0 * delta * u
    else:
        alpha = torch.ones((n_init, n_components), dtype=dtype,
                           device=device)
    return Z, C, alpha


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

    The iterations run through one :class:`iterate_graph.StepGraphs`
    for all the rounds and chunks of the fit: on a CUDA device, and
    where ``iterate`` reads nothing on the host within an iteration,
    each chunk shape's iterations after its first are replays of one
    CUDA graph, on the same bits; elsewhere they are called directly.
    """
    graphs = StepGraphs(iterate)

    def run(states_all, idx, max_iterations):
        states = graphs.gather(states_all, idx)
        states, costs, trace, n_iters, done = _keep_best_loop(
            states, cost0(*states), iterate, tolerance=tolerance,
            criterion=criterion, max_iterations=max_iterations,
            advance=graphs)
        for s_all, s in zip(states_all, states):
            s_all[idx] = s
        return (states_all, *graphs.own((costs, trace, n_iters, done)))

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
    round are queued before any result is read, each in the span
    ``cdr.restarts.round``; the host then reads each chunk's scalars
    once, in the span ``cdr.restarts.read``, and adds the iterations
    of its distinct restarts to ``profiling.RESTART_ADVANCES``.

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
            with span("cdr.restarts.round"):
                idx = to_device(idx_np, device)
                states_all, *out = round_call(states_all, idx, M_round)
            outs.append((idx_np, out))

        next_pending = []
        for idx_np, out in outs:
            with span("cdr.restarts.read"):
                cs, tr, ni, done = (host_read(t).numpy() for t in out)
            seen = set()
            for j, i in enumerate(idx_np):
                if i in seen:
                    continue
                seen.add(i)
                n_iters[i] += ni[j]
                profiling.RESTART_ADVANCES += int(ni[j])
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
                       restart_chunk, round_iterations, groups=None):
    """:func:`_compacted_best` from the initial ``states``, which the
    population advances in (no copy of it is made).  Returns
    ``((*best_state, trace, best_cost, best_n_iter), costs, n_iters)``,
    ``costs`` and ``n_iters`` numpy arrays over all restarts.  With
    ``groups`` (a :class:`_RestartGroups`) each rank runs its block of
    ``states`` and every rank returns the global result."""
    if groups is not None:
        return _group_best_of_compacted(
            states, round_call, groups, max_iterations=max_iterations,
            restart_chunk=restart_chunk, round_iterations=round_iterations)
    states_all, costs, n_iters, traces, best = _compacted_best(
        states[0].shape[0], states, max_iterations=max_iterations,
        restart_chunk=restart_chunk, round_iterations=round_iterations,
        round_call=round_call)
    trace_b = (np.concatenate(traces[best]) if traces[best]
               else np.zeros((0,)))
    return ((*(s[best] for s in states_all), trace_b, float(costs[best]),
             int(n_iters[best])), costs, n_iters)


def _group_best_of_compacted(states, round_call, groups, **schedule):
    """:func:`_best_of_compacted` over the restart groups of a mesh: this
    group's real restarts run here, the costs and iteration counts of
    all are gathered, and the winner (the lowest global index among
    equal costs) comes from its group by broadcast."""
    R = states[0].shape[0]
    ids, R_loc = groups.block(R)
    costs_loc = iters_loc = ()
    best_loc = None
    if len(ids):
        idx = torch.as_tensor(ids, device=states[0].device)
        best_loc, costs_loc, iters_loc = _best_of_compacted(
            tuple(s[idx] for s in states), round_call, **schedule)
    costs = groups.gather(costs_loc, R_loc, R, np.inf)
    n_iters = groups.gather(iters_loc, R_loc, R, 0).astype(np.int64)
    best = int(np.argmin(costs))
    owner = best // R_loc
    n_iter = int(n_iters[best])
    if best_loc is not None and owner == groups.index:
        parts = list(best_loc[:-3]) + [torch.as_tensor(
            best_loc[-3][:n_iter], dtype=torch.float64,
            device=groups.device)]
    else:
        parts = [s[0].new_zeros(s.shape[1:]) for s in states] + [
            torch.zeros((n_iter,), dtype=torch.float64,
                        device=groups.device)]
    parts = groups.broadcast(parts, owner)
    best_tuple = (*parts[:-1], host_read(parts[-1]).numpy(),
                  float(costs[best]), n_iter)
    return best_tuple, costs, n_iters


def _screened_best(states, round_call, *, max_iterations,
                   screen_iterations, restart_chunk, screen_keep,
                   screen_margin=None, groups=None):
    """Screened keep-best: screen every restart, prune, resume the best
    (the JAX package's ``_screened_best``, for both families).

    Every restart runs at most ``screen_iterations`` iterations from
    ``states`` (advanced in place, as in :func:`_best_of_compacted`).
    The ``n_keep = max(1, ceil(screen_keep
    R))`` lowest screened costs survive; the ``n_keep``-th is the cut,
    and with ``screen_margin`` every restart whose screened cost is at
    most the cut plus the margin survives too.  The survivors then run
    afresh from their screened states for up to ``max_iterations``
    iterations (not what the screen left over): a new initial cost and
    nothing carried over, so a restart that stopped in the screen runs
    again, as in the JAX package's resume runner.

    Both phases are :func:`_compacted_best` in rounds of
    :data:`_ROUND` over chunks of ``restart_chunk``; a frozen
    restart does not change, so every restart ends as it does under the
    JAX package's screen and resume runners.

    Returns ``(best, costs, n_iters, screen)``: ``best = (*state, trace,
    cost, n_iter)`` of the winner, its trace and ``n_iter`` covering its
    resume only; ``costs`` (a pruned restart's screened cost) and
    ``n_iters`` (screen plus resume for a survivor) over all restarts,
    numpy; ``screen`` the diagnostics ``n_screened``, ``n_kept``,
    ``screen_cut`` and ``screen_margin_observed``, the best pruned
    screened cost minus the worst kept (``inf`` when none is pruned).

    With ``groups`` (a mesh's :class:`_RestartGroups`) each group
    screens its block; the screen costs and screened states are
    gathered, so the prune is global, and the survivors are dealt out
    to the groups afresh for the resume.
    """
    R = states[0].shape[0]
    screen = dict(max_iterations=int(screen_iterations),
                  restart_chunk=restart_chunk,
                  round_iterations=_ROUND, round_call=round_call)
    if groups is None:
        screened, screen_costs, screen_iters, _, _ = _compacted_best(
            R, states, **screen)
    else:
        ids, R_loc = groups.block(R)
        local = tuple(s[torch.as_tensor(ids, device=s.device)]
                      for s in states)
        screen_costs = screen_iters = ()
        if len(ids):
            local, screen_costs, screen_iters, _, _ = _compacted_best(
                len(ids), local, **screen)
        screened = groups.gather_states(local, R_loc, R)
        screen_costs = groups.gather(screen_costs, R_loc, R, np.inf)
        screen_iters = groups.gather(screen_iters, R_loc, R,
                                     0).astype(np.int64)

    order = np.argsort(screen_costs)
    n_keep = max(1, int(np.ceil(float(screen_keep) * R)))
    cut = float(screen_costs[order[n_keep - 1]])
    if screen_margin is not None:
        n_keep = max(n_keep, int(np.sum(
            screen_costs <= cut + float(screen_margin))))
    survivors, pruned = order[:n_keep], order[n_keep:]
    screen = {
        'n_screened': int(R),
        'n_kept': int(n_keep),
        'screen_cut': cut,
        'screen_margin_observed': (
            float(screen_costs[pruned].min()
                  - screen_costs[survivors].max())
            if pruned.size else float('inf')),
    }

    idx = torch.as_tensor(survivors, device=screened[0].device)
    best, res_costs, res_iters = _best_of_compacted(
        tuple(s[idx] for s in screened), round_call,
        max_iterations=int(max_iterations), restart_chunk=restart_chunk,
        round_iterations=_ROUND, groups=groups)

    costs = screen_costs.copy()
    n_iters = screen_iters.copy()
    costs[survivors] = res_costs
    n_iters[survivors] = screen_iters[survivors] + res_iters
    return best, costs, n_iters, screen


@apply_matmul_precision
def _best_of_restarts(iterate, cost0, states, *, tolerance, criterion,
                      max_iterations, restart_chunk, compact_iterations,
                      screen_iterations, screen_keep, screen_margin,
                      groups=None):
    """The best restart of a population, from its initial ``states`` (a
    tuple of tensors, the restart axis first), under a family's
    ``iterate`` and ``cost0`` (``sharded_aa._aa_iterate`` or
    ``_gpnh_iterate`` on a :class:`sharded_aa._Shard` of one device).
    The population advances in ``states``, with no copy of it (at the
    HadISST scale a copy is 8.6 MB of the card's peak): a caller that
    reads its initial states again passes copies.

    ``screen_iterations`` runs the screened scheduler
    (:func:`_screened_best`); otherwise :func:`_compacted_best` runs in
    rounds of ``compact_iterations``, or of :data:`_ROUND` for the
    one-shot default (None).  An integer ``compact_iterations`` with
    ``screen_iterations`` raises ``ValueError``, as in the JAX package.
    ``groups`` (a mesh's :class:`_RestartGroups`) splits the restarts
    over the mesh's restart groups.

    Returns ``(best, costs, n_iters, screen)``: ``best = (*state,
    trace, cost, n_iter)`` of the winner, ``costs`` and ``n_iters``
    numpy arrays over all restarts, ``screen`` the screen's diagnostics
    (None unless screened)."""
    if compact_iterations is not None and screen_iterations is not None:
        raise ValueError("compact_iterations and screen_iterations "
                         "are mutually exclusive (compaction is the "
                         "exact-protocol scheduler, screening the "
                         "pruning heuristic)")
    run = _round_run(iterate, cost0, tolerance=tolerance,
                     criterion=criterion)
    schedule = dict(max_iterations=int(max_iterations),
                    restart_chunk=restart_chunk, groups=groups)
    if screen_iterations is not None:
        return _screened_best(
            states, run, screen_iterations=int(screen_iterations),
            screen_keep=float(screen_keep), screen_margin=screen_margin,
            **schedule)
    best, costs, n_iters = _best_of_compacted(
        states, run, round_iterations=(_ROUND if compact_iterations is None
                                       else int(compact_iterations)),
        **schedule)
    return best, costs, n_iters, None


def _check_fit_args(init, stopping_criterion, n_init, mesh, restart_axis,
                    grouped):
    """The public entries' argument checks, each raising ``ValueError``:
    ``mesh`` None or a DeviceMesh with the axis ``restart_axis`` (any
    other axis replicates the work), ``grouped`` None or True, ``init``,
    the stopping criterion and ``n_init``."""
    if mesh is not None:
        require_device_mesh(mesh)
        if restart_axis not in (mesh.mesh_dim_names or ()):
            raise ValueError("mesh has no restart axis %r; got "
                             "axis_names=%r"
                             % (restart_axis, tuple(mesh.mesh_dim_names)))
    if grouped is not None and not grouped:
        raise ValueError("grouped=False selects the vmapped per-restart "
                         "path, which is not ported (ROADMAP.md queue 1, "
                         "item 18); the grouped runners are the only "
                         "restart structure")
    if init not in ('random', 'furthest_sum'):
        raise ValueError("init must be 'random' or 'furthest_sum', got %r"
                         % (init,))
    if stopping_criterion not in STOPPING_CRITERIA:
        raise ValueError("unsupported stopping criterion %r"
                         % (stopping_criterion,))
    if int(n_init) < 1:
        raise ValueError("n_init must be >= 1, got %r" % (n_init,))


def _restart_groups(mesh, restart_axis):
    return None if mesh is None else _RestartGroups(mesh, restart_axis)


def _result(best, costs, n_iters, screen):
    """The result dict's keys of every family, from
    :func:`_best_of_restarts`: the winner's ``cost``, ``n_iter`` and
    ``cost_deltas``, and ``costs``, ``n_iters`` and ``best_index`` over
    all restarts, and ``screen`` when screened."""
    trace, cost, n_iter = best[-3:]
    out = {'cost': cost, 'n_iter': n_iter,
           'cost_deltas': np.asarray(trace)[:n_iter], 'costs': costs,
           'n_iters': n_iters, 'best_index': int(np.argmin(costs))}
    if screen is not None:
        out['screen'] = screen
    return out


def _aa_restarts(X, gram, n_components, generator, n_init, *, has_data,
                 delta, init, tolerance, max_iterations, n_extra_steps,
                 stopping_criterion, dictionary_solver_kwargs,
                 weights_solver_kwargs, scale_factors_solver_kwargs,
                 pad_components_to, mesh, restart_axis, **schedule):
    """The fit of :func:`aa_fit_restarts` (``has_data``: ``X`` is the
    data, ``gram`` its Gram) and :func:`kernel_aa_fit_restarts` (both
    the kernel); ``schedule`` the scheduler arguments of
    :func:`_best_of_restarts`.  Returns ``(Z, C, alpha, out)``: the
    winner's factors sliced back to ``n_components`` and the keys of
    :func:`_result`."""
    generator = _generator_on(generator, X.device, mesh=mesh)
    k_out = int(n_components)
    k_fit, component_mask = _padded_components(k_out, pad_components_to)
    do_scale = float(delta) != 0.0

    # The iterate first: building the cost's factor of the Gram needs the
    # room that the initial states take.
    iterate, cost0 = _aa_iterate(
        X if has_data else None, gram, n_components=k_fit,
        delta=float(delta), do_scale=do_scale, sh=_Shard(device=X.device),
        dictionary_solver_kwargs=dictionary_solver_kwargs,
        weights_solver_kwargs=weights_solver_kwargs,
        scale_factors_solver_kwargs=scale_factors_solver_kwargs,
        trace_K=(None if has_data
                 else torch.trace(gram).to(_scalar_dtype(gram.dtype))),
        component_mask=component_mask)
    diss = dissimilarities_from_kernel(gram) if init == 'furthest_sum' \
        else None
    states = _init_aa_state(
        generator, int(n_init), float(delta), n_samples=gram.shape[0],
        n_components=k_fit, init=init, diss=diss,
        n_extra_steps=int(n_extra_steps), do_scale=do_scale,
        dtype=gram.dtype, device=gram.device,
        component_mask=component_mask)
    del diss
    best, costs, n_iters, screen = _best_of_restarts(
        iterate, cost0, states, tolerance=float(tolerance),
        criterion=stopping_criterion, max_iterations=max_iterations,
        groups=_restart_groups(mesh, restart_axis), **schedule)

    Z, C, alpha = best[:3]
    if component_mask is not None:
        Z, C, alpha = Z[:, :k_out], C[:k_out], alpha[:k_out]
    return Z, C, alpha, _result(best, costs, n_iters, screen)


@apply_matmul_precision
def aa_fit_restarts(data, n_components, generator, n_init, delta=0.0,
                    init='furthest_sum', tolerance=1e-6,
                    max_iterations=500, n_extra_steps=10,
                    stopping_criterion='abs_delta_f',
                    dictionary_solver_kwargs=None,
                    weights_solver_kwargs=None,
                    scale_factors_solver_kwargs=None,
                    mesh=None, restart_axis='restarts',
                    restart_chunk=None, pad_components_to=None,
                    screen_iterations=None, screen_keep=0.25,
                    screen_margin=None, grouped=None,
                    compact_iterations=None, device=None):
    """Best-of-``n_init`` archetypal analysis, on one device or over the
    restart axis of a mesh.

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
    JAX package's one-shot runner and runs rounds of :data:`_ROUND`;
    every restart follows the same trajectory whatever the round and
    chunk, so the results are that runner's.
    ``weights_solver_kwargs['backend']`` 'auto' resolves with the JAX
    package's grouped-fit rule: the kernels on a CUDA device (k <= 128),
    the row solver on the CPU; another backend than 'xla', 'pallas' and
    'auto' raises ``ValueError`` before the first iteration.  Where the
    weights do not run on the kernels (the CPU, ``backend='xla'``), the
    JAX package falls back to its vmapped per-restart path under
    ``grouped=None``; the port keeps the grouped structure with the row
    solver.

    ``screen_iterations`` runs screened restarts (:func:`_screened_best`):
    every restart runs that many iterations at most, the best
    ``screen_keep`` fraction (and, with ``screen_margin``, every
    restart within that many cost units of the cut) resumes afresh to
    convergence.  It is a heuristic: the winner is the unscreened one's
    when that restart survives the screen.  An integer
    ``compact_iterations`` with it raises ``ValueError``.  The result
    then has a ``screen`` dict (``n_screened``, ``n_kept``,
    ``screen_cut``, ``screen_margin_observed``); ``n_iter`` and
    ``cost_deltas`` describe the winner's resume phase, ``n_iters`` the
    per-restart totals.

    ``pad_components_to`` runs the fit padded to that many components
    (when it is at least ``n_components``): the padded weights are
    pinned to exactly 0 by the weights QP's mask, so the fit is an
    ``n_components`` model, and the outputs are sliced back to
    ``n_components``.  Padded restarts start from other random states
    than unpadded ones (and FurthestSum picks as many samples as the
    padded count), so their costs differ at the level of restart noise.
    The JAX package pads so that one compiled program serves a bucket
    of ``k``; the port compiles nothing per ``k``, so padding only adds
    width (the sweeps' ``component_bucket`` is off by default).

    ``mesh`` (a DeviceMesh with the axis ``restart_axis``; see
    :mod:`.mesh`) splits the restarts over the restart groups: every
    rank calls with the same arguments, runs its block of the
    restarts (padded by tiling to a multiple of the axis, the pads out of
    the selection) on the mesh's device, and returns the whole result;
    screening prunes over all restarts.  The winner, its cost, ``costs``
    and ``n_iters`` are the single-device run's from the same seed.
    ``grouped`` is None or True; False (the vmapped path) raises
    ``ValueError`` naming the ROADMAP.md item that keeps it out.

    Returns a dict with the best restart's ``weights``, ``dictionary``,
    ``alpha``, ``archetypes`` (tensors), ``cost`` and ``n_iter``, its
    ``cost_deltas``, and ``costs``, ``n_iters`` and ``best_index`` over
    all restarts (numpy), and ``screen`` when screened.
    """
    _check_fit_args(init, stopping_criterion, n_init, mesh, restart_axis,
                    grouped)

    with span("cdr.fit"):
        X = as_input(data, _fit_device(mesh, device))
        # The Gram, once per fit: every round and chunk takes it.
        gram = _gram_once(X)
        Z, C, alpha, out = _aa_restarts(
            X, gram, n_components, generator, n_init, has_data=True,
            delta=delta, init=init, tolerance=tolerance,
            max_iterations=max_iterations, n_extra_steps=n_extra_steps,
            stopping_criterion=stopping_criterion,
            dictionary_solver_kwargs=dictionary_solver_kwargs,
            weights_solver_kwargs=weights_solver_kwargs,
            scale_factors_solver_kwargs=scale_factors_solver_kwargs,
            restart_chunk=restart_chunk,
            pad_components_to=pad_components_to,
            screen_iterations=screen_iterations, screen_keep=screen_keep,
            screen_margin=screen_margin,
            compact_iterations=compact_iterations, mesh=mesh,
            restart_axis=restart_axis)
        dictionary = alpha[:, None] * C if float(delta) != 0.0 else C
        return dict(weights=Z, dictionary=dictionary, alpha=alpha,
                    archetypes=dictionary @ X, **out)


@apply_matmul_precision
def kernel_aa_fit_restarts(kernel, n_components, generator, n_init,
                           delta=0.0, init='furthest_sum', tolerance=1e-6,
                           max_iterations=500, n_extra_steps=10,
                           stopping_criterion='abs_delta_f',
                           dictionary_solver_kwargs=None,
                           weights_solver_kwargs=None,
                           scale_factors_solver_kwargs=None,
                           mesh=None, restart_axis='restarts',
                           restart_chunk=None, pad_components_to=None,
                           screen_iterations=None, screen_keep=0.25,
                           screen_margin=None, grouped=None,
                           compact_iterations=None, device=None):
    """Best-of-``n_init`` kernel AA on a precomputed (n, n) kernel
    matrix, for ``KernelAA`` users.

    :func:`aa_fit_restarts` on a kernel: the same arguments, schedulers
    (compaction, screening), padded ``k``, device rule and ``mesh``, with
    FurthestSum on the kernel's dissimilarities and the trace-form cost
    ``0.5 (tr K - 2 tr(diag(alpha) C K Z) + tr(Z'Z diag(alpha) C K C'
    diag(alpha))) / n``, as there is no data matrix.

    Returns a dict with the best restart's ``weights``, ``dictionary``
    and ``alpha`` (tensors), ``cost``, ``n_iter``, ``cost_deltas``, and
    ``costs``, ``n_iters`` and ``best_index`` over all restarts (numpy),
    and ``screen`` when screened.  There are no ``archetypes``, and
    ``dictionary`` is ``C`` itself, not ``diag(alpha) C`` as in
    :func:`aa_fit_restarts` (as in the JAX package).
    """
    _check_fit_args(init, stopping_criterion, n_init, mesh, restart_axis,
                    grouped)

    with span("cdr.fit"):
        K = as_input(kernel, _fit_device(mesh, device))
        if K.ndim != 2 or K.shape[0] != K.shape[1]:
            raise ValueError("expected a square kernel matrix, got shape "
                             "%s" % (tuple(K.shape),))
        Z, C, alpha, out = _aa_restarts(
            K, K, n_components, generator, n_init, has_data=False,
            delta=delta, init=init, tolerance=tolerance,
            max_iterations=max_iterations, n_extra_steps=n_extra_steps,
            stopping_criterion=stopping_criterion,
            dictionary_solver_kwargs=dictionary_solver_kwargs,
            weights_solver_kwargs=weights_solver_kwargs,
            scale_factors_solver_kwargs=scale_factors_solver_kwargs,
            restart_chunk=restart_chunk,
            pad_components_to=pad_components_to,
            screen_iterations=screen_iterations, screen_keep=screen_keep,
            screen_margin=screen_margin,
            compact_iterations=compact_iterations, mesh=mesh,
            restart_axis=restart_axis)
        return dict(weights=Z, dictionary=C, alpha=alpha, **out)


# ---------------------------------------------------------------------------
# GPNH convex coding
# ---------------------------------------------------------------------------


def _init_gpnh_state(generator, X, diss, n_init, *, n_components, init,
                     n_extra_steps, component_mask=None):
    """Initial states of ``n_init`` GPNH restarts: row-stochastic
    ``Z (R, n, k)`` and ``W (R, d, k)``, either ``sqrt(mean|X| / k)
    N(0, 1)`` or, with ``init='furthest_sum'``, the data rows that
    :func:`furthest_sum_device` picks from the dissimilarities ``diss``,
    one random start index per restart.  The numbers are drawn on
    ``generator``'s device and moved to ``X``'s.

    ``component_mask`` (a padded fit, ``k`` the padded count): the
    random dictionary's scale takes the active count, ``sqrt(mean|X| /
    k_act)``; the padded columns of ``W`` are 0 and ``Z`` is uniform on
    the active columns.  A padded init is not the unpadded one embedded:
    it draws other numbers.  Matches the JAX package's
    ``_init_gpnh_state`` in distribution."""
    n_samples, n_features = X.shape
    dtype = X.dtype
    if init == 'furthest_sum':
        starts = to_device(torch.randint(0, n_samples, (n_init,),
                                         generator=generator,
                                         device=generator.device),
                           X.device)
        selected = furthest_sum_device(diss, n_components, starts,
                                       extra_steps=n_extra_steps)
        W = X[selected].transpose(1, 2).contiguous()
    else:
        k_act = (n_components if component_mask is None
                 else int(component_mask.sum()))
        avg = torch.sqrt(torch.mean(torch.abs(X)) / k_act)
        W = avg * to_device(torch.randn((n_init, n_features, n_components),
                                        generator=generator, dtype=dtype,
                                        device=generator.device), X.device)
    shape = (n_init, n_samples, n_components)
    if component_mask is None:
        Z = right_stochastic_matrix(generator, shape, dtype=dtype,
                                    device=X.device)
    else:
        W = W * component_mask.to(X.device, dtype)
        Z = _masked_uniform_weights(generator, shape, component_mask,
                                    dtype, X.device)
    return Z, W


@apply_matmul_precision
def gpnh_fit_restarts(data, n_components, generator, n_init, lambda_W=0.0,
                      init='random', tolerance=1e-6, max_iterations=500,
                      n_extra_steps=10, stopping_criterion='abs_delta_f',
                      weights_solver_kwargs=None, mesh=None,
                      restart_axis='restarts', restart_chunk=None,
                      pad_components_to=None, screen_iterations=None,
                      screen_keep=0.25, screen_margin=None, grouped=None,
                      compact_iterations=None, device=None):
    """Best-of-``n_init`` GPNH convex coding, on one device or over the
    restart axis of a mesh.

    ``data``, ``generator``, ``device``, the schedulers
    (``compact_iterations``, ``restart_chunk``, ``screen_iterations``,
    ``screen_keep``, ``screen_margin``), ``grouped``, ``restart_axis``,
    the weights backend and the options that raise are as in
    :func:`aa_fit_restarts`.  ``init``: 'random' (the default) or
    'furthest_sum' (on the device, ``n_extra_steps`` refinement passes).
    ``pad_components_to`` runs a padded fit (the masked penalty takes
    the active count, so the fit optimizes the ``n_components``
    objective; the padded columns of both factors stay exactly 0) and
    slices the outputs back to ``n_components``.

    Returns a dict with the best restart's ``weights`` and
    ``dictionary`` (tensors), ``cost``, ``n_iter`` and ``cost_deltas``,
    and ``costs``, ``n_iters`` and ``best_index`` over all restarts
    (numpy), and ``screen`` when screened.
    """
    _check_fit_args(init, stopping_criterion, n_init, mesh, restart_axis,
                    grouped)

    with span("cdr.fit"):
        X = as_input(data, _fit_device(mesh, device))
        generator = _generator_on(generator, X.device, mesh=mesh)
        k_out = int(n_components)
        k_fit, component_mask = _padded_components(k_out, pad_components_to)

        diss = (dissimilarities_from_kernel(_gram_once(X))
                if init == 'furthest_sum' else None)
        states = _init_gpnh_state(generator, X, diss, int(n_init),
                                  n_components=k_fit, init=init,
                                  n_extra_steps=int(n_extra_steps),
                                  component_mask=component_mask)
        iterate, cost0 = _gpnh_iterate(
            X, lambda_W=float(lambda_W), n_components=k_fit,
            sh=_Shard(device=X.device),
            weights_solver_kwargs=weights_solver_kwargs,
            component_mask=component_mask)
        best, costs, n_iters, screen = _best_of_restarts(
            iterate, cost0, states, tolerance=float(tolerance),
            criterion=stopping_criterion, max_iterations=max_iterations,
            restart_chunk=restart_chunk,
            compact_iterations=compact_iterations,
            screen_iterations=screen_iterations, screen_keep=screen_keep,
            screen_margin=screen_margin,
            groups=_restart_groups(mesh, restart_axis))

        Z, W = best[:2]
        if component_mask is not None:
            Z, W = Z[:, :k_out], W[:, :k_out]
        return dict(weights=Z, dictionary=W,
                    **_result(best, costs, n_iters, screen))
