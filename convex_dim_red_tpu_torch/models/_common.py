"""Shared model plumbing: solver configs, stopping criteria and the
estimators' common driving (random state, ``mesh=``, the single-fit
loop with its verbose table).

Port of convex_dim_red_tpu/models/_common.py.  The configs keep the
JAX package's fields and defaults, so a kwargs dict written for one
package builds the same config in the other.  ``prepare_estimator_mesh``
validates and lifts an estimator's ``mesh=`` (parallel/mesh.py).
"""

import numbers
import time
from dataclasses import dataclass, fields

import numpy as np
import torch

from ..utils.profiling import host_read

__all__ = [
    "QPSolverConfig",
    "SPGSolverConfig",
    "make_config",
    "check_estimator_params",
    "STOPPING_CRITERIA",
    "has_converged",
    "prepare_estimator_mesh",
]


@dataclass(frozen=True)
class QPSolverConfig:
    """Parameters of the simplex-QP SPG solver.

    ``backend``: 'pallas' (the JAX package's name for its fused-kernel
    route, kept so configs carry over) runs the hand-written QP kernels
    of ops/simplex_qp.py, 'xla' the row solver
    (solvers/spg.py:quad_simplex_spg), and the default 'auto' picks per
    call regime (solvers/spg.py:resolve_qp_backend): the kernels for
    one-shot and restart-grouped solves on a CUDA device, the row
    solver inside single fits and on the CPU.
    """
    backend: str = 'auto'
    gamma: float = 1e-4
    memory: int = 1
    sigma_one: float = 0.1
    sigma_two: float = 0.9
    lambda_min: float = 1e-10
    alpha0: float = -1.0
    alpha_min: float = 1e-5
    alpha_max: float = 1e3
    epsilon_one: float = 1e-10
    epsilon_two: float = 1e-6
    max_iterations: int = 1000
    max_feval: int = 2000

    def kwargs(self):
        """The solver arguments: every field but ``backend``."""
        return {f.name: getattr(self, f.name) for f in fields(self)
                if f.name != 'backend'}


@dataclass(frozen=True)
class SPGSolverConfig:
    """Parameters of the generic SPG solver."""
    gamma: float = 1e-4
    memory: int = 1
    sigma_one: float = 0.1
    sigma_two: float = 0.9
    lambda_min: float = 1e-10
    alpha0: float = None
    alpha_min: float = 1e-5
    alpha_max: float = 1e3
    epsilon_one: float = 1e-10
    epsilon_two: float = 1e-6
    use_infinity_norm: bool = True
    max_iterations: int = 10000
    max_feval: int = 1000000

    def kwargs(self):
        return {f.name: getattr(self, f.name) for f in fields(self)}


def make_config(cls, kwargs):
    """Build a solver config from a reference-style kwargs dict.

    Unknown keys are rejected so typos surface instead of silently
    falling back to defaults.
    """
    if kwargs is None:
        return cls()
    if isinstance(kwargs, cls):
        return kwargs
    valid = {f.name for f in fields(cls)}
    unknown = set(kwargs) - valid
    if unknown:
        raise ValueError(
            'Unknown solver parameters %r; valid keys: %r'
            % (sorted(unknown), sorted(valid)))
    return cls(**kwargs)


def check_estimator_params(n_components, max_iterations, tolerance):
    """The estimators' parameter checks, with the JAX package's
    messages."""
    if not isinstance(n_components, (numbers.Integral, np.integer)) \
            or n_components <= 0:
        raise ValueError(
            'Number of components must be a positive integer;'
            ' got (n_components=%r)' % n_components)
    if not isinstance(max_iterations, (numbers.Integral, np.integer)) \
            or max_iterations <= 0:
        raise ValueError(
            'Maximum number of iterations must be a positive integer;'
            ' got (max_iterations=%r)' % max_iterations)
    if not isinstance(tolerance, numbers.Number) or tolerance < 0:
        raise ValueError(
            'Tolerance for stopping criteria must be positive;'
            ' got (tolerance=%r)' % tolerance)


STOPPING_CRITERIA = ('abs_delta_f', 'rel_delta_f')


def has_converged(old_cost, new_cost, tolerance, criterion):
    """Elementwise stopping test on cost tensors (reference
    ``_get_stopping_criteria``, archetypal_analysis.py:177-197)."""
    if criterion == 'abs_delta_f':
        return torch.abs(new_cost - old_cost) < tolerance
    if criterion == 'rel_delta_f':
        max_cost = torch.maximum(torch.abs(new_cost), torch.abs(old_cost))
        return torch.abs((new_cost - old_cost) / max_cost) < tolerance
    raise ValueError("unsupported stopping criterion '%s'" % criterion)


def _as_generator(random_state):
    """Coerce an int / None / ``numpy.random.RandomState`` /
    ``torch.Generator`` into a ``torch.Generator`` (a CPU one unless a
    generator is given)."""
    if isinstance(random_state, torch.Generator):
        return random_state
    if random_state is None:
        seed = np.random.randint(2 ** 31 - 1)
    elif isinstance(random_state, np.random.RandomState):
        seed = random_state.randint(2 ** 31 - 1)
    elif isinstance(random_state, (int, np.integer)):
        seed = int(random_state)
    else:
        raise TypeError("random_state must be an int, None, a "
                        "numpy.random.RandomState or a torch.Generator; "
                        "got %r" % (random_state,))
    return torch.Generator().manual_seed(seed)


def _generator_on(random_state, device, mesh=None):
    """A ``torch.Generator`` as given, or one on ``device`` seeded from
    ``random_state`` (an integer, None or a ``numpy.random.RandomState``,
    read as :func:`_as_generator` reads it).  With ``mesh`` the seed is
    the mesh's first rank's, so every rank draws the same numbers (a
    ``None`` seed is drawn once)."""
    if isinstance(random_state, torch.Generator):
        return random_state
    seed = _as_generator(random_state).initial_seed()
    if mesh is not None:
        # Deferred: parallel imports this module.
        from ..parallel.mesh import _agree_object
        seed = _agree_object(seed, mesh)
    return torch.Generator(device=device).manual_seed(seed)


def prepare_estimator_mesh(mesh, n_samples, whom, dim_name='n_samples',
                           single_fit=True):
    """Validate an estimator's ``mesh=`` and lift it to both axes
    (:func:`parallel.mesh.ensure_mesh_axes`).

    Most estimators run a single fit, so every rank goes on the sample
    axis: a 2-D mesh must have a restart axis of size 1 (the multi-
    restart fits are ``parallel.aa_fit_restarts`` and
    ``parallel.sharded_*_fit``); ``single_fit=False`` is for estimators
    with a restart batch of their own (KMeans' ``n_init``).  The sample
    axis must divide ``n_samples``.  Raises ``ValueError`` as the JAX
    function does.
    """
    # Deferred: parallel imports this module.
    from ..parallel.mesh import ensure_mesh_axes

    mesh = ensure_mesh_axes(mesh)
    names = mesh.mesh_dim_names
    n_restart_shards = mesh.size(names.index('restarts'))
    if single_fit and n_restart_shards != 1:
        raise ValueError(
            "%s: estimator-level mesh= runs one fit, so the 'restarts' "
            "mesh axis must have size 1 (got %d); shard multi-restart "
            "fits with parallel.aa_fit_restarts / parallel.sharded_*_fit"
            % (whom, n_restart_shards))
    n_shards = mesh.size(names.index('samples'))
    if n_samples % n_shards:
        raise ValueError(
            "%s: %s (%d) must be divisible by the mesh sample axis (%d "
            "ranks); pad or subset the data, or use a smaller mesh"
            % (whom, dim_name, n_samples, n_shards))
    return mesh


def _fit_device(mesh, device):
    """Where a fit runs: the mesh's device (its device type decides),
    else ``device`` as :func:`utils.validation.as_input` reads it."""
    if mesh is None:
        return device
    from ..parallel.mesh import mesh_device
    return mesh_device(mesh)


def _check_mesh(mesh):
    """An estimator's ``mesh`` at construction: None, or a DeviceMesh
    with the mesh axes; anything else raises ``ValueError`` naming
    ``mesh``."""
    from ..parallel.mesh import check_mesh
    check_mesh(mesh)


#: Iterations per chunk of the verbose table (see :func:`_run_fit`), as
#: in the JAX package.
_VERBOSE_CHUNK = 10


def _run_fit(core, state, max_iterations, verbose, title, rule):
    """Drive a single-fit core to its end.

    ``core(state, m) -> (state, cost, n_iter, cost_trace, inc_flags,
    stop)`` runs up to ``m`` iterations from the tuple ``state``.
    Quiet: one call.  Verbose: prints ``title``, the reference's table
    header and a rule of ``rule`` dashes, then runs chunks of
    :data:`_VERBOSE_CHUNK` iterations, each resuming from the last one's
    state as the JAX package does, with one row per iteration (its time
    is the chunk's wall time per iteration), and the converged line when
    the criterion fired.  Returns ``(state, cost, n_iter, cost_deltas,
    inc_flags)``, the last two numpy arrays.
    """
    max_iterations = int(max_iterations)
    if not verbose:
        state, cost, n_iter, trace, inc, _ = core(state, max_iterations)
        return (state, cost, n_iter, host_read(trace[:n_iter]).numpy(),
                host_read(inc).numpy())

    print(title)
    print('{:<12s} | {:<13s} | {:<13s} | {:<12s}'.format(
        'Iteration', 'Cost', 'Cost delta', 'Time'))
    print(rule * '-')
    row = '{:12d} | {: 12.6e} | {: 12.6e} | {: 12.6e}'
    n_iter = 0
    stop = False
    deltas_parts = []
    inc_flags = None
    while not stop and n_iter < max_iterations:
        this_chunk = min(_VERBOSE_CHUNK, max_iterations - n_iter)
        t0 = time.perf_counter()
        state, cost, n_it, trace, inc, stop = core(state, this_chunk)
        dt = time.perf_counter() - t0
        deltas = host_read(trace[:n_it]).numpy()
        # Cost after in-chunk iteration i: the chunk's final cost minus
        # the deltas still to come.
        suffix = np.cumsum(deltas[::-1])[::-1]
        costs = float(host_read(cost)) - suffix + deltas
        for i in range(n_it):
            print(row.format(n_iter + i + 1, costs[i], deltas[i], dt / n_it))
        deltas_parts.append(deltas)
        inc = host_read(inc).numpy()
        inc_flags = inc if inc_flags is None else inc_flags | inc
        n_iter += n_it
    if inc_flags is None:
        # max_iterations == 0: the initial cost, as the quiet path.
        state, cost, _, _, inc, _ = core(state, 0)
        inc_flags = host_read(inc).numpy()
    cost_deltas = (np.concatenate(deltas_parts) if deltas_parts
                   else np.zeros((0,)))
    if stop and not inc_flags.any():
        print('*** Converged at iteration {:d} ***'.format(n_iter))
    return state, cost, n_iter, cost_deltas, inc_flags
