"""Archetypal analysis (standard and kernelized) in PyTorch.

Port of convex_dim_red_tpu/models/archetypal_analysis.py.  Per outer
iteration of the alternating minimization: an optional box-constrained
SPG update of the scale factors ``alpha``, an SPG update of the
row-stochastic dictionary ``C``, and a batched simplex-QP update of the
row-stochastic weights ``Z``, with the same cost forms, stopping test
and monotonicity watchdog as the JAX package.

- The JAX fit is one jitted ``while_loop``; here
  :func:`_kernel_aa_core` is a Python loop over device tensors that
  reads one flag (``stop``) on the host per iteration.
- ``ArchetypalAnalysis`` forms the Gram ``K = X X'`` once and runs the
  kernel iteration, with the residual-form cost ``0.5 ||Z diag(alpha)
  C X - X||^2 / n`` (reliable in float32); ``KernelAA`` takes a kernel
  and uses the trace form.
- The weights QPs go through ``solvers.spg.quad_simplex_spg_batch``: the
  row solver by default (``backend='auto'`` resolves with fit-regime
  semantics), the hand-written kernels with ``backend='pallas'``.
  ``ArchetypalAnalysis.transform`` is a cold one-shot solve, so
  ``'auto'`` runs a kernel there on a CUDA device.
- An estimator's ``random_state`` (an int, ``None``, a
  ``numpy.random.RandomState`` or a ``torch.Generator``) becomes one
  ``torch.Generator`` (an int seeds a CPU one); every random draw is
  made on it and moved to the data's device.  The draws differ from
  the JAX package's, so a comparison starts both from ``init='custom'``
  states (utils/interop.py).
- An estimator's ``device`` (constructor) places the data of ``fit``,
  ``fit_transform`` and ``transform``: a tensor stays on its own device
  unless ``device`` is given, anything else goes to ``device``, by
  default ``'cuda'`` (``RuntimeError`` where there is no CUDA device;
  pass ``device='cpu'``).  See :func:`utils.validation.as_input`.
- ``mesh=`` (a DeviceMesh, parallel/mesh.py) runs a full fit as one
  restart of ``parallel.sharded_aa.sharded_aa_fit`` (or
  ``sharded_kernel_aa_fit``) with every rank on the sample axis, on the
  mesh's device; the estimator's generator is seeded with the mesh's
  first rank's seed (constructing it is collective), so every rank
  draws the same initial state; the
  weights QP runs K1 (K3 above k = 64) on each rank's rows.  A
  partial fit stays on one device; ``transform`` splits the rows when
  they divide over the sample axis.
"""

import time
import warnings

import numpy as np
import torch

from ..ops.furthest_sum import dissimilarities_from_kernel, furthest_sum
from ..ops.simplex_projection import simplex_project_rows
from ..ops.stochastic_matrices import right_stochastic_matrix
from ..solvers.spg import (quad_simplex_spg_batch, quad_spg,
                           resolve_qp_backend)
from ..utils.precision import apply_matmul_precision, matmul_precision_scope
from ..utils.validation import (as_input, check_array_shape,
                                check_stochastic_matrix)
from ._common import (QPSolverConfig, SPGSolverConfig, make_config,
                      STOPPING_CRITERIA, _check_mesh, _fit_device,
                      _generator_on, prepare_estimator_mesh,
                      _run_fit, check_estimator_params, has_converged)

__all__ = [
    "KernelAA",
    "ArchetypalAnalysis",
    "kernel_aa_cost",
    "update_kernel_aa_dictionary",
    "update_kernel_aa_weights",
    "update_kernel_aa_scale_factors",
    "iterate_kernel_aa",
]

INITIALIZATION_METHODS = (None, 'random', 'furthest_sum', 'custom')

#: The scale-factor subproblem (k unknowns in a box a restart) is mostly
#: solved in one SPG step: its solve reads whether every restart is done
#: after each step, and leaves then instead of running frozen steps up
#: to ``quad_spg``'s next read.  Frozen problems do not change, so this
#: moves no result.
_SCALE_CHECK_EVERY = 1


def _scalar_dtype(dtype):
    """Dtype for cost and convergence scalars: the working dtype, as on
    the JAX package's production path (x64 off)."""
    return dtype


def _cost_from_parts(trace_K, CKZ, ZtZ, CKCt, alpha, n_samples):
    """AA objective 0.5 (tr K - 2 tr(D CKZ) + tr(D Z'Z D CKC'))/n from
    the k x k intermediates.  Leading axes of the operands are batch
    axes (one cost per restart)."""
    sdt = _scalar_dtype(CKZ.dtype)
    a = alpha.to(sdt)
    tr_dckz = torch.sum(
        a * torch.diagonal(CKZ, dim1=-2, dim2=-1).to(sdt), dim=-1)
    dzzd = (a[..., :, None] * ZtZ.to(sdt)) * a[..., None, :]
    tr_quad = torch.sum(dzzd * CKCt.to(sdt).transpose(-2, -1),
                        dim=(-2, -1))
    return 0.5 * (trace_K.to(sdt) - 2.0 * tr_dckz + tr_quad) / n_samples


@apply_matmul_precision
def kernel_aa_cost(K, weights, dictionary, alpha):
    """The kernel-AA cost ``0.5||X - a Z C X||^2_F / n`` in kernel
    form."""
    K, Z, C, alpha = (torch.as_tensor(a)
                      for a in (K, weights, dictionary, alpha))
    CK = C @ K
    return _cost_from_parts(torch.trace(K), CK @ Z, Z.T @ Z, CK @ C.T,
                            alpha, K.shape[0])


def _spg_cfg_to_quad_kwargs(cfg):
    """Map an :class:`SPGSolverConfig` onto :func:`quad_spg` arguments.

    The nonmonotone line-search parameters have no counterpart: the AA
    subproblems are exact quadratics, so the solver minimizes each line
    segment in closed form (see solvers/spg.py:quad_spg).
    """
    alpha0 = cfg.alpha0 if cfg.alpha0 is not None else -1.0
    return dict(alpha0=alpha0, alpha_min=cfg.alpha_min,
                alpha_max=cfg.alpha_max, epsilon_one=cfg.epsilon_one,
                epsilon_two=cfg.epsilon_two,
                max_iterations=cfg.max_iterations)


def update_kernel_aa_dictionary(K, dictionary, alpha, trace_K, KZ, ZtZ,
                                **solver_kwargs):
    """SPG solve of the dictionary subproblem (rows on the simplex):
    minimizes ``0.5 tr(DZ'ZD C K C')/n - tr(C KZD)/n`` over
    row-stochastic ``C``.  The whole ``(k, n)`` matrix is one
    :func:`quad_spg` problem (a batch of one).  ``trace_K`` is accepted
    for signature parity."""
    del trace_K
    cfg = make_config(SPGSolverConfig, solver_kwargs)
    n_samples = K.shape[0]
    KZD = KZ * alpha[None, :]
    DZtZD = (alpha[:, None] * ZtZ) * alpha[None, :]
    C = quad_spg(lambda Cm: DZtZD @ (Cm @ K) / n_samples,
                 (KZD.T / n_samples)[None], dictionary[None],
                 simplex_project_rows, **_spg_cfg_to_quad_kwargs(cfg))
    return C[0]


def update_kernel_aa_weights(weights, alpha, CK, CKCt,
                             component_mask=None, **solver_kwargs):
    """Batched simplex-QP update of the weights: per row ``t`` solve
    ``min 1/2 z' (D CKC' D) z - (D CK)[:, t]' z`` on the simplex, through
    ``quad_simplex_spg_batch`` with the config's backend."""
    cfg = make_config(QPSolverConfig, solver_kwargs)
    A = (alpha[:, None] * CKCt) * alpha[None, :]
    B = -(alpha[:, None] * CK).T
    return quad_simplex_spg_batch(A, B, weights, backend=cfg.backend,
                                  mask=component_mask, **cfg.kwargs())


def update_kernel_aa_scale_factors(alpha, trace_K, CKZ, ZtZ, CKCt, delta,
                                   **solver_kwargs):
    """Box-constrained SPG update of the scale factors, on
    ``[1 - delta, 1 + delta]``."""
    cfg = make_config(SPGSolverConfig, solver_kwargs)
    # The JAX function divides by CKZ.shape[1], which is k (CKZ is
    # k x k): the minimizer is the same, the SPG iterates follow it.
    scale = CKZ.shape[1] if CKZ.ndim == 2 else CKZ.shape[0]
    M = ZtZ * CKCt  # symmetric PSD (Schur product of PSD matrices)
    lo, hi = 1.0 - delta, 1.0 + delta
    a = quad_spg(lambda v: (v @ M.T) / scale,
                 (torch.diagonal(CKZ) / scale)[None], alpha[None],
                 lambda v: torch.clamp(v, lo, hi),
                 check_every=_SCALE_CHECK_EVERY,
                 **_spg_cfg_to_quad_kwargs(cfg))
    return a[0]


@apply_matmul_precision
def _kernel_aa_core(K, Z, C, alpha, delta, tolerance, X,
                    component_mask=None, *,
                    do_scale, do_dict, do_weights, criterion,
                    max_iterations, require_monotonic, has_data,
                    dict_cfg, weights_cfg, scale_cfg):
    """The alternating fit, up to ``max_iterations`` iterations.

    With ``has_data`` the cost is the residual form from the data ``X``;
    otherwise the kernel trace form.  Each stage's cost increase beyond
    ``max(tolerance, 64 eps tr K)`` (below that floor an increase is
    not certifiable: the kernel-space model agrees with the true cost
    only up to the rounding of forming K) sets that stage's flag in
    ``inc_flags``; with ``require_monotonic`` a flag stops the loop.
    ``delta`` is a 0-d tensor of ``K``'s dtype.

    Returns ``(Z, C, alpha, cost, n_iter, cost_trace, inc_flags,
    stop)``; ``stop`` tells a fired criterion (or watchdog) from the
    iteration cap.
    """
    n_samples = K.shape[0]
    sdt = _scalar_dtype(K.dtype)
    trace_K = torch.trace(K).to(sdt)

    ZtZ = Z.T @ Z
    KZ = K @ Z
    CK = C @ K
    CKCt = CK @ C.T
    CKZ = C @ KZ
    CX = C @ X if has_data else None

    def cost_fn(Z, alpha, CKZ, ZtZ, CKCt, CX):
        if has_data:
            resid = Z @ (alpha[:, None] * CX) - X
            return (0.5 * torch.sum(resid * resid) / n_samples).to(sdt)
        return _cost_from_parts(trace_K, CKZ, ZtZ, CKCt, alpha, n_samples)

    new_cost = cost_fn(Z, alpha, CKZ, ZtZ, CKCt, CX)
    tolerance = torch.as_tensor(tolerance, dtype=sdt, device=K.device)
    cost_trace = torch.zeros((max(int(max_iterations), 1),), dtype=sdt,
                             device=K.device)
    inc_flags = torch.zeros((3,), dtype=torch.bool, device=K.device)
    watchdog_floor = 64.0 * torch.finfo(K.dtype).eps * trace_K
    watchdog_thresh = torch.maximum(tolerance, watchdog_floor)

    def increased(old, new):
        return (new > old) & (new - old > watchdog_thresh)

    weights_backend = resolve_qp_backend(weights_cfg.backend, regime='fit')
    n_iter = 0
    stop = False
    while not stop and n_iter < max_iterations:
        old_cost = new_cost

        if do_scale:
            alpha = update_kernel_aa_scale_factors(
                alpha, trace_K, CKZ, ZtZ, CKCt, delta, **scale_cfg.kwargs())
            new_cost = cost_fn(Z, alpha, CKZ, ZtZ, CKCt, CX)
            inc_flags[0] |= increased(old_cost, new_cost)

        if do_dict:
            C = update_kernel_aa_dictionary(
                K, C, alpha, trace_K, KZ, ZtZ, **dict_cfg.kwargs())
            CK = C @ K
            CKCt = CK @ C.T
            CKZ = C @ KZ
            if has_data:
                CX = C @ X
            new_cost = cost_fn(Z, alpha, CKZ, ZtZ, CKCt, CX)
            inc_flags[1] |= increased(old_cost, new_cost)

        if do_weights:
            Z = update_kernel_aa_weights(
                Z, alpha, CK, CKCt, component_mask=component_mask,
                backend=weights_backend, **weights_cfg.kwargs())
            ZtZ = Z.T @ Z
            KZ = K @ Z
            CKZ = C @ KZ
            new_cost = cost_fn(Z, alpha, CKZ, ZtZ, CKCt, CX)
            inc_flags[2] |= increased(old_cost, new_cost)

        cost_trace[n_iter] = new_cost - old_cost
        stop_flag = has_converged(old_cost, new_cost, tolerance, criterion)
        if require_monotonic:
            stop_flag = stop_flag | torch.any(inc_flags)
        n_iter += 1
        stop = bool(stop_flag)

    return Z, C, alpha, new_cost, n_iter, cost_trace, inc_flags, stop


_STAGE_NAMES = ('scale factors', 'dictionary', 'weights')

def iterate_kernel_aa(K, weights, dictionary, alpha, delta=0,
                      update_weights=True, update_dictionary=True,
                      update_scale_factors=True, tolerance=1e-6,
                      max_iterations=1000, verbose=0, data=None, **kwargs):
    """Run alternating kernel-AA updates to convergence.

    Returns ``(weights, dictionary, alpha, cost, n_iter,
    avg_time_per_iter, cost_deltas)`` as the JAX function does: ``cost``
    a 0-d tensor, ``n_iter`` the iterations executed, the average time
    the wall clock over the fit divided by ``n_iter``, ``cost_deltas``
    a numpy array.  ``verbose`` prints the reference's iteration table
    (see ``_common._run_fit``).  A cost increase past the watchdog raises
    ``RuntimeError`` naming the stage (with
    ``require_monotonic_cost_decrease``, the default).
    """
    if kwargs.get('stopping_criterion',
                  'abs_delta_f') not in STOPPING_CRITERIA:
        raise ValueError("unsupported stopping criterion '%s'"
                         % kwargs['stopping_criterion'])

    require_monotonic = bool(kwargs.get('require_monotonic_cost_decrease',
                                        True))
    criterion = kwargs.get('stopping_criterion', 'abs_delta_f')
    dict_cfg = make_config(SPGSolverConfig,
                           kwargs.get('dictionary_solver_kwargs'))
    weights_cfg = make_config(QPSolverConfig,
                              kwargs.get('weights_solver_kwargs'))
    scale_cfg = make_config(SPGSolverConfig,
                            kwargs.get('scale_factors_solver_kwargs'))

    K = torch.as_tensor(K)
    Z = torch.as_tensor(weights, device=K.device)
    C = torch.as_tensor(dictionary, device=K.device)
    alpha = torch.as_tensor(alpha, dtype=K.dtype, device=K.device)
    has_data = data is not None
    X = torch.as_tensor(data, device=K.device) if has_data else None

    def core(state, max_iterations):
        *state, cost, n_iter, trace, inc, stop = _kernel_aa_core(
            K, *state, torch.as_tensor(delta, dtype=K.dtype,
                                       device=K.device),
            tolerance, X, do_scale=(bool(update_scale_factors)
                                    and float(delta) != 0.0),
            do_dict=bool(update_dictionary),
            do_weights=bool(update_weights), criterion=criterion,
            max_iterations=max_iterations,
            require_monotonic=require_monotonic, has_data=has_data,
            dict_cfg=dict_cfg, weights_cfg=weights_cfg,
            scale_cfg=scale_cfg)
        return tuple(state), cost, n_iter, trace, inc, stop

    start = time.perf_counter()
    (Z, C, alpha), cost, n_iter, cost_deltas, inc_flags = _run_fit(
        core, (Z, C, alpha), max_iterations, verbose,
        "*** Kernel AA: n_components = {:d} ***".format(Z.shape[1]), 80)
    elapsed = time.perf_counter() - start

    if require_monotonic and inc_flags.any():
        stage = _STAGE_NAMES[int(np.argmax(inc_flags))]
        raise RuntimeError(
            'factorization cost increased after {} update'.format(stage))

    avg_time = elapsed / max(n_iter, 1)

    return Z, C, alpha, cost, n_iter, avg_time, cost_deltas


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def initialize_kernel_aa_dictionary(kernel, n_components,
                                    init='furthest_sum', generator=None,
                                    **kwargs):
    """Dictionary init: one-hot rows of the FurthestSum-selected samples
    (``start_index``, ``n_extra_steps`` (10) and ``exclude`` from
    ``kwargs``; a random start index when none is given), or a random
    right-stochastic matrix."""
    n_samples = kernel.shape[0]
    if init is None:
        init = 'furthest_sum'

    if init == 'furthest_sum':
        start_index = kwargs.get('start_index')
        n_extra_steps = kwargs.get('n_extra_steps', 10)
        exclude = kwargs.get('exclude')
        if start_index is None:
            start_index = int(torch.randint(0, n_samples, (),
                                            generator=generator))
        selected = furthest_sum(dissimilarities_from_kernel(kernel),
                                n_components, start_index, exclude,
                                n_extra_steps)
        dictionary = torch.zeros((n_components, n_samples),
                                 dtype=kernel.dtype, device=kernel.device)
        dictionary[torch.arange(n_components, device=kernel.device),
                   torch.as_tensor(selected, device=kernel.device)] = 1
        return dictionary

    if init == 'random':
        return right_stochastic_matrix(
            generator, (n_components, n_samples), dtype=kernel.dtype,
            device=kernel.device)

    raise ValueError(
        'Invalid init parameter: got %r instead of one of %r'
        % (init, INITIALIZATION_METHODS))


def initialize_kernel_aa_weights(kernel, n_components, init='furthest_sum',
                                 generator=None):
    if init in (None, 'furthest_sum', 'random'):
        return right_stochastic_matrix(
            generator, (kernel.shape[0], n_components),
            dtype=kernel.dtype, device=kernel.device)
    raise ValueError(
        'Invalid init parameter: got %r instead of one of %r'
        % (init, INITIALIZATION_METHODS))


def initialize_kernel_aa_scale_factors(n_components, delta=0,
                                       generator=None,
                                       dtype=torch.float64, device=None):
    if delta != 0:
        u = torch.rand((n_components,), generator=generator, dtype=dtype,
                       device=generator.device).to(device)
        return (1 - delta) + 2 * delta * u
    return torch.ones((n_components,), dtype=dtype, device=device)


def _check_init_scale_factors(alpha, delta, shape, whom):
    check_array_shape(alpha, shape, whom)
    a = torch.as_tensor(alpha)
    if bool(torch.any((a < 1 - delta) | (a > 1 + delta))):
        raise ValueError('Initial scale factors infeasible in %s' % whom)


# ---------------------------------------------------------------------------
# Estimators
# ---------------------------------------------------------------------------


class KernelAA:
    """Kernel archetypal analysis on a precomputed Gram/kernel matrix.

    The JAX package's (and the reference's) constructor parameters,
    ``fit`` / ``fit_transform``, and fitted attributes ``weights``,
    ``dictionary``, ``alpha``, ``cost``, ``n_iter``,
    ``avg_time_per_iter``, ``cost_deltas``.  The fit runs in the
    kernel's dtype, on the device that ``device`` gives it (see the
    module docstring).  ``random_state`` and ``mesh``: see the module
    docstring.
    """

    def __init__(self, n_components, delta=0, init=None,
                 tolerance=1e-6, max_iterations=1000, verbose=0,
                 random_state=None, mesh=None, device=None, **kwargs):
        _check_mesh(mesh)
        self.n_components = n_components
        self.delta = delta
        self.init = init
        self.tolerance = tolerance
        self.max_iterations = max_iterations
        self.verbose = verbose
        self.mesh = mesh
        self.device = device
        self._generator = _generator_on(random_state, 'cpu', mesh=mesh)
        self.require_monotonic_cost_decrease = kwargs.get(
            'require_monotonic_cost_decrease', True)
        self.stopping_criterion = kwargs.get('stopping_criterion',
                                             'abs_delta_f')

        self.weights = None
        self.dictionary = None
        self.alpha = None
        self.cost = 0
        self.n_iter = 0
        self.avg_time_per_iter = 0
        self.cost_deltas = None

        self.weights_solver_kwargs = kwargs.get('weights_solver_kwargs', {})
        self.dictionary_solver_kwargs = kwargs.get(
            'dictionary_solver_kwargs', {})
        self.scale_factors_solver_kwargs = kwargs.get(
            'scale_factors_solver_kwargs', {})

    def _prepare_state(self, kernel, dictionary, weights, alpha,
                       update_dictionary, update_weights, whom, **kwargs):
        n_samples = kernel.shape[0]
        k = self.n_components
        gen = self._generator

        if self.init == 'custom':
            check_stochastic_matrix(weights, (n_samples, k), whom, axis=1)
            check_stochastic_matrix(dictionary, (k, n_samples), whom,
                                    axis=1)
            if alpha is not None:
                _check_init_scale_factors(alpha, self.delta, (k,), whom)
        elif not update_dictionary and update_weights:
            check_stochastic_matrix(dictionary, (k, n_samples), whom,
                                    axis=1)
            weights = initialize_kernel_aa_weights(
                kernel, k, init=self.init, generator=gen)
        elif update_dictionary and not update_weights:
            check_stochastic_matrix(weights, (n_samples, k), whom, axis=1)
            dictionary = initialize_kernel_aa_dictionary(
                kernel, k, init=self.init, generator=gen, **kwargs)
        else:
            dictionary = initialize_kernel_aa_dictionary(
                kernel, k, init=self.init, generator=gen, **kwargs)
            weights = initialize_kernel_aa_weights(
                kernel, k, init=self.init, generator=gen)

        if alpha is None:
            alpha = initialize_kernel_aa_scale_factors(
                k, delta=self.delta, generator=gen, dtype=kernel.dtype,
                device=kernel.device)
        else:
            _check_init_scale_factors(alpha, self.delta, (k,), whom)

        return tuple(torch.as_tensor(a, dtype=kernel.dtype,
                                     device=kernel.device)
                     for a in (dictionary, weights, alpha))

    def _kernel_aa(self, kernel, dictionary=None, weights=None, alpha=None,
                   update_dictionary=True, update_weights=True,
                   update_scale_factors=True, data=None, **kwargs):
        kernel = as_input(kernel, _fit_device(self.mesh, self.device))
        n_samples = kernel.shape[0]
        if kernel.ndim != 2 or kernel.shape[1] != n_samples:
            raise ValueError(
                'Expected square kernel matrix in %s. Got shape %s'
                % ('kernel_aa', tuple(kernel.shape)))

        if self.n_components is None:
            self.n_components = n_samples
        check_estimator_params(self.n_components, self.max_iterations,
                               self.tolerance)

        dictionary, weights, alpha = self._prepare_state(
            kernel, dictionary, weights, alpha,
            update_dictionary, update_weights, '_kernel_aa', **kwargs)

        # Full alternating fits run sharded over the mesh; partial fits
        # (a weights-only solve) are small and stay on one device.
        if (self.mesh is not None and update_dictionary and update_weights
                and (float(self.delta) == 0.0 or update_scale_factors)
                and data is None):
            return self._kernel_aa_sharded(kernel, dictionary, weights,
                                           alpha)

        (self.weights, self.dictionary, self.alpha, cost, n_iter,
         avg_time, cost_deltas) = iterate_kernel_aa(
            kernel, weights, dictionary, alpha, delta=self.delta,
            update_weights=update_weights,
            update_dictionary=update_dictionary,
            update_scale_factors=update_scale_factors,
            data=data,
            tolerance=self.tolerance,
            max_iterations=self.max_iterations,
            verbose=self.verbose,
            require_monotonic_cost_decrease=(
                self.require_monotonic_cost_decrease),
            stopping_criterion=self.stopping_criterion,
            weights_solver_kwargs=self.weights_solver_kwargs,
            dictionary_solver_kwargs=self.dictionary_solver_kwargs,
            scale_factors_solver_kwargs=self.scale_factors_solver_kwargs)

        if n_iter >= self.max_iterations and self.tolerance > 0:
            warnings.warn('Maximum number of iterations %d reached.'
                          % self.max_iterations, UserWarning)

        return cost, n_iter, avg_time, cost_deltas

    def _kernel_aa_sharded(self, kernel, dictionary, weights, alpha):
        """The fit over the estimator's mesh (one restart, every rank on
        the sample axis)."""
        # Deferred: parallel imports this module's cost helpers.
        from ..parallel.sharded_aa import sharded_kernel_aa_fit

        mesh = prepare_estimator_mesh(self.mesh, kernel.shape[0],
                                      'KernelAA(mesh=...)')
        start = time.perf_counter()
        res = sharded_kernel_aa_fit(
            mesh, kernel, weights[None], dictionary[None], alpha[None],
            delta=self.delta, tolerance=self.tolerance,
            max_iterations=int(self.max_iterations),
            stopping_criterion=self.stopping_criterion,
            dictionary_solver_kwargs=self.dictionary_solver_kwargs,
            weights_solver_kwargs=self.weights_solver_kwargs,
            scale_factors_solver_kwargs=self.scale_factors_solver_kwargs)
        elapsed = time.perf_counter() - start

        # The sharded fit returns diag(alpha) C for delta != 0; KernelAA
        # keeps the row-stochastic C, as the reference does.
        self.weights = res['weights']
        self.alpha = res['alpha']
        self.dictionary = (res['dictionary'] / self.alpha[:, None]
                           if float(self.delta) != 0.0
                           else res['dictionary'])
        n_iter = res['n_iter']
        if n_iter >= self.max_iterations and self.tolerance > 0:
            warnings.warn('Maximum number of iterations %d reached.'
                          % self.max_iterations, UserWarning)
        return (res['cost'], n_iter, elapsed / max(n_iter, 1),
                res['cost_deltas'][:n_iter])

    def fit_transform(self, data, dictionary=None, weights=None, alpha=None,
                      _data_matrix=None, **kwargs):
        """Fit kernel AA to ``data`` (a kernel matrix) and return weights."""
        cost, n_iter, avg_time, cost_deltas = self._kernel_aa(
            data, dictionary=dictionary, weights=weights, alpha=alpha,
            data=_data_matrix, **kwargs)
        self.cost = float(cost)
        self.n_iter = n_iter
        self.avg_time_per_iter = avg_time
        self.cost_deltas = cost_deltas
        return self.weights

    def fit(self, kernel, **kwargs):
        self.fit_transform(kernel, **kwargs)
        return self


class ArchetypalAnalysis:
    """Standard archetypal analysis: ``min ||X - a Z C X||^2_F``.

    The JAX package's estimator: it forms the Gram matrix once and runs
    the kernel iteration with the residual-form cost.  ``fit`` /
    ``fit_transform`` / ``transform`` / ``inverse_transform``, with the
    fitted attributes of :class:`KernelAA` plus ``archetypes`` (``a C
    X``).  The fit runs in the data's dtype, on the device that
    ``device`` (or ``mesh``) gives it (see the module docstring).
    """

    def __init__(self, n_components, delta=0, init=None,
                 tolerance=1e-6, max_iterations=1000, verbose=0,
                 random_state=None, mesh=None, device=None, **kwargs):
        self._kernel_model = KernelAA(
            n_components, delta=delta, init=init, tolerance=tolerance,
            max_iterations=max_iterations, verbose=verbose,
            random_state=random_state, mesh=mesh, device=device, **kwargs)
        self.n_components = n_components
        self.delta = delta
        self.init = init
        self.tolerance = tolerance
        self.max_iterations = max_iterations
        self.verbose = verbose
        self.mesh = mesh
        self.device = device

        self.weights = None
        self.dictionary = None
        self.alpha = None
        self.archetypes = None
        self.cost = 0
        self.n_iter = 0
        self.avg_time_per_iter = 0
        self.cost_deltas = None

    @property
    def weights_solver_kwargs(self):
        return self._kernel_model.weights_solver_kwargs

    def fit_transform(self, data, dictionary=None, weights=None, alpha=None,
                      **kwargs):
        """Fit AA to ``data`` with shape (n_samples, n_features)."""
        data = as_input(data, _fit_device(self.mesh, self.device))
        if self.n_components is None:
            # Reference quirk kept for parity: data-space AA defaults to
            # n_features components.
            self.n_components = data.shape[1]
            self._kernel_model.n_components = data.shape[1]

        if self.mesh is not None \
                and kwargs.get('update_dictionary', True) \
                and kwargs.get('update_weights', True) \
                and (float(self.delta) == 0.0
                     or kwargs.get('update_scale_factors', True)):
            # Before the n x n Gram: the sharded fit forms its own kernel
            # rows (the Gram is made only for FurthestSum's init).
            return self._fit_sharded(data, dictionary, weights, alpha,
                                     **kwargs)

        with matmul_precision_scope():
            kernel = data @ data.T

        self._kernel_model.fit_transform(
            kernel, dictionary=dictionary, weights=weights, alpha=alpha,
            _data_matrix=data, **kwargs)

        km = self._kernel_model
        self.weights = km.weights
        self.alpha = km.alpha
        self.cost = km.cost
        self.n_iter = km.n_iter
        self.avg_time_per_iter = km.avg_time_per_iter
        self.cost_deltas = km.cost_deltas

        dictionary = km.dictionary
        if self.delta != 0:
            dictionary = self.alpha[:, None] * dictionary
        self.dictionary = dictionary
        with matmul_precision_scope():
            self.archetypes = dictionary @ data

        return self.weights

    def _fit_sharded(self, data, dictionary, weights, alpha, **kwargs):
        """The fit over the estimator's mesh (one restart, every rank on
        the sample axis), residual-form cost as on one device."""
        # Deferred: parallel imports this module's cost helpers.
        from ..parallel.sharded_aa import sharded_aa_fit

        km = self._kernel_model
        mesh = prepare_estimator_mesh(self.mesh, data.shape[0],
                                      'ArchetypalAnalysis(mesh=...)')
        check_estimator_params(km.n_components, km.max_iterations,
                               km.tolerance)
        if km.init in (None, 'furthest_sum'):
            # FurthestSum needs the whole dissimilarity matrix.
            with matmul_precision_scope():
                kernel = data @ data.T
        else:
            # The random and custom inits read only the row count, dtype
            # and device.
            kernel = data[:, :0]
        init_kwargs = {k: v for k, v in kwargs.items()
                       if k not in ('update_dictionary', 'update_weights',
                                    'update_scale_factors')}
        dictionary, weights, alpha = km._prepare_state(
            kernel, dictionary, weights, alpha, True, True,
            'fit_transform', **init_kwargs)

        start = time.perf_counter()
        res = sharded_aa_fit(
            mesh, data, weights[None], dictionary[None], alpha[None],
            delta=self.delta, tolerance=self.tolerance,
            max_iterations=int(self.max_iterations),
            stopping_criterion=km.stopping_criterion,
            dictionary_solver_kwargs=km.dictionary_solver_kwargs,
            weights_solver_kwargs=km.weights_solver_kwargs,
            scale_factors_solver_kwargs=km.scale_factors_solver_kwargs)
        elapsed = time.perf_counter() - start

        self.weights = res['weights']
        self.alpha = res['alpha']
        # diag(alpha) C for delta != 0: this class's convention.
        self.dictionary = res['dictionary']
        with matmul_precision_scope():
            self.archetypes = self.dictionary @ data
        self.cost = res['cost']
        self.n_iter = n_iter = res['n_iter']
        self.avg_time_per_iter = elapsed / max(n_iter, 1)
        self.cost_deltas = res['cost_deltas'][:n_iter]
        if n_iter >= self.max_iterations and self.tolerance > 0:
            warnings.warn('Maximum number of iterations %d reached.'
                          % self.max_iterations, UserWarning)
        return self.weights

    def fit(self, data, **kwargs):
        self.fit_transform(data, **kwargs)
        return self

    def transform(self, data):
        """Solve weights for new data against the fitted archetypes: one
        simplex QP per row, a cold one-shot batch (``backend='auto'``
        runs a kernel on a CUDA device), capped at the estimator's
        ``max_iterations`` as in the reference.  With ``mesh`` each rank
        solves its block of the rows when they divide over the sample
        axis (and the restart axis has size 1), else the whole batch, as
        the JAX estimator falls back.  Returns ``(weights, cost)``."""
        data = as_input(data, _fit_device(self.mesh, self.device))
        n_samples = data.shape[0]

        cfg = make_config(QPSolverConfig, dict(
            self._kernel_model.weights_solver_kwargs) or None)
        cfg_kwargs = cfg.kwargs()
        cfg_kwargs['backend'] = cfg.backend
        cfg_kwargs['max_iterations'] = int(self.max_iterations)

        archetypes = self.archetypes.to(data.device, data.dtype)
        Z0 = right_stochastic_matrix(
            self._kernel_model._generator, (n_samples, self.n_components),
            dtype=data.dtype, device=data.device)

        if self.mesh is not None:
            from ..parallel.mesh import ensure_mesh_axes
            m = ensure_mesh_axes(self.mesh)
            names = m.mesh_dim_names
            if (m.size(names.index('restarts')) == 1
                    and n_samples % m.size(names.index('samples')) == 0):
                return self._transform_sharded(data, archetypes, Z0,
                                               cfg_kwargs)

        with matmul_precision_scope():
            A = archetypes @ archetypes.T
            B = -(data @ archetypes.T)
            weights = quad_simplex_spg_batch(A, B, Z0, **cfg_kwargs)
            self.weights = weights
            resid = data - weights @ archetypes
        cost = 0.5 * float(torch.sum(resid * resid)) / n_samples
        return weights, cost

    def _transform_sharded(self, data, archetypes, Z0, cfg_kwargs):
        """The transform over the mesh's sample axis: each rank solves
        its rows' QPs (one shared k x k Hessian, so K2 or K4 on a card);
        the weights are gathered and the squared residuals
        all-reduced."""
        from ..parallel.mesh import _all_gather, _axis, _block, _psum

        n_samples = data.shape[0]
        mesh = prepare_estimator_mesh(
            self.mesh, n_samples, 'ArchetypalAnalysis.transform(mesh=...)')
        size, index, _ = _axis(mesh, 'samples')
        rows = _block(n_samples, size, index)
        with matmul_precision_scope():
            A = archetypes @ archetypes.T
            B_loc = -(data[rows] @ archetypes.T)
            W_loc = quad_simplex_spg_batch(A, B_loc, Z0[rows].contiguous(),
                                           **cfg_kwargs)
            resid = data[rows] - W_loc @ archetypes
        ss = _psum(torch.sum(resid * resid), mesh, 'samples')
        self.weights = _all_gather(W_loc, mesh, 'samples')
        return self.weights, 0.5 * float(ss) / n_samples

    def inverse_transform(self, weights):
        """Map weights back to data space: ``Z @ archetypes`` (an array
        goes to the archetypes' device)."""
        with matmul_precision_scope():
            return (torch.as_tensor(weights, device=self.archetypes.device)
                    @ self.archetypes)
