"""GPNH-regularized convex coding in PyTorch.

Port of convex_dim_red_tpu/models/gpnh_convex_coding.py:
``min 0.5||X - Z W'||^2_F / n + lambda_W * Phi(W)`` over row-stochastic
weights ``Z`` and a free dictionary ``W``, where ``Phi`` penalizes the
pairwise distances of the dictionary's columns.  Each iteration of the
alternating fit:

- dictionary: the exact k x k solve ``(Z'Z/n + lambda_W G_W) W' =
  Z'X/n`` as a least-squares solve by SVD (:func:`_lstsq`, the cutoff of
  ``jnp.linalg.lstsq``), so a rank-deficient ``Z'Z`` (a component whose
  weights died out) cannot raise the cost;
- weights: per row ``min 1/2 z'(W'W)z - (XW)[t]'z`` on the simplex,
  through ``solvers.spg.quad_simplex_spg_batch``: the row solver by
  default (``backend='auto'`` resolves with fit-regime semantics, as in
  the JAX package), the K2 kernel with ``backend='pallas'``.

As in the port's archetypal analysis: :func:`_gpnh_core` is a Python
loop over device tensors that reads one flag (``stop``) on the host per
iteration; an estimator's ``random_state`` becomes one
``torch.Generator``, and its ``device`` places the data (a numpy array
goes to the card unless ``device='cpu'``); ``mesh=`` (a DeviceMesh,
parallel/mesh.py) runs a full fit as one restart of
``parallel.sharded_aa.sharded_gpnh_fit`` with every rank on the sample
axis, the generator seeded with the mesh's first rank's seed (a partial
fit, and so ``transform``, stays on one device).  The
cost and convergence scalars are
float64 whatever the data's dtype (:data:`_SCALAR_DTYPE`).
"""

import time
import warnings

import numpy as np
import torch

from ..ops.furthest_sum import dissimilarities_from_kernel, furthest_sum
from ..ops.stochastic_matrices import right_stochastic_matrix
from ..solvers.spg import quad_simplex_spg_batch, resolve_qp_backend
from ..utils.precision import apply_matmul_precision, matmul_precision_scope
from ..utils.profiling import host_read, span
from ..utils.validation import (as_input, check_array_shape,
                                check_unit_axis_sums)
from ._common import (QPSolverConfig, make_config, STOPPING_CRITERIA,
                      _check_mesh, _fit_device, _generator_on, _run_fit,
                      prepare_estimator_mesh,
                      check_estimator_params, has_converged)

__all__ = [
    "GPNHConvexCoding",
    "gpnh_cost",
    "gpnh_regularization",
    "gpnh_regularization_masked",
    "update_gpnh_dictionary",
    "update_gpnh_weights",
    "iterate_gpnh_convex_coding",
]

INITIALIZATION_METHODS = (None, 'random', 'furthest_sum', 'custom')

#: Dtype of the cost and convergence scalars.  The trace-form cost sums
#: ``XW * Z`` over all rows and subtracts it from ``tr(X'X)``; in
#: float32 that rounding is not far below a relative tolerance of 1e-5,
#: so the sums run in float64, as the JAX package's do with x64 on.
_SCALAR_DTYPE = torch.float64


def gpnh_regularization(dictionary):
    """GPNH penalty ``Phi(W) = 2/(k d (k-1)) sum_{i<j} ||w_i - w_j||^2``
    through ``sum_{i<j}||w_i - w_j||^2 = k sum_i ||w_i||^2 - ||sum_i
    w_i||^2``.  ``dictionary``: (d, k); leading axes are batch axes (one
    penalty per restart)."""
    W = torch.as_tensor(dictionary)
    n_features, n_components = W.shape[-2:]
    if n_components == 1:
        return torch.zeros(W.shape[:-2], dtype=W.dtype, device=W.device)
    prefactor = 2.0 / (n_components * n_features * (n_components - 1.0))
    total = (n_components * torch.sum(W * W, dim=(-2, -1))
             - torch.sum(torch.sum(W, dim=-1) ** 2, dim=-1))
    return prefactor * total


def _gpnh_gram(n_features, n_components, dtype, device=None):
    """``G_W`` such that ``Phi(W) = 0.5 tr(W G_W W')``."""
    if n_components > 1:
        prefactor = 4.0 / (n_features * n_components * (n_components - 1))
        return prefactor * (
            n_components * torch.eye(n_components, dtype=dtype,
                                     device=device)
            - torch.ones((n_components, n_components), dtype=dtype,
                         device=device))
    return torch.zeros((n_components, n_components), dtype=dtype,
                       device=device)


def _mask_of(component_mask, dtype, device):
    return torch.as_tensor(component_mask, device=device).to(dtype)


def gpnh_regularization_masked(dictionary, component_mask):
    """GPNH penalty over the active dictionary columns only: the
    prefactor takes the active count ``k_act = sum(mask)`` and the sums
    run over active columns, so a padded fit optimizes the
    ``k_act``-component objective.  ``component_mask``: (k,) bool."""
    W = torch.as_tensor(dictionary)
    n_features = W.shape[-2]
    m = _mask_of(component_mask, W.dtype, W.device)
    k_act = torch.sum(m)
    Wm = W * m
    total = (k_act * torch.sum(Wm * Wm, dim=(-2, -1))
             - torch.sum(torch.sum(Wm, dim=-1) ** 2, dim=-1))
    denom = k_act * n_features * torch.clamp(k_act - 1.0, min=1.0)
    pre = torch.where(k_act > 1, 2.0 / denom, 0.0)
    return pre * total


def _gpnh_gram_masked(n_features, component_mask, dtype, device=None):
    """Masked ``G_W``: the active block's GPNH Gram with the active-k
    prefactor, zero on padded rows and columns."""
    m = _mask_of(component_mask, dtype, device)
    k_act = torch.sum(m)
    k_pad = m.shape[0]
    denom = n_features * k_act * torch.clamp(k_act - 1.0, min=1.0)
    pre = torch.where(k_act > 1, 4.0 / denom, 0.0)
    G = pre * (k_act * torch.eye(k_pad, dtype=dtype, device=m.device)
               - torch.ones((k_pad, k_pad), dtype=dtype, device=m.device))
    return G * m[:, None] * m[None, :]


@apply_matmul_precision
def gpnh_cost(data, weights, dictionary, lambda_W=0):
    """The full GPNH objective, a 0-d tensor."""
    X, Z, W = (torch.as_tensor(a) for a in (data, weights, dictionary))
    resid = X - Z @ W.T
    cost = 0.5 * torch.sum(resid * resid) / X.shape[0]
    if lambda_W != 0:
        cost = cost + lambda_W * gpnh_regularization(W)
    return cost


def _cost_from_parts(trace_XtX, WtXtZ_tr, ZtZ, WtW, penalty, n_samples):
    """Trace-form objective from the k x k intermediates, in
    :data:`_SCALAR_DTYPE`.  Leading axes are batch axes."""
    sdt = _SCALAR_DTYPE
    tr_zw = torch.sum(ZtZ.to(sdt) * WtW.to(sdt).transpose(-2, -1),
                      dim=(-2, -1))
    return (0.5 * (trace_XtX.to(sdt) - 2.0 * WtXtZ_tr.to(sdt) + tr_zw)
            / n_samples + penalty.to(sdt))


def _lstsq(a, b):
    """``jnp.linalg.lstsq(a, b)[0]`` with ``rcond=None``: the SVD solve
    that keeps the singular values ``s > 0`` with ``s >= eps max(m, n)
    s[0]`` and drops the rest, so a rank-deficient ``a`` gets the
    minimum-norm solution.  (``torch.linalg.lstsq`` on CUDA has only the
    QR driver, which assumes full rank.)  Leading axes are batch
    axes."""
    m, n = a.shape[-2:]
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    cut = torch.finfo(a.dtype).eps * max(m, n) * s[..., :1]
    keep = (s > 0) & (s >= cut)
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
    return vh.mH @ (s_inv[..., :, None] * (u.mH @ b))


def _solve_gpnh_dictionary(ZtZ, ZtX, GW, lambda_W, n_samples):
    """``W`` of ``(Z'Z/n + lambda_W G_W) W' = Z'X/n`` by :func:`_lstsq`,
    from ``Z'Z`` and ``Z'X`` (leading axes are batch axes); returns
    ``W`` (..., d, k)."""
    lhs = ZtZ / n_samples + lambda_W * GW
    return _lstsq(lhs, ZtX / n_samples).transpose(-2, -1)


def update_gpnh_dictionary(X, weights, ZtZ, GW, lambda_W=0):
    """Exact dictionary solve ``(Z'Z/n + lambda_W G_W) W' = Z'X/n`` by
    :func:`_lstsq`.  ``weights`` (and ``ZtZ``) may carry leading batch
    axes; returns ``W`` (..., d, k)."""
    return _solve_gpnh_dictionary(ZtZ, weights.transpose(-2, -1) @ X, GW,
                                  lambda_W, X.shape[0])


def update_gpnh_weights(X, weights, dictionary, component_mask=None,
                        **solver_kwargs):
    """Batched simplex-QP weights update: per row solve ``min
    1/2 z'(W'W)z - (XW)[t]'z`` through ``quad_simplex_spg_batch`` with the
    config's backend.  ``component_mask`` ((k,) bool) pins masked
    columns of ``Z`` to zero."""
    cfg = make_config(QPSolverConfig, solver_kwargs)
    W = torch.as_tensor(dictionary)
    return quad_simplex_spg_batch(W.T @ W, -(X @ W), weights,
                                  backend=cfg.backend, mask=component_mask,
                                  **cfg.kwargs())


@apply_matmul_precision
def _gpnh_core(X, Z, W, lambda_W, tolerance, *, do_dict, do_weights,
               criterion, max_iterations, require_monotonic, weights_cfg):
    """The alternating GPNH fit, up to ``max_iterations`` iterations.

    Each stage's cost increase beyond ``max(tolerance, 64 eps tr(X'X))``
    (below that floor an increase is not certifiable: the trace form
    agrees with the true cost only up to the rounding of its parts) sets
    that stage's flag in ``inc_flags``; with ``require_monotonic`` a
    flag stops the loop.  ``lambda_W`` and ``tolerance`` are numbers.
    The JAX function's ``component_mask`` is not taken: padded fits run
    only in the restart runners (``parallel/restarts.py``), which carry
    their own mask.

    Returns ``(Z, W, cost, n_iter, cost_trace, inc_flags, stop)``;
    ``stop`` tells a fired criterion (or watchdog) from the iteration
    cap.
    """
    n_samples, n_features = X.shape
    n_components = W.shape[1]
    sdt = _SCALAR_DTYPE
    lambda_W = float(lambda_W)
    GW = _gpnh_gram(n_features, n_components, X.dtype, X.device)
    trace_XtX = torch.sum(X.to(sdt) * X.to(sdt))
    no_penalty = torch.zeros((), dtype=sdt, device=X.device)

    def penalty(W):
        if lambda_W == 0:
            return no_penalty
        return lambda_W * gpnh_regularization(W).to(sdt)

    def cost_of(Z, W, ZtZ, WtW):
        WtXtZ_tr = torch.sum((X @ W).to(sdt) * Z.to(sdt))
        return _cost_from_parts(trace_XtX, WtXtZ_tr, ZtZ, WtW, penalty(W),
                                n_samples)

    ZtZ = Z.T @ Z
    WtW = W.T @ W
    new_cost = cost_of(Z, W, ZtZ, WtW)
    tolerance = torch.as_tensor(tolerance, dtype=sdt, device=X.device)
    cost_trace = torch.zeros((max(int(max_iterations), 1),), dtype=sdt,
                             device=X.device)
    inc_flags = torch.zeros((2,), dtype=torch.bool, device=X.device)
    watchdog_floor = 64.0 * torch.finfo(X.dtype).eps * trace_XtX
    watchdog_thresh = torch.maximum(tolerance, watchdog_floor)

    def increased(old, new):
        return (new > old) & (new - old > watchdog_thresh)

    weights_backend = resolve_qp_backend(weights_cfg.backend, regime='fit')
    n_iter = 0
    stop = False
    while not stop and n_iter < max_iterations:
        old_cost = new_cost

        if do_dict:
            W = update_gpnh_dictionary(X, Z, ZtZ, GW, lambda_W=lambda_W)
            WtW = W.T @ W
            new_cost = cost_of(Z, W, ZtZ, WtW)
            inc_flags[0] |= increased(old_cost, new_cost)

        if do_weights:
            Z = update_gpnh_weights(X, Z, W, backend=weights_backend,
                                    **weights_cfg.kwargs())
            ZtZ = Z.T @ Z
            new_cost = cost_of(Z, W, ZtZ, WtW)
            inc_flags[1] |= increased(old_cost, new_cost)

        cost_trace[n_iter] = new_cost - old_cost
        stop_flag = has_converged(old_cost, new_cost, tolerance, criterion)
        if require_monotonic:
            stop_flag = stop_flag | torch.any(inc_flags)
        n_iter += 1
        stop = bool(host_read(stop_flag))

    return Z, W, new_cost, n_iter, cost_trace, inc_flags, stop


_STAGE_NAMES = ('dictionary', 'weights')


def iterate_gpnh_convex_coding(X, weights, dictionary, lambda_W=0,
                               update_weights=True, update_dictionary=True,
                               tolerance=1e-6, max_iterations=1000,
                               verbose=0, **kwargs):
    """Run alternating GPNH updates to convergence.

    Returns ``(weights, dictionary, cost, n_iter, avg_time_per_iter,
    cost_deltas)`` as the JAX function does: ``cost`` a 0-d tensor,
    ``cost_deltas`` a numpy array.  ``verbose`` prints the reference's
    iteration table (see ``_common._run_fit``).  A cost
    increase past the watchdog raises ``RuntimeError`` naming the stage
    (with ``require_monotonic_cost_decrease``, the default).
    ``dictionary_solver_kwargs`` is accepted and unused: the exact solve
    has no parameters.
    """
    criterion = kwargs.get('stopping_criterion', 'abs_delta_f')
    if criterion not in STOPPING_CRITERIA:
        raise ValueError("unsupported stopping criterion '%s'" % criterion)
    require_monotonic = bool(kwargs.get('require_monotonic_cost_decrease',
                                        True))
    weights_cfg = make_config(QPSolverConfig,
                              kwargs.get('weights_solver_kwargs'))

    X = torch.as_tensor(X)
    Z = torch.as_tensor(weights, device=X.device)
    W = torch.as_tensor(dictionary, device=X.device)

    def core(state, max_iterations):
        Z, W, cost, n_iter, trace, inc, stop = _gpnh_core(
            X, *state, lambda_W, tolerance,
            do_dict=bool(update_dictionary), do_weights=bool(update_weights),
            criterion=criterion, max_iterations=max_iterations,
            require_monotonic=require_monotonic, weights_cfg=weights_cfg)
        return (Z, W), cost, n_iter, trace, inc, stop

    start = time.perf_counter()
    (Z, W), cost, n_iter, cost_deltas, inc_flags = _run_fit(
        core, (Z, W), max_iterations, verbose,
        "*** GPNH convex coding: n_components = {:d} ***".format(
            Z.shape[1]), 100)
    elapsed = time.perf_counter() - start

    if require_monotonic and inc_flags.any():
        stage = _STAGE_NAMES[int(np.argmax(inc_flags))]
        raise RuntimeError(
            'factorization cost increased after {} update'.format(stage))

    return Z, W, cost, n_iter, elapsed / max(n_iter, 1), cost_deltas


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def initialize_gpnh_dictionary(data, n_components, init='random',
                               generator=None, **kwargs):
    """A random dictionary ``sqrt(mean|X| / k) N(0, 1)``, drawn on
    ``generator`` and moved to the data's device, or the data rows that
    FurthestSum selects (``start_index``, ``n_extra_steps`` (10) and
    ``exclude`` from ``kwargs``; a random start index when none is
    given)."""
    n_samples, n_features = data.shape
    if init is None:
        init = 'random'

    if init == 'random':
        avg = torch.sqrt(torch.mean(torch.abs(data)) / n_components)
        noise = torch.randn((n_features, n_components), generator=generator,
                            dtype=data.dtype, device=generator.device)
        return avg * noise.to(data.device)

    if init == 'furthest_sum':
        start_index = kwargs.get('start_index')
        n_extra_steps = kwargs.get('n_extra_steps', 10)
        exclude = kwargs.get('exclude')
        if start_index is None:
            start_index = int(torch.randint(0, n_samples, (),
                                            generator=generator))
        with matmul_precision_scope():
            kernel = data @ data.T
        selected = furthest_sum(dissimilarities_from_kernel(kernel),
                                n_components, start_index, exclude,
                                n_extra_steps)
        return data[torch.as_tensor(selected, device=data.device)].T

    raise ValueError(
        'Invalid init parameter: got %r instead of one of %r'
        % (init, INITIALIZATION_METHODS))


def initialize_gpnh_weights(data, n_components, init='random',
                            generator=None):
    if init in (None, 'random', 'furthest_sum'):
        return right_stochastic_matrix(
            generator, (data.shape[0], n_components), dtype=data.dtype,
            device=data.device)
    raise ValueError(
        'Invalid init parameter: got %r instead of one of %r'
        % (init, INITIALIZATION_METHODS))


def _check_init_weights(weights, shape, whom):
    check_array_shape(weights, shape, whom)
    check_unit_axis_sums(weights, whom, axis=1)


# ---------------------------------------------------------------------------
# Estimator
# ---------------------------------------------------------------------------


class GPNHConvexCoding:
    """Convex coding with GPNH dictionary regularization.

    The JAX package's (and the reference's) constructor parameters,
    ``fit`` / ``fit_transform`` / ``transform`` / ``inverse_transform``,
    and fitted attributes ``weights``, ``dictionary``, ``cost``,
    ``n_iter``, ``avg_time_per_iter``, ``cost_deltas``.  The fit runs in
    the data's dtype, on the device that ``device`` gives it;
    ``random_state`` and ``mesh``: see the module docstring.
    """

    def __init__(self, n_components, lambda_W=0, init=None,
                 tolerance=1e-6, max_iterations=1000,
                 verbose=0, random_state=None, mesh=None, device=None,
                 **kwargs):
        _check_mesh(mesh)
        self.n_components = n_components
        self.lambda_W = lambda_W
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
        self.cost = 0
        self.n_iter = 0
        self.avg_time_per_iter = 0
        self.cost_deltas = None

        self.weights_solver_kwargs = kwargs.get('weights_solver_kwargs', {})
        self.dictionary_solver_kwargs = kwargs.get(
            'dictionary_solver_kwargs', {})

    def _gpnh_convex_coding(self, data, dictionary=None, weights=None,
                            update_dictionary=True, update_weights=True,
                            **kwargs):
        data = as_input(data, _fit_device(self.mesh, self.device))
        n_samples, n_features = data.shape

        if self.n_components is None:
            self.n_components = n_features
        check_estimator_params(self.n_components, self.max_iterations,
                               self.tolerance)
        k = self.n_components
        gen = self._generator
        whom = '_gpnh_convex_coding'

        if self.init == 'custom':
            _check_init_weights(weights, (n_samples, k), whom)
            check_array_shape(dictionary, (n_features, k), whom)
        elif not update_dictionary and update_weights:
            check_array_shape(dictionary, (n_features, k), whom)
            weights = initialize_gpnh_weights(data, k, init=self.init,
                                              generator=gen)
        elif update_dictionary and not update_weights:
            _check_init_weights(weights, (n_samples, k), whom)
            dictionary = initialize_gpnh_dictionary(
                data, k, init=self.init, generator=gen, **kwargs)
        else:
            dictionary = initialize_gpnh_dictionary(
                data, k, init=self.init, generator=gen, **kwargs)
            weights = initialize_gpnh_weights(data, k, init=self.init,
                                              generator=gen)

        weights, dictionary = (
            torch.as_tensor(a, dtype=data.dtype, device=data.device)
            for a in (weights, dictionary))
        if self.mesh is not None:
            if update_dictionary and update_weights:
                return self._gpnh_sharded(data, weights, dictionary)
        (self.weights, self.dictionary, cost, n_iter, avg_time,
         cost_deltas) = iterate_gpnh_convex_coding(
            data, weights, dictionary, lambda_W=self.lambda_W,
            update_dictionary=update_dictionary,
            update_weights=update_weights,
            tolerance=self.tolerance,
            max_iterations=self.max_iterations,
            verbose=self.verbose,
            require_monotonic_cost_decrease=(
                self.require_monotonic_cost_decrease),
            stopping_criterion=self.stopping_criterion,
            weights_solver_kwargs=self.weights_solver_kwargs,
            dictionary_solver_kwargs=self.dictionary_solver_kwargs)

        if n_iter >= self.max_iterations and self.tolerance > 0:
            warnings.warn('Maximum number of iterations %d reached.'
                          % self.max_iterations, UserWarning)

        return cost, n_iter, avg_time, cost_deltas

    def _gpnh_sharded(self, data, weights, dictionary):
        """The fit over the estimator's mesh (one restart, every rank on
        the sample axis)."""
        # Deferred: parallel imports this module's helpers.
        from ..parallel.sharded_aa import sharded_gpnh_fit

        mesh = prepare_estimator_mesh(self.mesh, data.shape[0],
                                      'GPNHConvexCoding(mesh=...)')
        start = time.perf_counter()
        res = sharded_gpnh_fit(
            mesh, data, weights[None], dictionary[None],
            lambda_W=self.lambda_W, tolerance=self.tolerance,
            max_iterations=int(self.max_iterations),
            stopping_criterion=self.stopping_criterion,
            weights_solver_kwargs=self.weights_solver_kwargs)
        elapsed = time.perf_counter() - start
        self.weights = res['weights']
        self.dictionary = res['dictionary']
        n_iter = res['n_iter']
        if n_iter >= self.max_iterations and self.tolerance > 0:
            warnings.warn('Maximum number of iterations %d reached.'
                          % self.max_iterations, UserWarning)
        return (res['cost'], n_iter, elapsed / max(n_iter, 1),
                res['cost_deltas'][:n_iter])

    def fit_transform(self, data, dictionary=None, weights=None, **kwargs):
        """Fit to ``data`` (n_samples, n_features); return the weights
        (the span ``cdr.fit``)."""
        with span("cdr.fit"):
            cost, n_iter, avg_time, cost_deltas = self._gpnh_convex_coding(
                data, dictionary=dictionary, weights=weights, **kwargs)
        self.cost = float(host_read(cost))
        self.n_iter = n_iter
        self.avg_time_per_iter = avg_time
        self.cost_deltas = cost_deltas
        return self.weights

    def fit(self, data, **kwargs):
        self.fit_transform(data, **kwargs)
        return self

    def transform(self, data):
        """Solve weights for new data with the fitted dictionary: a
        weights-only fit from random weights, run to convergence.
        Returns ``(weights, cost)``.  After an ``init='custom'`` fit it
        raises ``ValueError``, as the JAX estimator does: a custom init
        takes initial weights, and there are none for the new data."""
        cost, _, _, _ = self._gpnh_convex_coding(
            data, dictionary=self.dictionary,
            update_dictionary=False, update_weights=True)
        return self.weights, float(host_read(cost))

    def inverse_transform(self, weights):
        """Map weights back to data space: ``Z @ W'`` (an array goes to
        the dictionary's device)."""
        with matmul_precision_scope():
            return (torch.as_tensor(weights, device=self.dictionary.device)
                    @ self.dictionary.T)
