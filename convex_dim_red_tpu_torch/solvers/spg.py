"""Projected spectral gradient (SPG) solvers.

Port of convex_dim_red_tpu/solvers/spg.py:

- :func:`spg`, the generic solver over user callables ``f``/``df``/
  ``project`` (Birgin-Martinez-Raydan SPG with a Grippo nonmonotone line
  search), with the JAX function's zero-initialised memory, safeguards,
  function-evaluation bookkeeping, warnings and verbose table.  The JAX
  function's three ``lax.while_loop`` calls become Python loops over
  tensors that read one comparison on the host per step.
- :func:`quad_spg`, the operator-form QP solver with the closed-form
  exact line search.  The JAX package ``vmap``s it over restarts or
  rows; here the batch axis is the leading axis of every operand, every
  sum and max runs over the other axes (one scalar step per batch
  member), and a per-member ``done`` mask freezes finished members
  exactly as a vmapped ``while_loop`` does.
- :func:`quad_simplex_spg`, the simplex row solver (the JAX package's
  'xla' backend): :func:`quad_spg` over a batch of rows.
- :func:`quad_simplex_spg_batch` and
  :func:`quad_simplex_spg_batch_grouped`, the dispatch of a batch of
  simplex QPs (one Hessian, or one per group) to the hand-written
  kernels of ops/simplex_qp.py or to the row solver, and
  :func:`resolve_qp_backend`, which picks between them for
  ``backend='auto'``.

The two stop on different rules, and both are kept: ``quad_spg`` tests
the residual at alpha = 1 with a second projection; the kernels test
``||D|| < eps * min(alpha, 1)`` with none.
"""

import time
import warnings

import numpy as np
import torch

from ..ops.simplex_projection import (simplex_project_masked,
                                      simplex_project_rows)
from ..ops.simplex_qp import (MAX_K, UNPACKED_MAX_K, quad_simplex_qp,
                              quad_simplex_qp_grouped,
                              quad_simplex_qp_packed,
                              quad_simplex_qp_packed_grouped)
from ..utils.precision import apply_matmul_precision
from ..utils.profiling import host_read
from ..utils.validation import as_input

__all__ = [
    "spg",
    "line_search_step_length",
    "quad_spg",
    "quad_simplex_spg",
    "quad_simplex_spg_batch",
    "quad_simplex_spg_batch_grouped",
    "resolve_qp_backend",
    "cauchy_step_size",
]

#: ``quad_spg`` checks on the host whether every restart is done once
#: per this many iterations, so short solves (the fit's dictionary step
#: is capped at 1) never wait on the device.  Frozen restarts do not
#: change, so the check moves no result.
_DONE_CHECK_EVERY = 8


def cauchy_step_size(beta, sksk, alpha_min=1e-3, alpha_max=1e3):
    """Barzilai-Borwein (Cauchy) step size with safeguards."""
    safe_beta = torch.where(beta <= 0, 1.0, beta)
    return torch.where(beta <= 0, alpha_max,
                       torch.clamp(sksk / safe_beta, alpha_min, alpha_max))


def line_search_step_length(lam, delta, f_old, f_new,
                            sigma_one=0.1, sigma_two=0.9):
    """Safeguarded quadratic-interpolation step length: the minimizer of
    the quadratic through ``f_old``, the slope ``delta`` and ``f_new`` at
    ``lam``, kept when it lies in ``[sigma_one, sigma_two lam]``, else
    ``lam / 2`` (a non-finite interpolation, at zero curvature, falls to
    the bisection too)."""
    denom = f_new - f_old - lam * delta
    tmp = -0.5 * lam * lam * delta / denom
    ok = (sigma_one <= tmp) & (tmp <= sigma_two * lam)
    return torch.where(ok, tmp, 0.5 * lam)


def _norms(res):
    return torch.sqrt(torch.sum(res * res)), torch.max(torch.abs(res))


def _emit_spg_warnings(underflow, feval_exceeded, iter_exceeded):
    """The soft failures of a solve as ``UserWarning``, with the JAX
    package's (and the reference's) texts."""
    if underflow:
        warnings.warn('step size below tolerance in SPG line search',
                      UserWarning)
    if feval_exceeded:
        warnings.warn('maximum number of function evaluations exceeded '
                      'in SPG', UserWarning)
    if iter_exceeded:
        warnings.warn('maximum number of iterations exceeded in SPG',
                      UserWarning)


class _VerboseTable:
    """The reference's fixed-width SPG iteration table, printed live:
    one row per iteration with the wall time since the last row."""

    _HEADER = '{:<12s} | {:<12s} | {:<13s} | {:<13s} | {:<12s}'.format(
        'n_iter', 'n_feval', 'f', 'conv_crit', 'time')
    _ROW = '{:12d} | {:12d} | {: 12.6e} | {: 12.6e} | {: 12.6e}'

    def __init__(self):
        self._last = None

    def header(self, n_feval, f0):
        print(self._HEADER)
        print('-' * 79)
        print(self._ROW.format(0, int(n_feval), float(f0), -1.0, 0.0))
        self._last = time.perf_counter()

    def row(self, n_iter, n_feval, f, conv_crit):
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        print(self._ROW.format(int(n_iter), int(n_feval), float(f),
                               float(conv_crit), dt))

    def footer(self, converged, n_iter):
        if converged:
            print('-' * 79)
            print('*** Converged at iteration {:d} ***'.format(int(n_iter)))


def _spg_input(x0, device):
    """``x0`` as a floating tensor: a tensor or numpy array keeps its
    floating dtype; a Python number or list, or an integer array, takes
    torch's default dtype (the JAX package's float under its x64
    flag)."""
    if not isinstance(x0, torch.Tensor) and isinstance(
            x0, (np.ndarray, np.generic)):
        x0 = np.asarray(x0)
    x = as_input(x0, device)
    if not x.is_floating_point():
        x = x.to(torch.get_default_dtype())
    return x


@apply_matmul_precision
def spg(f, df, x0, project=None, gamma=1e-4, memory=1,
        sigma_one=0.1, sigma_two=0.9, lambda_min=1e-10,
        alpha0=None, alpha_min=1e-5, alpha_max=1e3,
        epsilon_one=1e-10, epsilon_two=1e-6,
        use_infinity_norm=True, verbose=0,
        max_iterations=10000, max_feval=1000000, device=None):
    """Minimize ``f`` by projected gradient descent with a nonmonotone
    line search.

    The JAX function's parameters and results: ``f`` and ``df`` map a
    tensor shaped like ``x0`` to a 0-d tensor and a tensor, ``project``
    (optional) maps onto the feasible set.  ``x0`` (a scalar or a tensor
    of any shape) goes to ``device`` as
    :func:`utils.validation.as_input` says: a tensor stays on its
    device, anything else goes to the card unless ``device='cpu'``.
    Returns ``(x, f_min, n_iter, n_feval)``: tensors ``x`` and
    ``f_min``, and ``n_iter``, the descent iterations executed, and
    ``n_feval`` as integers.  ``verbose`` prints the reference's table
    as the solve goes; the soft failures (line-search underflow, the
    evaluation or the iteration cap reached before convergence) raise
    ``UserWarning``.
    """
    x = _spg_input(x0, device)
    dtype = x.dtype

    def scalar(v):
        return torch.as_tensor(v, dtype=dtype, device=x.device)

    if project is not None:
        x = project(x)

    f_old = f(x)
    n_feval = 1
    gk = df(x)

    if alpha0 is not None:
        alpha = scalar(alpha0)
    elif project is None:
        alpha = 1.0 / torch.max(torch.abs(gk))
    else:
        alpha_inv = torch.max(torch.abs(project(x - gk) - x))
        alpha = torch.where(torch.abs(alpha_inv) > 1e-12, 1.0 / alpha_inv,
                            scalar(1.0))

    # The reference initialises the nonmonotone memory with zeros.
    f_mem = torch.zeros((memory,), dtype=dtype, device=x.device)

    table = _VerboseTable() if verbose else None
    if table is not None:
        table.header(n_feval, f_old)

    def direction(x, g, a):
        if project is None:
            return -a * g
        return project(x - a * g) - x

    def residual(x, g):
        if project is None:
            return -g
        return project(x - g) - x

    n_iter = 0
    converged = underflow = done = False
    while not done and n_iter < max_iterations:
        dk = direction(x, gk, alpha)
        f_mem = torch.roll(f_mem, 1)
        f_mem[0] = f_old
        f_max = torch.max(f_mem)
        delta = torch.sum(dk * gk)

        lam = scalar(1.0)
        x_new = x + dk
        f_new = f(x_new)
        n_feval += 1
        uf = False
        while not uf and bool(f_new > f_max + gamma * lam * delta):
            lam = line_search_step_length(lam, delta, f_old, f_new,
                                          sigma_one, sigma_two)
            x_new = x + lam * dk
            f_new = f(x_new)
            n_feval += 1
            uf = bool(torch.abs(lam) < lambda_min)
        underflow = underflow or uf

        gk_new = df(x_new)
        yk = gk_new - gk
        sksk = lam * lam * torch.sum(dk * dk)
        betak = lam * torch.sum(dk * yk)
        alpha = cauchy_step_size(betak, sksk, alpha_min, alpha_max)

        # The reference evaluates f(x_new) once more here: the same
        # value, reused; the counter keeps its bookkeeping.
        f_old = f_new
        n_feval += 1
        x, gk = x_new, gk_new
        n_iter += 1

        res2, resinf = _norms(residual(x, gk))
        if table is not None:
            table.row(n_iter, n_feval, f_old, res2)
        converged = bool(res2 < epsilon_two)
        if use_infinity_norm:
            converged = converged or bool(resinf < epsilon_one)
        done = converged or n_feval > max_feval

    if table is not None:
        table.footer(converged, n_iter)
    _emit_spg_warnings(underflow, n_feval > max_feval and not converged,
                       n_iter >= max_iterations and not converged)
    return x, f_old, n_iter, n_feval


def _batch_sum(v):
    return v.sum(dim=tuple(range(1, v.ndim)))


def _batch_amax(v):
    return v.amax(dim=tuple(range(1, v.ndim)))


@apply_matmul_precision
def quad_spg(matvec, B, x0, project, alpha0=-1.0,
             alpha_min=1e-5, alpha_max=1e3,
             epsilon_one=1e-10, epsilon_two=1e-6,
             max_iterations=1000, agree=None,
             check_every=_DONE_CHECK_EVERY):
    """Projected spectral gradient for ``min 0.5<x,Hx> - <B,x>`` over a
    convex set, for a batch of problems along the leading axis.

    ``x0``/``B``: ``(R, ...)``; ``matvec`` and ``project`` map batched
    tensors to batched tensors.  Uses Barzilai-Borwein step sizes with
    the closed-form exact line minimizer along the projected direction;
    ``H x`` is carried incrementally, one ``matvec`` per iteration.
    ``agree`` (a sharded solve, whose ``matvec`` runs a collective)
    maps this process's host stop flag to the one every process of its
    group takes, so all leave the loop together.  ``check_every``:
    iterations between two host reads of whether every problem is done;
    a finished problem is frozen, so it moves no result, only how many
    frozen iterations run before the loop leaves and how often the host
    waits.
    Returns the projected solutions, ``(R, ...)``.
    """
    x = project(x0)
    dtype = x.dtype
    R = x.shape[0]
    bshape = (R,) + (1,) * (x.ndim - 1)

    Hx = matvec(x)
    g0 = Hx - B
    if alpha_min <= alpha0 <= alpha_max:
        alpha = torch.full((R,), alpha0, dtype=dtype, device=x.device)
    else:
        alpha_inv = _batch_amax(torch.abs(project(x - g0) - x))
        alpha_inv = torch.where(torch.abs(alpha_inv) < 1e-12, 1.0,
                                alpha_inv)
        alpha = torch.clamp(1.0 / alpha_inv, alpha_min, alpha_max)

    # Progress-based exit: see the JAX function.  The exact decrease
    # -(lam*delta + lam^2/2 q) has no cancellation; three iterations in
    # a row below the dtype's resolution of the objective stop a row.
    progress_eps = 32.0 * torch.finfo(dtype).eps
    tiny = torch.finfo(dtype).tiny
    stall_limit = 3

    stall = torch.zeros((R,), dtype=torch.int32, device=x.device)
    done = torch.zeros((R,), dtype=torch.bool, device=x.device)
    for it in range(int(max_iterations)):
        if it and it % check_every == 0:
            stop = bool(host_read(done.all()))
            if agree is not None:
                stop = agree(stop)
            if stop:
                break
        g = Hx - B
        d = project(x - alpha.view(bshape) * g) - x
        Hd = matvec(d)

        delta = _batch_sum(d * g)
        q = _batch_sum(d * Hd)

        safe_q = torch.where(q > 0, q, 1.0)
        lam = torch.where(q > 0, torch.clamp(-delta / safe_q, 0.0, 1.0),
                          1.0)

        x_new = x + lam.view(bshape) * d
        Hx_new = Hx + lam.view(bshape) * Hd

        sksk = _batch_sum(d * d)
        alpha_new = cauchy_step_size(q, sksk, alpha_min, alpha_max)

        g_new = Hx_new - B
        res = project(x_new - g_new) - x_new
        res2 = torch.sqrt(_batch_sum(res * res))
        resinf = _batch_amax(torch.abs(res))

        decrease = -(lam * delta + 0.5 * lam * lam * q)
        f_scale = torch.abs(0.5 * _batch_sum(x_new * Hx_new)
                            - _batch_sum(B * x_new)) + tiny
        no_progress = decrease <= progress_eps * f_scale
        stall_new = torch.where(no_progress, stall + 1, 0)
        done_new = ((res2 < epsilon_two) | (resinf < epsilon_one)
                    | (stall_new >= stall_limit))

        # A vmapped while_loop keeps iterating finished members with
        # their carry unchanged: freeze them.
        frozen = done.view(bshape)
        x = torch.where(frozen, x, x_new)
        Hx = torch.where(frozen, Hx, Hx_new)
        alpha = torch.where(done, alpha, alpha_new)
        stall = torch.where(done, stall, stall_new)
        done = done | done_new
    # The incremental updates x += lam*d keep feasibility only up to
    # accumulated rounding; one final projection restores it.
    return project(x)


def resolve_qp_backend(backend, k=None, regime="oneshot", device=None):
    """Resolve a ``backend='auto'`` weights-QP backend choice.

    The JAX package's rule (its docstring has the TPU measurements that
    set it), with a CUDA device in the TPU's place:

    - ``regime='oneshot'`` (a cold QP batch solved once: transforms,
      direct ``quad_simplex_spg_batch`` calls) and ``'sharded_fit'``
      (the restart-grouped fits): ``'pallas'``, the hand-written
      kernels, when ``device`` is a CUDA device and ``k`` (if given)
      is at most 128;
    - ``regime='fit'`` (warm-started QPs inside a single alternating
      fit): ``'xla'``, the row solver;
    - any other device, ``None`` included: ``'xla'``.

    Non-'auto' values pass through untouched.  Whether the fit-regime
    default also holds on the H100 is measured by ``chip_smoke.py``
    (PERF.md).
    """
    if regime not in ("oneshot", "fit", "sharded_fit"):
        raise ValueError("unknown QP dispatch regime %r" % (regime,))
    if backend != "auto":
        return backend
    if regime == "fit":
        return "xla"
    if device is None or torch.device(device).type != "cuda":
        return "xla"
    if k is not None and k > UNPACKED_MAX_K:
        return "xla"
    return "pallas"


@apply_matmul_precision
def quad_simplex_spg(A, b, x0, gamma=1e-4, memory=1,
                     sigma_one=0.1, sigma_two=0.9, lambda_min=1e-10,
                     alpha0=-1.0, alpha_min=1e-5, alpha_max=1e3,
                     epsilon_one=1e-10, epsilon_two=1e-6,
                     max_iterations=1000, max_feval=2000, mask=None):
    """Solve ``min 1/2 x'Ax + b'x`` over the simplex for a batch of rows.

    ``x0``/``b``: ``(..., n, k)``, one QP per row; ``A``: ``(k, k)``
    shared by all rows, or ``(..., k, k)`` with the same leading axes as
    ``b`` (one Hessian per group of ``n`` rows).  Returns the solutions,
    shaped like ``x0``.

    The JAX function solves one row and is ``vmap``ped; here every row
    is a member of one :func:`quad_spg` batch, with its own step size,
    line search, stopping test and freeze, so each row's result is the
    JAX row's.  ``matvec`` is ``x @ A'`` (the JAX function's ``A @
    x``), the projection :func:`simplex_project_rows` or, with ``mask``
    ((k,) bool), its masked form, and the iteration cap
    ``min(max_iterations, max_feval)``.  The nonmonotone line-search
    parameters are accepted for API parity and unused (see the JAX
    function).
    """
    del gamma, memory, sigma_one, sigma_two, lambda_min  # parity only

    shape = x0.shape
    k = shape[-1]
    if A.ndim == 2:
        def matvec(x):
            return x @ A.T
    else:
        def matvec(x):
            return torch.matmul(x.reshape(shape), A.transpose(-2, -1)) \
                .reshape(-1, k)
    if mask is None:
        project = simplex_project_rows
    else:
        mask = torch.as_tensor(mask, dtype=torch.bool, device=x0.device)

        def project(x):
            return simplex_project_masked(x, mask)

    x = quad_spg(matvec, -b.reshape(-1, k), x0.reshape(-1, k), project,
                 alpha0=alpha0, alpha_min=alpha_min, alpha_max=alpha_max,
                 epsilon_one=epsilon_one, epsilon_two=epsilon_two,
                 max_iterations=min(max_iterations, max_feval))
    return x.reshape(shape)


def _kernel_kwargs(solver_kwargs):
    """The arguments the QP kernels take, out of a row-solver kwargs
    dict (the JAX package's ``_pallas_qp_kwargs``)."""
    return {k: v for k, v in solver_kwargs.items()
            if k in ("max_iterations", "alpha0", "alpha_min",
                     "alpha_max", "epsilon_one", "epsilon_two")}


def _check_projection(projection, k):
    """``projection`` is checked up front, on every backend: the JAX
    dispatch passes it on to the unpacked kernels, which do not take it,
    and raises ``TypeError`` there."""
    if projection not in (None, "michelot", "bisect"):
        raise ValueError("projection must be None, 'michelot' or "
                         "'bisect', got %r" % (projection,))
    if projection == "michelot" and k > MAX_K:
        raise ValueError(
            "projection='michelot' runs in the packed QP kernels, which "
            "take k <= %d; k = %d runs the unpacked kernels, which "
            "bisect: pass projection=None or 'bisect'" % (MAX_K, k))


def _dispatch(As, Bs, X0s, backend, mask, projection, solver_kwargs,
              packed, unpacked):
    """Run ``packed`` (k <= 64) or ``unpacked`` (to 128) for 'pallas',
    the row solver for 'xla', after resolving 'auto' as a one-shot
    solve."""
    k = X0s.shape[-1]
    _check_projection(projection, k)
    backend = resolve_qp_backend(backend, k=k, device=X0s.device)
    if backend == "pallas":
        args = (As.contiguous(), Bs.contiguous(), X0s.contiguous())
        keep = _kernel_kwargs(solver_kwargs)
        if k <= MAX_K:
            return packed(*args, mask=mask,
                          projection=projection or "michelot", **keep)
        return unpacked(*args, mask=mask, **keep)
    if backend != "xla":
        raise ValueError("unknown QP backend %r" % (backend,))
    return quad_simplex_spg(As, Bs, X0s, mask=mask, **solver_kwargs)


@apply_matmul_precision
def quad_simplex_spg_batch(A, B, X0, backend="xla", mask=None,
                           projection=None, **solver_kwargs):
    """Solve ``n`` simplex QPs ``min 1/2 x'Ax + b'x`` sharing the
    Hessian ``A``.

    ``A``: (k, k); ``B``/``X0``: (n, k).  Returns (n, k).
    ``backend``: 'xla' runs the row solver :func:`quad_simplex_spg`;
    'pallas' runs a hand-written kernel (ops/simplex_qp.py), K2 for
    ``k <= 64`` and K4 up to 128 (the kernel's plain version on CPU
    tensors); 'auto' resolves as a cold one-shot solve
    (:func:`resolve_qp_backend`).  ``mask`` ((k,) bool) pins masked
    coordinates to zero.  ``projection`` (kernels only): None (Michelot
    at ``k <= 64``, bisection above), 'michelot' (``k <= 64``) or
    'bisect'.  ``solver_kwargs`` are :func:`quad_simplex_spg`'s; the
    kernels take the subset they know.
    """
    return _dispatch(A, B, X0, backend, mask, projection, solver_kwargs,
                     quad_simplex_qp_packed, quad_simplex_qp)


@apply_matmul_precision
def quad_simplex_spg_batch_grouped(As, Bs, X0s, backend="xla", mask=None,
                                   projection=None, **solver_kwargs):
    """Solve ``R`` groups of simplex QPs ``min 1/2 x'Ax + b'x``, one
    Hessian per group.

    ``As``: (R, k, k); ``Bs``/``X0s``: (R, n, k).  Returns (R, n, k).
    The restart-grouped form of :func:`quad_simplex_spg_batch`, with the
    same arguments: 'pallas' runs K1 for ``k <= 64`` and K3 up to 128,
    'xla' the row solver, 'auto' resolves as a one-shot solve.
    ``mask`` is shared across groups.
    """
    return _dispatch(As, Bs, X0s, backend, mask, projection, solver_kwargs,
                     quad_simplex_qp_packed_grouped,
                     quad_simplex_qp_grouped)
