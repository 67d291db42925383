"""Projected spectral gradient (SPG) QP solvers, batched over restarts.

Port of the two solvers of convex_dim_red_tpu/solvers/spg.py that the
multi-restart AA fit runs:

- :func:`quad_spg`, the operator-form QP solver with the closed-form
  exact line search.  The JAX package ``vmap``s it over restarts; here
  the restart axis is the leading axis of every operand, every sum and
  max runs over the other axes (one scalar step per restart), and a
  per-restart ``done`` mask freezes finished members exactly as a
  vmapped ``while_loop`` does.
- :func:`quad_simplex_spg_batch_grouped`, the dispatch of the
  restart-grouped weights QPs to the hand-written kernel
  (ops/simplex_qp.py).

The two stop on different rules, and both are kept: ``quad_spg`` tests
the residual at alpha = 1 with a second projection; the kernel tests
``||D|| < eps * min(alpha, 1)`` with none.
"""

import torch

from ..ops.simplex_qp import MAX_K, quad_simplex_qp_packed_grouped
from ..utils.precision import apply_matmul_precision

__all__ = [
    "quad_spg",
    "quad_simplex_spg_batch_grouped",
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


def _batch_sum(v):
    return v.sum(dim=tuple(range(1, v.ndim)))


def _batch_amax(v):
    return v.amax(dim=tuple(range(1, v.ndim)))


@apply_matmul_precision
def quad_spg(matvec, B, x0, project, alpha0=-1.0,
             alpha_min=1e-5, alpha_max=1e3,
             epsilon_one=1e-10, epsilon_two=1e-6,
             max_iterations=1000):
    """Projected spectral gradient for ``min 0.5<x,Hx> - <B,x>`` over a
    convex set, for a batch of problems along the leading axis.

    ``x0``/``B``: ``(R, ...)``; ``matvec`` and ``project`` map batched
    tensors to batched tensors.  Uses Barzilai-Borwein step sizes with
    the closed-form exact line minimizer along the projected direction;
    ``H x`` is carried incrementally, one ``matvec`` per iteration.
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
        if it and it % _DONE_CHECK_EVERY == 0 and bool(done.all()):
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


@apply_matmul_precision
def quad_simplex_spg_batch_grouped(As, Bs, X0s, backend="auto", mask=None,
                                   projection="michelot",
                                   max_iterations=1000, alpha0=-1.0,
                                   alpha_min=1e-5, alpha_max=1e3,
                                   epsilon_one=1e-10, epsilon_two=1e-6):
    """Solve ``R`` groups of simplex QPs ``min 1/2 x'Ax + b'x``, one
    Hessian per group.

    ``As``: (R, k, k); ``Bs``/``X0s``: (R, n, k).  Returns (R, n, k).
    ``backend`` 'auto' or 'pallas' runs the grouped kernel
    (ops/simplex_qp.py): the CUDA kernel for CUDA tensors, its plain
    PyTorch version for CPU tensors.  ``mask`` ((k,) bool, shared
    across groups) pins masked coordinates to zero; ``projection`` is
    'michelot' or 'bisect'.
    """
    if backend == "xla":
        raise NotImplementedError(
            "the vmapped XLA row solver (quad_simplex_spg) is not ported "
            "yet (ROADMAP.md queue 1, item 5); use backend='auto'")
    if backend not in ("auto", "pallas"):
        raise ValueError("unknown QP backend %r" % (backend,))
    k = X0s.shape[-1]
    if k > MAX_K:
        raise NotImplementedError(
            "k = %d > %d needs the unpacked grouped kernel, which is not "
            "ported yet (ROADMAP.md queue 2, K3)" % (k, MAX_K))
    return quad_simplex_qp_packed_grouped(
        As.contiguous(), Bs.contiguous(), X0s.contiguous(), mask=mask,
        projection=projection, max_iterations=max_iterations,
        alpha0=alpha0, alpha_min=alpha_min, alpha_max=alpha_max,
        epsilon_one=epsilon_one, epsilon_two=epsilon_two)
