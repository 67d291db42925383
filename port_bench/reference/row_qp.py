"""A frozen plain copy of the simplex-QP row solver of
``convex_dim_red_tpu_torch/ops/simplex_qp.py:_solve_plain``.

For every group ``r`` and row ``i`` it solves ``min 1/2 x'A_r x +
b_ri'x`` over the (optionally masked) simplex by projected spectral
gradient with the exact line search (Michelot or bisection projection),
and stops each row on the kernels' rule: ``||D|| < epsilon_two *
min(alpha, 1)``, ``max|D| < epsilon_one * min(alpha, 1)`` or three
iterations without progress.  It returns the iterations each row took
with the solution, which gives K1's mean iterations on a launch's
operands.
"""

import torch

DEFAULTS = dict(max_iterations=1000, alpha0=-1.0, alpha_min=1e-5,
                alpha_max=1e3, epsilon_one=1e-10, epsilon_two=1e-6)


def bisect_steps(dtype):
    """Halvings of the width-1 threshold bracket until it is below the
    dtype's resolution."""
    return 26 if dtype == torch.float32 else 52


def project(x, mask, projection, steps):
    """Row-wise projection of ``x`` (..., k) onto the masked simplex:
    Michelot with ``k`` active-set passes, or ``steps`` halvings."""
    k = x.shape[-1]
    if projection == "michelot":
        act = mask.to(x.dtype).expand_as(x)

        def tau_of(act):
            s = torch.sum(x * act, dim=-1, keepdim=True)
            c = torch.clamp(torch.sum(act, dim=-1, keepdim=True), min=1.0)
            return (s - 1.0) / c

        for _ in range(k):
            act = torch.where(x > tau_of(act), act, 0.0)
        tau = tau_of(act)
    else:
        hi = torch.amax(torch.where(mask, x, -1e30), dim=-1, keepdim=True)
        lo = hi - 1.0
        for _ in range(steps):
            mid = 0.5 * (lo + hi)
            excess = torch.sum(torch.where(mask, torch.clamp(x - mid, min=0.0),
                                           0.0), dim=-1, keepdim=True)
            too_big = excess > 1.0
            lo = torch.where(too_big, mid, lo)
            hi = torch.where(too_big, hi, mid)
        tau = 0.5 * (lo + hi)
    return torch.where(mask, torch.clamp(x - tau, min=0.0), 0.0)


def solve(As, Bs, X0s, mask=None, projection="michelot", **kwargs):
    """Solve the ``(R, n, k)`` batch; ``As`` (R, k, k).  Returns ``(X,
    iterations)``, ``iterations`` (R, n) the iterations each row ran."""
    unknown = set(kwargs) - set(DEFAULTS)
    if unknown:
        raise TypeError("unknown solver arguments %s" % sorted(unknown))
    kw = dict(DEFAULTS, **kwargs)
    alpha0, alpha_min, alpha_max = (kw["alpha0"], kw["alpha_min"],
                                    kw["alpha_max"])
    R, n, k = X0s.shape
    dtype, device = X0s.dtype, X0s.device
    mask = (torch.ones(k, dtype=torch.bool, device=device) if mask is None
            else torch.as_tensor(mask, device=device).to(torch.bool))
    steps = bisect_steps(dtype)

    def proj(v):
        return project(v, mask, projection, steps)

    def rowsum(v):
        return torch.sum(v, dim=-1, keepdim=True)

    X = proj(X0s)
    AX = torch.matmul(X, As)
    if alpha_min <= alpha0 <= alpha_max:
        alpha = torch.full((R, n, 1), alpha0, dtype=dtype, device=device)
    else:
        d0 = proj(X - (AX + Bs)) - X
        ainv = torch.amax(torch.where(mask, torch.abs(d0), -1e30), dim=-1,
                          keepdim=True)
        ainv = torch.where(torch.abs(ainv) < 1e-12, 1.0, ainv)
        alpha = torch.clamp(1.0 / ainv, alpha_min, alpha_max)

    active = torch.ones((R, n, 1), dtype=torch.bool, device=device)
    iterations = torch.zeros((R, n), dtype=torch.long, device=device)
    stall = torch.zeros((R, n, 1), dtype=dtype, device=device)
    progress_eps = 32.0 * torch.finfo(dtype).eps
    tiny = torch.finfo(dtype).tiny
    for _ in range(int(kw["max_iterations"])):
        if not bool(active.any()):
            break
        iterations += active[..., 0]
        G = AX + Bs
        alpha_used = alpha
        D = proj(X - alpha * G) - X
        AD = torch.matmul(D, As)
        delta = rowsum(D * G)
        q = rowsum(D * AD)
        safe_q = torch.where(q > 0, q, 1.0)
        lam = torch.where(q > 0, torch.clamp(-delta / safe_q, 0.0, 1.0), 1.0)
        lam = torch.where(active, lam, 0.0)
        X = X + lam * D
        AX = AX + lam * AD
        sksk = rowsum(D * D)
        alpha_new = torch.where(
            q > 0, torch.clamp(sksk / safe_q, alpha_min, alpha_max),
            alpha_max)
        alpha = torch.where(active, alpha_new, alpha)
        decrease = -(lam * delta + 0.5 * lam * lam * q)
        fval = torch.abs(0.5 * rowsum(X * AX) + rowsum(X * Bs))
        stall = torch.where(decrease <= progress_eps * (fval + tiny),
                            stall + 1.0, 0.0)
        scale = torch.clamp(alpha_used, max=1.0)
        dinf = torch.amax(torch.abs(D), dim=-1, keepdim=True)
        eps2 = kw["epsilon_two"] * scale
        converged = ((sksk < eps2 * eps2)
                     | (dinf < kw["epsilon_one"] * scale) | (stall >= 3.0))
        active = active & ~converged
    return proj(X), iterations
