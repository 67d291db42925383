"""Checks of a fit's outputs against the benchmark's data, in float64.

AA reconstructs a row as ``z' D X`` (``D`` the k x n dictionary, its
rows on the simplex times the scale factors), GPNH as ``z' W'`` (``W``
the d x k dictionary).  Each function takes the data the benchmark made
and the outputs the program returned, and returns plain floats.
"""

import torch

from . import row_qp

F64 = torch.float64


def f64(t, device):
    return torch.as_tensor(t).to(device=device, dtype=F64)


def rel_max_err(got, want):
    """``max |got - want| / max |want|``."""
    return float(torch.amax(torch.abs(got - want))
                 / torch.clamp(torch.amax(torch.abs(want)), min=1e-300))


def residual_cost(X, Z, P, rows=512):
    """``0.5 ||Z P - X||^2 / n`` in float64, ``rows`` rows at a time;
    ``P`` (k, d) the patterns."""
    total = 0.0
    for i in range(0, X.shape[0], rows):
        r = Z[i:i + rows] @ P - X[i:i + rows]
        total += float(torch.sum(r * r))
    return 0.5 * total / X.shape[0]


def dictionary_gap(X, Z, D, alpha, rows=512):
    """How far the dictionary is from the best one for the returned
    weights: the Frank-Wolfe gap of the dictionary subproblem
    ``min_C 0.5 ||Z diag(alpha) C X - X||^2 / n`` over row-stochastic
    ``C = D / alpha``, at the returned ``C``, over the cost there.  The
    subproblem is convex, so the gap bounds the share of the cost that a
    better dictionary could still remove; a dictionary step that never
    moves leaves its random start, far from that best.  ``D`` (k, n)
    carries the scale factors ``alpha`` (k,)."""
    n = X.shape[0]
    P = D @ X
    ZtR = torch.zeros_like(P)
    total = 0.0
    for i in range(0, n, rows):
        r = Z[i:i + rows] @ P - X[i:i + rows]
        ZtR += Z[i:i + rows].T @ r
        total += float(torch.sum(r * r))
    cost = 0.5 * total / n
    G = alpha[:, None] * (ZtR @ X.T) / n            # (k, n): d cost / dC
    C = D / alpha[:, None]
    gap = torch.sum(G * C) - torch.sum(torch.amin(G, dim=1))
    return float(gap) / cost


def gpnh_penalty(W):
    """``Phi(W) = 2 / (k d (k - 1)) sum_{i<j} ||w_i - w_j||^2`` over the
    columns of ``W`` (d, k), from the pairwise definition."""
    d, k = W.shape
    if k == 1:
        return 0.0
    total = sum(float(torch.sum((W[:, i] - W[:, j]) ** 2))
                for i in range(k) for j in range(i + 1, k))
    return 2.0 * total / (k * d * (k - 1))


def weights_gap(X, P, Z):
    """How far the weights ``Z`` are from the optimum of each row's
    simplex QP against the patterns ``P`` (k, d): :func:`qp_gap` of the
    rows' ``0.5 ||z' P - x||^2``."""
    return qp_gap(P @ P.T, -(X @ P.T), 0.5 * torch.sum(X * X, dim=1), Z)


def qp_gap(H, B, c, Z, max_iterations=20000):
    """The rows' objectives ``0.5 z'Hz + b'z + c`` at ``Z`` against their
    optimum on the simplex: the summed excess over the summed optimal
    objective, and the largest row's excess over the mean optimal
    objective.  The optimum is the frozen row solver's, in float64 from
    uniform weights, run until its steps are below 1e-13 or stall."""
    k = H.shape[0]
    Z0 = torch.full((1,) + tuple(B.shape), 1.0 / k, dtype=F64,
                    device=B.device)
    opt, _ = row_qp.solve(H[None], B[None], Z0,
                          max_iterations=max_iterations,
                          epsilon_one=1e-15, epsilon_two=1e-13)

    def objective(W):
        return 0.5 * torch.sum((W @ H) * W, dim=1) + torch.sum(B * W,
                                                               dim=1) + c

    f_opt = objective(opt[0])
    excess = objective(Z) - f_opt
    return (float(torch.sum(excess) / torch.sum(f_opt)),
            float(torch.amax(excess) / torch.mean(f_opt)))


def simplex_err(M):
    """The largest distance of a row of ``M`` from the simplex: a row sum
    off 1, or a negative entry."""
    return max(float(torch.amax(torch.abs(torch.sum(M, dim=1) - 1.0))),
               float(torch.clamp(-torch.amin(M), min=0.0)))
