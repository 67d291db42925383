"""Euclidean projection onto the probability simplex, in PyTorch.

Port of convex_dim_red_tpu/ops/simplex_projection.py.  With
``u = sort(x, descending)`` and ``s_j = u_1 + ... + u_j``, the active-set
size is ``rho = max{ j : u_j - (s_j - 1)/j > 0 }`` and the threshold is
``tau = (s_rho - 1)/rho``; the projection is ``max(x - tau, 0)``.  One
call projects every 1-D slice of an arbitrarily batched tensor.
"""

import torch

__all__ = [
    "simplex_project",
    "simplex_project_vector",
    "simplex_project_rows",
    "simplex_project_columns",
    "simplex_project_masked",
]


def simplex_project(x, dim=-1):
    """Project every 1-D slice of ``x`` along ``dim`` onto the standard
    simplex ``{p : p >= 0, sum(p) = 1}``."""
    if x.ndim == 0:
        # Projection of a scalar onto the 1-point simplex is 1.
        return torch.ones_like(x)

    n = x.shape[dim]
    u = torch.sort(x, dim=dim, descending=True).values
    css = torch.cumsum(u, dim=dim)

    shape = [1] * x.ndim
    shape[dim] = n
    j = torch.arange(1, n + 1, dtype=x.dtype, device=x.device).view(shape)

    # rho = number of indices with u_j - (s_j - 1)/j > 0  (always >= 1).
    positive = u - (css - 1.0) / j > 0
    rho = positive.sum(dim=dim, keepdim=True)

    css_rho = torch.gather(css, dim, rho - 1)
    tau = (css_rho - 1.0) / rho.to(x.dtype)

    return torch.clamp(x - tau, min=0.0)


def simplex_project_masked(x, mask, dim=-1):
    """Project onto the sub-simplex with masked-out coordinates pinned
    to zero.  Masked entries are replaced by the per-slice sentinel
    ``-(2*max|x_active| + 2)``, which lies below the threshold of the
    active entries, so the result equals the projection of the active
    subvector onto its own simplex (see the JAX function's docstring).
    ``mask`` is a bool tensor broadcastable against ``x``."""
    mask = torch.as_tensor(mask, dtype=torch.bool, device=x.device)
    scale = torch.amax(torch.abs(torch.where(mask, x, 0.0)), dim=dim,
                       keepdim=True)
    sentinel = -(2.0 * scale + 2.0)
    return simplex_project(torch.where(mask, x, sentinel), dim=dim)


def simplex_project_vector(x):
    """Project a single vector onto the standard simplex."""
    return simplex_project(x, dim=-1)


def simplex_project_rows(a):
    """Project each row of ``a`` (any leading batch axes) onto the
    standard simplex."""
    return simplex_project(a, dim=-1)


def simplex_project_columns(a):
    """Project each column of ``a`` (any leading batch axes) onto the
    standard simplex."""
    return simplex_project(a, dim=-2)
