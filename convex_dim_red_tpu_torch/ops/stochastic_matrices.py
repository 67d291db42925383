"""Random stochastic matrices from a ``torch.Generator``.

Port of convex_dim_red_tpu/ops/stochastic_matrices.py: uniform
entries, normalised along one axis.  It matches the JAX version in
distribution only; the two generators draw different numbers.
"""

import torch

from ..utils.profiling import to_device

__all__ = [
    "uniform_stochastic_matrix",
    "left_stochastic_matrix",
    "right_stochastic_matrix",
]


def uniform_stochastic_matrix(generator, shape, axis=0,
                              dtype=torch.float64, device=None):
    """Random matrix with unit sums along ``axis``.  The numbers are
    drawn on ``generator``'s device and then moved to ``device``
    (default: the generator's device); leading axes of ``shape`` are
    batch axes like any other."""
    m = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device)
    if device is not None:
        m = to_device(m, device)
    return m / m.sum(dim=axis, keepdim=True)


def left_stochastic_matrix(generator, shape, dtype=torch.float64,
                           device=None):
    """Random matrix with unit column sums."""
    return uniform_stochastic_matrix(generator, shape, axis=-2,
                                     dtype=dtype, device=device)


def right_stochastic_matrix(generator, shape, dtype=torch.float64,
                            device=None):
    """Random matrix with unit row sums."""
    return uniform_stochastic_matrix(generator, shape, axis=-1,
                                     dtype=dtype, device=device)
