"""Input validation helpers.

Port of convex_dim_red_tpu/utils/validation.py, with its error
messages.  The checks run on the host: tensors are copied there first.
"""

import numpy as np
import torch

__all__ = [
    "check_unit_axis_sums",
    "check_array_shape",
    "check_stochastic_matrix",
]


def _host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def check_unit_axis_sums(a, whom, axis=0):
    """Check sums along an array axis are close to one."""
    axis_sums = _host(a).sum(axis=axis)
    if not np.all(np.isclose(axis_sums, 1)):
        raise ValueError(
            'Array with incorrect axis sums passed to %s. '
            'Expected sums along axis %d to be 1.' % (whom, axis))


def check_array_shape(a, shape, whom):
    """Check array shape matches the given shape."""
    if np.shape(_host(a)) != tuple(shape):
        raise ValueError(
            'Array with wrong shape passed to %s. '
            'Expected %s, but got %s' % (whom, tuple(shape),
                                         np.shape(_host(a))))


def check_stochastic_matrix(a, shape, whom, axis=0):
    """Check array is a stochastic matrix with the correct shape."""
    check_array_shape(a, shape, whom)
    check_unit_axis_sums(a, whom, axis=axis)
