"""Input validation helpers.

Port of convex_dim_red_tpu/utils/validation.py, with its error
messages.  The checks run on the host: tensors are copied there first.
:func:`as_input` places an entry point's data on its device.
"""

import numpy as np
import torch

from .profiling import to_device

__all__ = [
    "as_input",
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


def as_input(data, device=None):
    """An entry point's data as a tensor, in its own dtype.

    A tensor stays on its device unless ``device`` is given; anything
    else (a numpy array, a list) goes to ``device``, by default
    ``'cuda'``: the port runs on the card unless the caller asks for
    the CPU.  Raises ``RuntimeError`` where the device is CUDA and no
    CUDA device is available, rather than running on the CPU.  The
    bytes copied to a card count in ``profiling.H2D_BYTES``.
    """
    if isinstance(data, torch.Tensor) and device is None:
        return data
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available, and the data goes to the card "
            "unless it is a tensor elsewhere: pass device='cpu' to run "
            "on the CPU")
    return to_device(data, device)
