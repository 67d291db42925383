"""Carrying state between the JAX package and the port.

The two packages draw different random numbers from the same seed
(JAX keys vs ``torch.Generator``), so a comparison makes its restart
states once, hands them over as numpy arrays, and runs both fits from
the same start.  Solver configs need no conversion: the port's
``make_config`` takes the same kwargs dicts.
"""

import numpy as np
import torch

__all__ = ["states_from_numpy"]


def states_from_numpy(Z, C, alpha, device, dtype):
    """Turn restart states ``Z (R, n, k)``, ``C (R, k, n)`` and
    ``alpha (R, k)`` (numpy arrays or anything ``np.asarray`` takes,
    such as JAX arrays) into contiguous tensors of ``dtype`` on
    ``device``.  The arrays are copied: JAX hands out read-only
    buffers."""
    Z, C, alpha = (np.array(a) for a in (Z, C, alpha))
    R, n, k = Z.shape
    if C.shape != (R, k, n) or alpha.shape != (R, k):
        raise ValueError(
            "expected Z (R, n, k), C (R, k, n), alpha (R, k); got %s, "
            "%s, %s" % (Z.shape, C.shape, alpha.shape))
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 .contiguous() for a in (Z, C, alpha))
