"""Carrying state between the JAX package and the port.

The two packages draw different random numbers from the same seed
(JAX keys vs ``torch.Generator``), so a comparison makes its states
once, hands them over as numpy arrays, and runs both fits from the same
start: restart states (:func:`states_from_numpy`), one fit's state
(:func:`estimator_state_from_numpy`), or a fitted estimator's factors
(:func:`load_fitted_estimator`).  Solver configs need no conversion:
the port's ``make_config`` takes the same kwargs dicts.
"""

import numpy as np
import torch

__all__ = ["states_from_numpy", "estimator_state_from_numpy",
           "load_fitted_estimator"]


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


def estimator_state_from_numpy(Z, C, alpha, device, dtype):
    """One fit's state, ``Z (n, k)``, ``C (k, n)`` and ``alpha (k,)``,
    as contiguous tensors of ``dtype`` on ``device`` (for
    ``init='custom'`` fits)."""
    Z, C, alpha = (np.array(a)[None] for a in (Z, C, alpha))
    return tuple(t[0] for t in states_from_numpy(Z, C, alpha, device,
                                                 dtype))


def load_fitted_estimator(port_model, weights, dictionary, alpha,
                          archetypes=None, device="cpu"):
    """Set a port estimator's fitted factors from another fit's arrays
    (a JAX fit's, say), so that both transform against the same
    archetypes.  Each array keeps its dtype and goes to ``device``;
    ``archetypes`` is for ``ArchetypalAnalysis`` (``KernelAA`` has
    none).  Returns ``port_model``."""
    port_model.weights, port_model.dictionary, port_model.alpha = (
        torch.as_tensor(np.array(a), device=device)
        for a in (weights, dictionary, alpha))
    if archetypes is not None:
        port_model.archetypes = torch.as_tensor(np.array(archetypes),
                                                device=device)
    return port_model
