"""Carrying state between the JAX package and the port.

The two packages draw different random numbers from the same seed
(JAX keys vs ``torch.Generator``), so a comparison makes its states
once, hands them over as numpy arrays, and runs both fits from the same
start: AA restart states (:func:`states_from_numpy`) and one AA fit's
state (:func:`estimator_state_from_numpy`), GPNH restart states
(:func:`gpnh_states_from_numpy`) and one GPNH fit's
(:func:`gpnh_estimator_state_from_numpy`); or both transform against
the same factors: a fitted AA estimator's
(:func:`load_fitted_estimator`), ``GPNHConvexCoding``'s
(:func:`load_fitted_gpnh`) or ``PCA``'s (:func:`load_fitted_pca`).
Solver configs need no conversion: the port's ``make_config`` takes the
same kwargs dicts.
"""

import numpy as np
import torch

__all__ = ["states_from_numpy", "estimator_state_from_numpy",
           "gpnh_states_from_numpy", "gpnh_estimator_state_from_numpy",
           "load_fitted_estimator", "load_fitted_gpnh", "load_fitted_pca"]


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


def gpnh_states_from_numpy(Z, W, device, dtype):
    """Turn GPNH restart states ``Z (R, n, k)`` and ``W (R, d, k)``
    (numpy or JAX arrays) into contiguous tensors of ``dtype`` on
    ``device``, copied."""
    Z, W = (np.array(a) for a in (Z, W))
    if Z.ndim != 3 or W.ndim != 3 or W.shape[::2] != Z.shape[::2]:
        raise ValueError("expected Z (R, n, k) and W (R, d, k); got %s, %s"
                         % (Z.shape, W.shape))
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 .contiguous() for a in (Z, W))


def gpnh_estimator_state_from_numpy(Z, W, device, dtype):
    """One GPNH fit's state, ``Z (n, k)`` and ``W (d, k)``, as
    contiguous tensors of ``dtype`` on ``device`` (for
    ``init='custom'`` fits)."""
    Z, W = (np.array(a)[None] for a in (Z, W))
    return tuple(t[0] for t in gpnh_states_from_numpy(Z, W, device, dtype))


def load_fitted_gpnh(port_model, weights, dictionary, device="cpu"):
    """Set a port ``GPNHConvexCoding``'s fitted ``weights`` and
    ``dictionary`` from another fit's arrays, each in its dtype on
    ``device``.  Returns ``port_model``."""
    port_model.weights, port_model.dictionary = (
        torch.as_tensor(np.array(a), device=device)
        for a in (weights, dictionary))
    return port_model


def load_fitted_pca(port_model, components, mean, explained_variance,
                    device="cpu"):
    """Set a port ``PCA``'s ``components_`` and ``mean_`` (tensors on
    ``device``) and ``explained_variance_`` (numpy) from another fit's
    arrays, so that both transform the same way.  Returns
    ``port_model``."""
    port_model.components_, port_model.mean_ = (
        torch.as_tensor(np.array(a), device=device)
        for a in (components, mean))
    port_model.explained_variance_ = np.array(explained_variance)
    return port_model
