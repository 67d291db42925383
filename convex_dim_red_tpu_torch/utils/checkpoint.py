"""Checkpoint and resume of a fit's state.

Port of convex_dim_red_tpu/utils/checkpoint.py: a solver state
(``weights``, ``dictionary``, ``alpha``, ``cost``, ``n_iter`` and any
other scalars) is saved to and loaded from an ``.npz`` file, and a fit
resumes from it through the estimators' ``init='custom'`` path.  (The
JAX package tries orbax first; its ``.npz`` branch is the one kept.)
"""

import os

import numpy as np

from .validation import _host

__all__ = ["save_checkpoint", "load_checkpoint", "resume_kernel_aa"]


def _npz_path(path):
    return path if path.endswith('.npz') else path + '.npz'


def save_checkpoint(path, state):
    """Save a dict of tensors, arrays and scalars to ``path`` (``.npz``
    added when missing); tensors are copied to the host."""
    np.savez(_npz_path(path), **{k: _host(v) for k, v in state.items()})


def load_checkpoint(path):
    """Load a checkpoint saved by :func:`save_checkpoint`: a dict of
    numpy arrays."""
    npz_path = _npz_path(path)
    if not os.path.exists(npz_path):
        raise FileNotFoundError("no checkpoint at %s" % npz_path)
    with np.load(npz_path) as f:
        return {k: f[k] for k in f.files}


def resume_kernel_aa(model, kernel, checkpoint, **kwargs):
    """Resume a ``KernelAA`` (on a kernel) or ``ArchetypalAnalysis`` (on
    data) fit from ``checkpoint`` through the custom-init path: sets
    ``model.init = 'custom'`` and fits from the saved ``dictionary``,
    ``weights`` and ``alpha``.  Returns the fitted weights."""
    model.init = 'custom'
    return model.fit_transform(
        kernel,
        dictionary=checkpoint['dictionary'],
        weights=checkpoint['weights'],
        alpha=checkpoint.get('alpha'),
        **kwargs)
