"""Rank-``r`` monthly fields plus noise, standardised per point: a frozen
copy of ``bench.py:make_data`` with the seed as an argument (at seed 42
it is bit-equal to that function), and held-out months drawn from the
same model for the transform traffic."""

import numpy as np


def _rng(seed):
    return np.random.RandomState(int(seed) % 2 ** 32)


def make(seed, *, n_samples, n_features, rank, noise, dtype):
    """The training field ``X`` (``n_samples`` x ``n_features``) and what
    held-out months need: ``{"X": X, "V": V, "mean": m, "std": s}``,
    with ``X = ((U V + noise) - m) / s`` in ``dtype``."""
    rng = _rng(seed)
    U = rng.standard_normal((n_samples, rank))
    V = rng.standard_normal((rank, n_features))
    X = U @ V + noise * rng.standard_normal((n_samples, n_features))
    mean = X.mean(axis=0)
    X -= mean
    std = X.std(axis=0) + 1e-12
    X /= std
    return {"X": X.astype(dtype), "V": V, "mean": mean, "std": std}


def held_out(data, seed, n_rows, *, noise, dtype):
    """``n_rows`` new months of the same model (the same ``V``, fresh
    loadings and noise, from ``seed``), standardised with the training
    months' statistics."""
    rng = _rng(seed)
    V = data["V"]
    U = rng.standard_normal((n_rows, V.shape[0]))
    Y = U @ V + noise * rng.standard_normal((n_rows, V.shape[1]))
    return ((Y - data["mean"]) / data["std"]).astype(dtype)
