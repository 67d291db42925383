"""Post-fit analysis utilities.

Re-implements the analysis functions the reference keeps in its
notebooks (notebooks/hadisst_{aa,kmeans,gpnh_convex_coding,
combined_plots}.ipynb): pattern correlation against reference patterns
(EOFs), correlation-based state sorting, model-selection tables
(cost/gap vs k), and low-dimensional embeddings of the archetypes for
convex-hull visualization.

A copy of convex_dim_red_tpu/pipelines/analysis.py, kept in the port so
that it never imports the JAX package; it also takes tensors:
:func:`reconstruction_rmse` computes on the tensors' device and
:func:`model_selection_table` reads 0-d tensors as numbers.
``sklearn`` is imported only by :func:`embed_states`.
"""

import numpy as np
import torch

from ..utils.precision import matmul_precision_scope

__all__ = [
    "pattern_correlation",
    "sort_states",
    "model_selection_table",
    "reconstruction_rmse",
    "embed_states",
]


def pattern_correlation(patterns, reference_patterns, weights=None):
    """Centered spatial correlation of each pattern with each reference.

    ``patterns``: (k, n_features); ``reference_patterns``:
    (m, n_features); NaNs (masked grid cells) are ignored jointly.
    Returns (k, m) correlation matrix.
    """
    P = np.asarray(patterns, dtype=float)
    R = np.asarray(reference_patterns, dtype=float)
    if P.ndim > 2:
        P = P.reshape(P.shape[0], -1)
    if R.ndim > 2:
        R = R.reshape(R.shape[0], -1)

    valid = np.isfinite(P).all(axis=0) & np.isfinite(R).all(axis=0)
    P = P[:, valid]
    R = R[:, valid]
    if weights is not None:
        w = np.asarray(weights, dtype=float).reshape(-1)[valid]
    else:
        w = np.ones(P.shape[1])

    def center(M):
        mean = (M * w).sum(axis=1, keepdims=True) / w.sum()
        return M - mean

    Pc, Rc = center(P), center(R)
    num = (Pc * w) @ Rc.T
    den = np.sqrt(((Pc ** 2) * w).sum(axis=1)[:, None]
                  * ((Rc ** 2) * w).sum(axis=1)[None, :])
    return num / den


def sort_states(patterns, reference_patterns, weights=None):
    """Order states by greedy best |correlation| match to the reference
    patterns (the notebooks' state-sorting step).

    Returns ``(order, signs, corr)``: permutation of state indices, the
    sign of each matched correlation, and the full correlation matrix.
    """
    corr = pattern_correlation(patterns, reference_patterns,
                               weights=weights)
    k, m = corr.shape
    order = np.full(min(k, m), -1, dtype=int)
    signs = np.ones(min(k, m))
    remaining = set(range(k))
    scores = np.abs(corr).copy()
    for j in range(min(k, m)):
        col = scores[:, j].copy()
        col[[i for i in range(k) if i not in remaining]] = -np.inf
        i = int(np.argmax(col))
        order[j] = i
        signs[j] = np.sign(corr[i, j]) or 1.0
        remaining.discard(i)
    return order, signs, corr


def reconstruction_rmse(data, weights, patterns):
    """RMSE of ``weights @ patterns`` against ``data`` (NaN-aware);
    arrays, or tensors, on whose device it is computed (arrays go
    there)."""
    tensors = [a for a in (data, weights, patterns)
               if isinstance(a, torch.Tensor)]
    if tensors:
        like = tensors[0]
        weights, patterns, data = (
            torch.as_tensor(a, dtype=like.dtype, device=like.device)
            for a in (weights, patterns, data))
        with matmul_precision_scope():
            recon = weights @ patterns.reshape(patterns.shape[0], -1)
        diff = recon - data.reshape(data.shape[0], -1)
        return float(torch.sqrt(torch.nanmean(diff ** 2)))
    weights, patterns, data = (np.asarray(a) for a in (weights, patterns,
                                                        data))
    recon = weights @ patterns.reshape(patterns.shape[0], -1)
    data = data.reshape(data.shape[0], -1)
    diff = recon - data
    return float(np.sqrt(np.nanmean(diff ** 2)))


def _number(value):
    return value.item() if isinstance(value, torch.Tensor) else value


def model_selection_table(results):
    """Build a cost/gap-vs-k table (the notebooks' model-selection CSV).

    ``results``: mapping k -> dict with any of 'cost', 'rmse', 'gap',
    'gap_sk', 'test_cost', 'test_rmse' (numbers, or 0-d tensors, which
    are read as numbers).  Returns (header, rows) ready for CSV writing.
    """
    keys = ['cost', 'rmse', 'test_cost', 'test_rmse', 'gap', 'gap_sk']
    header = ['k'] + keys
    rows = []
    for k in sorted(results):
        row = [k] + [_number(results[k].get(key, np.nan)) for key in keys]
        rows.append(row)
    return header, rows


def write_model_selection_csv(path, results):
    header, rows = model_selection_table(results)
    with open(path, 'w') as f:
        f.write(','.join(header) + '\n')
        for row in rows:
            f.write(','.join(str(v) for v in row) + '\n')


def embed_states(weights, method='mds', random_state=0, **kwargs):
    """2-D embedding of the sample weights for convex-hull plots
    (the notebooks use sklearn MDS / t-SNE)."""
    from sklearn.manifold import MDS, TSNE
    W = np.asarray(weights)
    if method == 'mds':
        model = MDS(n_components=2, random_state=random_state, **kwargs)
    elif method == 'tsne':
        model = TSNE(n_components=2, random_state=random_state, **kwargs)
    else:
        raise ValueError("method must be 'mds' or 'tsne'")
    return model.fit_transform(W)
