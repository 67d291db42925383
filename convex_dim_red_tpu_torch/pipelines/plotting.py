"""Plotting helpers for the case-study analysis.

Matplotlib equivalents of the reference notebooks' figures
(notebooks/hadisst_{aa,kmeans,combined_plots}.ipynb): spatial pattern
maps (plain lon/lat axes — cartopy is not available in this image),
convex-hull embeddings of the sample weights, and model-selection
curves.  All functions return the figure so callers can save or show.

A copy of convex_dim_red_tpu/pipelines/plotting.py, kept in the port so
that it never imports the JAX package; ``matplotlib`` is imported only
inside the functions.
"""

import numpy as np

__all__ = ["plot_patterns", "plot_state_embedding",
           "plot_model_selection"]


def plot_patterns(patterns, lats, lons, titles=None, cmap="RdBu_r",
                  ncols=2):
    """Grid of spatial pattern maps (archetypes / centroids / EOFs).

    ``patterns``: (k, n_lat, n_lon), NaNs (land) masked out.
    """
    import matplotlib.pyplot as plt

    patterns = np.asarray(patterns)
    k = patterns.shape[0]
    nrows = -(-k // ncols)
    fig, axes = plt.subplots(nrows, ncols,
                             figsize=(6 * ncols, 3 * nrows),
                             squeeze=False)
    vmax = np.nanmax(np.abs(patterns))
    for i in range(nrows * ncols):
        ax = axes[i // ncols][i % ncols]
        if i >= k:
            ax.axis("off")
            continue
        m = ax.pcolormesh(lons, lats, patterns[i], cmap=cmap,
                          vmin=-vmax, vmax=vmax, shading="auto")
        ax.set_title(titles[i] if titles else f"state {i}")
        fig.colorbar(m, ax=ax, shrink=0.8)
    fig.tight_layout()
    return fig


def plot_state_embedding(weights, labels=None, method="mds",
                         random_state=0):
    """2-D embedding of sample weights with the convex hull of the
    states (the notebooks' MDS/t-SNE hull figure)."""
    import matplotlib.pyplot as plt
    from .analysis import embed_states

    emb = embed_states(weights, method=method, random_state=random_state)
    W = np.asarray(weights)
    dominant = W.argmax(axis=1) if labels is None else np.asarray(labels)

    fig, ax = plt.subplots(figsize=(6, 6))
    sc = ax.scatter(emb[:, 0], emb[:, 1], c=dominant, cmap="tab10", s=12)
    try:
        from scipy.spatial import ConvexHull
        hull = ConvexHull(emb)
        for simplex in hull.simplices:
            ax.plot(emb[simplex, 0], emb[simplex, 1], "k-", lw=0.8)
    except Exception:
        pass
    ax.set_title(f"{method.upper()} embedding of state weights")
    fig.colorbar(sc, ax=ax, label="dominant state")
    return fig


def plot_model_selection(results, metrics=("cost", "gap")):
    """Cost / gap statistic vs number of components (the notebooks'
    model-selection curves)."""
    import matplotlib.pyplot as plt

    ks = sorted(results)
    fig, axes = plt.subplots(1, len(metrics),
                             figsize=(5 * len(metrics), 4), squeeze=False)
    for j, metric in enumerate(metrics):
        ax = axes[0][j]
        vals = [results[k].get(metric, np.nan) for k in ks]
        ax.plot(ks, vals, "o-")
        if metric == "gap" and any(
                "gap_sk" in results[k] for k in ks):
            sks = [results[k].get("gap_sk", 0.0) for k in ks]
            ax.errorbar(ks, vals, yerr=sks, fmt="none", capsize=3)
        ax.set_xlabel("n_components")
        ax.set_ylabel(metric)
        ax.grid(alpha=0.3)
    fig.tight_layout()
    return fig
