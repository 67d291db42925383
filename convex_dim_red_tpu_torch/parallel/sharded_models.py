"""Mesh-sharded k-means, PCA and gap statistic on ``torch.distributed``.

Port of convex_dim_red_tpu/parallel/sharded_models.py, under the rules
of :mod:`.mesh` (every rank passes the full inputs, slices its shard and
returns the global result):

- :func:`sharded_kmeans_fit`: Lloyd iterations with the data rows split
  over the ``samples`` axis (the assignment is local; the cluster counts
  and sums, and the inertia, are all-reduced) and the restarts over the
  ``restarts`` axis, with the keep-best selection of the sharded AA fits.
  The seeding is the single-device one's: every rank draws the random
  numbers of all restarts from the same generator and seed and keeps
  its restarts'; a k-means++ draw runs on the all-gathered distance
  vector, and a chosen row comes from the rank that holds it.
- :func:`sharded_pca`: the Gram-path PCA with the features split: each
  rank forms its feature block's partial Gram, one ``all_reduce`` adds
  them, the small ``eigh`` runs on the axis' first rank and is
  broadcast, and the components and mean are gathered over the
  features.
- :func:`sharded_gap_statistic`: the reference trials split over the
  restart axis, each with the single-device function's own generator,
  their inertias gathered.

Every stop decision of a Lloyd loop comes from all-reduced values and is
agreed over the sample group; restart groups never communicate inside
the loop.
"""

import torch

from ..models._common import _generator_on
from ..models.kmeans import (_gap_from_wks, _lloyd, _reference_wks,
                             _sq_dists, _sq_dists_to_rows, _tol_abs,
                             _uniform)
from ..utils.precision import apply_matmul_precision
from ..utils.validation import as_input
from .mesh import _all_gather, _axis, _block, _broadcast, _psum, mesh_device
from .sharded_aa import _select_best, _Shard

__all__ = ["sharded_kmeans_fit", "sharded_pca", "sharded_gap_statistic"]


def _fetch_rows(X_loc, idx, sh):
    """Rows ``idx`` (global indices, any shape) of the row-split data:
    the rank that holds a row gives it, the others zeros, summed over
    the sample group."""
    if sh.n_sample_shards == 1:
        return X_loc[idx]
    n_loc = X_loc.shape[0]
    local = idx - sh.sample_index * n_loc
    owned = (local >= 0) & (local < n_loc)
    rows = X_loc[torch.clamp(local, 0, n_loc - 1)]
    return sh.psum(torch.where(owned[..., None], rows,
                               torch.zeros_like(rows)))


def _seed_indices(X_loc, n, n_clusters, generator, n_src, src, init, sh):
    """The seed rows (global indices, (R, k)) of the restarts ``src`` of
    ``n_src`` seedings drawn from ``generator``: the numbers
    :func:`models.kmeans.kmeans_plusplus` and ``random_init`` draw for
    ``n_src`` restarts, on the row-split data."""
    device, dtype = X_loc.device, X_loc.dtype
    if init == 'random':
        if n_clusters > n:
            raise ValueError("cannot draw %d distinct observations of %d"
                             % (n_clusters, n))
        order = torch.argsort(_uniform(generator, (n_src, n), torch.float64,
                                       device), dim=1)
        return order[src, :n_clusters]
    R = src.shape[0]
    idx = torch.empty((R, n_clusters), dtype=torch.long, device=device)
    idx[:, 0] = torch.randint(0, n, (n_src,), generator=generator,
                              device=generator.device).to(device)[src]
    d2 = torch.full((R, X_loc.shape[0]), float('inf'), dtype=dtype,
                    device=device)
    tiny = torch.finfo(dtype).tiny
    for i in range(1, n_clusters):
        centre = _fetch_rows(X_loc, idx[:, i - 1], sh)
        d2 = torch.minimum(d2, _sq_dists_to_rows(X_loc, centre))
        logits = torch.log(torch.clamp(sh.gather_rows(d2, 1), min=tiny))
        u = torch.clamp(_uniform(generator, (n_src, n), dtype, device),
                        min=tiny)[src]
        idx[:, i] = torch.argmax(logits - torch.log(-torch.log(u)), dim=1)
    return idx


@apply_matmul_precision
def sharded_kmeans_fit(mesh, X, generator, *, n_clusters, n_init=10,
                       max_iter=300, tol=1e-4, init='k-means++',
                       n_valid_restarts=None,
                       restart_axis="restarts", sample_axis="samples"):
    """Best-of-``n_init`` k-means over a (restarts, samples) mesh.

    ``X`` (n, d): rows split over ``sample_axis`` (which must divide
    ``n``); the ``n_init`` restarts over ``restart_axis`` (which must
    divide ``n_init``).  ``generator``: an integer seed or a
    ``torch.Generator`` (the JAX package takes a PRNG key).  The first
    ``n_valid_restarts`` restarts (default all) draw the seedings that
    :func:`models.kmeans.kmeans_fit` draws for that many restarts from
    the same seed; the others, padding for the restart axis, repeat them
    and are left out of the selection, so the result is the
    single-device fit's up to reduction order.  ``tol`` follows sklearn
    (scaled by the mean per-feature variance of ``X``).

    Returns a dict on every rank: the best ``centroids`` and the
    ``labels`` of all rows (tensors), ``inertia``, ``n_iter``, and the
    per-restart ``inertias`` and ``n_iters`` (numpy).
    """
    if init not in ('k-means++', 'random'):
        raise ValueError("init must be 'k-means++' or 'random'")
    sh = _Shard(mesh, restart_axis, sample_axis)
    X = sh.take(X)
    n = X.shape[0]
    X_loc = X[sh.rows(n)]
    n_init = int(n_init)
    n_valid = n_init if n_valid_restarts is None else int(n_valid_restarts)
    blk = sh.restarts(n_init)
    src = torch.arange(n_init, device=sh.device)[blk] % n_valid
    generator = _generator_on(generator, sh.device, mesh=mesh)
    k = int(n_clusters)

    if sh.n_sample_shards == 1:
        tol_abs = _tol_abs(X_loc, tol)
    else:
        mean = sh.psum(torch.sum(X_loc, dim=0)) / n
        var = sh.psum(torch.sum((X_loc - mean) ** 2, dim=0)) / n
        tol_abs = tol * torch.mean(var)

    seeds = _fetch_rows(X_loc, _seed_indices(X_loc, n, k, generator,
                                             n_valid, src, init, sh), sh)
    centroids, _, inertias, n_iters = _lloyd(
        X_loc, seeds, max_iter, tol_abs, reduce=sh.psum, agree=sh.agree)
    (C_best,), inertia, n_iter, _, all_inertias, all_n_iters = \
        _select_best((centroids,), inertias, inertias[:, None], n_iters,
                     n_valid=n_valid, sh=sh)
    labels = torch.argmin(_sq_dists(X_loc, C_best), dim=1)
    return {
        'centroids': C_best,
        'labels': sh.gather_rows(labels, 0),
        'inertia': inertia,
        'n_iter': n_iter,
        'inertias': all_inertias.cpu().numpy(),
        'n_iters': all_n_iters.cpu().numpy(),
    }


@apply_matmul_precision
def sharded_pca(mesh, X, *, n_components, center=True,
                feature_axis="samples"):
    """Gram-path PCA with the features split over ``feature_axis``
    (which must divide them).

    Each rank centres its feature block and forms its partial Gram; one
    ``all_reduce`` gives the n x n Gram, whose ``eigh`` runs on the
    axis' first rank and is broadcast; the back-projection ``Xc' U / s``
    needs only local columns, so each rank forms its block of the
    components, and the blocks are gathered.  The mathematics of
    ``models.pca.pca_fit(use_gram=True)``.  Returns a dict on every rank:
    ``components`` (k, d), ``scores`` (n, k), ``mean`` (d,),
    ``explained_variance`` and ``singular_values`` (k,).
    """
    k = int(n_components)
    size, index, _ = _axis(mesh, feature_axis)
    X = as_input(X, mesh_device(mesh))
    n_samples = X.shape[0]
    X_loc = X[:, _block(X.shape[1], size, index, "features")]
    mean_loc = (X_loc.mean(dim=0) if center
                else torch.zeros((X_loc.shape[1],), dtype=X.dtype,
                                 device=X.device))
    Xc = X_loc - mean_loc[None, :]
    G = _psum(Xc @ Xc.T, mesh, feature_axis)
    if index == 0:
        evals, evecs = torch.linalg.eigh(G)                # ascending
    else:
        evals, evecs = G.new_empty(G.shape[:1]), torch.empty_like(G)
    evals, evecs = (_broadcast(t, mesh, feature_axis, 0)
                    for t in (evals, evecs))
    evals = evals.flip(0)[:k]
    evecs = evecs.flip(1)[:, :k]
    svals = torch.sqrt(torch.clamp(evals, min=0.0))
    safe = torch.clamp(svals, min=torch.finfo(X.dtype).tiny)
    components_loc = (Xc.T @ (evecs / safe[None, :])).T
    return {
        'components': _all_gather(components_loc, mesh, feature_axis, 1),
        'scores': evecs * svals[None, :],
        'mean': _all_gather(mean_loc, mesh, feature_axis, 0),
        'explained_variance': svals ** 2 / max(n_samples - 1, 1),
        'singular_values': svals,
    }


def sharded_gap_statistic(mesh, X, Wk, n_components, *, n_trials=100,
                          reference='uniform', random_state=None,
                          trial_axis="restarts", n_init=10, max_iter=300):
    """Gap statistic with the reference trials split over
    ``trial_axis``: each rank computes its contiguous block of the
    trials (any ``n_trials``; a rank may have none), each trial with the
    generator the single-device ``models.kmeans.gap_statistic`` gives it
    from ``random_state``, and the trials' inertias are gathered, so
    ``(gap, sk)`` is the single-device result.  ``n_init`` and
    ``max_iter`` are the inner fits' (the single-device defaults)."""
    if reference not in ('uniform', 'pca'):
        raise ValueError("unrecognized reference distribution '%s'"
                         % reference)
    X = as_input(X, mesh_device(mesh))
    n_trials = int(n_trials)
    size, index, _ = _axis(mesh, trial_axis)
    per = -(-n_trials // size)
    trials = slice(min(index * per, n_trials),
                   min((index + 1) * per, n_trials))
    wks = _reference_wks(
        X, _generator_on(random_state, X.device, mesh=mesh),
        n_clusters=int(n_components), n_trials=n_trials,
        reference=reference, n_init=int(n_init), max_iter=int(max_iter),
        trials=trials)
    block = torch.full((per,), float('nan'), dtype=torch.float64,
                       device=X.device)
    block[:wks.shape[0]] = wks.double()
    wks = _all_gather(block, mesh, trial_axis)[:n_trials]
    return _gap_from_wks(wks.cpu(), Wk, n_trials)
