"""K-means clustering and gap-statistic model selection in PyTorch.

Port of convex_dim_red_tpu/models/kmeans.py.  The JAX package runs the
Lloyd iterations as a ``lax.while_loop`` whose distances are one
``X @ C'`` product and whose centroid update is a one-hot product, the
``n_init`` restarts as a ``vmap`` of that loop and the gap statistic's
reference trials as a ``lax.map``; XLA compiles all of it, with no
Pallas kernel.  Here the same arithmetic is plain torch ops on the
data's device:

- :func:`_lloyd` advances a batch of restarts, and of gap trials, at
  once: the distances of every restart of a trial in one product, their
  centroid sums in another.  Each restart has its own stopping test and
  is frozen once it stops, as under the JAX ``vmap``, so it ends with
  the centroids, inertia and ``n_iter`` it reaches alone.  The host
  reads whether any restart still runs once per :data:`_ROUND`
  iterations.
- :func:`kmeans_plusplus` and :func:`random_init` seed a batch of
  restarts from one ``torch.Generator``.
- :func:`gap_statistic` gives each reference trial a generator of its
  own, seeded from ``random_state``, so a trial draws the same numbers
  however many trials share a batch, and runs as many trials at once as
  :data:`_BATCH_ELEMENTS` allows.

The random numbers differ from the JAX package's (``torch.Generator``
against JAX keys); the algorithms and their stopping rules are the
same.  ``KMeans(mesh=...)`` runs ``parallel.sharded_models.
sharded_kmeans_fit`` (rows over the sample axis, restarts over the
restart axis).
"""

import math

import torch

from ..utils.precision import apply_matmul_precision
from ..utils.validation import as_input
from ._common import (_check_mesh, _fit_device, _generator_on,
                      prepare_estimator_mesh)

__all__ = ["KMeans", "kmeans_fit", "kmeans_plusplus", "random_init",
           "gap_statistic"]

#: Lloyd iterations between two host reads of "is any restart still
#: running"; a frozen restart does not change, so the extra iterations
#: of the last round move no result.
_ROUND = 8
#: Elements of the largest temporary a batch may hold: k-means++'s
#: differences ``X - c`` of a chunk of restarts, and the stacked
#: reference draws of a batch of gap trials (2**28 float32 is 1 GiB).
_BATCH_ELEMENTS = 2 ** 28
#: The gap statistic's inner fits, as in the JAX package: k-means++,
#: best of 10, at most 300 iterations, tolerance 1e-4.
_GAP_N_INIT, _GAP_MAX_ITER, _GAP_TOL = 10, 300, 1e-4


def _uniform(generator, shape, dtype, device):
    """Uniform draws on ``generator``'s device, moved to ``device``."""
    return torch.rand(shape, generator=generator, dtype=dtype,
                      device=generator.device).to(device)


@apply_matmul_precision
def _sq_dists(X, centroids):
    """Squared Euclidean distances by one product, ``|x|^2 - 2 x.c +
    |c|^2`` clamped at 0: ``X`` (..., n, d) and ``centroids`` (..., k,
    d) give (..., n, k)."""
    x2 = torch.sum(X * X, dim=-1, keepdim=True)
    c2 = torch.sum(centroids * centroids, dim=-1)
    cross = X @ centroids.transpose(-2, -1)
    return torch.clamp(x2 - 2.0 * cross + c2.unsqueeze(-2), min=0.0)


def _sq_dists_to_rows(X, rows):
    """``sum((X - c)^2)`` for each row ``c`` of ``rows`` (R, d): (R,
    n), by differences (a row's own distance is exactly 0), in chunks
    of restarts of at most :data:`_BATCH_ELEMENTS` elements."""
    n, d = X.shape
    chunk = max(1, _BATCH_ELEMENTS // max(n * d, 1))
    out = torch.empty((rows.shape[0], n), dtype=X.dtype, device=X.device)
    for s in range(0, rows.shape[0], chunk):
        diff = X[None] - rows[s:s + chunk, None, :]
        out[s:s + chunk] = torch.sum(diff * diff, dim=-1)
    return out


def kmeans_plusplus(X, n_clusters, generator, n_init=None, device=None):
    """k-means++ seeding (Arthur & Vassilvitskii): the first centre
    uniform, each next one a categorical draw over ``log(max(d^2,
    tiny))`` with ``d^2`` the squared distance to the nearest centre so
    far (a chosen point keeps a tiny, nonzero weight; no local trials).
    Returns ``(n_clusters, d)``, or ``(n_init, n_clusters, d)``: a batch
    of independent seedings from the one ``generator`` (a
    ``torch.Generator`` or an integer seed).  ``X`` goes to ``device``
    as :func:`utils.validation.as_input` says."""
    X = as_input(X, device)
    generator = _generator_on(generator, X.device)
    R = 1 if n_init is None else int(n_init)
    n = X.shape[0]
    idx = torch.empty((R, n_clusters), dtype=torch.long, device=X.device)
    idx[:, 0] = torch.randint(0, n, (R,), generator=generator,
                              device=generator.device).to(X.device)
    d2 = torch.full((R, n), math.inf, dtype=X.dtype, device=X.device)
    tiny = torch.finfo(X.dtype).tiny
    for i in range(1, n_clusters):
        d2 = torch.minimum(d2, _sq_dists_to_rows(X, X[idx[:, i - 1]]))
        logits = torch.log(torch.clamp(d2, min=tiny))
        # A categorical draw as the argmax of logits plus Gumbel noise.
        u = torch.clamp(_uniform(generator, (R, n), X.dtype, X.device),
                        min=tiny)
        idx[:, i] = torch.argmax(logits - torch.log(-torch.log(u)), dim=1)
    centroids = X[idx]
    return centroids[0] if n_init is None else centroids


def random_init(X, n_clusters, generator, n_init=None, device=None):
    """Random seeding: ``n_clusters`` distinct observations drawn
    uniformly (sklearn ``init='random'``, the option the reference
    drivers expose).  Arguments and shapes as :func:`kmeans_plusplus`."""
    X = as_input(X, device)
    generator = _generator_on(generator, X.device)
    n = X.shape[0]
    if n_clusters > n:
        raise ValueError("cannot draw %d distinct observations of %d"
                         % (n_clusters, n))
    R = 1 if n_init is None else int(n_init)
    order = torch.argsort(_uniform(generator, (R, n), torch.float64,
                                   X.device), dim=1)
    centroids = X[order[:, :n_clusters]]
    return centroids[0] if n_init is None else centroids


def _tol_abs(X, tol):
    """sklearn's tolerance: ``tol`` times the mean per-feature variance
    (ddof 0) of ``X`` (..., n, d), one per leading index."""
    return tol * torch.mean(torch.var(X, dim=-2, correction=0), dim=-1)


@apply_matmul_precision
def _lloyd(X, centroids, max_iter, tol_abs, reduce=None, agree=None):
    """Lloyd iterations until the squared centroid shift falls below
    ``tol_abs`` or ``max_iter`` iterations.

    ``X`` (n, d) with ``centroids`` (k, d), one run, or (R, k, d), ``R``
    restarts on the same data; or ``X`` (T, n, d) with ``centroids`` (T,
    R, k, d) and ``tol_abs`` (T,), ``R`` restarts on each of ``T`` data
    sets.  Every restart stops on its own and is frozen from then on.
    Empty clusters keep their previous centroid; ties go to the first
    centroid.  Returns ``(centroids, labels, inertia, n_iter)`` shaped by
    the batch: ``(..., k, d)``, ``(..., n)``, ``(...)``, ``(...)``.

    A sharded fit passes its own rows as ``X``, and ``reduce``, the sum
    over its sample group that the cluster counts and sums and the
    inertia go through, and ``agree``, which maps the host's "is any
    restart still running" to the group's, so every rank leaves
    together; the labels stay local.
    """
    if reduce is None:
        def reduce(t):
            return t
    batch_shape = centroids.shape[:-2]
    if X.ndim == 2:
        X = X[None]
    C = centroids.reshape((X.shape[0], -1) + centroids.shape[-2:])
    T, n, d = X.shape
    R, k = C.shape[1], C.shape[2]
    tol = torch.as_tensor(tol_abs, dtype=X.dtype,
                          device=X.device).reshape(-1, 1)

    def assign(C):
        d2 = _sq_dists(X, C.reshape(T, R * k, d)).view(T, n, R, k)
        return d2, torch.argmin(d2, dim=-1)

    shift = torch.full((T, R), math.inf, dtype=X.dtype, device=X.device)
    n_iter = torch.zeros((T, R), dtype=torch.int64, device=X.device)
    for it in range(int(max_iter)):
        active = shift >= tol
        if it % _ROUND == 0 and it:
            running = bool(active.any())
            if agree is not None:
                running = not agree(not running)
            if not running:
                break
        _, labels = assign(C)
        onehot = torch.nn.functional.one_hot(labels, k).to(X.dtype)
        counts = reduce(torch.sum(onehot, dim=1))             # (T, R, k)
        sums = reduce((onehot.view(T, n, R * k).transpose(1, 2) @ X)
                      .view(T, R, k, d))
        new = sums / torch.clamp(counts, min=1.0)[..., None]
        new = torch.where((counts > 0)[..., None], new, C)
        new_shift = torch.sum((new - C) ** 2, dim=(-2, -1))
        C = torch.where(active[..., None, None], new, C)
        shift = torch.where(active, new_shift, shift)
        n_iter += active.to(n_iter.dtype)

    d2, labels = assign(C)
    # Each restart's sum over its own contiguous row, in the same order
    # whatever R is.
    inertia = reduce(torch.sum(torch.amin(d2, dim=-1).transpose(1, 2)
                               .contiguous(), dim=-1))        # (T, R)
    return (C.reshape(batch_shape + (k, d)),
            labels.permute(0, 2, 1).reshape(batch_shape + (n,)),
            inertia.reshape(batch_shape), n_iter.reshape(batch_shape))


_SEEDINGS = {'k-means++': kmeans_plusplus, 'random': random_init}


@apply_matmul_precision
def kmeans_fit(X, generator, *, n_clusters, n_init=10, max_iter=300,
               tol=1e-4, init='k-means++', device=None):
    """Best-of-``n_init`` k-means fit; the restarts run as one batch.

    ``X`` goes to ``device`` as :func:`utils.validation.as_input` says
    (a tensor stays where it is; the fit runs on its device, in its
    dtype); ``generator``: a ``torch.Generator`` or an integer seed (the
    JAX package takes a PRNG key).  ``tol`` follows sklearn: it is
    scaled by the mean per-feature variance of ``X``.  Returns
    ``(centroids, labels, inertia, n_iter)`` of the lowest-inertia
    restart (the first of equal ones), as tensors.
    """
    X = as_input(X, device)
    generator = _generator_on(generator, X.device)
    seeds = _SEEDINGS[init](X, int(n_clusters), generator,
                            n_init=int(n_init))
    centroids, labels, inertia, n_iter = _lloyd(X, seeds, max_iter,
                                                _tol_abs(X, tol))
    best = int(torch.argmin(inertia))
    return centroids[best], labels[best], inertia[best], n_iter[best]


class KMeans:
    """sklearn-style k-means estimator: ``fit`` / ``fit_predict`` /
    ``predict`` / ``transform`` and the fitted ``cluster_centers_`` (a
    tensor on the data's device), ``labels_`` (numpy), ``inertia_`` and
    ``n_iter_``, as the JAX package's.  ``device``: where a numpy input
    goes (:func:`utils.validation.as_input`: the card unless
    ``device='cpu'``); ``random_state``: an integer, None, a
    ``numpy.random.RandomState`` or a ``torch.Generator``.  ``mesh`` (a
    DeviceMesh, see parallel/mesh.py) runs
    ``parallel.sharded_models.sharded_kmeans_fit``: rows over the sample
    axis, the restarts over the restart axis (``n_init`` padded up to a
    multiple of it, the pads out of the selection), on the mesh's
    device."""

    def __init__(self, n_clusters, init='k-means++', n_init=10,
                 max_iter=300, tol=1e-4, random_state=None, mesh=None,
                 device=None):
        if init not in _SEEDINGS:
            raise ValueError("init must be 'k-means++' or 'random' "
                             "(reference run_hadisst_kmeans.py:48-49)")
        _check_mesh(mesh)
        self.init = init
        self.n_clusters = n_clusters
        self.n_init = n_init
        self.max_iter = max_iter
        self.tol = tol
        self.random_state = random_state
        self.mesh = mesh
        self.device = device

        self.cluster_centers_ = None
        self.labels_ = None
        self.inertia_ = None
        self.n_iter_ = None

    def fit(self, X):
        X = as_input(X, _fit_device(self.mesh, self.device))
        if self.mesh is not None:
            return self._fit_sharded(X)
        centroids, labels, inertia, n_iter = kmeans_fit(
            X, _generator_on(self.random_state, X.device),
            n_clusters=self.n_clusters, n_init=self.n_init,
            max_iter=self.max_iter, tol=self.tol, init=self.init)
        self.cluster_centers_ = centroids
        self.labels_ = labels.cpu().numpy()
        self.inertia_ = float(inertia)
        self.n_iter_ = int(n_iter)
        return self

    def _fit_sharded(self, X):
        """The fit over the estimator's mesh: rows over the sample
        axis, the ``n_init`` restarts over the restart axis."""
        # Deferred: parallel imports this module.
        from ..parallel.sharded_models import sharded_kmeans_fit

        mesh = prepare_estimator_mesh(self.mesh, X.shape[0],
                                      'KMeans(mesh=...)', single_fit=False)
        r_shards = mesh.size(mesh.mesh_dim_names.index('restarts'))
        res = sharded_kmeans_fit(
            mesh, X, self.random_state, n_clusters=self.n_clusters,
            n_init=-(-int(self.n_init) // r_shards) * r_shards,
            max_iter=self.max_iter, tol=self.tol, init=self.init,
            n_valid_restarts=int(self.n_init))
        self.cluster_centers_ = res['centroids']
        self.labels_ = res['labels'].cpu().numpy()
        self.inertia_ = res['inertia']
        self.n_iter_ = res['n_iter']
        return self

    def fit_predict(self, X):
        return self.fit(X).labels_

    def _sq_dists_to_centers(self, X):
        """New data (on the centres' device, in their dtype) against the
        fitted centres."""
        if self.cluster_centers_ is None:
            raise RuntimeError("KMeans instance is not fitted yet; "
                               "call fit() first")
        C = self.cluster_centers_
        return _sq_dists(torch.as_tensor(X, dtype=C.dtype, device=C.device),
                         C)

    def predict(self, X):
        """The nearest centre of each row of ``X`` (numpy)."""
        return torch.argmin(self._sq_dists_to_centers(X), dim=1) \
            .cpu().numpy()

    def transform(self, X):
        """Distances to each cluster centre (numpy; the sklearn
        ``transform`` surface the reference drivers' validation cost
        uses, run_hadisst_kmeans.py:281-282)."""
        return torch.sqrt(self._sq_dists_to_centers(X)).cpu().numpy()


# ---------------------------------------------------------------------------
# Gap statistic
# ---------------------------------------------------------------------------


@apply_matmul_precision
def _reference_wks(X, generator, *, n_clusters, n_trials, reference,
                   n_init=_GAP_N_INIT, max_iter=_GAP_MAX_ITER,
                   trials=slice(None)):
    """The best-of-``n_init`` k-means inertia of each of ``n_trials``
    reference draws (at most ``max_iter`` Lloyd iterations), a tensor;
    ``trials`` (a slice) computes only those trials, as a sharded gap
    statistic does.

    'uniform': each draw is uniform in the per-feature box of ``X``
    (reference kmeans.py:18-34); 'pca': uniform in the box of ``X``'s
    coordinates on its top ``min(100, n, d)`` right singular vectors,
    rotated back (kmeans.py:37-64).  Trial ``t`` draws its data and then
    seeds its restarts from a generator of its own on ``X``'s device;
    trials run in batches of as many draws as fit in
    :data:`_BATCH_ELEMENTS`.
    """
    n, d = X.shape
    basis = None
    if reference == 'pca':
        n_svd = int(min(100, n, d))
        basis = torch.linalg.svd(X, full_matrices=False)[2][:n_svd]
        box = X @ basis.T
    else:
        box = X
    lo = torch.amin(box, dim=0)
    span = torch.amax(box, dim=0) - lo
    seeds = torch.randint(0, 2 ** 62, (int(n_trials),), generator=generator,
                          device=generator.device).tolist()[trials]
    per = max(1, min(len(seeds), _BATCH_ELEMENTS // max(n * d, 1)))
    wks = []
    for s in range(0, len(seeds), per):
        gens = [torch.Generator(device=X.device).manual_seed(seed)
                for seed in seeds[s:s + per]]
        draws = torch.empty((len(gens), n, box.shape[1]), dtype=X.dtype,
                            device=X.device)
        for draw, gen in zip(draws, gens):
            draw.uniform_(generator=gen)
        draws = draws * span + lo
        if basis is not None:
            draws = draws @ basis
        seeded = torch.stack([
            kmeans_plusplus(draw, n_clusters, gen, n_init=n_init)
            for draw, gen in zip(draws, gens)])
        _, _, inertia, _ = _lloyd(draws, seeded, max_iter,
                                  _tol_abs(draws, _GAP_TOL))
        wks.append(torch.amin(inertia, dim=1))
    if not wks:
        return torch.zeros((0,), dtype=X.dtype, device=X.device)
    return torch.cat(wks)


def _gap_from_wks(wks, Wk, n_trials):
    """``(gap, sk)`` from the reference inertias: ``mean(log wks) -
    log(Wk)`` and ``std(log wks) sqrt(1 + 1 / n_trials)`` (ddof 0), in
    float64."""
    ln_wks = torch.log(torch.as_tensor(wks).double())
    sk = float(torch.std(ln_wks, correction=0)
               * math.sqrt(1.0 + 1.0 / n_trials))
    gap = float(torch.mean(ln_wks)) - math.log(float(Wk))
    return gap, sk


def gap_statistic(X, Wk, n_components, n_trials=100, reference='uniform',
                  n_jobs=None, random_state=None, device=None):
    """Gap statistic (Tibshirani et al.) for k-means model selection.

    The signature of the reference ``gap_statistic`` (kmeans.py:81-108);
    ``n_jobs`` is accepted and ignored (the trials run as device
    batches).  ``X`` goes to ``device`` as :func:`utils.validation.
    as_input` says; ``reference``: 'uniform' or 'pca'.  Returns ``(gap,
    sk)``.
    """
    del n_jobs
    if reference not in ('uniform', 'pca'):
        raise ValueError("unrecognized reference distribution '%s'"
                         % reference)
    X = as_input(X, device)
    wks = _reference_wks(X, _generator_on(random_state, X.device),
                         n_clusters=int(n_components),
                         n_trials=int(n_trials), reference=reference)
    return _gap_from_wks(wks, Wk, int(n_trials))
