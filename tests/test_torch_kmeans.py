"""The port's k-means and gap statistic against the JAX package's.

Float64 on the CPU.  The distances and Lloyd's iterations take the same
inputs in both packages and are held to them: ``_sq_dists`` to 1e-12,
``_lloyd`` from the same initial centroids to equal labels and
``n_iter`` with centroids and inertia within 1e-10 (the same products,
summed in another order).  The seedings draw other random numbers than
JAX's, so they are held to their properties, and the estimator and the
gap statistic to the JAX package's tests (tests/test_kmeans_pca.py) and
to JAX's gap within its Monte-Carlo spread.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convex_dim_red_tpu.models import kmeans as jk
from convex_dim_red_tpu_torch import KMeans, gap_statistic, kmeans_fit
from convex_dim_red_tpu_torch.models import kmeans as tk
from convex_dim_red_tpu_torch.utils.interop import load_fitted_kmeans

torch.set_num_threads(1)

TOL = 1e-10
CENTERS = ((0, 0), (10, 10), (-10, 10))


def _blobs(rng, n_per=50, centers=CENTERS, scale=0.5):
    pts = [c + scale * rng.standard_normal((n_per, 2)) for c in
           np.asarray(centers, dtype=float)]
    return np.concatenate(pts, axis=0)


def _t(a):
    return torch.as_tensor(np.array(a))


def _tol_abs(X, tol=1e-4):
    return tol * float(np.mean(np.var(X, axis=0)))


def test_sq_dists_matches_jax():
    rng = np.random.RandomState(0)
    X = rng.standard_normal((50, 9)) * 3.0 + 1.0
    C = rng.standard_normal((4, 9))
    want = np.asarray(jk._sq_dists(jnp.asarray(X), jnp.asarray(C)))
    got = tk._sq_dists(_t(X), _t(C)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # A centroid on a sample: clamped at 0, never negative.
    assert tk._sq_dists(_t(X), _t(X[:3])).min() >= 0.0


def _lloyd_case(case):
    """``(X, initial centroids, max_iter, tol_abs)``."""
    rng = np.random.RandomState(1)
    if case == "blobs":
        X = _blobs(rng, n_per=30)
        return X, X[[0, 1, 31]], 300, _tol_abs(X)
    X = rng.standard_normal((120, 6))
    C0 = X[rng.choice(120, 5, replace=False)]
    if case == "empty cluster":
        # A centroid far from every sample gets no points: it keeps its
        # place through every iteration.
        C0 = np.concatenate([C0, np.full((1, 6), 50.0)])
        return X, C0, 300, _tol_abs(X)
    # "cut by max_iter": tolerance 0 never stops before the cap.
    return X, C0, 3, 0.0


@pytest.mark.parametrize("case", ["blobs", "empty cluster",
                                  "cut by max_iter"])
def test_lloyd_matches_jax(case):
    X, C0, max_iter, tol = _lloyd_case(case)
    want = jk._lloyd(jnp.asarray(X), jnp.asarray(C0), max_iter, tol)
    got = tk._lloyd(_t(X), _t(C0), max_iter, tol)
    C_w, lab_w, inert_w, it_w = (np.asarray(a) for a in want)
    C_g, lab_g, inert_g, it_g = (a.numpy() for a in got)
    np.testing.assert_array_equal(lab_g, lab_w)
    assert int(it_g) == int(it_w)
    np.testing.assert_allclose(C_g, C_w, rtol=0, atol=TOL)
    assert float(inert_g) == pytest.approx(float(inert_w), rel=TOL)
    if case == "empty cluster":
        assert not np.any(lab_g == 5)
        np.testing.assert_array_equal(C_g[5], np.full(6, 50.0))
    if case == "cut by max_iter":
        assert int(it_g) == 3


def test_batched_restarts_equal_lone_restarts():
    """Restarts (and data sets) that share a batch stop on their own:
    each one's centroids, labels, inertia and ``n_iter`` are those of
    the same restart run alone."""
    rng = np.random.RandomState(2)
    Xs = np.stack([rng.standard_normal((80, 5)) for _ in range(2)])
    Cs = np.stack([np.stack([X[rng.choice(80, 4, replace=False)]
                             for _ in range(5)]) for X in Xs])
    tols = [_tol_abs(X) for X in Xs]
    C, labels, inertia, n_iter = tk._lloyd(_t(Xs), _t(Cs), 300, _t(tols))
    assert C.shape == (2, 5, 4, 5) and labels.shape == (2, 5, 80)
    assert len(set(n_iter.flatten().tolist())) > 1  # they stop apart
    for t in range(2):
        restarts = tk._lloyd(_t(Xs[t]), _t(Cs[t]), 300, tols[t])
        for r in range(5):
            alone = tk._lloyd(_t(Xs[t]), _t(Cs[t, r]), 300, tols[t])
            for batched in (restarts, (C[t], labels[t], inertia[t],
                                       n_iter[t])):
                got = [a[r] for a in batched]
                assert torch.equal(got[1], alone[1])
                assert int(got[3]) == int(alone[3])
                torch.testing.assert_close(got[0], alone[0], rtol=0,
                                           atol=1e-12)
                assert float(got[2]) == pytest.approx(float(alone[2]),
                                                      rel=1e-12)


def test_tol_abs_uses_ddof_0():
    X = np.random.RandomState(3).standard_normal((7, 4))
    got = float(tk._tol_abs(_t(X), 1e-4))
    assert got == pytest.approx(1e-4 * np.var(X, axis=0).mean(), rel=1e-12)
    assert got != pytest.approx(1e-4 * np.var(X, axis=0, ddof=1).mean(),
                                rel=1e-3)


@pytest.mark.parametrize("seeding", [tk.kmeans_plusplus, tk.random_init])
def test_seedings_pick_distinct_rows(seeding):
    rng = np.random.RandomState(4)
    X = _t(rng.standard_normal((30, 3)))
    C = seeding(X, 6, torch.Generator().manual_seed(0), n_init=20)
    assert C.shape == (20, 6, 3)
    for seeds in C:
        rows = [int(torch.nonzero((X == c).all(dim=1))[0]) for c in seeds]
        assert len(set(rows)) == 6  # rows of X, all distinct
    one = seeding(X, 6, torch.Generator().manual_seed(0))
    assert one.shape == (6, 3)


def test_kmeans_plusplus_one_centre_per_blob():
    # Blobs 0.1 wide 14 apart: a second pick in a picked blob has a
    # chance of about 1e-4.
    rng = np.random.RandomState(3)
    X = _t(_blobs(rng, scale=0.1))
    C = tk.kmeans_plusplus(X, 3, torch.Generator().manual_seed(1),
                           n_init=20).numpy()
    blob = np.argmin(((C[..., None, :] - np.asarray(CENTERS)) ** 2)
                     .sum(-1), axis=-1)
    for picks in blob:
        assert sorted(picks.tolist()) == [0, 1, 2]


def test_random_init_rejects_more_clusters_than_samples():
    with pytest.raises(ValueError):
        tk.random_init(torch.zeros((3, 2)), 4, torch.Generator())


# -- the JAX package's k-means tests (tests/test_kmeans_pca.py:18-120) --


def test_kmeans_recovers_separated_blobs():
    X = _blobs(np.random.RandomState(0))
    model = KMeans(n_clusters=3, n_init=5, random_state=0,
                   device='cpu').fit(X)
    centers = np.sort(model.cluster_centers_.numpy(), axis=0)
    expected = np.sort(np.array(CENTERS, dtype=float), axis=0)
    assert np.allclose(centers, expected, atol=0.5)
    for i in range(3):
        assert len(set(model.labels_[i * 50:(i + 1) * 50].tolist())) == 1


def test_kmeans_random_init_recovers_blobs():
    X = _blobs(np.random.RandomState(3))
    model = KMeans(n_clusters=3, init='random', n_init=10, random_state=0,
                   device='cpu').fit(X)
    centers = np.sort(model.cluster_centers_.numpy(), axis=0)
    expected = np.sort(np.array(CENTERS, dtype=float), axis=0)
    assert np.allclose(centers, expected, atol=0.5)


@pytest.mark.parametrize("kwargs", [dict(init='bogus'), dict(mesh=object())])
def test_kmeans_rejects_unknown_init_and_mesh(kwargs):
    with pytest.raises(ValueError):
        KMeans(n_clusters=2, **kwargs)


def test_kmeans_transform_returns_center_distances():
    X = _blobs(np.random.RandomState(4))
    model = KMeans(n_clusters=3, n_init=5, random_state=0,
                   device='cpu').fit(X)
    D = model.transform(X)
    centers = model.cluster_centers_.numpy()
    expected = np.sqrt(((X[:, None, :] - centers[None]) ** 2).sum(-1))
    assert isinstance(D, np.ndarray) and D.shape == (X.shape[0], 3)
    assert np.allclose(D, expected, atol=1e-8)
    assert np.array_equal(np.argmin(D, axis=1), model.predict(X))


def test_kmeans_inertia_matches_sklearn_quality():
    sklearn = pytest.importorskip('sklearn.cluster')
    X = np.random.RandomState(1).standard_normal((200, 5))
    ours = KMeans(n_clusters=4, n_init=10, random_state=0,
                  device='cpu').fit(X)
    ref = sklearn.KMeans(n_clusters=4, n_init=10, random_state=0).fit(X)
    assert ours.inertia_ <= ref.inertia_ * 1.02


def test_kmeans_predict_consistent_with_labels():
    X = _blobs(np.random.RandomState(2))
    model = KMeans(n_clusters=3, n_init=3, random_state=0,
                   device='cpu').fit(X)
    assert np.array_equal(model.predict(X), model.labels_)
    assert np.array_equal(model.fit_predict(X), model.labels_)


def test_kmeans_plusplus_selects_spread_centroids():
    X = _blobs(np.random.RandomState(3))
    centroids = tk.kmeans_plusplus(_t(X), 3,
                                   torch.Generator().manual_seed(0)).numpy()
    dists = np.linalg.norm(centroids[:, None] - centroids[None, :], axis=-1)
    np.fill_diagonal(dists, np.inf)
    assert dists.min() > 5.0


def test_gap_statistic_prefers_true_k():
    X = _blobs(np.random.RandomState(4), n_per=40)
    gaps = {}
    for k in (1, 2, 3, 4):
        model = KMeans(n_clusters=k, n_init=5, random_state=0,
                       device='cpu').fit(X)
        gap, sk = gap_statistic(X, model.inertia_, k, n_trials=20,
                                reference='uniform', random_state=0,
                                device='cpu')
        gaps[k] = (gap, sk)
        assert np.isfinite(gap) and np.isfinite(sk) and sk >= 0
    assert gaps[3][0] > gaps[2][0] > gaps[1][0]


def test_gap_statistic_pca_reference():
    X = _blobs(np.random.RandomState(5), n_per=30)
    model = KMeans(n_clusters=3, n_init=5, random_state=0,
                   device='cpu').fit(X)
    gap, sk = gap_statistic(X, model.inertia_, 3, n_trials=10,
                            reference='pca', random_state=0, device='cpu')
    assert np.isfinite(gap) and np.isfinite(sk)


def test_gap_statistic_rejects_unknown_reference():
    with pytest.raises(ValueError):
        gap_statistic(np.eye(4), 1.0, 2, n_trials=2, reference='bogus',
                      random_state=0, device='cpu')


# -- against the JAX package ------------------------------------------------


@pytest.mark.parametrize("reference", ["uniform", "pca"])
def test_gap_statistic_within_the_monte_carlo_spread_of_jax(reference):
    """The same blob data, 100 reference trials each: the two gaps lie
    within 3 max(sk) + 1e-3 of each other (their draws differ)."""
    X = _blobs(np.random.RandomState(6), n_per=30)
    Wk = jk.KMeans(n_clusters=3, n_init=5, random_state=0).fit(X).inertia_
    gap_j, sk_j = jk.gap_statistic(X, Wk, 3, n_trials=100,
                                   reference=reference, random_state=0)
    gap_t, sk_t = gap_statistic(X, Wk, 3, n_trials=100, reference=reference,
                                random_state=0, device='cpu')
    assert abs(gap_t - gap_j) <= 3 * max(sk_j, sk_t) + 1e-3
    assert sk_t > 0 and sk_j > 0


def test_gap_and_sk_from_the_same_reference_inertias(monkeypatch):
    wks = np.random.RandomState(7).uniform(50.0, 80.0, size=17)
    monkeypatch.setattr(jk, "_uniform_reference_wks",
                        lambda X, key, **kw: jnp.asarray(wks))
    monkeypatch.setattr(tk, "_reference_wks",
                        lambda X, gen, **kw: torch.as_tensor(wks))
    X = np.random.RandomState(8).standard_normal((20, 3))
    gap_j, sk_j = jk.gap_statistic(X, 33.0, 2, n_trials=17, random_state=0)
    gap_t, sk_t = gap_statistic(X, 33.0, 2, n_trials=17, random_state=0,
                                device='cpu')
    assert gap_t == pytest.approx(gap_j, rel=0, abs=1e-12)
    assert sk_t == pytest.approx(sk_j, rel=0, abs=1e-12)


def test_best_restart_inertia_close_to_jax():
    """Best of 10 on an unstructured problem: the two packages' winners
    (other seeds) land within 1% of each other."""
    X = np.random.RandomState(9).standard_normal((150, 4))
    jax_fit = jk.KMeans(n_clusters=4, n_init=10, random_state=0).fit(X)
    C, labels, inertia, n_iter = kmeans_fit(_t(X), 0, n_clusters=4,
                                            n_init=10)
    assert float(inertia) == pytest.approx(jax_fit.inertia_, rel=1e-2)
    # The winner's inertia is its labels' sum of squares.
    resid = _t(X) - C[labels]
    assert float(inertia) == pytest.approx(float((resid ** 2).sum()),
                                           rel=1e-12)
    assert C.shape == (4, 4) and int(n_iter) >= 1


def test_load_fitted_kmeans_predicts_as_jax():
    X = _blobs(np.random.RandomState(10))
    fitted = jk.KMeans(n_clusters=3, n_init=3, random_state=0).fit(X)
    port = load_fitted_kmeans(KMeans(3), fitted.cluster_centers_,
                              device='cpu')
    X_new = np.random.RandomState(11).uniform(-12, 12, size=(40, 2))
    np.testing.assert_array_equal(port.predict(X_new),
                                  fitted.predict(X_new))
    np.testing.assert_allclose(port.transform(X_new),
                               fitted.transform(X_new), rtol=0, atol=1e-12)


def test_unfitted_kmeans_raises():
    with pytest.raises(RuntimeError):
        KMeans(2).predict(np.eye(2))
