"""The port's PCA against the JAX package's, float64: both paths (SVD
and Gram eigendecomposition), the fitted attributes, ``transform`` and
``inverse_transform``.

Eigenvector signs are arbitrary in both packages, so each port
component (and its score column) is flipped to the sign of the JAX one
before comparing.  Tolerance 1e-10: the same decomposition, summed in
another order (the spectrum here is well separated).
"""

import numpy as np
import pytest
import torch

from convex_dim_red_tpu.models import pca as jpca
from convex_dim_red_tpu_torch.models import pca as tpca
from convex_dim_red_tpu_torch.utils.interop import load_fitted_pca
from tests.torch_mesh_worlds import bad_mesh

torch.set_num_threads(1)

TOL = 1e-10


def _data(seed, n, d):
    """Low rank plus noise, column scales spread so the leading
    eigenvalues are well separated."""
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, 4)) @ rng.standard_normal((4, d))
    X += 0.3 * rng.standard_normal((n, d))
    return X * np.linspace(1.0, 2.0, d) + 0.5


def _signs(got, want):
    """Per-component signs that turn ``got``'s rows into ``want``'s."""
    return np.where(np.sum(got * want, axis=1) < 0, -1.0, 1.0)


@pytest.mark.parametrize("n,d,use_gram", [
    (64, 10, False), (64, 10, True), (12, 60, 'auto'), (64, 10, 'auto')])
@pytest.mark.parametrize("center", [True, False])
def test_pca_matches_jax(n, d, use_gram, center):
    X = _data(n + d, n, d)
    k = 3
    want = jpca.PCA(k, center=center, use_gram=use_gram)
    want_scores = np.asarray(want.fit_transform(X))
    got = tpca.PCA(k, center=center, use_gram=use_gram, device='cpu')
    scores = got.fit_transform(X).numpy()

    comps, want_comps = got.components_.numpy(), np.asarray(want.components_)
    s = _signs(comps, want_comps)
    np.testing.assert_allclose(comps * s[:, None], want_comps, rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(scores * s[None, :], want_scores, rtol=0,
                               atol=TOL * np.abs(want_scores).max())
    np.testing.assert_allclose(got.mean_.numpy(), np.asarray(want.mean_),
                               rtol=0, atol=TOL)
    for name in ('explained_variance_', 'explained_variance_ratio_',
                 'singular_values_'):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=TOL)
    assert got.noise_variance_ == pytest.approx(want.noise_variance_,
                                                rel=TOL)

    X_new = _data(7, 5, d)
    t_new = got.transform(torch.as_tensor(X_new)).numpy()
    np.testing.assert_allclose(t_new * s[None, :],
                               np.asarray(want.transform(X_new)), rtol=0,
                               atol=TOL * np.abs(t_new).max())
    back = got.inverse_transform(scores).numpy()
    np.testing.assert_allclose(back, np.asarray(want.inverse_transform(
        want_scores)), rtol=0, atol=TOL * np.abs(X).max())


def test_gram_and_svd_paths_agree_in_the_port():
    X = torch.as_tensor(_data(3, 40, 90))
    kw = dict(n_components=5)
    c1, v1, m1, s1 = tpca.pca_fit(X, use_gram=True, **kw)
    c2, v2, m2, s2 = tpca.pca_fit(X, use_gram=False, **kw)
    s = torch.where(torch.sum(c1 * c2, dim=1) < 0, -1.0, 1.0)
    np.testing.assert_allclose((c1 * s[:, None]).numpy(), c2.numpy(),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(v1.numpy(), v2.numpy(), rtol=1e-10)
    np.testing.assert_allclose((s1 * s).numpy(), s2.numpy(), rtol=0,
                               atol=1e-9)
    assert torch.equal(m1, m2)


def test_all_components_leave_no_noise_variance():
    X = _data(4, 20, 6)
    got = tpca.PCA(6, device='cpu').fit(X)
    want = jpca.PCA(6).fit(X)
    assert got.noise_variance_ == want.noise_variance_ == 0.0
    np.testing.assert_allclose(got.explained_variance_ratio_.sum(), 1.0,
                               rtol=1e-12)


def test_transforms_of_a_loaded_fit_match_jax():
    """The JAX fit's factors loaded into the port: the same transform,
    signs and all."""
    X = _data(5, 30, 8)
    want = jpca.PCA(3).fit(X)
    got = load_fitted_pca(tpca.PCA(3, device='cpu'), want.components_,
                          want.mean_, want.explained_variance_)
    np.testing.assert_allclose(got.transform(X).numpy(),
                               np.asarray(want.transform(X)), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(got.explained_variance_,
                                  want.explained_variance_)


@pytest.mark.parametrize("kind", ['not a mesh', 'wrong axes'])
def test_mesh_is_not_ported(kind):
    """``mesh=`` is ported (tests/test_torch_estimator_mesh.py); one that
    is not a DeviceMesh, or lacks the mesh axes, raises naming mesh."""
    with bad_mesh(kind) as mesh:
        with pytest.raises(ValueError, match="mesh"):
            tpca.PCA(2, mesh=mesh)
