"""The estimators' ``mesh=`` routes against the JAX package's, float64.

``ArchetypalAnalysis``, ``KernelAA``, ``GPNHConvexCoding``, ``KMeans``
and ``PCA`` with ``mesh=`` run in one gloo world of two CPU processes
(tests/torch_mesh_worlds.py), each beside the same estimator on one
device from the same custom initial state or seed; the parent holds them
to the JAX estimators on a mesh of the same shape from the conftest's
virtual CPU devices.

Tolerances are JAX's own (tests/test_estimator_mesh.py): fitted costs to
rel 1e-8 (abs 1e-10), weights and dictionaries to 1e-6, archetypes to
1e-5, the transform's cost to rel 1e-6 and its weights to 1e-6 (the two
packages start it from other random weights), k-means inertia to rel
1e-10, PCA to 1e-8 up to sign.  The transform's weights are held to
1e-6 against the port's single-device transform, which starts from the
same random weights, and to 1e-5 against JAX's, which starts from
others (the QP stops at a residual of 1e-6 along flat valleys).  With
scale factors (``delta``) the
sharded fit is held to the JAX one at JAX's sharded-delta tolerance
(rtol 1e-6, atol 1e-9; tests/test_parallel.py) and to the port's
single-device restart-grouped iterate, which is what the sharded fit
computes; the port's single-fit core takes its scale-factor step in
another order (models/archetypal_analysis.py), so it is not the
reference there.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from convex_dim_red_tpu import (ArchetypalAnalysis as JAA,
                                GPNHConvexCoding as JGPNH, KernelAA as JKAA,
                                KMeans as JKMeans, PCA as JPCA)
from convex_dim_red_tpu.parallel.mesh import create_mesh as jax_mesh
from tests import torch_mesh_worlds as W

torch.set_num_threads(1)

N, D, K = 32, 6, 3
X = W.planted_data(2, N, D, K, 0.01)
BLOBS = W.blobs(1)
Zs, Cs, ALPHAS, Ws = W.random_states(3, 1, N, K, D)
AA_STATE = dict(weights=Zs[0], dictionary=Cs[0], alpha=ALPHAS[0])
GPNH_STATE = dict(weights=Zs[0], dictionary=Ws[0])
FIT = dict(max_iterations=1000, tolerance=1e-10,
           weights_solver_kwargs=W.FIT_WEIGHTS_KW)
AA_FIT = dict(FIT, dictionary_solver_kwargs=W.DICT_KW)
DELTA_FIT = dict(AA_FIT, delta=0.3, max_iterations=30,
                 scale_factors_solver_kwargs=W.DICT_KW)

CASES = [
    ('aa', 'estimator', dict(kind='aa', X=X, init_state=AA_STATE,
                             transform_rows=(16, 15), fit_kw=AA_FIT)),
    ('aa delta', 'estimator', dict(kind='aa', X=1.2 * X,
                                   init_state=AA_STATE, fit_kw=DELTA_FIT)),
    ('kernel aa', 'estimator', dict(kind='kernel_aa', X=X,
                                    init_state=AA_STATE, fit_kw=AA_FIT)),
    ('gpnh', 'estimator', dict(kind='gpnh', X=X, init_state=GPNH_STATE,
                               fit_kw=dict(FIT, lambda_W=1e-3))),
    ('kmeans', 'kmeans_estimator', dict(X=BLOBS, shape=(2, 1), n_init=5)),
    ('pca', 'pca_estimator', dict(X=X, shape=(1, 2))),
    ('errors', 'errors', dict(X=X[:30])),
]


def _jax_mesh(shape):
    n = int(np.prod(shape))
    return jax_mesh(shape=shape, devices=jax.devices()[:n])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world of two running the cases in the background while the
    JAX references compile."""
    cases = CASES + [('resume', 'resume', dict(
        K=X @ X.T, tmpdir=str(tmp_path_factory.mktemp("ckpt"))))]
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(W.world, cases)


@pytest.fixture(scope="module")
def want(world):
    """The JAX estimators with ``mesh=``, fitted as the port's are."""
    aa = _jax_fit(JAA, X, AA_STATE, AA_FIT)
    # transform overwrites the fitted weights: keep the fit's first.
    aa_fit = {name: np.asarray(getattr(aa, name)) for name in (
        'cost', 'n_iter', 'weights', 'dictionary', 'archetypes')}
    pca = JPCA(3, mesh=_jax_mesh((1, 2)))
    pca_scores = np.asarray(pca.fit_transform(X))
    return {
        'aa': aa_fit,
        'aa transforms': {rows: aa.transform(X[:rows]) for rows in (16, 15)},
        'aa delta': _jax_fit(JAA, 1.2 * X, AA_STATE, DELTA_FIT),
        'kernel aa': _jax_fit(JKAA, X @ X.T, AA_STATE, AA_FIT),
        'gpnh': _jax_fit(JGPNH, X, GPNH_STATE, dict(FIT, lambda_W=1e-3)),
        'kmeans': JKMeans(3, n_init=5, random_state=0,
                          mesh=_jax_mesh((2, 1))).fit(BLOBS),
        'pca': {'explained_variance': pca.explained_variance_,
                'ratio': pca.explained_variance_ratio_,
                'noise_variance': pca.noise_variance_,
                'scores': pca_scores,
                'transform': np.asarray(pca.transform(X))},
    }


@pytest.fixture(scope="module")
def out(world, want):
    return world.result()[0]


def _jax_kw(kw):
    return {k: ({'max_iterations': v['max_iterations']}
                if k == 'weights_solver_kwargs' else v)
            for k, v in kw.items()}


def _jax_fit(cls, data, state, fit_kw):
    model = cls(K, init='custom', mesh=_jax_mesh((1, 2)), **_jax_kw(fit_kw))
    return model.fit(data, **state)


def _assert_fit(got, want, single):
    for ref in (want, single):
        assert got['cost'] == pytest.approx(float(ref['cost']), rel=1e-8,
                                            abs=1e-10)
        assert got['n_iter'] == int(ref['n_iter'])
        for name in ('weights', 'dictionary'):
            np.testing.assert_allclose(got[name], np.asarray(ref[name]),
                                       rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(got['cost_deltas'], single['cost_deltas'],
                               rtol=0, atol=1e-12)
    assert len(got['cost_deltas']) == got['n_iter']
    np.testing.assert_allclose(got['weights'].sum(axis=1), 1.0, atol=1e-10)


def test_archetypal_analysis_mesh_fit_and_transform(out, want):
    """The fit on a (1, 2) mesh and the transform of 16 rows, 8 a rank;
    15 rows do not divide and fall back to one device, as in JAX."""
    got, single = out['aa']['sharded'], out['aa']['single']
    transforms, want = want['aa transforms'], want['aa']
    _assert_fit(got, want, single)
    np.testing.assert_allclose(got['dictionary'] @ X, want['archetypes'],
                               atol=1e-5)
    for rows in (16, 15):
        (w, cost), (w1, cost1) = (got['transform %d' % rows],
                                  single['transform %d' % rows])
        wj, cost_j = transforms[rows]
        # JAX starts the transform's QPs from other random weights; they
        # stop at ||D|| < 1e-6 on flat valleys, so their rows agree to
        # 1e-5.  The port's single device starts where the mesh does.
        for ref_w, ref_cost, atol in ((wj, cost_j, 1e-5),
                                      (w1, cost1, 1e-6)):
            assert cost == pytest.approx(ref_cost, rel=1e-6, abs=1e-10)
            np.testing.assert_allclose(w, np.asarray(ref_w), atol=atol)
        np.testing.assert_allclose(w.sum(axis=1), 1.0, atol=1e-8)


def test_archetypal_analysis_mesh_with_scale_factors(out, want):
    got, want = out['aa delta']['sharded'], want['aa delta']
    assert got['cost'] == pytest.approx(want.cost, rel=1e-6, abs=1e-9)
    alpha = got['alpha']
    assert np.all(np.abs(alpha - 1.0) <= 0.3 + 1e-12)
    assert not np.allclose(alpha, 1.0)
    # Data-space convention: the dictionary is diag(alpha) C.
    np.testing.assert_allclose(got['dictionary'].sum(axis=1), alpha,
                               atol=1e-10)
    np.testing.assert_allclose(alpha, np.asarray(want.alpha), atol=1e-6)


def test_kernel_aa_mesh_fit(out, want):
    got, single = out['kernel aa']['sharded'], out['kernel aa']['single']
    want = want['kernel aa']
    _assert_fit(got, {'cost': want.cost, 'n_iter': want.n_iter,
                      'weights': want.weights,
                      'dictionary': want.dictionary}, single)
    np.testing.assert_allclose(got['dictionary'].sum(axis=1), 1.0,
                               atol=1e-10)


def test_gpnh_mesh_fit(out, want):
    got, single = out['gpnh']['sharded'], out['gpnh']['single']
    want = want['gpnh']
    _assert_fit(got, {'cost': want.cost, 'n_iter': want.n_iter,
                      'weights': want.weights,
                      'dictionary': want.dictionary}, single)


def test_kmeans_mesh_fit(out, want):
    """Five restarts on a restart axis of two (padded to six, the pad
    out of the selection): the single-device fit of the same seed, and
    JAX's on the same blobs."""
    got, single = out['kmeans']['sharded'], out['kmeans']['single']
    assert got['inertia'] == pytest.approx(single['inertia'], rel=1e-12)
    assert got['n_iter'] == single['n_iter']
    for name in ('labels', 'predict'):
        np.testing.assert_array_equal(got[name], single[name])
    np.testing.assert_allclose(got['centers'], single['centers'],
                               atol=1e-12)
    assert got['inertia'] == pytest.approx(want['kmeans'].inertia_,
                                           rel=1e-10)


def test_pca_mesh_fit(out, want):
    got, single = out['pca']['sharded'], out['pca']['single']
    for ref in (single, want['pca']):
        for name in ('explained_variance', 'ratio'):
            np.testing.assert_allclose(got[name], ref[name], rtol=1e-8)
        assert got['noise_variance'] == pytest.approx(
            ref['noise_variance'], rel=1e-8)
        for name in ('scores', 'transform'):
            for j in range(3):
                sign = np.sign(got[name][:, j] @ ref[name][:, j])
                np.testing.assert_allclose(sign * got[name][:, j],
                                           ref[name][:, j], atol=1e-8)


def test_checkpoint_resume_through_a_sharded_estimator(out):
    """A KernelAA fit on a mesh, saved with utils.checkpoint and resumed
    through the sharded estimator: what the single-device resume gives,
    and no worse than the checkpoint."""
    got, single = out['resume']['sharded'], out['resume']['single']
    assert got['resumed'] <= got['first'] + 1e-12
    assert got['resumed'] == pytest.approx(single['resumed'], rel=1e-8,
                                           abs=1e-10)
    np.testing.assert_allclose(got['weights'], single['weights'], atol=1e-6)


@pytest.mark.parametrize("name,match", [
    ('estimator restart axis 2', "'restarts' mesh axis must have size 1"),
    ('estimator rows do not divide', "divisible"),
    ('pca features do not divide', "n_features"),
    ('estimator wrong axes', "mesh must carry axes"),
    ('ensure_mesh_axes wrong axes', "axis_names"),
    ('restarts without the restart axis', "mesh has no restart axis"),
    ('sharded fit restarts do not divide', "do not divide"),
    ('sharded fit unknown backend', "backend")])
def test_mesh_validation_errors(out, name, match):
    kind, message = out['errors'][name]
    assert kind == 'ValueError'
    assert match in message
