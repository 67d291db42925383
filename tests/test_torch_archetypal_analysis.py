"""The port's archetypal analysis against the JAX package's, float64:
the cost and the three updates, the single-fit loop through both
estimators, ``transform``, the verbose table and the watchdog.

The two packages draw different random numbers, so every fit starts
from one ``init='custom'`` state made with numpy (or, for FurthestSum,
by the JAX initializer with a fixed ``start_index``).

Tolerances.  The cost and the dictionary and scale-factor updates are
the same arithmetic summed in another order: 1e-10.  Solved to
convergence, the dictionary subproblem has many minimizers (its
objective sees C only through C X, and X has rank 6 < n), so there C X
and the objective are compared.  A weights update solves each row to
the QP solver's own resolution (tests/test_torch_row_solver.py), so
its x agrees to 1e-8 and its cost to 1e-12.  Whole fits carry that into
costs within 1e-8, with equal iteration counts, and Z and the
archetypes C X within 1e-6.  C itself drifts further along the
directions X does not see (up to 1.6e-6 here), so it is held to 1e-5.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from convex_dim_red_tpu.models import archetypal_analysis as jaa
from convex_dim_red_tpu.ops.pallas_qp import (quad_simplex_qp_pallas,
                                              quad_simplex_qp_pallas_packed)
from convex_dim_red_tpu.solvers.spg import _pallas_qp_kwargs
from convex_dim_red_tpu_torch.models import archetypal_analysis as taa
from convex_dim_red_tpu_torch.ops import simplex_qp
from convex_dim_red_tpu_torch.utils.interop import (
    estimator_state_from_numpy, load_fitted_estimator)
from tests.torch_mesh_worlds import bad_mesh

# Small tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores.
torch.set_num_threads(1)

N, D, K = 48, 6, 3


def _stochastic(rng, shape):
    m = rng.uniform(size=shape)
    return m / m.sum(axis=1, keepdims=True)


def _data(seed=0, n=N, k=K):
    """Planted archetypes plus a little noise: a well-conditioned fit."""
    rng = np.random.RandomState(seed)
    basis = rng.uniform(size=(k, D))
    Z = _stochastic(rng, (n, k))
    for comp, i in enumerate(rng.choice(n, size=k, replace=False)):
        Z[i] = 0.0
        Z[i, comp] = 1.0
    return Z @ basis + 0.01 * rng.standard_normal((n, D))


def _state(seed, n=N, k=K, delta=0.0):
    rng = np.random.RandomState(seed)
    Z = _stochastic(rng, (n, k))
    C = _stochastic(rng, (k, n))
    alpha = rng.uniform(1 - delta, 1 + delta, size=k)
    return Z, C, alpha


def _t(a):
    return torch.as_tensor(np.array(a))


def _parts(X, Z, C, alpha):
    K_ = X @ X.T
    CK = C @ K_
    return dict(K=K_, KZ=K_ @ Z, ZtZ=Z.T @ Z, CK=CK, CKCt=CK @ C.T,
                CKZ=CK @ Z)


@pytest.mark.parametrize("delta", [0.0, 0.3])
def test_kernel_aa_cost_matches_jax(delta):
    X = _data()
    Z, C, alpha = _state(1, delta=delta)
    K_ = X @ X.T
    want = float(jaa.kernel_aa_cost(K_, Z, C, alpha))
    got = float(taa.kernel_aa_cost(*(_t(a) for a in (K_, Z, C, alpha))))
    assert got == pytest.approx(want, rel=1e-10)
    resid = Z @ (alpha[:, None] * C) @ X - X
    assert got == pytest.approx(0.5 * np.sum(resid ** 2) / N, rel=1e-10)


@pytest.mark.parametrize("max_iterations", [1, 10000])
def test_dictionary_update_matches_jax(max_iterations):
    X = _data()
    Z, C, alpha = _state(2, delta=0.2)
    p = _parts(X, Z, C, alpha)
    kw = dict(max_iterations=max_iterations)
    want = np.asarray(jaa.update_kernel_aa_dictionary(
        p['K'], C, alpha, np.trace(p['K']), p['KZ'], p['ZtZ'], **kw))
    got = taa.update_kernel_aa_dictionary(
        _t(p['K']), _t(C), _t(alpha), None, _t(p['KZ']), _t(p['ZtZ']),
        **kw).numpy()
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=0, atol=1e-12)
    if max_iterations == 1:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
        return
    np.testing.assert_allclose(got @ X, want @ X, rtol=0, atol=1e-5)

    def objective(Cm):
        return 0.5 * np.sum((Z @ (alpha[:, None] * Cm) @ X - X) ** 2) / N

    # Both stop at a residual of 1e-6: the objective agrees to 1e-8.
    assert objective(got) == pytest.approx(objective(want), rel=1e-7)


@pytest.mark.parametrize("max_iterations", [3, 1000])
def test_weights_update_matches_jax(max_iterations):
    X = _data()
    Z, C, alpha = _state(3, delta=0.2)
    p = _parts(X, Z, C, alpha)
    kw = dict(max_iterations=max_iterations)
    want = np.asarray(jaa.update_kernel_aa_weights(
        Z, alpha, p['CK'], p['CKCt'], **kw))
    got = taa.update_kernel_aa_weights(
        _t(Z), _t(alpha), _t(p['CK']), _t(p['CKCt']), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-10 if max_iterations == 3 else 1e-8)
    D = alpha[:, None] * C

    def cost(W):
        resid = W @ D @ X - X
        return 0.5 * np.sum(resid ** 2) / N

    assert cost(got) == pytest.approx(cost(want), rel=1e-12)


@pytest.mark.parametrize("max_iterations", [2, 200])
def test_scale_factor_update_matches_jax(max_iterations):
    X = _data()
    Z, C, alpha = _state(4, delta=0.25)
    p = _parts(X, Z, C, alpha)
    kw = dict(max_iterations=max_iterations)
    want = np.asarray(jaa.update_kernel_aa_scale_factors(
        alpha, np.trace(p['K']), p['CKZ'], p['ZtZ'], p['CKCt'], 0.25,
        **kw))
    got = taa.update_kernel_aa_scale_factors(
        _t(alpha), None, _t(p['CKZ']), _t(p['ZtZ']), _t(p['CKCt']), 0.25,
        **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    assert got.min() >= 0.75 and got.max() <= 1.25


FIT = dict(tolerance=1e-7, max_iterations=80,
           stopping_criterion='rel_delta_f',
           dictionary_solver_kwargs={'max_iterations': 1},
           weights_solver_kwargs={'max_iterations': 100})


def _assert_fits_agree(port, jax_model, data_space):
    assert port.n_iter == jax_model.n_iter
    assert port.cost == pytest.approx(jax_model.cost, rel=1e-8)
    np.testing.assert_allclose(port.weights.numpy(),
                               np.asarray(jax_model.weights), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(port.dictionary.numpy(),
                               np.asarray(jax_model.dictionary), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(port.alpha.numpy(),
                               np.asarray(jax_model.alpha), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(port.cost_deltas, jax_model.cost_deltas,
                               rtol=0, atol=1e-8)
    if data_space:
        np.testing.assert_allclose(port.archetypes.numpy(),
                                   np.asarray(jax_model.archetypes),
                                   rtol=0, atol=1e-6)


def _fit_both(cls_name, delta, seed, fit=FIT):
    X = _data(seed)
    Z, C, alpha = _state(seed + 10, delta=delta)
    jmodel = getattr(jaa, cls_name)(K, delta=delta, init='custom', **fit)
    tmodel = getattr(taa, cls_name)(K, delta=delta, init='custom', **fit)
    data = X if cls_name == 'ArchetypalAnalysis' else X @ X.T
    state = dict(weights=Z, dictionary=C, alpha=alpha)
    jmodel.fit(data, **state)
    Zt, Ct, at = estimator_state_from_numpy(Z, C, alpha, 'cpu',
                                            torch.float64)
    tmodel.fit(torch.as_tensor(data), weights=Zt, dictionary=Ct, alpha=at)
    return tmodel, jmodel


@pytest.mark.parametrize("delta", [0.0, 0.2])
@pytest.mark.parametrize("cls_name", ["ArchetypalAnalysis", "KernelAA"])
def test_fit_with_row_solver_matches_jax(cls_name, delta):
    # The default weights backend: 'auto' resolves to the row solver in
    # a fit on both sides.
    tmodel, jmodel = _fit_both(cls_name, delta, seed=5)
    assert 5 < tmodel.n_iter < FIT['max_iterations']
    _assert_fits_agree(tmodel, jmodel, cls_name == 'ArchetypalAnalysis')


def _jax_batch_interpret(A, B, X0, backend='xla', mask=None, **kw):
    # The JAX weights QP on its Pallas kernels, in interpret mode with
    # small row blocks (rows are independent, so the block size does
    # not change the result).
    assert backend == 'pallas'
    kernel = (quad_simplex_qp_pallas_packed if B.shape[1] <= 64
              else quad_simplex_qp_pallas)
    return kernel(A, B, X0, mask=mask, interpret=True, block_rows=8,
                  **_pallas_qp_kwargs(kw))


@pytest.fixture
def jax_pallas_interpret():
    """Route the JAX estimators' weights QP to the Pallas kernels in
    interpret mode.  ``_kernel_aa_core`` is jitted, so JAX's caches are
    cleared on the way in and out: no program traced with another QP
    route is reused, and none traced here leaks out."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jaa, 'quad_simplex_spg_batch', _jax_batch_interpret)
        jax.clear_caches()
        yield
        jax.clear_caches()


@pytest.mark.parametrize("cls_name", ["ArchetypalAnalysis", "KernelAA"])
def test_fit_with_kernels_matches_jax(jax_pallas_interpret, cls_name):
    fit = dict(FIT, weights_solver_kwargs={'max_iterations': 100,
                                           'backend': 'pallas'})
    before = simplex_qp.PACKED_LAUNCHES
    tmodel, jmodel = _fit_both(cls_name, 0.0, seed=5, fit=fit)
    assert simplex_qp.PACKED_LAUNCHES == before  # CPU: the plain version
    assert 5 < tmodel.n_iter < FIT['max_iterations']
    _assert_fits_agree(tmodel, jmodel, cls_name == 'ArchetypalAnalysis')


def test_fit_with_kernels_above_64_components(jax_pallas_interpret):
    # k = 66 runs K4 (the unpacked kernel) on both sides.
    n, k = 80, 66
    X = np.random.RandomState(7).uniform(size=(n, 4))
    Z, C, _ = _state(8, n=n, k=k)
    fit = dict(FIT, max_iterations=3,
               weights_solver_kwargs={'max_iterations': 25,
                                      'backend': 'pallas'})
    jmodel = jaa.ArchetypalAnalysis(k, init='custom', **fit)
    jmodel.fit(X, weights=Z, dictionary=C)
    tmodel = taa.ArchetypalAnalysis(k, init='custom', **fit)
    tmodel.fit(torch.as_tensor(X), weights=_t(Z), dictionary=_t(C))
    assert tmodel.n_iter == jmodel.n_iter == 3
    assert tmodel.cost == pytest.approx(jmodel.cost, rel=1e-8)


def test_furthest_sum_initial_dictionary_matches_jax():
    X = _data(9)
    K_ = X @ X.T
    want = np.asarray(jaa.initialize_kernel_aa_dictionary(
        K_, 4, init='furthest_sum', start_index=11))
    got = taa.initialize_kernel_aa_dictionary(
        torch.as_tensor(K_), 4, init='furthest_sum', start_index=11)
    np.testing.assert_array_equal(got.numpy(), want)
    # A fit that draws its own start index picks one-hot rows too.
    model = taa.ArchetypalAnalysis(4, init='furthest_sum', random_state=0,
                                   **dict(FIT, max_iterations=5))
    model.fit(torch.as_tensor(X))
    assert model.n_iter >= 1 and np.isfinite(model.cost)


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_transform_matches_jax(backend):
    """Both transform against the same archetypes: the JAX fit's, loaded
    into the port.  Their random starting weights differ; the optimum of
    the convex QP does not."""
    X = _data(11)
    X_new = _data(12)
    Z, C, alpha = _state(13)
    jmodel = jaa.ArchetypalAnalysis(K, init='custom', **FIT)
    jmodel.fit(X, weights=Z, dictionary=C)
    _, want = jmodel.transform(X_new)

    weights_kw = dict(FIT['weights_solver_kwargs'], backend=backend)
    tmodel = taa.ArchetypalAnalysis(K, init='custom', random_state=0,
                                    **dict(FIT, max_iterations=1000,
                                           weights_solver_kwargs=weights_kw))
    load_fitted_estimator(tmodel, jmodel.weights, jmodel.dictionary,
                          jmodel.alpha, jmodel.archetypes)
    jmodel.max_iterations = 1000
    _, want = jmodel.transform(X_new)
    W, got = tmodel.transform(torch.as_tensor(X_new))
    assert got == pytest.approx(want, rel=1e-7)
    np.testing.assert_allclose(W.sum(dim=1).numpy(), 1.0, atol=1e-12)
    assert W.min() >= 0.0
    recon = tmodel.inverse_transform(W)
    resid = (recon - torch.as_tensor(X_new)).numpy()
    assert got == pytest.approx(0.5 * np.sum(resid ** 2) / N, rel=1e-12)


def _assert_same_table(got, want):
    """The same lines, except that a row's cost and delta columns agree
    to their printed precision or to 1e-10 (the fits agree to 1e-8 of
    the cost, which is what the small late deltas differ by) and its
    time column is a wall time."""
    got, want = got.splitlines(), want.splitlines()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w.count('|') != 3 or 'Cost' in w:
            assert g == w
            continue
        g_cols, w_cols = g.split('|'), w.split('|')
        assert g_cols[0] == w_cols[0]
        np.testing.assert_allclose(
            [float(c) for c in g_cols[1:3]],
            [float(c) for c in w_cols[1:3]], rtol=2e-6, atol=1e-10)


def test_verbose_table_matches_jax(capsys):
    # The state of test_fit_with_row_solver_matches_jax, whose fits
    # agree iteration for iteration.
    X = _data(5)
    Z, C, alpha = _state(15)
    K_ = X @ X.T
    kw = dict(FIT, delta=0, update_scale_factors=False, verbose=1, data=X)
    jaa.iterate_kernel_aa(K_, Z, C, alpha, **kw)
    want = capsys.readouterr().out
    kw['data'] = torch.as_tensor(X)
    out = taa.iterate_kernel_aa(torch.as_tensor(K_), _t(Z), _t(C),
                                _t(alpha), **kw)
    got = capsys.readouterr().out
    _assert_same_table(got, want)
    assert 10 < out[4] < FIT['max_iterations']  # several chunks; converged
    assert '*** Converged at iteration %d ***' % out[4] in got


def test_watchdog_raises_the_jax_message():
    """A cost that rises past the watchdog: the data handed in for the
    residual-form cost is not the data of the kernel, so the kernel-space
    updates raise the reported cost."""
    X = _data(16)
    K_ = _data(17) @ _data(17).T
    Z, C, alpha = _state(18)
    kw = dict(delta=0, tolerance=1e-6, max_iterations=20,
              dictionary_solver_kwargs={'max_iterations': 1},
              weights_solver_kwargs={'max_iterations': 25})
    with pytest.raises(RuntimeError) as want:
        jaa.iterate_kernel_aa(K_, Z, C, alpha, data=X, **kw)
    with pytest.raises(RuntimeError) as got:
        taa.iterate_kernel_aa(*(_t(a) for a in (K_, Z, C, alpha)),
                              data=_t(X), **kw)
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith('factorization cost increased after')
    # Without the watchdog the same fit runs to its end.
    taa.iterate_kernel_aa(*(_t(a) for a in (K_, Z, C, alpha)), data=_t(X),
                          require_monotonic_cost_decrease=False, **kw)


@pytest.mark.parametrize("bad", [
    dict(mesh='not a mesh'), dict(mesh='wrong axes'), dict(n_components=0),
    dict(max_iterations=0), dict(init='kmeans'),
    dict(stopping_criterion='delta_x'),
    dict(weights_solver_kwargs={'max_iteration': 5})])
def test_estimator_rejects_what_jax_rejects_or_is_not_ported(bad):
    """A ``mesh`` that is not a DeviceMesh, or lacks the mesh axes,
    raises a ``ValueError`` naming ``mesh``."""
    kw = dict(n_components=2, random_state=0)
    kw.update(bad)
    with bad_mesh(kw.pop('mesh', 'not a mesh')) as mesh:
        if 'mesh' in bad:
            kw['mesh'] = mesh
        with pytest.raises(ValueError,
                           match='mesh' if 'mesh' in bad else None):
            taa.ArchetypalAnalysis(**kw).fit(torch.as_tensor(_data()))


def test_estimator_random_state_forms():
    X = torch.as_tensor(_data(19))
    fit = functools.partial(taa.ArchetypalAnalysis, 2, init='random',
                            **dict(FIT, max_iterations=5))
    a = fit(random_state=3).fit(X).cost
    assert fit(random_state=torch.Generator().manual_seed(3)).fit(X).cost \
        == a
    assert np.isfinite(fit(random_state=None).fit(X).cost)
    assert np.isfinite(fit(random_state=np.random.RandomState(1))
                       .fit(X).cost)
    with pytest.raises(TypeError):
        fit(random_state="seed")
