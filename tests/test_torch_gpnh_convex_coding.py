"""The port's GPNH convex coding against the JAX package's, float64: the
penalty and its masked form, the Grams, the cost, both updates (a
rank-deficient dictionary solve included), the single-fit loop through
the estimator with both weights backends, ``transform``, the verbose
table, the watchdog and the argument checks.

The two packages draw different random numbers, so every fit starts
from one ``init='custom'`` state made with numpy (or, for FurthestSum,
from a fixed ``start_index``).

Tolerances.  The penalty, Grams and cost are the same arithmetic summed
in another order: 1e-12.  The dictionary solve is an SVD of a k x k
matrix on both sides: 1e-10, the rank-deficient cases included (a dead
component's column and a duplicated one fall below the same cutoff).
A weights update solves each row to the QP solver's own resolution
(tests/test_torch_row_solver.py): x to 1e-8, its cost to 1e-12.  Whole
fits carry that into costs within 1e-8 with equal iteration counts, and
Z and W within 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convex_dim_red_tpu.models import gpnh_convex_coding as jg
from convex_dim_red_tpu.ops.pallas_qp import quad_simplex_qp_pallas_packed
from convex_dim_red_tpu.solvers.spg import _pallas_qp_kwargs
from convex_dim_red_tpu_torch.models import gpnh_convex_coding as tg
from convex_dim_red_tpu_torch.ops import simplex_qp
from convex_dim_red_tpu_torch.utils.interop import (
    gpnh_estimator_state_from_numpy, load_fitted_gpnh)
from tests.torch_mesh_worlds import bad_mesh

# Small tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores.
torch.set_num_threads(1)

N, D, K = 64, 8, 3


def _stochastic(rng, shape):
    m = rng.uniform(size=shape)
    return m / m.sum(axis=1, keepdims=True)


def _data(seed=0, n=N, d=D, k=K):
    """A planted factorization plus a little noise."""
    rng = np.random.RandomState(seed)
    W = rng.uniform(size=(d, k))
    Z = _stochastic(rng, (n, k))
    return Z @ W.T + 0.02 * rng.standard_normal((n, d))


def _state(seed, n=N, d=D, k=K):
    rng = np.random.RandomState(seed)
    return _stochastic(rng, (n, k)), rng.standard_normal((d, k))


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("k", [1, 2, 4])
def test_penalty_grams_and_cost_match_jax(k):
    rng = np.random.RandomState(k)
    X = rng.standard_normal((N, D))
    Z, W = _state(k + 1, k=k)
    for got, want in (
            (tg.gpnh_regularization(_t(W)), jg.gpnh_regularization(W)),
            (tg._gpnh_gram(D, k, torch.float64),
             jg._gpnh_gram(D, k, jnp.float64)),
            (tg.gpnh_cost(_t(X), _t(Z), _t(W), lambda_W=0.3),
             jg.gpnh_cost(X, Z, W, lambda_W=0.3)),
            (tg.gpnh_cost(_t(X), _t(Z), _t(W)), jg.gpnh_cost(X, Z, W))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-15)
    # The batched penalty is the penalty of each member.
    Ws = np.stack([W, 2 * W, -W])
    np.testing.assert_allclose(
        tg.gpnh_regularization(_t(Ws)).numpy(),
        [float(jg.gpnh_regularization(w)) for w in Ws], rtol=1e-12)


@pytest.mark.parametrize("k,k_pad", [(1, 4), (2, 4), (3, 8)])
def test_masked_penalty_and_gram_match_jax(k, k_pad):
    rng = np.random.RandomState(k_pad + k)
    W = rng.standard_normal((D, k_pad))  # garbage in the padded columns
    mask = np.arange(k_pad) < k
    np.testing.assert_allclose(
        tg.gpnh_regularization_masked(_t(W), mask).numpy(),
        np.asarray(jg.gpnh_regularization_masked(W, jnp.asarray(mask))),
        rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(
        tg._gpnh_gram_masked(D, mask, torch.float64).numpy(),
        np.asarray(jg._gpnh_gram_masked(D, jnp.asarray(mask),
                                        jnp.float64)),
        rtol=1e-12, atol=1e-15)


def _dictionary_both(X, Z, lambda_W):
    GW = np.asarray(jg._gpnh_gram(D, Z.shape[1], jnp.float64))
    want = np.asarray(jg.update_gpnh_dictionary(X, Z, Z.T @ Z, GW,
                                                lambda_W=lambda_W))
    got = tg.update_gpnh_dictionary(_t(X), _t(Z), _t(Z.T @ Z), _t(GW),
                                    lambda_W=lambda_W).numpy()
    return got, want


@pytest.mark.parametrize("lambda_W", [0.0, 1e-3, 0.5])
@pytest.mark.parametrize("case", ["full", "dead", "duplicate"])
def test_dictionary_update_matches_jax(case, lambda_W):
    """``dead``: a component whose weights died out (a zero column of Z);
    ``duplicate``: two equal columns.  At lambda_W = 0 both make Z'Z
    singular, and the SVD solve returns the minimum-norm dictionary."""
    X = _data(1)
    Z, _ = _state(2, k=4)
    if case == "dead":
        Z[:, 2] = 0.0
    elif case == "duplicate":
        Z[:, 3] = Z[:, 1]
    Z /= Z.sum(axis=1, keepdims=True)
    got, want = _dictionary_both(X, Z, lambda_W)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    if lambda_W == 0.0 and case == "dead":
        assert np.abs(got[:, 2]).max() < 1e-12
    if lambda_W == 0.0 and case == "duplicate":
        np.testing.assert_allclose(got[:, 3], got[:, 1], atol=1e-10)
    # The solution minimizes the cost over W: a step away raises it.
    cost = float(jg.gpnh_cost(X, Z, got, lambda_W))
    assert cost < float(jg.gpnh_cost(X, Z, got + 1e-4, lambda_W))


def test_lstsq_matches_jax_in_a_batch():
    rng = np.random.RandomState(3)
    a = rng.standard_normal((5, 4, 4))
    a[1, :, 3] = a[1, :, 0]           # rank 3
    a[2] = 0.0                        # rank 0
    b = rng.standard_normal((5, 4, 6))
    want = np.stack([np.asarray(jnp.linalg.lstsq(ai, bi)[0])
                     for ai, bi in zip(a, b)])
    got = tg._lstsq(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    assert np.all(got[2] == 0.0)


_JAX_BATCH = jg.quad_simplex_spg_batch


def _jax_batch_interpret(A, B, X0, backend='xla', mask=None, **kw):
    # The JAX weights QP on its Pallas kernel, in interpret mode with
    # small row blocks (rows are independent, so the block size does
    # not change the result); the row solver as it is.
    if backend != 'pallas':
        return _JAX_BATCH(A, B, X0, backend=backend, mask=mask, **kw)
    return quad_simplex_qp_pallas_packed(A, B, X0, mask=mask, interpret=True,
                                         block_rows=8,
                                         **_pallas_qp_kwargs(kw))


@pytest.fixture
def jax_pallas_interpret():
    """Route the JAX GPNH weights QP to the Pallas kernel in interpret
    mode.  ``_gpnh_core`` is jitted, so JAX's caches are cleared on the
    way in and out: no program traced with another QP route is reused,
    and none traced here leaks out."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jg, 'quad_simplex_spg_batch', _jax_batch_interpret)
        jax.clear_caches()
        yield
        jax.clear_caches()


@pytest.mark.parametrize("max_iterations", [3, 1000])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_weights_update_matches_jax(jax_pallas_interpret, backend,
                                    max_iterations):
    X = _data(4)
    Z, W = _state(5)
    kw = dict(backend=backend, max_iterations=max_iterations)
    want = np.asarray(jg.update_gpnh_weights(X, Z, W, **kw))
    got = tg.update_gpnh_weights(_t(X), _t(Z), _t(W), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-10 if max_iterations == 3 else 1e-8)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-12)
    assert float(jg.gpnh_cost(X, got, W)) == pytest.approx(
        float(jg.gpnh_cost(X, want, W)), rel=1e-12)


FIT = dict(lambda_W=3e-5, tolerance=1e-6, max_iterations=200,
           stopping_criterion='rel_delta_f',
           weights_solver_kwargs={'max_iterations': 100})


def _fit_both(seed, fit=FIT):
    X = _data(seed)
    Z, W = _state(seed + 10)
    jmodel = jg.GPNHConvexCoding(K, init='custom', **fit)
    jmodel.fit(X, weights=Z, dictionary=W)
    tmodel = tg.GPNHConvexCoding(K, init='custom', **fit)
    Zt, Wt = gpnh_estimator_state_from_numpy(Z, W, 'cpu', torch.float64)
    tmodel.fit(torch.as_tensor(X), weights=Zt, dictionary=Wt)
    return tmodel, jmodel


def _assert_fits_agree(port, jax_model):
    assert port.n_iter == jax_model.n_iter
    assert port.cost == pytest.approx(jax_model.cost, rel=1e-8)
    for name in ('weights', 'dictionary'):
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(getattr(jax_model, name)),
                                   rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.cost_deltas, jax_model.cost_deltas,
                               rtol=0, atol=1e-8)


@pytest.mark.parametrize("lambda_W", [0.0, 3e-5])
def test_fit_with_row_solver_matches_jax(lambda_W):
    # The default weights backend: 'auto' resolves to the row solver in
    # a fit on both sides.
    tmodel, jmodel = _fit_both(6, dict(FIT, lambda_W=lambda_W))
    assert 5 < tmodel.n_iter < FIT['max_iterations']
    _assert_fits_agree(tmodel, jmodel)


def test_fit_with_kernel_matches_jax(jax_pallas_interpret):
    fit = dict(FIT, weights_solver_kwargs={'max_iterations': 100,
                                           'backend': 'pallas'})
    before = simplex_qp.PACKED_LAUNCHES
    tmodel, jmodel = _fit_both(6, fit)
    assert simplex_qp.PACKED_LAUNCHES == before  # CPU: the plain version
    assert 5 < tmodel.n_iter < FIT['max_iterations']
    _assert_fits_agree(tmodel, jmodel)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_masked_weights_update_matches_jax(jax_pallas_interpret, backend):
    """``update_gpnh_weights`` with a component mask: two padded columns
    of the weights stay exactly zero, and the rest follow JAX's."""
    X = _data(7)
    Z, W = _state(8, k=5)
    mask = np.arange(5) < 3
    Z[:, ~mask] = 0.0
    Z /= Z.sum(axis=1, keepdims=True)
    kw = dict(backend=backend, max_iterations=1000)
    want = np.asarray(jg.update_gpnh_weights(X, Z, W, jnp.asarray(mask),
                                             **kw))
    got = tg.update_gpnh_weights(_t(X), _t(Z), _t(W), mask, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)
    assert np.all(got[:, ~mask] == 0.0)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-12)


def test_furthest_sum_initial_dictionary_matches_jax():
    X = _data(9)
    want = np.asarray(jg.initialize_gpnh_dictionary(
        X, 3, init='furthest_sum', start_index=11))
    got = tg.initialize_gpnh_dictionary(torch.as_tensor(X), 3,
                                        init='furthest_sum', start_index=11)
    np.testing.assert_array_equal(got.numpy(), want)
    # A fit that draws its own start index starts from data rows too.
    model = tg.GPNHConvexCoding(3, init='furthest_sum', random_state=0,
                                **dict(FIT, max_iterations=5))
    model.fit(torch.as_tensor(X))
    assert model.n_iter >= 1 and np.isfinite(model.cost)


def test_random_initial_dictionary_has_the_jax_scale():
    X = torch.as_tensor(_data(10)) * 5.0
    gen = torch.Generator().manual_seed(0)
    W = tg.initialize_gpnh_dictionary(X, 2, generator=gen)
    assert W.shape == (D, 2)
    # avg * N(0, 1), avg = sqrt(mean|X| / k): both draws, undone.
    avg = float(torch.sqrt(torch.mean(torch.abs(X)) / 2))
    again = torch.randn((D, 2), generator=torch.Generator().manual_seed(0),
                        dtype=X.dtype)
    np.testing.assert_allclose(W.numpy(), avg * again.numpy(), rtol=1e-15)


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_transform_matches_jax(jax_pallas_interpret, backend):
    """Both transform against the same dictionary, the JAX fit's loaded
    into the port: a weights-only fit to convergence.  Their random
    starting weights differ; the optimum of the convex problem does
    not."""
    X, X_new = _data(11), _data(12)
    Z, W = _state(13)
    jmodel = jg.GPNHConvexCoding(K, init='custom', **FIT)
    jmodel.fit(X, weights=Z, dictionary=W)
    # The JAX estimator's transform after a custom fit raises (see
    # test_transform_after_a_custom_fit): transform as a random-init one.
    jmodel.init = None
    jmodel.tolerance = 1e-10
    _, want = jmodel.transform(X_new)

    weights_kw = dict(FIT['weights_solver_kwargs'], backend=backend)
    tmodel = tg.GPNHConvexCoding(
        K, random_state=0, **dict(FIT, tolerance=1e-10,
                                  weights_solver_kwargs=weights_kw))
    load_fitted_gpnh(tmodel, jmodel.weights, jmodel.dictionary)
    W_new, got = tmodel.transform(torch.as_tensor(X_new))
    assert got == pytest.approx(want, rel=1e-7)
    np.testing.assert_allclose(W_new.sum(dim=1).numpy(), 1.0, atol=1e-12)
    assert W_new.min() >= 0.0
    # transform keeps the dictionary; inverse_transform maps back.
    np.testing.assert_array_equal(tmodel.dictionary.numpy(),
                                  np.asarray(jmodel.dictionary))
    want_cost = float(jg.gpnh_cost(X_new, W_new.numpy(), jmodel.dictionary,
                                   FIT['lambda_W']))
    assert got == pytest.approx(want_cost, rel=1e-12)
    recon = tmodel.inverse_transform(W_new).numpy()
    np.testing.assert_allclose(recon, W_new.numpy() @ np.asarray(
        jmodel.dictionary).T, rtol=0, atol=1e-14)


def test_transform_after_a_custom_fit():
    """After an ``init='custom'`` fit both estimators' transform asks
    for initial weights of the new data and raises the same error; the
    fitted factors stay as they were."""
    X, X_new = _data(21), _data(22)
    Z, W = _state(23)
    jmodel = jg.GPNHConvexCoding(K, init='custom', **FIT)
    jmodel.fit(X, weights=Z, dictionary=W)
    with pytest.raises(ValueError, match='_gpnh_convex_coding') as jerr:
        jmodel.transform(X_new)
    tmodel = tg.GPNHConvexCoding(K, init='custom', random_state=0, **FIT)
    tmodel.fit(_t(X), weights=_t(Z), dictionary=_t(W))
    fitted = (tmodel.weights, tmodel.dictionary)
    with pytest.raises(ValueError, match='_gpnh_convex_coding') as terr:
        tmodel.transform(_t(X_new))
    assert str(terr.value) == str(jerr.value)
    assert tmodel.weights is fitted[0] and tmodel.dictionary is fitted[1]


def test_fit_transform_returns_the_fitted_weights():
    X = torch.as_tensor(_data(14))
    model = tg.GPNHConvexCoding(K, init='random', random_state=3,
                                **dict(FIT, max_iterations=30))
    W = model.fit_transform(X)
    assert W is model.weights and W.shape == (N, K)
    assert model.dictionary.shape == (D, K)
    assert model.cost == pytest.approx(float(tg.gpnh_cost(
        X, model.weights, model.dictionary, FIT['lambda_W'])), rel=1e-12)
    assert model.cost_deltas.shape == (model.n_iter,)
    assert model.avg_time_per_iter > 0
    # The same seed, the same fit; a generator seeded alike, too.
    again = tg.GPNHConvexCoding(
        K, init='random', random_state=torch.Generator().manual_seed(3),
        **dict(FIT, max_iterations=30)).fit(X)
    assert again.cost == model.cost


def _assert_same_table(got, want):
    """The same lines, except that a row's cost and delta columns agree
    to their printed precision (or 1e-10) and its time column is a wall
    time."""
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


@pytest.mark.parametrize("max_iterations", [80, 0])
def test_verbose_table_matches_jax(capsys, max_iterations):
    X = _data(6)
    Z, W = _state(16)
    kw = dict(FIT, max_iterations=max_iterations, verbose=1)
    jg.iterate_gpnh_convex_coding(X, Z, W, **kw)
    want = capsys.readouterr().out
    out = tg.iterate_gpnh_convex_coding(_t(X), _t(Z), _t(W), **kw)
    got = capsys.readouterr().out
    _assert_same_table(got, want)
    quiet = tg.iterate_gpnh_convex_coding(_t(X), _t(Z), _t(W),
                                          **dict(kw, verbose=0))
    assert out[3] == quiet[3]
    assert float(out[2]) == pytest.approx(float(quiet[2]), rel=1e-12)
    if max_iterations:
        assert 10 < out[3] < max_iterations  # several chunks; converged
        assert '*** Converged at iteration %d ***' % out[3] in got
    else:
        assert out[3] == 0 and len(out[5]) == 0


def test_watchdog_raises_the_jax_message():
    """Weights that sum to one but leave the simplex reproduce the data
    exactly; the weights update projects them onto it and the cost
    rises past the watchdog."""
    rng = np.random.RandomState(17)
    W = rng.standard_normal((D, K))
    Z = np.array([[2.0, -0.5, -0.5], [-1.0, 1.5, 0.5]] * (N // 2))
    X = Z @ W.T
    kw = dict(lambda_W=0.0, tolerance=1e-6, max_iterations=20,
              weights_solver_kwargs={'max_iterations': 25})
    with pytest.raises(RuntimeError) as want:
        jg.iterate_gpnh_convex_coding(X, Z, W, **kw)
    with pytest.raises(RuntimeError) as got:
        tg.iterate_gpnh_convex_coding(_t(X), _t(Z), _t(W), **kw)
    assert str(got.value) == str(want.value)
    assert str(got.value) == ('factorization cost increased after weights '
                              'update')
    # Without the watchdog the same fit runs to its end.
    out = tg.iterate_gpnh_convex_coding(
        _t(X), _t(Z), _t(W), require_monotonic_cost_decrease=False, **kw)
    assert out[3] >= 1


@pytest.mark.parametrize("bad", [
    dict(mesh='not a mesh'), dict(mesh='wrong axes'), dict(n_components=0),
    dict(max_iterations=0), dict(tolerance=-1.0), dict(init='kmeans'),
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
            tg.GPNHConvexCoding(**kw).fit(torch.as_tensor(_data()))


@pytest.mark.parametrize("bad", ["weights_shape", "weights_sums",
                                 "dictionary_shape"])
def test_custom_init_is_validated(bad):
    X = _data(18)
    Z, W = _state(19)
    if bad == "weights_shape":
        Z = Z[:-1]
    elif bad == "weights_sums":
        Z = 2 * Z
    else:
        W = W[:-1]
    model = tg.GPNHConvexCoding(K, init='custom', **FIT)
    with pytest.raises(ValueError, match='_gpnh_convex_coding'):
        model.fit(torch.as_tensor(X), weights=_t(Z), dictionary=_t(W))
    with pytest.raises(ValueError):
        jg.GPNHConvexCoding(K, init='custom', **FIT).fit(
            X, weights=Z, dictionary=W)


def test_estimator_random_state_forms():
    X = torch.as_tensor(_data(20))
    fit = functools.partial(tg.GPNHConvexCoding, 2, init='random',
                            **dict(FIT, max_iterations=5))
    assert np.isfinite(fit(random_state=None).fit(X).cost)
    assert np.isfinite(fit(random_state=np.random.RandomState(1))
                       .fit(X).cost)
    with pytest.raises(TypeError):
        fit(random_state="seed")
