"""The port's multi-restart GPNH fit against the JAX package's, float64.

Both start from the same restart states: the JAX package's own
``_init_gpnh_state`` makes them, and ``gpnh_states_from_numpy`` hands
them to the port.  ``quad_simplex_spg_batch_grouped`` in the JAX
restarts module is patched to run the Pallas kernel in interpret mode,
so both fits run the same grouped QP kernel (its plain version in the
port), under the JAX package's one-shot runner (which the port's
default ``compact_iterations=None`` stands for) and under convergence
compaction.

Tolerances: per-restart costs to rtol 1e-8, equal iteration counts and
winner, the winner's weights and dictionary to 1e-6.  The QP kernels
agree to about 1e-8 in x at convergence (tests/test_torch_simplex_qp.py)
and the k x k dictionary solves to rounding; the fit contracts the
differences.  The port's rounds of any length give every restart the
same trajectory, so they agree to rounding (1e-12).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convex_dim_red_tpu.ops.furthest_sum import (
    dissimilarities_from_kernel as j_diss)
from convex_dim_red_tpu.ops.pallas_qp import (
    quad_simplex_qp_pallas_packed_grouped)
from convex_dim_red_tpu.parallel import restarts as jrestarts
from convex_dim_red_tpu.solvers.spg import _pallas_qp_kwargs
from convex_dim_red_tpu_torch.models.gpnh_convex_coding import (
    gpnh_regularization)
from convex_dim_red_tpu_torch.ops import simplex_qp
from convex_dim_red_tpu_torch.parallel import restarts as trestarts
from convex_dim_red_tpu_torch.parallel import sharded_aa as tsharded
from convex_dim_red_tpu_torch.utils.interop import gpnh_states_from_numpy
from tests.torch_mesh_worlds import bad_mesh

# Small tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores.
torch.set_num_threads(1)

N, D, K, N_INIT = 64, 8, 3, 6
LAMBDA_W = 3e-5
FIT = dict(tolerance=1e-5, max_iterations=60,
           stopping_criterion='rel_delta_f')
WEIGHTS_KW = {'backend': 'pallas', 'max_iterations': 200}


def _data(seed=0):
    """A planted factorization plus a little noise."""
    rng = np.random.RandomState(seed)
    W = rng.uniform(size=(D, K))
    Z = rng.uniform(size=(N, K))
    Z /= Z.sum(axis=1, keepdims=True)
    return Z @ W.T + 0.02 * rng.standard_normal((N, D))


def _grouped_interpret(As, Bs, X0s, backend='xla', mask=None, **kw):
    # Small row blocks keep interpret mode quick; rows are solved
    # independently, so the block size does not change the result.
    assert backend == 'pallas'
    return quad_simplex_qp_pallas_packed_grouped(
        As, Bs, X0s, mask=mask, interpret=True, block_rows=8,
        **_pallas_qp_kwargs(kw))


_RUNNERS = ('_make_gpnh_grouped_run', '_make_gpnh_grouped_round_run')


@pytest.fixture(scope="module")
def jax_pallas_interpret():
    """Route the JAX restarts' weights QP to the Pallas kernel in
    interpret mode.  The runners are cached per configuration, so the
    caches are cleared on the way in and out: no runner traced with
    another QP route is reused, and none traced here leaks out."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrestarts, 'quad_simplex_spg_batch_grouped',
                   _grouped_interpret)
        for name in _RUNNERS:
            getattr(jrestarts, name).cache_clear()
        yield
        for name in _RUNNERS:
            getattr(jrestarts, name).cache_clear()


def _jax_init_states(key, X, init='random'):
    Xj = jnp.asarray(X)
    diss = j_diss(Xj @ Xj.T) if init == 'furthest_sum' else None
    one = functools.partial(jrestarts._init_gpnh_state, n_components=K,
                            init=init, n_extra_steps=10,
                            component_mask=None)
    keys = jax.random.split(key, N_INIT)
    return jax.vmap(one, in_axes=(0, None, None))(keys, Xj, diss)


@pytest.mark.parametrize("compact_iterations", [None, 16])
@pytest.mark.parametrize("init,max_iterations", [
    ('random', 60), ('random', 16), ('furthest_sum', 60)])
def test_fit_matches_jax(jax_pallas_interpret, monkeypatch,
                         compact_iterations, init, max_iterations):
    """The one-shot default (chunks of 4) and compaction (rounds of 16)
    through the public entry point, from JAX's own states.  At 60
    iterations restarts converge in several rounds, after a resume; at
    16 every restart stops at the cap."""
    X = _data()
    key = jax.random.PRNGKey(0)
    kw = dict(FIT, max_iterations=max_iterations, lambda_W=LAMBDA_W,
              init=init, weights_solver_kwargs=WEIGHTS_KW, restart_chunk=4,
              compact_iterations=compact_iterations)
    want = jrestarts.gpnh_fit_restarts(X, K, key, N_INIT, **kw)

    states = gpnh_states_from_numpy(*_jax_init_states(key, X, init),
                                    device='cpu', dtype=torch.float64)
    monkeypatch.setattr(trestarts, '_init_gpnh_state',
                        lambda *args, **kwargs: states)
    before = simplex_qp.LAUNCHES
    got = trestarts.gpnh_fit_restarts(torch.as_tensor(X), K, 0, N_INIT,
                                      **kw)
    assert simplex_qp.LAUNCHES == before  # CPU: the plain version
    costs, n_iters = got['costs'], got['n_iters']
    best = (got['weights'], got['dictionary'], got['cost_deltas'],
            got['cost'], got['n_iter'])

    np.testing.assert_allclose(costs, want['costs'], rtol=1e-8)
    np.testing.assert_array_equal(n_iters, want['n_iters'])
    if max_iterations == 16:
        assert np.all(n_iters == 16)
    else:
        assert 16 < n_iters.max() and n_iters.min() < 60
    assert int(np.argmin(costs)) == want['best_index']
    Z, W, trace, best_cost, best_n_iter = best
    np.testing.assert_allclose(Z.numpy(), np.asarray(want['weights']),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(W.numpy(), np.asarray(want['dictionary']),
                               rtol=0, atol=1e-6)
    assert best_n_iter == want['n_iter']
    assert best_cost == pytest.approx(want['cost'], rel=1e-8)
    np.testing.assert_allclose(trace[:best_n_iter], want['cost_deltas'],
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("lambda_W", [0.0, LAMBDA_W])
def test_grouped_iterate_matches_jax(jax_pallas_interpret, lambda_W):
    """One alternating iteration of every restart."""
    X = _data(1)
    Zs, Ws = _jax_init_states(jax.random.PRNGKey(1), X)
    iterate, cost0 = jrestarts._gpnh_grouped_iterate(
        jnp.asarray(X), lambda_W=jnp.asarray(lambda_W),
        weights_backend='pallas', weights_kwargs={'max_iterations': 25},
        n_components=K)
    want = [np.asarray(a) for a in iterate(Zs, Ws)]
    want0 = np.asarray(cost0(Zs, Ws))

    t_iterate, t_cost0 = tsharded._gpnh_iterate(
        torch.as_tensor(X), lambda_W=lambda_W, n_components=K,
        sh=tsharded._Shard(device='cpu'),
        weights_solver_kwargs={'backend': 'pallas', 'max_iterations': 25})
    states = gpnh_states_from_numpy(Zs, Ws, 'cpu', torch.float64)
    np.testing.assert_allclose(t_cost0(*states).numpy(), want0, rtol=1e-12)
    Z, W, costs = (t.numpy() for t in t_iterate(*states))
    # The dictionary is solved before the weights QP: rounding only.
    np.testing.assert_allclose(W, want[1], rtol=0, atol=1e-10)
    # 25 QP iterations from a random start: x within the solver's own
    # resolution; the cost it gives is what the fit uses.
    np.testing.assert_allclose(Z, want[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(costs, want[2], rtol=1e-9)


@pytest.mark.parametrize("restart_chunk", [None, 4])
def test_one_shot_and_compaction_agree(restart_chunk):
    """The default (rounds of 32) and rounds of 7 from the same seed,
    through the public entry point, on the row solver: the same
    trajectory for every restart."""
    X = torch.as_tensor(_data(2))
    kw = dict(FIT, lambda_W=LAMBDA_W, restart_chunk=restart_chunk,
              weights_solver_kwargs={'backend': 'xla'})
    one = trestarts.gpnh_fit_restarts(X, K, 2, N_INIT, **kw)
    comp = trestarts.gpnh_fit_restarts(X, K, 2, N_INIT, compact_iterations=7,
                                       **kw)
    np.testing.assert_allclose(one['costs'], comp['costs'], rtol=1e-12)
    np.testing.assert_array_equal(one['n_iters'], comp['n_iters'])
    assert 7 < one['n_iters'].max() and one['n_iters'].min() < 60
    np.testing.assert_allclose(one['weights'].numpy(),
                               comp['weights'].numpy(), atol=1e-12)
    assert one['n_iter'] == comp['n_iter']
    np.testing.assert_allclose(one['cost_deltas'], comp['cost_deltas'],
                               atol=1e-12)


def test_public_fit_contract():
    X = torch.as_tensor(_data(3))
    gen = torch.Generator().manual_seed(7)
    kw = dict(lambda_W=LAMBDA_W, weights_solver_kwargs=WEIGHTS_KW, **FIT)
    res = trestarts.gpnh_fit_restarts(X, K, gen, 5, restart_chunk=2, **kw)
    Z, W = res['weights'], res['dictionary']
    assert Z.shape == (N, K) and W.shape == (D, K)
    assert Z.min().item() >= 0.0
    np.testing.assert_allclose(Z.sum(dim=1).numpy(), 1.0, atol=1e-12)
    resid = X - Z @ W.T
    cost = (0.5 * torch.sum(resid * resid).item() / N
            + LAMBDA_W * float(gpnh_regularization(W)))
    assert res['cost'] == pytest.approx(cost, rel=1e-10)
    assert res['costs'].shape == (5,) and res['n_iters'].shape == (5,)
    assert res['best_index'] == int(np.argmin(res['costs']))
    assert res['cost'] == res['costs'].min()
    assert np.all(res['n_iters'] <= FIT['max_iterations'])
    assert res['cost_deltas'].shape == (res['n_iter'],)
    assert np.all(res['cost_deltas'] <= 1e-12)

    # A seed in place of a generator, the same seed twice and the
    # compacted scheduler: the same fit.
    again = trestarts.gpnh_fit_restarts(X, K, 7, 5, **kw)
    np.testing.assert_array_equal(again['costs'], res['costs'])
    compact = trestarts.gpnh_fit_restarts(X, K, 7, 5, compact_iterations=9,
                                          restart_chunk=3, **kw)
    np.testing.assert_allclose(compact['costs'], res['costs'], rtol=1e-12)
    np.testing.assert_array_equal(compact['n_iters'], res['n_iters'])


def test_furthest_sum_init_starts_from_data_rows():
    X = torch.as_tensor(_data(4))
    diss = trestarts.dissimilarities_from_kernel(X @ X.T)
    Zs, Ws = trestarts._init_gpnh_state(
        torch.Generator().manual_seed(0), X, diss, 4, n_components=K,
        init='furthest_sum', n_extra_steps=10)
    assert Zs.shape == (4, N, K) and Ws.shape == (4, D, K)
    np.testing.assert_allclose(Zs.sum(dim=2).numpy(), 1.0, atol=1e-12)
    for W in Ws:
        for column in W.T:
            assert bool((X == column).all(dim=1).any())
    res = trestarts.gpnh_fit_restarts(X, K, 0, 3, init='furthest_sum',
                                      **dict(FIT, max_iterations=10))
    assert np.all(np.isfinite(res['costs']))


def test_random_init_has_the_jax_scale():
    X = torch.as_tensor(_data(5)) * 3.0
    Zs, Ws = trestarts._init_gpnh_state(
        torch.Generator().manual_seed(1), X, None, 200, n_components=2,
        init='random', n_extra_steps=10)
    np.testing.assert_allclose(Zs.sum(dim=2).numpy(), 1.0, atol=1e-12)
    # avg * N(0, 1) with avg = sqrt(mean|X| / k).
    avg = float(torch.sqrt(torch.mean(torch.abs(X)) / 2))
    assert float(Ws.std()) == pytest.approx(avg, rel=0.05)


@pytest.mark.parametrize("bad", [
    dict(mesh='not a mesh'), dict(mesh='wrong axes'),
    dict(screen_iterations=10, compact_iterations=20),
    dict(pad_components_to='eight'), dict(grouped=False),
    dict(init='custom'), dict(stopping_criterion='delta_x'),
    dict(n_init=0), dict(weights_solver_kwargs={'max_iteration': 5})])
def test_rejects_what_is_not_ported(bad):
    # Screening and padding are ported: screen_iterations raises only
    # beside an integer compact_iterations (two schedulers), and
    # pad_components_to only when it is not a count.
    # A mesh that is not a DeviceMesh, or lacks the restart axis, raises
    # naming mesh.
    kw = dict(n_init=2)
    kw.update(bad)
    with bad_mesh(kw.pop('mesh', 'not a mesh')) as mesh:
        if 'mesh' in bad:
            kw['mesh'] = mesh
        with pytest.raises(ValueError,
                           match='mesh' if 'mesh' in bad else None):
            trestarts.gpnh_fit_restarts(torch.as_tensor(_data()), K, 0,
                                        **kw)
