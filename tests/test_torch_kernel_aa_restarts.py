"""The port's ``kernel_aa_fit_restarts`` against the JAX package's,
float64.

Both fit a kernel matrix ``K = X X'`` with the trace-form cost, from the
same restart states (the JAX package's ``_init_aa_state``, patched into
the port's entry point), with the JAX restarts' weights QP on the Pallas
kernel in interpret mode (the port: its plain version): compaction,
screening and a padded fit under each, held to per-restart costs at
rtol 1e-8 with equal iteration counts and winner, as the data-matrix
fits are (tests/test_torch_restarts.py).  The result has no
``archetypes``, and its ``dictionary`` is ``C``, not ``diag(alpha) C``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convex_dim_red_tpu.ops.pallas_qp import (
    quad_simplex_qp_pallas_packed_grouped)
from convex_dim_red_tpu.parallel import restarts as jrestarts
from convex_dim_red_tpu.solvers.spg import _pallas_qp_kwargs
from convex_dim_red_tpu_torch import kernel_aa_fit_restarts
from convex_dim_red_tpu_torch.parallel import restarts as trestarts
from convex_dim_red_tpu_torch.utils.interop import states_from_numpy

torch.set_num_threads(1)

N, D, K, K_PAD, N_INIT = 64, 6, 3, 8, 6
FIT = dict(init='random', tolerance=1e-6, max_iterations=40,
           stopping_criterion='rel_delta_f',
           dictionary_solver_kwargs={'max_iterations': 1},
           weights_solver_kwargs={'backend': 'pallas', 'max_iterations': 25},
           restart_chunk=4)
SCHEDULERS = {'compacted': dict(compact_iterations=20),
              'screened': dict(screen_iterations=24, screen_keep=0.5)}


def _kernel(seed=0):
    rng = np.random.RandomState(seed)
    basis = rng.uniform(size=(K, D))
    Z = rng.uniform(size=(N, K))
    Z /= Z.sum(axis=1, keepdims=True)
    for comp, i in enumerate(rng.choice(N, size=K, replace=False)):
        Z[i] = 0.0
        Z[i, comp] = 1.0
    X = Z @ basis + 0.01 * rng.standard_normal((N, D))
    return X @ X.T


def _grouped_interpret(As, Bs, X0s, backend='xla', mask=None, **kw):
    assert backend == 'pallas'
    return quad_simplex_qp_pallas_packed_grouped(
        As, Bs, X0s, mask=mask, interpret=True, block_rows=8,
        **_pallas_qp_kwargs(kw))


_RUNNERS = ('_make_aa_grouped_round_run', '_make_aa_grouped_run',
            '_make_aa_grouped_screen_run', '_make_aa_grouped_resume_run')


@pytest.fixture(scope="module")
def jax_pallas_interpret():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrestarts, 'quad_simplex_spg_batch_grouped',
                   _grouped_interpret)
        for name in _RUNNERS:
            getattr(jrestarts, name).cache_clear()
        yield
        for name in _RUNNERS:
            getattr(jrestarts, name).cache_clear()


def _jax_states(key, delta, padded):
    k = K_PAD if padded else K
    init = functools.partial(
        jrestarts._init_aa_state, n_samples=N, n_components=k,
        init='random', diss=None, n_extra_steps=10,
        component_mask=jnp.arange(K_PAD) < K if padded else None,
        do_scale=delta != 0.0, dtype=jnp.float64)
    return jax.vmap(init, in_axes=(0, None))(jax.random.split(key, N_INIT),
                                             jnp.asarray(delta))


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("scheduler", sorted(SCHEDULERS))
def test_kernel_fit_matches_jax(jax_pallas_interpret, monkeypatch,
                                scheduler, padded):
    Kmat = _kernel()
    key = jax.random.PRNGKey(0)
    kw = dict(FIT, **SCHEDULERS[scheduler])
    if padded:
        kw['pad_components_to'] = K_PAD
    want = jrestarts.kernel_aa_fit_restarts(Kmat, K, key, N_INIT,
                                            grouped=True, **kw)
    states = states_from_numpy(*_jax_states(key, 0.0, padded),
                               device='cpu', dtype=torch.float64)
    monkeypatch.setattr(trestarts, '_init_aa_state',
                        lambda *args, **kwargs: states)
    got = kernel_aa_fit_restarts(torch.as_tensor(Kmat), K, 0, N_INIT, **kw)

    np.testing.assert_allclose(got['costs'], want['costs'], rtol=1e-8)
    np.testing.assert_array_equal(got['n_iters'], want['n_iters'])
    assert got['best_index'] == want['best_index']
    assert got['n_iter'] == want['n_iter']
    assert got['cost'] == pytest.approx(want['cost'], rel=1e-8)
    np.testing.assert_allclose(got['cost_deltas'], want['cost_deltas'],
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(got['weights'].numpy(),
                               np.asarray(want['weights']), atol=1e-6)
    np.testing.assert_allclose(got['dictionary'].numpy(),
                               np.asarray(want['dictionary']), atol=1e-6)
    assert got['weights'].shape == (N, K) and got['dictionary'].shape == (K, N)
    assert 'archetypes' not in got
    assert set(got) == set(want)
    if scheduler == 'screened':
        assert got['screen']['n_kept'] == want['screen']['n_kept']
        assert got['screen']['screen_cut'] == pytest.approx(
            want['screen']['screen_cut'], rel=1e-8)


def test_dictionary_is_c_with_scale_factors():
    """With scale factors the dictionary is ``C`` itself (rows on the
    simplex) and ``alpha`` stays apart, as in the JAX package; the
    trace-form cost of the winner is its cost."""
    Kmat = torch.as_tensor(_kernel(1))
    res = kernel_aa_fit_restarts(Kmat, K, 0, 4, delta=0.3,
                                 **dict(FIT, compact_iterations=20))
    C, Z, alpha = res['dictionary'], res['weights'], res['alpha']
    np.testing.assert_allclose(C.sum(dim=1).numpy(), 1.0, atol=1e-12)
    assert float(C.min()) >= 0.0
    assert 0.7 <= float(alpha.min()) and float(alpha.max()) <= 1.3
    assert not torch.allclose(alpha, torch.ones_like(alpha))
    # 0.5 tr((I - Z D C) K (I - Z D C)') / n with D = diag(alpha).
    M = torch.eye(N, dtype=Kmat.dtype) - Z @ (alpha[:, None] * C)
    cost = 0.5 * torch.trace(M @ Kmat @ M.T).item() / N
    assert res['cost'] == pytest.approx(cost, rel=1e-10)
    assert 'archetypes' not in res


def test_kernel_fit_equals_the_data_fit_winner_cost():
    """On ``K = X X'`` the kernel fit and the data fit, from the same
    seed, reach the same costs (trace form against residual form)."""
    rng = np.random.RandomState(3)
    X = torch.as_tensor(rng.standard_normal((40, 5)))
    kw = dict(FIT, compact_iterations=20, max_iterations=30)
    data_fit = trestarts.aa_fit_restarts(X, K, 5, 4, **kw)
    kernel_fit = kernel_aa_fit_restarts(X @ X.T, K, 5, 4, **kw)
    np.testing.assert_allclose(kernel_fit['costs'], data_fit['costs'],
                               rtol=1e-8)
    np.testing.assert_array_equal(kernel_fit['n_iters'],
                                  data_fit['n_iters'])


def test_rejects_a_non_square_kernel():
    with pytest.raises(ValueError, match="square"):
        kernel_aa_fit_restarts(torch.zeros((4, 5), dtype=torch.float64),
                               2, 0, 2)
