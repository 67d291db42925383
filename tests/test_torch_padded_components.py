"""Padded-k fits of the port against the JAX package's, float64.

A padded fit (``pad_components_to``) runs every restart at the padded
component count with a mask that pins the padded weights to zero.  Two
contracts (tests/test_padded_components.py and tests/test_gpnh_padded.py
in the JAX package):

- from the same padded restart states (the JAX package's
  ``_init_*_state`` with its mask), the port's compacted and screened
  padded fits give the JAX package's grouped ones: per-restart costs to
  rtol 1e-8, equal iteration counts and winner;
- from an unpadded fit's states embedded at the padded width (padded
  weights and GPNH dictionary columns 0, padded AA dictionary rows any
  stochastic rows), a padded fit gives the unpadded fit's costs to
  1e-10 with equal iteration counts, and its padded columns stay
  exactly 0.  These run the weights QP on the row solver, as the JAX
  package's tests do: the QP kernels' plain version sums a row's
  coordinates in another order at k = 3 than at 8 (zeros included), and
  a row on a stopping threshold then stops an iteration apart, which
  moves a cost by 1e-11 (6e-10 of it).

The JAX restarts' weights QP runs the Pallas kernel in interpret mode
(the port: its plain version), as in tests/test_torch_restarts.py.
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
from convex_dim_red_tpu_torch.parallel import restarts as trestarts
from convex_dim_red_tpu_torch.parallel import sharded_aa as tsharded
from convex_dim_red_tpu_torch.utils.interop import (gpnh_states_from_numpy,
                                                    states_from_numpy)

torch.set_num_threads(1)

N, D, K, K_PAD, N_INIT = 64, 6, 3, 8, 6
AA_FIT = dict(init='random', tolerance=1e-6, max_iterations=40,
              stopping_criterion='rel_delta_f',
              dictionary_solver_kwargs={'max_iterations': 1},
              weights_solver_kwargs={'backend': 'pallas',
                                     'max_iterations': 25},
              restart_chunk=4)
GPNH_D, LAMBDA_W = 8, 3e-5
GPNH_FIT = dict(init='random', tolerance=1e-5, max_iterations=60,
                stopping_criterion='rel_delta_f', lambda_W=LAMBDA_W,
                weights_solver_kwargs={'backend': 'pallas',
                                       'max_iterations': 200},
                restart_chunk=4)
#: The two schedulers: compaction in rounds of 20 (16 for GPNH) and a
#: screen whose pruned restarts stop late enough in their trajectory to
#: agree to 1e-8 (see tests/test_torch_screening.py).
SCHEDULERS = {'compacted': dict(compact_iterations=20),
              'screened': dict(screen_iterations=24, screen_keep=0.5)}


def _aa_data(seed=0, noise=0.01):
    rng = np.random.RandomState(seed)
    basis = rng.uniform(size=(K, D))
    Z = rng.uniform(size=(N, K))
    Z /= Z.sum(axis=1, keepdims=True)
    for comp, i in enumerate(rng.choice(N, size=K, replace=False)):
        Z[i] = 0.0
        Z[i, comp] = 1.0
    return Z @ basis + noise * rng.standard_normal((N, D))


def _gpnh_data(seed=0, noise=0.02):
    rng = np.random.RandomState(seed)
    W = rng.uniform(size=(GPNH_D, K))
    Z = rng.uniform(size=(N, K))
    Z /= Z.sum(axis=1, keepdims=True)
    return Z @ W.T + noise * rng.standard_normal((N, GPNH_D))


def _grouped_interpret(As, Bs, X0s, backend='xla', mask=None, **kw):
    assert backend == 'pallas'
    return quad_simplex_qp_pallas_packed_grouped(
        As, Bs, X0s, mask=mask, interpret=True, block_rows=8,
        **_pallas_qp_kwargs(kw))


_RUNNERS = ('_make_aa_grouped_round_run', '_make_aa_grouped_screen_run',
            '_make_aa_grouped_resume_run', '_make_gpnh_grouped_round_run',
            '_make_gpnh_grouped_screen_run',
            '_make_gpnh_grouped_resume_run')


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


def _jax_mask():
    return jnp.arange(K_PAD) < K


def _jax_aa_states(key, mask):
    k = K if mask is None else K_PAD
    init = functools.partial(
        jrestarts._init_aa_state, n_samples=N, n_components=k,
        init='random', diss=None, n_extra_steps=10, component_mask=mask,
        do_scale=False, dtype=jnp.float64)
    return jax.vmap(init, in_axes=(0, None))(jax.random.split(key, N_INIT),
                                             jnp.asarray(0.0))


def _jax_gpnh_states(key, X, mask):
    k = K if mask is None else K_PAD
    one = functools.partial(jrestarts._init_gpnh_state, n_components=k,
                            init='random', n_extra_steps=10,
                            component_mask=mask)
    return jax.vmap(one, in_axes=(0, None, None))(
        jax.random.split(key, N_INIT), jnp.asarray(X), None)


def test_exact_multiple_k_gets_all_true_mask():
    k_fit, mask = trestarts._padded_components(4, 4)
    assert k_fit == 4 and mask is not None and bool(mask.all())
    assert mask.device.type == "cpu" and mask.dtype == torch.bool
    assert trestarts._padded_components(3, None) == (3, None)
    # A pad below k: no padding.
    assert trestarts._padded_components(5, 4) == (5, None)
    k_fit, mask = trestarts._padded_components(3, 8)
    assert k_fit == 8 and mask.tolist() == [True] * 3 + [False] * 5


def _assert_fit_matches(got, want, k_out, rtol=1e-8):
    np.testing.assert_allclose(got['costs'], want['costs'], rtol=rtol)
    np.testing.assert_array_equal(got['n_iters'], want['n_iters'])
    assert got['best_index'] == want['best_index']
    assert got['n_iter'] == want['n_iter']
    assert got['cost'] == pytest.approx(want['cost'], rel=rtol)
    assert got['weights'].shape[1] == k_out
    np.testing.assert_allclose(got['weights'].numpy(),
                               np.asarray(want['weights']), atol=1e-6)


@pytest.mark.parametrize("scheduler", sorted(SCHEDULERS))
def test_padded_aa_fit_matches_jax(jax_pallas_interpret, monkeypatch,
                                   scheduler):
    X = _aa_data()
    key = jax.random.PRNGKey(0)
    kw = dict(AA_FIT, pad_components_to=K_PAD, **SCHEDULERS[scheduler])
    want = jrestarts.aa_fit_restarts(X, K, key, N_INIT, grouped=True, **kw)
    states = states_from_numpy(*_jax_aa_states(key, _jax_mask()),
                               device='cpu', dtype=torch.float64)
    monkeypatch.setattr(trestarts, '_init_aa_state',
                        lambda *args, **kwargs: states)
    got = trestarts.aa_fit_restarts(torch.as_tensor(X), K, 0, N_INIT, **kw)
    _assert_fit_matches(got, want, K)
    assert got['dictionary'].shape == (K, N)
    assert got['archetypes'].shape == (K, D)
    assert ('screen' in got) == (scheduler == 'screened')


@pytest.mark.parametrize("scheduler", sorted(SCHEDULERS))
def test_padded_gpnh_fit_matches_jax(jax_pallas_interpret, monkeypatch,
                                     scheduler):
    X = _gpnh_data()
    key = jax.random.PRNGKey(0)
    sched = dict(SCHEDULERS[scheduler])
    if scheduler == 'compacted':
        sched['compact_iterations'] = 16
    else:
        sched['screen_iterations'] = 8
    kw = dict(GPNH_FIT, pad_components_to=K_PAD, **sched)
    want = jrestarts.gpnh_fit_restarts(X, K, key, N_INIT, grouped=True,
                                       **kw)
    states = gpnh_states_from_numpy(*_jax_gpnh_states(key, X, _jax_mask()),
                                    device='cpu', dtype=torch.float64)
    monkeypatch.setattr(trestarts, '_init_gpnh_state',
                        lambda *args, **kwargs: states)
    got = trestarts.gpnh_fit_restarts(torch.as_tensor(X), K, 0, N_INIT,
                                      **kw)
    _assert_fit_matches(got, want, K)
    assert got['dictionary'].shape == (GPNH_D, K)
    np.testing.assert_allclose(got['dictionary'].numpy(),
                               np.asarray(want['dictionary']), atol=1e-6)


#: The row solver's weights QP for the embedded-state tests.
ROW_SOLVER = {'backend': 'xla', 'max_iterations': 25}


def _best_of_restarts(iterate, cost0, states, fit, scheduler, *, rounds,
                      screen):
    """``trestarts._best_of_restarts`` at ``fit``'s tolerance, criterion
    and cap over chunks of 4: compacted in rounds of ``rounds``
    iterations, or screened for ``screen`` iterations keeping half."""
    screened = scheduler == 'screened'
    return trestarts._best_of_restarts(
        iterate, cost0, states, tolerance=fit['tolerance'],
        criterion=fit['stopping_criterion'],
        max_iterations=fit['max_iterations'], restart_chunk=4,
        compact_iterations=None if screened else rounds,
        screen_iterations=screen if screened else None, screen_keep=0.5,
        screen_margin=None)


def _embed_aa(states, seed=1):
    """Unpadded AA states at the padded width: padded weights 0, padded
    dictionary rows random stochastic rows."""
    Z, C, alpha = states
    R, n, k = Z.shape
    gen = torch.Generator().manual_seed(seed)
    Z_pad = torch.zeros((R, n, K_PAD), dtype=Z.dtype)
    Z_pad[..., :k] = Z
    C_pad = torch.rand((R, K_PAD, n), generator=gen, dtype=C.dtype)
    C_pad /= C_pad.sum(dim=2, keepdim=True)
    C_pad[:, :k] = C
    a_pad = torch.ones((R, K_PAD), dtype=alpha.dtype)
    a_pad[:, :k] = alpha
    return Z_pad, C_pad, a_pad


def _run_aa(X, states, mask, scheduler):
    iterate, cost0 = tsharded._aa_iterate(
        X, trestarts._gram_once(X), n_components=states[0].shape[-1],
        delta=0.0, do_scale=False, sh=tsharded._Shard(device='cpu'),
        dictionary_solver_kwargs=AA_FIT['dictionary_solver_kwargs'],
        weights_solver_kwargs=ROW_SOLVER, component_mask=mask)
    return _best_of_restarts(iterate, cost0, states, AA_FIT, scheduler,
                             rounds=20, screen=10)


@pytest.mark.parametrize("scheduler", sorted(SCHEDULERS))
def test_padded_aa_from_embedded_states_equals_unpadded(scheduler):
    """The same active start at k = 3 and padded to 8: the same
    per-restart costs to 1e-10 and iteration counts; the padded weights
    exactly 0 and the padded dictionary rows frozen."""
    # Noise of 0.1 keeps the costs well above their rounding (the
    # residual form cancels to about 1e-13).
    X = torch.as_tensor(_aa_data(2, noise=0.1))
    gen = torch.Generator().manual_seed(3)
    states = trestarts._init_aa_state(
        gen, N_INIT, 0.0, n_samples=N, n_components=K, init='random',
        diss=None, n_extra_steps=10, do_scale=False, dtype=torch.float64,
        device='cpu')
    padded = _embed_aa(states)
    _, mask = trestarts._padded_components(K, K_PAD)

    best_r, costs_r, iters_r, screen_r = _run_aa(X, states, None,
                                                 scheduler)
    # The fit advances the states it is given; ``padded`` is read below.
    best_p, costs_p, iters_p, screen_p = _run_aa(
        X, tuple(s.clone() for s in padded), mask, scheduler)
    np.testing.assert_allclose(costs_p, costs_r, rtol=1e-10)
    np.testing.assert_array_equal(iters_p, iters_r)
    Z_r, C_r, _, trace_r, _, n_iter_r = best_r
    Z_p, C_p, _, trace_p, _, n_iter_p = best_p
    assert n_iter_p == n_iter_r
    np.testing.assert_allclose(trace_p, trace_r, rtol=0, atol=1e-10)
    np.testing.assert_allclose(Z_p[:, :K].numpy(), Z_r.numpy(), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(C_p[:K].numpy(), C_r.numpy(), rtol=1e-6,
                               atol=1e-9)
    assert bool((Z_p[:, K:] == 0).all())
    best = int(np.argmin(costs_p))
    np.testing.assert_allclose(C_p[K:].numpy(), padded[1][best, K:].numpy(),
                               atol=1e-15)
    if scheduler == 'screened':
        assert screen_p['n_kept'] == screen_r['n_kept']
        assert screen_p['screen_cut'] == pytest.approx(
            screen_r['screen_cut'], rel=1e-10)


@pytest.mark.parametrize("scheduler", sorted(SCHEDULERS))
def test_padded_gpnh_from_embedded_states_equals_unpadded(scheduler):
    """As for AA, with the GPNH penalty on: the padded columns of both
    factors stay exactly 0 after every iteration's dictionary solve (the
    system is singular there; the least-squares cutoff drops those
    directions and the mask zeroes them)."""
    X = torch.as_tensor(_gpnh_data(2, noise=0.1))
    gen = torch.Generator().manual_seed(3)
    Z, W = trestarts._init_gpnh_state(gen, X, None, N_INIT, n_components=K,
                                      init='random', n_extra_steps=10)
    Z_pad = torch.zeros((N_INIT, N, K_PAD), dtype=Z.dtype)
    Z_pad[..., :K] = Z
    W_pad = torch.zeros((N_INIT, GPNH_D, K_PAD), dtype=W.dtype)
    W_pad[..., :K] = W
    _, mask = trestarts._padded_components(K, K_PAD)

    solves = []
    real_solve = tsharded._solve_gpnh_dictionary

    def recording(*args, **kwargs):
        out = real_solve(*args, **kwargs)
        if out.shape[-1] == K_PAD:
            solves.append(out[..., K:].abs().max().item())
        return out

    def run(states, m, k):
        iterate, cost0 = tsharded._gpnh_iterate(
            X, lambda_W=LAMBDA_W, n_components=k,
            sh=tsharded._Shard(device='cpu'),
            weights_solver_kwargs=dict(ROW_SOLVER, max_iterations=200),
            component_mask=m)
        return _best_of_restarts(iterate, cost0, states, GPNH_FIT,
                                 scheduler, rounds=16, screen=8)

    best_r, costs_r, iters_r, _ = run((Z, W), None, K)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsharded, '_solve_gpnh_dictionary', recording)
        best_p, costs_p, iters_p, _ = run((Z_pad, W_pad), mask, K_PAD)
    np.testing.assert_allclose(costs_p, costs_r, rtol=1e-10)
    np.testing.assert_array_equal(iters_p, iters_r)
    Z_r, W_r, trace_r, _, n_iter_r = best_r
    Z_p, W_p, trace_p, _, n_iter_p = best_p
    assert n_iter_p == n_iter_r
    np.testing.assert_allclose(trace_p, trace_r, rtol=0, atol=1e-10)
    np.testing.assert_allclose(Z_p[:, :K].numpy(), Z_r.numpy(), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(W_p[:, :K].numpy(), W_r.numpy(), rtol=1e-6,
                               atol=1e-9)
    assert bool((Z_p[:, K:] == 0).all()) and bool((W_p[:, K:] == 0).all())
    # Every dictionary solve of the padded fit, before the mask: the
    # padded columns already 0 (minimum-norm least squares).
    assert solves and max(solves) == 0.0


@pytest.mark.parametrize("fit", ["aa", "kernel_aa", "gpnh"])
@pytest.mark.parametrize("scheduler", sorted(SCHEDULERS))
def test_padded_outputs_have_k_columns(fit, scheduler):
    """Every output of a padded fit is sliced back to k; its weights
    are row-stochastic on the active columns."""
    X = torch.as_tensor(_aa_data(4))
    sched = dict(SCHEDULERS[scheduler])
    if scheduler == 'screened':
        sched['screen_iterations'] = 5
    kw = dict(max_iterations=10, pad_components_to=K_PAD, init='random',
              weights_solver_kwargs={'max_iterations': 25}, **sched)
    if fit == 'gpnh':
        res = trestarts.gpnh_fit_restarts(X, K, 0, 4, lambda_W=1e-3, **kw)
        assert res['dictionary'].shape == (D, K)
    else:
        kw['dictionary_solver_kwargs'] = {'max_iterations': 1}
        if fit == 'aa':
            res = trestarts.aa_fit_restarts(X, K, 0, 4, **kw)
            assert res['archetypes'].shape == (K, D)
        else:
            res = trestarts.kernel_aa_fit_restarts(X @ X.T, K, 0, 4, **kw)
        assert res['dictionary'].shape == (K, N)
        assert res['alpha'].shape == (K,)
    assert res['weights'].shape == (N, K)
    np.testing.assert_allclose(res['weights'].sum(dim=1).numpy(), 1.0,
                               atol=1e-12)
    assert np.all(np.isfinite(res['costs']))
