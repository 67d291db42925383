"""The port's screened restarts against the JAX package's, float64.

``_screened_best`` is held to tests/test_screen_margin.py's fake
four-restart problem; the screened AA and GPNH fits to the JAX
package's grouped screen and resume runners (``grouped=True``) from the
same restart states: the JAX package's own ``_init_*_state`` makes them
and the port's entry point gets them by patching its
``_init_*_state``.  The JAX restarts' weights QP is patched to run the
Pallas kernel in interpret mode, so both fits run the same grouped QP
kernel (its plain version in the port).

Tolerances, as for the unscreened fits (tests/test_torch_restarts.py):
per-restart costs to rtol 1e-8 with equal iteration counts; the screen's
cut and observed margin, differences of such costs, to 1e-8 of the cut.
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
from convex_dim_red_tpu_torch.utils.interop import (gpnh_states_from_numpy,
                                                    states_from_numpy)

torch.set_num_threads(1)

N, D, K, N_INIT = 64, 6, 3, 6
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


def _aa_data(seed=0):
    """Planted archetypes (pure samples included) plus a little noise."""
    rng = np.random.RandomState(seed)
    basis = rng.uniform(size=(K, D))
    Z = rng.uniform(size=(N, K))
    Z /= Z.sum(axis=1, keepdims=True)
    for comp, i in enumerate(rng.choice(N, size=K, replace=False)):
        Z[i] = 0.0
        Z[i, comp] = 1.0
    return Z @ basis + 0.01 * rng.standard_normal((N, D))


def _gpnh_data(seed=0):
    rng = np.random.RandomState(seed)
    W = rng.uniform(size=(GPNH_D, K))
    Z = rng.uniform(size=(N, K))
    Z /= Z.sum(axis=1, keepdims=True)
    return Z @ W.T + 0.02 * rng.standard_normal((N, GPNH_D))


def _grouped_interpret(As, Bs, X0s, backend='xla', mask=None, **kw):
    assert backend == 'pallas'
    return quad_simplex_qp_pallas_packed_grouped(
        As, Bs, X0s, mask=mask, interpret=True, block_rows=8,
        **_pallas_qp_kwargs(kw))


_RUNNERS = ('_make_aa_grouped_screen_run', '_make_aa_grouped_resume_run',
            '_make_gpnh_grouped_screen_run',
            '_make_gpnh_grouped_resume_run')


@pytest.fixture(scope="module")
def jax_pallas_interpret():
    """Route the JAX restarts' weights QP to the Pallas kernel in
    interpret mode, with the per-configuration runner caches cleared on
    the way in and out."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrestarts, 'quad_simplex_spg_batch_grouped',
                   _grouped_interpret)
        for name in _RUNNERS:
            getattr(jrestarts, name).cache_clear()
        yield
        for name in _RUNNERS:
            getattr(jrestarts, name).cache_clear()


def _jax_aa_states(key):
    init = functools.partial(
        jrestarts._init_aa_state, n_samples=N, n_components=K,
        init='random', diss=None, n_extra_steps=10, component_mask=None,
        do_scale=False, dtype=jnp.float64)
    return jax.vmap(init, in_axes=(0, None))(jax.random.split(key, N_INIT),
                                             jnp.asarray(0.0))


def _jax_gpnh_states(key, X):
    one = functools.partial(jrestarts._init_gpnh_state, n_components=K,
                            init='random', n_extra_steps=10,
                            component_mask=None)
    return jax.vmap(one, in_axes=(0, None, None))(
        jax.random.split(key, N_INIT), jnp.asarray(X), None)


# -- the fake four-restart problem (tests/test_screen_margin.py) ----------

SCREENED = np.array([1.0, 1.01, 2.0, 3.0])
FINALS = np.array([0.9, 0.5, 1.9, 2.9])


def _fake_round(states_all, idx, M):
    """A restart's state is (its index, rounds run).  Its first round
    (the screen) ends at its screened cost, every later one (the resume)
    at its final cost; every round stops after one iteration."""
    (s_all,) = states_all
    s = s_all[idx].clone()
    s[:, 1] += 1
    ids = s[:, 0].long()
    costs = torch.where(s[:, 1] == 1, torch.as_tensor(SCREENED)[ids],
                        torch.as_tensor(FINALS)[ids])
    s_all[idx] = s
    n = len(idx)
    return ((s_all,), costs, torch.zeros((n, M), dtype=torch.float64),
            torch.ones(n, dtype=torch.int32), torch.ones(n, dtype=torch.bool))


def _fake_screened(**kw):
    states = (torch.stack([torch.arange(4.0, dtype=torch.float64),
                           torch.zeros(4, dtype=torch.float64)], dim=1),)
    return trestarts._screened_best(
        states, _fake_round, max_iterations=10, screen_iterations=5,
        restart_chunk=4, **kw)


def test_screening_without_margin_prunes_true_winner():
    best, costs, n_iters, diag = _fake_screened(screen_keep=0.25)
    # keep=0.25 keeps only restart 0; the eventual winner (restart 1) is
    # pruned and the final best is restart 0's 0.9.
    assert best[-2] == pytest.approx(0.9)
    assert diag['n_kept'] == 1 and diag['n_screened'] == 4
    assert diag['screen_cut'] == pytest.approx(1.0)
    assert diag['screen_margin_observed'] == pytest.approx(0.01)
    # Pruned restarts report their screened costs; a survivor's n_iters
    # are screen plus resume, the winner's n_iter its resume only.
    np.testing.assert_allclose(costs[1:], SCREENED[1:])
    np.testing.assert_array_equal(n_iters, [2, 1, 1, 1])
    assert best[-1] == 1
    assert best[0].tolist() == [0.0, 2.0]


def test_screen_margin_rescues_near_tied_winner():
    best, costs, _, diag = _fake_screened(screen_keep=0.25,
                                          screen_margin=0.05)
    assert diag['n_kept'] == 2
    assert best[-2] == pytest.approx(0.5)
    assert costs[0] == pytest.approx(0.9) and costs[1] == pytest.approx(0.5)
    # A margin beyond every restart keeps all four.
    _, costs_all, _, diag_all = _fake_screened(screen_keep=0.25,
                                               screen_margin=np.inf)
    assert diag_all['n_kept'] == 4
    assert diag_all['screen_margin_observed'] == np.inf
    np.testing.assert_allclose(costs_all, FINALS)


# -- screened fits against the JAX package ---------------------------------


def _assert_screened_matches(got, want):
    np.testing.assert_allclose(got['costs'], want['costs'], rtol=1e-8)
    np.testing.assert_array_equal(got['n_iters'], want['n_iters'])
    assert got['best_index'] == want['best_index']
    assert got['n_iter'] == want['n_iter']
    assert got['cost'] == pytest.approx(want['cost'], rel=1e-8)
    np.testing.assert_allclose(got['cost_deltas'], want['cost_deltas'],
                               rtol=0, atol=1e-7)
    g, w = got['screen'], want['screen']
    assert (g['n_screened'], g['n_kept']) == (w['n_screened'], w['n_kept'])
    scale = 1e-8 * abs(w['screen_cut'])
    assert g['screen_cut'] == pytest.approx(w['screen_cut'], abs=scale)
    assert g['screen_margin_observed'] == pytest.approx(
        w['screen_margin_observed'], abs=scale)


@pytest.mark.parametrize("screen", [
    dict(screen_iterations=24, screen_keep=0.5),
    dict(screen_iterations=22, screen_keep=0.25, screen_margin=1e-7)])
def test_aa_screened_fit_matches_jax(jax_pallas_interpret, monkeypatch,
                                     screen):
    """A pruned restart reports its screened cost, a mid-trajectory
    cost that carries the weights QP's resolution (25 iterations from
    the last weights): 20 screen iterations hold it to 1e-8, 10 only to
    5e-7.  The margin case keeps 5 of 6 where the fraction keeps 2."""
    X = _aa_data()
    key = jax.random.PRNGKey(0)
    want = jrestarts.aa_fit_restarts(X, K, key, N_INIT, grouped=True,
                                     **AA_FIT, **screen)
    states = states_from_numpy(*_jax_aa_states(key), device='cpu',
                               dtype=torch.float64)
    monkeypatch.setattr(trestarts, '_init_aa_state',
                        lambda *args, **kwargs: states)
    got = trestarts.aa_fit_restarts(torch.as_tensor(X), K, 0, N_INIT,
                                    **AA_FIT, **screen)
    _assert_screened_matches(got, want)
    # Survivors ran past the screen; pruned restarts stopped in it.
    assert np.sum(got['n_iters'] > screen['screen_iterations']) \
        <= got['screen']['n_kept']
    np.testing.assert_allclose(got['weights'].numpy(),
                               np.asarray(want['weights']), atol=1e-6)


def test_gpnh_screened_fit_matches_jax(jax_pallas_interpret, monkeypatch):
    X = _gpnh_data()
    key = jax.random.PRNGKey(0)
    screen = dict(screen_iterations=8, screen_keep=0.5)
    want = jrestarts.gpnh_fit_restarts(X, K, key, N_INIT, grouped=True,
                                       **GPNH_FIT, **screen)
    states = gpnh_states_from_numpy(*_jax_gpnh_states(key, X),
                                    device='cpu', dtype=torch.float64)
    monkeypatch.setattr(trestarts, '_init_gpnh_state',
                        lambda *args, **kwargs: states)
    got = trestarts.gpnh_fit_restarts(torch.as_tensor(X), K, 0, N_INIT,
                                      **GPNH_FIT, **screen)
    _assert_screened_matches(got, want)
    np.testing.assert_allclose(got['dictionary'].numpy(),
                               np.asarray(want['dictionary']), atol=1e-6)


# -- the port's own screened contract --------------------------------------


def _planted(seed, n=48, k=3, d=5):
    rng = np.random.RandomState(seed)
    basis = rng.uniform(size=(k, d))
    Z = rng.uniform(size=(n, k))
    Z /= Z.sum(axis=1, keepdims=True)
    for comp, i in enumerate(rng.choice(n, size=k, replace=False)):
        Z[i] = 0.0
        Z[i, comp] = 1.0
    return torch.as_tensor(Z @ basis)


_PLANTED_FIT = dict(init='random', tolerance=1e-10, max_iterations=150,
                    dictionary_solver_kwargs={'max_iterations': 5})


def test_keep_all_reaches_the_unscreened_winner():
    """With ``screen_keep=1.0`` every restart resumes: the screened fit
    finds the unscreened optimum (tests/test_padded_components.py)."""
    X = _planted(8)
    full = trestarts.aa_fit_restarts(X, 3, 1, 4, **_PLANTED_FIT)
    screened = trestarts.aa_fit_restarts(X, 3, 1, 4, screen_iterations=15,
                                         screen_keep=1.0, **_PLANTED_FIT)
    assert abs(full['cost'] - screened['cost']) < 1e-8
    assert screened['best_index'] == full['best_index']
    assert screened['screen']['n_kept'] == 4
    assert screened['screen']['screen_margin_observed'] == np.inf


def test_infinite_margin_keeps_every_restart():
    """tests/test_screen_margin.py's diagnostics test: an infinite
    margin is keeping every restart, and every screened result reports
    its screen."""
    X = _planted(0)
    kw = dict(_PLANTED_FIT, max_iterations=60, screen_iterations=10)
    guarded = trestarts.aa_fit_restarts(X, 3, 0, 6, screen_keep=1 / 6,
                                        screen_margin=np.inf, **kw)
    everything = trestarts.aa_fit_restarts(X, 3, 0, 6, screen_keep=1.0,
                                           **kw)
    assert guarded['screen']['n_kept'] == 6
    assert guarded['cost'] == pytest.approx(everything['cost'], rel=1e-10)
    np.testing.assert_allclose(guarded['costs'], everything['costs'],
                               rtol=1e-10)
    tight = trestarts.aa_fit_restarts(X, 3, 0, 6, screen_keep=0.5, **kw)
    diag = tight['screen']
    assert diag['n_screened'] == 6 and diag['n_kept'] == 3
    assert np.isfinite(diag['screen_cut'])
    assert diag['screen_margin_observed'] >= 0.0
    # The three pruned restarts report their screened costs, at most
    # screen_iterations iterations each.
    assert np.sum(tight['n_iters'] <= 10) >= 3


@pytest.mark.parametrize("fit", ["aa", "kernel_aa", "gpnh"])
def test_integer_compaction_with_screening_raises(fit):
    X = _planted(1)
    call = {'aa': trestarts.aa_fit_restarts,
            'kernel_aa': trestarts.kernel_aa_fit_restarts,
            'gpnh': trestarts.gpnh_fit_restarts}[fit]
    data = X @ X.T if fit == 'kernel_aa' else X
    kw = dict(max_iterations=5, weights_solver_kwargs={'max_iterations': 10})
    if fit != 'gpnh':
        kw['dictionary_solver_kwargs'] = {'max_iterations': 1}
    with pytest.raises(ValueError, match="mutually exclusive"):
        call(data, 3, 0, 2, screen_iterations=10, compact_iterations=20,
             **kw)
    # compact_iterations=None (the default) goes with screening.
    res = call(data, 3, 0, 2, screen_iterations=3, **kw)
    assert res['screen']['n_screened'] == 2
