"""The port's multi-restart AA fit against the JAX package's, float64.

Both start from the same restart states: the JAX package's own
``_init_aa_state`` (``init='random'``) makes them, and
``states_from_numpy`` hands them to the port.  On the CPU the JAX fit
would resolve its weights QP to the XLA row solver, which stops on
another rule, so ``quad_simplex_spg_batch_grouped`` in the JAX restarts
module is patched to run the Pallas kernel in interpret mode: both fits
then run the same grouped QP kernel (its plain version in the port).

Tolerances: per-restart costs to rtol 1e-8 and the winner's weights to
1e-6.  The QP kernels agree to about 1e-8 in x at convergence (see
tests/test_torch_simplex_qp.py); forty alternating iterations carry
that into the costs far below 1e-8, and the iteration counts, which
depend on the rel_delta_f test, come out equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convex_dim_red_tpu.models import _common as jcommon
from convex_dim_red_tpu.models.archetypal_analysis import (
    _spg_cfg_to_quad_kwargs as j_spg_kwargs)
from convex_dim_red_tpu.ops.pallas_qp import (
    quad_simplex_qp_pallas_packed_grouped)
from convex_dim_red_tpu.parallel import restarts as jrestarts
from convex_dim_red_tpu.solvers.spg import _pallas_qp_kwargs
from convex_dim_red_tpu_torch.models import _common as tcommon
from convex_dim_red_tpu_torch.ops import simplex_qp
from convex_dim_red_tpu_torch.parallel import restarts as trestarts
from convex_dim_red_tpu_torch.utils.interop import states_from_numpy

# Small tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores (tenfold slower when they do).
torch.set_num_threads(1)

N, D, K, N_INIT = 64, 6, 3, 6
FIT = dict(tolerance=1e-6, max_iterations=40,
           stopping_criterion='rel_delta_f')
DICT_KW = {'max_iterations': 1}
WEIGHTS_KW = {'backend': 'pallas', 'max_iterations': 25}


def _data(seed=0):
    """Planted archetypes (pure samples included) plus a little noise:
    a well-conditioned fit, where a perturbation of the state decays
    instead of growing over the iterations."""
    rng = np.random.RandomState(seed)
    basis = rng.uniform(size=(K, D))
    Z = rng.uniform(size=(N, K))
    Z /= Z.sum(axis=1, keepdims=True)
    for comp, i in enumerate(rng.choice(N, size=K, replace=False)):
        Z[i] = 0.0
        Z[i, comp] = 1.0
    return Z @ basis + 0.01 * rng.standard_normal((N, D))


def _grouped_interpret(As, Bs, X0s, backend='xla', mask=None, **kw):
    # Small row blocks keep interpret mode quick; rows are solved
    # independently, so the block size does not change the result.
    assert backend == 'pallas'
    return quad_simplex_qp_pallas_packed_grouped(
        As, Bs, X0s, mask=mask, interpret=True, block_rows=8,
        **_pallas_qp_kwargs(kw))


@pytest.fixture(scope="module")
def jax_pallas_interpret():
    """Route the JAX restarts' weights QP to the Pallas kernel in
    interpret mode.  The round runners are cached per configuration, so
    the cache is cleared on the way in and out: no runner traced with
    another QP route is reused, and none traced here leaks out."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrestarts, 'quad_simplex_spg_batch_grouped',
                   _grouped_interpret)
        jrestarts._make_aa_grouped_round_run.cache_clear()
        yield
        jrestarts._make_aa_grouped_round_run.cache_clear()


def _jax_init_states(key, delta):
    init = functools.partial(
        jrestarts._init_aa_state, n_samples=N, n_components=K,
        init='random', diss=None, n_extra_steps=10, component_mask=None,
        do_scale=delta != 0.0, dtype=jnp.float64)
    keys = jax.random.split(key, N_INIT)
    return jax.vmap(init, in_axes=(0, None))(keys, jnp.asarray(delta))


@pytest.mark.parametrize("max_iterations", [40, 20])
def test_compacted_fit_matches_jax(jax_pallas_interpret, max_iterations):
    """Rounds of 20 iterations.  At 40 every restart converges in the
    second round, after a resume; at 20 every restart stops at the cap
    at the end of the first."""
    X = _data()
    key = jax.random.PRNGKey(0)
    fit = dict(FIT, max_iterations=max_iterations)
    want = jrestarts.aa_fit_restarts(
        X, K, key, N_INIT, init='random',
        dictionary_solver_kwargs=DICT_KW,
        weights_solver_kwargs=WEIGHTS_KW, restart_chunk=4,
        compact_iterations=20, **fit)

    states = states_from_numpy(*_jax_init_states(key, 0.0),
                               device='cpu', dtype=torch.float64)
    statics = dict(
        max_iterations=max_iterations,
        criterion=FIT['stopping_criterion'], do_scale=False,
        has_data=True,
        dict_cfg=tcommon.make_config(tcommon.SPGSolverConfig, DICT_KW),
        weights_cfg=tcommon.make_config(tcommon.QPSolverConfig,
                                        WEIGHTS_KW),
        scale_cfg=tcommon.SPGSolverConfig())
    before = simplex_qp.LAUNCHES
    best, costs, n_iters = trestarts._compacted_aa_best(
        torch.as_tensor(X), states, 0.0, FIT['tolerance'],
        statics=statics, grouped_backend='pallas', restart_chunk=4,
        round_iterations=20)
    assert simplex_qp.LAUNCHES == before  # CPU: the plain version

    np.testing.assert_allclose(costs, want['costs'], rtol=1e-8)
    np.testing.assert_array_equal(n_iters, want['n_iters'])
    if max_iterations == 40:
        assert 20 < n_iters.min() and n_iters.max() < 40
    else:
        assert np.all(n_iters == 20)
    best_index = int(np.argmin(costs))
    assert best_index == want['best_index']
    Z, C, alpha, trace, best_cost, best_n_iter = best
    np.testing.assert_allclose(Z.numpy(), np.asarray(want['weights']),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(C.numpy(), np.asarray(want['dictionary']),
                               rtol=0, atol=1e-6)
    assert best_n_iter == want['n_iter']
    assert best_cost == pytest.approx(want['cost'], rel=1e-8)
    # Mid-trajectory costs carry the weights QP's resolution (see
    # test_grouped_iterate_matches_jax); the fit contracts it away.
    np.testing.assert_allclose(trace[:best_n_iter], want['cost_deltas'],
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("has_data,delta", [
    (True, 0.0), (True, 0.3), (False, 0.0), (False, 0.3)])
def test_grouped_iterate_matches_jax(jax_pallas_interpret, has_data,
                                    delta):
    """One alternating iteration of every restart, both cost forms, with
    and without scale factors."""
    X = _data(1)
    Zs, Cs, alphas = _jax_init_states(jax.random.PRNGKey(1), delta)
    Kj = jnp.asarray(X @ X.T)
    dict_kw = j_spg_kwargs(jcommon.SPGSolverConfig(max_iterations=1))
    scale_kw = j_spg_kwargs(jcommon.SPGSolverConfig(max_iterations=50))
    common = dict(delta=delta, do_scale=delta != 0.0, has_data=has_data,
                  dict_kwargs=dict_kw, scale_kwargs=scale_kw,
                  weights_backend='pallas')
    iterate, cost0 = jrestarts._aa_grouped_iterate(
        jnp.asarray(X) if has_data else None, Kj,
        weights_kwargs={'max_iterations': 25}, component_mask=None,
        trace_K=None if has_data else jnp.trace(Kj), **common)
    want = [np.asarray(a) for a in iterate(Zs, Cs, alphas)]
    want0 = np.asarray(cost0(Zs, Cs, alphas))

    Kt = torch.as_tensor(X @ X.T)
    t_iterate, t_cost0 = trestarts._aa_grouped_iterate(
        torch.as_tensor(X) if has_data else None, Kt,
        weights_kwargs={'max_iterations': 25},
        trace_K=None if has_data else torch.trace(Kt), **common)
    states = states_from_numpy(Zs, Cs, alphas, 'cpu', torch.float64)
    Z, C, alpha, costs = (t.numpy() for t in t_iterate(*states))
    np.testing.assert_allclose(t_cost0(*states).numpy(), want0, rtol=1e-12)
    # C and alpha are solved before the weights QP: rounding only.
    np.testing.assert_allclose(C, want[1], rtol=0, atol=1e-12)
    np.testing.assert_allclose(alpha, want[2], rtol=0, atol=1e-12)
    # The weights QPs start far from their optimum and stop at
    # ||D|| < 1e-6 on nearly flat valleys of these small, ill-conditioned
    # Hessians, so x lands anywhere within the solver's own resolution;
    # the cost it gives is what the fit uses.
    np.testing.assert_allclose(Z, want[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(costs, want[3], rtol=1e-9)


def test_public_fit_contract():
    X = torch.as_tensor(_data(2))
    gen = torch.Generator().manual_seed(7)
    res = trestarts.aa_fit_restarts(
        X, K, gen, 5, init='random', dictionary_solver_kwargs=DICT_KW,
        weights_solver_kwargs=WEIGHTS_KW, restart_chunk=2,
        compact_iterations=8, **FIT)
    Z, C = res['weights'], res['dictionary']
    assert Z.shape == (N, K) and C.shape == (K, N)
    assert res['archetypes'].shape == (K, D)
    for M in (Z, C):
        assert M.min().item() >= 0.0
        np.testing.assert_allclose(M.sum(dim=1).numpy(), 1.0, atol=1e-12)
    resid = Z @ (C @ X) - X
    cost = 0.5 * torch.sum(resid * resid).item() / N
    assert res['cost'] == pytest.approx(cost, rel=1e-12)
    assert res['costs'].shape == (5,) and res['n_iters'].shape == (5,)
    assert res['best_index'] == int(np.argmin(res['costs']))
    assert res['cost'] == res['costs'].min()
    assert np.all(res['n_iters'] <= FIT['max_iterations'])
    assert res['cost_deltas'].shape == (res['n_iter'],)

    # A seed in place of a generator, and the same seed twice: the
    # same fit.
    again = trestarts.aa_fit_restarts(
        X, K, 7, 5, init='random', dictionary_solver_kwargs=DICT_KW,
        weights_solver_kwargs=WEIGHTS_KW, restart_chunk=2,
        compact_iterations=8, **FIT)
    np.testing.assert_array_equal(again['costs'], res['costs'])


def test_scale_factors_fit_keeps_alpha_in_its_box():
    X = torch.as_tensor(_data(3))
    res = trestarts.aa_fit_restarts(
        X, K, 3, 3, delta=0.2, init='random',
        dictionary_solver_kwargs=DICT_KW,
        weights_solver_kwargs=WEIGHTS_KW, compact_iterations=8, **FIT)
    alpha = res['alpha']
    assert alpha.min().item() >= 0.8 and alpha.max().item() <= 1.2
    # The dictionary is diag(alpha) C with C row-stochastic.
    C = res['dictionary'] / alpha[:, None]
    np.testing.assert_allclose(C.sum(dim=1).numpy(), 1.0, atol=1e-12)


@pytest.mark.parametrize("bad", [
    dict(mesh=object()), dict(screen_iterations=10),
    dict(pad_components_to=4), dict(compact_iterations=None),
    dict(init='furthest_sum'), dict(stopping_criterion='delta_x'),
    dict(n_init=0),
    dict(weights_solver_kwargs={'max_iteration': 5})])
def test_rejects_what_is_not_ported(bad):
    kw = dict(init='random', compact_iterations=8, n_init=2)
    kw.update(bad)
    with pytest.raises(ValueError):
        trestarts.aa_fit_restarts(torch.as_tensor(_data()), K, 0, **kw)


def test_default_init_is_not_ported_yet():
    with pytest.raises(ValueError, match="FurthestSum"):
        trestarts.aa_fit_restarts(torch.as_tensor(_data()), K, 0, 2,
                                  compact_iterations=8)


def test_xla_weights_backend_is_not_ported_yet():
    with pytest.raises(NotImplementedError):
        trestarts.aa_fit_restarts(
            torch.as_tensor(_data()), K, 0, 2, init='random',
            dictionary_solver_kwargs=DICT_KW,
            weights_solver_kwargs={'backend': 'xla'}, compact_iterations=8)
