"""The port's restart-batched ``quad_spg`` against ``jax.vmap`` of the
JAX package's, float64, on the two AA subproblems it solves: the
dictionary (rows of C on the simplex) and the scale factors (a box).
Same arithmetic, summed in another order: 1e-12.
"""

import jax
import numpy as np
import pytest
import torch

from convex_dim_red_tpu.models import _common as jcommon
from convex_dim_red_tpu.ops.simplex_projection import (
    simplex_project_rows as j_rows)
from convex_dim_red_tpu.solvers.spg import quad_spg as j_quad_spg
from convex_dim_red_tpu_torch.models import _common as tcommon
from convex_dim_red_tpu_torch.ops.simplex_projection import (
    simplex_project_rows as t_rows)
from convex_dim_red_tpu_torch.solvers.spg import quad_spg as t_quad_spg

# Small tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores.
torch.set_num_threads(1)

ATOL = 1e-12


def _stochastic(rng, shape):
    m = rng.uniform(size=shape)
    return m / m.sum(axis=-1, keepdims=True)


def _subproblems(seed, R=4, n=30, d=5, k=3, delta=0.2):
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, d))
    K = X @ X.T
    Z = _stochastic(rng, (R, n, k))
    C = _stochastic(rng, (R, k, n))
    alpha = rng.uniform(1 - delta, 1 + delta, size=(R, k))
    ZtZ = np.einsum('rnk,rnl->rkl', Z, Z)
    KZ = K @ Z
    # Dictionary: min 1/2 <C, DZ'ZD C K>/n - <KZD'/n, C>.
    DZtZD = alpha[:, :, None] * ZtZ * alpha[:, None, :]
    B_dict = (KZ * alpha[:, None, :]).transpose(0, 2, 1) / n
    # Scale factors: min 1/2 a'Ma/n - diag(CKZ)'a/n over a box.
    CK = C @ K
    M = ZtZ * (CK @ C.transpose(0, 2, 1))
    B_scale = np.diagonal(CK @ Z, axis1=1, axis2=2) / n
    return dict(K=K, n=n, DZtZD=DZtZD, B_dict=B_dict, C=C, M=M,
                B_scale=B_scale, alpha=alpha, delta=delta)


def _t(a):
    return torch.as_tensor(a)


@pytest.mark.parametrize("max_iterations", [1, 50])
def test_dictionary_subproblem_matches_vmapped_jax(max_iterations):
    p = _subproblems(0)
    K, n = p['K'], p['n']

    def one(DZtZD, B, C):
        return j_quad_spg(lambda Cm: DZtZD @ (Cm @ K) / n, B, C, j_rows,
                          max_iterations=max_iterations)

    want = np.asarray(jax.vmap(one)(p['DZtZD'], p['B_dict'], p['C']))
    Kt, DZtZD = _t(K), _t(p['DZtZD'])
    got = t_quad_spg(lambda Cm: DZtZD @ (Cm @ Kt) / n, _t(p['B_dict']),
                     _t(p['C']), t_rows,
                     max_iterations=max_iterations).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.sum(axis=2), 1.0, rtol=0, atol=ATOL)


@pytest.mark.parametrize("alpha0", [-1.0, 0.1])
def test_scale_subproblem_matches_vmapped_jax(alpha0):
    p = _subproblems(1)
    n, lo, hi = p['n'], 1 - p['delta'], 1 + p['delta']

    def one(M, B, a):
        return j_quad_spg(lambda v: (M @ v) / n, B, a,
                          lambda v: jax.numpy.clip(v, lo, hi),
                          alpha0=alpha0, max_iterations=200)

    want = np.asarray(jax.vmap(one)(p['M'], p['B_scale'], p['alpha']))
    M = _t(p['M'])
    got = t_quad_spg(lambda v: (M @ v[:, :, None])[:, :, 0] / n,
                     _t(p['B_scale']), _t(p['alpha']),
                     lambda v: torch.clamp(v, lo, hi), alpha0=alpha0,
                     max_iterations=200).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert got.min() >= lo and got.max() <= hi


def test_finished_restarts_stay_frozen():
    # A restart that converged is not moved by the iterations the
    # others still need: solving it alone gives the same answer.
    p = _subproblems(2)
    K, n = _t(p['K']), p['n']
    DZtZD, B, C = _t(p['DZtZD']), _t(p['B_dict']), _t(p['C'])

    def solve(sl):
        D = DZtZD[sl]
        return t_quad_spg(lambda Cm: D @ (Cm @ K) / n, B[sl], C[sl],
                          t_rows, max_iterations=100)

    full = solve(slice(None))
    for r in range(C.shape[0]):
        np.testing.assert_allclose(full[r:r + 1].numpy(),
                                   solve(slice(r, r + 1)).numpy(),
                                   rtol=0, atol=ATOL)


@pytest.mark.parametrize("criterion", ["abs_delta_f", "rel_delta_f"])
def test_has_converged_matches_jax(criterion):
    rng = np.random.RandomState(3)
    old = rng.uniform(1, 2, size=50)
    new = old + rng.choice([-1, 1], 50) * 10.0 ** rng.uniform(-9, -3, 50)
    want = np.asarray(jcommon.has_converged(old, new, 1e-5, criterion))
    got = tcommon.has_converged(_t(old), _t(new), 1e-5, criterion).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size


def test_has_converged_rejects_unknown_criterion():
    with pytest.raises(ValueError):
        tcommon.has_converged(_t(1.0), _t(1.0), 1e-5, "delta_x")


def test_make_config_takes_the_jax_kwargs():
    kw = {'backend': 'pallas', 'max_iterations': 25}
    cfg = tcommon.make_config(tcommon.QPSolverConfig, kw)
    jcfg = jcommon.make_config(jcommon.QPSolverConfig, kw)
    assert cfg.kwargs() == jcfg.kwargs()
    assert cfg.backend == jcfg.backend
    assert (tcommon.SPGSolverConfig().kwargs()
            == jcommon.SPGSolverConfig().kwargs())
    with pytest.raises(ValueError):
        tcommon.make_config(tcommon.SPGSolverConfig, {'max_iter': 1})
