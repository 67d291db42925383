"""The plain versions of the single-Hessian and unpacked simplex-QP
kernels (K2, K3, K4) against the JAX package's Pallas kernels
(``interpret=True``), float64.

K2 (``quad_simplex_qp_packed``) runs K1's plain version with one group;
K3 (``quad_simplex_qp_grouped``) and K4 (``quad_simplex_qp``) run the
same loop with the bisection projection up to k = 128.  On CPU tensors
the wrappers take these plain versions, and count no launch.

Tolerances as in tests/test_torch_simplex_qp.py: the same algorithm,
summed in another order, agrees to 1e-12 over the first iterations;
at convergence near-ties in the projection and the epsilon_two stop
amplify rounding to about 1e-8 in x, with the per-row objective still
within 1e-12.  At k = 128 the rounding runs through sums twice as long
and x spreads to 1.3e-8 on these problems, so it is held to 2e-8 there.
"""

import numpy as np
import pytest
import torch

from convex_dim_red_tpu.ops.pallas_qp import (
    quad_simplex_qp_pallas, quad_simplex_qp_pallas_grouped,
    quad_simplex_qp_pallas_packed)
from convex_dim_red_tpu_torch.ops import simplex_qp

# Small tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores.
torch.set_num_threads(1)

N = 12
BLOCK_ROWS = 8


def _problem(seed, R, n, k):
    rng = np.random.RandomState(seed)
    M = rng.standard_normal((R, k, k))
    As = M @ M.transpose(0, 2, 1) / k + np.eye(k)
    Bs = rng.standard_normal((R, n, k))
    X0s = rng.uniform(size=(R, n, k))
    X0s /= X0s.sum(axis=2, keepdims=True)
    return As, Bs, X0s


def _mask(k, masked):
    return (np.arange(k) % 5 != 2) if masked else None


def _obj(X, A, B):
    return (0.5 * np.einsum('rij,rjk,rik->ri', X, A, X)
            + np.sum(X * B, axis=2))


def _assert_parity(got, want, As, Bs, max_iterations):
    if max_iterations == 3:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        return
    atol = 1e-8 if got.shape[-1] < 128 else 2e-8
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    f_got, f_want = _obj(got, As, Bs), _obj(want, As, Bs)
    rel = np.abs(f_got - f_want) / np.maximum(1.0, np.abs(f_want))
    assert rel.max() <= 1e-12
    np.testing.assert_allclose(got.sum(axis=2), 1.0, rtol=0, atol=1e-12)


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def _counts():
    return (simplex_qp.LAUNCHES, simplex_qp.PACKED_LAUNCHES,
            simplex_qp.GROUPED_LAUNCHES, simplex_qp.UNPACKED_LAUNCHES)


@pytest.mark.parametrize("max_iterations", [3, 500])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", [6, 33])
@pytest.mark.parametrize("projection", ["michelot", "bisect"])
def test_packed_single_hessian_matches_jax(projection, k, masked,
                                           max_iterations):
    As, Bs, X0s = _problem(k, 1, N, k)
    mask = _mask(k, masked)
    kw = dict(max_iterations=max_iterations, mask=mask)
    want = np.asarray(quad_simplex_qp_pallas_packed(
        As[0], Bs[0], X0s[0], interpret=True, block_rows=BLOCK_ROWS,
        projection=projection, **kw))
    before = _counts()
    got = simplex_qp.quad_simplex_qp_packed(
        *_t(As[0], Bs[0], X0s[0]), projection=projection, **kw).numpy()
    assert _counts() == before
    if masked:
        assert np.all(got[:, ~mask] == 0.0)
    _assert_parity(got[None], want[None], As, Bs, max_iterations)


@pytest.mark.parametrize("max_iterations", [3, 500])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", [6, 70, 128])
def test_unpacked_grouped_matches_jax(k, masked, max_iterations):
    As, Bs, X0s = _problem(100 + k, 2, N, k)
    mask = _mask(k, masked)
    kw = dict(max_iterations=max_iterations, mask=mask)
    want = np.asarray(quad_simplex_qp_pallas_grouped(
        As, Bs, X0s, interpret=True, block_rows=BLOCK_ROWS, **kw))
    before = _counts()
    got = simplex_qp.quad_simplex_qp_grouped(*_t(As, Bs, X0s),
                                             **kw).numpy()
    assert _counts() == before
    if masked:
        assert np.all(got[:, :, ~mask] == 0.0)
    _assert_parity(got, want, As, Bs, max_iterations)


@pytest.mark.parametrize("max_iterations", [3, 500])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", [6, 70, 128])
def test_unpacked_single_hessian_matches_jax(k, masked, max_iterations):
    As, Bs, X0s = _problem(200 + k, 1, N, k)
    mask = _mask(k, masked)
    kw = dict(max_iterations=max_iterations, mask=mask)
    want = np.asarray(quad_simplex_qp_pallas(
        As[0], Bs[0], X0s[0], interpret=True, block_rows=BLOCK_ROWS, **kw))
    got = simplex_qp.quad_simplex_qp(*_t(As[0], Bs[0], X0s[0]),
                                     **kw).numpy()
    _assert_parity(got[None], want[None], As, Bs, max_iterations)


def test_unpacked_alpha0_in_range_matches_jax():
    As, Bs, X0s = _problem(7, 2, N, 70)
    want = np.asarray(quad_simplex_qp_pallas_grouped(
        As, Bs, X0s, interpret=True, block_rows=BLOCK_ROWS,
        max_iterations=3, alpha0=0.5))
    got = simplex_qp.quad_simplex_qp_grouped(
        *_t(As, Bs, X0s), max_iterations=3, alpha0=0.5).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_unpacked_plain_version_is_the_packed_loop_with_bisection():
    # One loop serves both plain versions: at k <= 64 with bisection
    # they are the same computation.
    As, Bs, X0s = _t(*_problem(8, 2, N, 20))
    a = simplex_qp.quad_simplex_qp_grouped_reference(As, Bs, X0s,
                                                     max_iterations=40)
    b = simplex_qp.quad_simplex_qp_packed_grouped_reference(
        As, Bs, X0s, projection="bisect", max_iterations=40)
    assert torch.equal(a, b)


def test_plain_version_counts_row_iterations():
    # Three rows start at the vertex their linear term pulls to: their
    # first step is D = 0, so they stop after one iteration.  The seven
    # others take 7 to 16 iterations uncapped, so the cap of 4 stops them.
    As, Bs, X0s = _problem(12, 2, 5, 6)
    for r, i in ((0, 0), (0, 3), (1, 1)):
        X0s[r, i] = np.eye(6)[i]
        Bs[r, i] = -100.0 * np.eye(6)[i]
    simplex_qp.PLAIN_ROW_ITERATIONS = 0
    simplex_qp.PLAIN_MAX_ROW_ITERATIONS = 0
    simplex_qp.quad_simplex_qp_grouped(*_t(As, Bs, X0s), max_iterations=4)
    assert simplex_qp.PLAIN_ROW_ITERATIONS == 3 * 1 + 7 * 4
    assert simplex_qp.PLAIN_MAX_ROW_ITERATIONS == 4
    assert simplex_qp.PLAIN_SLOWEST_ROW == (0, 1)
    # The most is kept over calls until it is set to 0 again.
    simplex_qp.quad_simplex_qp_grouped(*_t(As, Bs, X0s), max_iterations=2)
    assert simplex_qp.PLAIN_ROW_ITERATIONS == 31 + 3 * 1 + 7 * 2
    assert simplex_qp.PLAIN_MAX_ROW_ITERATIONS == 4
    assert simplex_qp.PLAIN_SLOWEST_ROW == (0, 1)


@pytest.mark.parametrize("call", ["packed_k65", "unpacked_k129",
                                  "packed_bad_rank", "unknown_argument",
                                  "unpacked_bad_projection"])
def test_wrappers_reject_what_the_kernels_do_not_take(call):
    def args(R, k):
        return _t(*_problem(9, R, 3, k))

    with pytest.raises((ValueError, TypeError)):
        if call == "packed_k65":
            simplex_qp.quad_simplex_qp_packed(*(a[0] for a in args(1, 65)))
        elif call == "unpacked_k129":
            simplex_qp.quad_simplex_qp_grouped(*args(1, 129))
        elif call == "packed_bad_rank":
            simplex_qp.quad_simplex_qp_packed(*args(1, 4))
        elif call == "unknown_argument":
            simplex_qp.quad_simplex_qp(*(a[0] for a in args(1, 4)),
                                       interpret=True)
        else:
            simplex_qp.quad_simplex_qp_grouped(*args(1, 4),
                                               projection="michelot")
