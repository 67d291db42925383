"""The grouped simplex-QP kernel's plain version against the JAX
package's Pallas kernel (``interpret=True``), float64.

Tolerances: the two run the same algorithm but sum in another order
(the Pallas kernel sums segments with a matmul), so over the first few
iterations they agree to 1e-12.  Once rows converge, near-ties in the
projection's threshold and the epsilon_two = 1e-6 stop (a row that
rounds to one more or one fewer step) amplify that rounding to about
1e-8 in x, while the per-row objective still agrees to 1e-12 relative.

The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py
holds it against this plain version there.
"""

import numpy as np
import pytest
import torch

from convex_dim_red_tpu.ops.pallas_qp import (
    quad_simplex_qp_pallas_packed_grouped)
from convex_dim_red_tpu_torch.ops import simplex_qp
from convex_dim_red_tpu_torch.ops.simplex_qp import (
    quad_simplex_qp_packed_grouped,
    quad_simplex_qp_packed_grouped_reference)
from convex_dim_red_tpu_torch.solvers.spg import (
    quad_simplex_spg_batch_grouped)

# Small tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores.
torch.set_num_threads(1)

CASES = [(3, 33, 3), (2, 40, 6), (2, 20, 11)]
PROJECTIONS = ["michelot", "bisect"]


def _problem(seed, R, n, k, scale=1.0):
    rng = np.random.RandomState(seed)
    M = rng.standard_normal((R, k, k))
    As = M @ M.transpose(0, 2, 1) + np.eye(k)
    Bs = scale * rng.standard_normal((R, n, k))
    X0s = rng.uniform(size=(R, n, k))
    X0s /= X0s.sum(axis=2, keepdims=True)
    return As, Bs, X0s


def _obj(X, A, B):
    return (0.5 * np.einsum('rij,rjk,rik->ri', X, A, X)
            + np.sum(X * B, axis=2))


def _both(As, Bs, X0s, **kw):
    want = np.asarray(quad_simplex_qp_pallas_packed_grouped(
        As, Bs, X0s, interpret=True, **kw))
    got = quad_simplex_qp_packed_grouped(
        *(torch.as_tensor(v) for v in (As, Bs, X0s)), **kw).numpy()
    return got, want


def _assert_converged_parity(got, want, As, Bs):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)
    f_got, f_want = _obj(got, As, Bs), _obj(want, As, Bs)
    rel = np.abs(f_got - f_want) / np.maximum(1.0, np.abs(f_want))
    assert rel.max() <= 1e-12


@pytest.mark.parametrize("projection", PROJECTIONS)
@pytest.mark.parametrize("R,n,k", CASES)
def test_first_iterations_match_jax(R, n, k, projection):
    As, Bs, X0s = _problem(0, R, n, k)
    got, want = _both(As, Bs, X0s, max_iterations=3, projection=projection)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("projection", PROJECTIONS)
@pytest.mark.parametrize("R,n,k", CASES)
def test_converged_matches_jax(R, n, k, projection):
    As, Bs, X0s = _problem(1, R, n, k)
    got, want = _both(As, Bs, X0s, max_iterations=500,
                      projection=projection)
    _assert_converged_parity(got, want, As, Bs)
    np.testing.assert_allclose(got.sum(axis=2), 1.0, rtol=0, atol=1e-12)


@pytest.mark.parametrize("projection", PROJECTIONS)
def test_masked_matches_jax(projection):
    R, n, k = 2, 40, 6
    As, Bs, X0s = _problem(2, R, n, k)
    mask = np.arange(k) != 2
    got, want = _both(As, Bs, X0s, max_iterations=500, mask=mask,
                      projection=projection)
    assert np.all(got[:, :, 2] == 0.0)
    _assert_converged_parity(got, want, As, Bs)


@pytest.mark.parametrize("max_iterations", [3, 500])
def test_alpha0_in_range_matches_jax(max_iterations):
    As, Bs, X0s = _problem(3, 3, 33, 3)
    got, want = _both(As, Bs, X0s, max_iterations=max_iterations,
                      alpha0=0.5)
    if max_iterations == 3:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    else:
        _assert_converged_parity(got, want, As, Bs)


def test_michelot_rows_on_the_simplex():
    As, Bs, X0s = _problem(4, 2, 50, 7, scale=10.0)
    X = quad_simplex_qp_packed_grouped_reference(
        *(torch.as_tensor(v) for v in (As, Bs, X0s)), max_iterations=200)
    np.testing.assert_allclose(X.sum(dim=2).numpy(), 1.0, rtol=0,
                               atol=1e-12)
    assert X.min().item() >= 0.0


def test_rows_do_not_depend_on_their_neighbours():
    # A converged row is frozen, so solving a subset of the rows gives
    # the same rows: what lets the kernel stop each row on its own.  The
    # batched matmul rounds differently for another batch shape, and
    # convergence amplifies that as in the module docstring.
    As, Bs, X0s = _problem(5, 2, 37, 5)
    t = [torch.as_tensor(v) for v in (As, Bs, X0s)]
    full = quad_simplex_qp_packed_grouped_reference(*t, max_iterations=300)
    sub = quad_simplex_qp_packed_grouped_reference(
        t[0], t[1][:, 3:9].contiguous(), t[2][:, 3:9].contiguous(),
        max_iterations=300)
    np.testing.assert_allclose(full[:, 3:9].numpy(), sub.numpy(), rtol=0,
                               atol=1e-8)


def _bad(name):
    k = 65 if name == "k_too_large" else 4
    As = torch.eye(k, dtype=torch.float64)[None]
    Bs = torch.zeros((1, 3, k), dtype=torch.float64)
    X0s = torch.full((1, 3, k), 1.0 / k, dtype=torch.float64)
    kw = {}
    if name == "mixed_dtypes":
        Bs = Bs.float()
    elif name == "integer_dtype":
        As, Bs, X0s = As.long(), Bs.long(), X0s.long()
    elif name == "bad_shape":
        As = As[:, :3]
    elif name == "bad_projection":
        kw["projection"] = "sort"
    elif name == "empty_mask":
        kw["mask"] = np.zeros(k, bool)
    elif name == "bad_mask_shape":
        kw["mask"] = np.ones(k + 1, bool)
    return (As, Bs, X0s), kw


@pytest.mark.parametrize("name", [
    "k_too_large", "mixed_dtypes", "integer_dtype", "bad_shape",
    "bad_projection", "empty_mask", "bad_mask_shape"])
def test_rejects_what_the_kernel_does_not_take(name):
    args, kw = _bad(name)
    with pytest.raises(ValueError):
        quad_simplex_qp_packed_grouped(*args, **kw)


def test_cpu_tensors_take_the_plain_version_without_counting():
    As, Bs, X0s = (torch.as_tensor(v) for v in _problem(6, 2, 9, 4))
    before = simplex_qp.LAUNCHES
    got = quad_simplex_qp_packed_grouped(As, Bs, X0s, max_iterations=50)
    want = quad_simplex_qp_packed_grouped_reference(As, Bs, X0s,
                                                    max_iterations=50)
    assert simplex_qp.LAUNCHES == before
    assert torch.equal(got, want)


def test_dispatch_backends():
    As, Bs, X0s = (torch.as_tensor(v) for v in _problem(7, 2, 9, 4))
    for backend in ("auto", "pallas"):
        out = quad_simplex_spg_batch_grouped(As, Bs, X0s, backend=backend,
                                             max_iterations=40)
        assert torch.equal(out, quad_simplex_qp_packed_grouped_reference(
            As, Bs, X0s, max_iterations=40))
    with pytest.raises(NotImplementedError):
        quad_simplex_spg_batch_grouped(As, Bs, X0s, backend="xla")
    with pytest.raises(ValueError):
        quad_simplex_spg_batch_grouped(As, Bs, X0s, backend="tpu")
    As, Bs, X0s = (torch.as_tensor(v) for v in _problem(8, 1, 3, 65))
    with pytest.raises(NotImplementedError):
        quad_simplex_spg_batch_grouped(As, Bs, X0s)

