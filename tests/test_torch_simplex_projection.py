"""The port's simplex projections against the JAX package's, float64.

Both take the same numpy inputs; the sort + cumsum threshold is the
same arithmetic, so they agree to rounding (1e-14).
"""

import numpy as np
import pytest
import torch

from convex_dim_red_tpu.ops import simplex_projection as jsp
from convex_dim_red_tpu_torch.ops import simplex_projection as tsp

# Small tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores.
torch.set_num_threads(1)

ATOL = 1e-14


def _inputs(seed, shape, scale=3.0):
    return scale * np.random.RandomState(seed).standard_normal(shape)


@pytest.mark.parametrize("shape,axis", [
    ((7,), -1), ((5, 9), -1), ((5, 9), 0), ((2, 4, 6), 1), ((3, 1), -1),
])
def test_simplex_project_matches_jax(shape, axis):
    x = _inputs(0, shape)
    want = np.asarray(jsp.simplex_project(x, axis=axis))
    got = tsp.simplex_project(torch.as_tensor(x), dim=axis).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.sum(axis=axis), 1.0, rtol=0, atol=ATOL)


def test_simplex_project_scalar_is_one():
    got = tsp.simplex_project(torch.tensor(-4.0, dtype=torch.float64))
    assert got.item() == 1.0


@pytest.mark.parametrize("name", ["rows", "columns", "vector"])
def test_wrappers_match_jax(name):
    x = _inputs(1, (8,) if name == "vector" else (6, 10))
    fn = "simplex_project_" + name
    want = np.asarray(getattr(jsp, fn)(x))
    got = getattr(tsp, fn)(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_rows_batched_over_restarts():
    # The port projects a leading restart axis in one call, as the JAX
    # package does under vmap.
    x = _inputs(2, (4, 3, 11))
    want = np.stack([np.asarray(jsp.simplex_project_rows(xi)) for xi in x])
    got = tsp.simplex_project_rows(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("axis", [-1, 0])
def test_masked_matches_jax(axis):
    x = _inputs(3, (6, 7))
    n = x.shape[axis]
    mask = np.arange(n) % 3 != 1
    mask_b = mask if axis == -1 else mask[:, None]
    want = np.asarray(jsp.simplex_project_masked(x, mask_b, axis=axis))
    got = tsp.simplex_project_masked(torch.as_tensor(x),
                                     torch.as_tensor(mask_b),
                                     dim=axis).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.all(np.where(mask_b, 0.0, got) == 0.0)
