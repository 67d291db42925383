"""The port's FurthestSum against the JAX package's: equal indices from
the host and the device versions, equal error messages, and the
dissimilarities from a Gram matrix to 1e-12 (float64)."""

import jax
import numpy as np
import pytest
import torch

from convex_dim_red_tpu.ops import furthest_sum as jfs
from convex_dim_red_tpu_torch.ops import furthest_sum as tfs

# Small tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores.
torch.set_num_threads(1)


def _points(seed, n=60, d=5):
    return np.random.RandomState(seed).standard_normal((n, d))


def _diss(X):
    return np.sqrt(np.maximum(
        np.sum((X[:, None, :] - X[None, :, :]) ** 2, axis=2), 0.0))


def test_dissimilarities_from_kernel_match_jax():
    X = _points(0)
    K = X @ X.T
    want = np.asarray(jfs.dissimilarities_from_kernel(K))
    got = tfs.dissimilarities_from_kernel(torch.as_tensor(K)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, _diss(X), rtol=0, atol=1e-10)


@pytest.mark.parametrize("extra_steps", [0, 1, 10])
@pytest.mark.parametrize("n_components", [1, 4, 9])
def test_host_matches_jax(n_components, extra_steps):
    d = _diss(_points(1))
    for start in (0, 17, 59):
        want = jfs.furthest_sum(d, n_components, start,
                                extra_steps=extra_steps)
        got = tfs.furthest_sum(torch.as_tensor(d), n_components, start,
                               extra_steps=extra_steps)
        np.testing.assert_array_equal(got, want)


def test_host_with_exclusions_matches_jax():
    d = _diss(_points(2))
    exclude = [3, 8, 40]
    want = jfs.furthest_sum(d, 5, 10, exclude=exclude, extra_steps=7)
    got = tfs.furthest_sum(d, 5, 10, exclude=exclude, extra_steps=7)
    np.testing.assert_array_equal(got, want)
    assert not set(got.tolist()) & set(exclude)


@pytest.mark.parametrize("args", [
    dict(d=np.zeros((3, 4)), n_components=1, start=0),
    dict(d=np.zeros((3, 3)), n_components=1, start=3),
    dict(d=np.zeros((3, 3)), n_components=1, start=1, exclude=[1]),
    dict(d=np.zeros((3, 3)), n_components=3, start=0, exclude=[2])])
def test_host_error_messages_match_jax(args):
    call = dict(exclude=args.get('exclude'))
    with pytest.raises(ValueError) as want:
        jfs.furthest_sum(args['d'], args['n_components'], args['start'],
                         **call)
    with pytest.raises(ValueError) as got:
        tfs.furthest_sum(args['d'], args['n_components'], args['start'],
                         **call)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("extra_steps", [0, 10])
@pytest.mark.parametrize("n_components", [2, 6])
def test_device_matches_jax_over_a_restart_axis(n_components, extra_steps):
    d = _diss(_points(3, n=80))
    starts = np.array([0, 5, 33, 79, 5])
    want = np.asarray(jax.vmap(
        lambda s: jfs.furthest_sum_device(d, n_components, s,
                                          extra_steps=extra_steps))(
        starts))
    got = tfs.furthest_sum_device(torch.as_tensor(d), n_components,
                                  torch.as_tensor(starts),
                                  extra_steps=extra_steps)
    assert got.shape == (5, n_components)
    np.testing.assert_array_equal(got.numpy(), want)
    for i, s in enumerate(starts):
        one = tfs.furthest_sum_device(torch.as_tensor(d), n_components,
                                      int(s), extra_steps=extra_steps)
        np.testing.assert_array_equal(one.numpy(), want[i])
        np.testing.assert_array_equal(
            one.numpy(), tfs.furthest_sum(d, n_components, int(s),
                                          extra_steps=extra_steps))


def test_device_exclude_mask_matches_jax():
    d = _diss(_points(4, n=30))
    mask = np.zeros(30, bool)
    mask[[2, 11, 12]] = True
    want = np.asarray(jfs.furthest_sum_device(d, 4, 0, extra_steps=3,
                                              exclude_mask=mask))
    got = tfs.furthest_sum_device(torch.as_tensor(d), 4, 0, extra_steps=3,
                                  exclude_mask=torch.as_tensor(mask))
    np.testing.assert_array_equal(got.numpy(), want)


def test_device_takes_the_first_maximum_on_ties():
    # Four corners of a square: every candidate ties.
    pts = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    d = _diss(pts)
    want = np.asarray(jfs.furthest_sum_device(d, 3, 1, extra_steps=2))
    got = tfs.furthest_sum_device(torch.as_tensor(d), 3, 1, extra_steps=2)
    np.testing.assert_array_equal(got.numpy(), want)
