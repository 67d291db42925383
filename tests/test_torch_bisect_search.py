"""The threshold search of the K3/K4 kernel (csrc/simplex_qp_unpacked.cu)
against one halving at a time, on the CPU.

The kernel takes the bisection's halvings two at a time: it sums
``max(y - t, 0)`` at the three midpoints that the sequential bisection
could visit in its next two steps, each computed as that bisection
computes it, and walks the decision tree over those sums.
``ops/simplex_qp.py:_bisect_threshold_search`` is that search in
PyTorch; here it is held to ``_project(x, mask, 'bisect', k, steps)``
(the plain versions' bisection, which the K3 parity tests of
tests/test_torch_qp_kernels.py hold to the JAX package) bit for bit, at
26 halvings in float32 and 52 in float64.
"""

import numpy as np
import pytest
import torch

from convex_dim_red_tpu_torch.ops import simplex_qp

torch.set_num_threads(1)


def _rows(k, seed):
    """Rows of every kind the projection meets: Gaussian at three
    scales, tied maxima, rows already on the simplex (interior and
    vertices), rows far above and far below it, and a constant row."""
    rng = np.random.RandomState(seed)
    rows = [rng.standard_normal(k) * s for s in (1e-3, 1.0, 30.0)]
    for ties in (2, 3):
        row = rng.standard_normal(k)
        row[rng.choice(k, size=min(ties, k), replace=False)] = 2.5
        rows.append(row)
    inside = rng.uniform(size=k)
    rows.append(inside / inside.sum())
    rows.append(np.eye(k)[rng.randint(k)])
    rows.append(np.full(k, 1.0 / k))
    rows.append(1e3 * rng.uniform(size=k) + 100.0)
    rows.append(-1e3 * rng.uniform(size=k) - 100.0)
    rows.append(np.full(k, 7.0))
    return np.stack(rows)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", [1, 2, 31, 33, 96, 128])
def test_threshold_search_equals_one_halving_at_a_time(k, masked, dtype):
    x = torch.as_tensor(_rows(k, k), dtype=dtype)
    if masked and k > 1:
        mask = torch.as_tensor(np.arange(k) % 3 != 1)
    else:
        mask = torch.ones(k, dtype=torch.bool)
    steps = simplex_qp._bisect_steps(dtype)
    want = simplex_qp._project(x, mask, "bisect", k, steps)
    got = simplex_qp._bisect_threshold_search(x, mask, steps)
    assert torch.equal(got, want)
    assert bool((got[:, ~mask] == 0).all())
