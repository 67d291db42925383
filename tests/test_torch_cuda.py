"""The grouped simplex-QP CUDA kernel against its plain version, on the
card.

Marked ``cuda``: the kernel has no CPU mode, so these tests skip where
no CUDA device is found.  tests/conftest.py imports JAX, which a GPU
machine need not have, so run them there without it::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

Tolerances: in float64 the kernel and the plain version (cuBLAS
products, tree reductions) agree to 1e-12 over the first iterations.
Once rows converge, near-ties in the projection's threshold and the
epsilon_two stop amplify rounding, so converged results are held to
the per-row objective, as in chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from convex_dim_red_tpu_torch import aa_fit_restarts
from convex_dim_red_tpu_torch.ops import simplex_qp

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _problem(seed, R, n, k, dtype, device):
    rng = np.random.RandomState(seed)
    M = rng.standard_normal((R, k, k))
    As = M @ M.transpose(0, 2, 1) + np.eye(k)
    Bs = rng.standard_normal((R, n, k))
    X0s = rng.uniform(size=(R, n, k))
    X0s /= X0s.sum(axis=2, keepdims=True)
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (As, Bs, X0s))


def _both(args, **kw):
    got = simplex_qp.quad_simplex_qp_packed_grouped(*args, **kw)
    want = simplex_qp.quad_simplex_qp_packed_grouped_reference(*args, **kw)
    torch.cuda.synchronize()
    return got, want


def _objective(X, As, Bs):
    X, As, Bs = (t.double() for t in (X, As, Bs))
    return (0.5 * torch.einsum('rij,rjk,rik->ri', X, As, X)
            + torch.sum(X * Bs, dim=2))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("projection", ["michelot", "bisect"])
@pytest.mark.parametrize("k", [1, 3, 8, 9, 16, 17, 32, 33, 64])
def test_first_iterations_match_plain(cuda, k, projection, masked):
    # Every KMAX template (8, 16, 32, 64) and the edges between them.
    args = _problem(k, 3, 257, k, torch.float64, cuda)
    mask = (np.arange(k) != k // 2) if masked and k > 1 else None
    got, want = _both(args, max_iterations=3, projection=projection,
                      mask=mask)
    assert float((got - want).abs().max()) <= 1e-12
    if mask is not None:
        assert bool((got[:, :, k // 2] == 0).all())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("projection", ["michelot", "bisect"])
def test_converged_main_path_shape_matches_plain(cuda, projection,
                                                 masked):
    # float32 at the fit's shape: 25 restarts x 1788 rows, k = 6.
    args = _problem(0, 25, 1788, 6, torch.float32, cuda)
    mask = (np.arange(6) != 3) if masked else None
    got, want = _both(args, max_iterations=1000, projection=projection,
                      mask=mask)
    f_got, f_want = _objective(got, *args[:2]), _objective(want, *args[:2])
    assert float(((f_got - f_want).abs() / (1 + f_want.abs())).max()) <= 1e-5
    assert float((got.double().sum(dim=2) - 1).abs().max()) <= 1e-5
    assert float(got.min()) >= 0.0
    if masked:
        assert bool((got[:, :, 3] == 0).all())


def test_launches_are_counted(cuda):
    args = _problem(1, 2, 100, 4, torch.float32, cuda)
    before = simplex_qp.LAUNCHES
    simplex_qp.quad_simplex_qp_packed_grouped(*args, max_iterations=5)
    simplex_qp.quad_simplex_qp_packed_grouped_reference(*args,
                                                        max_iterations=5)
    torch.cuda.synchronize()
    assert simplex_qp.LAUNCHES == before + 1


def test_rejects_non_contiguous(cuda):
    As, Bs, X0s = _problem(2, 2, 100, 4, torch.float32, cuda)
    with pytest.raises(ValueError):
        simplex_qp.quad_simplex_qp_packed_grouped(
            As, Bs.transpose(0, 1).contiguous().transpose(0, 1), X0s)


def _planted(seed, n, d, k, noise):
    rng = np.random.RandomState(seed)
    basis = rng.uniform(size=(k, d))
    Z = rng.uniform(size=(n, k))
    Z /= Z.sum(axis=1, keepdims=True)
    for comp, i in enumerate(rng.choice(n, size=k, replace=False)):
        Z[i] = 0.0
        Z[i, comp] = 1.0
    return Z @ basis + noise * rng.standard_normal((n, d))


def test_fit_on_card_matches_cpu(cuda):
    # The same float64 fit from the same initial states (a CPU
    # generator draws them on both devices).  Planted archetypes keep
    # the fit well conditioned, so rounding differences between the
    # devices decay instead of growing (on Gaussian data they reach
    # 1e-6 in the cost by the iteration cap).
    X = torch.as_tensor(_planted(0, 300, 40, 6, 0.01))
    kw = dict(init='random', tolerance=1e-6, max_iterations=200,
              stopping_criterion='rel_delta_f',
              dictionary_solver_kwargs={'max_iterations': 1},
              weights_solver_kwargs={'max_iterations': 25},
              restart_chunk=4, compact_iterations=32)
    res = {dev: aa_fit_restarts(X.to(dev), 6,
                                torch.Generator().manual_seed(0), 8, **kw)
           for dev in (cuda, "cpu")}
    np.testing.assert_allclose(res[cuda]["costs"], res["cpu"]["costs"],
                               rtol=1e-6)
    np.testing.assert_array_equal(res[cuda]["n_iters"],
                                  res["cpu"]["n_iters"])
