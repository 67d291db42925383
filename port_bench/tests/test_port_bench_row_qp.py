"""The frozen plain row solver gives the port's plain version's
solution and iterations on small seeded problems, in float64."""

import pytest
import torch

from port_bench.reference import row_qp


def problem(seed, R, n, k):
    g = torch.Generator().manual_seed(seed)
    M = torch.randn(R, k, k, generator=g, dtype=torch.float64)
    A = M @ M.transpose(1, 2) + 0.1 * torch.eye(k, dtype=torch.float64)
    B = torch.randn(R, n, k, generator=g, dtype=torch.float64)
    X0 = torch.rand(R, n, k, generator=g, dtype=torch.float64)
    return A, B, X0 / X0.sum(-1, keepdim=True)


@pytest.mark.parametrize("projection", ["michelot", "bisect"])
@pytest.mark.parametrize("seed,R,n,k,masked,cap", [
    (0, 3, 17, 6, False, 1000), (1, 2, 9, 4, True, 1000),
    (2, 4, 11, 5, False, 1), (3, 1, 30, 8, False, 25)])
def test_frozen_row_solver_is_the_plain_version(projection, seed, R, n, k,
                                                masked, cap):
    from convex_dim_red_tpu_torch.ops import simplex_qp
    A, B, X0 = problem(seed, R, n, k)
    mask = torch.arange(k) < k - 1 if masked else None
    simplex_qp.PLAIN_ROW_ITERATIONS = 0
    want = simplex_qp.quad_simplex_qp_packed_grouped_reference(
        A, B, X0, mask=mask, projection=projection, max_iterations=cap)
    got, iterations = row_qp.solve(A, B, X0, mask=mask,
                                   projection=projection,
                                   max_iterations=cap)
    assert torch.equal(got, want)
    assert int(iterations.sum()) == simplex_qp.PLAIN_ROW_ITERATIONS


def test_unknown_solver_argument_raises():
    A, B, X0 = problem(0, 1, 2, 3)
    with pytest.raises(TypeError):
        row_qp.solve(A, B, X0, tolerance=1e-3)
