"""K5, the fused AA residual cost (``ops/residual_cost.py``,
``csrc/residual_cost.cu``), and its place in the AA iterate.

On the CPU: the plain version is the former inline cost of
``sharded_aa._aa_iter_cost`` bit for bit and a float64 sum of squares;
the wrapper's checks; the launch counter.

Marked ``cuda`` (the kernel has no CPU mode; they skip without a card):
K5 against its plain version in float64 on the card, its bits run after
run, its checks, its launch count, the memory it does not take, and a
fit whose every residual-form cost goes through it.  This file imports
no JAX; run the card's tests with::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_residual_cost.py

Tolerances on the card, against the plain version in float64 from the
same inputs, relative to ``sum_ij (|x_ij| + sum_c |z_ic alpha_c
cx_cj|)^2``, the size of the terms (where the residual is much smaller
than its terms, any float32 sum of them loses digits to cancellation,
relative to the terms and not to the residual): 1e-6 in float32 (k + 1
roundings of about 6e-8 an element, of random sign, in each residual,
then its square and the thread's sum of 64 squares), 1e-12 in float64
(the same at 1.1e-16).
"""

import numpy as np
import pytest
import torch

from convex_dim_red_tpu_torch import aa_fit_restarts
from convex_dim_red_tpu_torch.ops import residual_cost, simplex_qp
from convex_dim_red_tpu_torch.parallel import restarts, sharded_aa
from convex_dim_red_tpu_torch.utils import profiling

torch.set_num_threads(1)

RTOL = {torch.float32: 1e-6, torch.float64: 1e-12}


def _operands(seed, R, n, d, k, dtype, device="cpu"):
    """X (n, d) and CX (R, k, d) standard normal, Z (R, n, k) on the
    simplex, alpha (R, k) in [0.9, 1.1]."""
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, d))
    Z = rng.uniform(size=(R, n, k))
    Z /= Z.sum(axis=2, keepdims=True)
    CX = rng.standard_normal((R, k, d))
    alpha = rng.uniform(0.9, 1.1, size=(R, k))
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (X, Z, CX, alpha))


def _former_cost(X, Z, C, alpha):
    """``sharded_aa._aa_iter_cost``'s residual form as it was written
    inline, on one device."""
    CX = C @ X
    resid = Z @ (alpha[:, :, None] * CX)
    resid -= X
    resid.square_()
    return 0.5 * torch.sum(resid, dim=(1, 2)) / C.shape[-1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 6])
@pytest.mark.parametrize("R", [1, 3])
def test_cost_on_the_cpu_is_the_former_inline_cost(R, k, dtype):
    n, d = 37, 23
    X, Z, _, alpha = _operands(R + 10 * k, R, n, d, k, dtype)
    rng = np.random.RandomState(k)
    C = torch.as_tensor(rng.dirichlet(np.ones(n), size=(R, k)), dtype=dtype)
    before = residual_cost.LAUNCHES
    got = sharded_aa._aa_iter_cost(X, Z, C, alpha, None, None, None,
                                   sharded_aa._Shard(device="cpu"))
    assert torch.equal(got, _former_cost(X, Z, C, alpha))
    assert residual_cost.LAUNCHES == before


@pytest.mark.parametrize("R,n,d,k", [(1, 1, 1, 1), (3, 40, 17, 6),
                                     (2, 9, 130, 20)])
def test_plain_version_is_a_float64_sum_of_squares(R, n, d, k):
    X, Z, CX, alpha = _operands(n + k, R, n, d, k, torch.float64)
    Xn, Zn, CXn, an = (t.numpy() for t in (X, Z, CX, alpha))
    want = np.array([np.sum((Zn[r] @ (an[r][:, None] * CXn[r]) - Xn) ** 2)
                     for r in range(R)])
    for got in (residual_cost.residual_sq_sums(X, Z, CX, alpha),
                residual_cost.residual_sq_sums_reference(X, Z, CX, alpha)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-13)


def _shapes(R=2, n=5, d=7, k=3):
    return {"X": (n, d), "Z": (R, n, k), "CX": (R, k, d), "alpha": (R, k)}


@pytest.mark.parametrize("bad", [
    {"X": (5,)}, {"Z": (5, 3)}, {"X": (6, 7)}, {"X": (5, 8)},
    {"CX": (2, 4, 7)}, {"CX": (3, 3, 7)}, {"alpha": (2, 4)},
    {"alpha": (1, 3)}, {"Z": (3, 5, 3)}])
def test_wrapper_rejects_bad_shapes(bad):
    shapes = dict(_shapes(), **bad)
    args = [torch.zeros(shapes[name]) for name in ("X", "Z", "CX", "alpha")]
    with pytest.raises(ValueError, match="must be"):
        residual_cost.residual_sq_sums(*args)


def test_wrapper_rejects_mixed_dtypes_devices_and_other_devices():
    args = [torch.zeros(s) for s in _shapes().values()]
    with pytest.raises(ValueError, match="one dtype"):
        residual_cost.residual_sq_sums(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="one dtype"):
        residual_cost.residual_sq_sums(*(a.half() for a in args))
    with pytest.raises(ValueError, match="one device"):
        residual_cost.residual_sq_sums(args[0].to("meta"), *args[1:])
    with pytest.raises(ValueError, match="CUDA tensors"):
        residual_cost.residual_sq_sums(*(a.to("meta") for a in args))


def test_counters_snapshot_reads_k5_launches():
    assert (profiling.counters()["COST_LAUNCHES"]
            == residual_cost.LAUNCHES)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _scale(X, Z, CX, alpha):
    """``sum_ij (|x_ij| + sum_c |z_ic alpha_c cx_cj|)^2`` per restart,
    in float64: the size of the terms of each residual."""
    X, Z, CX, alpha = (t.double() for t in (X, Z, CX, alpha))
    terms = Z.abs() @ (alpha.abs()[:, :, None] * CX.abs()) + X.abs()
    return torch.sum(terms * terms, dim=(1, 2))


def _against_float64(args):
    got = residual_cost.residual_sq_sums(*args)
    want = residual_cost.residual_sq_sums_reference(
        *(t.double() for t in args))
    torch.cuda.synchronize()
    return (got.double() - want).abs() / _scale(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,d", [(1, 1), (733, 167), (300, 5003)])
@pytest.mark.parametrize("k", [1, 2, 6, 20, 64, 96, 130])
@pytest.mark.parametrize("R", [1, 25, 100])
def test_k5_matches_plain_in_float64(cuda, R, k, n, d, dtype):
    # n and d are no multiple of a tile (128 in float32, 64 in float64),
    # and k of no chunk of 8 but at k = 64; R = 100 at the small shapes
    # splits the restarts into groups.
    args = _operands(R * 1000 + k, R, n, d, k, dtype, cuda)
    err = float(_against_float64(args).max())
    assert err <= RTOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k5_at_the_main_path_shape(cuda, dtype):
    args = _operands(6, 25, 1788, 24030, 6, dtype, cuda)
    assert float(_against_float64(args).max()) <= RTOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("R,n,d,k", [(25, 733, 167, 6), (100, 1, 1, 130),
                                     (3, 300, 5003, 20)])
def test_k5_gives_the_same_bits_every_launch(cuda, R, n, d, k, dtype):
    args = _operands(k, R, n, d, k, dtype, cuda)
    first = residual_cost.residual_sq_sums(*args)
    second = residual_cost.residual_sq_sums(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_k5_rejects_what_it_does_not_take(cuda):
    X, Z, CX, alpha = _operands(1, 2, 50, 40, 3, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        residual_cost.residual_sq_sums(X.T.contiguous().T, Z, CX, alpha)
    with pytest.raises(ValueError, match="contiguous"):
        residual_cost.residual_sq_sums(X, Z, CX, alpha.T.contiguous().T)
    with pytest.raises(ValueError, match="one device"):
        residual_cost.residual_sq_sums(X, Z.cpu(), CX, alpha)
    with pytest.raises(ValueError, match="one dtype"):
        residual_cost.residual_sq_sums(X, Z, CX.double(), alpha)


@pytest.mark.cuda
def test_k5_counts_one_launch_a_call(cuda):
    args = _operands(2, 4, 100, 300, 6, torch.float32, cuda)
    before = profiling.counters()["COST_LAUNCHES"]
    for _ in range(3):
        residual_cost.residual_sq_sums(*args)
    torch.cuda.synchronize()
    assert profiling.counters()["COST_LAUNCHES"] - before == 3


@pytest.mark.cuda
def test_k5_forms_no_residual(cuda):
    R, n, d, k = 25, 1788, 24030, 6
    args = _operands(3, R, n, d, k, torch.float32, cuda)
    residual_cost.residual_sq_sums(*args)  # builds and loads the library
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    residual_cost.residual_sq_sums(*args)
    torch.cuda.synchronize()
    # The partial sums (R x 2632 doubles) and the result; the residual
    # would be R n d x 4 B = 4.3 GB.
    assert torch.cuda.max_memory_allocated() - base < 16 * 2 ** 20


@pytest.mark.cuda
def test_every_cost_of_a_fit_on_the_card_is_a_k5_launch(cuda, monkeypatch):
    loops = []
    real = restarts._keep_best_loop

    def counting(*a, **kw):
        loops.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(restarts, "_keep_best_loop", counting)
    rng = np.random.RandomState(0)
    X = torch.as_tensor(rng.standard_normal((120, 30)), dtype=torch.float32,
                        device=cuda)
    before = (residual_cost.LAUNCHES, simplex_qp.LAUNCHES)
    aa_fit_restarts(X, 4, 0, 10, init='random', max_iterations=40,
                    restart_chunk=4, compact_iterations=8)
    torch.cuda.synchronize()
    cost_launches = residual_cost.LAUNCHES - before[0]
    k1_launches = simplex_qp.LAUNCHES - before[1]
    # One cost an iteration (an iteration launches K1 once) and one for
    # the initial states of each round.
    assert k1_launches > 0 and loops
    assert cost_launches == k1_launches + len(loops)
