"""The simplex-QP CUDA kernels against their plain versions, on the
card: K1 and K2 (csrc/simplex_qp.cu), K3 and K4
(csrc/simplex_qp_unpacked.cu), and the K3/K4 kernel's scheduling of
rows (the same bits whatever warp solves a row); then the paths that
run them against the CPU: a GPNH fit on K2, PCA, the restart fits'
default rounds (``compact_iterations=None``) against shorter ones for
AA and GPNH (K1), and padded (masked K1) and screened restart fits;
k-means' Lloyd iterations against the CPU, and the case-study drivers'
transform on K2.

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

from convex_dim_red_tpu_torch import (PCA, GPNHConvexCoding,
                                      aa_fit_restarts, gpnh_fit_restarts)
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


@pytest.mark.parametrize("R,n", [(3, 257), (1, 1), (1, 31), (3, 33),
                                 (1, 257)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("projection", ["michelot", "bisect"])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8, 9, 16, 17, 32, 33, 64])
def test_first_iterations_match_plain(cuda, k, projection, masked, R, n):
    # Both ends of every (team width, coordinates a lane) pair of the
    # rule simplex_qp.team_width, one group or three, and row counts
    # that leave the last block's teams partly past n.
    args = _problem(k, R, n, k, torch.float64, cuda)
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


def _mixed_rows(seed, n, k):
    """One group whose even rows converge after 1 or 2 iterations
    (started at or near the vertex that their linear term pulls to) and
    whose odd rows take 125-430 in the plain version at k = 6 and 20
    (an optimum inside the simplex, a Hessian with eigenvalues from 0.1
    to 10)."""
    rng = np.random.RandomState(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((k, k)))
    A = (Q * np.logspace(-1, 1, k)) @ Q.T
    inside = rng.uniform(size=(n, k))
    inside /= inside.sum(axis=1, keepdims=True)
    B = -(inside @ A) + rng.standard_normal((n, 1))
    X0 = np.full((n, k), 1.0 / k)
    for i in range(0, n, 2):
        j = i % k
        B[i] = 0.0
        B[i, j] = -100.0
        X0[i] = 0.0 if i % 4 == 0 else 0.5 / (k - 1)
        X0[i, j] = 1.0 if i % 4 == 0 else 0.5
    return A[None], B[None], X0[None]


@pytest.mark.parametrize("projection", ["michelot", "bisect"])
@pytest.mark.parametrize("k", [6, 20])
def test_rows_do_not_depend_on_their_neighbours(cuda, k, projection):
    # Teams of one warp leave their loops at different iterations; each
    # row's result is the one it gets alone, bit for bit.
    A, B, X0 = (torch.as_tensor(a, device=cuda)
                for a in _mixed_rows(k, 70, k))
    kw = dict(projection=projection, max_iterations=1000)
    together = simplex_qp.quad_simplex_qp_packed_grouped(A, B, X0, **kw)
    for i in range(B.shape[1]):
        alone = simplex_qp.quad_simplex_qp_packed_grouped(
            A, B[:, i:i + 1].contiguous(), X0[:, i:i + 1].contiguous(), **kw)
        assert torch.equal(alone, together[:, i:i + 1]), i
    # Half the rows are slow: over 50 iterations a row on average (the
    # plain version's row-iterations over rows).
    before = simplex_qp.PLAIN_ROW_ITERATIONS
    simplex_qp.quad_simplex_qp_packed_grouped_reference(A, B, X0, **kw)
    assert simplex_qp.PLAIN_ROW_ITERATIONS - before > 50 * B.shape[1]


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


#: The small float64 fit of the card-against-CPU tests.  backend='pallas'
#: on both devices: 'auto' resolves to the row solver on the CPU, which
#: stops on another rule.
_SMALL_FIT = dict(init='random', tolerance=1e-6, max_iterations=200,
                  stopping_criterion='rel_delta_f',
                  dictionary_solver_kwargs={'max_iterations': 1},
                  weights_solver_kwargs={'max_iterations': 25,
                                         'backend': 'pallas'},
                  restart_chunk=4, compact_iterations=32)


def _small_fit(device):
    return aa_fit_restarts(
        torch.as_tensor(_planted(0, 300, 40, 6, 0.01), device=device), 6,
        torch.Generator().manual_seed(0), 8, **_SMALL_FIT)


def test_fit_on_card_matches_cpu(cuda):
    # The same float64 fit from the same initial states (a CPU
    # generator draws them on both devices).  Planted archetypes keep
    # the fit well conditioned, so rounding differences between the
    # devices decay instead of growing (on Gaussian data they reach
    # 1e-6 in the cost by the iteration cap).
    res = {dev: _small_fit(dev) for dev in (cuda, "cpu")}
    np.testing.assert_allclose(res[cuda]["costs"], res["cpu"]["costs"],
                               rtol=1e-6)
    np.testing.assert_array_equal(res[cuda]["n_iters"],
                                  res["cpu"]["n_iters"])


def test_scale_relaxed_fit_on_card_matches_cpu(cuda):
    """The small float64 fit with scale factors (delta = 0.1) from the
    same states on the card (K1) and on the CPU (its plain version), as
    chip_smoke.py phase 25 holds it: costs within 1e-6 relative, the
    winner's alpha within 1e-6 and inside its box, K1 launched on the
    card."""
    before = simplex_qp.LAUNCHES
    res = {dev: aa_fit_restarts(
        torch.as_tensor(_planted(0, 300, 40, 6, 0.01), device=dev), 6,
        torch.Generator().manual_seed(0), 8, delta=0.1, **_SMALL_FIT)
        for dev in (cuda, "cpu")}
    assert simplex_qp.LAUNCHES > before
    np.testing.assert_allclose(res[cuda]["costs"], res["cpu"]["costs"],
                               rtol=1e-6)
    alpha = res[cuda]["alpha"].cpu()
    np.testing.assert_allclose(alpha.numpy(), res["cpu"]["alpha"].numpy(),
                               rtol=0, atol=1e-6)
    assert float(alpha.min()) >= 0.9 and float(alpha.max()) <= 1.1
    assert not torch.allclose(alpha, torch.ones_like(alpha))


def test_small_fit_is_the_same_bits_every_run(cuda):
    """The card-against-CPU fit gives the same bits run after run on
    each device, and on the CPU whatever its thread count: equal
    ``n_iters`` on the two devices is then a property of the code, not
    of a run."""
    threads = torch.get_num_threads()
    runs = {}
    try:
        for name, device, n_threads in (("card", cuda, threads),
                                        ("card again", cuda, threads),
                                        ("cpu", "cpu", threads),
                                        ("cpu, 1 thread", "cpu", 1),
                                        ("cpu, 4 threads", "cpu", 4)):
            torch.set_num_threads(n_threads)
            runs[name] = _small_fit(device)
    finally:
        torch.set_num_threads(threads)
    for a, b in (("card", "card again"), ("cpu", "cpu, 1 thread"),
                 ("cpu", "cpu, 4 threads")):
        np.testing.assert_array_equal(runs[a]["costs"], runs[b]["costs"])
        np.testing.assert_array_equal(runs[a]["n_iters"], runs[b]["n_iters"])
        assert torch.equal(runs[a]["weights"], runs[b]["weights"])


def _unpacked_both(args, **kw):
    got = simplex_qp.quad_simplex_qp_grouped(*args, **kw)
    want = simplex_qp.quad_simplex_qp_grouped_reference(*args, **kw)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", [1, 6, 32, 33, 64, 65, 96, 97, 128])
def test_unpacked_first_iterations_match_plain(cuda, k, masked):
    # Every lane count (NC = 1..4) and the edges between them, float64.
    args = _problem(k, 3, 257, k, torch.float64, cuda)
    mask = (np.arange(k) % 7 != 3) if masked and k > 3 else None
    got, want = _unpacked_both(args, max_iterations=3, mask=mask)
    assert float((got - want).abs().max()) <= 1e-12
    if mask is not None:
        off = torch.as_tensor(~mask, device=got.device)
        assert bool((got[:, :, off] == 0).all())


@pytest.mark.parametrize("R,n,k,dtype", [
    (3, 257, 100, torch.float64), (1, 300, 128, torch.float64),
    (4, 1788, 96, torch.float32), (1, 1788, 6, torch.float32)])
def test_unpacked_converged_matches_plain(cuda, R, n, k, dtype):
    # (1, 300, 128) float64 holds a 128 KiB Hessian in shared memory.
    args = _problem(R + k, R, n, k, dtype, cuda)
    got, want = _unpacked_both(args, max_iterations=1000)
    f_got, f_want = _objective(got, *args[:2]), _objective(want, *args[:2])
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert float(((f_got - f_want).abs() / (1 + f_want.abs())).max()) <= tol
    if dtype == torch.float64:
        # Bisection near-ties stop a row a step apart (see chip_smoke.py).
        assert float((got - want).abs().max()) <= 1e-7
    assert float((got.double().sum(dim=2) - 1).abs().max()) <= 1e-5
    assert float(got.min()) >= 0.0


def _mixed_groups(k, R, n, dtype, device):
    """R groups of ``_problem`` rows (tens of iterations each at k = 96)
    in which every third row starts at the vertex that its linear term
    pulls to and stops after one iteration, so that the warps of the
    K3/K4 kernel take rows from their group's counter at different
    times."""
    As, Bs, X0s = (t.cpu().numpy() for t in _problem(100 * k + R, R, n, k,
                                                     torch.float64, "cpu"))
    for i in range(0, n, 3):
        X0s[:, i] = 0.0
        X0s[:, i, i % k] = 1.0
        Bs[:, i, i % k] = -100.0
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (As, Bs, X0s))


def _unpacked_mask(k):
    return (np.arange(k) % 7 != 3) if k > 3 else None


def _hold_to_plain(got, args, mask, dtype):
    """K3's result against its plain version on the same card, at the
    tolerances of chip_smoke.py."""
    want = simplex_qp.quad_simplex_qp_grouped_reference(
        *args, mask=mask, max_iterations=1000)
    f_got, f_want = _objective(got, *args[:2]), _objective(want, *args[:2])
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert float(((f_got - f_want).abs() / (1 + f_want.abs())).max()) <= tol
    assert float((got.double().sum(dim=2) - 1).abs().max()) <= 1e-5
    assert float(got.min()) >= 0.0
    if mask is not None:
        off = torch.as_tensor(~mask, device=got.device)
        assert bool((got[:, :, off] == 0).all())


_SCHEDULING_CASES = pytest.mark.parametrize(
    "dtype", [torch.float32, torch.float64])
_SCHEDULING_WIDTHS = pytest.mark.parametrize("k", [1, 33, 96, 128])


@_SCHEDULING_CASES
@_SCHEDULING_WIDTHS
def test_unpacked_same_input_gives_the_same_bits(cuda, k, dtype):
    # Warps take rows from a counter in whatever order they get there;
    # the result must not depend on it.
    args = _mixed_groups(k, 3, 90, dtype, cuda)
    mask = _unpacked_mask(k)
    first = simplex_qp.quad_simplex_qp_grouped(*args, mask=mask,
                                               max_iterations=1000)
    second = simplex_qp.quad_simplex_qp_grouped(*args, mask=mask,
                                                max_iterations=1000)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    _hold_to_plain(first, args, mask, dtype)


@_SCHEDULING_CASES
@_SCHEDULING_WIDTHS
def test_unpacked_permuted_rows_permute_the_result(cuda, k, dtype):
    As, Bs, X0s = _mixed_groups(k, 3, 90, dtype, cuda)
    mask = _unpacked_mask(k)
    perm = torch.as_tensor(np.random.RandomState(k).permutation(90),
                           device=cuda)
    got = simplex_qp.quad_simplex_qp_grouped(As, Bs, X0s, mask=mask,
                                             max_iterations=1000)
    permuted = simplex_qp.quad_simplex_qp_grouped(
        As, Bs[:, perm].contiguous(), X0s[:, perm].contiguous(), mask=mask,
        max_iterations=1000)
    torch.cuda.synchronize()
    assert torch.equal(permuted, got[:, perm])
    _hold_to_plain(got, (As, Bs, X0s), mask, dtype)


@_SCHEDULING_CASES
@_SCHEDULING_WIDTHS
def test_unpacked_rows_equal_their_lone_solves(cuda, k, dtype):
    As, Bs, X0s = _mixed_groups(k, 2, 24, dtype, cuda)
    mask = _unpacked_mask(k)
    kw = dict(mask=mask, max_iterations=1000)
    together = simplex_qp.quad_simplex_qp_grouped(As, Bs, X0s, **kw)
    for r in range(As.shape[0]):
        for i in range(Bs.shape[1]):
            alone = simplex_qp.quad_simplex_qp_grouped(
                As[r:r + 1], Bs[r:r + 1, i:i + 1].contiguous(),
                X0s[r:r + 1, i:i + 1].contiguous(), **kw)
            assert torch.equal(alone, together[r:r + 1, i:i + 1]), (r, i)
    _hold_to_plain(together, (As, Bs, X0s), mask, dtype)


@_SCHEDULING_CASES
@_SCHEDULING_WIDTHS
@pytest.mark.parametrize("R,n", [(1, 1), (1, 257), (3, 1)])
def test_unpacked_one_group_or_one_row(cuda, k, dtype, R, n):
    # At k = 128 in float64 the Hessian takes 128 KiB of shared memory.
    args = _problem(7 * k + n, R, n, k, dtype, cuda)
    mask = _unpacked_mask(k)
    got = simplex_qp.quad_simplex_qp_grouped(*args, mask=mask,
                                             max_iterations=1000)
    torch.cuda.synchronize()
    _hold_to_plain(got, args, mask, dtype)


@pytest.mark.parametrize("projection", ["michelot", "bisect"])
def test_packed_single_hessian_is_k1_at_one_group(cuda, projection):
    A, B, X0 = (t[0] for t in _problem(4, 1, 1788, 6, torch.float32, cuda))
    got = simplex_qp.quad_simplex_qp_packed(A, B, X0, projection=projection,
                                            max_iterations=25)
    want = simplex_qp.quad_simplex_qp_packed_grouped(
        A[None], B[None], X0[None], projection=projection,
        max_iterations=25)[0]
    plain = simplex_qp.quad_simplex_qp_packed_grouped_reference(
        A[None], B[None], X0[None], projection=projection,
        max_iterations=25)[0]
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    f_got = _objective(got[None], A[None], B[None])
    f_plain = _objective(plain[None], A[None], B[None])
    assert float(((f_got - f_plain).abs() / (1 + f_plain.abs())).max()) \
        <= 1e-5


def test_unpacked_single_hessian_is_k3_at_one_group(cuda):
    A, B, X0 = (t[0] for t in _problem(5, 1, 500, 100, torch.float64, cuda))
    got = simplex_qp.quad_simplex_qp(A, B, X0, max_iterations=1000)
    want = simplex_qp.quad_simplex_qp_grouped(A[None], B[None], X0[None],
                                              max_iterations=1000)[0]
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_every_wrapper_counts_its_own_launches(cuda):
    As, Bs, X0s = _problem(6, 2, 100, 70, torch.float32, cuda)
    names = ("LAUNCHES", "PACKED_LAUNCHES", "GROUPED_LAUNCHES",
             "UNPACKED_LAUNCHES")
    before = [getattr(simplex_qp, name) for name in names]
    simplex_qp.quad_simplex_qp_grouped(As, Bs, X0s, max_iterations=5)
    simplex_qp.quad_simplex_qp(As[0], Bs[0], X0s[0], max_iterations=5)
    simplex_qp.quad_simplex_qp(As[0], Bs[0], X0s[0], max_iterations=5)
    small = tuple(t[..., :6, :6] if t is As else t[..., :6]
                  for t in (As, Bs, X0s))
    small = tuple(t.contiguous() for t in small)
    simplex_qp.quad_simplex_qp_packed(*(t[0] for t in small),
                                      max_iterations=5)
    simplex_qp.quad_simplex_qp_grouped_reference(As, Bs, X0s,
                                                 max_iterations=5)
    torch.cuda.synchronize()
    after = [getattr(simplex_qp, name) for name in names]
    assert [a - b for a, b in zip(after, before)] == [0, 1, 1, 2]


def test_gpnh_fit_with_k2_matches_the_plain_version_on_the_cpu(cuda):
    """The same float64 GPNH fit from the same state: K2 on the card, its
    plain version on the CPU."""
    X = _planted(0, 300, 20, 4, 0.02)
    rng = np.random.RandomState(1)
    Z = rng.uniform(size=(300, 4))
    Z /= Z.sum(axis=1, keepdims=True)
    W = rng.standard_normal((20, 4))
    fit = dict(init='custom', lambda_W=3e-5, tolerance=1e-5,
               stopping_criterion='rel_delta_f', max_iterations=200,
               weights_solver_kwargs={'backend': 'pallas',
                                      'max_iterations': 200})
    models = {}
    for device in ("cuda", "cpu"):
        before = simplex_qp.PACKED_LAUNCHES
        models[device] = GPNHConvexCoding(4, **fit).fit(
            torch.as_tensor(X, device=device),
            weights=torch.as_tensor(Z, device=device),
            dictionary=torch.as_tensor(W, device=device))
        launched = simplex_qp.PACKED_LAUNCHES - before
        assert launched == (models[device].n_iter if device == "cuda"
                            else 0)
    card, cpu = models["cuda"], models["cpu"]
    assert card.n_iter == cpu.n_iter and 5 < card.n_iter < 200
    assert card.cost == pytest.approx(cpu.cost, rel=1e-8)
    np.testing.assert_allclose(card.weights.cpu().numpy(),
                               cpu.weights.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(card.dictionary.cpu().numpy(),
                               cpu.dictionary.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("use_gram", [True, False])
def test_pca_on_the_card_matches_the_cpu(cuda, use_gram):
    X = _planted(2, 120, 300, 5, 0.3)
    fits = {}
    for device in ("cuda", "cpu"):
        pca = PCA(6, use_gram=use_gram, device=device)
        fits[device] = (pca, pca.fit_transform(X).cpu().numpy())
    (card, s_card), (cpu, s_cpu) = fits["cuda"], fits["cpu"]
    assert card.components_.device.type == "cuda"
    c_card, c_cpu = card.components_.cpu().numpy(), cpu.components_.numpy()
    sign = np.where(np.sum(c_card * c_cpu, axis=1) < 0, -1.0, 1.0)
    np.testing.assert_allclose(c_card * sign[:, None], c_cpu, rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(s_card * sign, s_cpu, rtol=0,
                               atol=1e-10 * np.abs(s_cpu).max())
    np.testing.assert_allclose(card.explained_variance_,
                               cpu.explained_variance_, rtol=1e-10)


def _schedulers_agree(fit_restarts, X, k, **kw):
    """The default ``compact_iterations=None`` (rounds of 32) and rounds
    of 8 from one seed, float64 on the card: the same trajectory for
    every restart, on K1."""
    before = simplex_qp.LAUNCHES
    one = fit_restarts(X, k, 0, 12, restart_chunk=5, **kw)
    comp = fit_restarts(X, k, 0, 12, restart_chunk=5, compact_iterations=8,
                        **kw)
    assert simplex_qp.LAUNCHES > before
    np.testing.assert_allclose(one['costs'], comp['costs'], rtol=1e-8)
    np.testing.assert_array_equal(one['n_iters'], comp['n_iters'])
    assert one['best_index'] == comp['best_index']
    assert one['n_iters'].max() > 8


def test_gpnh_one_shot_and_compaction_agree_on_the_card(cuda):
    X = torch.as_tensor(_planted(3, 400, 30, 4, 0.02), device=cuda)
    _schedulers_agree(gpnh_fit_restarts, X, 4, lambda_W=1e-3,
                      tolerance=1e-6, stopping_criterion='rel_delta_f',
                      max_iterations=80)


def test_aa_one_shot_and_compaction_agree_on_the_card(cuda):
    X = torch.as_tensor(_planted(4, 400, 30, 5, 0.02), device=cuda)
    _schedulers_agree(aa_fit_restarts, X, 5, init='random', tolerance=1e-6,
                      stopping_criterion='rel_delta_f', max_iterations=80,
                      dictionary_solver_kwargs={'max_iterations': 1},
                      weights_solver_kwargs={'max_iterations': 25})


def _card_and_cpu(fit_restarts, X, k, **kw):
    """One float64 fit from the same seed (a CPU generator draws the
    states on both devices) on the card, where K1 solves the weights,
    and on the CPU, where its plain version does."""
    res = {}
    for device in ("cuda", "cpu"):
        before = simplex_qp.LAUNCHES
        res[device] = fit_restarts(torch.as_tensor(X, device=device), k,
                                   torch.Generator().manual_seed(0), 8,
                                   **kw)
        launched = simplex_qp.LAUNCHES - before
        assert (launched > 0) == (device == "cuda"), (device, launched)
    card, cpu = res["cuda"], res["cpu"]
    np.testing.assert_allclose(card["costs"], cpu["costs"], rtol=1e-6)
    np.testing.assert_array_equal(card["n_iters"], cpu["n_iters"])
    assert card["best_index"] == cpu["best_index"]
    return card, cpu


_PADDED = dict(pad_components_to=8, restart_chunk=4,
               weights_solver_kwargs={'max_iterations': 200,
                                      'backend': 'pallas'})


@pytest.mark.parametrize("scheduler", ["compacted", "screened"])
def test_padded_aa_fit_on_card_matches_cpu(cuda, scheduler):
    """The masked K1 path, float64: the small fit's restart states
    (k = 6) and the same states at width 8 (padded weights 0, padded
    dictionary rows uniform), on the card and on the CPU.  On the card
    the padded fit gives the unpadded one's costs and iteration counts
    (a masked lane adds exact zeros), its padded weights exactly 0; and
    card and CPU agree as for the unpadded fit
    (test_fit_on_card_matches_cpu).  The screen is 36 iterations long,
    late in these fits (33-45 iterations): a pruned restart reports a
    mid-trajectory cost, which rounding moves by 1e-5 at 20
    iterations."""
    from convex_dim_red_tpu_torch.parallel import restarts, sharded_aa
    _, mask = restarts._padded_components(6, 8)
    res = {}
    for label, device in (("card", cuda), ("cpu", "cpu")):
        X = torch.as_tensor(_planted(0, 300, 40, 6, 0.01), device=device)
        Z, C, alpha = restarts._init_aa_state(
            torch.Generator().manual_seed(0), 8, 0.0, n_samples=300,
            n_components=6, init='random', diss=None, n_extra_steps=10,
            do_scale=False, dtype=torch.float64, device=device)
        Z_pad = torch.zeros((8, 300, 8), dtype=Z.dtype, device=device)
        Z_pad[..., :6] = Z
        C_pad = torch.full((8, 8, 300), 1.0 / 300, dtype=C.dtype,
                           device=device)
        C_pad[:, :6] = C
        a_pad = torch.ones((8, 8), dtype=alpha.dtype, device=device)
        for name, states, m in (("unpadded", (Z, C, alpha), None),
                                ("padded", (Z_pad, C_pad, a_pad), mask)):
            iterate, cost0 = sharded_aa._aa_iterate(
                X, restarts._gram_once(X), n_components=states[0].shape[-1],
                delta=0.0, do_scale=False,
                sh=sharded_aa._Shard(device=device),
                dictionary_solver_kwargs={'max_iterations': 1},
                weights_solver_kwargs={'backend': 'pallas',
                                       'max_iterations': 25},
                component_mask=m)
            screened = scheduler == "screened"
            best, costs, n_iters, _ = restarts._best_of_restarts(
                iterate, cost0, states, tolerance=1e-6,
                criterion='rel_delta_f', max_iterations=200,
                restart_chunk=4,
                compact_iterations=None if screened else 32,
                screen_iterations=36 if screened else None,
                screen_keep=0.5, screen_margin=None)
            res[label, name] = (costs, n_iters, best[0])
    card, card_pad = res["card", "unpadded"], res["card", "padded"]
    np.testing.assert_allclose(card_pad[0], card[0], rtol=1e-10)
    np.testing.assert_array_equal(card_pad[1], card[1])
    assert bool((card_pad[2][:, 6:] == 0).all())
    cpu_pad = res["cpu", "padded"]
    np.testing.assert_allclose(card_pad[0], cpu_pad[0], rtol=1e-6)
    np.testing.assert_array_equal(card_pad[1], cpu_pad[1])


def test_padded_gpnh_fit_on_card_matches_cpu(cuda):
    card, _ = _card_and_cpu(
        gpnh_fit_restarts, _planted(6, 300, 20, 3, 0.02), 3, lambda_W=1e-3,
        tolerance=1e-6, stopping_criterion='rel_delta_f', max_iterations=120,
        **_PADDED)
    assert card["dictionary"].shape == (20, 3)


def test_screened_fit_on_card_matches_cpu(cuda):
    card, cpu = _card_and_cpu(
        aa_fit_restarts, _planted(7, 300, 40, 6, 0.01), 6, init='random',
        tolerance=1e-6, stopping_criterion='rel_delta_f', max_iterations=120,
        dictionary_solver_kwargs={'max_iterations': 1}, restart_chunk=4,
        weights_solver_kwargs={'max_iterations': 25, 'backend': 'pallas'},
        screen_iterations=15, screen_keep=0.5)
    assert card["screen"]["n_kept"] == cpu["screen"]["n_kept"] == 4
    assert card["screen"]["screen_cut"] == pytest.approx(
        cpu["screen"]["screen_cut"], rel=1e-6)


def test_lloyd_on_card_matches_cpu(cuda):
    """Float64 Lloyd from the same centroids on the card and on the CPU:
    equal labels and ``n_iter``, centroids and inertia to rounding."""
    from convex_dim_red_tpu_torch.models import kmeans
    rng = np.random.RandomState(0)
    X = rng.standard_normal((600, 512))
    C0 = X[rng.choice(600, 4, replace=False)]
    tol = 1e-4 * float(np.var(X, axis=0).mean())
    out = {dev: kmeans._lloyd(torch.as_tensor(X, device=dev),
                              torch.as_tensor(C0, device=dev), 300, tol)
           for dev in (cuda, "cpu")}
    (C_d, lab_d, inert_d, it_d), (C_c, lab_c, inert_c, it_c) = (
        [t.cpu() for t in out[dev]] for dev in (cuda, "cpu"))
    assert torch.equal(lab_d, lab_c)
    assert int(it_d) == int(it_c)
    torch.testing.assert_close(C_d, C_c, rtol=0, atol=1e-10)
    assert float(inert_d) == pytest.approx(float(inert_c), rel=1e-10)


def test_aa_transform_on_card_runs_k2(cuda):
    from convex_dim_red_tpu_torch.cli import common
    from convex_dim_red_tpu_torch.models._common import (QPSolverConfig,
                                                         make_config)
    rng = np.random.RandomState(1)
    arch = torch.as_tensor(rng.uniform(size=(4, 64)), device=cuda)
    data = torch.as_tensor(rng.uniform(size=(300, 64)), device=cuda)
    simplex_qp.PACKED_LAUNCHES = 0
    Z, cost = common._aa_transform(arch, data, 0,
                                   make_config(QPSolverConfig, None), 1000)
    assert simplex_qp.PACKED_LAUNCHES == 1
    Z_cpu, cost_cpu = common._aa_transform(
        arch.cpu(), data.cpu(), 0, make_config(QPSolverConfig, None), 1000)
    assert Z.device.type == "cuda"
    # K2 and the CPU's row solver stop on different rules.
    assert cost == pytest.approx(cost_cpu, rel=1e-6)


def test_sharded_fits_on_the_card_match_one_device(cuda):
    """The dry run of the multi-device layer in a world of two processes
    sharing the card on gloo (parallel/dryrun.py: train step, sharded
    AA, kernel-AA and GPNH fits on (2, 1) and (1, 2) meshes, a
    restart-sharded fit), K1 on every rank, each check held to the
    single-device path."""
    from convex_dim_red_tpu_torch.parallel.dryrun import dryrun_multichip
    for rank in dryrun_multichip(2, 'gloo', 'cuda'):
        assert rank['launches']['K1'] > 0
        assert max(rank['differences'].values()) < 1e-6


def test_profiling_helpers_on_the_card(cuda, tmp_path):
    from convex_dim_red_tpu_torch.utils.profiling import (block_and_time,
                                                          trace)
    x = torch.ones((256, 256), device=cuda)
    result, sec = block_and_time(lambda a: a @ a, x, repeats=3)
    assert sec > 0 and float(result[0, 0]) == 256.0
    with trace(str(tmp_path)) as prof:
        (x @ x).sum().item()
    assert any(p.name.endswith(".pt.trace.json")
               for p in tmp_path.rglob("*"))
    assert any(getattr(e, "device_time_total", 0) > 0
               for e in prof.key_averages())
