"""The AA restart cost on a factor of the Gram
(``parallel/sharded_aa._gram_factor``).

On one device, where the data has more features than samples, the AA
iterate's residual-form cost runs on an (n, n) factor ``L`` of the Gram
(``L L' = X X'``) in place of the (n, d) data: ``||A X||^2 = ||A L||^2``
for every ``A``, so the cost is the same sum of squares.

On the CPU: the factor reproduces the Gram (by Cholesky, with its last
pivot clamped where the Gram has rank n - 1, as centred data's has, and
by the eigendecomposition where its leading minor is singular too, as
with duplicate rows); the factor-form cost
equals the data-form one to rtol 1e-12 in float64, in one cost, one
iteration and whole fits, and in float32 on a near fit lies within 2e-7
of a float64 audit; data with no more features than samples (the
JRA-55 PCs' shape) keeps the data as the operand; the counter.

Marked ``cuda`` (K5 has no CPU mode; they skip without a card): K5
against its plain version in float64 at the factor's shape (R, n, n, k),
the eigendecomposition's factor of duplicate rows and K5's costs on it,
and a fit whose chunk-iterations replay a CUDA graph on the factor.
This file imports no JAX (the parity with the JAX package on wide data
is in tests/test_torch_restarts.py); run the card's tests with::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_gram_factor.py
"""

import numpy as np
import pytest
import torch

from convex_dim_red_tpu_torch import aa_fit_restarts, kernel_aa_fit_restarts
from convex_dim_red_tpu_torch.ops import residual_cost
from convex_dim_red_tpu_torch.parallel import restarts, sharded_aa
from convex_dim_red_tpu_torch.utils import profiling

torch.set_num_threads(1)

FIT = dict(init='random', tolerance=1e-6, max_iterations=40,
           stopping_criterion='rel_delta_f',
           dictionary_solver_kwargs={'max_iterations': 1},
           weights_solver_kwargs={'max_iterations': 25})


def _planted(seed, n, d, k, noise, dtype=torch.float64, centred=False):
    """Data of ``k`` planted archetypes (pure samples among them) plus
    noise, with its planted weights ``Z`` (n, k) and the pure samples'
    indices; columns centred on request, as anomaly fields are."""
    rng = np.random.RandomState(seed)
    basis = rng.standard_normal((k, d))
    Z = rng.dirichlet(np.ones(k), size=n)
    pure = rng.choice(n, size=k, replace=False)
    Z[pure] = np.eye(k)
    X = Z @ basis + noise * rng.standard_normal((n, d))
    if centred:
        X -= X.mean(axis=0)
    return torch.as_tensor(X, dtype=dtype), Z, pure


def _states(seed, R, n, k, dtype=torch.float64):
    rng = np.random.RandomState(seed)
    Z = rng.dirichlet(np.ones(k), size=(R, n))
    C = rng.dirichlet(np.ones(n), size=(R, k))
    alpha = rng.uniform(0.9, 1.1, size=(R, k))
    return tuple(torch.as_tensor(a, dtype=dtype) for a in (Z, C, alpha))


def _iterate(X, k=3):
    return sharded_aa._aa_iterate(
        X, restarts._gram_once(X), n_components=k, delta=0.0,
        do_scale=False, sh=sharded_aa._Shard(device='cpu'),
        dictionary_solver_kwargs={'max_iterations': 1},
        weights_solver_kwargs={'backend': 'pallas', 'max_iterations': 25})


def _data_form(monkeypatch):
    """Run the residual form on the data itself, as before the factor."""
    monkeypatch.setattr(sharded_aa, "_gram_factor", lambda X: X.contiguous())


@pytest.mark.parametrize("n,d", [(20, 50), (37, 300), (64, 2500)])
def test_factor_reproduces_the_gram(n, d):
    # d = 2500 sums the Gram over three feature blocks.
    X, _, _ = _planted(n + d, n, d, 3, 0.1)
    L = sharded_aa._gram_factor(X)
    K = X @ X.T
    assert L.shape == (n, n) and L.dtype == X.dtype
    np.testing.assert_allclose((L @ L.T).numpy(), K.numpy(), rtol=0,
                               atol=1e-12 * float(K.abs().max()))
    # Cholesky's factor where the Gram is positive definite.
    assert torch.equal(L, torch.tril(L))


def _eigh_calls(monkeypatch):
    calls = []
    real = torch.linalg.eigh

    def eigh(K, **kw):
        calls.append(K.shape)
        return real(K, **kw)

    monkeypatch.setattr(torch.linalg, "eigh", eigh)
    return calls


def test_duplicate_rows_take_the_eigendecomposition(monkeypatch):
    rng = np.random.RandomState(3)
    X = torch.as_tensor(np.repeat(rng.standard_normal((4, 50)), 3, axis=0))
    # The leading minor is singular too: no clamped last pivot mends it.
    assert int(torch.linalg.cholesky_ex((X @ X.T)[:-1, :-1])[1]) != 0
    calls = _eigh_calls(monkeypatch)
    L = sharded_aa._gram_factor(X)
    assert calls == [(12, 12)]
    K = X @ X.T
    np.testing.assert_allclose((L @ L.T).numpy(), K.numpy(), rtol=0,
                               atol=1e-12 * float(K.abs().max()))
    Z, C, alpha = _states(4, 3, 12, 3)
    sh = sharded_aa._Shard(device='cpu')
    got = sharded_aa._aa_iter_cost(L, Z, C, alpha, None, None, None, sh)
    want = sharded_aa._aa_iter_cost(X, Z, C, alpha, None, None, None, sh)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)


@pytest.mark.parametrize("case", ["centred", "last row repeated"])
def test_rank_one_short_takes_the_clamped_last_pivot(case, monkeypatch):
    """A Gram of rank n - 1 whose leading minor is positive definite,
    where Cholesky alone fails at its last pivot or leaves it at
    rounding: the factor clamps it, with no eigendecomposition, and
    reproduces the Gram."""
    X, _, _ = _planted(7, 40, 300, 3, 0.1, centred=case == "centred")
    if case == "last row repeated":
        X[-1] = X[5]
    K = X @ X.T
    calls = _eigh_calls(monkeypatch)
    L = sharded_aa._gram_factor(X)
    assert calls == [] and torch.equal(L, torch.tril(L))
    np.testing.assert_allclose((L @ L.T).numpy(), K.numpy(), rtol=0,
                               atol=1e-12 * float(K.abs().max()))
    assert 0.0 <= float(L[-1, -1]) < 1e-6 * float(L.diagonal().max())


@pytest.mark.parametrize("n,d,centred", [(30, 80, False), (48, 1500, False),
                                         (48, 1500, True)])
def test_factor_form_cost_and_iteration_equal_the_data_form(n, d, centred,
                                                            monkeypatch):
    X, _, _ = _planted(n, n, d, 3, 0.05, centred=centred)
    states = _states(n + 1, 4, n, 3)
    before = profiling.GRAM_FACTORS
    iterate, cost0 = _iterate(X)
    assert profiling.GRAM_FACTORS - before == 1
    got0, got = cost0(*states), iterate(*states)
    _data_form(monkeypatch)
    d_iterate, d_cost0 = _iterate(X)
    assert profiling.GRAM_FACTORS - before == 1
    want0, want = d_cost0(*states), d_iterate(*states)
    np.testing.assert_allclose(got0.numpy(), want0.numpy(), rtol=1e-12)
    # The cost comes after the dictionary and weights updates, which the
    # factor does not touch: the states are equal to the bit.
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    np.testing.assert_allclose(got[3].numpy(), want[3].numpy(), rtol=1e-12)


@pytest.mark.parametrize("screened", [False, True],
                         ids=["compacted", "screened"])
def test_wide_fit_equals_the_data_form_fit(screened, monkeypatch):
    """Whole float64 fits from one seed: the same stops, the same
    winner, the costs to rtol 1e-12; one factor a fit."""
    X, _, _ = _planted(5, 36, 400, 3, 0.05)
    kw = dict(FIT, restart_chunk=4, compact_iterations=8)
    if screened:
        kw = dict(FIT, restart_chunk=4, compact_iterations=None,
                  screen_iterations=6, screen_keep=0.5)
    before = profiling.GRAM_FACTORS
    got = aa_fit_restarts(X, 3, 11, 10, **kw)
    assert profiling.GRAM_FACTORS - before == 1
    _data_form(monkeypatch)
    want = aa_fit_restarts(X, 3, 11, 10, **kw)
    np.testing.assert_array_equal(got['n_iters'], want['n_iters'])
    assert got['best_index'] == want['best_index']
    np.testing.assert_allclose(got['costs'], want['costs'], rtol=1e-12)
    np.testing.assert_allclose(got['weights'].numpy(),
                               want['weights'].numpy(), rtol=0, atol=1e-10)


@pytest.mark.parametrize("centred", [False, True])
def test_float32_factor_cost_of_a_near_fit_against_float64(centred):
    """The planted solution and perturbations of it (residual shares of
    about 5-20%): the float32 cost on the factor within 2e-7 of the
    float64 data-form cost."""
    n, d, k, R = 150, 3000, 4, 5
    X64, Zp, pure = _planted(8, n, d, k, 0.15, centred=centred)
    rng = np.random.RandomState(9)
    Z = np.stack([Zp] + [
        (1 - t) * Zp + t * rng.dirichlet(np.ones(k), size=n)
        for t in np.linspace(0.05, 0.3, R - 1)])
    C = np.zeros((R, k, n))
    C[:, np.arange(k), pure] = 1.0
    alpha = np.ones((R, k))
    Xn = X64.float().double().numpy()  # the float32 data, exactly
    resid = np.einsum('rnk,rkd->rnd', Z, C @ Xn) - Xn
    want = 0.5 * np.sum(resid * resid, axis=(1, 2)) / n
    share = np.sum(resid * resid, axis=(1, 2)) / np.sum(Xn * Xn)
    assert share.min() > 0.02 and share.max() < 0.35
    X = X64.float()
    _, cost0 = _iterate(X, k)
    got = cost0(*(torch.as_tensor(a, dtype=torch.float32)
                  for a in (Z, C, alpha)))
    assert got.dtype == torch.float32
    rel = np.abs(got.double().numpy() / want - 1.0)
    assert rel.max() < 2e-7


@pytest.mark.parametrize("n,d", [(732, 167), (60, 60)])
def test_no_more_features_than_samples_keeps_the_data(n, d, monkeypatch):
    """The JRA-55 PCs' shape, and a square one: the cost's operand is
    the data, and no factor is built."""
    seen = []
    real = sharded_aa.residual_sq_sums

    def spy(X, *args):
        seen.append(X)
        return real(X, *args)

    monkeypatch.setattr(sharded_aa, "residual_sq_sums", spy)
    X, _, _ = _planted(1, n, d, 4, 0.1, dtype=torch.float32)
    before = profiling.GRAM_FACTORS
    _, cost0 = _iterate(X, 4)
    cost0(*_states(2, 2, n, 4, torch.float32))
    assert profiling.GRAM_FACTORS == before
    assert seen and all(t.data_ptr() == X.data_ptr() and t.shape == (n, d)
                        for t in seen)
    wide, _, _ = _planted(1, 20, 21, 4, 0.1, dtype=torch.float32)
    _, cost0 = _iterate(wide, 4)
    cost0(*_states(2, 2, 20, 4, torch.float32))
    assert seen[-1].shape == (20, 20)
    assert profiling.GRAM_FACTORS == before + 1


def test_kernel_fits_build_no_factor():
    X, _, _ = _planted(2, 30, 90, 3, 0.1)
    before = profiling.GRAM_FACTORS
    kernel_aa_fit_restarts(X @ X.T, 3, 0, 4, **dict(FIT, max_iterations=5))
    assert profiling.GRAM_FACTORS == before


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K5 and a CUDA graph have no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("R,n,d,k", [(25, 1788, 24030, 6), (4, 300, 2000, 5),
                                     (100, 130, 700, 20)])
def test_k5_matches_plain_at_the_factor_shape(cuda, R, n, d, k):
    """K5 at (R, n, n, k) on the factor of wide centred data, in
    float32, against its plain version in float64 from the same inputs:
    within 1e-6 of the size of the terms
    (tests/test_torch_residual_cost.py)."""
    X, _, _ = _planted(R + k, n, d, 8, 0.3, dtype=torch.float32,
                       centred=True)
    L = sharded_aa._gram_factor(X.to(cuda))
    Z, C, alpha = (t.float().to(cuda) for t in _states(k, R, n, k))
    CL = (C @ L).contiguous()
    got = residual_cost.residual_sq_sums(L, Z, CL, alpha)
    want = residual_cost.residual_sq_sums_reference(
        L.double(), Z.double(), CL.double(), alpha.double())
    terms = (Z.double().abs() @ (alpha.double().abs()[:, :, None]
                                 * CL.double().abs()) + L.double().abs())
    scale = torch.sum(terms * terms, dim=(1, 2))
    torch.cuda.synchronize()
    assert float(((got.double() - want).abs() / scale).max()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-10),
                                        (torch.float32, 1e-5)])
def test_duplicate_rows_take_the_eigendecomposition_on_the_card(
        cuda, monkeypatch, dtype, rtol):
    """Wide data whose rows come in threes, on the card: the factor
    comes from the eigendecomposition (in place, in its float64 buffer),
    reproduces the Gram, and K5's costs on it are its costs on the data
    (random states, so that the residuals do not cancel)."""
    rng = np.random.RandomState(11)
    X = torch.as_tensor(np.repeat(rng.standard_normal((100, 2000)), 3,
                                  axis=0), dtype=dtype, device=cuda)
    calls = _eigh_calls(monkeypatch)
    L = sharded_aa._gram_factor(X)
    assert calls == [(300, 300)]
    assert L.shape == (300, 300) and L.dtype == dtype
    K = X.double() @ X.double().T
    assert float((L.double() @ L.double().T - K).abs().max()) <= (
        (1e-12 if dtype == torch.float64 else 1e-6) * float(K.abs().max()))
    Z, C, alpha = (t.to(dtype=dtype, device=cuda)
                   for t in _states(12, 8, 300, 5))
    got = residual_cost.residual_sq_sums(L, Z, (C @ L).contiguous(), alpha)
    want = residual_cost.residual_sq_sums(X, Z, (C @ X).contiguous(), alpha)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.double().cpu().numpy(),
                               want.double().cpu().numpy(), rtol=rtol)


@pytest.mark.cuda
def test_graph_replayed_fit_runs_on_the_factor(cuda, monkeypatch):
    """A float32 fit of wide data on the card: one factor, the
    chunk-iterations replayed as a CUDA graph, every cost a K5 launch,
    and the winner's cost that of the data-form fit to float32
    rounding."""
    X, _, _ = _planted(6, 300, 2000, 5, 0.3, dtype=torch.float32,
                       centred=True)
    X = X.to(cuda)
    kw = dict(FIT, restart_chunk=4, compact_iterations=8)
    aa_fit_restarts(X, 5, 1, 10, **dict(kw, max_iterations=2))  # builds
    loops = []
    real = restarts._keep_best_loop

    def counting(*a, **k):
        loops.append(1)
        return real(*a, **k)

    monkeypatch.setattr(restarts, "_keep_best_loop", counting)
    before = profiling.counters()
    got = aa_fit_restarts(X, 5, 3, 10, **kw)
    torch.cuda.synchronize()
    after = profiling.counters()
    change = {key: after[key] - before[key] for key in after}
    assert change["GRAM_FACTORS"] == 1
    assert change["GRAPH_CAPTURES"] == 1
    assert change["GRAPH_REPLAYS"] + 1 == change["LAUNCHES"]
    assert change["COST_LAUNCHES"] == change["LAUNCHES"] + len(loops)
    _data_form(monkeypatch)
    want = aa_fit_restarts(X, 5, 3, 10, **kw)
    assert profiling.GRAM_FACTORS == after["GRAM_FACTORS"]
    assert got['cost'] == pytest.approx(want['cost'], rel=1e-5)
