"""The port's simplex row solver and QP dispatch against the JAX
package's, float64.

``quad_simplex_spg`` solves every row as a member of one ``quad_spg``
batch, with its own step, line search, stop and freeze, which is what
``jax.vmap`` of the JAX row solver does.  The same arithmetic summed in
another order agrees to 1e-12 over the first iterations.  Once rows
stop, a row that stops one step apart (the residual test at 1e-6 on a
rounding-level difference) leaves up to 2e-9 in x on these problems,
while its objective agrees to 1e-15: converged rows are held to 1e-8 in
x and 1e-12 in the objective, as the kernels are.  The dispatch follows
the JAX rule: 'xla' is the row solver, 'pallas' the kernels (their
plain versions on CPU tensors), and 'auto' resolves to the row solver
on the CPU.
"""

import numpy as np
import pytest
import torch

from convex_dim_red_tpu.solvers import spg as jspg
from convex_dim_red_tpu_torch.ops import simplex_qp
from convex_dim_red_tpu_torch.solvers import spg as tspg

# Small tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores.
torch.set_num_threads(1)


def _assert_parity(got, want, As, Bs, max_iterations):
    if max_iterations <= 3:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        return
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)
    f_got = (0.5 * np.einsum('rij,rjk,rik->ri', got, As, got)
             + np.sum(got * Bs, axis=2))
    f_want = (0.5 * np.einsum('rij,rjk,rik->ri', want, As, want)
              + np.sum(want * Bs, axis=2))
    rel = np.abs(f_got - f_want) / np.maximum(1.0, np.abs(f_want))
    assert rel.max() <= 1e-12


def _problem(seed, R, n, k):
    rng = np.random.RandomState(seed)
    M = rng.standard_normal((R, k, k))
    As = M @ M.transpose(0, 2, 1) / k + np.eye(k)
    Bs = rng.standard_normal((R, n, k))
    X0s = rng.uniform(size=(R, n, k))
    X0s /= X0s.sum(axis=2, keepdims=True)
    return As, Bs, X0s


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


@pytest.mark.parametrize("max_iterations", [3, 300])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", [3, 6, 70])
def test_row_solver_matches_vmapped_jax(k, masked, max_iterations):
    As, Bs, X0s = _problem(k, 1, 25, k)
    mask = (np.arange(k) != 1) if masked else None
    kw = dict(max_iterations=max_iterations, max_feval=2000)
    want = np.asarray(jspg.quad_simplex_spg_batch(
        As[0], Bs[0], X0s[0], backend="xla", mask=mask, **kw))
    got = tspg.quad_simplex_spg(*_t(As[0], Bs[0], X0s[0]), mask=mask,
                                **kw).numpy()
    _assert_parity(got[None], want[None], As, Bs, max_iterations)
    if masked:
        assert np.all(got[:, 1] == 0.0)


def test_row_solver_caps_iterations_at_max_feval():
    As, Bs, X0s = _problem(1, 1, 10, 5)
    want = np.asarray(jspg.quad_simplex_spg_batch(
        As[0], Bs[0], X0s[0], backend="xla", max_iterations=100,
        max_feval=2))
    got = tspg.quad_simplex_spg(*_t(As[0], Bs[0], X0s[0]),
                                max_iterations=100, max_feval=2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    full = tspg.quad_simplex_spg(*_t(As[0], Bs[0], X0s[0]),
                                 max_iterations=100).numpy()
    assert np.abs(full - got).max() > 1e-6


@pytest.mark.parametrize("max_iterations", [3, 200])
@pytest.mark.parametrize("k", [4, 70])
def test_grouped_xla_matches_jax(k, max_iterations):
    # The repair: backend='xla' runs the row solver, once per group.
    As, Bs, X0s = _problem(10 + k, 3, 15, k)
    kw = dict(max_iterations=max_iterations)
    want = np.asarray(jspg.quad_simplex_spg_batch_grouped(
        As, Bs, X0s, backend="xla", **kw))
    got = tspg.quad_simplex_spg_batch_grouped(*_t(As, Bs, X0s),
                                              backend="xla", **kw).numpy()
    _assert_parity(got, want, As, Bs, max_iterations)
    one = tspg.quad_simplex_spg_batch(*_t(As[1], Bs[1], X0s[1]),
                                      backend="xla", **kw).numpy()
    _assert_parity(got[1:2], one[None], As[1:2], Bs[1:2], max_iterations)


@pytest.mark.parametrize("backend,regime,device,k,want", [
    ("auto", "oneshot", "cpu", 6, "xla"),
    ("auto", "sharded_fit", "cpu", 6, "xla"),
    ("auto", "fit", "cuda", 6, "xla"),
    ("auto", "oneshot", "cuda", 6, "pallas"),
    ("auto", "oneshot", "cuda", 128, "pallas"),
    ("auto", "oneshot", "cuda", 129, "xla"),
    ("auto", "sharded_fit", "cuda", 96, "pallas"),
    ("auto", "oneshot", None, 6, "xla"),
    ("pallas", "fit", "cpu", 6, "pallas"),
    ("xla", "oneshot", "cuda", 6, "xla")])
def test_resolve_qp_backend(backend, regime, device, k, want):
    assert tspg.resolve_qp_backend(backend, k=k, regime=regime,
                                   device=device) == want


def test_resolve_qp_backend_agrees_with_jax_off_the_accelerator():
    for regime in ("oneshot", "fit", "sharded_fit"):
        for backend in ("auto", "xla", "pallas"):
            assert (tspg.resolve_qp_backend(backend, k=6, regime=regime,
                                            device="cpu")
                    == jspg.resolve_qp_backend(backend, k=6,
                                               regime=regime))
    with pytest.raises(ValueError):
        tspg.resolve_qp_backend("auto", regime="warm")


def _launches():
    return (simplex_qp.LAUNCHES, simplex_qp.PACKED_LAUNCHES,
            simplex_qp.GROUPED_LAUNCHES, simplex_qp.UNPACKED_LAUNCHES)


@pytest.mark.parametrize("k", [6, 70])
def test_single_hessian_dispatch(k):
    As, Bs, X0s = _problem(20 + k, 1, 9, k)
    A, B, X0 = _t(As[0], Bs[0], X0s[0])
    kw = dict(max_iterations=60)
    xla = tspg.quad_simplex_spg_batch(A, B, X0, backend="xla", **kw)
    # Default calls on the CPU give the row solver, as in JAX.
    assert torch.equal(tspg.quad_simplex_spg_batch(A, B, X0, **kw), xla)
    assert torch.equal(
        tspg.quad_simplex_spg_batch(A, B, X0, backend="auto", **kw), xla)
    before = _launches()
    # 'pallas' ignores the row solver's other arguments, as in JAX.
    pallas = tspg.quad_simplex_spg_batch(A, B, X0, backend="pallas",
                                         gamma=1e-4, max_feval=2000, **kw)
    assert _launches() == before
    if k <= 64:
        want = simplex_qp.quad_simplex_qp_packed(A, B, X0, **kw)
    else:
        want = simplex_qp.quad_simplex_qp(A, B, X0, **kw)
    assert torch.equal(pallas, want)


def test_grouped_dispatch_above_64_runs_the_unpacked_kernel():
    # The repair: k > 64 no longer raises.
    As, Bs, X0s = _t(*_problem(30, 2, 9, 80))
    got = tspg.quad_simplex_spg_batch_grouped(As, Bs, X0s,
                                              backend="pallas",
                                              max_iterations=60)
    want = simplex_qp.quad_simplex_qp_grouped(As, Bs, X0s,
                                              max_iterations=60)
    assert torch.equal(got, want)


@pytest.mark.parametrize("fn", ["batch", "grouped"])
@pytest.mark.parametrize("backend", ["xla", "auto", "pallas"])
def test_michelot_above_64_is_refused_up_front(fn, backend):
    As, Bs, X0s = _t(*_problem(40, 1, 4, 65))
    args = (As[0], Bs[0], X0s[0]) if fn == "batch" else (As, Bs, X0s)
    call = (tspg.quad_simplex_spg_batch if fn == "batch"
            else tspg.quad_simplex_spg_batch_grouped)
    with pytest.raises(ValueError, match="k <= 64"):
        call(*args, backend=backend, projection="michelot")
    # Bisection is what the unpacked kernels run: accepted.
    call(*args, backend=backend, projection="bisect", max_iterations=5)


@pytest.mark.parametrize("bad", [dict(projection="sort"),
                                 dict(backend="tpu")])
def test_dispatch_rejects_unknown_choices(bad):
    As, Bs, X0s = _t(*_problem(41, 1, 4, 5))
    with pytest.raises(ValueError):
        tspg.quad_simplex_spg_batch(As[0], Bs[0], X0s[0], **bad)
    with pytest.raises(ValueError):
        tspg.quad_simplex_spg_batch_grouped(As, Bs, X0s, **bad)
