"""The port's generic ``spg`` and ``utils/profiling.py`` against the JAX
package's, float64.

The twelve tests of tests/test_spg.py, ported (the generic solver, the
simplex QP solvers, the soft-failure warnings and the verbose table);
then ``spg`` held to the JAX ``spg`` on the same problems, with and
without ``project``: the same iteration and evaluation counts, ``x`` and
``f_min`` to 1e-10 (the two run the same float64 operations in the same
order, up to the rounding of the libraries' reductions); then the
profiling helpers (tests/test_analysis_utils.py:207-232).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convex_dim_red_tpu.ops.simplex_projection import (
    simplex_project_rows as j_project_rows)
from convex_dim_red_tpu.solvers.spg import spg as j_spg
from convex_dim_red_tpu_torch import spg
from convex_dim_red_tpu_torch.ops.simplex_projection import (
    simplex_project_rows)
from convex_dim_red_tpu_torch.solvers.spg import (line_search_step_length,
                                                  quad_simplex_spg,
                                                  quad_simplex_spg_batch)
from convex_dim_red_tpu_torch.utils.profiling import block_and_time, trace

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


# -- tests/test_spg.py, ported ---------------------------------------------


def test_correct_solution_on_unconstrained_1d_trivial_problem():
    x0 = np.random.RandomState(0).uniform(-10.0, 10.0)
    x, f_min, n_iter, n_feval = spg(
        lambda x: x * x, lambda x: 2.0 * x, np.float64(x0),
        max_iterations=100, max_feval=100, device='cpu')
    assert abs(float(x)) < 1e-10
    assert abs(float(f_min)) < 1e-10
    assert n_iter < 100 and n_feval < 100


def _quartic():
    a, b, c, d, e = 1.0, -15.0 / 4.0, 13.0 / 4.0, 0.0, 1.0
    return (lambda x: a * x ** 4 + b * x ** 3 + c * x ** 2 + d * x + e,
            lambda x: 4 * a * x ** 3 + 3 * b * x ** 2 + 2 * c * x + d)


def test_correct_solution_on_constrained_1d_trivial_problem():
    """Quartic with a local min at 0 and the global one at 2, on the box
    [-1, 0.5]."""
    f, df = _quartic()
    rng = np.random.RandomState(1)
    for x0 in (rng.uniform(1.1, 3.0), rng.uniform(-5.0, -2.0)):
        x, f_min, n_iter, n_feval = spg(
            f, df, np.float64(x0), project=lambda x: torch.clamp(x, -1.0,
                                                                 0.5),
            max_iterations=100, max_feval=100, device='cpu')
        assert abs(float(x)) < 1e-6
        assert abs(float(f_min) - 1.0) < 1e-6
        assert n_iter < 100 and n_feval < 100


def test_spg_on_matrix_variable_with_row_simplex_projection():
    """min ||X - T||^2 with T outside the feasible set: the row-wise
    projection of T."""
    T = _t(np.random.RandomState(2).standard_normal((4, 6)))
    X, _, _, _ = spg(lambda X: torch.sum((X - T) ** 2),
                     lambda X: 2.0 * (X - T), np.full((4, 6), 1.0 / 6.0),
                     project=simplex_project_rows, epsilon_two=1e-12,
                     max_iterations=500, device='cpu')
    np.testing.assert_allclose(X.numpy(), simplex_project_rows(T).numpy(),
                               atol=1e-8)


def test_quad_simplex_spg_identity_hessian():
    x = quad_simplex_spg(_t(np.eye(3)), _t([-1.0, 0.0, 0.0]),
                         _t(np.ones(3) / 3))
    np.testing.assert_allclose(x.numpy(), [1.0, 0.0, 0.0], atol=1e-8)


def test_quad_simplex_spg_interior_solution():
    n = 5
    x0 = np.random.RandomState(3).uniform(size=n)
    x = quad_simplex_spg(_t(np.eye(n)), _t(np.zeros(n)), _t(x0 / x0.sum()))
    np.testing.assert_allclose(x.numpy(), np.full(n, 1.0 / n), atol=1e-7)


def test_quad_simplex_spg_batch_kkt():
    rng = np.random.RandomState(0)
    k, n = 7, 64
    M = rng.standard_normal((k, k))
    A = M @ M.T + np.eye(k)
    B = rng.standard_normal((n, k))
    X0 = np.full((n, k), 1.0 / k)
    X = quad_simplex_spg_batch(_t(A), _t(B), _t(X0)).numpy()

    assert np.allclose(X.sum(axis=1), 1.0, atol=1e-12)
    assert (X >= -1e-14).all()
    G = X @ A + B
    res = simplex_project_rows(_t(X - G)).numpy() - X
    assert np.abs(res).max() < 2e-6
    for t in range(0, n, 17):
        xt = quad_simplex_spg(_t(A), _t(B[t]), _t(X0[t])).numpy()
        np.testing.assert_allclose(X[t], xt, atol=1e-12)


def test_quad_simplex_spg_batch_monotone_cost():
    rng = np.random.RandomState(5)
    k, n = 4, 32
    M = rng.standard_normal((k, k))
    A = M @ M.T
    B = rng.standard_normal((n, k))
    X0 = rng.uniform(size=(n, k))
    X0 /= X0.sum(axis=1, keepdims=True)

    def total_cost(X):
        return float(np.sum(0.5 * np.einsum('ij,jk,ik->i', X, A, X)
                            + np.sum(X * B, axis=1)))

    X = quad_simplex_spg_batch(_t(A), _t(B), _t(X0)).numpy()
    assert total_cost(X) <= total_cost(X0) + 1e-12


def test_spg_warns_on_max_iterations():
    with pytest.warns(UserWarning,
                      match='maximum number of iterations exceeded'):
        spg(lambda x: torch.sum(x * x), lambda x: 2.0 * x,
            np.full((4,), 10.0), max_iterations=1, epsilon_one=1e-300,
            epsilon_two=1e-300, device='cpu')


def _rosenbrock(xp):
    def f(x):
        return xp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                      + (1.0 - x[:-1]) ** 2)

    def df(x):
        inner = -400.0 * x[:-1] * (x[1:] - x[:-1] ** 2) \
            - 2.0 * (1.0 - x[:-1])
        outer = 200.0 * (x[1:] - x[:-1] ** 2)
        zero = xp.zeros_like(x[:1])
        return (xp.concatenate([inner, zero])
                + xp.concatenate([zero, outer]))
    return f, df


def test_spg_warns_on_max_feval():
    f, df = _rosenbrock(torch)
    with pytest.warns(UserWarning,
                      match='maximum number of function evaluations'):
        spg(f, df, np.array([-1.2, 1.0, -1.2, 1.0]), max_iterations=10000,
            max_feval=5, epsilon_one=1e-300, epsilon_two=1e-300,
            device='cpu')


def test_spg_warns_on_line_search_underflow():
    """A wrong-sign gradient makes every step an ascent direction: the
    line search shrinks lambda below lambda_min."""
    with pytest.warns(UserWarning, match='step size below tolerance'):
        spg(lambda x: torch.sum(x * x), lambda x: -2.0 * x,
            np.full((3,), 5.0), max_iterations=2, lambda_min=1e-2,
            epsilon_one=1e-300, epsilon_two=1e-300, device='cpu')


def _table(capsys, **kw):
    out = spg(lambda x: torch.sum(x * x), lambda x: 2.0 * x,
              np.full((2,), 3.0), max_iterations=50, device='cpu', **kw)
    return out, capsys.readouterr().out.splitlines()


def test_spg_verbose_prints_reference_table(capsys):
    _, lines = _table(capsys, verbose=1)
    assert lines[0].split('|')[0].strip() == 'n_iter'
    assert 'conv_crit' in lines[0] and 'time' in lines[0]
    assert lines[1] == '-' * 79
    assert '-1.000000e+00' in lines[2]   # the zeroth row's conv_crit
    assert any('*** Converged at iteration' in ln for ln in lines)


def test_spg_verbose_table_has_a_row_per_iteration(capsys):
    """The port's table is printed live, row by row (the JAX package
    buffers it on backends without host callbacks): a zeroth row and
    one per iteration, the footer, and the quiet solve's numbers."""
    (x, _, n_iter, n_feval), lines = _table(capsys, verbose=1)
    rows = [ln for ln in lines if ln.count('|') == 4][1:]
    assert len(rows) == n_iter + 1
    assert [int(r.split('|')[0]) for r in rows] == list(range(n_iter + 1))
    assert int(rows[-1].split('|')[1]) == n_feval
    (x_q, _, n_q, nf_q), quiet = _table(capsys)
    assert quiet == []
    assert n_iter == n_q and n_feval == nf_q
    np.testing.assert_array_equal(x.numpy(), x_q.numpy())


# -- held to the JAX spg ----------------------------------------------------


def _problems():
    f_q, df_q = _quartic()
    T = np.random.RandomState(2).standard_normal((4, 6))
    Tt = _t(T)
    rf_t, rdf_t = _rosenbrock(torch)
    rf_j, rdf_j = _rosenbrock(jnp)
    return {
        'unconstrained': (
            (lambda x: x * x, lambda x: 2.0 * x, None),
            (lambda x: x * x, lambda x: 2.0 * x, None),
            np.float64(7.3), dict(max_iterations=100)),
        'box': (
            (f_q, df_q, lambda x: jnp.clip(x, -1.0, 0.5)),
            (f_q, df_q, lambda x: torch.clamp(x, -1.0, 0.5)),
            np.float64(2.4), dict(max_iterations=100)),
        'row simplex': (
            (lambda X: jnp.sum((X - T) ** 2), lambda X: 2.0 * (X - T),
             j_project_rows),
            (lambda X: torch.sum((X - Tt) ** 2), lambda X: 2.0 * (X - Tt),
             simplex_project_rows),
            np.full((4, 6), 1.0 / 6.0),
            dict(epsilon_two=1e-12, max_iterations=500)),
        'rosenbrock, memory 5': (
            (rf_j, rdf_j, None), (rf_t, rdf_t, None),
            np.array([-1.2, 1.0, -1.2, 1.0]),
            dict(memory=5, max_iterations=20)),
    }


@pytest.mark.parametrize("name", ['unconstrained', 'box', 'row simplex',
                                  'rosenbrock, memory 5'])
def test_spg_matches_jax(name):
    (fj, dfj, pj), (ft, dft, pt), x0, kw = _problems()[name]
    with warnings.catch_warnings():
        # Soft-failure warnings may fire, on both sides alike.
        warnings.simplefilter('ignore', UserWarning)
        want = j_spg(fj, dfj, x0, project=pj, **kw)
        got = spg(ft, dft, x0, project=pt, device='cpu', **kw)
    assert got[2] == int(want[2]) and got[3] == int(want[3])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=0, atol=1e-10)
    assert float(got[1]) == pytest.approx(float(want[1]), rel=1e-10,
                                          abs=1e-10)


def test_line_search_step_length_matches_jax():
    from convex_dim_red_tpu.solvers.spg import (
        line_search_step_length as j_step)
    cases = [(1.0, -2.0, 3.0, 5.0), (1.0, -2.0, 3.0, 2.9),
             (0.5, -1.0, 1.0, 1.5 + 1e-3), (1.0, -1.0, 0.0, -1.0)]
    for lam, delta, f_old, f_new in cases:
        got = line_search_step_length(*(_t(v) for v in (lam, delta, f_old,
                                                        f_new)))
        want = j_step(*(jnp.asarray(v) for v in (lam, delta, f_old, f_new)))
        assert float(got) == pytest.approx(float(want), rel=1e-15)


def test_spg_is_exported_and_sends_arrays_to_the_card():
    import convex_dim_red_tpu_torch as port
    assert port.spg is spg and 'spg' in port.__all__
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            spg(lambda x: x * x, lambda x: 2.0 * x, np.float64(1.0))


# -- utils/profiling.py (tests/test_analysis_utils.py:207-232) -------------


def test_timer_and_block_and_time():
    # The JAX package's Timer is not ported: on a card a host clock
    # without a synchronize times the enqueue.  block_and_time waits.
    result, sec = block_and_time(lambda x: x * 2, torch.ones(8), repeats=3)
    assert sec >= 0 and torch.all(result == 2.0)


def test_profiler_trace_produces_trace_files(tmp_path):
    """``trace`` writes a torch.profiler trace (CPU activity here, CUDA
    activity too on a card) that TensorBoard's profiler reads."""
    log_dir = tmp_path / "torch_trace"
    with trace(str(log_dir)) as prof:
        (torch.ones((32, 16)) @ torch.ones((16, 32))).sum()
    produced = [p for p in log_dir.rglob("*") if p.is_file()]
    assert any(p.name.endswith(".pt.trace.json") for p in produced)
    assert any('mm' in e.key for e in prof.key_averages())
