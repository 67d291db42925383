"""The port's case-study drivers against the JAX package's.

Tiny synthetic HadISST- and JRA-55-schema files are built as
tests/test_pipelines.py builds them (``bin/make_synthetic_*.py``, then
the anomalies CLI).  Every driver of both packages runs once on them, in
a module-scoped fixture, with ``--platform cpu``, and the port's output
must have the JAX output's variables, dims, shapes (but for the cost
trace, whose length is the winner's iteration count), NaN pattern and
attribute keys.  The PCA products agree to 1e-8 (up to the sign of each
component), k-means on well-separated blobs reaches the same inertia,
``_aa_transform`` the same cost from other starting weights (the QP is
strictly convex), the cross-validation branches write the JAX attribute
blocks, and the ``TimeSeriesSplit`` copy gives sklearn's folds.  All in
float64 on the CPU: the drivers fit host data in the default dtype of
their framework, which tests/conftest.py makes float64 for JAX (x64) and
the ``float64_default`` fixture for torch; the drivers' float32 default
is tested last.
"""

import functools
import os
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convex_dim_red_tpu.cli import anomalies as janomalies
from convex_dim_red_tpu.cli import common as jcommon
from convex_dim_red_tpu.cli import drivers as jdrivers
from convex_dim_red_tpu.models._common import QPSolverConfig as JQPConfig
from convex_dim_red_tpu.models.archetypal_analysis import _as_key
from convex_dim_red_tpu.parallel import restarts as jrestarts
from convex_dim_red_tpu_torch.cli import anomalies as tanomalies
from convex_dim_red_tpu_torch.cli import common as tcommon
from convex_dim_red_tpu_torch.cli import drivers as tdrivers
from convex_dim_red_tpu_torch.models._common import (QPSolverConfig,
                                                     make_config)
from convex_dim_red_tpu_torch.parallel import restarts as trestarts
from convex_dim_red_tpu_torch.pipelines.dataset import open_dataset
from convex_dim_red_tpu_torch.pipelines.synthetic import synthetic_jra55
from convex_dim_red_tpu_torch.utils.interop import states_from_numpy

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Driver runs: (driver, input file key, extra flags).  Small caps keep
#: each fit short; the schema does not depend on them.
AA = ["--n-init", "2", "--tolerance", "1e-4", "--max-iterations", "8"]
KM = ["--n-init", "2", "--n-trials", "3"]
RUNS = {
    "hadisst_aa": ("anom", ["--n-components", "3"] + AA),
    "hadisst_gpnh": ("anom", ["--n-components", "2", "--lambda-W", "1e-3"]
                     + AA),
    "hadisst_kmeans": ("anom", ["--n-components", "2"] + KM),
    "hadisst_pca": ("anom", ["--n-components", "4"]),
    "jra55_kmeans": ("grid", ["--n-components", "2"] + KM),
    "jra55_pca": ("grid", ["--n-components", "3"]),
    "jra55_pca_aa": ("pcs", ["--n-components", "3", "--standardize"] + AA),
    "jra55_pca_gpnh": ("pcs", ["--n-components", "2", "--lambda-W", "1e-4"]
                       + AA),
    "jra55_pca_kmeans": ("pcs", ["--n-components", "2", "--reference",
                                 "pca"] + KM),
}


def _synthetic(script, argv):
    runpy.run_path(os.path.join(REPO, "bin", script),
                   run_name="synthetic")["main"](argv)


@pytest.fixture(scope="module", autouse=True)
def float64_default():
    """torch's default dtype float64 for this module's tests, as JAX's
    x64 is on for the whole run."""
    before = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(before)


@pytest.fixture(scope="module")
def outputs(float64_default, tmp_path_factory):
    """Every driver of both packages once: ``{(package, driver): path}``,
    and the anomaly files of both packages' anomalies CLI."""
    tmp = tmp_path_factory.mktemp("cli")
    raw, grid, pcs = (str(tmp / n) for n in ("raw.nc", "grid.nc", "pcs.nc"))
    _synthetic("make_synthetic_hadisst.py",
               [raw, "--n-years", "20", "--n-lat", "12", "--n-lon", "18",
                "--start-year", "1989"])
    _synthetic("make_synthetic_jra55.py",
               [grid, "--kind", "grid", "--n-years", "6", "--n-lat", "12",
                "--n-lon", "16"])
    _synthetic("make_synthetic_jra55.py", [pcs, "--kind", "pcs",
                                           "--n-years", "6"])
    files = {"grid": grid, "pcs": pcs}
    anomalies_args = ["--var-name", "sst", "--base-period-start-year",
                      "1994", "--base-period-end-year", "2003"]
    for package, main in (("port", tanomalies.anomalies_main),
                          ("jax", janomalies.anomalies_main)):
        files[package, "anomalies"] = str(tmp / ("anom_%s.nc" % package))
        with np.errstate(invalid="ignore"):
            main([raw, files[package, "anomalies"]] + anomalies_args)
    files["anom"] = files["port", "anomalies"]
    for name, (source, extra) in RUNS.items():
        for package, main in (("port", tdrivers.main),
                              ("jax", jdrivers.main)):
            out = str(tmp / ("%s_%s.nc" % (package, name)))
            main([name, files[source], out, "--platform", "cpu",
                  "--random-seed", "0"] + extra)
            files[package, name] = out
    return files


@pytest.mark.parametrize("name", ["anomalies"] + sorted(RUNS))
def test_driver_output_has_the_jax_schema(outputs, name):
    port = open_dataset(outputs["port", name])
    jax_out = open_dataset(outputs["jax", name])
    assert sorted(port.data_vars) == sorted(jax_out.data_vars)
    assert sorted(port.coords) == sorted(jax_out.coords)
    assert sorted(port.attrs) == sorted(jax_out.attrs)
    for var in list(jax_out.data_vars) + list(jax_out.coords):
        got, want = port[var], jax_out[var]
        assert got.dims == want.dims, var
        if 'iteration' in want.dims:
            continue  # the winner's iteration count
        assert got.data.shape == want.data.shape, var
        if np.issubdtype(want.data.dtype, np.floating):
            np.testing.assert_array_equal(np.isnan(got.data),
                                          np.isnan(want.data), err_msg=var)
        if var in jax_out.coords:
            np.testing.assert_array_equal(got.data, want.data)
    for key in ('random_seed', 'test_set_size', 'training_set_size',
                'n_init', 'lat_weights', 'base_period_start_year'):
        if key in jax_out.attrs:
            assert port.attrs[key] == jax_out.attrs[key], key
    if name == "anomalies":  # numpy both ways: the same numbers
        for var in jax_out.data_vars:
            np.testing.assert_array_equal(port[var].data, jax_out[var].data)


@pytest.mark.parametrize("name", ["hadisst_pca", "jra55_pca"])
def test_pca_products_agree_with_jax(outputs, name):
    port = open_dataset(outputs["port", name])
    jax_out = open_dataset(outputs["jax", name])
    eofs_p, eofs_j = port['EOFs'].data, jax_out['EOFs'].data
    k = eofs_j.shape[0]
    flat_p, flat_j = eofs_p.reshape(k, -1), eofs_j.reshape(k, -1)
    valid = np.isfinite(flat_j).all(axis=0)
    signs = np.sign(np.sum(flat_p[:, valid] * flat_j[:, valid], axis=1))
    np.testing.assert_allclose(signs[:, None] * flat_p[:, valid],
                               flat_j[:, valid], rtol=0, atol=1e-8)
    np.testing.assert_allclose(port['PCs'].data * signs, jax_out['PCs'].data,
                               rtol=0, atol=1e-8)
    for var in ('means', 'residuals', 'explained_variance',
                'explained_variance_ratio', 'singular_values'):
        np.testing.assert_allclose(port[var].data, jax_out[var].data,
                                   rtol=1e-8, atol=1e-8, err_msg=var)
    for key in ('training_set_cost', 'test_set_cost', 'noise_variance',
                'training_set_rmse', 'test_set_rmse'):
        assert float(port.attrs[key]) == pytest.approx(
            float(jax_out.attrs[key]), rel=1e-8), key
    assert port.attrs['eofs_start_year'] == jax_out.attrs['eofs_start_year']


def _blobs(seed, n_per=40, d=6):
    rng = np.random.RandomState(seed)
    centers = 8.0 * rng.standard_normal((3, d))
    return np.concatenate([c + 0.3 * rng.standard_normal((n_per, d))
                           for c in centers])


def test_kmeans_analysis_reaches_the_jax_inertia():
    X = _blobs(0)
    rng = np.random.RandomState(1)
    X = X[rng.permutation(len(X))]
    kw = dict(n_components=3, n_init=5, max_iterations=300, n_trials=5,
              reference='uniform', random_seed=0)
    model_j, onehot_j, attrs_j = jcommon.kmeans_analysis(X[:100], X[100:],
                                                         **kw)
    model_t, onehot_t, attrs_t = tcommon.kmeans_analysis(
        X[:100], X[100:], device='cpu', **kw)
    assert model_t.inertia_ == pytest.approx(model_j.inertia_, rel=1e-8)
    assert sorted(attrs_t) == sorted(attrs_j)
    for key in ('training_set_inertia', 'test_set_inertia'):
        assert float(attrs_t[key]) == pytest.approx(float(attrs_j[key]),
                                                    rel=1e-8)
    assert onehot_t.shape == onehot_j.shape == (100, 3)
    np.testing.assert_array_equal(onehot_t.sum(axis=1), 1.0)


def test_aa_transform_matches_jax():
    rng = np.random.RandomState(2)
    arch = rng.uniform(size=(3, 8))
    data = rng.uniform(size=(25, 8))
    Z_j, cost_j = jcommon._aa_transform(arch, data, jax.random.PRNGKey(0),
                                        make_config(JQPConfig, None), 1000)
    Z_t, cost_t = tcommon._aa_transform(
        torch.as_tensor(arch), torch.as_tensor(data), 0,
        make_config(QPSolverConfig, None), 1000)
    assert cost_t == pytest.approx(cost_j, rel=1e-8)
    np.testing.assert_allclose(Z_t.numpy(), np.asarray(Z_j), atol=1e-5)
    np.testing.assert_allclose(Z_t.sum(dim=1).numpy(), 1.0, atol=1e-12)


def test_aa_transform_threads_the_configured_backend(monkeypatch):
    captured = []
    real = tcommon.quad_simplex_spg_batch

    def spy(A, B, X0, backend="xla", **kw):
        captured.append(backend)
        return real(A, B, X0, backend=backend, **kw)

    monkeypatch.setattr(tcommon, "quad_simplex_spg_batch", spy)
    rng = np.random.RandomState(0)
    arch, data = (torch.as_tensor(rng.uniform(size=s))
                  for s in ((3, 6), (10, 6)))
    for cfg in (None, {'backend': 'xla'}, {'backend': 'pallas'}):
        Z, _ = tcommon._aa_transform(arch, data, 0,
                                     make_config(QPSolverConfig, cfg), 50)
        assert torch.allclose(Z.sum(dim=1), torch.ones(10, dtype=Z.dtype))
    assert captured == ['auto', 'xla', 'pallas']


@pytest.mark.parametrize("max_iterations", [10, 15])
def test_aa_analysis_with_scale_factors_matches_jax(max_iterations,
                                                    monkeypatch):
    """``aa_analysis`` with delta = 0.1 at the jra55_pca_aa driver's
    solver settings (both inner solvers capped at one step, rel_delta_f,
    tolerance 1e-6, random init), float64, on small synthetic PCs with
    no held-out months (the PC drivers hold none out), from the JAX
    analysis' restart states.  The JAX restarts run their grouped
    runners, which pose the scale-factor subproblem as the port does
    (tests/test_torch_restarts.py shows that the vmapped runners differ
    only by its normalisation).  Per-restart costs agree to 1e-8
    relative and alpha to 1e-8, with the same winner.  Every restart
    stops at the cap: at these caps (both inner solvers at one step) the
    alternating map amplifies a difference in rounding about tenfold
    every few iterations from the 15th on, and JAX's own two runners,
    which sum in other orders, part from each other as much as the port
    parts from either (tests/test_torch_restarts.py,
    ``test_scale_relaxed_fit_parts_from_jax_as_jax_parts_from_itself``)."""
    pcs = synthetic_jra55('pcs', n_years=5, n_modes=8)['PCs'].data
    kw = dict(n_components=3, delta=0.1, init='random', n_init=6,
              tolerance=1e-6, max_iterations=max_iterations,
              random_seed=0, dictionary_solver_kwargs={'max_iterations': 1},
              weights_solver_kwargs={'max_iterations': 1},
              stopping_criterion='rel_delta_f')
    empty = pcs[:0]
    monkeypatch.setattr(jcommon, 'aa_fit_restarts', functools.partial(
        jrestarts.aa_fit_restarts, grouped=True))
    want, want_attrs = jcommon.aa_analysis(pcs, empty, **kw)

    # The JAX analysis' fit key (jcommon.aa_analysis: one split of the
    # seed's key) and its restart states.
    k_fit = jax.random.split(_as_key(0), 3)[1]
    init = functools.partial(
        jrestarts._init_aa_state, n_samples=pcs.shape[0], n_components=3,
        init='random', diss=None, n_extra_steps=10, component_mask=None,
        do_scale=True, dtype=jnp.float64)
    states = states_from_numpy(
        *jax.vmap(init, in_axes=(0, None))(jax.random.split(k_fit, 6),
                                           jnp.asarray(0.1)),
        device='cpu', dtype=torch.float64)
    monkeypatch.setattr(trestarts, '_init_aa_state',
                        lambda *args, **kwargs: states)
    got, attrs = tcommon.aa_analysis(pcs, empty, device='cpu', **kw)

    np.testing.assert_allclose(got['costs'], want['costs'], rtol=1e-8)
    np.testing.assert_array_equal(got['n_iters'], max_iterations)
    np.testing.assert_array_equal(want['n_iters'], max_iterations)
    assert got['best_index'] == want['best_index']
    np.testing.assert_allclose(got['alpha'].numpy(),
                               np.asarray(want['alpha']), rtol=0, atol=1e-8)
    alpha = got['alpha'].numpy()
    assert np.all(np.abs(alpha - 1.0) <= 0.1 + 1e-12)
    # The dictionary is diag(alpha) C, C row-stochastic.
    np.testing.assert_allclose(
        (got['dictionary'] / got['alpha'][:, None]).sum(dim=1).numpy(), 1.0,
        atol=1e-12)
    np.testing.assert_allclose(got['archetypes'].numpy(),
                               np.asarray(want['archetypes']), atol=1e-6)
    assert sorted(attrs) == sorted(want_attrs)
    for key in ('training_set_cost', 'training_set_rmse'):
        assert float(attrs[key]) == pytest.approx(float(want_attrs[key]),
                                                  rel=1e-8)
    assert attrs['delta'] == want_attrs['delta']
    assert attrs['test_set_size'] == want_attrs['test_set_size'] == '0'


def _planted(seed, n=40, d=8, k=3):
    rng = np.random.RandomState(seed)
    Z = rng.uniform(size=(n, k))
    Z /= Z.sum(axis=1, keepdims=True)
    return Z @ rng.uniform(size=(k, d))


#: The attribute keys of each family's cross-validated analysis, as the
#: JAX package writes them (convex_dim_red_tpu/cli/common.py).
CV_KEYS = {
    "aa": {'training_set_cost', 'training_set_cost_std',
           'training_set_rmse', 'training_set_rmse_std', 'n_folds',
           'training_set_size', 'test_set_cost', 'test_set_rmse',
           'test_set_size', 'n_iter', 'avg_time_per_iter', 'elapsed_time',
           'init', 'n_init', 'delta', 'max_iterations', 'tolerance'},
    "gpnh": {'training_set_cost', 'training_set_cost_std',
             'training_set_rmse', 'training_set_rmse_std', 'n_folds',
             'training_set_size', 'test_set_cost', 'test_set_rmse',
             'test_set_size', 'n_iter', 'avg_time_per_iter',
             'elapsed_time', 'init', 'n_init', 'lambda_W',
             'max_iterations', 'tolerance'},
}


@pytest.mark.parametrize("family", ["aa", "gpnh", "kmeans"])
def test_cross_validation_attrs(family):
    X = _planted(3)
    if family == "kmeans":
        kw = dict(n_components=3, n_init=2, max_iterations=50, n_trials=3,
                  reference='uniform', random_seed=0, cross_validate=True,
                  n_folds=3)
        _, _, attrs = tcommon.kmeans_analysis(X, None, device='cpu', **kw)
        _, _, want = jcommon.kmeans_analysis(X, None, **kw)
        keys = set(want)
    else:
        analysis = (tcommon.aa_analysis if family == "aa"
                    else tcommon.gpnh_analysis)
        extra = (dict(delta=0.0, dictionary_solver_kwargs={
            'max_iterations': 1}) if family == "aa"
            else dict(lambda_W=1e-3))
        _, attrs = analysis(X, X[:5], n_components=3, init='random',
                            n_init=2, tolerance=1e-6, max_iterations=10,
                            random_seed=0, cross_validate=True, n_folds=3,
                            device='cpu', **extra)
        keys = CV_KEYS[family]
    assert set(attrs) == keys
    assert attrs['n_folds'] == '3'
    for key in ('training_set_cost', 'training_set_cost_std',
                'training_set_rmse', 'training_set_rmse_std'):
        assert np.isfinite(float(attrs[key])), key


@pytest.mark.parametrize("n_samples,n_splits", [(10, 3), (37, 4),
                                                (100, 10), (1610, 10),
                                                (7, 6)])
def test_time_series_split_gives_sklearn_folds(n_samples, n_splits):
    model_selection = pytest.importorskip("sklearn.model_selection")
    want = list(model_selection.TimeSeriesSplit(n_splits=n_splits).split(
        np.zeros((n_samples, 1))))
    got = list(tcommon.time_series_split(n_samples, n_splits))
    assert len(got) == len(want) == n_splits
    for (train, test), (train_w, test_w) in zip(got, want):
        np.testing.assert_array_equal(train, train_w)
        np.testing.assert_array_equal(test, test_w)


@pytest.mark.parametrize("n_samples,n_splits", [(5, 5), (10, 1)])
def test_time_series_split_rejects_what_sklearn_rejects(n_samples, n_splits):
    model_selection = pytest.importorskip("sklearn.model_selection")
    with pytest.raises(ValueError):
        list(model_selection.TimeSeriesSplit(n_splits=n_splits).split(
            np.zeros((n_samples, 1))))
    with pytest.raises(ValueError):
        list(tcommon.time_series_split(n_samples, n_splits))


@pytest.mark.parametrize("argv", [[], ["bogus"]])
def test_main_without_a_driver_returns_2(argv, capsys):
    assert tdrivers.main(argv) == 2
    assert "convex_dim_red_tpu_torch.cli.drivers" in capsys.readouterr().err


def test_rmse_takes_arrays_and_tensors():
    a = np.arange(6.0).reshape(2, 3)
    b = a + np.array([1.0, -1.0, 2.0])
    want = tcommon.rmse(a, b)
    assert want == pytest.approx(np.sqrt(2.0))
    assert tcommon.rmse(torch.as_tensor(a), b) == pytest.approx(want)
    assert tcommon.rmse(a, torch.as_tensor(b)) == pytest.approx(want)


@pytest.mark.parametrize("default", [torch.float32, torch.float64])
def test_analyses_fit_host_data_in_the_default_dtype(default):
    # The JAX drivers fit in float32 unless x64 is enabled; the port's
    # fit host data in torch's default dtype, float32 unless it is set.
    # A tensor keeps its own dtype.
    X = _planted(4)
    torch.set_default_dtype(default)
    try:
        Xt, Vt = tcommon._inputs(X, X[:5], 'cpu')
        model, _, attrs = tcommon.kmeans_analysis(
            X, X[:5], n_components=2, n_init=2, max_iterations=20,
            n_trials=2, reference='uniform', random_seed=0, device='cpu')
        kept, _ = tcommon._inputs(torch.as_tensor(X, dtype=torch.float64),
                                  None, 'cpu')
    finally:
        torch.set_default_dtype(torch.float64)
    assert Xt.dtype == Vt.dtype == model.cluster_centers_.dtype == default
    assert kept.dtype == torch.float64
    assert attrs['test_set_size'] == '5'
