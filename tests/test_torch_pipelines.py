"""The port's copies of the case-study pipelines against the JAX
package's.

``convex_dim_red_tpu_torch.pipelines`` keeps its own copies of the
numpy modules (importing the JAX package's would load JAX).  Each
preprocess and analysis function gives bit-equal results to the JAX
package's on the same inputs; ``reconstruction_rmse`` and
``model_selection_table`` also take tensors; a file written by either
package's ``Dataset.to_netcdf`` reads back the same through both
``open_dataset``s; and the CF-time and selection tests of
tests/test_pipelines.py (:47-88, :501-567) pass on the port's copy.
"""

import numpy as np
import pytest
import torch

from convex_dim_red_tpu.pipelines import analysis as janalysis
from convex_dim_red_tpu.pipelines import dataset as jdataset
from convex_dim_red_tpu.pipelines import preprocess as jpp
from convex_dim_red_tpu_torch.pipelines import analysis as tanalysis
from convex_dim_red_tpu_torch.pipelines import dataset as tdataset
from convex_dim_red_tpu_torch.pipelines import preprocess as tpp
from convex_dim_red_tpu_torch.pipelines.dataset import (Dataset, Variable,
                                                        decode_cf_time)

torch.set_num_threads(1)


def _field(seed=0, n_years=12, shape=(3, 4)):
    """A monthly field with a cycle, a trend, noise and a NaN cell."""
    rng = np.random.RandomState(seed)
    n = 12 * n_years
    t = np.arange(n, dtype=float)
    data = (10.0 + 3.0 * np.sin(2 * np.pi * t / 12) + 0.01 * t)[:, None, None]
    data = data + rng.standard_normal((n,) + shape)
    data[:, 0, 1] = np.nan
    years = 1981 + (t // 12).astype(int)
    months = (t % 12).astype(int) + 1
    return data, years, months


def _equal(got, want):
    """Bit-equal, recursing through the tuples and dicts the functions
    return (NaN where NaN)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            _equal(got[key], want[key])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


_DATA, _YEARS, _MONTHS = _field()
_FLAT = _DATA.reshape(_DATA.shape[0], -1)
_MISSING = np.isnan(_FLAT).any(axis=0)

PREPROCESS_CASES = {
    "latitude_weights cos": ("latitude_weights",
                             (np.array([-60.0, 0.0, 45.0, 90.0]), 'cos')),
    "latitude_weights scos": ("latitude_weights",
                              (np.array([-60.0, 0.0, 45.0, 90.0]), 'scos')),
    "latitude_weights none": ("latitude_weights",
                              (np.array([-60.0, 0.0]), 'none')),
    "weight_and_flatten": ("weight_and_flatten",
                           (_DATA, np.array([0.5, 1.0, 0.7])[:, None])),
    "weight_and_flatten unweighted": ("weight_and_flatten", (_DATA,)),
    "missing_feature_mask": ("missing_feature_mask", (_FLAT,)),
    "restore_missing_features": (
        "restore_missing_features",
        (np.arange(2.0 * (~_MISSING).sum()).reshape(2, -1), _MISSING)),
    "restore_missing_features int": (
        "restore_missing_features",
        (np.arange(2 * (~_MISSING).sum()).reshape(2, -1), _MISSING)),
    "train_validation_split": ("train_validation_split", (_FLAT, 0.1)),
    "moving_average_trend even": ("moving_average_trend", (_DATA, 12)),
    "moving_average_trend odd": ("moving_average_trend", (_DATA, 5)),
    "calculate_seasonal_cycle": ("calculate_seasonal_cycle",
                                 (_DATA, _YEARS, 12, 1983, 1990)),
    "calculate_polynomial_trend 1": ("calculate_polynomial_trend",
                                     (_DATA, 1)),
    "calculate_polynomial_trend 2": ("calculate_polynomial_trend",
                                     (_DATA, 2)),
    "calculate_monthly_anomalies": ("calculate_monthly_anomalies",
                                    (_DATA, _YEARS, 12, 1, 1983, 1990)),
    "standardize_by_month": ("standardize_by_month",
                             (_DATA, _MONTHS, _YEARS, (1983, 1990))),
}


@pytest.mark.parametrize("case", sorted(PREPROCESS_CASES))
def test_preprocess_bit_equal_to_jax(case):
    name, args = PREPROCESS_CASES[case]
    with np.errstate(invalid="ignore"):
        _equal(getattr(tpp, name)(*args), getattr(jpp, name)(*args))


def test_latitude_weights_rejects_unknown():
    with pytest.raises(ValueError):
        tpp.latitude_weights(np.zeros(2), 'bogus')


_RNG = np.random.RandomState(5)
_REF = _RNG.standard_normal((4, 50))
_PAT = (np.array([1, -1, 1, -1])[:, None] * _REF[[2, 0, 3, 1]]
        + 0.05 * _RNG.standard_normal((4, 50)))
_PAT_NAN = _PAT.copy()
_PAT_NAN[:, :6] = np.nan
_W = _RNG.rand(30, 4)

ANALYSIS_CASES = {
    "pattern_correlation": ("pattern_correlation", (_PAT, _REF), {}),
    "pattern_correlation nan, weighted": (
        "pattern_correlation", (_PAT_NAN.reshape(4, 5, 10), _REF),
        dict(weights=_RNG.rand(50))),
    "sort_states": ("sort_states", (_PAT_NAN, _REF), {}),
    "reconstruction_rmse": ("reconstruction_rmse",
                            (_W @ _REF + 0.1, _W, _REF), {}),
    "model_selection_table": (
        "model_selection_table",
        ({3: {'cost': 1.0, 'gap': 0.5}, 2: {'cost': 2.0, 'rmse': 0.3,
                                            'gap_sk': 0.01}},), {}),
    "embed_states": ("embed_states", (_W / _W.sum(1, keepdims=True),),
                     dict(method='mds', max_iter=20, n_init=1)),
}


@pytest.mark.parametrize("case", sorted(ANALYSIS_CASES))
def test_analysis_bit_equal_to_jax(case):
    name, args, kwargs = ANALYSIS_CASES[case]
    _equal(getattr(tanalysis, name)(*args, **kwargs),
           getattr(janalysis, name)(*args, **kwargs))


def test_analysis_takes_tensors(tmp_path):
    data, W, P = _W @ _REF + 0.1, _W, _REF
    want = janalysis.reconstruction_rmse(data, W, P)
    assert tanalysis.reconstruction_rmse(
        *(torch.as_tensor(a) for a in (data, W, P))) == want
    # NaN-aware on the tensors' device; arrays beside a tensor go there.
    holed = data.copy()
    holed[3, :7] = np.nan
    want = janalysis.reconstruction_rmse(holed, W, P)
    assert tanalysis.reconstruction_rmse(torch.as_tensor(holed), W, P) == \
        pytest.approx(want, rel=1e-12)
    results = {2: {'cost': torch.tensor(2.0, dtype=torch.float64),
                   'gap': 0.3},
               3: {'cost': 1.0, 'gap': torch.tensor(0.5,
                                                    dtype=torch.float64)}}
    plain = {k: {key: float(v) for key, v in entry.items()}
             for k, entry in results.items()}
    assert tanalysis.model_selection_table(results) == \
        janalysis.model_selection_table(plain)
    paths = [str(tmp_path / name) for name in ("port.csv", "jax.csv")]
    tanalysis.write_model_selection_csv(paths[0], results)
    janalysis.write_model_selection_csv(paths[1], plain)
    assert open(paths[0]).read() == open(paths[1]).read()


def test_plotting_helpers_produce_figures(tmp_path):
    import matplotlib
    matplotlib.use("Agg")
    from convex_dim_red_tpu_torch.pipelines.plotting import (
        plot_model_selection, plot_patterns, plot_state_embedding)

    rng = np.random.RandomState(0)
    patterns = rng.standard_normal((3, 8, 12))
    patterns[:, 2:4, 5] = np.nan
    plot_patterns(patterns, np.linspace(-40, 40, 8),
                  np.linspace(0, 330, 12)).savefig(
                      str(tmp_path / "patterns.png"))
    W = rng.rand(20, 3)
    W /= W.sum(axis=1, keepdims=True)
    plot_state_embedding(W, method="mds").savefig(
        str(tmp_path / "embedding.png"))
    plot_model_selection({2: {"cost": 2.0, "gap": 0.3, "gap_sk": 0.01},
                          3: {"cost": 1.0, "gap": 0.5, "gap_sk": 0.02}}
                         ).savefig(str(tmp_path / "selection.png"))
    for name in ("patterns", "embedding", "selection"):
        assert (tmp_path / (name + ".png")).exists()


# -- netCDF between the packages -------------------------------------------


def _dataset(module):
    rng = np.random.RandomState(0)
    return module.Dataset(
        data_vars={'x': module.Variable(
            ('time', 'lat'), rng.standard_normal((5, 3)), {'units': 'K'}),
            'n': module.Variable(('lat',), np.arange(3))},
        coords={'time': module.Variable(('time',), np.arange(5.0),
                                        {'units': 'days since 2000-1-1'}),
                'lat': module.Variable(('lat',), np.array([0.0, 10.0, 20.0]))},
        attrs={'title': 'test', 'base_period_start_year': '1981'})


def _same(a, b):
    assert sorted(a.data_vars) == sorted(b.data_vars)
    assert sorted(a.coords) == sorted(b.coords)
    assert a.attrs == b.attrs
    for name in list(a.data_vars) + list(a.coords):
        va, vb = a[name], b[name]
        assert va.dims == vb.dims and va.attrs == vb.attrs
        assert va.data.dtype == vb.data.dtype
        np.testing.assert_array_equal(va.data, vb.data)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_netcdf_reads_back_the_same_in_both_packages(tmp_path, writer):
    path = str(tmp_path / "rt.nc")
    module = tdataset if writer == "port" else jdataset
    written = _dataset(module)
    written.to_netcdf(path)
    port, jax = tdataset.open_dataset(path), jdataset.open_dataset(path)
    _same(port, jax)
    np.testing.assert_array_equal(port['x'].data, written['x'].data)
    assert port['x'].dims == ('time', 'lat')
    assert port.attrs['title'] == 'test'


def test_fill_value_decodes_to_nan(tmp_path):
    path = str(tmp_path / "fill.nc")
    data = np.arange(6.0).reshape(2, 3)
    data[0, 1] = -1e30
    Dataset({'x': Variable(('time', 'lat'), data, {'_FillValue': -1e30})},
            {'time': Variable(('time',), np.arange(2.0)),
             'lat': Variable(('lat',), np.arange(3.0))}).to_netcdf(path)
    back = tdataset.open_dataset(path)
    assert np.isnan(back['x'].data[0, 1])
    _same(back, jdataset.open_dataset(path))


# -- tests/test_pipelines.py's CF-time and selection tests -----------------


def test_decode_cf_time_days():
    t = Variable(('time',), np.array([0.0, 31.0, 59.0, 365.0]),
                 {'units': 'days since 2000-1-1'})
    years, months = decode_cf_time(t)
    assert years.tolist() == [2000, 2000, 2000, 2000]
    assert months.tolist() == [1, 2, 2, 12]


def test_decode_cf_time_hours_and_months():
    t = Variable(('time',), np.array([0.0, 24.0 * 40]),
                 {'units': 'hours since 1958-1-1'})
    years, months = decode_cf_time(t)
    assert years.tolist() == [1958, 1958]
    assert months.tolist() == [1, 2]
    t = Variable(('time',), np.array([0, 13]),
                 {'units': 'months since 1870-1-1'})
    years, months = decode_cf_time(t)
    assert years.tolist() == [1870, 1871]
    assert months.tolist() == [1, 2]


def test_sel_time_years_and_range():
    n = 48
    ds = Dataset(
        data_vars={'x': Variable(('time', 'lat'),
                                 np.arange(n * 3.0).reshape(n, 3))},
        coords={'time': Variable(('time',), np.arange(n) * 30.4375,
                                 {'units': 'days since 2000-1-1'}),
                'lat': Variable(('lat',), np.array([-50.0, 0.0, 50.0]))})
    assert ds.sel_time_years('time', 2001, 2001).dims['time'] == 12
    assert ds.sel_range('lat', -45.5, 45.5).dims['lat'] == 1


def test_decode_cf_time_fixed_calendars():
    t = Variable(('time',), np.array([0.0, 30.0, 359.0, 360.0, 719.0]),
                 {'units': 'days since 1850-1-1', 'calendar': '360_day'})
    years, months = decode_cf_time(t)
    assert years.tolist() == [1850, 1850, 1850, 1851, 1851]
    assert months.tolist() == [1, 2, 12, 1, 12]
    t = Variable(('time',), np.array([1.0]),
                 {'units': 'days since 1850-2-30', 'calendar': '360_day'})
    assert [a.tolist() for a in decode_cf_time(t)] == [[1850], [3]]
    t = Variable(('time',), np.array([0.0, 31.0, 59.0, 364.0, 365.0]),
                 {'units': 'days since 1850-1-1', 'calendar': 'noleap'})
    years, months = decode_cf_time(t)
    assert years.tolist() == [1850, 1850, 1850, 1850, 1851]
    assert months.tolist() == [1, 2, 3, 12, 1]
    t = Variable(('time',), np.array([90.0]),
                 {'units': 'days since 1999-12-1', 'calendar': '365_day'})
    assert [a.tolist() for a in decode_cf_time(t)] == [[2000], [3]]
    t = Variable(('time',), np.array([59.0, 60.0]),
                 {'units': 'days since 2001-1-1', 'calendar': 'all_leap'})
    assert [a.tolist() for a in decode_cf_time(t)] == [[2001, 2001], [2, 3]]
    t = Variable(('time',), np.array([59.0]),
                 {'units': 'days since 2000-1-1', 'calendar': 'standard'})
    assert [a.tolist() for a in decode_cf_time(t)] == [[2000], [2]]


def test_decode_cf_time_julian_calendar():
    t = Variable(('time',), np.array([0.0, 58.0, 59.0, 60.0, 365.0,
                                      366.0]),
                 {'units': 'days since 1900-1-1', 'calendar': 'julian'})
    years, months = decode_cf_time(t)
    assert years.tolist() == [1900, 1900, 1900, 1900, 1900, 1901]
    assert months.tolist() == [1, 2, 2, 3, 12, 1]
    t = Variable(('time',), np.array([59.0]),
                 {'units': 'days since 1901-1-1', 'calendar': 'julian'})
    assert [a.tolist() for a in decode_cf_time(t)] == [[1901], [3]]
    t = Variable(('time',), np.array([0.0, 24.0 * 16]),
                 {'units': 'hours since 1870-1-16', 'calendar': 'julian'})
    years, months = decode_cf_time(t)
    assert years.tolist() == [1870, 1870]
    assert months.tolist() == [1, 2]


@pytest.mark.parametrize("units,calendar,values", [
    ('days since 1870-1-1', 'standard', np.arange(0.0, 4000.0, 97.0)),
    ('hours since 1958-1-1', None, np.arange(0.0, 90000.0, 730.5)),
    ('months since 1870-1-1', None, np.arange(40.0)),
    ('years since 1900-1-1', None, np.arange(5.0)),
    ('days since 1850-1-1', '360_day', np.arange(0.0, 2000.0, 41.0)),
    ('days since 1900-3-1', 'julian', np.arange(0.0, 3000.0, 59.0)),
    ('', None, np.arange(1990, 1995))])
def test_decode_cf_time_equal_to_jax(units, calendar, values):
    attrs = {'units': units}
    if calendar:
        attrs['calendar'] = calendar
    _equal(decode_cf_time(Variable(('time',), values, attrs)),
           jdataset.decode_cf_time(jdataset.Variable(('time',), values,
                                                     attrs)))
