"""The port's synthetic-data generators against bin/make_synthetic_*.py.

``convex_dim_red_tpu_torch.pipelines.synthetic`` keeps its own copies of
the two bin scripts, which build the JAX package's ``Dataset``.  Each
script's ``main`` runs here with that ``Dataset.to_netcdf`` recording
the dataset instead of writing it; the port's generator must give the
same variables, dims, attrs and coordinates, and arrays equal bit for
bit (same dtype, same values, NaN where the script has NaN).  The
port's command line writes a file that reads back equal to the
script's file.
"""

import os
import runpy

import numpy as np
import pytest

from convex_dim_red_tpu.pipelines import dataset as jdataset
from convex_dim_red_tpu_torch.pipelines import synthetic
from convex_dim_red_tpu_torch.pipelines.dataset import open_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (bin script, port generator, flags): small grids, seed 0 unless set.
CASES = {
    "hadisst": ("make_synthetic_hadisst.py", "hadisst",
                ["--n-years", "3", "--n-lat", "12", "--n-lon", "20"]),
    "hadisst start 1979 land 0.5 seed 3": (
        "make_synthetic_hadisst.py", "hadisst",
        ["--n-years", "2", "--n-lat", "9", "--n-lon", "14",
         "--start-year", "1979", "--land-frac", "0.5", "--seed", "3"]),
    "jra55 grid": ("make_synthetic_jra55.py", "jra55",
                   ["--n-years", "2", "--n-lat", "13", "--n-lon", "24"]),
    "jra55 grid 61 years": ("make_synthetic_jra55.py", "jra55",
                            ["--n-years", "61", "--n-lat", "5",
                             "--n-lon", "8"]),
    "jra55 pcs": ("make_synthetic_jra55.py", "jra55",
                  ["--kind", "pcs", "--n-years", "3", "--n-modes", "7"]),
    "jra55 pcs seed 2": ("make_synthetic_jra55.py", "jra55",
                         ["--kind", "pcs", "--n-years", "2", "--seed", "2",
                          "--start-year", "1990"]),
}


def _script_dataset(script, flags, monkeypatch):
    """The JAX package's Dataset that the bin script's ``main`` builds."""
    kept = []
    monkeypatch.setattr(jdataset.Dataset, "to_netcdf",
                        lambda self, path: kept.append(self))
    runpy.run_path(os.path.join(REPO, "bin", script),
                   run_name="synthetic")["main"](["unused.nc"] + flags)
    assert len(kept) == 1
    return kept[0]


def _port_dataset(which, flags, monkeypatch):
    from convex_dim_red_tpu_torch.pipelines import dataset as tdataset
    kept = []
    monkeypatch.setattr(tdataset.Dataset, "to_netcdf",
                        lambda self, path: kept.append(self))
    assert synthetic.main([which, "unused.nc"] + flags) == 0
    assert len(kept) == 1
    return kept[0]


def _assert_same(got, want):
    assert sorted(got.data_vars) == sorted(want.data_vars)
    assert sorted(got.coords) == sorted(want.coords)
    assert got.attrs == want.attrs
    for name in list(want.data_vars) + list(want.coords):
        g, w = got[name], want[name]
        assert g.dims == w.dims, name
        assert g.attrs == w.attrs, name
        assert g.data.dtype == w.data.dtype, name
        np.testing.assert_array_equal(g.data, w.data, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_generator_gives_the_bin_script_bits(case, monkeypatch):
    script, which, flags = CASES[case]
    want = _script_dataset(script, flags, monkeypatch)
    got = _port_dataset(which, flags, monkeypatch)
    _assert_same(got, want)


def test_hadisst_land_is_nan_on_every_month():
    ds = synthetic.synthetic_hadisst(n_years=2, n_lat=10, n_lon=16,
                                     land_frac=0.25)
    sst = ds['sst'].data
    land = np.isnan(sst[0])
    assert (np.isnan(sst) == land[None]).all()
    assert 0.15 <= land.mean() <= 0.35


@pytest.mark.parametrize("which,script,flags", [
    ("hadisst", "make_synthetic_hadisst.py",
     ["--n-years", "2", "--n-lat", "6", "--n-lon", "10"]),
    ("jra55", "make_synthetic_jra55.py",
     ["--kind", "pcs", "--n-years", "2", "--n-modes", "4"]),
])
def test_command_line_writes_the_bin_script_file(which, script, flags,
                                                 tmp_path, capsys):
    ours, theirs = str(tmp_path / "port.nc"), str(tmp_path / "bin.nc")
    assert synthetic.main([which, ours] + flags) == 0
    assert capsys.readouterr().out.startswith("wrote " + ours)
    runpy.run_path(os.path.join(REPO, "bin", script),
                   run_name="synthetic")["main"]([theirs] + flags)
    _assert_same(open_dataset(ours), jdataset.open_dataset(theirs))


@pytest.mark.parametrize("argv", [[], ["bogus", "out.nc"]])
def test_main_without_a_generator_returns_2(argv, capsys):
    assert synthetic.main(argv) == 2
    assert "{hadisst,jra55}" in capsys.readouterr().err


def test_jra55_rejects_an_unknown_kind():
    with pytest.raises(ValueError, match="kind"):
        synthetic.synthetic_jra55(kind='eofs')
