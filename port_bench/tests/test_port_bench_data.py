"""The frozen copies of the data makers are bit-equal to their sources:
``bench.py:make_data`` (at seed 42) and the port's
``pipelines.synthetic.synthetic_jra55`` with the drivers'
preparation."""

import numpy as np
import pytest

from port_bench.recipes import jra55_grid_pcs, low_rank_standardised


def test_low_rank_is_bench_make_data_at_seed_42(monkeypatch):
    import bench
    monkeypatch.setattr(bench, "N_SAMPLES", 50)
    monkeypatch.setattr(bench, "N_FEATURES", 96)
    want = bench.make_data(np.float32)
    got = low_rank_standardised.make(42, n_samples=50, n_features=96,
                                     rank=8, noise=0.3, dtype="float32")
    assert got["X"].dtype == np.float32
    assert np.array_equal(got["X"], want)


def test_low_rank_takes_seeds_past_32_bits():
    a = low_rank_standardised.make(2 ** 31 + 5, n_samples=4, n_features=8,
                                   rank=2, noise=0.3, dtype="float32")
    b = low_rank_standardised.make(2 ** 31 + 5, n_samples=4, n_features=8,
                                   rank=2, noise=0.3, dtype="float32")
    assert np.array_equal(a["X"], b["X"])


def test_held_out_months_share_the_model():
    data = low_rank_standardised.make(3, n_samples=400, n_features=64,
                                      rank=2, noise=0.0, dtype="float64")
    Y = low_rank_standardised.held_out(data, 4, 5, noise=0.0,
                                       dtype="float64")
    # Noise-free months lie in the span of the training months.
    coef, *_ = np.linalg.lstsq(data["X"].T, Y.T, rcond=None)
    assert np.allclose(data["X"].T @ coef, Y.T, atol=1e-8)


@pytest.mark.parametrize("seed,n_years,n_lat,n_lon", [
    (0, 61, 145, 8), (7, 3, 30, 24)])
def test_jra55_grid_is_the_port_pipeline(seed, n_years, n_lat, n_lon):
    from convex_dim_red_tpu_torch.cli.specs import JRA55_HGT as spec
    from convex_dim_red_tpu_torch.pipelines import preprocess as pp
    from convex_dim_red_tpu_torch.pipelines.synthetic import synthetic_jra55
    ds = synthetic_jra55(kind="grid", start_year=spec.start_year,
                         n_years=n_years, n_lat=n_lat, n_lon=n_lon,
                         seed=seed)
    ds = ds.sel_time_years(spec.time_name, spec.start_year, spec.end_year)
    ds = ds.sel_range(spec.lat_name, spec.min_latitude, spec.max_latitude)
    weights = pp.latitude_weights(ds.coords[spec.lat_name].data,
                                  spec.default_lat_weights)
    flat = pp.weight_and_flatten(ds[spec.var_name].data, weights[:, None])
    assert not pp.missing_feature_mask(flat).any()
    train, held, _ = pp.train_validation_split(
        flat, validation_frac=spec.validation_frac)
    got_train, got_held = jra55_grid_pcs.prepared(
        seed, n_years=n_years, n_lat=n_lat, n_lon=n_lon,
        min_latitude=spec.min_latitude, max_latitude=spec.max_latitude,
        validation_frac=spec.validation_frac)
    assert np.array_equal(got_train, train)
    assert np.array_equal(got_held, held)


def test_jra55_pcs_are_the_leading_components():
    kw = dict(n_years=4, n_lat=30, n_lon=24, min_latitude=20.0,
              max_latitude=90.0, validation_frac=0.1)
    pcs = jra55_grid_pcs.make(5, n_eofs=6, **kw)["X"]
    train, held = jra55_grid_pcs.prepared(5, **kw)
    centred = train - train.mean(axis=0)
    s = np.linalg.svd(centred, compute_uv=False)
    n_train = len(train)
    assert pcs.shape == (n_train + len(held), 6)
    # The training PCs carry the leading singular values, uncorrelated.
    gram = pcs[:n_train].T @ pcs[:n_train]
    assert np.allclose(np.diag(gram), s[:6] ** 2, rtol=1e-9)
    assert np.allclose(gram - np.diag(np.diag(gram)), 0.0,
                       atol=1e-7 * s[0] ** 2)
