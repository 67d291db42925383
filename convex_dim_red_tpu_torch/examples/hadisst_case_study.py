"""End-to-end HadISST case study on synthetic data, on the port.

The port's counterpart of examples/hadisst_case_study.py: the reference
workflow (get data -> anomalies -> AA / GPNH / k-means / PCA drivers ->
notebook analysis) through the port's own generator, anomalies CLI,
drivers and analysis modules, with the same artifacts::

    python -m convex_dim_red_tpu_torch.examples.hadisst_case_study \
        OUT_DIR [--quick] [--platform cuda|cpu]

Steps:
  1. synthesize a HadISST-schema SST dataset
     (``pipelines.synthetic hadisst``);
  2. monthly and standardized anomalies (``cli.anomalies``);
  3. the hadisst_pca, hadisst_aa, hadisst_gpnh and hadisst_kmeans
     drivers;
  4. the notebook analog: the AA archetypes sorted by pattern
     correlation against the EOFs, an AA model-selection sweep over k on
     the drivers' weighted, masked matrix, and the figure inventory:
     archetype, GPNH state, centroid and EOF maps, the MDS embedding of
     the AA weights and the model-selection curves.

Every fit runs on ``--platform`` (the card by default; with no card it
raises).  The drivers read and write netCDF, which needs ``h5py``; the
figures need ``matplotlib`` (and ``sklearn`` for the MDS embedding).
"""

import os

import numpy as np

from ._common import (parse_args, read_model_selection, run_module,
                      save_figure)


def main(argv=None):
    args = parse_args("The HadISST case study on synthetic data", argv)
    quick, out_dir = args.quick, args.out_dir
    raw = os.path.join(out_dir, "raw.nc")
    anom = os.path.join(out_dir, "anom.nc")

    # --quick shrinks every knob (same steps, same artifacts).
    years, nlat, nlon = ("16", "18", "36") if quick else ("40", "36", "72")
    n_init = "4" if quick else "20"
    n_trials = "6" if quick else "20"

    run_module("pipelines.synthetic", "hadisst", raw, "--n-years", years,
               "--n-lat", nlat, "--n-lon", nlon, "--start-year", "1979")
    run_module("cli.anomalies", raw, anom, "--var-name", "sst",
               "--base-period-start-year", "1981",
               "--base-period-end-year", "1994" if quick else "2010")

    for name, extra in [
        ("hadisst_pca", ["--n-components", "4"]),
        ("hadisst_aa", ["--n-components", "4", "--n-init", n_init,
                        "--delta", "0.0", "--tolerance", "1e-5",
                        "--max-iterations", "100" if quick else "300"]),
        ("hadisst_gpnh", ["--n-components", "4", "--n-init",
                          "2" if quick else "8",
                          "--lambda-W", "1e-3", "--tolerance", "1e-5",
                          "--max-iterations", "60" if quick else "200"]),
        ("hadisst_kmeans", ["--n-components", "4", "--n-init",
                            "3" if quick else "10",
                            "--n-trials", n_trials]),
    ]:
        run_module("cli.drivers", name, anom,
                   os.path.join(out_dir, "%s.nc" % name),
                   "--random-seed", "0", *extra,
                   "--platform", args.platform)

    # ---- notebook-analog analysis --------------------------------------
    from ..pipelines.analysis import sort_states, write_model_selection_csv
    from ..pipelines.dataset import open_dataset
    from ..pipelines.preprocess import (latitude_weights,
                                        missing_feature_mask,
                                        weight_and_flatten)

    # EOFs from the hadisst_pca driver product.
    eofs_ds = open_dataset(os.path.join(out_dir, "hadisst_pca.nc"))
    print("EOF variance ratios:",
          np.round(eofs_ds['explained_variance_ratio'].data, 3))
    eof_grids = eofs_ds['EOFs'].data.reshape(4, -1)
    eof_missing = ~np.isfinite(eof_grids).all(axis=0)
    eof_patterns = eof_grids[:, ~eof_missing]

    # Pattern-correlation state sorting of the AA archetypes vs EOFs.
    # The AA driver analyzed the same latitude band with the same scos
    # weighting, so the valid-cell masks coincide.
    aa = open_dataset(os.path.join(out_dir, "hadisst_aa.nc"))
    arch = aa['archetypes'].data.reshape(4, -1)[:, ~eof_missing]
    order, signs, _ = sort_states(arch, eof_patterns)
    print("state order vs EOFs:", order.tolist(), "signs:", signs.tolist())

    # Model-selection table over k on the weighted, masked matrix the
    # drivers analyze (reference bin/run_hadisst_aa.py:32-34, :112-146).
    ds = open_dataset(anom).sel_range('latitude', -45.5, 45.5)
    weights = latitude_weights(ds.coords['latitude'].data, 'scos')
    flat = weight_and_flatten(ds['sst_anom'].data, weights[None, :, None])
    valid = flat[:, ~missing_feature_mask(flat)]

    from ..parallel.sweep import aa_model_selection_sweep
    sweep = aa_model_selection_sweep(
        valid.astype(np.float32), ks=[2, 3] if quick else [2, 3, 4, 5],
        seed=0, n_init=3 if quick else 8, tolerance=1e-5,
        max_iterations=40 if quick else 150, init='random',
        device=args.device)
    csv_path = os.path.join(out_dir, "model_selection.csv")
    write_model_selection_csv(csv_path, sweep)
    print("wrote", csv_path)

    write_figures(out_dir)
    print("done; outputs in", out_dir)


def write_figures(out_dir):
    """The combined-plots figure inventory from the driver outputs:
    archetype / GPNH state / centroid / EOF maps (plain lon/lat axes),
    the MDS embedding of the AA weights, and the model-selection
    curves."""
    import matplotlib
    matplotlib.use("Agg")

    from ..pipelines.dataset import open_dataset
    from ..pipelines.plotting import (plot_model_selection, plot_patterns,
                                      plot_state_embedding)

    for product, var, title in [
            ("hadisst_aa.nc", "archetypes", "Archetype"),
            ("hadisst_gpnh.nc", "dictionary", "GPNH state"),
            ("hadisst_kmeans.nc", "centroids", "Centroid"),
            ("hadisst_pca.nc", "EOFs", "EOF")]:
        ds = open_dataset(os.path.join(out_dir, product))
        pats = np.asarray(ds[var].data)
        lat_name = [d for d in ds[var].dims if 'lat' in d][0]
        lon_name = [d for d in ds[var].dims if 'lon' in d][0]
        fig = plot_patterns(
            pats, ds.coords[lat_name].data, ds.coords[lon_name].data,
            titles=["%s %d" % (title, i) for i in range(pats.shape[0])])
        save_figure(fig, out_dir, product.replace(".nc", "_patterns.png"))

    aa = open_dataset(os.path.join(out_dir, "hadisst_aa.nc"))
    fig = plot_state_embedding(np.asarray(aa['weights'].data), method="mds")
    save_figure(fig, out_dir, "mds_hull.png")

    fig = plot_model_selection(
        read_model_selection(os.path.join(out_dir, "model_selection.csv")),
        metrics=("cost", "rmse"))
    save_figure(fig, out_dir, "model_selection.png")


if __name__ == "__main__":
    main()
