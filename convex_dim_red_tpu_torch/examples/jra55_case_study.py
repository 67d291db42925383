"""End-to-end JRA-55 hgt500 case study on synthetic data, on the port.

The port's counterpart of examples/jra55_case_study.py (the runnable
reconstruction of the reference's stripped combined JRA-55 notebook):
the same steps and the same artifacts, through the port's own
generator, drivers and analysis modules::

    python -m convex_dim_red_tpu_torch.examples.jra55_case_study OUT_DIR \
        [--quick] [--platform cuda|cpu]

Steps:
  1. synthesize a JRA-55-schema hgt500 anomaly grid
     (``pipelines.synthetic jra55``);
  2. the jra55_pca driver: the EOFs + PCs netCDF product;
  3. the PC-space drivers jra55_pca_aa, jra55_pca_gpnh and
     jra55_pca_kmeans (gap statistic with the PCA reference), and the
     gridded jra55_kmeans;
  4. the notebook analog: PC-space states projected back to grid
     patterns through the EOFs, every method's states sorted by pattern
     correlation against the leading EOFs, AA archetypes matched to the
     gridded k-means centroids, an AA model-selection sweep over k in
     PC space, and the artifact inventory: per-method grid-state maps
     and the EOF maps (PNG), ``state_sort.csv``,
     ``cross_method_match.csv``, ``model_selection.csv`` and its curve.

Every fit runs on ``--platform`` (the card by default; with no card it
raises).  The drivers read and write netCDF, which needs ``h5py``; the
figures need ``matplotlib``.
"""

import csv
import os

import numpy as np

from ._common import (parse_args, read_model_selection, run_module,
                      save_figure)

K = 4        # states per method
N_MODES = 6  # EOF truncation


def main(argv=None):
    args = parse_args("The JRA-55 case study on synthetic data", argv)
    quick, out_dir = args.quick, args.out_dir

    def driver(name, in_path, *extra):
        out = os.path.join(out_dir, "%s.nc" % name)
        run_module("cli.drivers", name, in_path, out, "--random-seed", "0",
                   *extra, "--platform", args.platform)
        return out

    grid = os.path.join(out_dir, "hgt500_anom.nc")
    grid_args = (["--n-years", "8", "--n-lat", "12", "--n-lon", "24"]
                 if quick else ["--n-years", "20"])
    run_module("pipelines.synthetic", "jra55", grid, "--kind", "grid",
               *grid_args)

    max_iter = "120" if quick else "300"

    # EOF/PC product (the input to all three PC-space drivers).
    pca = driver("jra55_pca", grid, "--n-components", str(N_MODES))

    k = str(K)
    aa = driver("jra55_pca_aa", pca, "--n-components", k,
                "--n-init", "4" if quick else "8",
                "--tolerance", "1e-6", "--max-iterations", max_iter)
    gpnh = driver("jra55_pca_gpnh", pca, "--n-components", k,
                  "--n-init", "2" if quick else "4",
                  "--lambda-W", "1e-3",
                  "--tolerance", "1e-6", "--max-iterations", max_iter)
    pc_km = driver("jra55_pca_kmeans", pca, "--n-components", k,
                   "--n-init", "4" if quick else "10",
                   "--n-trials", "8" if quick else "20",
                   "--reference", "pca")
    grid_km = driver("jra55_kmeans", grid, "--n-components", k,
                     "--n-init", "4" if quick else "10",
                     "--n-trials", "8" if quick else "20")

    # ---- combined analysis (the missing notebook's content) -------------
    from ..pipelines.analysis import (pattern_correlation, sort_states,
                                      write_model_selection_csv)
    from ..pipelines.dataset import open_dataset

    pca_ds = open_dataset(pca)
    grid_shape = pca_ds['EOFs'].data.shape[1:]
    eof_grids = pca_ds['EOFs'].data.reshape(N_MODES, -1)
    missing = ~np.isfinite(eof_grids).all(axis=0)
    eofs_valid = eof_grids[:, ~missing]          # (modes, valid cells)
    print("EOF variance ratios:",
          np.round(pca_ds['explained_variance_ratio'].data, 3))

    # PC-space states -> grid patterns through the EOF basis.
    states = {
        'aa': open_dataset(aa)['archetypes'].data,          # (k, modes)
        'gpnh': open_dataset(gpnh)['dictionary'].data,      # (k, modes)
        'pc_kmeans': open_dataset(pc_km)['centroids'].data,  # (k, modes)
    }
    grid_states = {name: s @ eofs_valid for name, s in states.items()}
    # The gridded k-means analyzed the same lat band with the same
    # weighting, so its (NaN-refilled) centroid grids share the mask.
    grid_states['grid_kmeans'] = open_dataset(grid_km)[
        'centroids'].data.reshape(K, -1)[:, ~missing]

    # Sort every method's states against the leading EOF patterns and
    # record the table (notebook analog of the state-ordering cell).
    ref_patterns = eofs_valid[:K]
    sort_rows = []
    for name, patterns in grid_states.items():
        order, signs, corr = sort_states(patterns, ref_patterns)
        best = corr[order, np.arange(K)] * signs
        print("%-12s state order vs EOFs: %s signs %s |corr| %s"
              % (name, order.tolist(), signs.tolist(),
                 np.round(np.abs(best), 3).tolist()))
        for eof_idx in range(K):
            sort_rows.append({
                'method': name, 'eof': eof_idx,
                'state': int(order[eof_idx]),
                'sign': int(signs[eof_idx]),
                'abs_corr': float(abs(best[eof_idx]))})
    sort_csv = os.path.join(out_dir, "state_sort.csv")
    with open(sort_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(sort_rows[0]))
        w.writeheader()
        w.writerows(sort_rows)
    print("wrote", sort_csv)

    # Cross-method correspondence: AA archetypes vs k-means centroids.
    cross = pattern_correlation(grid_states['aa'],
                                grid_states['grid_kmeans'])
    match = np.argmax(np.abs(cross), axis=1)
    print("AA archetype -> closest grid-kmeans centroid:", match.tolist(),
          "corr", np.round(np.abs(cross[np.arange(K), match]), 3).tolist())
    match_csv = os.path.join(out_dir, "cross_method_match.csv")
    with open(match_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=['aa_state',
                                          'grid_kmeans_centroid',
                                          'abs_corr'])
        w.writeheader()
        for i in range(K):
            w.writerow({'aa_state': i,
                        'grid_kmeans_centroid': int(match[i]),
                        'abs_corr': float(abs(cross[i, match[i]]))})
    print("wrote", match_csv)
    print("gap statistic (grid kmeans):",
          open_dataset(grid_km).attrs.get('gap_statistic'))

    # AA model-selection curve over k in PC space.
    from ..parallel.sweep import aa_model_selection_sweep
    pcs = pca_ds['PCs'].data.astype(np.float32)
    sweep = aa_model_selection_sweep(
        pcs, ks=[2, 3] if quick else [2, 3, 4, 5], seed=0,
        n_init=4 if quick else 8, tolerance=1e-6,
        max_iterations=60 if quick else 200, init='random',
        device=args.device)
    csv_path = os.path.join(out_dir, "model_selection.csv")
    write_model_selection_csv(csv_path, sweep)
    print("wrote", csv_path)

    write_figures(out_dir, pca_ds, grid_states, grid_shape, missing)
    print("done; outputs in", out_dir)


def write_figures(out_dir, pca_ds, grid_states, grid_shape, missing):
    """The JRA-55 combined figure inventory: per-method grid-state maps
    (states refilled onto the lat/lon grid through the shared valid-cell
    mask), the EOF patterns, and the model-selection curves."""
    import matplotlib
    matplotlib.use("Agg")

    from ..pipelines.plotting import plot_model_selection, plot_patterns

    lat_name = [d for d in pca_ds['EOFs'].dims if 'lat' in d][0]
    lon_name = [d for d in pca_ds['EOFs'].dims if 'lon' in d][0]
    lats = pca_ds.coords[lat_name].data
    lons = pca_ds.coords[lon_name].data

    for name, patterns in grid_states.items():
        k = patterns.shape[0]
        full = np.full((k, missing.size), np.nan, patterns.dtype)
        full[:, ~missing] = patterns
        fig = plot_patterns(
            full.reshape((k,) + tuple(grid_shape)), lats, lons,
            titles=["%s state %d" % (name, i) for i in range(k)])
        save_figure(fig, out_dir, "jra55_%s_grid_states.png" % name)

    eofs = np.asarray(pca_ds['EOFs'].data)
    fig = plot_patterns(eofs, lats, lons,
                        titles=["EOF %d" % i for i in range(eofs.shape[0])])
    save_figure(fig, out_dir, "jra55_eof_patterns.png")

    fig = plot_model_selection(
        read_model_selection(os.path.join(out_dir, "model_selection.csv")),
        metrics=("cost", "rmse"))
    save_figure(fig, out_dir, "model_selection.png")


if __name__ == "__main__":
    main()
