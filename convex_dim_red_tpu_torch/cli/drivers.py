"""Case-study driver mains.

Port of convex_dim_red_tpu/cli/drivers.py: nine drivers mirroring the
reference ``bin/`` CLIs (same flags, same output variable/attribute
schema; reference bin/run_hadisst_aa.py and siblings), built on the
shared template in :mod:`.common`, run as ``python -m
convex_dim_red_tpu_torch.cli.drivers <name> ...``.  ``--platform``
takes 'cpu' or 'cuda' (the default); reading and writing netCDF needs
``h5py`` (or ``xarray``).  The fits run in torch's default dtype,
float32, as the JAX drivers run in float32 unless x64 is enabled.
"""

import argparse
import sys

import numpy as np

from ..utils.validation import _host
from .common import (add_common_args, add_platform_arg, apply_platform,
                     validate_common_args, load_field,
                     aa_analysis, gpnh_analysis, kmeans_analysis,
                     pca_analysis, build_output_dataset)
from .specs import HADISST, JRA55_HGT, JRA55_PCS
from ..pipelines.dataset import Dataset, Variable
from ..pipelines.preprocess import (missing_feature_mask,
                                    restore_missing_features,
                                    train_validation_split,
                                    weight_and_flatten)


def _prepare(args, spec, gridded=True, standardize=False):
    """Shared load/filter/weight/flatten/split preamble."""
    var_name = spec.var_name
    if getattr(args, 'standardized', False) and spec.std_var_name:
        var_name = spec.std_var_name

    field = load_field(
        args.input_file, var_name, spec.time_name,
        lat_name=spec.lat_name if gridded else None,
        start_year=spec.start_year, end_year=spec.end_year,
        min_latitude=spec.min_latitude, max_latitude=spec.max_latitude,
        lat_weights=getattr(args, 'lat_weights', spec.default_lat_weights),
        restrict_to_base_period=getattr(args, 'restrict_to_base_period',
                                        False))

    flat = weight_and_flatten(field['data'], field['weights'])
    missing = missing_feature_mask(flat)
    valid = flat[:, ~missing]

    if standardize and getattr(args, 'standardize', False):
        valid = valid / np.std(valid, axis=0, keepdims=True)

    train, val, n_train = train_validation_split(
        valid, validation_frac=spec.validation_frac)

    ds = field['dataset']
    feature_coords = {}
    for d in field['feature_dims']:
        if d in ds.coords:
            feature_coords[d] = ds.coords[d]

    return field, missing, train, val, n_train, feature_coords


def _write_output(args, spec, field, missing, result_vars, attrs,
                  n_train, feature_coords, pattern_name):
    ds = field['dataset']
    time_attrs = (ds.coords[spec.time_name].attrs
                  if spec.time_name in ds.coords else {})
    out = build_output_dataset(
        weights=result_vars['weights'],
        dictionary_over_samples=result_vars.get('dictionary'),
        patterns=result_vars['patterns'],
        cost_deltas=result_vars.get('cost_deltas'),
        time_values=field['time_values'],
        time_name=spec.time_name, time_attrs=time_attrs,
        feature_dims=field['feature_dims'],
        feature_shape=field['feature_shape'],
        feature_coords=feature_coords,
        missing_mask=missing,
        n_components=args.n_components,
        attrs=attrs, pattern_name=pattern_name)
    out.attrs['input_file'] = args.input_file
    # PC (EOF-product) inputs carry the climatology period as eofs_*;
    # the reference PC drivers echo it as base_period_* on the output
    # (bin/run_jra55_pca_aa.py:268-269).
    for key, alt in (('base_period_start_year', 'eofs_start_year'),
                     ('base_period_end_year', 'eofs_end_year')):
        if key in ds.attrs:
            out.attrs[key] = str(ds.attrs[key])
        elif alt in ds.attrs:
            out.attrs[key] = str(ds.attrs[alt])
    if args.random_seed is not None:
        out.attrs['random_seed'] = '{:d}'.format(args.random_seed)
    out.to_netcdf(args.output_file)


# ---------------------------------------------------------------------------
# AA drivers
# ---------------------------------------------------------------------------


def _aa_main(spec, description, dictionary_solver_kwargs,
             weights_solver_kwargs, stopping_criterion,
             gridded=True, standardize=False, pattern_name='archetypes',
             argv=None):
    parser = argparse.ArgumentParser(description=description)
    add_common_args(parser, 'aa')
    if gridded:
        parser.add_argument('--lat-weights', dest='lat_weights',
                            choices=['none', 'cos', 'scos'],
                            default=spec.default_lat_weights)
        parser.add_argument('--cross-validate', dest='cross_validate',
                            action='store_true')
        parser.add_argument('--n-folds', dest='n_folds', type=int,
                            default=10)
        parser.add_argument('--standardized', dest='standardized',
                            action='store_true')
    # Non-gridded (PC) drivers have this too, restricting to the EOFs'
    # climatology period (reference bin/run_jra55_pca_aa.py:64, :255).
    parser.add_argument('--restrict-to-base-period',
                        dest='restrict_to_base_period',
                        action='store_true')
    if standardize:
        parser.add_argument('--standardize', dest='standardize',
                            action='store_true')
    args = parser.parse_args(argv)
    validate_common_args(args)
    device = apply_platform(args)

    field, missing, train, val, n_train, feature_coords = _prepare(
        args, spec, gridded=gridded, standardize=standardize)

    best, attrs = aa_analysis(
        train, val, n_components=args.n_components, delta=args.delta,
        init=args.init, n_init=args.n_init, tolerance=args.tolerance,
        max_iterations=args.max_iterations, random_seed=args.random_seed,
        cross_validate=getattr(args, 'cross_validate', False),
        n_folds=getattr(args, 'n_folds', 10),
        dictionary_solver_kwargs=dictionary_solver_kwargs,
        weights_solver_kwargs=weights_solver_kwargs,
        stopping_criterion=stopping_criterion, verbose=args.verbose,
        device=device)
    attrs['lat_weights'] = getattr(args, 'lat_weights', 'none')

    result_vars = {
        'weights': _host(best['weights']),
        'dictionary': _host(best['dictionary']),
        'patterns': _host(best['archetypes']),
        'cost_deltas': _host(best['cost_deltas']),
    }
    _write_output(args, spec, field, missing, result_vars, attrs,
                  n_train, feature_coords, pattern_name)


def hadisst_aa_main(argv=None):
    """Mirror of reference bin/run_hadisst_aa.py (dictionary solver
    capped at one SPG step per outer iteration, :165)."""
    _aa_main(HADISST, 'Run archetypal analysis on HadISST SST anomalies',
             dictionary_solver_kwargs={'max_iterations': 1},
             weights_solver_kwargs=None,
             stopping_criterion='abs_delta_f', argv=argv)


def jra55_pca_aa_main(argv=None):
    """Mirror of reference bin/run_jra55_pca_aa.py (both inner solvers
    capped at one step, rel_delta_f stopping, :119-130)."""
    _aa_main(JRA55_PCS,
             'Run archetypal analysis on JRA-55 hgt500 principal '
             'components',
             dictionary_solver_kwargs={'max_iterations': 1},
             weights_solver_kwargs={'max_iterations': 1},
             stopping_criterion='rel_delta_f',
             gridded=False, standardize=True, argv=argv)


# ---------------------------------------------------------------------------
# GPNH drivers
# ---------------------------------------------------------------------------


def _gpnh_main(spec, description, weights_solver_kwargs, stopping_criterion,
               gridded=True, standardize=False, argv=None):
    parser = argparse.ArgumentParser(description=description)
    add_common_args(parser, 'gpnh')
    if gridded:
        parser.add_argument('--lat-weights', dest='lat_weights',
                            choices=['none', 'cos', 'scos'],
                            default=spec.default_lat_weights)
        parser.add_argument('--cross-validate', dest='cross_validate',
                            action='store_true')
        parser.add_argument('--n-folds', dest='n_folds', type=int,
                            default=10)
        parser.add_argument('--standardized', dest='standardized',
                            action='store_true')
    # Non-gridded (PC) drivers have this too, restricting to the EOFs'
    # climatology period (reference bin/run_jra55_pca_aa.py:64, :255).
    parser.add_argument('--restrict-to-base-period',
                        dest='restrict_to_base_period',
                        action='store_true')
    if standardize:
        parser.add_argument('--standardize', dest='standardize',
                            action='store_true')
    args = parser.parse_args(argv)
    validate_common_args(args)
    device = apply_platform(args)

    field, missing, train, val, n_train, feature_coords = _prepare(
        args, spec, gridded=gridded, standardize=standardize)

    best, attrs = gpnh_analysis(
        train, val, n_components=args.n_components, lambda_W=args.lambda_W,
        init=args.init, n_init=args.n_init, tolerance=args.tolerance,
        max_iterations=args.max_iterations, random_seed=args.random_seed,
        cross_validate=getattr(args, 'cross_validate', False),
        n_folds=getattr(args, 'n_folds', 10),
        weights_solver_kwargs=weights_solver_kwargs,
        stopping_criterion=stopping_criterion, verbose=args.verbose,
        device=device)
    attrs['lat_weights'] = getattr(args, 'lat_weights', 'none')

    # GPNH dictionary is (n_features, k); patterns are its columns.
    result_vars = {
        'weights': _host(best.weights),
        'dictionary': None,
        'patterns': _host(best.dictionary).T,
        'cost_deltas': _host(best.cost_deltas),
    }
    _write_output(args, spec, field, missing, result_vars, attrs,
                  n_train, feature_coords, pattern_name='dictionary')


def hadisst_gpnh_main(argv=None):
    """Mirror of reference bin/run_hadisst_gpnh.py."""
    _gpnh_main(HADISST,
               'Run GPNH convex coding on HadISST SST anomalies',
               weights_solver_kwargs=None,
               stopping_criterion='abs_delta_f', argv=argv)


def jra55_pca_gpnh_main(argv=None):
    """Mirror of reference bin/run_jra55_pca_gpnh.py (weights solver
    capped at one step, rel_delta_f, :119-129)."""
    _gpnh_main(JRA55_PCS,
               'Run GPNH convex coding on JRA-55 hgt500 principal '
               'components',
               weights_solver_kwargs={'max_iterations': 1},
               stopping_criterion='rel_delta_f',
               gridded=False, standardize=True, argv=argv)


# ---------------------------------------------------------------------------
# PCA / EOF drivers
# ---------------------------------------------------------------------------


def _pca_main(spec, description, argv=None):
    """PCA case-study driver: produces the EOFs + PCs netCDF product of
    the reference's ``run_pca`` (notebooks/hadisst_pca.ipynb) — the
    dataset the PC drivers and the pattern-correlation state sorting
    consume.  Variable/attr schema matches the notebook's Dataset:
    PCs, EOFs, means, residuals, explained_variance,
    explained_variance_ratio, singular_values."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument('input_file', help='input data file')
    parser.add_argument('output_file', help='name of output file')
    parser.add_argument('--n-components', dest='n_components', type=int,
                        default=2, help='number of components')
    parser.add_argument('--lat-weights', dest='lat_weights',
                        choices=['none', 'cos', 'scos'],
                        default=spec.default_lat_weights,
                        help='latitudinal weighting to apply')
    parser.add_argument('--tolerance', dest='tolerance', type=float,
                        default=1e-8,
                        help='SVD tolerance (parity; the SVD is exact)')
    parser.add_argument('--validation-frac', dest='validation_frac',
                        type=float, default=spec.validation_frac,
                        help='fraction of samples held out')
    parser.add_argument('--random-seed', dest='random_seed', type=int,
                        default=None, help='random seed')
    parser.add_argument('--standardized', dest='standardized',
                        action='store_true')
    parser.add_argument('--restrict-to-base-period',
                        dest='restrict_to_base_period',
                        action='store_true')
    parser.add_argument('--verbose', dest='verbose', action='store_true')
    add_platform_arg(parser)
    args = parser.parse_args(argv)
    if args.n_components < 1:
        raise ValueError('Number of components must be at least 1')
    device = apply_platform(args)

    var_name = spec.var_name
    if args.standardized and spec.std_var_name:
        var_name = spec.std_var_name
    field = load_field(
        args.input_file, var_name, spec.time_name,
        lat_name=spec.lat_name,
        start_year=spec.start_year, end_year=spec.end_year,
        min_latitude=spec.min_latitude, max_latitude=spec.max_latitude,
        lat_weights=args.lat_weights,
        restrict_to_base_period=args.restrict_to_base_period)

    flat = weight_and_flatten(field['data'], field['weights'])
    missing = missing_feature_mask(flat)
    valid = flat[:, ~missing]
    train, val, n_train = train_validation_split(
        valid, validation_frac=args.validation_frac)

    result, attrs = pca_analysis(
        train, val, n_components=args.n_components,
        tolerance=args.tolerance, random_seed=args.random_seed,
        verbose=args.verbose, device=device)
    attrs['lat_weights'] = args.lat_weights

    ds = field['dataset']
    k = args.n_components
    feature_dims = list(field['feature_dims'])
    feature_shape = list(field['feature_shape'])
    n_samples = valid.shape[0]

    def refill(values_2d, lead_shape):
        full = restore_missing_features(np.asarray(values_2d), missing)
        return full.reshape(lead_shape + feature_shape)

    coords = {'component': Variable(('component',), np.arange(k))}
    if field['time_values'] is not None:
        time_attrs = (ds.coords[spec.time_name].attrs
                      if spec.time_name in ds.coords else {})
        coords[spec.time_name] = Variable(
            (spec.time_name,), field['time_values'][:n_samples],
            time_attrs)
    for d in feature_dims:
        if d in ds.coords:
            coords[d] = ds.coords[d]

    data_vars = {
        'PCs': Variable((spec.time_name, 'component'), result['pcs']),
        'EOFs': Variable(tuple(['component'] + feature_dims),
                         refill(result['eofs'], [k])),
        'means': Variable(tuple(feature_dims),
                          refill(result['means'][None, :], [1])[0]),
        'residuals': Variable(tuple([spec.time_name] + feature_dims),
                              refill(result['residuals'], [n_samples])),
        'explained_variance': Variable(('component',),
                                       result['explained_variance']),
        'explained_variance_ratio':
            Variable(('component',), result['explained_variance_ratio']),
        'singular_values': Variable(('component',),
                                    result['singular_values']),
    }
    out = Dataset(data_vars, coords, attrs)
    out.attrs['input_file'] = args.input_file
    for key in ('base_period_start_year', 'base_period_end_year'):
        if key in ds.attrs:
            out.attrs[key] = str(ds.attrs[key])
    # The PC drivers read the EOFs' climatology period from eofs_*
    # attrs (reference bin/run_jra55_pca_aa.py:247-248): the input's
    # base period if recorded, else the analyzed year span.
    years = field['years']
    out.attrs['eofs_start_year'] = str(
        ds.attrs.get('base_period_start_year',
                     int(years.min()) if years is not None else ''))
    out.attrs['eofs_end_year'] = str(
        ds.attrs.get('base_period_end_year',
                     int(years.max()) if years is not None else ''))
    if args.random_seed is not None:
        out.attrs['random_seed'] = '{:d}'.format(args.random_seed)
    out.to_netcdf(args.output_file)


def hadisst_pca_main(argv=None):
    """Mirror of the reference hadisst_pca notebook's ``run_pca`` on the
    HadISST anomalies (notebooks/hadisst_pca.ipynb)."""
    _pca_main(HADISST,
              'Run PCA/EOF analysis on HadISST SST anomalies', argv=argv)


def jra55_pca_main(argv=None):
    """PCA of the gridded JRA-55 hgt500 anomalies, producing the PCs
    netCDF consumed by the jra55_pca_{aa,gpnh,kmeans} drivers (the
    reference's jra55 PCA notebook is a stripped large blob;
    .MISSING_LARGE_BLOBS:1)."""
    _pca_main(JRA55_HGT,
              'Run PCA/EOF analysis on JRA-55 hgt500 anomalies',
              argv=argv)


# ---------------------------------------------------------------------------
# k-means drivers
# ---------------------------------------------------------------------------


def _kmeans_main(spec, description, gridded=True, standardize=False,
                 cross_validate_flags=False, argv=None):
    parser = argparse.ArgumentParser(description=description)
    add_common_args(parser, 'kmeans')
    if gridded:
        parser.add_argument('--lat-weights', dest='lat_weights',
                            choices=['none', 'cos', 'scos'],
                            default=spec.default_lat_weights)
        parser.add_argument('--standardized', dest='standardized',
                            action='store_true')
    # Non-gridded (PC) drivers have this too, restricting to the EOFs'
    # climatology period (reference bin/run_jra55_pca_kmeans.py:255-258).
    parser.add_argument('--restrict-to-base-period',
                        dest='restrict_to_base_period',
                        action='store_true')
    if cross_validate_flags:
        parser.add_argument('--cross-validate', dest='cross_validate',
                            action='store_true',
                            help='use k-fold cross validation')
        parser.add_argument('--n-folds', dest='n_folds', type=int,
                            default=10,
                            help='number of cross-validation folds')
    if standardize:
        parser.add_argument('--standardize', dest='standardize',
                            action='store_true')
    args = parser.parse_args(argv)
    validate_common_args(args)
    device = apply_platform(args)

    field, missing, train, val, n_train, feature_coords = _prepare(
        args, spec, gridded=gridded, standardize=standardize)

    model, onehot, attrs = kmeans_analysis(
        train, val, n_components=args.n_components, init=args.init,
        n_init=args.n_init, tolerance=args.tolerance,
        max_iterations=args.max_iterations, n_trials=args.n_trials,
        reference=args.reference, random_seed=args.random_seed,
        cross_validate=getattr(args, 'cross_validate', False),
        n_folds=getattr(args, 'n_folds', 10), verbose=args.verbose,
        device=device)
    attrs['lat_weights'] = getattr(args, 'lat_weights', 'none')

    result_vars = {
        'weights': onehot,
        'dictionary': None,
        'patterns': _host(model.cluster_centers_),
        'cost_deltas': None,
    }
    _write_output(args, spec, field, missing, result_vars, attrs,
                  n_train, feature_coords, pattern_name='centroids')


def hadisst_kmeans_main(argv=None):
    """Mirror of reference bin/run_hadisst_kmeans.py (the only k-means
    driver with the --cross-validate/--n-folds flags, :63-65)."""
    _kmeans_main(HADISST,
                 'Run k-means clustering on HadISST SST anomalies',
                 cross_validate_flags=True, argv=argv)


def jra55_kmeans_main(argv=None):
    """Mirror of reference bin/run_jra55_kmeans.py (gridded hgt500)."""
    _kmeans_main(JRA55_HGT,
                 'Run k-means clustering on JRA-55 hgt500 anomalies',
                 argv=argv)


def jra55_pca_kmeans_main(argv=None):
    """Mirror of reference bin/run_jra55_pca_kmeans.py."""
    _kmeans_main(JRA55_PCS,
                 'Run k-means clustering on JRA-55 hgt500 principal '
                 'components', gridded=False, standardize=True, argv=argv)


DRIVERS = {
    'hadisst_aa': hadisst_aa_main,
    'hadisst_gpnh': hadisst_gpnh_main,
    'hadisst_kmeans': hadisst_kmeans_main,
    'hadisst_pca': hadisst_pca_main,
    'jra55_kmeans': jra55_kmeans_main,
    'jra55_pca': jra55_pca_main,
    'jra55_pca_aa': jra55_pca_aa_main,
    'jra55_pca_gpnh': jra55_pca_gpnh_main,
    'jra55_pca_kmeans': jra55_pca_kmeans_main,
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in DRIVERS:
        print('usage: python -m convex_dim_red_tpu_torch.cli.drivers '
              '{%s} ...' % ','.join(DRIVERS), file=sys.stderr)
        return 2
    return DRIVERS[argv[0]](argv[1:])


if __name__ == '__main__':
    sys.exit(main() or 0)
