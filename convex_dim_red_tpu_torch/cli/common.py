"""Shared case-study driver machinery.

Port of convex_dim_red_tpu/cli/common.py.  Every reference driver
follows one template (reference bin/run_hadisst_aa.py:177-447 and
siblings): load netCDF → year/latitude filters → latitude weighting →
flatten → NaN-feature mask → chronological train/validation split →
(optional time-series cross-validation) → best-of-``n_init`` fit →
reconstruction metrics → netCDF output with a metric-attribute block.
Loading and writing stay numpy on the host (``pipelines``); each
analysis puts its data on its device once and fits there, the AA and
GPNH restarts as one batch (``parallel.restarts``).

Where the port differs from the JAX module:

- ``--platform`` takes 'cpu' or 'cuda' (the card, by default):
  :func:`apply_platform` gives the device, and raises where the card is
  asked for and there is none.
- Each ``jax.random.split`` of the JAX module is a sub-seed drawn in
  turn from ``random_seed`` (``parallel.sweep._sub_seeds``).
- Cross-validation splits with :func:`time_series_split`, a copy of
  sklearn's ``TimeSeriesSplit`` at its defaults, so no sklearn is
  needed.
- The analyses fit host data in torch's default dtype (float32), as
  the JAX drivers fit in JAX's (float32 unless x64 is enabled).
"""

import time

import numpy as np
import torch

from ..models._common import (QPSolverConfig, _as_generator,
                              _generator_on, make_config)
from ..models.gpnh_convex_coding import GPNHConvexCoding
from ..models.kmeans import KMeans, gap_statistic
from ..models.pca import PCA
from ..ops.stochastic_matrices import right_stochastic_matrix
from ..parallel.restarts import aa_fit_restarts, gpnh_fit_restarts
from ..parallel.sweep import _sub_seeds
from ..pipelines.dataset import Dataset, Variable, decode_cf_time, \
    open_dataset
from ..pipelines.preprocess import (latitude_weights,
                                    restore_missing_features)
from ..solvers.spg import quad_simplex_spg_batch
from ..utils.precision import matmul_precision_scope
from ..utils.validation import _host, as_input

__all__ = [
    "add_common_args",
    "apply_platform",
    "load_field",
    "aa_analysis",
    "gpnh_analysis",
    "kmeans_analysis",
    "pca_analysis",
    "build_output_dataset",
    "rmse",
    "time_series_split",
]


def rmse(a, b):
    """Root-mean-square difference of two arrays or tensors (on the
    device of the tensor, if either is one)."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        device = (a if isinstance(a, torch.Tensor) else b).device
        a, b = (torch.as_tensor(t, device=device) for t in (a, b))
        return float(torch.sqrt(torch.mean((a - b) ** 2)))
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def time_series_split(n_samples, n_splits=5):
    """The ``(train, test)`` index arrays of sklearn's
    ``TimeSeriesSplit(n_splits)`` at its defaults (no gap, no largest
    training size): ``n_splits`` test folds of ``n_samples //
    (n_splits + 1)`` samples at the end of the series, each trained on
    every sample before it."""
    if n_splits < 2:
        raise ValueError("k-fold cross-validation requires at least one "
                         "train/test split by setting n_splits=2 or more, "
                         "got n_splits=%d." % n_splits)
    n_folds = n_splits + 1
    if n_folds > n_samples:
        raise ValueError("Cannot have number of folds=%d greater than the "
                         "number of samples=%d." % (n_folds, n_samples))
    test_size = n_samples // n_folds
    indices = np.arange(n_samples)
    for start in range(n_samples - n_splits * test_size, n_samples,
                       test_size):
        yield indices[:start], indices[start:start + test_size]


def _rows(X, idx):
    return X[torch.as_tensor(idx, device=X.device)]


def _seeds(random_seed):
    """The sub-seeds of an analysis, drawn in turn from ``random_seed``
    (an integer, or None for a random one)."""
    return _sub_seeds(_as_generator(random_seed))


def _recon_rmse(data, weights, patterns):
    with matmul_precision_scope():
        return rmse(data, weights @ patterns)


def _cv_attrs(costs, rmses):
    return {
        'training_set_cost': '{:16.8e}'.format(np.mean(costs)),
        'training_set_cost_std': '{:16.8e}'.format(np.std(costs)),
        'training_set_rmse': '{:16.8e}'.format(np.mean(rmses)),
        'training_set_rmse_std': '{:16.8e}'.format(np.std(rmses)),
    }


def _inputs(training_data, validation_data, device):
    """The training data on ``device`` (:func:`utils.validation.
    as_input`), the validation data beside it (None when empty).

    A tensor keeps its dtype; host data (the drivers' float64 arrays)
    take torch's default dtype, float32 unless
    ``torch.set_default_dtype`` says otherwise, as the JAX drivers fit
    in float32 unless x64 is enabled."""
    def place(data, device):
        if isinstance(data, torch.Tensor):
            return as_input(data, device)
        return as_input(data, device).to(torch.get_default_dtype())

    X = place(training_data, device)
    V = None
    if validation_data is not None and len(validation_data):
        V = place(validation_data, X.device)
    return X, V


def add_common_args(parser, model):
    """Add the flag set shared by the reference drivers."""
    parser.add_argument('input_file', help='input data file')
    parser.add_argument('output_file', help='name of output file')
    parser.add_argument('--n-components', dest='n_components', type=int,
                        default=1, help='number of components')
    if model == 'aa':
        parser.add_argument('--delta', dest='delta', type=float, default=0.0,
                            help='dictionary relaxation parameter')
        parser.add_argument('--init', dest='init',
                            choices=['random', 'furthest_sum'],
                            default='random', help='initialization method')
    elif model == 'gpnh':
        parser.add_argument('--lambda-W', dest='lambda_W', type=float,
                            default=0.0, help='dictionary regularization')
        parser.add_argument('--init', dest='init',
                            choices=['random', 'furthest_sum'],
                            default='random', help='initialization method')
    if model in ('aa', 'gpnh'):
        parser.add_argument('--n-init', dest='n_init', type=int, default=100,
                            help='number of initializations')
        parser.add_argument('--tolerance', dest='tolerance', type=float,
                            default=1e-6, help='stopping tolerance')
        parser.add_argument('--max-iterations', dest='max_iterations',
                            type=int, default=10000,
                            help='maximum number of iterations')
    else:  # kmeans
        parser.add_argument('--init', dest='init',
                            choices=['random', 'k-means++'],
                            default='k-means++',
                            help='initialization method')
        parser.add_argument('--n-init', dest='n_init', type=int, default=10,
                            help='number of initializations')
        parser.add_argument('--tolerance', dest='tolerance', type=float,
                            default=1e-4, help='stopping tolerance')
        parser.add_argument('--max-iterations', dest='max_iterations',
                            type=int, default=10000,
                            help='maximum number of iterations')
        parser.add_argument('--n-trials', dest='n_trials', type=int,
                            default=100, help='gap statistic trials')
        parser.add_argument('--n-jobs', dest='n_jobs', type=int, default=1,
                            help='number of jobs to use (accepted for '
                                 'parity; trials run on device)')
        parser.add_argument('--reference', dest='reference',
                            choices=['uniform', 'pca'], default='uniform',
                            help='gap statistic reference distribution')
    parser.add_argument('--random-seed', dest='random_seed', type=int,
                        default=None, help='random seed')
    parser.add_argument('--verbose', dest='verbose', action='store_true',
                        help='produce verbose output')
    add_platform_arg(parser)
    return parser


def add_platform_arg(parser):
    parser.add_argument('--platform', dest='platform', default=None,
                        choices=['cpu', 'cuda'],
                        help='the device to run on (default: cuda; there '
                             'is no fallback to the CPU)')


def apply_platform(args):
    """The device of a driver's run: ``--platform`` ('cpu' or 'cuda'),
    the card by default.  Raises ``RuntimeError`` where the card is
    asked for and no CUDA device is available."""
    device = getattr(args, 'platform', None) or 'cuda'
    if device == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass --platform "
                           "cpu to run on the CPU")
    return device


def validate_common_args(args):
    if args.n_components < 1:
        raise ValueError('Number of components must be at least 1')
    if getattr(args, 'delta', 0) < 0:
        raise ValueError('Relaxation parameter must be non-negative')
    if getattr(args, 'tolerance', 1) < 0:
        raise ValueError('Stopping tolerance must be positive')
    if args.n_init < 1:
        raise ValueError('Number of initializations must be at least 1')
    if args.max_iterations < 1:
        raise ValueError('Maximum number of iterations must be at least 1')


def load_field(input_file, var_name, time_name, lat_name=None,
               start_year=None, end_year=None, min_latitude=None,
               max_latitude=None, lat_weights='none',
               restrict_to_base_period=False):
    """Load + filter a field and return the driver's working arrays.

    Returns a dict with ``data`` (n_t, *grid), ``years``, ``months``,
    ``weights`` (broadcastable to the grid), feature dim metadata, and
    the source dataset (for coordinate passthrough).
    """
    ds = open_dataset(input_file)

    if start_year is not None:
        ds = ds.sel_time_years(time_name, start_year, end_year)
    if min_latitude is not None and lat_name is not None:
        ds = ds.sel_range(lat_name, min_latitude, max_latitude)

    if restrict_to_base_period:
        # Gridded anomaly products carry base_period_* attrs; EOF/PC
        # products carry eofs_* (the climatology period the EOFs were
        # computed over — reference bin/run_jra55_pca_aa.py:247-258).
        b0 = ds.attrs.get('base_period_start_year',
                          ds.attrs.get('eofs_start_year'))
        b1 = ds.attrs.get('base_period_end_year',
                          ds.attrs.get('eofs_end_year'))
        if b0 is None or b1 is None:
            raise ValueError(
                'restrict_to_base_period needs base_period_*_year or '
                'eofs_*_year attrs on %s' % input_file)
        ds = ds.sel_time_years(time_name, int(b0), int(b1))

    var = ds[var_name]
    years, months = decode_cf_time(ds.coords[time_name]) \
        if time_name in ds.coords else (None, None)

    weights = None
    if lat_name is not None and lat_name in ds.coords:
        w = latitude_weights(ds.coords[lat_name].data, lat_weights)
        # Broadcast the 1-D latitude weights over the variable's grid.
        shape = [1] * (len(var.dims) - 1)
        lat_axis = var.dims.index(lat_name) - 1  # after dropping time
        shape[lat_axis] = w.size
        weights = w.reshape(shape)

    feature_dims = [d for d in var.dims if d != time_name]
    feature_shape = [var.data.shape[var.dims.index(d)]
                     for d in feature_dims]

    return {
        'dataset': ds,
        'data': var.data,
        'years': years,
        'months': months,
        'weights': weights,
        'feature_dims': feature_dims,
        'feature_shape': feature_shape,
        'time_values': ds.coords[time_name].data
        if time_name in ds.coords else None,
        'time_name': time_name,
    }


def _aa_transform(archetypes, data, seed, weights_cfg, max_iterations):
    """Weights for new data against fitted archetypes (reference
    archetypal_analysis.py:1151-1199): one cold batch of simplex QPs from
    random row-stochastic weights drawn from ``seed`` (an integer or a
    ``torch.Generator``), on the configured backend (``'auto'``: K2 on
    the card, the row solver on the CPU).  Returns ``(weights, cost)``,
    on ``data``'s device."""
    data = torch.as_tensor(data)
    archetypes = torch.as_tensor(archetypes, dtype=data.dtype,
                                 device=data.device)
    n_samples = data.shape[0]
    Z0 = right_stochastic_matrix(
        _generator_on(seed, data.device), (n_samples, archetypes.shape[0]),
        dtype=data.dtype, device=data.device)

    cfg = weights_cfg.kwargs()
    # kwargs() leaves out the backend: thread it through, or the
    # configured ('auto': the one-shot kernel) routing would fall back to
    # the 'xla' default, as in ArchetypalAnalysis.transform.
    cfg['backend'] = weights_cfg.backend
    cfg['max_iterations'] = int(max_iterations)
    with matmul_precision_scope():
        A = archetypes @ archetypes.T
        B = -(data @ archetypes.T)
        Z = quad_simplex_spg_batch(A, B, Z0, **cfg)
        resid = data - Z @ archetypes
    cost = 0.5 * float(torch.sum(resid * resid)) / n_samples
    return Z, cost


def aa_analysis(training_data, validation_data, *, n_components, delta,
                init, n_init, tolerance, max_iterations, random_seed,
                cross_validate=False, n_folds=10,
                dictionary_solver_kwargs=None, weights_solver_kwargs=None,
                stopping_criterion='abs_delta_f', verbose=False,
                device=None):
    """Best-of-``n_init`` AA fit + metrics (the template of reference
    bin/run_hadisst_aa.py:run_aa, the restarts as one batch).  The data
    go to ``device`` (:func:`utils.validation.as_input`).  Returns
    ``(best, attrs)``: ``aa_fit_restarts``' result (tensors) and the
    attribute block."""
    del verbose  # the JAX signature; unused there too
    seeds = _seeds(random_seed)
    weights_cfg = make_config(QPSolverConfig, weights_solver_kwargs)
    X, V = _inputs(training_data, validation_data, device)
    fit_kw = dict(delta=delta, init=init, tolerance=tolerance,
                  max_iterations=max_iterations,
                  stopping_criterion=stopping_criterion,
                  dictionary_solver_kwargs=dictionary_solver_kwargs,
                  weights_solver_kwargs=weights_solver_kwargs)

    attrs = {}
    if cross_validate:
        cv_test_costs, cv_test_rmses = [], []
        for train, test in time_series_split(X.shape[0], n_folds):
            fit_seed, transform_seed = next(seeds), next(seeds)
            fold = aa_fit_restarts(_rows(X, train), n_components, fit_seed,
                                   n_init, **fit_kw)
            Xt = _rows(X, test)
            Zt, ct = _aa_transform(fold['archetypes'], Xt, transform_seed,
                                   weights_cfg, max_iterations)
            cv_test_costs.append(ct)
            cv_test_rmses.append(_recon_rmse(Xt, Zt, fold['archetypes']))
        # DELIBERATE reference quirk, kept as in the JAX package: the
        # held-out-fold (test) statistics are recorded under the
        # 'training_set_*' attr names, exactly as the reference writes
        # them (run_hadisst_aa.py:299-302; its per-fold TRAIN stats at
        # :232 are computed but never written, so they are omitted).
        # Downstream notebooks read these names.
        attrs.update(_cv_attrs(cv_test_costs, cv_test_rmses))
        attrs['n_folds'] = '{:d}'.format(n_folds)

    fit_seed, val_seed = next(seeds), next(seeds)
    start = time.perf_counter()
    best = aa_fit_restarts(X, n_components, fit_seed, n_init, **fit_kw)
    elapsed = time.perf_counter() - start

    training_cost = best['cost']
    training_rmse = _recon_rmse(X, best['weights'], best['archetypes'])

    validation_cost = np.nan
    validation_rmse = np.nan
    if V is not None:
        Zv, validation_cost = _aa_transform(
            best['archetypes'], V, val_seed, weights_cfg, max_iterations)
        validation_rmse = _recon_rmse(V, Zv, best['archetypes'])

    if not cross_validate:
        attrs.update({
            'training_set_cost': '{:16.8e}'.format(training_cost),
            'training_set_rmse': '{:16.8e}'.format(training_rmse),
        })
    attrs.update({
        'training_set_size': '{:d}'.format(X.shape[0]),
        'test_set_cost': '{:16.8e}'.format(validation_cost),
        'test_set_rmse': '{:16.8e}'.format(validation_rmse),
        'test_set_size': '{:d}'.format(0 if V is None else V.shape[0]),
        'n_iter': '{:d}'.format(best['n_iter']),
        'avg_time_per_iter': '{:16.8e}'.format(
            elapsed / max(best['n_iter'], 1)),
        'elapsed_time': '{:16.8e}'.format(elapsed),
        'init': init,
        'n_init': '{:d}'.format(n_init),
        'delta': '{:16.8e}'.format(delta),
        'max_iterations': '{:d}'.format(max_iterations),
        'tolerance': '{:16.8e}'.format(tolerance),
    })

    return best, attrs


def gpnh_analysis(training_data, validation_data, *, n_components, lambda_W,
                  init, n_init, tolerance, max_iterations, random_seed,
                  cross_validate=False, n_folds=10,
                  weights_solver_kwargs=None,
                  stopping_criterion='abs_delta_f', verbose=False,
                  device=None):
    """Best-of-``n_init`` GPNH fit + metrics (template of reference
    bin/run_hadisst_gpnh.py).  With the drivers' inits ('random',
    'furthest_sum') the restarts run as one batch
    (``parallel.restarts.gpnh_fit_restarts``); another init fits
    ``n_init`` estimators in turn.  Returns ``(model, attrs)``: a
    ``GPNHConvexCoding`` holding the winner.  As in the JAX package, the
    validation transform leaves the validation weights in
    ``model.weights``."""
    del verbose  # the JAX signature; unused there too
    seeds = _seeds(random_seed)
    X, V = _inputs(training_data, validation_data, device)

    def estimator(seed):
        return GPNHConvexCoding(
            n_components=n_components, lambda_W=lambda_W,
            init=init or 'random', tolerance=tolerance,
            max_iterations=max_iterations, random_state=seed,
            stopping_criterion=stopping_criterion,
            require_monotonic_cost_decrease=False, device=X.device,
            weights_solver_kwargs=weights_solver_kwargs or {})

    def fit_best(data, seed):
        if init in (None, 'random', 'furthest_sum'):
            result = gpnh_fit_restarts(
                data, n_components, seed, n_init, lambda_W=lambda_W,
                init=init or 'random', tolerance=tolerance,
                max_iterations=max_iterations,
                stopping_criterion=stopping_criterion,
                weights_solver_kwargs=weights_solver_kwargs)
            model = estimator(seed)
            model.weights = result['weights']
            model.dictionary = result['dictionary']
            model.cost = result['cost']
            model.n_iter = result['n_iter']
            model.cost_deltas = result['cost_deltas']
            model.avg_time_per_iter = 0.0
            return model
        best = None  # custom init: keep the best of n_init estimator fits
        subs = _sub_seeds(seed)
        for _ in range(n_init):
            model = estimator(next(subs))
            model.fit_transform(data)
            if best is None or model.cost < best.cost:
                best = model
        return best

    attrs = {}
    if cross_validate:
        cv_test_costs, cv_test_rmses = [], []
        for train, test in time_series_split(X.shape[0], n_folds):
            fold = fit_best(_rows(X, train), next(seeds))
            Xt = _rows(X, test)
            Zt, ct = fold.transform(Xt)
            cv_test_costs.append(ct)
            cv_test_rmses.append(rmse(Xt, fold.inverse_transform(Zt)))
        attrs.update(_cv_attrs(cv_test_costs, cv_test_rmses))
        attrs['n_folds'] = '{:d}'.format(n_folds)

    start = time.perf_counter()
    best = fit_best(X, next(seeds))
    elapsed = time.perf_counter() - start
    if not best.avg_time_per_iter:
        best.avg_time_per_iter = elapsed / max(best.n_iter, 1)

    training_rmse = rmse(X, best.inverse_transform(best.weights))
    validation_cost = np.nan
    validation_rmse = np.nan
    if V is not None:
        Zv, validation_cost = best.transform(V)
        validation_rmse = rmse(V, best.inverse_transform(Zv))

    if not cross_validate:
        attrs.update({
            'training_set_cost': '{:16.8e}'.format(best.cost),
            'training_set_rmse': '{:16.8e}'.format(training_rmse),
        })
    attrs.update({
        'training_set_size': '{:d}'.format(X.shape[0]),
        'test_set_cost': '{:16.8e}'.format(validation_cost),
        'test_set_rmse': '{:16.8e}'.format(validation_rmse),
        'test_set_size': '{:d}'.format(0 if V is None else V.shape[0]),
        'n_iter': '{:d}'.format(best.n_iter),
        'avg_time_per_iter': '{:16.8e}'.format(best.avg_time_per_iter),
        'elapsed_time': '{:16.8e}'.format(elapsed),
        'init': init if init else 'random',
        'n_init': '{:d}'.format(n_init),
        'lambda_W': '{:16.8e}'.format(lambda_W),
        'max_iterations': '{:d}'.format(max_iterations),
        'tolerance': '{:16.8e}'.format(tolerance),
    })

    return best, attrs


def _cluster_sq_error(data, model):
    """Squared error of ``data`` against its nearest fitted centres."""
    labels = torch.as_tensor(model.predict(data), device=data.device)
    resid = data - model.cluster_centers_[labels]
    return float(torch.sum(resid ** 2)), resid


def kmeans_analysis(training_data, validation_data, *, n_components,
                    n_init, max_iterations, n_trials, reference,
                    random_seed, init='k-means++', tolerance=1e-4,
                    cross_validate=False, n_folds=10, verbose=False,
                    device=None):
    """K-means + gap statistic (template of reference
    bin/run_hadisst_kmeans.py:run_kmeans, including the time-series
    cross-validation branch, :203-268, without the reference's 3-index
    bug at :268).  Returns ``(model, onehot, attrs)``: the fitted
    ``KMeans``, the one-hot labels (numpy) and the attribute block."""
    del verbose  # the JAX signature; unused there too
    seeds = _seeds(random_seed)
    final_seed = next(seeds)
    X, V = _inputs(training_data, validation_data, device)

    def fit_model(data, seed):
        subs = _sub_seeds(seed)
        model = KMeans(n_clusters=n_components, init=init, n_init=n_init,
                       max_iter=max_iterations, tol=tolerance,
                       random_state=next(subs))
        model.fit(data)
        gap, sk = gap_statistic(data, model.inertia_, n_components,
                                n_trials=n_trials, reference=reference,
                                random_state=next(subs))
        return model, gap, sk

    attrs = {}
    if cross_validate:
        cv_gaps, cv_sks = [], []
        cv_test_costs, cv_test_rmses = [], []
        for train, test in time_series_split(X.shape[0], n_folds):
            fold, fold_gap, fold_sk = fit_model(_rows(X, train),
                                                next(seeds))
            cv_gaps.append(fold_gap)
            cv_sks.append(fold_sk)
            cost, resid = _cluster_sq_error(_rows(X, test), fold)
            cv_test_costs.append(cost)
            cv_test_rmses.append(float(torch.sqrt(torch.mean(resid ** 2))))
        attrs.update(_cv_attrs(cv_test_costs, cv_test_rmses))
        attrs.update({
            'training_set_gap': '{:16.8e}'.format(np.mean(cv_gaps)),
            'training_set_gap_std': '{:16.8e}'.format(np.std(cv_gaps)),
            'training_set_sk': '{:16.8e}'.format(np.mean(cv_sks)),
            'training_set_sk_std': '{:16.8e}'.format(np.std(cv_sks)),
            'n_folds': '{:d}'.format(n_folds),
        })

    start = time.perf_counter()
    model, gap, sk = fit_model(X, final_seed)
    elapsed = time.perf_counter() - start

    # One-hot labels as "weights" (reference run_hadisst_kmeans.py:336-345).
    onehot = np.eye(n_components)[model.labels_]

    validation_inertia = np.nan
    if V is not None:
        validation_inertia = _cluster_sq_error(V, model)[0]

    if not cross_validate:
        attrs['training_set_inertia'] = '{:16.8e}'.format(model.inertia_)
    attrs.update({
        'training_set_size': '{:d}'.format(X.shape[0]),
        'test_set_inertia': '{:16.8e}'.format(validation_inertia),
        'test_set_size': '{:d}'.format(0 if V is None else V.shape[0]),
        'gap_statistic': '{:16.8e}'.format(gap),
        'gap_sk': '{:16.8e}'.format(sk),
        'n_trials': '{:d}'.format(n_trials),
        'reference': reference,
        'init': init,
        'n_init': '{:d}'.format(n_init),
        'n_iter': '{:d}'.format(model.n_iter_),
        'max_iterations': '{:d}'.format(max_iterations),
        'tolerance': '{:16.8e}'.format(tolerance),
        'elapsed_time': '{:16.8e}'.format(elapsed),
    })
    return model, onehot, attrs


def pca_analysis(training_data, validation_data, *, n_components,
                 tolerance=1e-8, random_seed=None, verbose=False,
                 device=None):
    """PCA/EOF fit + metrics (the reference's ``run_pca`` cell,
    notebooks/hadisst_pca.ipynb: PCA of the weighted, flattened,
    NaN-masked anomalies; EOFs + PCs + residuals + cost attrs).

    ``training_data``/``validation_data`` are in valid-feature space and
    go to ``device``.  Returns ``(result, attrs)`` where ``result`` holds
    numpy arrays: ``pcs`` (full sample axis, training then validation),
    ``eofs`` (k, n_valid), ``means`` (n_valid,), ``residuals`` (full
    sample axis, n_valid), ``explained_variance``,
    ``explained_variance_ratio``, ``singular_values``.
    """
    del random_seed, verbose  # exact SVD; accepted for signature parity
    X, V = _inputs(training_data, validation_data, device)
    n_train, n_features = X.shape
    n_val = 0 if V is None else V.shape[0]

    start = time.perf_counter()
    model = PCA(n_components=n_components, tol=tolerance, device=X.device)
    pcs = model.fit_transform(X)
    elapsed = time.perf_counter() - start

    def residual(data, scores):
        with matmul_precision_scope():
            recon = scores @ model.components_
        resid = data - recon
        return (recon, resid,
                0.5 * float(torch.sum(resid ** 2)) / data.shape[0])

    training_recon, training_resid, training_cost = residual(X, pcs)
    training_rmse = rmse(X, training_recon)

    full_pcs = np.full((n_train + n_val, n_components), np.nan)
    full_pcs[:n_train] = _host(pcs)
    full_resid = np.full((n_train + n_val, n_features), np.nan)
    full_resid[:n_train] = _host(training_resid)

    validation_cost = np.nan
    validation_rmse = np.nan
    if n_val:
        validation_pcs = model.transform(V)
        validation_recon, validation_resid, validation_cost = residual(
            V, validation_pcs)
        validation_rmse = rmse(V, validation_recon)
        full_pcs[n_train:] = _host(validation_pcs)
        full_resid[n_train:] = _host(validation_resid)

    attrs = {
        'training_set_cost': '{:16.8e}'.format(training_cost),
        'training_set_size': '{:d}'.format(n_train),
        'training_set_rmse': '{:16.8e}'.format(training_rmse),
        'test_set_cost': '{:16.8e}'.format(validation_cost),
        'test_set_size': '{:d}'.format(n_val),
        'test_set_rmse': '{:16.8e}'.format(validation_rmse),
        'noise_variance': '{:16.8e}'.format(model.noise_variance_),
        'tolerance': '{:16.8e}'.format(tolerance),
        'elapsed_time': '{:16.8e}'.format(elapsed),
    }
    result = {
        'pcs': full_pcs,
        'eofs': _host(model.components_),
        'means': _host(model.mean_),
        'residuals': full_resid,
        'explained_variance': np.asarray(model.explained_variance_),
        'explained_variance_ratio':
            np.asarray(model.explained_variance_ratio_),
        'singular_values': np.asarray(model.singular_values_),
    }
    return result, attrs


def build_output_dataset(*, weights, dictionary_over_samples, patterns,
                         cost_deltas, time_values, time_name, time_attrs,
                         feature_dims, feature_shape, feature_coords,
                         missing_mask, n_components, attrs,
                         pattern_name='archetypes'):
    """Assemble the driver output Dataset (same variable/attr schema as
    the reference drivers' xr.Dataset, run_hadisst_aa.py:292-393).
    Tensors are copied to the host."""
    weights = _host(weights)
    n_train = weights.shape[0]
    component = Variable(('component',), np.arange(n_components))
    coords = {'component': component}
    if time_values is not None:
        coords[time_name] = Variable((time_name,), time_values[:n_train],
                                     time_attrs or {})
    for name, var in (feature_coords or {}).items():
        coords[name] = var

    full_patterns = restore_missing_features(_host(patterns), missing_mask)
    full_patterns = full_patterns.reshape([n_components] +
                                          list(feature_shape))

    data_vars = {
        'weights': Variable((time_name, 'component'), weights),
        'dictionary': Variable(('component', time_name),
                               _host(dictionary_over_samples))
        if dictionary_over_samples is not None else None,
        pattern_name: Variable(tuple(['component'] + list(feature_dims)),
                               full_patterns),
        'cost_deltas': Variable(('iteration',), _host(cost_deltas))
        if cost_deltas is not None else None,
    }
    data_vars = {k: v for k, v in data_vars.items() if v is not None}
    return Dataset(data_vars, coords, dict(attrs))
