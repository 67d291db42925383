"""Model-selection sweeps: best-of-``n_init`` fits for every ``k``.

Port of convex_dim_red_tpu/parallel/sweep.py.  Each ``k`` of the AA
and GPNH sweeps is one :func:`~.restarts.aa_fit_restarts` or
:func:`~.restarts.gpnh_fit_restarts` call; ``component_bucket`` rounds
``k`` up to a multiple of the bucket and runs the fit padded, with a
mask pinning the padded components to zero, so every result is a true
``k``-component fit.  The JAX package pads so that a bucket of ``k``
shares one compiled program; the port compiles nothing per ``k``, so
padding changes only the restarts' initial draws and the width of the
work, and stays off by default, as in the JAX package.  Each ``k`` of
the k-means sweep is a :class:`~..models.kmeans.KMeans` fit and its
:func:`~..models.kmeans.gap_statistic`.

The sweeps draw sub-seeds per ``k`` from ``seed`` (an integer or a
``torch.Generator``), one for an AA or GPNH fit, one for the k-means
fit and one for its gap, whether or not that ``k`` is loaded from a
checkpoint, so a resumed sweep computes what an uninterrupted one does.
"""

import hashlib
import os
import time
import warnings

import numpy as np
import torch

from ..models._common import _check_mesh, _fit_device
from ..models.kmeans import KMeans, gap_statistic
from ..utils.precision import matmul_precision_scope
from ..utils.validation import _host, as_input
from .mesh import _agree_object, _is_first_rank
from .restarts import aa_fit_restarts, gpnh_fit_restarts

__all__ = ["aa_model_selection_sweep", "gpnh_model_selection_sweep",
           "kmeans_model_selection_sweep"]


def _seed_fingerprint(seed):
    if isinstance(seed, torch.Generator):
        state = seed.get_state().numpy().tobytes()
        return "generator:" + hashlib.sha256(state).hexdigest()
    return "seed:%d" % int(seed)


def _sweep_fingerprint(data, seed, params):
    """Cheap fingerprint of a sweep's configuration, stored with each
    checkpoint: a resumed sweep must be the same sweep (the same data,
    seed and hyperparameters), otherwise its ``k`` points would mix
    configurations."""
    X = _host(data)
    probe = (tuple(X.shape), str(X.dtype),
             float(X.sum(dtype=np.float64)), _seed_fingerprint(seed),
             tuple(sorted((k, repr(v)) for k, v in params.items())))
    return repr(probe)


def _sweep_ckpt_load(checkpoint_dir, k, fingerprint):
    """A completed sweep point, or None.  A checkpoint written by
    another configuration (its stored fingerprint differs) is ignored,
    with a warning, and the point recomputed."""
    if checkpoint_dir is None:
        return None
    path = os.path.join(checkpoint_dir, "k_%03d.npz" % k)
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        entry = {name: (data[name].item() if data[name].ndim == 0
                        else data[name]) for name in data.files}
    if entry.pop('_fingerprint', None) != fingerprint:
        warnings.warn(
            "sweep checkpoint %s was written by a different sweep "
            "configuration (data/seed/params changed); recomputing"
            % path, UserWarning)
        return None
    return entry


def _sweep_ckpt_save(checkpoint_dir, k, entry, fingerprint, mesh=None):
    """Save a completed point; on a mesh only its first rank writes,
    through a temporary file renamed into place."""
    if checkpoint_dir is None:
        return
    if mesh is not None and not _is_first_rank(mesh):
        return
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, "k_%03d.npz" % k)
    tmp = path + ".tmp.npz"
    np.savez(tmp, _fingerprint=fingerprint,
             **{name: np.asarray(val) for name, val in entry.items()})
    os.replace(tmp, path)


def _sub_seeds(seed):
    """One integer sub-seed per ``k``, drawn in turn from ``seed`` (a
    ``torch.Generator`` advances; an integer seeds a CPU generator)."""
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    while True:
        yield int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                                device=gen.device))


def _pad_to(k, component_bucket):
    if not component_bucket:
        return None
    bucket = int(component_bucket)
    return -(-k // bucket) * bucket


def _sweep(point, data, ks, seed, params, checkpoint_dir, device,
           draws=1, mesh=None):
    """The sweep loop: for each ``k`` ``draws`` sub-seeds, then the
    checkpoint or ``point(X, k, *sub_seeds)``, the entry of that ``k``
    to which the loop adds ``elapsed``, the point's wall time.
    ``params`` make the checkpoints' fingerprint; with ``mesh`` the data
    goes to the mesh's device, and the mesh's first rank alone reads and
    writes the checkpoints."""
    _check_mesh(mesh)
    fp = _sweep_fingerprint(data, seed, params)
    X = as_input(data, _fit_device(mesh, device))
    seeds = _sub_seeds(seed)
    results = {}
    for k in ks:
        k = int(k)
        subs = [next(seeds) for _ in range(draws)]
        if mesh is None:
            done = _sweep_ckpt_load(checkpoint_dir, k, fp)
        else:
            # The first rank decides and hands its checkpoint to all, so
            # every rank skips or fits the same k, whatever files it
            # sees.
            done = _agree_object(
                _sweep_ckpt_load(checkpoint_dir, k, fp)
                if _is_first_rank(mesh) else None, mesh)
        if done is not None:
            results[k] = done
            continue
        start = time.perf_counter()
        results[k] = point(X, k, *subs)
        results[k]['elapsed'] = time.perf_counter() - start
        _sweep_ckpt_save(checkpoint_dir, k, results[k], fp, mesh)
    return results


def _fit_point(fit, reconstruct, component_bucket):
    """The point of an AA or GPNH sweep: ``fit(X, k, sub_seed, pad_to)``
    and the RMSE of ``reconstruct(fit_result)`` against ``X``, computed
    on the device and read once."""
    def point(X, k, sub):
        res = fit(X, k, sub, _pad_to(k, component_bucket))
        with matmul_precision_scope():
            rmse = float(torch.sqrt(torch.mean((reconstruct(res) - X)
                                               ** 2)))
        return {'cost': res['cost'], 'rmse': rmse, 'n_iter': res['n_iter'],
                'costs': np.asarray(res['costs'])}

    return point


def aa_model_selection_sweep(data, ks, seed, n_init=50, delta=0.0,
                             init='furthest_sum', tolerance=1e-5,
                             stopping_criterion='rel_delta_f',
                             max_iterations=500, mesh=None,
                             validation_data=None, restart_chunk=10,
                             component_bucket=None, checkpoint_dir=None,
                             device=None, **solver_kwargs):
    """Fit AA with ``n_init`` restarts for every ``k`` in ``ks``.

    ``data`` goes to its device once (``device`` as in
    :func:`~.restarts.aa_fit_restarts`); ``seed`` is an integer or a
    ``torch.Generator`` (the JAX package takes a PRNG key).
    ``component_bucket`` pads each ``k`` to the next multiple of the
    bucket (``pad_components_to``): padded components are pinned to
    zero, so each result is a true ``k``-component fit, but the restarts
    start from other draws than unpadded ones.  ``checkpoint_dir`` makes
    the sweep resumable: each completed ``k`` is saved as ``k_NNN.npz``
    and loaded on a rerun with the same configuration.
    ``solver_kwargs`` go to every fit (for example
    ``screen_iterations`` or ``dictionary_solver_kwargs``);
    ``validation_data`` is accepted for the JAX package's signature and
    unused, as there.  ``mesh`` (a DeviceMesh with a ``restarts`` axis)
    splits each fit's restarts over it (see
    :func:`~.restarts.aa_fit_restarts`); every rank calls the sweep and
    gets every result, and only the mesh's first rank reads and writes
    checkpoints (the others get what it loaded).

    Returns ``{k: {'cost', 'rmse', 'n_iter', 'elapsed', 'costs'}}``:
    ``rmse`` of the winner's reconstruction ``Z archetypes``,
    ``elapsed`` the fit's wall time with that RMSE.
    """
    del validation_data  # the JAX package's signature; unused there too
    params = dict(n_init=n_init, delta=delta, init=init,
                  tolerance=tolerance,
                  stopping_criterion=stopping_criterion,
                  max_iterations=max_iterations,
                  component_bucket=component_bucket, **solver_kwargs)

    def fit(X, k, sub, pad_to):
        return aa_fit_restarts(
            X, k, sub, n_init, delta=delta, init=init,
            tolerance=tolerance, stopping_criterion=stopping_criterion,
            max_iterations=max_iterations, mesh=mesh,
            restart_chunk=restart_chunk, pad_components_to=pad_to,
            **solver_kwargs)

    return _sweep(_fit_point(fit, lambda res: res['weights']
                             @ res['archetypes'], component_bucket),
                  data, ks, seed, params, checkpoint_dir, device,
                  mesh=mesh)


def gpnh_model_selection_sweep(data, ks, seed, n_init=50, lambda_W=0.0,
                               init='random', tolerance=1e-5,
                               stopping_criterion='rel_delta_f',
                               max_iterations=500, mesh=None,
                               restart_chunk=10, component_bucket=None,
                               checkpoint_dir=None, device=None,
                               **solver_kwargs):
    """Fit GPNH convex coding with ``n_init`` restarts for every ``k``.

    The GPNH form of :func:`aa_model_selection_sweep`, with the same
    ``seed``, ``device``, ``component_bucket`` (the masked penalty takes
    the active count, so a padded fit optimizes the ``k``-component
    objective) and ``checkpoint_dir``.  Returns ``{k: {'cost', 'rmse',
    'n_iter', 'elapsed', 'costs'}}``, ``rmse`` of ``Z W'``.  ``mesh``
    as in :func:`aa_model_selection_sweep`.
    """
    params = dict(n_init=n_init, lambda_W=lambda_W, init=init,
                  tolerance=tolerance,
                  stopping_criterion=stopping_criterion,
                  max_iterations=max_iterations,
                  component_bucket=component_bucket, **solver_kwargs)

    def fit(X, k, sub, pad_to):
        return gpnh_fit_restarts(
            X, k, sub, n_init, lambda_W=lambda_W, init=init,
            tolerance=tolerance, stopping_criterion=stopping_criterion,
            max_iterations=max_iterations, mesh=mesh,
            restart_chunk=restart_chunk, pad_components_to=pad_to,
            **solver_kwargs)

    return _sweep(_fit_point(fit, lambda res: res['weights']
                             @ res['dictionary'].T, component_bucket),
                  data, ks, seed, params, checkpoint_dir, device,
                  mesh=mesh)


def kmeans_model_selection_sweep(data, ks, seed, n_init=10, n_trials=100,
                                 reference='uniform', max_iter=300,
                                 mesh=None, checkpoint_dir=None,
                                 device=None):
    """K-means and the gap statistic for every ``k`` in ``ks`` (the
    reference's gap-based model selection, kmeans.py:81-108 and its
    notebooks).

    Each ``k`` draws two sub-seeds from ``seed``: the
    :class:`~..models.kmeans.KMeans` fit's (best of ``n_init``, at most
    ``max_iter`` iterations) and its :func:`~..models.kmeans.
    gap_statistic`'s (``n_trials`` draws from ``reference``).
    ``data``, ``device`` and ``checkpoint_dir`` are as in
    :func:`aa_model_selection_sweep`.  ``mesh`` runs the fit as
    ``KMeans(mesh=mesh)`` (rows over the sample axis, restarts over the
    restart axis) and the gap as
    :func:`~.sharded_models.sharded_gap_statistic` (trials over the
    restart axis), each giving the single-device numbers up to
    reduction order, so ``n_trials`` is not rounded up as in the JAX
    package.

    Returns ``{k: {'cost', 'gap', 'gap_sk', 'n_iter', 'elapsed'}}``,
    ``cost`` the fit's inertia.
    """
    _check_mesh(mesh)
    if mesh is not None:
        from .mesh import ensure_mesh_axes
        mesh = ensure_mesh_axes(mesh)
    params = dict(n_init=n_init, n_trials=n_trials, reference=reference,
                  max_iter=max_iter)

    def point(X, k, fit_seed, gap_seed):
        model = KMeans(n_clusters=k, n_init=n_init, max_iter=max_iter,
                       random_state=fit_seed, mesh=mesh).fit(X)
        if mesh is None:
            gap, sk = gap_statistic(X, model.inertia_, k,
                                    n_trials=n_trials, reference=reference,
                                    random_state=gap_seed)
        else:
            from .sharded_models import sharded_gap_statistic
            gap, sk = sharded_gap_statistic(
                mesh, X, model.inertia_, k, n_trials=n_trials,
                reference=reference, random_state=gap_seed)
        return {'cost': model.inertia_, 'gap': gap, 'gap_sk': sk,
                'n_iter': model.n_iter_}

    return _sweep(point, data, ks, seed, params, checkpoint_dir, device,
                  draws=2, mesh=mesh)
