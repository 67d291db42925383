"""Model-selection sweeps: best-of-``n_init`` fits for every ``k``.

Port of the AA and GPNH sweeps of convex_dim_red_tpu/parallel/sweep.py
(the k-means sweep waits for the k-means port, ROADMAP.md queue 1,
item 15).  Each ``k`` is one :func:`~.restarts.aa_fit_restarts` or
:func:`~.restarts.gpnh_fit_restarts` call; ``component_bucket`` rounds
``k`` up to a multiple of the bucket and runs the fit padded, with a
mask pinning the padded components to zero, so every result is a true
``k``-component fit.  The JAX package pads so that a bucket of ``k``
shares one compiled program; the port compiles nothing per ``k``, so
padding changes only the restarts' initial draws and the width of the
work, and stays off by default, as in the JAX package.

The sweep draws one sub-seed per ``k`` from ``seed`` (an integer or a
``torch.Generator``) whether or not that ``k`` is loaded from a
checkpoint, so a resumed sweep computes what an uninterrupted one does.
"""

import hashlib
import os
import time
import warnings

import numpy as np
import torch

from ..utils.precision import matmul_precision_scope
from ..utils.validation import _host, as_input
from .restarts import aa_fit_restarts, gpnh_fit_restarts

__all__ = ["aa_model_selection_sweep", "gpnh_model_selection_sweep"]


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


def _sweep_ckpt_save(checkpoint_dir, k, entry, fingerprint):
    if checkpoint_dir is None:
        return
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, "k_%03d.npz" % k)
    np.savez(path, _fingerprint=fingerprint,
             **{name: np.asarray(val) for name, val in entry.items()})


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


def _sweep(fit, data, ks, seed, params, checkpoint_dir, reconstruct,
           device):
    """The sweep loop: for each ``k`` a sub-seed, then the checkpoint or
    ``fit(X, k, sub_seed, pad_to)``.  ``params`` make the checkpoints'
    fingerprint; ``reconstruct(fit_result)`` gives the model's
    reconstruction of ``X``, whose RMSE is computed on the device and
    read once."""
    fp = _sweep_fingerprint(data, seed, params)
    X = as_input(data, device)
    seeds = _sub_seeds(seed)
    results = {}
    for k in ks:
        k = int(k)
        sub = next(seeds)
        done = _sweep_ckpt_load(checkpoint_dir, k, fp)
        if done is not None:
            results[k] = done
            continue
        start = time.perf_counter()
        res = fit(X, k, sub, _pad_to(k, params['component_bucket']))
        with matmul_precision_scope():
            rmse = float(torch.sqrt(torch.mean((reconstruct(res) - X)
                                               ** 2)))
        results[k] = {
            'cost': res['cost'],
            'rmse': rmse,
            'n_iter': res['n_iter'],
            'elapsed': time.perf_counter() - start,
            'costs': np.asarray(res['costs']),
        }
        _sweep_ckpt_save(checkpoint_dir, k, results[k], fp)
    return results


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
    unused, as there; ``mesh`` raises.

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

    return _sweep(fit, data, ks, seed, params, checkpoint_dir,
                  lambda res: res['weights'] @ res['archetypes'], device)


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
    'n_iter', 'elapsed', 'costs'}}``, ``rmse`` of ``Z W'``.
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

    return _sweep(fit, data, ks, seed, params, checkpoint_dir,
                  lambda res: res['weights'] @ res['dictionary'].T, device)
