"""Worlds of CPU processes for the port's mesh tests.

Each ``case_*`` function runs in every rank of a gloo world started by
``convex_dim_red_tpu_torch.parallel.mesh.spawn`` (float64, tiny shapes):
it builds its meshes, runs a sharded function of the port and the same
call on one device, and returns numpy results.  :func:`run_cases` runs
a list of them in one world, since a world costs seconds to start.

Spawned processes import this module afresh, so it imports no JAX; the
tests compare the results with the JAX package in the parent.
"""

import contextlib
import sys

import numpy as np
import torch

from convex_dim_red_tpu_torch.parallel.dryrun import (planted_data,
                                                      random_states)

CPU = 'cpu'
#: Solver settings of the sharded fits here: every dictionary step is an
#: all-reduce, so the dictionary SPG is capped; the weights QP runs the
#: row solver ('xla', the JAX package's backend on the CPU).
DICT_KW = {'max_iterations': 5}
WEIGHTS_KW = {'backend': 'xla', 'max_iterations': 25}
#: The sharded fits' weights QP, run to convergence: a capped QP's
#: result follows the rounding of its Hessian, which the sample axis's
#: all-reduce changes.
FIT_WEIGHTS_KW = {'backend': 'xla', 'max_iterations': 200}


def blobs(seed, n_per=12, d=4):
    """Three well-separated Gaussian blobs: every k-means restart of
    best-of-several finds the same partition."""
    rng = np.random.RandomState(seed)
    centres = np.array([[0.0] * d, [8.0] * d, [0.0, 8.0] + [0.0] * (d - 2)])
    return np.concatenate([c + 0.5 * rng.standard_normal((n_per, d))
                           for c in centres])


def _np(out):
    """Tensors of a result (dict, tuple or single) as numpy arrays."""
    if isinstance(out, dict):
        return {k: _np(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_np(v) for v in out)
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return out


def _mesh(shape, names=("restarts", "samples")):
    from convex_dim_red_tpu_torch.parallel.mesh import create_mesh
    return create_mesh(shape, axis_names=names, device_type=CPU)


# ---------------------------------------------------------------------------
# The sharded functions (parallel/sharded_aa.py, sharded_models.py)
# ---------------------------------------------------------------------------


def case_gram(X, shape):
    from convex_dim_red_tpu_torch.parallel import distributed_gram
    return _np(distributed_gram(_mesh(shape), X))


def case_train_step(X, states, shape):
    """One sharded train step and the single-device iterate from the
    same states and settings; and the iterate's arguments as the train
    step and the restart runner each pass them from those settings."""
    from convex_dim_red_tpu_torch.parallel import (aa_fit_restarts,
                                                   restarts, sharded_aa)
    Zs, Cs, alphas, _ = states
    passed = {}

    def recording(caller, real):
        def iterate(*args, sh, **kwargs):
            passed[caller] = kwargs
            return real(*args, sh=sh, **kwargs)
        return iterate

    real = sharded_aa._aa_iterate
    sharded_aa._aa_iterate = recording('train step', real)
    restarts._aa_iterate = recording('restart runner', real)
    try:
        got = sharded_aa.sharded_aa_train_step(
            _mesh(shape), X, Zs, Cs, alphas, dict_iterations=3,
            weights_iterations=20, weights_backend='xla')
        aa_fit_restarts(X, np.shape(Zs)[-1], 0, 2, init='random',
                        max_iterations=1,
                        dictionary_solver_kwargs={'max_iterations': 3},
                        weights_solver_kwargs={'backend': 'xla',
                                               'max_iterations': 20},
                        device=CPU)
    finally:
        sharded_aa._aa_iterate = restarts._aa_iterate = real
    Xt = torch.as_tensor(X)
    iterate, _ = real(Xt, Xt @ Xt.T, sh=sharded_aa._Shard(device=CPU),
                      **passed['train step'])
    single = iterate(*(torch.as_tensor(a) for a in (Zs, Cs, alphas)))
    return {'sharded': _np(got), 'single': _np(single),
            'iterate_kwargs': _np(passed)}


def case_fit(kind, data, states, shape, delta=0.0, n_valid=None,
             max_iterations=40):
    """A sharded AA, kernel-AA or GPNH fit and the single-device
    restart-grouped fit from the same states."""
    from convex_dim_red_tpu_torch.parallel import (sharded_aa_fit,
                                                   sharded_gpnh_fit,
                                                   sharded_kernel_aa_fit)
    from convex_dim_red_tpu_torch.parallel.dryrun import (single_aa_fit,
                                                          single_gpnh_costs)
    Zs, Cs, alphas, Ws = states
    mesh = _mesh(shape)
    fit = dict(tolerance=1e-10, max_iterations=max_iterations,
               weights_solver_kwargs=FIT_WEIGHTS_KW,
               n_valid_restarts=n_valid)
    if kind == 'gpnh':
        got = sharded_gpnh_fit(mesh, data, Zs, Ws, lambda_W=1e-3, **fit)
        single = single_gpnh_costs(data, Zs, Ws, lambda_W=1e-3,
                                   max_iterations=max_iterations,
                                   weights_solver_kwargs=FIT_WEIGHTS_KW)
    else:
        fn = sharded_aa_fit if kind == 'aa' else sharded_kernel_aa_fit
        got = fn(mesh, data, Zs, Cs, alphas, delta=delta,
                 dictionary_solver_kwargs=DICT_KW, **fit)
        single = single_aa_fit(data, Zs, Cs, alphas, has_data=kind == 'aa',
                               delta=delta, max_iterations=max_iterations,
                               dictionary_solver_kwargs=DICT_KW,
                               weights_solver_kwargs=FIT_WEIGHTS_KW)[:2]
    return {'sharded': _np(got), 'single': _np(single)}


def case_kmeans(X, shape, n_init, init='k-means++'):
    from convex_dim_red_tpu_torch.models.kmeans import kmeans_fit
    from convex_dim_red_tpu_torch.parallel import sharded_kmeans_fit
    got = sharded_kmeans_fit(_mesh(shape), X, 5, n_clusters=3,
                             n_init=n_init, init=init)
    C, labels, inertia, n_iter = kmeans_fit(X, 5, n_clusters=3,
                                            n_init=n_init, init=init,
                                            device=CPU)
    return {'sharded': _np(got),
            'single': _np(dict(centroids=C, labels=labels,
                               inertia=float(inertia),
                               n_iter=int(n_iter)))}


def case_pca(X, shape):
    from convex_dim_red_tpu_torch.models.pca import pca_fit
    from convex_dim_red_tpu_torch.parallel import sharded_pca
    got = sharded_pca(_mesh(shape), X, n_components=3)
    single = pca_fit(torch.as_tensor(X), n_components=3, use_gram=True)
    return {'sharded': _np(got), 'single': _np(single)}


def case_gap(X, shape, n_trials):
    from convex_dim_red_tpu_torch.models.kmeans import gap_statistic
    from convex_dim_red_tpu_torch.parallel import sharded_gap_statistic
    got = sharded_gap_statistic(_mesh(shape), X, 10.0, 3, n_trials=n_trials,
                                random_state=2)
    single = gap_statistic(X, 10.0, 3, n_trials=n_trials, random_state=2,
                           device=CPU)
    return {'sharded': got, 'single': single}


# ---------------------------------------------------------------------------
# The restart-sharded entry points and the sweeps
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _patched_states(kind, states):
    """The entry point's initial states replaced by ``states`` (numpy,
    e.g. the JAX package's own), on every rank and in the single run."""
    from convex_dim_red_tpu_torch.parallel import restarts as trestarts
    if states is None:
        yield
        return
    name = '_init_gpnh_state' if kind == 'gpnh' else '_init_aa_state'
    tensors = tuple(torch.as_tensor(s) for s in states)
    original = getattr(trestarts, name)
    setattr(trestarts, name, lambda *args, **kwargs: tuple(
        t.clone() for t in tensors))
    try:
        yield
    finally:
        setattr(trestarts, name, original)


def case_restarts(kind, data, n_init, kwargs, states=None,
                  mesh_shape=(2,), names=("restarts",)):
    """``{aa,kernel_aa,gpnh}_fit_restarts`` on a restart mesh and on one
    device, from the same seed (or the same given states)."""
    from convex_dim_red_tpu_torch.parallel import restarts as trestarts
    fn = {'aa': trestarts.aa_fit_restarts,
          'kernel_aa': trestarts.kernel_aa_fit_restarts,
          'gpnh': trestarts.gpnh_fit_restarts}[kind]
    with _patched_states(kind, states):
        got = fn(data, 3, 7, n_init, mesh=_mesh(mesh_shape, names),
                 **kwargs)
        single = fn(data, 3, 7, n_init, device=CPU, **kwargs)
    return {'sharded': _np(got), 'single': _np(single)}


def case_sweep(kind, X, tmpdir=None):
    from convex_dim_red_tpu_torch.parallel import (
        aa_model_selection_sweep, kmeans_model_selection_sweep)
    mesh = _mesh((2,), ("restarts",))
    if kind == 'kmeans':
        mesh = _mesh((2, 1))
        kw = dict(n_init=3, n_trials=4, max_iter=50)
        fn = kmeans_model_selection_sweep
    else:
        kw = dict(n_init=3, init='random', max_iterations=30,
                  dictionary_solver_kwargs=DICT_KW,
                  weights_solver_kwargs=WEIGHTS_KW, restart_chunk=2)
        fn = aa_model_selection_sweep
    got = fn(X, [2, 3], 11, mesh=mesh, checkpoint_dir=tmpdir, **kw)
    single = fn(X, [2, 3], 11, device=CPU, **kw)
    return {'sharded': _np(got), 'single': _np(single)}


def case_sweep_resume(X, tmpdir):
    """A restart-sharded AA sweep resumed where only the first rank sees
    the checkpoint directory: the first rank's single-device sweep of
    k = 2 checkpoints there, then both ranks sweep k = 2, 3, rank 1 with
    a directory that does not exist.  Returns each rank's sweep, an
    uninterrupted single-device sweep, and what each directory holds."""
    import os
    from convex_dim_red_tpu_torch.parallel import aa_model_selection_sweep
    rank = torch.distributed.get_rank()
    kw = dict(n_init=3, init='random', max_iterations=30,
              dictionary_solver_kwargs=DICT_KW,
              weights_solver_kwargs=WEIGHTS_KW, restart_chunk=2)
    ckpt = os.path.join(tmpdir, "seen" if rank == 0 else "unseen_%d" % rank)
    if rank == 0:
        first = aa_model_selection_sweep(X, [2], 11, device=CPU,
                                         checkpoint_dir=ckpt, **kw)
    torch.distributed.barrier()
    got = aa_model_selection_sweep(X, [2, 3], 11,
                                   mesh=_mesh((2,), ("restarts",)),
                                   checkpoint_dir=ckpt, **kw)
    single = aa_model_selection_sweep(X, [2, 3], 11, device=CPU, **kw)
    return {'sharded': _np(got), 'single': _np(single),
            'first': _np(first) if rank == 0 else None,
            'files': sorted(os.listdir(ckpt)) if os.path.isdir(ckpt)
            else None}


# ---------------------------------------------------------------------------
# The estimators
# ---------------------------------------------------------------------------


def case_estimator(kind, X, init_state, shape=(1, 2), transform_rows=(),
                   fit_kw=None):
    """An estimator with ``mesh=`` and the same estimator on one device,
    from the same custom initial state: the fitted attributes, and for
    AA the transforms of ``X[:rows]`` for each of ``transform_rows``."""
    from convex_dim_red_tpu_torch import (ArchetypalAnalysis,
                                          GPNHConvexCoding, KernelAA)
    fit_kw = dict(fit_kw or {})
    cls = {'aa': ArchetypalAnalysis, 'kernel_aa': KernelAA,
           'gpnh': GPNHConvexCoding}[kind]
    data = X @ X.T if kind == 'kernel_aa' else X
    out = {}
    for name, place in (('sharded', dict(mesh=_mesh(shape))),
                        ('single', dict(device=CPU))):
        model = cls(3, init='custom', random_state=4, **place, **fit_kw)
        state = {k: torch.as_tensor(v) for k, v in init_state.items()}
        model.fit(torch.as_tensor(data), **state)
        res = {a: getattr(model, a) for a in (
            'weights', 'dictionary', 'alpha', 'cost', 'n_iter',
            'cost_deltas') if hasattr(model, a)}
        for rows in transform_rows:
            res['transform %d' % rows] = model.transform(
                torch.as_tensor(X[:rows]))
        out[name] = _np(res)
    return out


def case_kmeans_estimator(X, shape, n_init):
    from convex_dim_red_tpu_torch import KMeans
    out = {}
    for name, place in (('sharded', dict(mesh=_mesh(shape))),
                        ('single', dict(device=CPU))):
        m = KMeans(3, n_init=n_init, random_state=3, **place).fit(X)
        out[name] = _np(dict(centers=m.cluster_centers_, labels=m.labels_,
                             inertia=m.inertia_, n_iter=m.n_iter_,
                             predict=m.predict(X)))
    return out


def case_pca_estimator(X, shape):
    from convex_dim_red_tpu_torch import PCA
    out = {}
    for name, place in (('sharded', dict(mesh=_mesh(shape))),
                        ('single', dict(device=CPU, use_gram=True))):
        m = PCA(3, **place)
        scores = m.fit_transform(X)
        out[name] = _np(dict(
            scores=scores, components=m.components_, mean=m.mean_,
            explained_variance=m.explained_variance_,
            ratio=m.explained_variance_ratio_,
            noise_variance=m.noise_variance_,
            transform=m.transform(X)))
    return out


def case_resume(K, tmpdir):
    """A KernelAA fit on a mesh, saved, and resumed through the sharded
    estimator from the checkpoint; the same on one device."""
    from convex_dim_red_tpu_torch import KernelAA
    from convex_dim_red_tpu_torch.utils.checkpoint import (
        load_checkpoint, resume_kernel_aa, save_checkpoint)
    out = {}
    rank = torch.distributed.get_rank()
    for name, place in (('sharded', dict(mesh=_mesh((1, 2)))),
                        ('single', dict(device=CPU))):
        kw = dict(init='random', random_state=1, tolerance=1e-10,
                  dictionary_solver_kwargs=DICT_KW,
                  weights_solver_kwargs=WEIGHTS_KW)
        first = KernelAA(3, max_iterations=10, **kw, **place).fit(
            torch.as_tensor(K))
        path = "%s/%s_%d" % (tmpdir, name, rank)
        save_checkpoint(path, {'weights': first.weights,
                               'dictionary': first.dictionary,
                               'alpha': first.alpha, 'cost': first.cost})
        second = KernelAA(3, max_iterations=30, **kw, **place)
        resume_kernel_aa(second, torch.as_tensor(K), load_checkpoint(path))
        out[name] = _np(dict(first=first.cost, resumed=second.cost,
                             n_iter=second.n_iter,
                             weights=second.weights))
    return out


def case_errors(X):
    """The validation errors of the mesh routes, as ``(type, message)``."""
    from convex_dim_red_tpu_torch import (ArchetypalAnalysis, KMeans, PCA,
                                          GPNHConvexCoding)
    from convex_dim_red_tpu_torch.parallel import (aa_fit_restarts,
                                                   sharded_aa_fit)
    from convex_dim_red_tpu_torch.parallel.mesh import ensure_mesh_axes
    two = _mesh((2, 1))
    wrong = _mesh((2,), ("x",))
    Zs, Cs, alphas, _ = random_states(0, 3, X.shape[0], 3)
    calls = {
        'estimator restart axis 2': lambda: ArchetypalAnalysis(
            3, mesh=two).fit(torch.as_tensor(X)),
        'estimator rows do not divide': lambda: GPNHConvexCoding(
            3, mesh=_mesh((1, 2))).fit(torch.as_tensor(X[:-1])),
        'pca features do not divide': lambda: PCA(
            2, mesh=_mesh((1, 2))).fit(X[:, :-1]),
        'estimator wrong axes': lambda: KMeans(3, mesh=wrong),
        'ensure_mesh_axes wrong axes': lambda: ensure_mesh_axes(wrong),
        'restarts without the restart axis': lambda: aa_fit_restarts(
            X, 3, 0, 2, mesh=_mesh((2,), ("samples",))),
        'sharded fit restarts do not divide': lambda: sharded_aa_fit(
            two, X, Zs, Cs, alphas),
        'sharded fit unknown backend': lambda: sharded_aa_fit(
            _mesh((1, 2)), X, Zs[:2], Cs[:2], alphas[:2],
            weights_solver_kwargs={'backend': 'triton'}),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except Exception as e:  # reported to the test
            out[name] = (type(e).__name__, str(e))
    return out


def case_jax_blocked():
    """A sharded fit with ``jax`` made unimportable first: what the
    process has imported afterwards."""
    class _Block:
        def find_spec(self, name, path=None, target=None):
            if name == 'jax' or name.startswith(('jax.', 'jaxlib')) \
                    or name.startswith('convex_dim_red_tpu.') \
                    or name == 'convex_dim_red_tpu':
                raise ImportError("blocked: %s" % name)
            return None
    sys.meta_path.insert(0, _Block())
    from convex_dim_red_tpu_torch.parallel import sharded_aa_fit
    X = planted_data(0, 8, 4, 2, 0.01)
    Zs, Cs, alphas, _ = random_states(0, 2, 8, 2)
    res = sharded_aa_fit(_mesh((2, 1)), X, Zs, Cs, alphas,
                         max_iterations=5, dictionary_solver_kwargs=DICT_KW,
                         weights_solver_kwargs=WEIGHTS_KW)
    return {'cost': res['cost'],
            'modules': sorted(m for m in sys.modules
                              if m.split('.')[0] in ('jax', 'jaxlib',
                                                     'convex_dim_red_tpu'))}


def case_mesh_helpers():
    """The mesh constructors and helpers of parallel/mesh.py: shapes,
    local ranks, 1-D meshes lifted, the hybrid mesh by explicit groups
    and by host, and each rank's copy and block."""
    from convex_dim_red_tpu_torch.parallel.mesh import (
        create_hybrid_mesh, create_mesh, ensure_mesh_axes, replicate,
        shard_batch)
    world = torch.distributed.get_world_size()
    flat = create_mesh(device_type=CPU)
    lifted_s = ensure_mesh_axes(create_mesh(axis_names=("samples",),
                                            device_type=CPU))
    lifted_r = ensure_mesh_axes(create_mesh(axis_names=("restarts",),
                                            device_type=CPU))
    two_d = create_mesh((world // 2, 2), device_type=CPU)
    hybrid = create_hybrid_mesh(
        slice_groups=[[2 * g, 2 * g + 1] for g in range(world // 2)],
        device_type=CPU)
    by_host = create_hybrid_mesh(device_type=CPU)
    errors = {}
    for name, groups in (('ragged', [[0], [1, 0]]),
                         ('duplicate', [[0, 1], [1, 0]]),
                         ('empty', [])):
        try:
            create_hybrid_mesh(slice_groups=groups, device_type=CPU)
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    x = np.arange(2.0 * world * 3).reshape(2 * world, 3)

    def desc(m):
        return (tuple(m.mesh_dim_names), tuple(m.mesh.shape),
                m.mesh.tolist(), [m.get_local_rank(a)
                                  for a in m.mesh_dim_names])
    return {'flat': desc(flat), 'lifted_samples': desc(lifted_s),
            'lifted_restarts': desc(lifted_r), 'two_d': desc(two_d),
            'same_2d': ensure_mesh_axes(two_d) is two_d,
            'lifted_once': ensure_mesh_axes(lifted_s) is lifted_s,
            'hybrid': desc(hybrid), 'by_host': desc(by_host),
            'errors': errors,
            'replicate': _np(replicate(two_d, x)),
            'shard_restarts': _np(shard_batch(two_d, x)),
            'shard_samples': _np(shard_batch(two_d, x, 'samples'))}


def hang_world():
    """Rank 0 waits in a collective that rank 1 never joins."""
    import time
    from convex_dim_red_tpu_torch.parallel.mesh import _psum
    mesh = _mesh((1, torch.distributed.get_world_size()))
    if torch.distributed.get_rank() == 1:
        time.sleep(600)
    return _np(_psum(torch.ones(1), mesh, 'samples'))


def run_cases(cases):
    """Run ``cases`` (``(label, case function name, kwargs)``) in order
    in this rank; returns ``{label: result}``."""
    torch.set_default_dtype(torch.float64)
    module = sys.modules[__name__]
    return {label: getattr(module, 'case_' + name)(**kwargs)
            for label, name, kwargs in cases}


def world(cases, n_processes=2, timeout=240.0):
    """Every rank's :func:`run_cases` results, in a gloo world of
    ``n_processes`` CPU processes with the launcher's time limit."""
    from convex_dim_red_tpu_torch.parallel.mesh import spawn
    return spawn(run_cases, n_processes, args=(cases,), backend='gloo',
                 device_type=CPU, timeout=timeout)


@contextlib.contextmanager
def one_rank_world():
    """A gloo world of this process alone (in memory), for a DeviceMesh
    in a test that needs no collective; torn down on the way out."""
    import torch.distributed as dist
    dist.init_process_group('gloo', store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def bad_mesh(kind):
    """A ``mesh=`` every entry point must refuse with a ``ValueError``
    naming ``mesh``: ``'not a mesh'`` (an object) or ``'wrong axes'`` (a
    one-rank DeviceMesh whose axis is neither 'restarts' nor 'samples',
    in a world of this process alone)."""
    if kind == 'not a mesh':
        yield object()
        return
    with one_rank_world():
        yield _mesh((1,), ("x",))
