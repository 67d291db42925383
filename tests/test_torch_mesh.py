"""The port's multi-device layer against the JAX package's, float64.

The port's sharded functions run in gloo worlds of two CPU processes
(tests/torch_mesh_worlds.py; one world for this module, its cases
batched), and each is held twice: to the JAX function on a mesh of the
same shape built from the conftest's virtual CPU devices, and to the
port's own single-device run from the same states or seed, which every
case computes beside its sharded run.

Tolerances (never looser than JAX's own tests, tests/test_parallel.py):
- the Gram, to 1e-10 (JAX: 1e-10);
- one train step: C, alpha and the costs to 1e-10; the weights, which
  the QP stops at a residual of 1e-6 on nearly flat valleys, to 1e-6
  against JAX (the JAX step against the single-device math checks the
  costs only, to 1e-8) and 1e-8 against the port's own single-device
  step (JAX's mesh-shape invariance, 1e-8);
- the fits: per-restart costs to rtol 1e-8 and equal iteration counts
  (JAX: rtol 1e-8, atol 1e-12, equal counts); with scale factors to
  rtol 1e-6, atol 1e-9 (JAX's delta test);
- the restart-sharded entry points: to the port's single-device run bit
  for bit in costs, counts, winner and screen, and to JAX (its mesh
  compaction runner, and its ``grouped=True`` screened runner, since
  JAX's screened mesh route runs the vmapped runners the port does not
  have, ROADMAP.md item 18) to rtol 1e-8 with equal counts;
- k-means: the best inertia to rel 1e-8 and centroids to 1e-8 (JAX:
  the same), PCA to rtol 1e-9 and 1e-8 up to sign (JAX: the same), the
  gap bit for bit against the port's single device and within JAX's
  Monte-Carlo spread (the draws differ).
"""

import functools
import pickle
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convex_dim_red_tpu.parallel import restarts as jrestarts
from convex_dim_red_tpu.parallel import sharded_aa as jsharded
from convex_dim_red_tpu.parallel import sharded_models as jmodels
from convex_dim_red_tpu.parallel.mesh import create_mesh as jax_mesh
from convex_dim_red_tpu_torch.parallel.mesh import spawn
from tests import torch_mesh_worlds as W

torch.set_num_threads(1)

N, D, K = 16, 6, 3
X = W.planted_data(0, N, D, K, 0.01)
X_RESTARTS = W.planted_data(1, 32, D, K, 0.01)
BLOBS = W.blobs(0)
AA_KW = dict(init='random', max_iterations=20, tolerance=1e-6,
             stopping_criterion='rel_delta_f',
             dictionary_solver_kwargs=W.DICT_KW,
             weights_solver_kwargs=W.WEIGHTS_KW)
COMPACTED = dict(AA_KW, compact_iterations=8, restart_chunk=2)
SCREENED = dict(AA_KW, screen_iterations=12, screen_keep=0.5,
                restart_chunk=2)
GPNH_KW = dict(init='random', max_iterations=20, lambda_W=1e-3,
               weights_solver_kwargs=W.WEIGHTS_KW)
JAX_KEY = jax.random.PRNGKey(0)


def _states(n_init):
    return W.random_states(1, n_init, N, K, D)


def _jax_aa_states(key, n_init, n=32):
    init = functools.partial(
        jrestarts._init_aa_state, n_samples=n, n_components=K,
        init='random', diss=None, n_extra_steps=10, component_mask=None,
        do_scale=False, dtype=jnp.float64)
    keys = jax.random.split(key, n_init)
    return tuple(np.asarray(a) for a in jax.vmap(init, in_axes=(0, None))(
        keys, jnp.asarray(0.0)))


CASES = [
    ('gram', 'gram', dict(X=X, shape=(1, 2))),
    ('train step', 'train_step', dict(X=X, states=_states(2), shape=(1, 2))),
    ('aa 1x2', 'fit', dict(kind='aa', data=X, states=_states(2),
                           shape=(1, 2))),
    ('aa 1x2 delta', 'fit', dict(kind='aa', data=1.2 * X,
                                 states=_states(2), shape=(1, 2),
                                 delta=0.3)),
    ('aa 2x1 padded', 'fit', dict(kind='aa', data=X, states=_states(4),
                                  shape=(2, 1), n_valid=3)),
    ('kernel aa 1x2', 'fit', dict(kind='kernel_aa', data=X @ X.T,
                                  states=_states(2), shape=(1, 2))),
    ('gpnh 1x2', 'fit', dict(kind='gpnh', data=X, states=_states(2),
                             shape=(1, 2))),
    ('gpnh 2x1', 'fit', dict(kind='gpnh', data=X, states=_states(4),
                             shape=(2, 1))),
    ('compacted', 'restarts', dict(
        kind='aa', data=X_RESTARTS, n_init=5, kwargs=COMPACTED,
        states=_jax_aa_states(JAX_KEY, 5))),
    ('screened', 'restarts', dict(
        kind='aa', data=X_RESTARTS, n_init=6, kwargs=SCREENED,
        states=_jax_aa_states(JAX_KEY, 6))),
    ('padded', 'restarts', dict(kind='aa', data=X_RESTARTS, n_init=4,
                                kwargs=dict(AA_KW, pad_components_to=4))),
    ('fewer restarts than ranks', 'restarts', dict(
        kind='aa', data=X_RESTARTS, n_init=1, kwargs=AA_KW)),
    ('chunked on a 2-D mesh', 'restarts', dict(
        kind='aa', data=X_RESTARTS, n_init=5,
        kwargs=dict(AA_KW, restart_chunk=2), mesh_shape=(2, 1),
        names=("restarts", "samples"))),
    ('kernel aa restarts', 'restarts', dict(
        kind='kernel_aa', data=X_RESTARTS @ X_RESTARTS.T, n_init=3,
        kwargs=AA_KW)),
    ('gpnh screened restarts', 'restarts', dict(
        kind='gpnh', data=X_RESTARTS, n_init=4,
        kwargs=dict(GPNH_KW, screen_iterations=8, screen_keep=0.5))),
    ('kmeans++ 1x2', 'kmeans', dict(X=BLOBS, shape=(1, 2), n_init=4)),
    ('kmeans random 2x1', 'kmeans', dict(X=BLOBS, shape=(2, 1), n_init=4,
                                         init='random')),
    ('pca', 'pca', dict(X=X, shape=(1, 2))),
    ('gap', 'gap', dict(X=BLOBS, shape=(2, 1), n_trials=5)),
    ('aa sweep', 'sweep', dict(kind='aa', X=X_RESTARTS)),
    ('kmeans sweep', 'sweep', dict(kind='kmeans', X=BLOBS)),
    ('sweep resume', 'sweep_resume', dict(X=X_RESTARTS)),
    ('mesh helpers', 'mesh_helpers', {}),
]


def _mesh(shape, names=("restarts", "samples")):
    n = int(np.prod(shape))
    return jax_mesh(shape=shape, axis_names=names,
                    devices=jax.devices()[:n])


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("sweep_ckpt")


@pytest.fixture(scope="module")
def world(ckpt_dir, tmp_path_factory):
    """The world of two running :data:`CASES` in the background while
    the JAX references compile; the AA sweep on the mesh checkpoints to
    ``ckpt_dir``."""
    tmpdirs = {'aa sweep': ckpt_dir,
               'sweep resume': tmp_path_factory.mktemp("sweep_resume")}
    cases = [(label, name, dict(kw, tmpdir=str(tmpdirs[label]))
              if label in tmpdirs else kw)
             for label, name, kw in CASES]
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(W.world, cases)


@pytest.fixture(scope="module")
def want(world):
    """The JAX package's results on meshes of the same shapes."""
    Zs, Cs, alphas, _ = _states(2)
    step = jax.jit(lambda *a: jsharded.sharded_aa_train_step(
        _mesh((1, 2)), *a, dict_iterations=3, weights_iterations=20,
        weights_backend='xla'))
    restart_mesh = _mesh((2,), ("restarts",))
    return {
        'gram': np.asarray(jsharded.distributed_gram(_mesh((1, 2)),
                                                     jnp.asarray(X))),
        'train step': [np.asarray(a) for a in step(
            jnp.asarray(X), jnp.asarray(Zs), jnp.asarray(Cs),
            jnp.asarray(alphas))],
        **{label: _jax_fit(**next(c for c in CASES if c[0] == label)[2])
           for label in FIT_LABELS},
        'compacted': jrestarts.aa_fit_restarts(
            X_RESTARTS, K, JAX_KEY, 5, mesh=restart_mesh, **COMPACTED),
        'screened': jrestarts.aa_fit_restarts(
            X_RESTARTS, K, JAX_KEY, 6, grouped=True, **SCREENED),
        'kmeans': jmodels.sharded_kmeans_fit(
            _mesh((1, 2)), jnp.asarray(BLOBS), JAX_KEY, n_clusters=3,
            n_init=4),
        'pca': jmodels.sharded_pca(_mesh((1, 2)), jnp.asarray(X),
                                   n_components=3),
        'gap': jmodels.sharded_gap_statistic(
            restart_mesh, BLOBS, 10.0, 3, n_trials=6, random_state=0),
    }


@pytest.fixture(scope="module")
def ranks(world, want):
    """Every rank's results of :data:`CASES`."""
    return world.result()


@pytest.fixture(scope="module")
def out(ranks):
    return ranks[0]


def _strip_elapsed(result):
    if isinstance(result, dict):
        return {k: _strip_elapsed(v) for k, v in result.items()
                if k != 'elapsed'}
    return result


def test_every_rank_returns_the_whole_result(ranks):
    """The sharded outputs (weights over samples, costs over restarts,
    labels, components) come back whole and equal on both ranks."""
    for label in ranks[0]:
        if label in ('mesh helpers', 'sweep resume'):
            # Local ranks, blocks and checkpoint directories differ by
            # rank; the resumed sweeps are compared by their own test.
            continue
        a, b = (_strip_elapsed(r[label]) for r in ranks)
        assert pickle.dumps(a) == pickle.dumps(b), label


def test_distributed_gram_matches_jax(out, want):
    np.testing.assert_allclose(out['gram'], X @ X.T, rtol=0, atol=1e-10)
    np.testing.assert_allclose(out['gram'], want['gram'], rtol=0,
                               atol=1e-10)


def test_train_step_matches_jax(out, want):
    got, single = out['train step']['sharded'], out['train step']['single']
    for name, g, s, w in zip(("Z", "C", "alpha", "cost"), got, single,
                             want['train step']):
        atol = 1e-6 if name == "Z" else 1e-10
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=atol,
                                   err_msg=name)
        np.testing.assert_allclose(g, s, rtol=0,
                                   atol=1e-8 if name == "Z" else 1e-10,
                                   err_msg=name)
    np.testing.assert_allclose(got[0].sum(axis=2), 1.0, atol=1e-10)


def test_train_step_and_restart_runner_build_the_same_iterate(out):
    """From the same settings the train step (``dict_iterations``,
    ``weights_iterations``, ``weights_backend``) and the restart runner
    (the public solver dicts) hand the iterate arguments that resolve
    alike, and the iterates built from them on one device read the host
    alike (whether a CUDA graph may replay an iteration)."""
    from convex_dim_red_tpu_torch.parallel import sharded_aa as tsharded
    passed = out['train step']['iterate_kwargs']
    step, runner = passed['train step'], passed['restart runner']

    def resolved(kw):
        return tsharded._solver_kwargs(
            kw['n_components'], 'cpu', kw.get('dictionary_solver_kwargs'),
            kw.get('weights_solver_kwargs'),
            kw.get('scale_factors_solver_kwargs'))

    def reads_host(kw):
        Xt = torch.as_tensor(X)
        iterate, _ = tsharded._aa_iterate(
            Xt, Xt @ Xt.T, sh=tsharded._Shard(device='cpu'), **kw)
        return iterate.reads_host

    assert resolved(step) == resolved(runner)
    assert resolved(step)[1] == 'xla'
    assert (step['delta'], step['do_scale']) == (runner['delta'],
                                                 runner['do_scale'])
    assert reads_host(step) is reads_host(runner) is True


FIT_LABELS = ('aa 1x2', 'aa 1x2 delta', 'kernel aa 1x2', 'gpnh 1x2')


def _jax_fit(kind, data, states, shape, delta=0.0, n_valid=None):
    Zs, Cs, alphas, Ws = (None if a is None else jnp.asarray(a)
                          for a in states)
    fit = dict(tolerance=1e-10, max_iterations=40,
               weights_solver_kwargs={'max_iterations': 200},
               n_valid_restarts=n_valid)
    mesh = _mesh(shape)
    if kind == 'gpnh':
        return jsharded.sharded_gpnh_fit(mesh, jnp.asarray(data), Zs, Ws,
                                         lambda_W=1e-3, **fit)
    fn = (jsharded.sharded_aa_fit if kind == 'aa'
          else jsharded.sharded_kernel_aa_fit)
    return fn(mesh, jnp.asarray(data), Zs, Cs, alphas, delta=delta,
              dictionary_solver_kwargs=W.DICT_KW, **fit)


def _assert_fit(res, costs, n_iters, rtol=1e-8, atol=1e-12, counts=True):
    np.testing.assert_allclose(res['costs'], np.asarray(costs), rtol=rtol,
                               atol=atol)
    if counts:
        np.testing.assert_array_equal(res['n_iters'], np.asarray(n_iters))


@pytest.mark.parametrize("label", FIT_LABELS)
def test_sharded_fit_matches_jax(out, want, label):
    """The three sharded fits on a (1, 2) mesh, AA with and without scale
    factors, against JAX's on a (1, 2) mesh and the port's single-device
    restart-grouped fit from the same states."""
    case = next(c for c in CASES if c[0] == label)[2]
    got, single = out[label]['sharded'], out[label]['single']
    want = want[label]
    tol = (dict(rtol=1e-6, atol=1e-9, counts=False) if case.get('delta')
           else {})
    _assert_fit(got, want['costs'], want['n_iters'], **tol)
    _assert_fit(got, *single, **tol)
    best = int(np.argmin(got['costs']))
    assert got['cost'] == pytest.approx(got['costs'][best], rel=1e-15)
    assert got['n_iter'] == got['n_iters'][best]
    np.testing.assert_allclose(got['weights'], np.asarray(want['weights']),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got['weights'].sum(axis=1), 1.0, atol=1e-10)
    assert got['weights'].shape == (N, K)
    if case['kind'] != 'gpnh':
        np.testing.assert_allclose(got['alpha'], np.asarray(want['alpha']),
                                   rtol=0, atol=1e-6)
    if case.get('delta'):
        alpha = got['alpha']
        assert np.all(np.abs(alpha - 1.0) <= 0.3 + 1e-12)
        assert not np.allclose(alpha, 1.0)


@pytest.mark.parametrize("label", ['aa 2x1 padded', 'gpnh 2x1'])
def test_restart_axis_of_the_sharded_fits(out, label):
    """Restarts split over a (2, 1) mesh, one of four a pad (AA,
    ``n_valid_restarts=3``): every restart's trajectory is the
    single-device one's, and a pad never wins."""
    got, (costs, n_iters) = out[label]['sharded'], out[label]['single']
    _assert_fit(got, costs, n_iters, rtol=1e-12)
    n_valid = 3 if label.startswith('aa') else 4
    assert got['cost'] == pytest.approx(np.min(costs[:n_valid]), rel=1e-15)
    assert got['cost_deltas'].shape == (40,)


@pytest.mark.parametrize("label", [
    'compacted', 'screened', 'padded', 'fewer restarts than ranks',
    'chunked on a 2-D mesh', 'kernel aa restarts',
    'gpnh screened restarts'])
def test_restart_sharded_entry_point_matches_single_device(out, label):
    """``{aa,kernel_aa,gpnh}_fit_restarts(mesh=...)`` from the same seed
    (or states) as the single-device call: the same per-restart costs,
    counts, winner, screen and winner's factors."""
    got, single = out[label]['sharded'], out[label]['single']
    np.testing.assert_array_equal(got['costs'], single['costs'])
    np.testing.assert_array_equal(got['n_iters'], single['n_iters'])
    assert got['best_index'] == single['best_index']
    assert got['cost'] == single['cost'] and got['n_iter'] == single['n_iter']
    assert got.get('screen') == single.get('screen')
    for name in ('weights', 'dictionary', 'cost_deltas'):
        np.testing.assert_array_equal(got[name], single[name])


def test_restart_sharded_compaction_matches_jax_mesh(out, want):
    """Compaction in rounds of 8 over chunks of 2 on a restart mesh of 2
    (5 restarts, one pad): JAX's per-group grouped round runners on its
    own mesh, the port from JAX's restart states."""
    want = want['compacted']
    got = out['compacted']['sharded']
    _assert_fit(got, want['costs'], want['n_iters'])
    assert got['best_index'] == want['best_index']
    assert got['n_iters'].max() > 8  # a restart ran past a round
    np.testing.assert_allclose(got['weights'], np.asarray(want['weights']),
                               rtol=0, atol=1e-6)


def test_restart_sharded_screening_matches_jax(out, want):
    """Screening prunes over all restarts: the screen dict and winner of
    JAX's ``grouped=True`` screened run (JAX's mesh route would run its
    vmapped runners, which the port does not have)."""
    want = want['screened']
    got = out['screened']['sharded']
    _assert_fit(got, want['costs'], want['n_iters'])
    assert got['best_index'] == want['best_index']
    assert got['screen']['n_kept'] == want['screen']['n_kept'] == 3
    assert got['screen']['screen_cut'] == pytest.approx(
        want['screen']['screen_cut'], rel=1e-8)


@pytest.mark.parametrize("label", ['kmeans++ 1x2', 'kmeans random 2x1'])
def test_sharded_kmeans_matches_jax(out, want, label):
    """Rows over the samples, restarts over the restarts: the port's
    single-device fit from the same seed, bit for bit in the labels and
    to rounding in the rest, and JAX's sharded k-means++ fit on three
    blobs (its draws differ; every seeding finds the blobs)."""
    got, single = out[label]['sharded'], out[label]['single']
    assert got['inertia'] == pytest.approx(single['inertia'], rel=1e-12)
    assert got['n_iter'] == single['n_iter']
    np.testing.assert_array_equal(got['labels'], single['labels'])
    np.testing.assert_allclose(got['centroids'], single['centroids'],
                               atol=1e-12)
    assert got['inertias'].shape == got['n_iters'].shape == (4,)
    want = want['kmeans']
    assert got['inertia'] == pytest.approx(float(want['inertia']),
                                           rel=1e-8)
    order = np.lexsort(got['centroids'].T)
    order_j = np.lexsort(np.asarray(want['centroids']).T)
    np.testing.assert_allclose(got['centroids'][order],
                               np.asarray(want['centroids'])[order_j],
                               atol=1e-8)
    C = got['centroids']
    assert got['inertia'] == pytest.approx(
        np.sum((BLOBS - C[got['labels']]) ** 2), rel=1e-10)


def test_sharded_pca_matches_jax(out, want):
    got, single = out['pca']['sharded'], out['pca']['single']
    want = want['pca']
    components, explained, mean, scores = single
    for ref_var, ref_comp, ref_mean, ref_scores in (
            (np.asarray(want['explained_variance']),
             np.asarray(want['components']), np.asarray(want['mean']),
             np.asarray(want['scores'])),
            (explained, components, mean, scores)):
        np.testing.assert_allclose(got['explained_variance'], ref_var,
                                   rtol=1e-9)
        np.testing.assert_allclose(got['mean'], ref_mean, atol=1e-12)
        for j in range(3):
            sign = np.sign(got['components'][j] @ ref_comp[j])
            np.testing.assert_allclose(sign * got['components'][j],
                                       ref_comp[j], atol=1e-8)
            np.testing.assert_allclose(sign * got['scores'][:, j],
                                       ref_scores[:, j], atol=1e-8)


def test_sharded_gap_statistic(out, want):
    """Trials over the restart axis: the single-device gap of the same
    seed exactly, and JAX's sharded gap within the Monte-Carlo spread."""
    got, single = out['gap']['sharded'], out['gap']['single']
    assert got == single
    gap_j, sk_j = want['gap']
    assert abs(got[0] - gap_j) <= 3 * max(got[1], sk_j) + 1e-3


@pytest.mark.parametrize("label", ['aa sweep', 'kmeans sweep'])
def test_sweep_on_a_mesh_matches_single_device(out, ckpt_dir, label):
    """Each k's fit over the restart axis: the single-device sweep's
    numbers; the AA sweep's checkpoints written once, by the mesh's
    first rank, through a rename."""
    got, single = out[label]['sharded'], out[label]['single']
    assert sorted(got) == sorted(single) == [2, 3]
    for k in got:
        for name, value in single[k].items():
            if name != 'elapsed':
                np.testing.assert_array_equal(got[k][name], value)
    if label == 'aa sweep':
        assert sorted(p.name for p in ckpt_dir.iterdir()) == [
            'k_002.npz', 'k_003.npz']


def test_sweep_resume_when_only_the_first_rank_sees_the_checkpoints(ranks):
    """Only the first rank reads the checkpoints, and every rank takes
    its decision: the k it loaded is skipped everywhere and comes back
    on every rank as saved, the next k is fitted by all and equals an
    uninterrupted sweep's, and only the first rank's directory is
    written."""
    zero, one = (r['sweep resume'] for r in ranks)
    for rank in (zero, one):
        got = rank['sharded']
        assert sorted(got) == [2, 3]
        for name, value in zero['first'][2].items():
            np.testing.assert_array_equal(got[2][name], value)
        for name, value in rank['single'][3].items():
            if name != 'elapsed':
                np.testing.assert_array_equal(got[3][name], value)
    assert zero['files'] == ['k_002.npz', 'k_003.npz']
    assert one['files'] is None


def test_mesh_helpers(out):
    got = out['mesh helpers']
    assert got['flat'] == (('restarts', 'samples'), (2, 1), [[0], [1]],
                           [0, 0])
    assert got['lifted_samples'][:3] == (('restarts', 'samples'), (1, 2),
                                         [[0, 1]])
    assert got['lifted_restarts'][:3] == (('restarts', 'samples'), (2, 1),
                                          [[0], [1]])
    assert got['two_d'][:3] == (('restarts', 'samples'), (1, 2), [[0, 1]])
    assert got['same_2d'] and got['lifted_once']
    assert got['hybrid'][:3] == got['two_d'][:3]
    assert got['by_host'][:3] == got['two_d'][:3]  # one host
    assert "equally many" in got['errors']['ragged']
    assert "duplicate" in got['errors']['duplicate']
    assert "non-empty" in got['errors']['empty']
    x = np.arange(12.0).reshape(4, 3)
    np.testing.assert_array_equal(got['replicate'], x)
    np.testing.assert_array_equal(got['shard_restarts'], x)
    np.testing.assert_array_equal(got['shard_samples'], x[:2])


def test_a_deadlocked_world_fails_within_its_time_limit():
    """A collective that one rank never joins fails the call once the
    launcher's limit passes, with every process killed."""
    start = time.perf_counter()
    with pytest.raises((TimeoutError, RuntimeError),
                       match="did not finish|failed"):
        spawn(W.hang_world, 2, backend='gloo', device_type='cpu',
              timeout=6.0)
    assert time.perf_counter() - start < 30.0


def test_select_best_matches_jax():
    from convex_dim_red_tpu_torch.parallel.restarts import select_best
    costs = np.array([3.0, 1.0, 1.0, 2.0])
    state = (np.arange(8.0).reshape(4, 2), np.arange(4.0))
    want = jrestarts.select_best(jnp.asarray(costs),
                                 tuple(jnp.asarray(a) for a in state))
    got = select_best(torch.as_tensor(costs),
                      tuple(torch.as_tensor(a) for a in state))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert select_best(costs, {'x': torch.arange(4)})['x'] == 1
