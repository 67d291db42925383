"""The port's model-selection sweeps and checkpoints.

A sweep is one best-of-``n_init`` fit per ``k``, each from a sub-seed
drawn in turn from the sweep's seed and, with ``component_bucket``,
padded to the bucket: every point equals the direct call it stands for,
a resumed sweep equals an uninterrupted one (the port of
tests/test_analysis_utils.py's checkpoint tests, fingerprint warning
included), and a fit's state survives ``utils.checkpoint``'s round
trip.  A k-means sweep point is a ``KMeans`` fit and its gap statistic
from the two sub-seeds of its ``k``.  All on the CPU in float64.
"""

import numpy as np
import pytest
import torch

from convex_dim_red_tpu_torch import KMeans, KernelAA, gap_statistic
from convex_dim_red_tpu_torch.parallel import (aa_model_selection_sweep,
                                               aa_fit_restarts,
                                               gpnh_fit_restarts,
                                               gpnh_model_selection_sweep,
                                               kmeans_model_selection_sweep)
from convex_dim_red_tpu_torch.parallel import sweep as tsweep
from convex_dim_red_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                       resume_kernel_aa,
                                                       save_checkpoint)

torch.set_num_threads(1)

AA_KW = dict(n_init=4, init='random', tolerance=1e-8, max_iterations=60,
             dictionary_solver_kwargs={'max_iterations': 1},
             weights_solver_kwargs={'max_iterations': 25})
GPNH_KW = dict(n_init=4, lambda_W=1e-4, tolerance=1e-8, max_iterations=60,
               weights_solver_kwargs={'max_iterations': 50})


def _data(seed, n=40, k=3, d=6):
    rng = np.random.RandomState(seed)
    basis = rng.standard_normal((k, d))
    Z = rng.rand(n, k)
    Z /= Z.sum(axis=1, keepdims=True)
    return torch.as_tensor(Z @ basis)


@pytest.mark.parametrize("family", ["aa", "gpnh"])
@pytest.mark.parametrize("bucket", [None, 4])
def test_each_point_is_the_direct_fit(family, bucket):
    X = _data(0)
    ks = [2, 3]
    if family == 'aa':
        sweep, fit, kw = aa_model_selection_sweep, aa_fit_restarts, AA_KW
    else:
        sweep, fit, kw = gpnh_model_selection_sweep, gpnh_fit_restarts, \
            GPNH_KW
    results = sweep(X, ks, 11, component_bucket=bucket, restart_chunk=3,
                    **kw)
    seeds = tsweep._sub_seeds(11)
    kw = dict(kw)
    n_init = kw.pop('n_init')
    for k in ks:
        direct = fit(X, k, next(seeds), n_init, restart_chunk=3,
                     stopping_criterion='rel_delta_f',
                     pad_components_to=bucket, **kw)
        np.testing.assert_array_equal(results[k]['costs'], direct['costs'])
        assert results[k]['cost'] == direct['cost']
        assert results[k]['n_iter'] == direct['n_iter']
        dictionary = (direct['archetypes'] if family == 'aa'
                      else direct['dictionary'].T)
        recon = direct['weights'] @ dictionary
        rmse = float(torch.sqrt(torch.mean((recon - X) ** 2)))
        assert results[k]['rmse'] == pytest.approx(rmse, rel=1e-12)
        assert results[k]['elapsed'] > 0.0


def test_sub_seeds_come_from_the_seed_or_generator():
    a = tsweep._sub_seeds(5)
    b = tsweep._sub_seeds(torch.Generator().manual_seed(5))
    first = [next(a) for _ in range(3)]
    assert first == [next(b) for _ in range(3)]
    assert len(set(first)) == 3
    assert tsweep._pad_to(5, 8) == 8 and tsweep._pad_to(8, 8) == 8
    assert tsweep._pad_to(9, 8) == 16 and tsweep._pad_to(9, None) is None


def test_sweep_checkpoint_resume(tmp_path):
    """Completed ``k`` load from disk; a new ``k`` computes with the
    seeds an uninterrupted sweep draws; a changed configuration warns
    and recomputes (tests/test_analysis_utils.py)."""
    X = _data(15)
    ckpt = str(tmp_path / "sweep")
    kw = dict(AA_KW)
    first = aa_model_selection_sweep(X, [2, 3], 3, checkpoint_dir=ckpt,
                                     **kw)
    resumed = aa_model_selection_sweep(X, [2, 3, 4], 3,
                                       checkpoint_dir=ckpt, **kw)
    fresh = aa_model_selection_sweep(X, [2, 3, 4], 3, **kw)
    for k in (2, 3):
        assert resumed[k]['cost'] == first[k]['cost']
        np.testing.assert_array_equal(resumed[k]['costs'], first[k]['costs'])
        assert resumed[k]['elapsed'] == first[k]['elapsed']  # loaded
    assert resumed[4]['cost'] == fresh[4]['cost']
    np.testing.assert_array_equal(resumed[4]['costs'], fresh[4]['costs'])
    assert resumed[4]['n_iter'] == fresh[4]['n_iter']
    assert resumed[4]['rmse'] == pytest.approx(fresh[4]['rmse'], rel=1e-12)

    with pytest.warns(UserWarning, match="different sweep"):
        changed = aa_model_selection_sweep(X, [2], 3, checkpoint_dir=ckpt,
                                           **dict(kw, n_init=2))
    assert changed[2]['costs'].shape == (2,)  # recomputed, not loaded
    # Another seed is another configuration too.
    with pytest.warns(UserWarning, match="different sweep"):
        aa_model_selection_sweep(X, [3], 4, checkpoint_dir=ckpt, **kw)


def test_gpnh_sweep_resumes_from_a_generator(tmp_path):
    X = _data(13, n=30)
    ckpt = str(tmp_path / "gpnh")
    first = gpnh_model_selection_sweep(
        X, [2], torch.Generator().manual_seed(0), checkpoint_dir=ckpt,
        **GPNH_KW)
    resumed = gpnh_model_selection_sweep(
        X, [2, 3], torch.Generator().manual_seed(0), checkpoint_dir=ckpt,
        **GPNH_KW)
    fresh = gpnh_model_selection_sweep(
        X, [2, 3], torch.Generator().manual_seed(0), **GPNH_KW)
    assert resumed[2]['cost'] == first[2]['cost']
    np.testing.assert_array_equal(resumed[3]['costs'], fresh[3]['costs'])
    for entry in fresh.values():
        assert entry['costs'].shape == (4,)
        assert np.isfinite(entry['cost']) and entry['rmse'] >= 0.0
    # k = 3 is planted: it reconstructs better than k = 2.
    assert fresh[3]['rmse'] < fresh[2]['rmse']


KMEANS_KW = dict(n_init=3, n_trials=6, max_iter=50)


def _blobs(seed, n_per=15):
    rng = np.random.RandomState(seed)
    centers = np.array([[0.0, 0.0, 0.0], [6.0, 0.0, 1.0], [0.0, 7.0, -1.0]])
    return torch.as_tensor(np.concatenate(
        [c + 0.4 * rng.standard_normal((n_per, 3)) for c in centers]))


def test_kmeans_sweep_point_is_the_direct_fit():
    X = _blobs(1)
    results = kmeans_model_selection_sweep(X, [2, 3], 4, **KMEANS_KW)
    seeds = tsweep._sub_seeds(4)
    for k in (2, 3):
        fit_seed, gap_seed = next(seeds), next(seeds)
        model = KMeans(k, n_init=3, max_iter=50, random_state=fit_seed).fit(X)
        gap, sk = gap_statistic(X, model.inertia_, k, n_trials=6,
                                random_state=gap_seed)
        assert set(results[k]) == {'cost', 'gap', 'gap_sk', 'n_iter',
                                   'elapsed'}
        assert results[k]['cost'] == model.inertia_
        assert results[k]['n_iter'] == model.n_iter_
        assert (results[k]['gap'], results[k]['gap_sk']) == (gap, sk)
        assert results[k]['elapsed'] > 0.0
    # Three planted blobs: the inertia falls with k and the gap peaks at 3.
    assert results[3]['cost'] < results[2]['cost']
    assert results[3]['gap'] > results[2]['gap']


def test_kmeans_sweep_checkpoint_resume(tmp_path):
    X = _blobs(2)
    ckpt = str(tmp_path / "kmeans")
    first = kmeans_model_selection_sweep(X, [2], 5, checkpoint_dir=ckpt,
                                         **KMEANS_KW)
    resumed = kmeans_model_selection_sweep(X, [2, 3], 5,
                                           checkpoint_dir=ckpt, **KMEANS_KW)
    fresh = kmeans_model_selection_sweep(X, [2, 3], 5, **KMEANS_KW)
    assert resumed[2] == first[2]  # loaded, elapsed included
    for key in ('cost', 'gap', 'gap_sk', 'n_iter'):
        assert resumed[3][key] == fresh[3][key]
        assert resumed[2][key] == fresh[2][key]
    with pytest.warns(UserWarning, match="different sweep"):
        changed = kmeans_model_selection_sweep(
            X, [2], 5, checkpoint_dir=ckpt, **dict(KMEANS_KW, n_trials=4))
    assert changed[2]['elapsed'] != first[2]['elapsed']  # recomputed


def test_kmeans_sweep_rejects_mesh():
    with pytest.raises(ValueError, match="mesh"):
        kmeans_model_selection_sweep(_blobs(3), [2], 0, mesh=object(),
                                     **KMEANS_KW)


def test_checkpoint_roundtrip_and_resume(tmp_path):
    X = _data(7, n=50)
    Kmat = X @ X.T
    model = KernelAA(n_components=3, init='random', random_state=0,
                     tolerance=1e-8, max_iterations=20)
    model.fit(Kmat)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, {
        'weights': model.weights, 'dictionary': model.dictionary,
        'alpha': model.alpha, 'cost': model.cost, 'n_iter': model.n_iter})
    state = load_checkpoint(path)
    assert set(state) == {'weights', 'dictionary', 'alpha', 'cost',
                          'n_iter'}
    np.testing.assert_array_equal(state['weights'], model.weights.numpy())
    assert float(state['cost']) == model.cost
    assert int(state['n_iter']) == model.n_iter
    # An explicit .npz name loads the same file.
    assert load_checkpoint(path + '.npz').keys() == state.keys()

    # Resume from the checkpoint: the cost does not regress.
    model2 = KernelAA(n_components=3, random_state=1, tolerance=1e-10,
                      max_iterations=100)
    resume_kernel_aa(model2, Kmat, state)
    assert model2.init == 'custom'
    assert model2.cost <= float(state['cost']) + 1e-10


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none"))
