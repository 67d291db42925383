"""The port's model-selection sweeps and checkpoints.

A sweep is one best-of-``n_init`` fit per ``k``, each from a sub-seed
drawn in turn from the sweep's seed and, with ``component_bucket``,
padded to the bucket: every point equals the direct call it stands for,
a resumed sweep equals an uninterrupted one (the port of
tests/test_analysis_utils.py's checkpoint tests, fingerprint warning
included), and a fit's state survives ``utils.checkpoint``'s round
trip.  All on the CPU in float64.
"""

import numpy as np
import pytest
import torch

from convex_dim_red_tpu_torch import KernelAA
from convex_dim_red_tpu_torch.parallel import (aa_model_selection_sweep,
                                               aa_fit_restarts,
                                               gpnh_fit_restarts,
                                               gpnh_model_selection_sweep)
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
