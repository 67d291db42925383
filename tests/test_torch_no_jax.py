"""The port never imports JAX.

A fresh interpreter with ``sys.modules['jax'] = None`` (any ``import
jax`` then raises) imports ``convex_dim_red_tpu_torch`` and runs tiny
CPU fits through the public entry points (AA, screened and padded,
kernel AA, PCA, GPNH, k-means and its gap statistic, the sweeps, a
checkpoint, the k-means analysis, drivers' ``main``s with a
scale-relaxed AA, and the synthetic generators), and imports the
examples, as on a machine with no JAX.
"""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent("""
    import sys
    sys.modules['jax'] = None
    sys.modules['jaxlib'] = None
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import convex_dim_red_tpu_torch as cdr
    X = torch.as_tensor(np.random.RandomState(0).standard_normal((20, 4)))
    res = cdr.aa_fit_restarts(
        X, 2, 0, 3, max_iterations=10,
        weights_solver_kwargs={'max_iterations': 5},
        dictionary_solver_kwargs={'max_iterations': 1},
        compact_iterations=4)
    assert res['weights'].shape == (20, 2)
    assert np.isfinite(res['cost'])
    model = cdr.ArchetypalAnalysis(2, random_state=0, max_iterations=10)
    model.fit(X)
    weights, cost = model.transform(X)
    assert weights.shape == (20, 2) and np.isfinite(cost)
    pcs = cdr.PCA(3).fit_transform(X)
    assert pcs.shape == (20, 3)
    res = cdr.gpnh_fit_restarts(pcs, 2, 0, 3, lambda_W=1e-3,
                                max_iterations=10,
                                weights_solver_kwargs={'max_iterations': 5})
    assert res['dictionary'].shape == (3, 2) and np.isfinite(res['cost'])
    gpnh = cdr.GPNHConvexCoding(2, lambda_W=1e-3, random_state=0,
                                max_iterations=10).fit(pcs)
    weights, cost = gpnh.transform(pcs)
    assert weights.shape == (20, 2) and np.isfinite(cost)
    small = dict(max_iterations=10,
                 weights_solver_kwargs={'max_iterations': 5},
                 dictionary_solver_kwargs={'max_iterations': 1})
    res = cdr.aa_fit_restarts(X, 2, 0, 4, screen_iterations=3,
                              pad_components_to=4, **small)
    assert res['screen']['n_kept'] == 1 and res['weights'].shape == (20, 2)
    res = cdr.kernel_aa_fit_restarts(X @ X.T, 2, 0, 3, **small)
    assert 'archetypes' not in res and np.isfinite(res['cost'])
    res = cdr.gpnh_fit_restarts(pcs, 2, 0, 3, pad_components_to=4,
                                screen_iterations=3, max_iterations=10)
    assert res['dictionary'].shape == (3, 2)
    from convex_dim_red_tpu_torch.parallel import aa_model_selection_sweep
    from convex_dim_red_tpu_torch.utils import checkpoint
    sweep = aa_model_selection_sweep(X, [2, 3], 0, n_init=2,
                                     component_bucket=4, **small)
    assert sorted(sweep) == [2, 3]
    import os, tempfile
    path = os.path.join(tempfile.mkdtemp(), 'state')
    checkpoint.save_checkpoint(path, {'weights': res['weights']})
    assert checkpoint.load_checkpoint(path)['weights'].shape == (20, 2)
    km = cdr.KMeans(2, n_init=2, random_state=0).fit(X)
    gap, sk = cdr.gap_statistic(X, km.inertia_, 2, n_trials=3,
                                random_state=0)
    assert np.isfinite(gap) and km.predict(X).shape == (20,)
    from convex_dim_red_tpu_torch.parallel import kmeans_model_selection_sweep
    sweep = kmeans_model_selection_sweep(X, [2, 3], 0, n_init=2, n_trials=3)
    assert np.isfinite(sweep[3]['gap'])
    from convex_dim_red_tpu_torch.cli import common, drivers
    model, onehot, attrs = common.kmeans_analysis(
        X.numpy()[:15], X.numpy()[15:], n_components=2, n_init=2,
        max_iterations=20, n_trials=3, reference='uniform', random_seed=0,
        device='cpu')
    assert onehot.shape == (15, 2) and attrs['test_set_size'] == '5'
    from convex_dim_red_tpu_torch.pipelines.dataset import (
        Dataset, Variable, open_dataset)
    tmp = tempfile.mkdtemp()
    field = np.random.RandomState(1).standard_normal((24, 3, 4))
    Dataset({'sst_anom': Variable(('time', 'latitude', 'longitude'),
                                  field)},
            {'time': Variable(('time',), np.arange(24) * 30.5,
                              {'units': 'days since 1990-1-1'}),
             'latitude': Variable(('latitude',), np.array([-20.0, 0, 20])),
             'longitude': Variable(('longitude',), np.arange(4.0))}
            ).to_netcdf(os.path.join(tmp, 'in.nc'))
    drivers.main(['hadisst_pca', os.path.join(tmp, 'in.nc'),
                  os.path.join(tmp, 'out.nc'), '--n-components', '2',
                  '--platform', 'cpu'])
    assert open_dataset(os.path.join(tmp, 'out.nc'))['EOFs'].data.shape \
        == (2, 3, 4)
    # The synthetic generators, a PCA and a scale-relaxed AA driver on
    # their JRA-55 files, and the examples' modules.
    from convex_dim_red_tpu_torch.pipelines import synthetic
    grid, eofs, pcs_file = (os.path.join(tmp, name) for name in
                            ('grid.nc', 'eofs.nc', 'pcs.nc'))
    synthetic.synthetic_jra55(n_years=3, n_lat=9, n_lon=8).to_netcdf(grid)
    assert synthetic.synthetic_hadisst(n_years=1, n_lat=6, n_lon=8)[
        'sst'].data.shape == (12, 6, 8)
    drivers.main(['jra55_pca', grid, eofs, '--n-components', '3',
                  '--platform', 'cpu'])
    synthetic.synthetic_jra55('pcs', n_years=3, n_modes=4).to_netcdf(
        pcs_file)
    drivers.main(['jra55_pca_aa', pcs_file, os.path.join(tmp, 'aa.nc'),
                  '--n-components', '2', '--delta', '0.1', '--n-init', '2',
                  '--max-iterations', '5', '--random-seed', '0',
                  '--platform', 'cpu'])
    assert float(open_dataset(os.path.join(tmp, 'aa.nc')).attrs['delta']) \
        == 0.1
    from convex_dim_red_tpu_torch.examples import (
        _common, distributed_scaling, hadisst_case_study, jra55_case_study)
    assert _common.parse_args('x', [os.path.join(tmp, 'ex'), '--platform',
                                    'cpu']).device == 'cpu'
    # The blocked names stay None; the JAX package is never imported.
    loaded = [m for m, mod in sys.modules.items() if mod is not None
              and m.split('.')[0] in ('jax', 'jaxlib',
                                      'convex_dim_red_tpu')]
    assert not loaded, loaded
    print('OK')
""")


def test_port_runs_without_jax():
    # ``python -c`` puts the working directory, the repository, first
    # on sys.path.
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "OK", proc.stdout


def test_spawned_world_imports_no_jax():
    """A gloo world of two processes runs a sharded fit with ``jax`` made
    unimportable in each: no process imports JAX or the JAX package
    (the world's worker module imports neither)."""
    import numpy as np

    from tests import torch_mesh_worlds as W
    for rank in W.world([('fit', 'jax_blocked', {})], timeout=120.0):
        assert np.isfinite(rank['fit']['cost'])
        assert rank['fit']['modules'] == []
