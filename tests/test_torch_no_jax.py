"""The port never imports JAX.

A fresh interpreter with ``sys.modules['jax'] = None`` (any ``import
jax`` then raises) imports ``convex_dim_red_tpu_torch`` and runs tiny
CPU fits through the public entry points (AA, screened and padded,
kernel AA, PCA, GPNH, a sweep and a checkpoint), as on a machine with
no JAX.
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
