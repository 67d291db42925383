"""The port never imports JAX.

A fresh interpreter with ``sys.modules['jax'] = None`` (any ``import
jax`` then raises) imports ``convex_dim_red_tpu_torch`` and runs a tiny
CPU fit through the public entry point, as on a machine with no JAX.
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
        X, 2, 0, 3, init='random', max_iterations=10,
        weights_solver_kwargs={'max_iterations': 5},
        dictionary_solver_kwargs={'max_iterations': 1},
        compact_iterations=4)
    assert res['weights'].shape == (20, 2)
    assert np.isfinite(res['cost'])
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
