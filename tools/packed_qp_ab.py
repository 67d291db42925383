#!/usr/bin/env python3
"""Device time of the K1/K2 simplex-QP kernel of two checkouts of the
PyTorch port, in turns on one NVIDIA GPU.

Usage, on a machine with the GPU, PyTorch built for CUDA and ``nvcc``::

    python3 tools/packed_qp_ab.py A_DIR B_DIR

``A_DIR`` and ``B_DIR`` are repository roots, each holding
``convex_dim_red_tpu_torch/``.  Each checkout's ``ops/simplex_qp.py``
(which imports only the standard library and torch) is loaded as a
module of its own and builds its kernel into its own ``_build/``.  For
each shape and projection, float32, 25 iterations, the script times one
launch of each checkout's ``quad_simplex_qp_packed_grouped`` (CUDA
events around a CUDA graph of 20 launches, median of 5 replays; see
``chip_smoke.device_ms``) in the order A, B, B, A, and prints the mean
of each checkout's two times and B's speed-up.  Exits non-zero without a
GPU.
"""

import importlib.util
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

#: (label, R, n, k): K1 at the main path's 25 restarts for k = 6, 16 and
#: 20, and K2 (one Hessian) at k = 6.
SHAPES = (("K1", 25, 1788, 6), ("K2", 1, 1788, 6), ("K1", 25, 1788, 16),
          ("K1", 25, 1788, 20))


def load(root, name):
    path = os.path.join(root, "convex_dim_red_tpu_torch", "ops",
                        "simplex_qp.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(a_dir, b_dir):
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times the GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print("card: " + card)
    qp = {"A": load(a_dir, "qp_a"), "B": load(b_dir, "qp_b")}
    for label, R, n, k in SHAPES:
        args = chip_smoke.qp_problem(k, R, n, k, torch.float32, "cuda")
        for projection in ("michelot", "bisect"):
            times = {"A": [], "B": []}
            for which in "ABBA":
                fn = qp[which].quad_simplex_qp_packed_grouped
                times[which].append(chip_smoke.device_ms(
                    lambda: fn(*args, projection=projection,
                               max_iterations=25)))
            a, b = (sum(times[w]) / 2 for w in "AB")
            print("%s (%d, %d, %d) %s: A %.5f ms, B %.5f ms a launch "
                  "(A/B %.2fx)" % (label, R, n, k, projection, a, b, a / b))


if __name__ == "__main__":
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    main(sys.argv[1], sys.argv[2])
