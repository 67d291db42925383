#!/usr/bin/env python3
"""Device time of the simplex-QP kernels of two checkouts of the PyTorch
port, in turns on one NVIDIA GPU.

Usage, on a machine with the GPU, PyTorch built for CUDA and ``nvcc``::

    python3 tools/packed_qp_ab.py A_DIR B_DIR

``A_DIR`` and ``B_DIR`` are repository roots, each holding
``convex_dim_red_tpu_torch/``.  Each checkout's ``ops/simplex_qp.py``
(which imports only the standard library and torch) is loaded as a
module of its own and builds its kernels into its own ``_build/``.  For
each K1/K2 shape and projection, float32, 25 iterations, the script
times one launch of each checkout's ``quad_simplex_qp_packed_grouped``
(CUDA events around a CUDA graph of 20 launches, median of 5 replays;
see ``chip_smoke.device_ms``) in the order A, B, B, A, and prints the
mean of each checkout's two times and B's speed-up; then the same for
K3 at (4, 1788, 96) and K4 at (1, 1788, 96), float32, up to 1000
iterations, through ``quad_simplex_qp_grouped`` (``chip_smoke.py`` phase
5's inputs).  Each line says whether the two checkouts' outputs are
equal bit for bit.  Exits non-zero without a GPU.
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
#: (label, R): K3 and K4 (K3's kernel at one group) at n = 1788, k = 96.
UNPACKED_SHAPES = (("K3", 4), ("K4", 1))


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
            compare("%s (%d, %d, %d) %s" % (label, R, n, k, projection), {
                w: lambda m=qp[w]: m.quad_simplex_qp_packed_grouped(
                    *args, projection=projection, max_iterations=25)
                for w in "AB"})
    wide = chip_smoke.qp_problem(5, 4, chip_smoke.N_SAMPLES,
                                 chip_smoke.WIDE_K, torch.float32, "cuda")
    for label, R in UNPACKED_SHAPES:
        args = tuple(t[:R] for t in wide)
        compare("%s (%d, %d, %d) bisect, up to 1000 iterations"
                % ((label,) + tuple(args[1].shape)), {
                    w: lambda m=qp[w]: m.quad_simplex_qp_grouped(
                        *args, max_iterations=1000)
                    for w in "AB"})


def compare(title, run):
    """Device times of ``run["A"]`` and ``run["B"]`` in the order A, B,
    B, A, and whether their outputs are equal bit for bit."""
    import torch
    times = {"A": [], "B": []}
    for which in "ABBA":
        times[which].append(chip_smoke.device_ms(run[which]))
    a, b = (sum(times[w]) / 2 for w in "AB")
    same = torch.equal(run["A"](), run["B"]())
    print("%s: A %.5f ms, B %.5f ms a launch (A/B %.2fx); outputs %s"
          % (title, a, b, a / b, "equal bit for bit" if same else "differ"))


if __name__ == "__main__":
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    main(sys.argv[1], sys.argv[2])
