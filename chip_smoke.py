#!/usr/bin/env python3
"""Run the PyTorch port's main path once on one CUDA GPU and check it.

Usage, from the root of the repository, on a machine with an NVIDIA
Hopper GPU (sm_90a), PyTorch built for CUDA and ``nvcc``::

    python3 chip_smoke.py

``python3 chip_smoke.py --scale-check-ab`` runs, instead of the phases,
an A/B of the scale-factor SPG's host reads on phase 25's delta = 0.1
paths and a profile of one iteration of its AA analysis
(``scale_check_ab``); ``python3 chip_smoke.py --k5`` runs phases 1, 2
and 5b alone.

Phases, each printing its own lines; any failed check or exception ends
the run with a non-zero exit and no result line:

1. Device: needs ``torch.cuda.is_available()``; prints the torch, CUDA
   and nvcc versions and the card's name and power limit.
2. Build: compiles ``convex_dim_red_tpu_torch/csrc/simplex_qp.cu`` (K1,
   K2; once per dtype), ``simplex_qp_unpacked.cu`` (K3, K4) and
   ``residual_cost.cu`` (K5; once per dtype) with five nvcc processes
   at once, prints ptxas's register, spill and
   shared-memory report and fails if any kernel has a stack frame or
   spills.
3. Team-width sweep of the K1/K2 kernel: device time (a CUDA graph of
   20 launches) of every team width and block size in the sweep, float32,
   25 iterations, both projections, at (25, 1788, 6), (1, 1788, 6),
   (25, 1788, 20) and (25, 1788, 64), each result held to the plain
   version's objective.
4. K1 against its plain PyTorch version on the card: float32 at the
   main path's shape (R=25 groups, n=1788 rows, k=6) with both
   projections and a masked case, float64 at (3, 257, 11) after 3
   iterations and at convergence, and k=20 and k=64; then its times at
   the main-path shape: the wrapper's (CUDA events around one call,
   median of 10), the device's (CUDA graph), the plain version's, the
   mean iterations of a row, the bound and the one-thread-per-row
   kernel's device time.
5. K2, K3 and K4 against their plain versions: K2 at (n=1788, k=6)
   float32 with both projections; K3/K4 at (R=4, n=1788, k=96) and
   (1, 1788, 6) float32 and a masked case, float64 at (3, 257, 100)
   after 3 iterations and at convergence and at (1, 300, 128) (a
   128 KiB Hessian in shared memory); then the same times as for K1 at
   each path's shape, and for K3/K4 the most iterations a row took and
   the device time of that slowest row launched alone (n = 1), the
   latency floor of a launch.
5b. K5 (the fused residual cost) against its plain version in float64
    and float32 at the benchmark's shape (25, 1788, 24030, k = 6) and
    the JRA-55 PCs' (100, 732, 167, k = 4), its bits equal over two
    launches; its device time (CUDA graph of 20 launches), the plain
    version's, the ``C X`` product's and its bound.
6. Small fit: the port's ``aa_fit_restarts`` in float64 on a numpy
   array with no ``device`` (so on the card) and with ``device='cpu'``
   (K1 and its plain version) from the same initial states (costs within
   1e-6 relative, equal iteration counts), and an
   ``ArchetypalAnalysis`` fit of a numpy array, which lands on the card.
7. Main path: the HadISST-scale best-of-100 fit that ``bench.py`` times
   (n=1788 x d=16384 synthetic data, k=6, weights QP capped at 25
   iterations, dictionary at 1, rel_delta_f 1e-5, rounds of 32, chunks
   of 25), once to warm up and once timed with the launch counts reset
   just before; the winner is re-costed on the host in float64 and held
   to the JAX package's audited cost on the same data.
8. Estimator at full width: ``ArchetypalAnalysis(6,
   init='furthest_sum')`` on the same data, fitted with the default
   weights backend (the row solver) and with ``'pallas'`` (K2 every
   iteration), then ``transform`` (one K2 launch); the device
   FurthestSum is held to the host one, the cost trace to the
   watchdog, the device cost to its float64 audit and the transform's
   cost to the fit's.
9. k = 96 at full width: the estimator with ``'pallas'`` weights (K4)
   and its transform, and ``aa_fit_restarts`` with 4 restarts (K3).
10. PCA -> GPNH, the JAX package's "config 4"
    (benchmarks/run_all.py:110-136), not cut: ``PCA(167)`` of a
    732 x 8192 matrix (Gram path), then ``gpnh_fit_restarts`` with k=4,
    lambda_W 1e-3, rel_delta_f 1e-5, at most 300 iterations and 1000 QP
    iterations, best of 16 and of 100, each with the one-shot default
    (``compact_iterations=None``: rounds of 32, all restarts in one
    chunk), once to warm up and once timed; the
    winner is re-costed on the host in float64 and held to the
    reference costs; then K1's times, iterations and bound at the
    path's shape (100, 732, 4), on the operands of its first and its
    33rd launch.
11. The same best-of-100 fit in chunks of 25 (``compact_iterations=32,
    restart_chunk=25``) from the same seed, once to warm up and once
    timed: per-restart costs and the winner held to the one-shot
    default's, and the number of restarts whose ``n_iters`` differ
    printed.
12. ``GPNHConvexCoding(4, ...)`` on the PCs with the default weights
    backend (the row solver) and with ``'pallas'`` (K2), each fit then
    ``transform``: the cost trace to the watchdog, the device cost to
    its float64 audit, the transform's cost to the fit's, the K2
    launches.
13. The AA main path's workload (phase 7) with the one-shot default
    (chunks of 25), once: phase 7's schedule through the default
    argument, the audit held to 3809.80 and per-restart costs to phase
    7's run.
14. Screened AA, best of 100 (bench.py:346-360 on phase 7's data:
    screen 50 iterations, keep 0.25, margin 2.0, chunks of 25), once
    to warm up and once timed: the screen diagnostics, the launches of
    each phase, the float64 audit held to 3809.80 within 0.1%.
15. ``kernel_aa_fit_restarts``, best of 100, on phase 7's Gram with
    phase 7's settings, warm-up and timed: no ``archetypes``, the
    dictionary is C, Z and alpha C re-costed against X in float64 and
    held to 3809.80 within 0.1%.
16. Padded AA at config 5's shape (benchmarks/run_all.py:139-154:
    900 x 4096, best of 50, chunks of 10): k = 5 padded to 8 against
    the same fit unpadded, both walls; the padded weight columns
    exactly 0 on the card; then in float64 on K1 a fit from states at
    k = 5 and the same states padded to 8: costs within 1e-10, equal
    iteration counts.
17. Config 5's AA sweep, k = 2..20 step 3, bucketed by 8: per k the
    wall, launches and the winner's float64 audit (1e-4), costs falling
    with k, padded columns exactly 0; K1 against its plain version and
    its times and bound on k = 20's operands (10, 900, 24), masked.
18. Config 4 on phase 10's PCs: GPNH best of 100 screened (50
    iterations) and padded to 8, audited against the JAX package's
    best of 100 within 1e-3 (the padded dictionary's columns checked
    after every solve), then a GPNH sweep k = 2..6 of 16 restarts,
    bucketed by 4, each k's audit within 1e-4.
19. Config 2 (benchmarks/run_all.py:70-98) on phase 7's data:
    ``KMeans(4, n_init=10, random_state=0)``, then ``gap_statistic``
    with 20 and with 100 uniform reference trials, once to warm up
    (counting the synchronising calls) and once timed: the inertia held
    within 1% of the JAX package's 23,561,932 and both gaps within 0.01
    of 1.5533; then ``_lloyd`` in float64 on the card against the CPU
    from the same centroids at (600, 512, 4): equal labels and
    ``n_iter``.
20. ``kmeans_model_selection_sweep`` on the same data, k = 2..6, best of
    10, 20 trials: the wall of each k, inertia falling with k, finite
    gaps.
21. The HadISST case-study analyses at full size, in memory (no netCDF:
    the GPU machine has no h5py): the port's copy of
    bin/make_synthetic_hadisst.py (``pipelines/synthetic.py``) at its
    defaults (149 years from 1870, 180 x 360, land 0.3, seed 0), the
    anomalies of the anomalies CLI
    (base period 1981-2010, trend order 1), the HADISST spec's filters,
    scos weights, flatten, missing mask and a 0.1 chronological split
    (1610 training months, 178 held out), in float64 as a driver reads
    them; then, called as the drivers call them (host arrays,
    ``device='cuda'``, so fitted in float32), ``kmeans_analysis`` at
    bin/run_hadisst_kmeans_wrapper.sh's settings, ``aa_analysis`` at the
    hadisst_aa driver's and its wrapper's (k=4, best of 100, tolerance
    1e-4, at most 10,000 iterations), ``pca_analysis`` with 20
    components and ``gpnh_analysis`` on those PCs (k=4, lambda_W 1e-3,
    the jra55_pca_gpnh driver's and wrapper's settings), each followed
    by ``build_output_dataset``: finite attrs, ``test_set_size`` 178,
    the training cost audited in float64 on the host within 1e-4, the
    patterns NaN exactly on the land mask, and the K1/K2 launches.  K1
    is held to its plain version on the operands of the AA and the GPNH
    analyses' first launch and the first of their second round, K2 on
    those of the AA validation transform: float64 row by row, float32
    row by row (at most 1% of the rows apart by 1e-5) and in total.

22. The multi-device layer (parallel/), in a world of two processes
    sharing the card on gloo (parallel/mesh.py:spawn; the kernels are
    built by phase 2 first): phase 7's best of 100 over a restart mesh
    (2 x 1), each rank 50 restarts under compaction (the winner, its
    audit and every restart's cost held to phase 7's, K1 launches by
    rank to the schedule's); ``ArchetypalAnalysis(6)`` over a sample
    mesh (1 x 2) with phase 8's 'pallas' settings (K1 at (1, 894, 6) an
    iteration on each rank, the cost held to phase 8's K2 fit) and its
    transform (one K2 launch a rank on 894 rows); config 4's GPNH best of
    100 over the restart mesh (audit within 1e-4 of 2420.1641); config
    2's ``KMeans(4, n_init=10)`` over (2 x 1) and (1 x 2) and
    ``sharded_gap_statistic`` of 20 trials (inertia within 1% of JAX's,
    the gap within 0.01); ``sharded_pca(167)`` of config 4's data with
    the features split, in float64 (every explained variance within
    1e-5 of its own against the single-device Gram path on the same
    data) and in float32 (every one within 1e-5 of the leading one of
    phase 10's, the first 8 within 1e-5 of their own: the float32 Grams
    sum in other orders);
    and a k = 96 sharded fit cut to 3 iterations (K3, then K4 in the
    transform, on each rank's rows).
23. A world of one process on NCCL: ``sharded_aa_fit`` over a (1 x 1)
    mesh from four states on phase 7's data, 10 iterations (K1 at (4,
    1788, 6)), bit for bit the single-device restart-grouped fit.
24. K1 and K2 against their plain versions on rank 0's local operands
    of phase 22's sharded estimator (its first K1 launch, its transform's
    K2 launch), as phase 21 holds them.
25. The JRA-55 case study at full size, in memory: the port's copy of
    bin/make_synthetic_jra55.py at the reanalysis' own span and grid
    (61 years from 1958, 145 x 288, seed 0: 732 x 145 x 288 float32),
    the JRA55_HGT spec's filters (20-90 N: 57 x 288 = 16,416 points),
    scos weights and a 0.1 split (659 training months), in float64 as a
    driver reads them; then, called as the drivers call them (host
    arrays, ``device='cuda'``, fitted in float32): ``pca_analysis``
    with 167 components (tolerance 1e-8), and on the 732 x 167 PCs (the
    PC drivers hold none out) ``aa_analysis`` at jra55_pca_aa's
    settings with k = 4 and delta = 0.1 (random init, best of 100,
    rel_delta_f 1e-6, at most 10,000 iterations, both inner solvers
    capped at one step), ``gpnh_analysis`` at jra55_pca_gpnh's, and
    ``kmeans_analysis`` with the PCA-reference gap (best of 100, 100
    trials) on the PCs and on the weighted grid: every attr finite (the
    held-out ones NaN with no held-out months), each training cost
    within 1e-4 of its float64 audit (AA's from Z alpha C X), every
    alpha inside [0.9, 1.1] to float32 rounding, the weights rows on the
    simplex; K1 held to its plain version on the AA and the GPNH
    analyses' first launch and the first of their second round as phase
    21 holds them, and timed at the AA analysis' one-iteration launch
    (100, 732, 4).  Then phase 6's float64 fit with delta = 0.1 on the
    card against the CPU (costs and alpha within 1e-6, equal iteration
    counts), and ``ArchetypalAnalysis(4, delta=0.1)`` with 'pallas'
    weights (K2 every iteration, one iteration a launch) on the PCs at
    the driver's settings, then ``transform`` (one K2 launch; its cost
    at most the fit's x 1.0001); K2 held to its plain version on the
    operands of the fit's first launch and of the transform's.

Each path runs with every launch count set to 0 just before it and read
just after (in a world, in each process, and summed); phases 14-18, 21,
22 and 25 also check the K1 count against the one their restart schedule
implies (the scheduler's calls are recorded).
The last lines of standard output are the card's name and power limit,
a JSON object with every kernel's launches (in all and by path), error,
times and bound, and the JSON result line.
"""

import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

#: Main-path workload (bench.py:51-103).
N_SAMPLES, N_FEATURES, K = 1788, 16384, 6
N_INIT = 100
RESTART_CHUNK = 25
COMPACT_ITERS = 32
TOL = 1e-5
MAX_ITER = 500
DICT_MAX_ITERATIONS = 1
WEIGHTS_MAX_ITERATIONS = 25
#: Float64-audited cost of the JAX package's winner on the same data
#: (BENCH_r05.json, extra.cost_f64_audit).  The port draws other random
#: restarts, so it is held to this within 0.1%.
REFERENCE_AUDITED_COST = 3809.80
AUDIT_RTOL = 1e-3

PACKED_SOURCE = "convex_dim_red_tpu_torch/csrc/simplex_qp.cu"
UNPACKED_SOURCE = "convex_dim_red_tpu_torch/csrc/simplex_qp_unpacked.cu"
PALLAS_QP = "convex_dim_red_tpu/ops/pallas_qp.py"
#: The four kernels: name, source, the TPU kernel it replaces, and the
#: wrapper's launch counter in ops/simplex_qp.py.
KERNELS = (
    ("K1", "simplex_qp_grouped", PACKED_SOURCE, PALLAS_QP + ":659",
     "LAUNCHES"),
    ("K2", "simplex_qp_packed", PACKED_SOURCE, PALLAS_QP + ":575",
     "PACKED_LAUNCHES"),
    ("K3", "simplex_qp_unpacked_grouped", UNPACKED_SOURCE,
     PALLAS_QP + ":295", "GROUPED_LAUNCHES"),
    ("K4", "simplex_qp_unpacked", UNPACKED_SOURCE, PALLAS_QP + ":223",
     "UNPACKED_LAUNCHES"),
)
#: The estimator path at k = 96 (K3, K4).
WIDE_K = 96
#: The PCA -> GPNH workload, the JAX package's config 4
#: (benchmarks/run_all.py:110-136): data shape, PCA modes, GPNH settings.
GPNH_SAMPLES, GPNH_FEATURES, PCA_MODES, GPNH_K = 732, 8192, 167, 4
GPNH_FIT = dict(lambda_W=1e-3, tolerance=1e-5,
                stopping_criterion='rel_delta_f', max_iterations=300,
                weights_solver_kwargs={'max_iterations': 1000})
#: Reference costs of config 4: the JAX package's best of 100 on the TPU
#: (benchmarks/results.json, config4.ref_scale.cost) and the measured
#: NumPy float64 baseline's best of 16
#: (benchmarks/baselines_measured.json, config4.cost), with the relative
#: limits the port's float64 audits are held to.
GPNH_REFERENCE = {100: (2420.1641, 1e-4), 16: (2420.1787, 1e-3)}
#: Relative limit of the per-restart costs of two schedulers.
SCHEDULER_RTOL = 1e-5
DEVICE = "cuda"

#: The H100 SXM's published rates (NVIDIA's data sheet, at 700 W): HBM
#: bytes per second and non-tensor FLOP/s by dtype.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
#: Flops per coordinate of one row-iteration besides D A (2 k^2 a row),
#: counted from csrc/simplex_qp.cu: the step D = P(x - alpha g) - x (4),
#: delta, q, ||D||^2 and ||D||_inf (9), the x and xA updates (4) and fval
#: (4).  The projection adds 4 for Michelot's shortest run (one pass:
#: sum and compare, then subtract and clamp) and 3 per halving plus 3
#: for bisection.
ROW_FLOPS = 21
#: Launches a CUDA graph replays to time one launch on the device.
GRAPH_LAUNCHES = 20
#: The team-width sweep behind the rule simplex_qp.team_width: (label,
#: (R, n, k), team widths, block sizes).
SWEEP = (("K1", (RESTART_CHUNK, N_SAMPLES, K), (1, 2, 4, 8), (64, 128, 256)),
         ("K2", (1, N_SAMPLES, K), (1, 2, 4, 8), (64, 128, 256)),
         ("K1", (RESTART_CHUNK, N_SAMPLES, 16), (1, 8, 16), (128,)),
         ("K1", (RESTART_CHUNK, N_SAMPLES, 20), (8, 16, 32), (128,)),
         ("K1", (RESTART_CHUNK, N_SAMPLES, 40), (8, 16, 32), (128,)),
         ("K1", (RESTART_CHUNK, N_SAMPLES, 64), (8, 16, 32), (128,)),
         ("K2", (1, N_SAMPLES, 64), (8, 16, 32), (128,)))


def check(ok, message):
    if not ok:
        raise AssertionError(message)


def make_data(n=N_SAMPLES, d=N_FEATURES):
    """bench.py:make_data (benchmarks/run_all.py:_hadisst_scale_data):
    rank-8 structure plus noise, standardised, float32."""
    rng = np.random.RandomState(42)
    U = rng.standard_normal((n, 8))
    V = rng.standard_normal((8, d))
    X = U @ V + 0.3 * rng.standard_normal((n, d))
    X -= X.mean(axis=0)
    X /= X.std(axis=0) + 1e-12
    return X.astype(np.float32)


def qp_problem(seed, R, n, k, dtype, device):
    """SPD Hessians ``M M' + I`` and random linear terms, started at the
    simplex centre (tests/test_pallas_qp.py:13-18)."""
    import torch
    rng = np.random.RandomState(seed)
    M = rng.standard_normal((R, k, k))
    As = M @ M.transpose(0, 2, 1) + np.eye(k)
    Bs = rng.standard_normal((R, n, k))
    X0s = np.full((R, n, k), 1.0 / k)
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (As, Bs, X0s))


def qp_objective(X, As, Bs):
    """Per-row objective 1/2 x'Ax + b'x, in float64 on the host."""
    X, As, Bs = (t.double().cpu().numpy() for t in (X, As, Bs))
    return (0.5 * np.einsum('rij,rjk,rik->ri', X, As, X)
            + np.sum(X * Bs, axis=2))


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on "
                           "a GPU")
    print("torch %s, CUDA %s, %d device(s)"
          % (torch.__version__, torch.version.cuda,
             torch.cuda.device_count()))
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = subprocess.run([os.path.join(CUDA_HOME or "", "bin", "nvcc"),
                           "--version"], capture_output=True, text=True,
                          check=True)
    print("nvcc: " + nvcc.stdout.strip().splitlines()[-1])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    card = smi.stdout.strip().splitlines()[0]
    print("card: " + card)
    return card


def ptxas_report(log):
    """One ``(name, report, clean)`` per kernel from nvcc's ``-Xptxas
    -v`` output: registers, stack frame, spills and shared memory, and
    whether it has neither a stack frame nor spills."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            team = re.search(r"simplex_qp_grouped_kernelI([fd])Lb([01])E"
                             r"Li(\d+)ELi(\d+)E", mangled)
            warp = re.search(r"simplex_qp_unpacked_kernelI([fd])Li(\d+)E",
                             mangled)
            cost = re.search(r"(residual_cost(?:_sum)?)_kernelI([fd])E",
                             mangled)
            if team:
                name = "K1/K2 %s %s T %s NC %s" % (
                    "float" if team.group(1) == "f" else "double",
                    "michelot" if team.group(2) == "1" else "bisect",
                    team.group(3), team.group(4))
            elif warp:
                name = "K3/K4 %s NC %s" % (
                    "float" if warp.group(1) == "f" else "double",
                    warp.group(2))
            elif cost:
                name = "K5 %s %s" % (
                    cost.group(1).replace("_", " "),
                    "float" if cost.group(2) == "f" else "double")
            else:
                plain = re.search(r"\d+([a-z_]+)Ev$", mangled)
                name = plain.group(1) if plain else mangled
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "Used" in line:
            clean = bool(re.fullmatch(r"0 bytes stack frame, 0 bytes spill "
                                      r"stores, 0 bytes spill loads", spill))
            out.append((name, "%s; %s" % (line.split(":", 1)[1].strip(),
                                          spill), clean))
            name, spill = None, ""
    return sorted(out)


def phase_build():
    """The five libraries (K1/K2 and K5 in float32 and in float64,
    K3/K4), one nvcc each, started together."""
    import torch
    from convex_dim_red_tpu_torch.ops import residual_cost, simplex_qp
    t0 = time.perf_counter()
    errors = []

    def build(load):
        try:
            load()
        except Exception as exc:  # re-raised below, in this thread
            errors.append(exc)

    threads = [threading.Thread(target=build, args=(load,)) for load in (
        lambda: simplex_qp.load_library(torch.float32),
        lambda: simplex_qp.load_library(torch.float64),
        simplex_qp.load_unpacked_library,
        lambda: residual_cost.load_library(torch.float32),
        lambda: residual_cost.load_library(torch.float64))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    print("build: %.1f s (five nvcc processes at once)"
          % (time.perf_counter() - t0))
    logs = simplex_qp.build_logs()
    check(len(logs) == 5, "built %s" % sorted(logs))
    for library, log in sorted(logs.items()):
        report = ptxas_report(log)
        check(len(report) > 1, "no ptxas report for %s" % library)
        for name, line, clean in report:
            print("  ptxas: %-32s %s" % (name, line))
            check(clean, "%s: a stack frame or spills" % name)


def compare_qp(name, As, Bs, X0s, tol_obj, tol_x=None, kernel=None,
               plain=None, **kw):
    """A kernel against its plain version on the same card and inputs
    (default: K1).  Returns max|dx|."""
    import torch
    from convex_dim_red_tpu_torch.ops import simplex_qp
    kernel = kernel or simplex_qp.quad_simplex_qp_packed_grouped
    plain = plain or simplex_qp.quad_simplex_qp_packed_grouped_reference
    got = kernel(As, Bs, X0s, **kw)
    torch.cuda.synchronize()
    want = plain(As, Bs, X0s, **kw)
    torch.cuda.synchronize()
    if got.ndim == 2:
        got, want, As, Bs = got[None], want[None], As[None], Bs[None]
    f_got = qp_objective(got, As, Bs)
    f_want = qp_objective(want, As, Bs)
    gap = float(np.max(np.abs(f_got - f_want) / (1.0 + np.abs(f_want))))
    dx = float((got - want).abs().max())
    feas = float((got.double().sum(dim=2) - 1.0).abs().max())
    print("  %-40s max|dx| %.3e  objective gap %.3e  |sum-1| %.3e"
          % (name, dx, gap, feas))
    check(bool(torch.isfinite(got).all()), name + ": non-finite output")
    check(gap <= tol_obj, "%s: objective gap %.3e > %.1e"
          % (name, gap, tol_obj))
    check(feas <= 1e-5, "%s: rows off the simplex by %.3e" % (name, feas))
    check(float(got.min()) >= 0.0, name + ": negative weights")
    if tol_x is not None:
        check(dx <= tol_x, "%s: max|dx| %.3e > %.1e" % (name, dx, tol_x))
    mask = kw.get("mask")
    if mask is not None:
        off = ~torch.as_tensor(mask, device=got.device)
        check(bool((got[:, :, off] == 0).all()),
              name + ": masked lanes not exactly 0")
    return dx


def _event_ms(fn):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def cuda_median_ms(fn, reps=10):
    """CUDA events around one call of ``fn`` (host enqueue included),
    median of ``reps`` after a warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    return statistics.median(_event_ms(fn) for _ in range(reps))


def device_ms(fn, reps=5):
    """Device time of one launch: CUDA events around a CUDA graph that
    replays ``GRAPH_LAUNCHES`` calls of ``fn``, over that count, median
    of ``reps`` replays.  The host's enqueue is not in it."""
    import torch
    fn()  # loads the kernel's module outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_LAUNCHES):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = statistics.median(_event_ms(graph.replay) for _ in range(reps))
    del graph
    return ms / GRAPH_LAUNCHES


def mean_iterations(plain, args, **kw):
    """The mean and the most iterations a row takes on ``args``, from
    the counts of the plain version, and the slowest row ``(group,
    row)``."""
    from convex_dim_red_tpu_torch.ops import simplex_qp
    simplex_qp.PLAIN_ROW_ITERATIONS = 0
    simplex_qp.PLAIN_MAX_ROW_ITERATIONS = 0
    out = plain(*args, **kw)
    rows = out.numel() // out.shape[-1]
    return (simplex_qp.PLAIN_ROW_ITERATIONS / rows,
            simplex_qp.PLAIN_MAX_ROW_ITERATIONS, simplex_qp.PLAIN_SLOWEST_ROW)


def lone_row(args, row):
    """The operands of row ``(group, row)`` of ``args`` alone (n = 1),
    grouped or single-Hessian like ``args``."""
    r, i = row
    if args[1].ndim == 2:
        return args[0], args[1][i:i + 1], args[2][i:i + 1]
    return (args[0][r:r + 1], args[1][r:r + 1, i:i + 1],
            args[2][r:r + 1, i:i + 1])


def qp_bound(R, n, k, dtype, iterations, projection):
    """The least time the card could take for one solve: bytes (Bs and
    X0s read, the result written, As read) over the HBM rate, and flops
    (``iterations`` a row) over the non-tensor peak of ``dtype``."""
    import torch
    name = "float32" if dtype == torch.float32 else "float64"
    size = 4 if dtype == torch.float32 else 8
    if projection == "michelot":
        per_coordinate = ROW_FLOPS + 4
    else:
        per_coordinate = (ROW_FLOPS + 3
                          + 3 * (26 if dtype == torch.float32 else 52))
    nbytes = (3 * R * n * k + R * k * k) * size
    flops = R * n * iterations * (2 * k * k + per_coordinate * k)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * flops / PEAK_FLOPS[name]
    return dict(bytes=nbytes, flops=flops, flops_per_coordinate=per_coordinate,
                bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def kernel_times(name, kernel, plain, args, projection, team, threads,
                 lone=False, **kw):
    """The times, iterations and bound of one kernel at ``args``: the
    wrapper's (CUDA events), the device's (CUDA graph), the plain
    version's, the launch floor (an empty kernel on the grid of a block
    per ``threads // team`` rows, timed like the device time) and, with
    ``lone``, the device time of the slowest row launched alone.  Printed
    and returned."""
    from convex_dim_red_tpu_torch.ops import simplex_qp
    Bs = args[1]
    R, n, k = (1,) * (3 - Bs.ndim) + tuple(Bs.shape)
    ms = cuda_median_ms(lambda: kernel(*args, projection=projection, **kw))
    dev = device_ms(lambda: kernel(*args, projection=projection, **kw))
    plain_ms = cuda_median_ms(
        lambda: plain(*args, projection=projection, **kw))
    iterations, most, slowest = mean_iterations(
        plain, args, projection=projection, **kw)
    floor = device_ms(lambda: simplex_qp._empty_launch(team, threads, R, n))
    bound = qp_bound(R, n, k, Bs.dtype, iterations, projection)
    share = max(bound["bound_ms"], floor) / dev
    extra = {}
    if lone:
        one = lone_row(args, slowest)
        extra["lone_row_ms"] = device_ms(
            lambda: kernel(*one, projection=projection, **kw))
    print("  %s at (%d, %d, %d) %s %s: device %.5f ms a launch (CUDA graph "
          "of %d), wrapper %.4f ms (CUDA events, median of 10), plain "
          "version %.4f ms; mean iterations of a row %.3f; bound %.5f ms "
          "(%s: %d bytes -> %.5f ms, %.4g flops at %d a coordinate + 2k^2 "
          "-> %.5f ms), empty launch %.5f ms; %.1f%% of max(bound, empty "
          "launch)"
          % (name, R, n, k, str(Bs.dtype).split(".")[-1], projection, dev,
             GRAPH_LAUNCHES, ms, plain_ms, iterations, bound["bound_ms"],
             bound["bound_by"], bound["bytes"], bound["bytes_ms"],
             bound["flops"], bound["flops_per_coordinate"], bound["ops_ms"],
             floor, 100.0 * share))
    print("  %s: most iterations of a row %d (row %s)%s"
          % (name, most, slowest, "" if not lone else
             "; that row alone %.5f ms a launch (CUDA graph of %d); device "
             "time / lone-row time %.2f" % (extra["lone_row_ms"],
                                            GRAPH_LAUNCHES,
                                            dev / extra["lone_row_ms"])))
    return dict(ms=ms, plain_ms=plain_ms, device_ms=dev,
                bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                library_ms=None, launch_floor_ms=floor,
                mean_iterations=iterations, max_iterations=most, **extra)


def phase_sweep():
    """Device time of the K1/K2 kernel at every team width and block size
    of ``SWEEP`` (at width T a launch takes the kernel's first (T, NC)
    pair with NC >= ceil(k / T)), each result held to the plain
    version's objective."""
    import torch
    from convex_dim_red_tpu_torch.ops import simplex_qp
    for projection in ("michelot", "bisect"):
        for seed, (label, shape, teams, block_sizes) in enumerate(SWEEP):
            args = qp_problem(10 + seed, *shape, torch.float32, DEVICE)
            kw = dict(max_iterations=WEIGHTS_MAX_ITERATIONS)
            plain = simplex_qp.quad_simplex_qp_packed_grouped_reference
            want = qp_objective(plain(*args, projection=projection, **kw),
                                *args[:2])
            for team in teams:
                row = []
                for threads in block_sizes:
                    def run():
                        return simplex_qp._packed(
                            *args, None, projection, kw, team=team,
                            threads=threads)[0]
                    got = qp_objective(run(), *args[:2])
                    gap = float(np.max(np.abs(got - want)
                                       / (1.0 + np.abs(want))))
                    check(gap <= 1e-5, "sweep %s %s T=%d threads=%d: "
                          "objective gap %.3e" % (label, shape, team,
                                                  threads, gap))
                    row.append("%d threads %.5f ms"
                               % (threads, device_ms(run)))
                print("  %s %s f32 %s T=%-2d: %s" % (
                    label, shape, projection, team, ", ".join(row)))


def phase_kernel():
    import torch
    from convex_dim_red_tpu_torch.ops import simplex_qp
    dev = "cuda"
    main = qp_problem(0, RESTART_CHUNK, N_SAMPLES, K, torch.float32, dev)
    err = 0.0
    for projection in ("michelot", "bisect"):
        for its in (WEIGHTS_MAX_ITERATIONS, 1000):
            err_p = compare_qp(
                "f32 25x1788x6 %s it=%d" % (projection, its), *main,
                tol_obj=1e-5, projection=projection, max_iterations=its)
            if projection == "michelot" and its == WEIGHTS_MAX_ITERATIONS:
                err = err_p
    compare_qp("f32 25x1788x6 masked", *main, tol_obj=1e-5,
               mask=np.arange(K) != 3, max_iterations=1000)
    torch.cuda.synchronize()
    f64 = qp_problem(1, 3, 257, 11, torch.float64, dev)
    # Over the first iterations, before any row stops, the two agree to
    # rounding.
    for projection in ("michelot", "bisect"):
        compare_qp("f64 3x257x11 %s it=3" % projection, *f64,
                   tol_obj=1e-12, tol_x=1e-12, projection=projection,
                   max_iterations=3)
    compare_qp("f64 3x257x11 michelot", *f64, tol_obj=1e-12, tol_x=1e-8,
               max_iterations=1000)
    # Bisection stops one row a step apart on the card and in the plain
    # version (a threshold near-tie that rounding decides): 3.3e-8 in x
    # at an objective gap of 2e-14 on an H100, so x is held to 1e-7.
    compare_qp("f64 3x257x11 bisect", *f64, tol_obj=1e-12, tol_x=1e-7,
               projection="bisect", max_iterations=1000)
    compare_qp("f32 2x500x20 (T %d)" % simplex_qp.team_width(20),
               *qp_problem(2, 2, 500, 20, torch.float32, dev),
               tol_obj=1e-5, max_iterations=1000)
    compare_qp("f64 2x300x64 (T %d)" % simplex_qp.team_width(64),
               *qp_problem(3, 2, 300, 64, torch.float64, dev),
               tol_obj=1e-8, max_iterations=1000)
    torch.cuda.synchronize()
    return dict(max_abs_err=err, **packed_times(
        "K1", simplex_qp.quad_simplex_qp_packed_grouped,
        simplex_qp.quad_simplex_qp_packed_grouped_reference, main))


def packed_times(name, kernel, plain, args):
    """K1's or K2's times at its path's shape (25 iterations), both
    projections, beside the one-thread-per-row kernel (T = 1) timed the
    same way; the Michelot numbers are returned."""
    from convex_dim_red_tpu_torch.ops import simplex_qp as sq
    k = args[1].shape[-1]
    team = sq.team_width(k)
    grouped = tuple(a if a.ndim == 3 else a[None] for a in args)
    out = {}
    for projection in ("michelot", "bisect"):
        times = kernel_times(name, kernel, plain, args, projection, team,
                             sq.PACKED_THREADS,
                             max_iterations=WEIGHTS_MAX_ITERATIONS)
        one = device_ms(lambda: sq._packed(
            *grouped, None, projection,
            dict(max_iterations=WEIGHTS_MAX_ITERATIONS), team=1)[0])
        print("  %s %s: team width %d %.5f ms, one thread per row %.5f ms "
              "(%.2fx)" % (name, projection, team, times["device_ms"], one,
                           one / times["device_ms"]))
        out.setdefault("times", dict(times, team_width=team,
                                     one_thread_device_ms=one))
    return out["times"]


def _one_group(fn):
    """A grouped plain version called on single-Hessian operands."""
    return lambda A, B, X0, **kw: fn(A[None], B[None], X0[None], **kw)[0]


def phase_more_kernels():
    """K2, K3 and K4 against their plain versions, then warm times at
    each path's shape."""
    import torch
    from convex_dim_red_tpu_torch.ops import simplex_qp as sq
    dev = "cuda"
    k2 = dict(kernel=sq.quad_simplex_qp_packed,
              plain=_one_group(sq.quad_simplex_qp_packed_grouped_reference))
    k3 = dict(kernel=sq.quad_simplex_qp_grouped,
              plain=sq.quad_simplex_qp_grouped_reference)
    k4 = dict(kernel=sq.quad_simplex_qp,
              plain=_one_group(sq.quad_simplex_qp_grouped_reference))
    errors = {}

    single = [t[0] for t in qp_problem(4, 1, N_SAMPLES, K, torch.float32,
                                       dev)]
    for projection in ("michelot", "bisect"):
        dx = compare_qp("K2 f32 1788x6 %s it=25" % projection, *single,
                        tol_obj=1e-5, projection=projection,
                        max_iterations=WEIGHTS_MAX_ITERATIONS, **k2)
        errors.setdefault("K2", dx)
        compare_qp("K2 f32 1788x6 %s it=1000" % projection, *single,
                   tol_obj=1e-5, projection=projection,
                   max_iterations=1000, **k2)

    wide = qp_problem(5, 4, N_SAMPLES, WIDE_K, torch.float32, dev)
    errors["K3"] = compare_qp("K3 f32 4x1788x96", *wide, tol_obj=1e-5,
                              max_iterations=1000, **k3)
    errors["K4"] = compare_qp("K4 f32 1788x96", *(t[0] for t in wide),
                              tol_obj=1e-5, max_iterations=1000, **k4)
    compare_qp("K4 f32 1788x6", *single, tol_obj=1e-5,
               max_iterations=1000, **k4)
    compare_qp("K3 f32 4x1788x96 masked", *wide, tol_obj=1e-5,
               mask=np.arange(WIDE_K) % 7 != 3, max_iterations=1000, **k3)
    f64 = qp_problem(6, 3, 257, 100, torch.float64, dev)
    compare_qp("K3 f64 3x257x100 it=3", *f64, tol_obj=1e-12, tol_x=1e-12,
               max_iterations=3, **k3)
    # Converged bisection may stop a row a step apart (see phase 3).
    compare_qp("K3 f64 3x257x100", *f64, tol_obj=1e-12, tol_x=1e-7,
               max_iterations=1000, **k3)
    compare_qp("K4 f64 300x128 (128 KiB shared)",
               *(t[0] for t in qp_problem(7, 1, 300, 128, torch.float64,
                                          dev)),
               tol_obj=1e-12, tol_x=1e-7, max_iterations=1000, **k4)
    torch.cuda.synchronize()

    out = {"K2": packed_times("K2", k2["kernel"], k2["plain"], single)}
    # K3/K4 take the bisection only; the launch floor is an empty kernel
    # on a grid of a block per 8 rows (team width 32 in blocks of 256
    # lanes), at least the grid of csrc/simplex_qp_unpacked.cu, which
    # launches only the blocks that can be resident.
    for key, kind, args in (("K3", k3, wide),
                            ("K4", k4, [t[0] for t in wide])):
        out[key] = kernel_times(
            key, lambda *a, projection, **kw: kind["kernel"](*a, **kw),
            lambda *a, projection, **kw: kind["plain"](*a, **kw), args,
            "bisect", 32, 256, lone=True, max_iterations=1000)
    return {key: dict(max_abs_err=errors[key], **times)
            for key, times in out.items()}


def fit_kwargs():
    return dict(init='random', tolerance=TOL, max_iterations=MAX_ITER,
                stopping_criterion='rel_delta_f',
                dictionary_solver_kwargs={
                    'max_iterations': DICT_MAX_ITERATIONS},
                weights_solver_kwargs={
                    'max_iterations': WEIGHTS_MAX_ITERATIONS},
                restart_chunk=RESTART_CHUNK,
                compact_iterations=COMPACT_ITERS)


def fit_on_card_and_cpu(delta):
    """The same float64 fit on the card and on the CPU, from the same
    initial states (a CPU generator draws them on both).  The data is a
    numpy array: with no ``device`` the fit runs on the card, with
    ``device='cpu'`` on the CPU.  This planted problem is well
    conditioned, so rounding differences between the two stay far below
    the 1e-6 compared here.  ``backend='pallas'`` on both: 'auto' runs
    the row solver on the CPU, which stops on another rule.  Holds the
    per-restart costs within 1e-6 relative and the iteration counts
    equal; returns ``({device: result}, {device: wall}, the card's
    launches)``."""
    import torch
    from convex_dim_red_tpu_torch import aa_fit_restarts
    from convex_dim_red_tpu_torch.parallel.dryrun import planted_data
    X = planted_data(0, 300, 40, 6, 0.01)
    kw = dict(fit_kwargs(), delta=delta, tolerance=1e-6, max_iterations=200,
              restart_chunk=4)
    kw['weights_solver_kwargs'] = dict(kw['weights_solver_kwargs'],
                                       backend='pallas')
    res, walls = {}, {}
    reset_launches()
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        res[dev] = aa_fit_restarts(X, 6, torch.Generator().manual_seed(0),
                                   8, **kw, **({} if dev == "cuda" else
                                               dict(device=dev)))
        torch.cuda.synchronize()
        walls[dev] = time.perf_counter() - t0
    launches = read_launches()
    for dev, r in res.items():
        check(r["weights"].device.type == dev,
              "aa_fit_restarts(numpy%s) ran on %s"
              % ("" if dev == "cuda" else ", device='cpu'",
                 r["weights"].device))
    card, cpu = res["cuda"], res["cpu"]
    rel = float(np.max(np.abs(card["costs"] / cpu["costs"] - 1.0)))
    print("  float64 300x40, k=6, delta %g, 8 restarts: costs on the card "
          "vs the CPU max rel diff %.3e; n_iters %s vs %s, winners %d and "
          "%d; walls %.2f s on the card, %.2f s on the CPU, launches %s"
          % (delta, rel, card["n_iters"].tolist(), cpu["n_iters"].tolist(),
             card["best_index"], cpu["best_index"], walls["cuda"],
             walls["cpu"], launches))
    check(rel <= 1e-6, "delta %g fit: card and CPU costs differ by %.3e"
          % (delta, rel))
    check(np.array_equal(card["n_iters"], cpu["n_iters"]),
          "delta %g fit: n_iters %s on the card, %s on the CPU"
          % (delta, card["n_iters"].tolist(), cpu["n_iters"].tolist()))
    check(launches["K1"] > 0, "delta %g fit: no K1 launch on the card"
          % delta)
    return res, walls, launches


def phase_small_fit():
    """``fit_on_card_and_cpu`` with delta = 0, and the estimator on a
    numpy array with no ``device``, which must run on the card."""
    import torch
    from convex_dim_red_tpu_torch import ArchetypalAnalysis
    from convex_dim_red_tpu_torch.parallel.dryrun import planted_data
    _, walls, _ = fit_on_card_and_cpu(0.0)
    # Two iterations are enough to show where the fit runs: the
    # estimator's default dictionary step takes up to 10,000 SPG
    # iterations an outer iteration.
    t0 = time.perf_counter()
    model = ArchetypalAnalysis(6, init='furthest_sum', random_state=0,
                               max_iterations=2).fit(
                                   planted_data(0, 300, 40, 6, 0.01))
    torch.cuda.synchronize()
    walls["estimator"] = time.perf_counter() - t0
    check(model.weights.device.type == "cuda"
          and model.archetypes.device.type == "cuda",
          "ArchetypalAnalysis.fit(numpy) ran on %s" % model.weights.device)
    print("  a numpy array with no device= ran aa_fit_restarts and "
          "ArchetypalAnalysis.fit on the card (walls: restarts %.2f s on "
          "the card, %.2f s on the CPU; estimator %.2f s)"
          % (walls["cuda"], walls["cpu"], walls["estimator"]))


#: K5's shapes: the benchmark's main path (25 restarts of the
#: HadISST-scale data, 1788 x 24,030, k = 6) and the JRA-55 PC analyses'
#: (100 restarts of 732 x 167, k = 4), where its restarts split into
#: groups.
K5_SHAPES = (("HadISST scale", RESTART_CHUNK, N_SAMPLES, 24030, K),
             ("JRA-55 PCs", 100, 732, 167, 4))


def k5_operands(seed, R, n, d, k):
    """K5's float32 operands as the AA iterate forms them: data of
    ``make_data``'s model, ``C`` and ``Z`` on the simplex, ``CX = C X``
    and ``alpha`` in [0.9, 1.1]; returns ``(X, Z, C, CX, alpha)``."""
    import torch
    rng = np.random.RandomState(seed)
    X = torch.as_tensor(make_data(n, d), device=DEVICE)
    C = torch.as_tensor(rng.dirichlet(np.ones(n), size=(R, k)),
                        dtype=torch.float32, device=DEVICE)
    Z = torch.as_tensor(rng.dirichlet(np.ones(k), size=(R, n)),
                        dtype=torch.float32, device=DEVICE)
    alpha = torch.as_tensor(rng.uniform(0.9, 1.1, size=(R, k)),
                            dtype=torch.float32, device=DEVICE)
    return X, Z, C, (C @ X).contiguous(), alpha


def phase_k5():
    """K5 against its plain version in float64 and float32 at
    ``K5_SHAPES``, then its times: the device's (CUDA graph), the plain
    version's and the ``C X`` product's (the rest of the cost's span)
    the same way, the wrapper's (CUDA events), and the bound
    ``max(bytes / 3.35 TB/s, 2 R n d (k + 1) / 67 TFLOP/s)`` (X, Z, CX,
    alpha read once, the sums written once).
    Returns the numbers at the first shape."""
    import torch
    from convex_dim_red_tpu_torch.ops import residual_cost as rc
    out = {}
    for seed, (label, R, n, d, k) in enumerate(K5_SHAPES):
        X, Z, C, CX, alpha = k5_operands(seed, R, n, d, k)
        args = (X, Z, CX, alpha)
        got = rc.residual_sq_sums(*args)
        again = rc.residual_sq_sums(*args)
        plain = rc.residual_sq_sums_reference(*args)
        want = rc.residual_sq_sums_reference(*(t.double() for t in args))
        torch.cuda.synchronize()
        check(torch.equal(got, again), label + ": K5 bits differ")
        err = float(((got.double() - want).abs() / want).max())
        plain_err = float(((plain.double() - want).abs() / want).max())
        check(err <= 1e-6, "%s: K5 %.3e from float64" % (label, err))
        dev = device_ms(lambda: rc.residual_sq_sums(*args))
        wrapper_ms = cuda_median_ms(lambda: rc.residual_sq_sums(*args))
        plain_ms = device_ms(lambda: rc.residual_sq_sums_reference(*args))
        gemm_ms = device_ms(lambda: C @ X)
        flops = 2.0 * R * n * d * (k + 1)
        nbytes = 4 * (n * d + R * n * k + R * k * d + R * k + R)
        bound = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float32"])
        bound_ms = 1e3 * bound
        print("  K5 %s (%d, %d, %d, %d) float32: device %.5f ms a launch "
              "(CUDA graph of %d), wrapper %.4f ms (CUDA events, median of "
              "10), plain version %.4f ms (%.1fx), C X "
              "%.5f ms; bound %.5f ms (%s: %d bytes -> %.5f ms, %.4g "
              "flops -> %.5f ms), %.1f%% of it; max rel err against "
              "float64 %.3e (plain version in float32 %.3e)"
              % (label, R, n, d, k, dev, GRAPH_LAUNCHES, wrapper_ms,
                 plain_ms, plain_ms / dev, gemm_ms, bound_ms,
                 "ops" if flops / PEAK_FLOPS["float32"]
                 > nbytes / HBM_BYTES_PER_S else "bytes", nbytes,
                 1e3 * nbytes / HBM_BYTES_PER_S, flops,
                 1e3 * flops / PEAK_FLOPS["float32"], 100.0 * bound_ms / dev,
                 err, plain_err))
        out.setdefault("times", dict(
            shape=[R, n, d, k], device_ms=dev, ms=wrapper_ms,
            plain_ms=plain_ms, cx_gemm_ms=gemm_ms, bound_ms=bound_ms,
            share=bound_ms / dev, max_rel_err=err,
            plain_max_rel_err=plain_err))
        del X, Z, C, CX, alpha, args, plain, want
        torch.cuda.empty_cache()
    return out["times"]


def audit_cost_f64(result, X32):
    """bench.py:audit_cost_f64: the winner re-costed on the host in
    float64."""
    X64 = np.asarray(X32, np.float64)
    Z = result['weights'].double().cpu().numpy()
    D = result['dictionary'].double().cpu().numpy()
    resid = Z @ (D @ X64) - X64
    return 0.5 * float(np.sum(resid * resid)) / X64.shape[0]


def add_launches(total, launches):
    """Add one path's launch counts to ``total``; returns ``total``."""
    for key, count in launches.items():
        total[key] += count
    return total


def reset_launches():
    from convex_dim_red_tpu_torch.ops import simplex_qp
    for *_, counter in KERNELS:
        setattr(simplex_qp, counter, 0)


def read_launches():
    from convex_dim_red_tpu_torch.ops import simplex_qp
    return {key: getattr(simplex_qp, counter)
            for key, *_, counter in KERNELS}


def phase_main_path(card):
    import torch
    from convex_dim_red_tpu_torch import aa_fit_restarts
    from convex_dim_red_tpu_torch.ops import residual_cost
    from convex_dim_red_tpu_torch.utils.precision import (
        set_matmul_precision)
    set_matmul_precision('float32')
    X_host = make_data()
    X = torch.as_tensor(X_host, device="cuda")

    def run():
        out = aa_fit_restarts(X, K, 0, N_INIT, **fit_kwargs())
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    run()
    warm_s = time.perf_counter() - t0
    reset_launches()
    residual_cost.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = run()
    elapsed = time.perf_counter() - t0
    launches = read_launches()
    cost_launches = residual_cost.LAUNCHES
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    Z, C = result['weights'], result['dictionary']
    n_iters = result['n_iters']
    total_iters = int(np.sum(n_iters))
    check(Z.shape == (N_SAMPLES, K) and C.shape == (K, N_SAMPLES),
          "unexpected factor shapes %s, %s" % (Z.shape, C.shape))
    for name, M in (("Z", Z), ("C", C)):
        dev = float((M.double().sum(dim=1) - 1.0).abs().max())
        check(dev <= 1e-4, "%s rows off the simplex by %.3e" % (name, dev))
        check(float(M.min()) >= 0.0, name + " has negative entries")
    check(bool(np.all(np.isfinite(result['costs']))), "non-finite costs")
    used = compacted_launches(n_iters, RESTART_CHUNK, COMPACT_ITERS,
                              MAX_ITER)
    check(launches == dict(K1=used, K2=0, K3=0, K4=0),
          "main path: launches %s, expected %d of K1" % (launches, used))
    # One cost an iteration and one for each round's initial states.
    print("  K5 launches %d: %d iterations and %d rounds' initial costs"
          % (cost_launches, used, cost_launches - used))
    check(cost_launches > used, "main path: %d K5 launches for %d K1"
          % (cost_launches, used))
    audit = audit_cost_f64(result, X_host)
    rel = abs(audit / REFERENCE_AUDITED_COST - 1.0)
    print("  device cost %.4f, float64 audit %.4f, JAX reference audit "
          "%.2f (rel diff %.2e)" % (result['cost'], audit,
                                    REFERENCE_AUDITED_COST, rel))
    print("  wall %.3f s timed (%.3f s first run), %d restarts, mean "
          "outer iterations %.2f, %.1f restart-iterations/s, %d kernel "
          "launches, peak memory %.2f GB, on %s"
          % (elapsed, warm_s, N_INIT, float(np.mean(n_iters)),
             total_iters / elapsed, launches["K1"], peak_gb, card))
    check(rel <= AUDIT_RTOL, "audited cost %.4f is %.2e from %.2f"
          % (audit, rel, REFERENCE_AUDITED_COST))
    RESULTS["main path"] = dict(costs=result['costs'], audit=audit,
                                best_index=result['best_index'],
                                launches=launches["K1"])
    return launches, X_host, result, elapsed


def check_factors(name, model, X):
    """Rows of the weights (and of C) on the simplex, finite costs."""
    import torch
    for part, M in (("weights", model.weights),
                    ("C", model.dictionary / model.alpha[:, None])):
        dev = float((M.double().sum(dim=1) - 1.0).abs().max())
        check(dev <= 1e-4, "%s: %s rows off the simplex by %.3e"
              % (name, part, dev))
        check(float(M.min()) >= 0.0, "%s: negative %s" % (name, part))
    check(bool(torch.isfinite(model.archetypes).all())
          and np.isfinite(model.cost), name + ": non-finite fit")


def watchdog_threshold(X, tolerance):
    """The fit's watchdog: max(tolerance, 64 eps tr K) (tr K = ||X||^2)."""
    import torch
    trace_K = float(torch.sum(X.double() * X.double()))
    return max(tolerance, 64.0 * float(torch.finfo(X.dtype).eps) * trace_K)


def phase_estimator(X_host, card):
    """ArchetypalAnalysis at full width, k = 6: the default weights
    backend and 'pallas', then transform."""
    import torch
    from convex_dim_red_tpu_torch import ArchetypalAnalysis
    from convex_dim_red_tpu_torch.ops.furthest_sum import (
        dissimilarities_from_kernel, furthest_sum, furthest_sum_device)
    X = torch.as_tensor(X_host, device=DEVICE)

    # FurthestSum on the device against the host version, on the same
    # dissimilarities (the estimator's init runs the host one; the
    # restarts run the device one).
    diss = dissimilarities_from_kernel(X @ X.T)
    starts = [0, 17, N_SAMPLES // 2, N_SAMPLES - 1]
    dev_sel = furthest_sum_device(diss, K, torch.as_tensor(starts),
                                  extra_steps=10).cpu().numpy()
    diss_host = diss.cpu().numpy()
    for i, s in enumerate(starts):
        host = furthest_sum(diss_host, K, s, extra_steps=10)
        check(np.array_equal(dev_sel[i], host),
              "FurthestSum from %d: device %s, host %s"
              % (s, dev_sel[i].tolist(), host.tolist()))
    print("  FurthestSum: device and host pick the same %d samples from "
          "%d start indices" % (K, len(starts)))

    def make(backend=None):
        weights = {'max_iterations': WEIGHTS_MAX_ITERATIONS}
        if backend:
            weights['backend'] = backend
        return ArchetypalAnalysis(
            K, init='furthest_sum', random_state=0, tolerance=TOL,
            stopping_criterion='rel_delta_f', max_iterations=MAX_ITER,
            dictionary_solver_kwargs={
                'max_iterations': DICT_MAX_ITERATIONS},
            weights_solver_kwargs=weights)

    thresh = watchdog_threshold(X, TOL)
    fits = {}
    total = dict.fromkeys(read_launches(), 0)
    for label, backend in (("default (row solver)", None),
                           ("pallas (K2)", "pallas")):
        model = make(backend)
        reset_launches()
        t0 = time.perf_counter()
        model.fit(X)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        audit = audit_cost_f64(dict(weights=model.weights,
                                    dictionary=model.dictionary), X_host)
        rel = abs(audit / model.cost - 1.0)
        print("  fit, weights backend %s: wall %.3f s, n_iter %d, device "
              "cost %.4f, float64 audit %.4f (rel diff %.2e; best of 100 "
              "%.2f), launches %s, on %s"
              % (label, wall, model.n_iter, model.cost, audit, rel,
                 REFERENCE_AUDITED_COST, launches, card))
        check_factors("fit " + label, model, X)
        check(rel <= 1e-4, "%s: audit %.4f vs device cost %.4f"
              % (label, audit, model.cost))
        rise = float(np.max(model.cost_deltas))
        check(rise <= thresh, "%s: the cost rose by %.3e > watchdog %.3e"
              % (label, rise, thresh))
        if backend == "pallas":
            RESULTS["estimator pallas"] = dict(cost=model.cost,
                                               n_iter=model.n_iter)
            check(launches["K2"] == model.n_iter,
                  "pallas fit: %d K2 launches for %d iterations"
                  % (launches["K2"], model.n_iter))
            add_launches(total, launches)
        else:
            check(sum(launches.values()) == 0,
                  "the row-solver fit launched a kernel: %s" % launches)
        fits[label] = model

    model = fits["default (row solver)"]
    reset_launches()
    t0 = time.perf_counter()
    W, cost = model.transform(X)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    print("  transform (auto -> K2): wall %.3f s, cost %.4f (fit %.4f), "
          "launches %s" % (wall, cost, model.cost, launches))
    check(launches == dict(K1=0, K2=1, K3=0, K4=0),
          "transform: launches %s, expected one K2" % launches)
    check(cost <= model.cost * (1 + 1e-4),
          "transform cost %.4f above the fit's %.4f" % (cost, model.cost))
    dev = float((W.double().sum(dim=1) - 1.0).abs().max())
    check(dev <= 1e-4 and float(W.min()) >= 0.0,
          "transform weights off the simplex by %.3e" % dev)
    return add_launches(total, launches)


def phase_wide(X_host):
    """k = 96 at full width: the estimator with K4, the restarts with
    K3."""
    import torch
    from convex_dim_red_tpu_torch import ArchetypalAnalysis, aa_fit_restarts
    X = torch.as_tensor(X_host, device=DEVICE)
    thresh = watchdog_threshold(X, 1e-6)

    model = ArchetypalAnalysis(WIDE_K, init='furthest_sum', random_state=0,
                               max_iterations=10,
                               weights_solver_kwargs={'backend': 'pallas'})
    reset_launches()
    t0 = time.perf_counter()
    model.fit(X)
    W, cost = model.transform(X)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    est = read_launches()
    print("  estimator k=96 fit + transform: wall %.3f s, n_iter %d, cost "
          "%.4f, transform cost %.4f, launches %s"
          % (wall, model.n_iter, model.cost, cost, est))
    check_factors("k=96 fit", model, X)
    check(float(np.max(model.cost_deltas)) <= thresh,
          "k=96 fit: the cost rose past the watchdog")
    check(est["K4"] == model.n_iter + 1 and est["K2"] == 0,
          "k=96 fit: launches %s for %d iterations" % (est, model.n_iter))
    check(float((W.double().sum(dim=1) - 1).abs().max()) <= 1e-4
          and float(W.min()) >= 0.0 and np.isfinite(cost),
          "k=96 transform: weights off the simplex")

    reset_launches()
    t0 = time.perf_counter()
    res = aa_fit_restarts(X, WIDE_K, 0, 4, restart_chunk=4,
                          compact_iterations=8, max_iterations=16,
                          init='furthest_sum')
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rst = read_launches()
    print("  aa_fit_restarts k=96, 4 restarts: wall %.3f s, costs %s, "
          "n_iters %s, launches %s"
          % (wall, np.round(res['costs'], 4).tolist(),
             res['n_iters'].tolist(), rst))
    check(bool(np.all(np.isfinite(res['costs']))), "k=96 restarts: costs")
    check(float(np.max(res['cost_deltas'])) <= thresh,
          "k=96 restarts: the cost rose past the watchdog")
    check(rst["K3"] > 0 and rst["K1"] == 0,
          "k=96 restarts: launches %s" % rst)
    for name, M in (("Z", res['weights']), ("C", res['dictionary'])):
        dev = float((M.double().sum(dim=1) - 1.0).abs().max())
        check(dev <= 1e-4 and float(M.min()) >= 0.0,
              "k=96 restarts: %s rows off the simplex by %.3e" % (name, dev))
    return {"AA estimator k=96, fit + transform": est,
            "AA best of 4, k=96, compaction": rst}


def gpnh_audit(result, pcs_host):
    """The GPNH winner re-costed on the host in float64, its penalty from
    the pairwise definition: ``0.5 ||X - Z W'||^2 / n + lambda_W 2 / (k d
    (k - 1)) sum_{i<j} ||w_i - w_j||^2``."""
    X = np.asarray(pcs_host, np.float64)
    Z = result['weights'].double().cpu().numpy()
    W = result['dictionary'].double().cpu().numpy()
    d, k = W.shape
    pairs = sum(np.sum((W[:, i] - W[:, j]) ** 2)
                for i in range(k) for j in range(i + 1, k))
    penalty = 2.0 / (k * d * (k - 1)) * pairs
    resid = X - Z @ W.T
    return (0.5 * float(np.sum(resid * resid)) / X.shape[0]
            + GPNH_FIT['lambda_W'] * penalty)


#: The QP dispatch's (solvers/spg.py) names of the K1 and K2 wrappers.
K1_WRAPPER, K2_WRAPPER = ("quad_simplex_qp_packed_grouped",
                          "quad_simplex_qp_packed")


def capture_operands(run, calls):
    """Run ``run()`` with the QP dispatch's kernel wrappers named in
    ``calls`` (``{wrapper: call numbers, from 0}``) recording the operands
    of those calls: ``(run's result, {wrapper: {call: (A, B, X0, solver
    arguments)}})``."""
    from convex_dim_red_tpu_torch.ops import simplex_qp
    from convex_dim_red_tpu_torch.solvers import spg
    captured = {name: {} for name in calls}

    def recording(name):
        real, seen = getattr(simplex_qp, name), [0]

        def wrapper(A, B, X0, **kw):
            if seen[0] in calls[name]:
                captured[name][seen[0]] = (A.clone(), B.clone(), X0.clone(),
                                           dict(kw))
            seen[0] += 1
            return real(A, B, X0, **kw)
        return wrapper

    for name in calls:
        setattr(spg, name, recording(name))
    try:
        result = run()
    finally:
        for name in calls:
            setattr(spg, name, getattr(simplex_qp, name))
    return result, captured


def capture_k1_operands(run, calls):
    """K1's operands at its calls numbered ``calls``: ``{call: (As, Bs,
    X0s, solver arguments)}``."""
    return capture_operands(run, {K1_WRAPPER: calls})[1][K1_WRAPPER]


def compacted_launches(n_iters, chunk, round_iterations, max_iterations):
    """K1 launches of a compacted restart fit whose restarts took
    ``n_iters``: each round of ``M = round_iterations`` runs every chunk
    of ``chunk`` restarts still pending (those with more than ``r M``
    iterations) for one grouped QP call an iteration."""
    n_iters = np.asarray(n_iters)
    launches, used = 0, 0
    while used < max_iterations:
        pending = int(np.sum(n_iters > used))
        if not pending:
            break
        M = min(round_iterations, max_iterations - used)
        launches += -(-pending // min(chunk, len(n_iters))) * M
        used += M
    return launches


def check_simplex_rows(name, M):
    dev = float((M.double().sum(dim=1) - 1.0).abs().max())
    check(dev <= 1e-4 and float(M.min()) >= 0.0,
          "%s rows off the simplex by %.3e" % (name, dev))


def phase_pca_gpnh(card):
    """Config 4 at full size: PCA(167) of 732 x 8192 on the card, then
    the best-of-16 and best-of-100 GPNH fits, one-shot default; K1 at the
    path's shape."""
    import torch
    from convex_dim_red_tpu_torch import PCA, gpnh_fit_restarts
    from convex_dim_red_tpu_torch.ops import simplex_qp as sq
    from convex_dim_red_tpu_torch.parallel.sharded_aa import _ROUND
    X = torch.as_tensor(make_data(GPNH_SAMPLES, GPNH_FEATURES),
                        device=DEVICE)
    paths = {}
    reset_launches()
    t0 = time.perf_counter()
    pca = PCA(PCA_MODES)
    pcs = pca.fit_transform(X)
    torch.cuda.synchronize()
    pca_s = time.perf_counter() - t0
    paths["PCA(167)"] = read_launches()
    check(pcs.shape == (GPNH_SAMPLES, PCA_MODES)
          and bool(torch.isfinite(pcs).all()), "PCA scores: %s, finite %s"
          % (tuple(pcs.shape), bool(torch.isfinite(pcs).all())))
    # The scores come from the Gram's eigenvectors, the transform from
    # the components X_c' v / s: in float32 a trailing mode carries the
    # rounding of the leading one, amplified by s_1 / s.
    again = pca.transform(X)
    gap = float((again - pcs).abs().max() / pcs.abs().max())
    print("  PCA(%d) of %dx%d (Gram path): %.3f s (first call), explained "
          "variance ratio %.4f in all, first three %s; transform(X) vs the "
          "scores max rel diff %.2e"
          % (PCA_MODES, GPNH_SAMPLES, GPNH_FEATURES, pca_s,
             float(np.sum(pca.explained_variance_ratio_)),
             np.round(pca.explained_variance_ratio_[:3], 4).tolist(), gap))
    check(gap <= 1e-3, "PCA transform differs from the scores by %.2e"
          % gap)
    pcs_host = pcs.cpu().numpy()
    RESULTS["pcs"] = pcs_host
    RESULTS["pca explained variance"] = pca.explained_variance_

    results = {}
    for n_init in (16, 100):
        def run():
            out = gpnh_fit_restarts(pcs, GPNH_K, 0, n_init, **GPNH_FIT)
            torch.cuda.synchronize()
            return out

        # The best of 100's first run records K1's operands at its first
        # launch (random weights, a fresh dictionary) and at the first
        # launch of its second round (warm weights).
        t0 = time.perf_counter()
        if n_init == 100:
            captured = capture_k1_operands(run, (0, 32))
        else:
            run()
        warm_s = time.perf_counter() - t0
        reset_launches()
        t0 = time.perf_counter()
        res = run()
        wall = time.perf_counter() - t0
        launches = read_launches()
        paths["GPNH best of %d, one-shot" % n_init] = launches
        n_iters = res['n_iters']
        check(bool(np.all(np.isfinite(res['costs']))), "non-finite costs")
        check_simplex_rows("GPNH weights", res['weights'])
        used = compacted_launches(n_iters, n_init, _ROUND,
                                  GPNH_FIT['max_iterations'])
        check(launches == dict(K1=used, K2=0, K3=0, K4=0),
              "GPNH best of %d: launches %s, expected %d of K1"
              % (n_init, launches, used))
        audit = gpnh_audit(res, pcs_host)
        ref, rtol = GPNH_REFERENCE[n_init]
        rel = abs(audit / ref - 1.0)
        print("  GPNH best of %d: wall %.3f s timed (%.3f s first run), %d "
              "K1 launches, n_iter %d, n_iters mean %.2f max %d, device "
              "cost %.4f, float64 audit %.4f (device vs audit %.2e), "
              "reference %.4f (rel diff %.2e, limit %.0e), on %s"
              % (n_init, wall, warm_s, launches["K1"], res['n_iter'],
                 float(np.mean(n_iters)), int(np.max(n_iters)), res['cost'],
                 audit, abs(res['cost'] / audit - 1.0), ref, rel, rtol,
                 card))
        check(rel <= rtol, "GPNH best of %d: audited cost %.4f is %.2e from "
              "%.4f" % (n_init, audit, rel, ref))
        results[n_init] = (res, wall)
    RESULTS["gpnh 100"] = dict(costs=results[100][0]['costs'],
                               best_index=results[100][0]['best_index'])

    # K1 at the path's shape, on the recorded operands.
    times = {}
    for call, (As, Bs, X0s, kw) in sorted(captured.items()):
        projection = kw.pop("projection")
        check(kw.pop("mask") is None, "a masked GPNH QP")
        compare_qp("K1 GPNH (100, 732, 4) f32, launch %d" % call, As, Bs,
                   X0s, tol_obj=1e-5, projection=projection, **kw)
        times[call] = kernel_times(
            "K1 GPNH launch %d" % call, sq.quad_simplex_qp_packed_grouped,
            sq.quad_simplex_qp_packed_grouped_reference, (As, Bs, X0s),
            projection, sq.team_width(GPNH_K), sq.PACKED_THREADS,
            lone=True, **kw)
    return pcs, pcs_host, results, paths, times


def scheduler_agreement(name, one_shot, compacted):
    """Per-restart costs of two schedulers within SCHEDULER_RTOL and the
    same winner; prints how many restarts' n_iters differ."""
    rel = float(np.max(np.abs(compacted['costs'] / one_shot['costs']
                              - 1.0)))
    differ = int(np.sum(compacted['n_iters'] != one_shot['n_iters']))
    print("  %s: per-restart costs max rel diff %.2e, winners %d and %d, "
          "%d of %d restarts' n_iters differ"
          % (name, rel, one_shot['best_index'], compacted['best_index'],
             differ, len(one_shot['costs'])))
    check(rel <= SCHEDULER_RTOL, "%s: costs differ by %.2e" % (name, rel))
    check(one_shot['best_index'] == compacted['best_index'],
          "%s: winners %d and %d" % (name, one_shot['best_index'],
                                     compacted['best_index']))


def phase_gpnh_compaction(pcs, one_shot, card):
    """The best-of-100 GPNH fit under compaction from the same seed, run
    once to warm up and once timed, as the one-shot default was."""
    import torch
    from convex_dim_red_tpu_torch import gpnh_fit_restarts

    def run():
        out = gpnh_fit_restarts(pcs, GPNH_K, 0, 100,
                                compact_iterations=COMPACT_ITERS,
                                restart_chunk=RESTART_CHUNK, **GPNH_FIT)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    run()
    warm_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    res = run()
    wall = time.perf_counter() - t0
    launches = read_launches()
    print("  GPNH best of 100, compaction (rounds of %d, chunks of %d): "
          "wall %.3f s timed (%.3f s first run; the one-shot default, one "
          "chunk of 100, %.3f s timed), %d K1 launches, on %s"
          % (COMPACT_ITERS, RESTART_CHUNK, wall, warm_s, one_shot[1],
             launches["K1"], card))
    used = compacted_launches(res['n_iters'], RESTART_CHUNK, COMPACT_ITERS,
                              GPNH_FIT['max_iterations'])
    check(launches == dict(K1=used, K2=0, K3=0, K4=0),
          "GPNH compaction: launches %s, expected %d of K1"
          % (launches, used))
    scheduler_agreement("GPNH best of 100, one-shot vs compaction",
                        one_shot[0], res)
    return {"GPNH best of 100, compaction": launches}


def phase_gpnh_estimator(pcs, pcs_host, card):
    """GPNHConvexCoding on the PCs: the row solver and K2, each fit then
    transform."""
    import torch
    from convex_dim_red_tpu_torch import GPNHConvexCoding
    trace = float(torch.sum(pcs.double() * pcs.double()))
    thresh = max(GPNH_FIT['tolerance'],
                 64.0 * float(torch.finfo(pcs.dtype).eps) * trace)
    paths = {}
    for label, backend in (("default (row solver)", None),
                           ("pallas (K2)", "pallas")):
        weights = {'backend': backend} if backend else {}
        model = GPNHConvexCoding(
            GPNH_K, lambda_W=GPNH_FIT['lambda_W'], init='random',
            random_state=0, tolerance=GPNH_FIT['tolerance'],
            stopping_criterion='rel_delta_f',
            max_iterations=GPNH_FIT['max_iterations'],
            weights_solver_kwargs=weights)
        reset_launches()
        t0 = time.perf_counter()
        model.fit(pcs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        audit = gpnh_audit(dict(weights=model.weights,
                                dictionary=model.dictionary), pcs_host)
        rel = abs(audit / model.cost - 1.0)
        rise = float(np.max(model.cost_deltas))
        print("  fit, weights backend %s: wall %.3f s, n_iter %d, device "
              "cost %.4f, float64 audit %.4f (rel diff %.2e; best of 100 "
              "%.4f), largest cost rise %.3e (watchdog %.3e), launches %s, "
              "on %s" % (label, wall, model.n_iter, model.cost, audit, rel,
                         GPNH_REFERENCE[100][0], rise, thresh, launches,
                         card))
        check_simplex_rows("GPNH fit " + label, model.weights)
        check(rel <= 1e-4, "%s: audit %.4f vs device cost %.4f"
              % (label, audit, model.cost))
        check(rise <= thresh, "%s: the cost rose by %.3e > watchdog %.3e"
              % (label, rise, thresh))
        expected = dict(K1=0, K2=model.n_iter if backend else 0, K3=0, K4=0)
        check(launches == expected, "%s fit: launches %s, expected %s"
              % (label, launches, expected))

        reset_launches()
        t0 = time.perf_counter()
        W, cost = model.transform(pcs)
        torch.cuda.synchronize()
        t_wall = time.perf_counter() - t0
        t_launches = read_launches()
        print("  transform, weights backend %s: wall %.3f s, cost %.4f "
              "(fit %.4f), launches %s"
              % (label, t_wall, cost, model.cost, t_launches))
        check(cost <= model.cost * (1 + 1e-4),
              "transform cost %.4f above the fit's %.4f" % (cost, model.cost))
        check_simplex_rows("GPNH transform " + label, W)
        check(t_launches["K1"] == t_launches["K3"] == t_launches["K4"] == 0
              and (t_launches["K2"] > 0 if backend
                   else t_launches["K2"] == 0),
              "transform %s: launches %s" % (label, t_launches))
        paths["GPNH estimator %s, fit + transform" % label] = add_launches(
            launches, t_launches)
    return paths


def phase_aa_one_shot(X_host, compacted, compacted_wall, card):
    """The main path's workload with the default
    ``compact_iterations=None``, once: rounds of 32 over chunks of 25,
    phase 7's schedule, so the same launches and bits."""
    import torch
    from convex_dim_red_tpu_torch import aa_fit_restarts
    from convex_dim_red_tpu_torch.parallel.sharded_aa import _ROUND
    X = torch.as_tensor(X_host, device=DEVICE)
    reset_launches()
    t0 = time.perf_counter()
    res = aa_fit_restarts(X, K, 0, N_INIT,
                          **dict(fit_kwargs(), compact_iterations=None))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    check_simplex_rows("AA one-shot Z", res['weights'])
    check_simplex_rows("AA one-shot C", res['dictionary'])
    used = compacted_launches(res['n_iters'], RESTART_CHUNK,
                              _ROUND, MAX_ITER)
    check(launches == dict(K1=used, K2=0, K3=0, K4=0),
          "AA one-shot: launches %s, expected %d of K1" % (launches, used))
    audit = audit_cost_f64(res, X_host)
    rel = abs(audit / REFERENCE_AUDITED_COST - 1.0)
    print("  AA best of 100, one-shot default (rounds of %d, chunks of %d): "
          "wall %.3f s against %.3f s in phase 7, %d K1 launches, n_iters "
          "mean %.2f, device cost %.4f, float64 audit %.4f (rel diff %.2e "
          "from %.2f), on %s"
          % (_ROUND, RESTART_CHUNK, wall, compacted_wall,
             launches["K1"],
             float(np.mean(res['n_iters'])), res['cost'], audit, rel,
             REFERENCE_AUDITED_COST, card))
    check(rel <= AUDIT_RTOL, "audited cost %.4f is %.2e from %.2f"
          % (audit, rel, REFERENCE_AUDITED_COST))
    scheduler_agreement("AA best of 100, one-shot vs compaction", res,
                        compacted)
    return {"AA best of 100, one-shot": launches}


def recording_schedules(run, k_active=None):
    """Run ``run()`` with the restart scheduler
    (``parallel/restarts.py:_compacted_best``) recording each of its
    calls: ``(n_iters, chunk, round, max_iterations)``, whose K1 launches
    ``compacted_launches`` counts.  With ``k_active``, every call's
    final weights must have exactly-zero columns from ``k_active`` on
    (a padded fit).  Returns ``(run's result, calls)``."""
    from convex_dim_red_tpu_torch.parallel import restarts
    real, calls, padded = restarts._compacted_best, [], []

    def recording(R, states_all, **kw):
        out = real(R, states_all, **kw)
        calls.append((out[2].copy(), min(int(kw["restart_chunk"] or R), R),
                      kw["round_iterations"], kw["max_iterations"]))
        tail = out[0][0][..., k_active:] if k_active is not None else None
        if tail is not None and tail.numel():
            padded.append(tail.abs().max())
        return out

    restarts._compacted_best = recording
    try:
        result = run()
    finally:
        restarts._compacted_best = real
    if padded:
        largest = float(torch_max(padded))
        check(largest == 0.0, "padded weight columns reach %.3e" % largest)
    return result, calls


def torch_max(values):
    import torch
    return torch.stack(values).max()


def scheduled_launches(calls):
    """K1 launches that the recorded scheduler calls imply."""
    return sum(compacted_launches(*call) for call in calls)


def timed(run, warm=True):
    """``run()`` once to warm up (with ``warm``), then once more with
    the launch counts reset just before and the scheduler recorded:
    ``(result, wall seconds, launches, scheduler calls, first wall)``."""
    import torch
    first = None
    if warm:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    res, calls = recording_schedules(run)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, read_launches(), calls, first


def check_k1_only(name, launches, calls):
    used = scheduled_launches(calls)
    check(launches == dict(K1=used, K2=0, K3=0, K4=0),
          "%s: launches %s, expected %d of K1 from the schedule"
          % (name, launches, used))
    return used


def phase_screened_aa(X_host, card):
    """bench.py:346-360 on phase 7's data: the best of 100 screened
    (50 iterations, the best quarter plus a margin of 2.0 resume),
    chunks of 25; audited in float64 against phase 7's limit."""
    import torch
    from convex_dim_red_tpu_torch import aa_fit_restarts
    X = torch.as_tensor(X_host, device=DEVICE)
    kw = dict(fit_kwargs(), compact_iterations=None, screen_iterations=50,
              screen_margin=2.0)

    def run():
        return aa_fit_restarts(X, K, 0, N_INIT, **kw)

    res, wall, launches, calls, first = timed(run)
    used = check_k1_only("screened AA", launches, calls)
    screen = res['screen']
    check(len(calls) == 2 and screen['n_screened'] == N_INIT
          and len(calls[1][0]) == screen['n_kept'],
          "screened AA: scheduler calls %s, screen %s"
          % ([len(c[0]) for c in calls], screen))
    phase_launches = [compacted_launches(*c) for c in calls]
    exact = compacted_launches(calls[1][0], screen['n_kept'], *calls[1][2:])
    check_simplex_rows("screened AA Z", res['weights'])
    check_simplex_rows("screened AA C", res['dictionary'])
    audit = audit_cost_f64(res, X_host)
    rel = abs(audit / REFERENCE_AUDITED_COST - 1.0)
    print("  AA best of 100, screened (50 iterations, keep 0.25, margin "
          "2.0, chunks of 25): wall %.3f s timed (%.3f s first run), %d K1 "
          "launches (screen %d, resume %d; the resume's %d survivors in "
          "chunks of %d, where one chunk of all of them would launch %d), "
          "screen %s, n_iters mean %.2f, winner n_iter %d (resume), device "
          "cost %.4f, float64 audit %.4f (rel diff %.2e from %.2f); the JAX "
          "package on a TPU v5e: n_kept 26, audit 3810.04 (BENCH_r05.json), "
          "on %s"
          % (wall, first, used, phase_launches[0], phase_launches[1],
             screen['n_kept'], RESTART_CHUNK, exact, json.dumps(screen),
             float(np.mean(res['n_iters'])), res['n_iter'], res['cost'],
             audit, rel, REFERENCE_AUDITED_COST, card))
    check(rel <= AUDIT_RTOL, "screened AA: audited cost %.4f is %.2e from "
          "%.2f" % (audit, rel, REFERENCE_AUDITED_COST))
    return {"AA best of 100, screened": launches}


def phase_kernel_aa(X_host, card):
    """``kernel_aa_fit_restarts`` best of 100 on phase 7's Gram, with
    phase 7's fit settings: no archetypes, the dictionary is C, and Z
    and alpha C re-costed against X in float64."""
    import torch
    from convex_dim_red_tpu_torch import kernel_aa_fit_restarts
    X = torch.as_tensor(X_host, device=DEVICE)
    gram = X @ X.T

    def run():
        return kernel_aa_fit_restarts(gram, K, 0, N_INIT, **fit_kwargs())

    res, wall, launches, calls, first = timed(run)
    used = check_k1_only("kernel AA", launches, calls)
    check('archetypes' not in res, "kernel AA returned archetypes")
    C = res['dictionary']
    check(C.shape == (K, N_SAMPLES), "kernel AA dictionary %s"
          % (tuple(C.shape),))
    check_simplex_rows("kernel AA C (the dictionary)", C)
    check_simplex_rows("kernel AA Z", res['weights'])
    audit = audit_cost_f64(dict(weights=res['weights'],
                                dictionary=res['alpha'][:, None] * C),
                           X_host)
    rel = abs(audit / REFERENCE_AUDITED_COST - 1.0)
    print("  kernel AA best of 100 on the %dx%d Gram (rounds of %d, chunks "
          "of %d): wall %.3f s timed (%.3f s first run), %d K1 launches, "
          "n_iters mean %.2f, device cost (trace form) %.4f, float64 audit "
          "of Z and alpha C against X %.4f (rel diff %.2e from %.2f), on %s"
          % (N_SAMPLES, N_SAMPLES, COMPACT_ITERS, RESTART_CHUNK, wall, first,
             used, float(np.mean(res['n_iters'])), res['cost'], audit, rel,
             REFERENCE_AUDITED_COST, card))
    check(rel <= AUDIT_RTOL, "kernel AA: audited cost %.4f is %.2e from "
          "%.2f" % (audit, rel, REFERENCE_AUDITED_COST))
    return {"kernel AA best of 100, compaction": launches}


#: Config 5 (benchmarks/run_all.py:139-154): the model-selection sweep's
#: data, component counts and fit settings.
SWEEP_SAMPLES, SWEEP_FEATURES = 900, 4096
SWEEP_KS = tuple(range(2, 21, 3))
SWEEP_FIT = dict(n_init=50, tolerance=1e-5, stopping_criterion='rel_delta_f',
                 max_iterations=200, init='random')
SWEEP_BUCKET = 8
#: The K1 call of the sweep's k = 20 fit whose operands give its warm
#: time: the first of the second round (5 chunks x 32 iterations).
WARM_CALL = 160


def phase_padded_aa(card):
    """Config 5's shape: k = 5 padded to 8 (50 restarts, chunks of 10),
    against the same fit unpadded; then the padded fit from an unpadded
    fit's states, float64 on the card."""
    import torch
    from convex_dim_red_tpu_torch import aa_fit_restarts
    from convex_dim_red_tpu_torch.parallel import restarts
    from convex_dim_red_tpu_torch.parallel.dryrun import planted_data
    X = torch.as_tensor(make_data(SWEEP_SAMPLES, SWEEP_FEATURES),
                        device=DEVICE)
    kw = dict(SWEEP_FIT, restart_chunk=10)
    n_init = kw.pop('n_init')
    walls, out, paths = {}, {}, {}
    for label, pad in (("padded to 8", SWEEP_BUCKET), ("unpadded", None)):
        reset_launches()
        t0 = time.perf_counter()
        res, calls = recording_schedules(
            lambda: aa_fit_restarts(X, 5, 0, n_init, pad_components_to=pad,
                                    **kw),
            k_active=5 if pad else None)
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        launches = read_launches()
        used = check_k1_only("AA k=5 " + label, launches, calls)
        check(res['weights'].shape == (SWEEP_SAMPLES, 5)
              and res['archetypes'].shape == (5, SWEEP_FEATURES),
              "AA k=5 %s: shapes %s" % (label, tuple(res['weights'].shape)))
        check_simplex_rows("AA k=5 %s Z" % label, res['weights'])
        print("  AA k=5 %s, best of 50: wall %.3f s (first call), %d K1 "
              "launches, n_iters mean %.2f, cost %.4f, on %s"
              % (label, walls[label], used, float(np.mean(res['n_iters'])),
                 res['cost'], card))
        out[label] = res
        paths["AA k=5 best of 50, %s" % label] = launches

    # The same active start, unpadded and padded (float64, small): the
    # same per-restart costs and iteration counts.
    Xs = torch.as_tensor(planted_data(1, 300, 40, 5, 0.1), device=DEVICE)
    gen = torch.Generator().manual_seed(0)
    states = restarts._init_aa_state(
        gen, 8, 0.0, n_samples=300, n_components=5, init='random',
        diss=None, n_extra_steps=10, do_scale=False, dtype=torch.float64,
        device=DEVICE)
    Z, C, alpha = states
    Z_pad = torch.zeros((8, 300, 8), dtype=torch.float64, device=DEVICE)
    Z_pad[..., :5] = Z
    C_pad = torch.full((8, 8, 300), 1.0 / 300, dtype=torch.float64,
                       device=DEVICE)
    C_pad[:, :5] = C
    a_pad = torch.ones((8, 8), dtype=torch.float64, device=DEVICE)
    from convex_dim_red_tpu_torch.parallel import sharded_aa
    fits = []
    reset_launches()
    for st, k, mask in ((states, 5, None),
                        ((Z_pad, C_pad, a_pad), 8,
                         restarts._padded_components(5, 8)[1])):
        iterate, cost0 = sharded_aa._aa_iterate(
            Xs, restarts._gram_once(Xs), n_components=k, delta=0.0,
            do_scale=False, sh=sharded_aa._Shard(device=DEVICE),
            dictionary_solver_kwargs={'max_iterations': 1},
            weights_solver_kwargs={'backend': 'pallas',
                                   'max_iterations': 25},
            component_mask=mask)
        best, costs, n_iters, _ = restarts._best_of_restarts(
            iterate, cost0, st, tolerance=1e-6, criterion='rel_delta_f',
            max_iterations=200, restart_chunk=4, compact_iterations=32,
            screen_iterations=None, screen_keep=None, screen_margin=None)
        fits.append((best, costs, n_iters))
    torch.cuda.synchronize()
    check(read_launches()["K1"] > 0, "float64 padded check: no K1 launch")
    (b_r, c_r, i_r), (b_p, c_p, i_p) = fits
    rel = float(np.max(np.abs(c_p / c_r - 1.0)))
    zero = bool((b_p[0][:, 5:] == 0).all())
    print("  float64 300x40, k=5 and the same states padded to 8, 8 "
          "restarts on K1: per-restart costs max rel diff %.3e, n_iters %s "
          "and %s, padded weights exactly 0: %s"
          % (rel, i_r.tolist(), i_p.tolist(), zero))
    check(rel <= 1e-10 and np.array_equal(i_r, i_p) and zero,
          "padded float64: costs %.3e apart, n_iters %s vs %s"
          % (rel, i_r.tolist(), i_p.tolist()))
    print("  padded vs unpadded wall at config 5's shape: %.3f s vs %.3f s "
          "(%.2fx), on %s" % (walls["padded to 8"], walls["unpadded"],
                              walls["padded to 8"] / walls["unpadded"], card))
    return paths, walls


def phase_aa_sweep(card):
    """Config 5 (benchmarks/run_all.py:139-154): the AA sweep k = 2..20
    step 3, best of 50 each, bucketed by 8; K1's operands at k = 20 (k_pad
    24) captured for its time and bound."""
    import torch
    from convex_dim_red_tpu_torch.ops import simplex_qp as sq
    from convex_dim_red_tpu_torch.parallel import sweep
    X_host = make_data(SWEEP_SAMPLES, SWEEP_FEATURES)
    X = torch.as_tensor(X_host, device=DEVICE)
    real_fit = sweep.aa_fit_restarts
    per_k, captured, box = {}, {}, []  # launches by k, K1's operands

    def fit(data, k, *args, **kw):
        before = read_launches()
        t0 = time.perf_counter()

        def call():
            box.append(real_fit(data, k, *args, **kw))
            return box[-1]

        run = call
        if k == SWEEP_KS[-1]:
            def run():
                captured.update(capture_k1_operands(call, (0, WARM_CALL)))
                return box[-1]

        res, calls = recording_schedules(run, k_active=k)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = read_launches()
        launches = {key: after[key] - before[key] for key in after}
        check_k1_only("AA sweep k=%d" % k, launches, calls)
        audit = audit_cost_f64(res, X_host)
        rel = abs(audit / res['cost'] - 1.0)
        print("  k=%2d (padded to %2d): %.3f s, %d K1 launches, n_iters "
              "mean %.2f max %d, cost %.4f, float64 audit %.4f (rel diff "
              "%.2e)" % (k, kw['pad_components_to'], wall, launches["K1"],
                         float(np.mean(res['n_iters'])),
                         int(np.max(res['n_iters'])), res['cost'], audit,
                         rel), flush=True)
        check(rel <= 1e-4, "AA sweep k=%d: audit %.4f vs device cost %.4f"
              % (k, audit, res['cost']))
        check(res['weights'].shape[1] == k, "AA sweep k=%d: %d columns"
              % (k, res['weights'].shape[1]))
        per_k[k] = launches
        return res

    sweep.aa_fit_restarts = fit
    reset_launches()
    t0 = time.perf_counter()
    try:
        results = sweep.aa_model_selection_sweep(
            X, SWEEP_KS, 0, component_bucket=SWEEP_BUCKET, **SWEEP_FIT)
    finally:
        sweep.aa_fit_restarts = real_fit
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = read_launches()
    check(launches["K1"] == sum(v["K1"] for v in per_k.values()),
          "AA sweep: launches %s" % launches)
    costs = [results[k]['cost'] for k in SWEEP_KS]
    print("  AA sweep k=%s, best of 50 each, bucket 8: %.3f s in all, %d K1 "
          "launches, costs %s, rmse %s, on %s"
          % (list(SWEEP_KS), total, launches["K1"],
             np.round(costs, 4).tolist(),
             [round(results[k]['rmse'], 5) for k in SWEEP_KS], card))
    check(all(b <= a for a, b in zip(costs, costs[1:])),
          "AA sweep: costs rise with k: %s" % costs)

    # K1 at a padded sweep shape: k = 20's first launch (random weights)
    # and the first of its second round (warm: 5 chunks of 32 launches
    # make the first round), 10 restarts of 900 rows at k_pad 24,
    # masked.  In float64 the kernel is held to its plain version row by
    # row.  In float32 both lose rows: from a near-optimal start the first
    # step projects x - 1e3 g with |g| ~ 1e3, and float32 cancels those
    # 1e6s down to [0, 1] with errors of ~0.1 in the direction, so the
    # line search may leave x0 for a point up to 3% worse; which rows it
    # hits depends on rounding.  So float32 is held in total: the
    # kernel's summed objective within 1e-4 of the float64 solve's.
    times = {}
    for call, (As, Bs, X0s, kw) in sorted(captured.items()):
        projection = kw.pop("projection")
        mask = kw.pop("mask")
        R, n, k_pad = Bs.shape
        check(mask is not None and int(mask.sum()) == SWEEP_KS[-1]
              and k_pad == 24, "k=20 operands: mask %s, shape %s"
              % (mask, tuple(Bs.shape)))
        name = "K1 sweep (%d, %d, %d) masked, launch %d" % (R, n, k_pad, call)
        qp = dict(projection=projection, mask=mask, **kw)
        compare_qp(name + " f64", As.double(), Bs.double(), X0s.double(),
                   tol_obj=1e-8, **qp)
        f = {label: qp_objective(fn(*args, **qp), As, Bs)
             for label, fn, args in (
                 ("kernel", sq.quad_simplex_qp_packed_grouped,
                  (As, Bs, X0s)),
                 ("plain", sq.quad_simplex_qp_packed_grouped_reference,
                  (As, Bs, X0s)),
                 ("f64", sq.quad_simplex_qp_packed_grouped_reference,
                  (As.double(), Bs.double(), X0s.double())))}
        gap = np.abs(f["kernel"] - f["plain"]) / (1.0 + np.abs(f["plain"]))
        total = {key: float(np.sum(v)) for key, v in f.items()}
        rel = {key: total[key] / total["f64"] - 1.0
               for key in ("kernel", "plain")}
        print("  %s f32: rows apart by > 1e-5 %d of %d (most %.3e); summed "
              "objective against the float64 solve: kernel %.2e, plain "
              "%.2e" % (name, int(np.sum(gap > 1e-5)), gap.size,
                        float(gap.max()), rel["kernel"], rel["plain"]))
        check(abs(rel["kernel"]) <= 1e-4, "%s f32: summed objective %.2e "
              "from the float64 solve's" % (name, rel["kernel"]))
        times[call] = kernel_times(
            "K1 sweep k=20 launch %d" % call,
            sq.quad_simplex_qp_packed_grouped,
            sq.quad_simplex_qp_packed_grouped_reference, (As, Bs, X0s),
            projection, sq.team_width(k_pad), sq.PACKED_THREADS, lone=True,
            mask=mask, **kw)
        times[call]["max_abs_err_f64"] = float(
            (sq.quad_simplex_qp_packed_grouped(As.double(), Bs.double(),
                                               X0s.double(), **qp)
             - sq.quad_simplex_qp_packed_grouped_reference(
                 As.double(), Bs.double(), X0s.double(), **qp))
            .abs().max())
    paths = {"AA sweep k=%d, best of 50, bucket 8" % k: per_k[k]
             for k in SWEEP_KS}
    return paths, dict(R=R, n=n, k=k_pad, k_active=SWEEP_KS[-1],
                       team_width=sq.team_width(k_pad), launch=WARM_CALL,
                       **times[WARM_CALL]), total


def phase_gpnh_screened_padded(pcs, pcs_host, card):
    """Config 4 on phase 10's PCs: the best of 100 screened (50
    iterations), then padded to 8, both audited against the JAX package's
    best of 100; then a short GPNH sweep k = 2..6, bucketed by 4."""
    import torch
    from convex_dim_red_tpu_torch import gpnh_fit_restarts
    from convex_dim_red_tpu_torch.parallel import restarts, sharded_aa
    from convex_dim_red_tpu_torch.parallel.sweep import (
        gpnh_model_selection_sweep)
    ref = GPNH_REFERENCE[100][0]
    paths = {}
    real_solve = sharded_aa._solve_gpnh_dictionary
    before_mask = []

    def recording_solve(*args, **kwargs):
        W = real_solve(*args, **kwargs)
        if W.shape[-1] > GPNH_K:
            before_mask.append(W[..., GPNH_K:].abs().amax())
        return W

    for label, extra in (("screened (50 iterations)",
                          dict(screen_iterations=50)),
                         ("padded to 8", dict(pad_components_to=8))):
        def run():
            return gpnh_fit_restarts(pcs, GPNH_K, 0, 100, **extra,
                                     **GPNH_FIT)

        k_active = GPNH_K if 'pad_components_to' in extra else None
        reset_launches()
        sharded_aa._solve_gpnh_dictionary = recording_solve
        t0 = time.perf_counter()
        try:
            res, calls = recording_schedules(run, k_active=k_active)
        finally:
            sharded_aa._solve_gpnh_dictionary = real_solve
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        used = check_k1_only("GPNH " + label, launches, calls)
        check_simplex_rows("GPNH %s weights" % label, res['weights'])
        audit = gpnh_audit(res, pcs_host)
        rel = abs(audit / ref - 1.0)
        note = ""
        if k_active is not None:
            largest = float(torch_max(before_mask))
            check(np.isfinite(largest), "padded GPNH: the dictionary solve "
                  "gave non-finite padded columns")
            note = (", padded dictionary columns before the mask at most "
                    "%.3e over %d solves (0 after it)"
                    % (largest, len(before_mask)))
        print("  GPNH best of 100, %s: wall %.3f s (first call), %d K1 "
              "launches, n_iters mean %.2f, %s device cost %.4f, float64 "
              "audit %.4f (rel diff %.2e from %.4f, limit 1e-3)%s, on %s"
              % (label, wall, used, float(np.mean(res['n_iters'])),
                 ("screen %s," % json.dumps(res['screen'])
                  if 'screen' in res else ""), res['cost'], audit, rel, ref,
                 note, card))
        check(rel <= 1e-3, "GPNH %s: audited cost %.4f is %.2e from %.4f"
              % (label, audit, rel, ref))
        paths["GPNH best of 100, %s" % label] = launches

    # A short sweep over the PCs with config 4's settings.
    real_fit = restarts.gpnh_fit_restarts
    kept = {}

    def keeping(*args, **kwargs):
        res, calls = recording_schedules(lambda: real_fit(*args, **kwargs),
                                         k_active=args[1])
        kept[args[1]] = (res, calls)
        return res

    from convex_dim_red_tpu_torch.parallel import sweep as sweep_module
    sweep_module.gpnh_fit_restarts = keeping
    reset_launches()
    t0 = time.perf_counter()
    try:
        results = gpnh_model_selection_sweep(
            pcs, range(2, 7), 0, n_init=16, component_bucket=4, **GPNH_FIT)
    finally:
        sweep_module.gpnh_fit_restarts = real_fit
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    check(launches["K1"] == sum(scheduled_launches(c)
                                for _, c in kept.values())
          and launches["K2"] == launches["K3"] == launches["K4"] == 0,
          "GPNH sweep: launches %s" % launches)
    rows = []
    for k in range(2, 7):
        res, _ = kept[k]
        audit = gpnh_audit(res, pcs_host)
        rel = abs(audit / results[k]['cost'] - 1.0)
        rows.append("k=%d %.4f (audit rel %.1e, %.2f s)"
                    % (k, results[k]['cost'], rel, results[k]['elapsed']))
        check(rel <= 1e-4, "GPNH sweep k=%d: audit %.4f vs device cost %.4f"
              % (k, audit, results[k]['cost']))
        check(res['dictionary'].shape[1] == k, "GPNH sweep k=%d: columns" % k)
    print("  GPNH sweep k=2..6 on the PCs, best of 16, bucket 4: %.3f s, %d "
          "K1 launches; %s; on %s" % (wall, launches["K1"], "; ".join(rows),
                                       card))
    paths["GPNH sweep k=2..6, best of 16, bucket 4"] = launches
    return paths


#: Config 2 (benchmarks/run_all.py:70-98): k-means on phase 7's data and
#: the JAX package's results on it (benchmarks/results.json, config2:
#: inertia, and the gap of 20 and of 100 trials), with the limits the
#: port is held to (its generator draws other seeds and references).
CONFIG2_K, CONFIG2_INERTIA, CONFIG2_GAP = 4, 23561932.0, 1.5533
CONFIG2_INERTIA_RTOL, CONFIG2_GAP_ATOL = 1e-2, 0.01
#: The HadISST case study (phase 21): bin/make_synthetic_hadisst.py's
#: defaults, the wrappers' base period, k and the PCs of the GPNH run.
HADISST_SYNTHETIC = dict(start_year=1870, n_years=149, n_lat=180,
                         n_lon=360, land_frac=0.3, seed=0)
BASE_PERIOD = (1981, 2010)
CASE_STUDY_K, CASE_STUDY_PCS = 4, 20
#: The jra55_pca_gpnh driver's settings and its wrapper's, which phase 21
#: runs on the HadISST PCs and phase 25 on the JRA-55 PCs.
CASE_STUDY_GPNH = dict(lambda_W=1e-3, init='random', n_init=100,
                       tolerance=1e-6, max_iterations=10000, random_seed=0,
                       weights_solver_kwargs={'max_iterations': 1},
                       stopping_criterion='rel_delta_f')
#: Phase 21's float32 hold of K1/K2 on the analyses' operands: the share
#: of rows that may be apart from the plain version by more than 1e-5 in
#: objective (rounding decides a warm row's first step, phase 17), and
#: the summed objective's limit against the float64 solve (phase 17's;
#: a float32 solve, the plain version's too, stops short of float64's).
PATH_F32_ROWS, PATH_F32_SUM = 0.01, 1e-4


def count_syncs(run):
    """``run()`` under ``torch.cuda.set_sync_debug_mode('warn')``:
    ``(result, number of synchronising calls)``."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            result = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return result, sum("synchroniz" in str(w.message) for w in seen)


def phase_config2(X_host, card):
    """Config 2: the best-of-10 k-means fit, then the gap statistic with
    20 and with 100 uniform trials, warm-up (counting the synchronising
    calls) and timed; then Lloyd in float64 on the card against the
    CPU."""
    import torch
    from convex_dim_red_tpu_torch import KMeans, gap_statistic
    from convex_dim_red_tpu_torch.models import kmeans
    X = torch.as_tensor(X_host, device=DEVICE)
    iterations = []
    real_lloyd = kmeans._lloyd

    def recording_lloyd(*args):
        out = real_lloyd(*args)
        iterations.append(int(out[3].max()))
        return out

    def run():
        walls = {}
        t0 = time.perf_counter()
        model = KMeans(CONFIG2_K, n_init=10, random_state=0).fit(X)
        torch.cuda.synchronize()
        walls["fit"] = time.perf_counter() - t0
        gaps = {}
        for trials in (20, 100):
            t0 = time.perf_counter()
            gaps[trials] = gap_statistic(X, model.inertia_, CONFIG2_K,
                                         n_trials=trials, random_state=0)
            torch.cuda.synchronize()
            walls["gap %d" % trials] = time.perf_counter() - t0
        return model, gaps, walls

    kmeans._lloyd = recording_lloyd
    try:
        (_, _, first), syncs = count_syncs(run)
        lloyd_calls = list(iterations)
        reset_launches()
        model, gaps, walls = run()
    finally:
        kmeans._lloyd = real_lloyd
    launches = read_launches()
    check(sum(launches.values()) == 0, "k-means launched %s" % launches)
    print("  config 2, KMeans(4, n_init=10) on %dx%d: fit %.3f s timed "
          "(%.3f s first run), inertia %.1f (JAX %.1f, rel diff %.2e), the "
          "winner's Lloyd iterations %d, on %s"
          % (N_SAMPLES, N_FEATURES, walls["fit"], first["fit"],
             model.inertia_, CONFIG2_INERTIA,
             model.inertia_ / CONFIG2_INERTIA - 1.0, model.n_iter_, card))
    for trials, (gap, sk) in sorted(gaps.items()):
        print("  gap statistic, %d uniform trials: %.3f s timed (%.3f s "
              "first run), gap %.5f, sk %.3e (JAX %.4f)"
              % (trials, walls["gap %d" % trials],
                 first["gap %d" % trials], gap, sk, CONFIG2_GAP))
        check(abs(gap - CONFIG2_GAP) <= CONFIG2_GAP_ATOL and sk >= 0.0,
              "config 2: gap of %d trials %.5f" % (trials, gap))
    print("  first run: %d synchronising calls (torch.cuda sync debug "
          "mode); %d Lloyd runs (the fit and 120 trials in batches), most "
          "iterations per run %s" % (syncs, len(lloyd_calls), lloyd_calls))
    check(abs(model.inertia_ / CONFIG2_INERTIA - 1.0) <= CONFIG2_INERTIA_RTOL,
          "config 2: inertia %.1f" % model.inertia_)
    RESULTS["config 2"] = {"inertia": model.inertia_, "gap 20": gaps[20]}

    # Lloyd in float64 from the same centroids, card against CPU.
    rng = np.random.RandomState(0)
    Xs = rng.standard_normal((600, 512))
    C0 = Xs[rng.choice(600, CONFIG2_K, replace=False)]
    tol = 1e-4 * float(np.var(Xs, axis=0).mean())
    out = {dev: [t.cpu() for t in real_lloyd(
        torch.as_tensor(Xs, device=dev), torch.as_tensor(C0, device=dev),
        300, tol)] for dev in ("cuda", "cpu")}
    (C_d, lab_d, in_d, it_d), (C_c, lab_c, in_c, it_c) = out["cuda"], \
        out["cpu"]
    dc = float((C_d - C_c).abs().max())
    print("  _lloyd float64 (600, 512, 4), card vs CPU: labels equal %s, "
          "n_iter %d / %d, max|dC| %.2e, inertia rel diff %.2e"
          % (bool(torch.equal(lab_d, lab_c)), int(it_d), int(it_c), dc,
             float(in_d / in_c - 1.0)))
    check(torch.equal(lab_d, lab_c) and int(it_d) == int(it_c)
          and dc <= 1e-10, "Lloyd float64: card and CPU differ")
    return {"config 2 k-means fit + gaps": launches}


def phase_kmeans_sweep(X_host, card):
    """``kmeans_model_selection_sweep`` on config 2's data, k = 2..6."""
    import torch
    from convex_dim_red_tpu_torch.parallel import (
        kmeans_model_selection_sweep)
    X = torch.as_tensor(X_host, device=DEVICE)
    reset_launches()
    t0 = time.perf_counter()
    res = kmeans_model_selection_sweep(X, range(2, 7), 0, n_init=10,
                                       n_trials=20)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    rows = ["k=%d %.3f s inertia %.1f gap %.5f sk %.2e n_iter %d"
            % (k, r['elapsed'], r['cost'], r['gap'], r['gap_sk'],
               r['n_iter']) for k, r in sorted(res.items())]
    print("  k-means sweep k=2..6, best of 10, 20 trials: %.3f s in all; "
          "%s; on %s" % (wall, "; ".join(rows), card))
    costs = [res[k]['cost'] for k in range(2, 7)]
    check(all(b < a for a, b in zip(costs, costs[1:])),
          "k-means sweep: inertia does not fall with k: %s" % costs)
    check(all(np.isfinite([res[k]['gap'], res[k]['gap_sk']]).all()
              for k in res), "k-means sweep: non-finite gap")
    check(sum(launches.values()) == 0, "k-means sweep launched %s"
          % launches)
    return {"k-means sweep k=2..6": launches}


def hadisst_case_study_data():
    """The synthetic HadISST field through the port's pipelines, as the
    anomalies CLI and the hadisst drivers take it: anomalies (base
    period 1981-2010, trend order 1), the HADISST spec's year and
    latitude filters, scos weights, flatten, missing mask, 0.1
    chronological split; the samples in float64, as the anomalies CLI
    writes them and a driver reads them."""
    from convex_dim_red_tpu_torch.cli.specs import HADISST
    from convex_dim_red_tpu_torch.pipelines import preprocess as pp
    from convex_dim_red_tpu_torch.pipelines.dataset import (
        Dataset, Variable, decode_cf_time)
    from convex_dim_red_tpu_torch.pipelines.synthetic import (
        synthetic_hadisst)
    t0 = time.perf_counter()
    raw = synthetic_hadisst(**HADISST_SYNTHETIC)
    sst, coords = raw['sst'].data, raw.coords
    years, _ = decode_cf_time(coords['time'])
    data = np.asarray(sst, dtype=float)
    data = np.where(data <= -1000.0, np.nan, data)  # the CLI's ice flag
    generated = time.perf_counter() - t0
    anomalies = pp.calculate_monthly_anomalies(
        data, years, period=12, trend_order=1,
        base_period_start_year=BASE_PERIOD[0],
        base_period_end_year=BASE_PERIOD[1])[0]
    ds = Dataset({HADISST.var_name: Variable(
        ('time', 'latitude', 'longitude'), anomalies)}, coords)
    ds = ds.sel_time_years(HADISST.time_name, HADISST.start_year,
                           HADISST.end_year)
    ds = ds.sel_range(HADISST.lat_name, HADISST.min_latitude,
                      HADISST.max_latitude)
    weights = pp.latitude_weights(ds.coords[HADISST.lat_name].data,
                                  HADISST.default_lat_weights)
    flat = pp.weight_and_flatten(ds[HADISST.var_name].data,
                                 weights[:, None])
    missing = pp.missing_feature_mask(flat)
    valid = flat[:, ~missing]
    train, val, n_train = pp.train_validation_split(
        valid, validation_frac=HADISST.validation_frac)
    grid = list(ds[HADISST.var_name].data.shape[1:])
    print("  synthetic HadISST %s: generated in %.1f s, anomalies and "
          "preparation %.1f s on the host; band %s, %d sea points of %d, "
          "%d training and %d held-out months"
          % (sst.shape, generated, time.perf_counter() - t0 - generated,
             grid, valid.shape[1], missing.size, n_train, val.shape[0]))
    return dict(train=train, val=val, missing=missing, grid=grid,
                time=ds.coords[HADISST.time_name],
                time_name=HADISST.time_name,
                dims=(HADISST.lat_name, HADISST.lon_name),
                coords={name: ds.coords[name] for name in
                        (HADISST.lat_name, HADISST.lon_name)})


def check_analysis(name, attrs, out, pattern_name, missing, audit, cost,
                   test_size):
    """The attrs finite (the held-out ones NaN when no sample is held
    out, as the drivers write them), ``test_size`` held-out samples, the
    training cost's float64 audit within 1e-4, the patterns NaN exactly
    on the mask."""
    for key, value in attrs.items():
        try:
            number = float(value)
        except ValueError:
            continue  # init, reference
        if test_size == 0 and key.startswith('test_set_') \
                and key != 'test_set_size':
            check(np.isnan(number), "%s: attr %s is %s with no held-out "
                  "samples" % (name, key, value))
            continue
        check(np.isfinite(number), "%s: attr %s is %s" % (name, key, value))
    check(attrs['test_set_size'] == str(test_size), "%s: test_set_size %s"
          % (name, attrs['test_set_size']))
    rel = abs(audit / cost - 1.0)
    check(rel <= 1e-4, "%s: float64 audit %.6f vs cost %.6f" % (name, audit,
                                                                 cost))
    patterns = out[pattern_name].data
    nan = np.isnan(patterns.reshape(patterns.shape[0], -1))
    check(bool((nan == missing[None, :]).all()),
          "%s: patterns NaN off the land mask" % name)
    return rel


def analysis_output(d, weights, patterns, attrs, name, n_components,
                    cost_deltas=None, dictionary=None, n_modes=None):
    """``build_output_dataset`` as a driver calls it on the case study's
    data ``d``: over its grid, or with ``n_modes`` over the PCs' modes."""
    from convex_dim_red_tpu_torch.cli import common
    grid = n_modes is None
    return common.build_output_dataset(
        weights=weights, dictionary_over_samples=dictionary,
        patterns=patterns, cost_deltas=cost_deltas,
        time_values=d['time'].data, time_name=d['time_name'],
        time_attrs=d['time'].attrs,
        feature_dims=list(d['dims']) if grid else ['mode'],
        feature_shape=list(d['grid']) if grid else [n_modes],
        feature_coords=d['coords'] if grid else {},
        missing_mask=d['missing'] if grid else np.zeros(n_modes, bool),
        n_components=n_components, attrs=attrs, pattern_name=name)


def run_path(paths, label, call):
    """``call()`` with the launch counts set to 0 just before it and the
    restart scheduler recorded: ``(result, wall, launches, the K1
    launches its schedule implies)``; the launches go into ``paths``
    under ``label``."""
    import torch
    reset_launches()
    t0 = time.perf_counter()
    result, calls = recording_schedules(call)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    paths[label] = launches
    return result, wall, launches, scheduled_launches(calls)


def hold_recorded(held, name, kernel, plain, captured, wrapper, calls):
    """``hold_path_qp`` on each of the recorded launches ``calls`` of
    ``wrapper``, into ``held``."""
    check(sorted(captured[wrapper]) == list(calls),
          "%s: launches %s recorded, not %s"
          % (name, sorted(captured[wrapper]), list(calls)))
    for call, operands in sorted(captured[wrapper].items()):
        held["%s, launch %d" % (name, call)] = hold_path_qp(
            "%s launch %d" % (name, call), kernel, plain, operands)


def kmeans_audit(X64, model):
    """The k-means winner's inertia re-costed on the host in float64."""
    centres = model.cluster_centers_.double().cpu().numpy()
    return float(np.sum((X64 - centres[model.labels_]) ** 2))


def hold_path_qp(name, kernel, plain, operands):
    """``kernel`` against ``plain`` on the operands a path gave it, on the
    card: in float64 row by row (objective gap 1e-8, as phase 17), and in
    float32 row by row, where at most ``PATH_F32_ROWS`` of the rows may
    be apart by more than 1e-5 in objective and the summed objective must
    be within ``PATH_F32_SUM`` of the float64 solve's.  Returns the shape
    and both max|dx|."""
    import torch
    A, B, X0, kw = operands
    kw = dict(kw)
    qp = dict(projection=kw.pop("projection"), mask=kw.pop("mask"), **kw)
    shape = (1,) * (3 - B.ndim) + tuple(B.shape)
    label = "%s (%d, %d, %d)" % ((name,) + shape)
    err64 = compare_qp(label + " f64", A.double(), B.double(), X0.double(),
                       tol_obj=1e-8, kernel=kernel, plain=plain, **qp)
    got = kernel(A, B, X0, **qp)
    want = plain(A, B, X0, **qp)
    solved = plain(A.double(), B.double(), X0.double(), **qp)
    As, Bs = (t if t.ndim == 3 else t[None] for t in (A, B))
    f = {key: qp_objective(x if x.ndim == 3 else x[None], As, Bs)
         for key, x in (("kernel", got), ("plain", want), ("f64", solved))}
    gap = np.abs(f["kernel"] - f["plain"]) / (1.0 + np.abs(f["plain"]))
    apart = int(np.sum(gap > 1e-5))
    total = {key: float(np.sum(v)) for key, v in f.items()}
    rel = {key: total[key] / total["f64"] - 1.0 for key in ("kernel", "plain")}
    dx = float((got - want).abs().max())
    feas = float((got.double().sum(dim=-1) - 1.0).abs().max())
    print("  %s f32: max|dx| %.3e, |sum-1| %.3e, rows apart by > 1e-5 %d of "
          "%d (most %.3e); summed objective against the float64 solve: "
          "kernel %.2e, plain %.2e"
          % (label, dx, feas, apart, gap.size, float(gap.max()),
             rel["kernel"], rel["plain"]))
    check(bool(torch.isfinite(got).all()) and float(got.min()) >= 0.0
          and feas <= 1e-5, label + " f32: rows off the simplex")
    check(apart <= PATH_F32_ROWS * gap.size, "%s f32: %d rows of %d apart "
          "from the plain version" % (label, apart, gap.size))
    check(abs(rel["kernel"]) <= PATH_F32_SUM, "%s f32: summed objective "
          "%.2e from the float64 solve's" % (label, rel["kernel"]))
    return dict(R=shape[0], n=shape[1], k=shape[2], max_abs_err=dx,
                max_abs_err_f64=err64)


def phase_case_study(card):
    """kmeans_analysis, aa_analysis, pca_analysis and gpnh_analysis on
    the synthetic HadISST anomalies, as the drivers call them (float64
    host arrays, ``device='cuda'``), each then build_output_dataset; K1
    and K2 held to their plain versions on the operands the AA and GPNH
    analyses gave them."""
    import torch
    from convex_dim_red_tpu_torch.cli import common
    from convex_dim_red_tpu_torch.ops import simplex_qp as sq
    from convex_dim_red_tpu_torch.parallel.sharded_aa import _ROUND
    from convex_dim_red_tpu_torch.pipelines import preprocess as pp
    d = hadisst_case_study_data()
    train, val, missing = d['train'], d['val'], d['missing']
    # The analyses fit in float32 (torch's default dtype): the float64
    # audits take the data as the fit saw it.
    X64 = train.astype(np.float32).astype(np.float64)
    paths, held = {}, {}
    k1 = {K1_WRAPPER: (0, _ROUND)}
    k2_plain = _one_group(sq.quad_simplex_qp_packed_grouped_reference)

    # k-means at bin/run_hadisst_kmeans_wrapper.sh's settings.
    (model, onehot, attrs), wall, launches, _ = run_path(
        paths, "HadISST k-means analysis (k=4, best of 100, 100 trials)",
        lambda: common.kmeans_analysis(
            train, val, n_components=CASE_STUDY_K, n_init=100,
            max_iterations=10000, n_trials=100, reference='uniform',
            random_seed=0, init='k-means++', tolerance=1e-4, device=DEVICE))
    check(sum(launches.values()) == 0, "k-means analysis: %s" % launches)
    check(model.cluster_centers_.dtype == torch.float32,
          "k-means analysis fitted in %s" % model.cluster_centers_.dtype)
    out = analysis_output(d, onehot, model.cluster_centers_, attrs,
                          'centroids', CASE_STUDY_K)
    rel = check_analysis("k-means", attrs, out, 'centroids', missing,
                         kmeans_audit(X64, model), model.inertia_, len(val))
    print("  kmeans_analysis (k=4, n_init=100, 100 trials, max 10000 "
          "iterations): %.3f s, inertia %.1f (float64 audit rel diff "
          "%.1e), test inertia %s, gap %s, sk %s, n_iter %s, on %s"
          % (wall, model.inertia_, rel, attrs['test_set_inertia'].strip(),
             attrs['gap_statistic'].strip(), attrs['gap_sk'].strip(),
             attrs['n_iter'], card))

    # AA at the hadisst_aa driver's solver settings and its wrapper's.
    # Its iterations replay a CUDA graph after the first
    # (parallel/iterate_graph.py), so K1's wrapper sees launch 0 alone
    # (the eager iteration; the capture's operands hold no values yet):
    # launch 0 is the one recorded.
    label = "HadISST AA analysis (k=4, best of 100)"
    k1_aa = {K1_WRAPPER: (0,)}
    ((best, attrs), captured), wall, launches, k1_used = run_path(
        paths, label, lambda: capture_operands(lambda: common.aa_analysis(
            train, val, n_components=CASE_STUDY_K, delta=0.0,
            init='random', n_init=100, tolerance=1e-4, max_iterations=10000,
            random_seed=0, dictionary_solver_kwargs={'max_iterations': 1},
            stopping_criterion='abs_delta_f', device=DEVICE),
            dict(k1_aa, **{K2_WRAPPER: (0,)})))
    check(launches == dict(K1=k1_used, K2=1, K3=0, K4=0),
          "AA analysis: launches %s, expected %d of K1 and one K2"
          % (launches, k1_used))
    check(best['weights'].dtype == torch.float32,
          "AA analysis fitted in %s" % best['weights'].dtype)
    out = analysis_output(d, best['weights'], best['archetypes'], attrs,
                          'archetypes', CASE_STUDY_K,
                          cost_deltas=best['cost_deltas'],
                          dictionary=best['dictionary'])
    rel = check_analysis("AA", attrs, out, 'archetypes', missing,
                         audit_cost_f64(best, X64), best['cost'], len(val))
    print("  aa_analysis (k=4, n_init=100, tolerance 1e-4 abs_delta_f, "
          "dictionary capped at 1, max_iterations 10000): %.3f s, %d K1 + "
          "%d K2 launches, n_iter %d, n_iters mean %.1f max %d (%d restarts "
          "at the cap), cost %.4f (float64 audit rel diff %.1e), test cost "
          "%s, on %s"
          % (wall, launches["K1"], launches["K2"], best['n_iter'],
             float(np.mean(best['n_iters'])), int(np.max(best['n_iters'])),
             int(np.sum(best['n_iters'] >= 10000)), best['cost'], rel,
             attrs['test_set_cost'].strip(), card))
    hold_recorded(held, "K1 HadISST AA", sq.quad_simplex_qp_packed_grouped,
                  sq.quad_simplex_qp_packed_grouped_reference, captured,
                  K1_WRAPPER, k1_aa[K1_WRAPPER])
    hold_recorded(held, "K2 HadISST AA transform", sq.quad_simplex_qp_packed,
                  k2_plain, captured, K2_WRAPPER, (0,))

    # PCA with 20 components, then GPNH on its PCs.
    (result, attrs), wall, launches, _ = run_path(
        paths, "HadISST PCA(20) analysis", lambda: common.pca_analysis(
            train, val, n_components=CASE_STUDY_PCS, tolerance=1e-8,
            device=DEVICE))
    check(sum(launches.values()) == 0, "PCA analysis: %s" % launches)
    pcs, eofs = result['pcs'], result['eofs']
    resid = X64 - pcs[:len(train)] @ eofs.astype(np.float64)
    out = analysis_output(d, pcs[:len(train)], eofs, attrs, 'EOFs',
                          CASE_STUDY_PCS)
    rel = check_analysis("PCA", attrs, out, 'EOFs', missing,
                         0.5 * float(np.sum(resid ** 2)) / len(train),
                         float(attrs['training_set_cost']), len(val))
    print("  pca_analysis (20 components): %.3f s, explained variance ratio "
          "%.4f, training cost %s (float64 audit rel diff %.1e), test cost "
          "%s, on %s" % (wall, float(np.sum(result['explained_variance_'
                                                   'ratio'])),
                         attrs['training_set_cost'].strip(), rel,
                         attrs['test_set_cost'].strip(), card))

    # The PCs as the PCA driver writes them (float64, every month).
    pc_train, pc_val, _ = pp.train_validation_split(pcs, validation_frac=0.1)
    (model, attrs, won, captured), wall, launches, k1_used = run_path(
        paths, "PCs GPNH analysis (k=4, best of 100)",
        lambda: gpnh_analysis_recorded(
            pc_train, pc_val, dict(CASE_STUDY_GPNH, n_components=CASE_STUDY_K),
            k1))
    check(launches == dict(K1=k1_used, K2=0, K3=0, K4=0),
          "GPNH analysis: launches %s, expected %d of K1"
          % (launches, k1_used))
    out = analysis_output(d, won['weights'], won['dictionary'].T, attrs,
                          'dictionary', CASE_STUDY_K,
                          cost_deltas=won['cost_deltas'],
                          n_modes=CASE_STUDY_PCS)
    rel = check_analysis("GPNH", attrs, out, 'dictionary',
                         np.zeros(CASE_STUDY_PCS, bool),
                         gpnh_audit(won, pc_train.astype(np.float32)),
                         won['cost'], len(pc_val))
    print("  gpnh_analysis on the PCs (k=4, lambda_W 1e-3, n_init=100, "
          "rel_delta_f 1e-6, weights QP capped at 1): %.3f s, %d K1 "
          "launches, n_iter %d, n_iters mean %.1f max %d, cost %.6f (float64 "
          "audit rel diff %.1e), test cost %s, on %s"
          % (wall, launches["K1"], won['n_iter'],
             float(np.mean(won['n_iters'])), int(np.max(won['n_iters'])),
             won['cost'], rel, attrs['test_set_cost'].strip(), card))
    hold_recorded(held, "K1 PCs GPNH", sq.quad_simplex_qp_packed_grouped,
                  sq.quad_simplex_qp_packed_grouped_reference, captured,
                  K1_WRAPPER, k1[K1_WRAPPER])
    return paths, held


def gpnh_analysis_recorded(train, val, settings, calls):
    """``gpnh_analysis`` as a driver calls it, on the card, with the
    winning ``gpnh_fit_restarts`` result kept and the QP kernels'
    operands of ``calls`` recorded (``capture_operands``): ``(model,
    attrs, the winner's fit result, the recorded operands)``."""
    from convex_dim_red_tpu_torch.cli import common
    fits = []
    real_fit = common.gpnh_fit_restarts

    def keeping(*args, **kwargs):
        fits.append(real_fit(*args, **kwargs))
        return fits[-1]

    common.gpnh_fit_restarts = keeping
    try:
        (model, attrs), captured = capture_operands(
            lambda: common.gpnh_analysis(train, val, device=DEVICE,
                                         **settings), calls)
    finally:
        common.gpnh_fit_restarts = real_fit
    return model, attrs, fits[-1], captured


# ---------------------------------------------------------------------------
# Phases 22-24: the multi-device layer on the card
# ---------------------------------------------------------------------------

#: The mesh phases run in worlds of processes (parallel/mesh.py:spawn):
#: two processes share the one card on gloo (NCCL takes one process a
#: device), and a world of one runs NCCL, the production route.  Each
#: world has this time limit (seconds).
MESH_WORLD, MESH_TIMEOUT = 2, 900.0
MESH_BACKENDS = {"shared card": "gloo", "production": "nccl"}
#: Results of the single-device phases that the mesh phases are held to.
RESULTS = {}


def _host(value):
    """Tensors (in a dict, tuple or list) as numpy arrays."""
    import torch
    if isinstance(value, dict):
        return {k: _host(v) for k, v in value.items()}
    if isinstance(value, (tuple, list)):
        return type(value)(_host(v) for v in value)
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return value


def _timed(run):
    """``run()`` once to warm up, then once timed with the launch counts
    set to 0 just before: ``(result, wall seconds, launches)``."""
    import torch
    run()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read_launches()


def mesh_aa_restarts():
    """Phase 7's best of 100 over a restart mesh (2 x 1): each rank runs
    its 50 restarts under compaction."""
    import torch
    from convex_dim_red_tpu_torch import aa_fit_restarts
    from convex_dim_red_tpu_torch.parallel.mesh import create_mesh
    X = torch.as_tensor(make_data(), device=DEVICE)
    mesh = create_mesh((MESH_WORLD, 1), device_type=DEVICE)
    res, wall, launches = _timed(
        lambda: aa_fit_restarts(X, K, 0, N_INIT, mesh=mesh, **fit_kwargs()))
    return dict(wall=wall, launches=launches, **_host({
        name: res[name] for name in ('weights', 'dictionary', 'cost',
                                     'costs', 'n_iters', 'best_index')}))


def mesh_aa_estimator():
    """``ArchetypalAnalysis(6)`` over a sample mesh (1 x 2), phase 8's
    'pallas' settings: K1 at R = 1 on the rank's 894 rows; then the
    transform, K2 on the same rows.  The operands of each kernel's first
    launch are kept."""
    import torch
    from convex_dim_red_tpu_torch import ArchetypalAnalysis
    from convex_dim_red_tpu_torch.parallel.mesh import create_mesh
    X = torch.as_tensor(make_data(), device=DEVICE)
    mesh = create_mesh((1, MESH_WORLD), device_type=DEVICE)
    model = ArchetypalAnalysis(
        K, init='furthest_sum', random_state=0, tolerance=TOL,
        stopping_criterion='rel_delta_f', max_iterations=MAX_ITER,
        dictionary_solver_kwargs={'max_iterations': DICT_MAX_ITERATIONS},
        weights_solver_kwargs={'max_iterations': WEIGHTS_MAX_ITERATIONS,
                               'backend': 'pallas'}, mesh=mesh)
    reset_launches()
    t0 = time.perf_counter()
    _, captured = capture_operands(lambda: model.fit(X), {K1_WRAPPER: (0,)})
    torch.cuda.synchronize()
    fit_wall = time.perf_counter() - t0
    fit_launches = read_launches()
    reset_launches()
    t0 = time.perf_counter()
    (W, cost), k2 = capture_operands(lambda: model.transform(X),
                                     {K2_WRAPPER: (0,)})
    torch.cuda.synchronize()
    transform_wall = time.perf_counter() - t0
    return dict(
        fit_wall=fit_wall, fit_launches=fit_launches, cost=model.cost,
        n_iter=model.n_iter, transform_wall=transform_wall,
        transform_launches=read_launches(), transform_cost=cost,
        **_host(dict(weights=model.weights, dictionary=model.dictionary,
                     transform_weights=W)),
        k1=_host(captured[K1_WRAPPER][0]), k2=_host(k2[K2_WRAPPER][0]))


def mesh_gpnh_restarts(pcs_host):
    """Config 4's GPNH best of 100 over a restart mesh (2 x 1)."""
    import torch
    from convex_dim_red_tpu_torch import gpnh_fit_restarts
    from convex_dim_red_tpu_torch.parallel.mesh import create_mesh
    pcs = torch.as_tensor(pcs_host, device=DEVICE)
    mesh = create_mesh((MESH_WORLD, 1), device_type=DEVICE)
    res, wall, launches = _timed(lambda: gpnh_fit_restarts(
        pcs, GPNH_K, 0, 100, mesh=mesh, **GPNH_FIT))
    return dict(wall=wall, launches=launches, **_host({
        name: res[name] for name in ('weights', 'dictionary', 'cost',
                                     'costs', 'n_iters', 'best_index')}))


def mesh_kmeans():
    """Config 2 over a (2 x 1) and a (1 x 2) mesh, and the gap statistic
    of 20 trials over the restart axis."""
    import torch
    from convex_dim_red_tpu_torch import KMeans
    from convex_dim_red_tpu_torch.parallel import sharded_gap_statistic
    from convex_dim_red_tpu_torch.parallel.mesh import create_mesh
    X = torch.as_tensor(make_data(), device=DEVICE)
    out = {}
    for shape in ((MESH_WORLD, 1), (1, MESH_WORLD)):
        mesh = create_mesh(shape, device_type=DEVICE)
        model, wall, launches = _timed(lambda: KMeans(
            CONFIG2_K, n_init=10, random_state=0, mesh=mesh).fit(X))
        out["%dx%d" % shape] = dict(inertia=model.inertia_,
                                    n_iter=model.n_iter_, wall=wall,
                                    launches=launches)
        if shape[0] > 1:
            (gap, sk), gap_wall, _ = _timed(lambda: sharded_gap_statistic(
                mesh, X, model.inertia_, CONFIG2_K, n_trials=20,
                random_state=0))
            out["gap"] = dict(gap=gap, sk=sk, wall=gap_wall)
    return out


def mesh_pca():
    """``sharded_pca`` of config 4's data, the features split in two, in
    float32 (phase 10's dtype), and in float64 beside phase 10's Gram
    path (``pca_fit(use_gram=True)``) run on one device on the same
    data."""
    import torch
    from convex_dim_red_tpu_torch.models.pca import pca_fit
    from convex_dim_red_tpu_torch.parallel import sharded_pca
    from convex_dim_red_tpu_torch.parallel.mesh import create_mesh
    data = make_data(GPNH_SAMPLES, GPNH_FEATURES)
    X = torch.as_tensor(data, device=DEVICE)
    mesh = create_mesh((1, MESH_WORLD), device_type=DEVICE)
    res, wall, _ = _timed(lambda: sharded_pca(mesh, X,
                                              n_components=PCA_MODES))
    X64 = torch.as_tensor(data, dtype=torch.float64, device=DEVICE)
    res64 = sharded_pca(mesh, X64, n_components=PCA_MODES)
    _, single64, _, _ = pca_fit(X64, n_components=PCA_MODES, use_gram=True)
    return dict(wall=wall, **_host(dict(
        explained_variance=res['explained_variance'],
        explained_variance_f64=res64['explained_variance'],
        single_explained_variance_f64=single64,
        components_shape=np.array(res['components'].shape))))


def mesh_wide():
    """A sharded fit at k = 96 over a sample mesh (1 x 2), cut to 3
    iterations: K3 on each rank's 894 rows; its transform, K4."""
    import torch
    from convex_dim_red_tpu_torch import ArchetypalAnalysis
    from convex_dim_red_tpu_torch.parallel.mesh import create_mesh
    X = torch.as_tensor(make_data(), device=DEVICE)
    model = ArchetypalAnalysis(WIDE_K, init='furthest_sum', random_state=0,
                               max_iterations=3,
                               weights_solver_kwargs={'backend': 'pallas'},
                               mesh=create_mesh((1, MESH_WORLD),
                                                device_type=DEVICE))
    reset_launches()
    t0 = time.perf_counter()
    model.fit(X)
    W, cost = model.transform(X)
    torch.cuda.synchronize()
    return dict(wall=time.perf_counter() - t0, launches=read_launches(),
                cost=model.cost, n_iter=model.n_iter, transform_cost=cost,
                transform_rows=W.shape[0])


MESH_CASES = {"aa restarts": mesh_aa_restarts,
              "aa estimator": mesh_aa_estimator,
              "gpnh restarts": mesh_gpnh_restarts,
              "kmeans": mesh_kmeans, "pca": mesh_pca, "wide": mesh_wide}


def mesh_rank(cases):
    """One rank of a mesh world: each of ``cases`` (``(name, kwargs)``),
    in order; returns ``{name: result}`` (host values)."""
    from convex_dim_red_tpu_torch.utils.precision import (
        set_matmul_precision)
    set_matmul_precision('float32')
    return {name: MESH_CASES[name](**kwargs) for name, kwargs in cases}


def nccl_rank():
    """A world of one on NCCL: ``sharded_aa_fit`` over a (1 x 1) mesh and
    the single-device restart-grouped fit from the same four states, on
    phase 7's data, cut to 10 iterations (K1 at (4, 1788, 6))."""
    import torch
    from convex_dim_red_tpu_torch.parallel import sharded_aa_fit
    from convex_dim_red_tpu_torch.parallel.dryrun import (random_states,
                                                          single_aa_fit)
    from convex_dim_red_tpu_torch.parallel.mesh import create_mesh
    X = torch.as_tensor(make_data(), device=DEVICE)
    states = [torch.as_tensor(a, dtype=X.dtype, device=DEVICE)
              for a in random_states(0, 4, N_SAMPLES, K)[:3]]
    kw = dict(tolerance=TOL, max_iterations=10,
              dictionary_solver_kwargs={'max_iterations': 1})
    weights = {'backend': 'pallas', 'max_iterations': WEIGHTS_MAX_ITERATIONS}
    reset_launches()
    res = sharded_aa_fit(create_mesh((1, 1), device_type=DEVICE), X,
                         *states, weights_solver_kwargs=weights,
                         stopping_criterion='rel_delta_f', **kw)
    launches = read_launches()
    mesh_backend = torch.distributed.get_backend()
    costs, n_iters, single = single_aa_fit(
        X, *states, device=DEVICE, weights_solver_kwargs=weights,
        criterion='rel_delta_f', **kw)
    best = int(np.argmin(costs))
    return dict(backend=mesh_backend, launches=launches,
                costs=res['costs'], single_costs=costs,
                n_iters=res['n_iters'], single_n_iters=n_iters,
                weights_equal=bool(torch.equal(
                    torch.as_tensor(res['weights'], device=DEVICE),
                    single[0][best])))


def _factors(result):
    """A world's returned weights and dictionary as tensors, for the
    host audits."""
    import torch
    return {name: torch.as_tensor(result[name])
            for name in ('weights', 'dictionary')}


def phase_mesh(card, X_host):
    """Phase 22: a world of two processes sharing the card (gloo) runs
    the restart-sharded AA and GPNH fits, the sample-sharded estimator
    and its transform, k-means, the gap statistic, PCA and a k = 96
    sharded fit; each result is held to the single-device phases'."""
    import torch
    from convex_dim_red_tpu_torch.parallel.mesh import spawn
    torch.cuda.empty_cache()
    cases = [("aa restarts", {}), ("aa estimator", {}),
             ("gpnh restarts", dict(pcs_host=RESULTS["pcs"])),
             ("kmeans", {}), ("pca", {}), ("wide", {})]
    t0 = time.perf_counter()
    ranks = spawn(mesh_rank, MESH_WORLD, args=(cases,),
                  backend=MESH_BACKENDS["shared card"], device_type=DEVICE,
                  timeout=MESH_TIMEOUT)
    print("  a world of %d processes on the card (%s): %.1f s in all, "
          "start-up included" % (MESH_WORLD, MESH_BACKENDS["shared card"],
                                 time.perf_counter() - t0))
    paths = {}

    # The restart-sharded best of 100 against phase 7's.
    ref = RESULTS["main path"]
    got = [r["aa restarts"] for r in ranks]
    res = got[0]
    for r in got[1:]:
        check(np.array_equal(r["costs"], res["costs"]),
              "restart mesh: ranks return other costs")
    audit = audit_cost_f64(_factors(res), X_host)
    rel_costs = float(np.max(np.abs(res["costs"] / ref["costs"] - 1.0)))
    per_rank = [r["launches"]["K1"] for r in got]
    blocks = np.array_split(res["n_iters"], MESH_WORLD)
    expected = [compacted_launches(b, RESTART_CHUNK, COMPACT_ITERS, MAX_ITER)
                for b in blocks]
    print("  AA best of 100, restart mesh %dx1: wall %s s (timed run, by "
          "rank), K1 launches by rank %s (phase 7: %d in one process), "
          "winner %d (phase 7: %d), audited %.4f (phase 7 %.4f, reference "
          "%.2f), per-restart costs max rel diff from phase 7 %.2e, on %s"
          % (MESH_WORLD, [round(r["wall"], 3) for r in got], per_rank,
             ref["launches"], res["best_index"], ref["best_index"], audit,
             ref["audit"], REFERENCE_AUDITED_COST, rel_costs, card))
    check(per_rank == expected, "restart mesh: K1 launches %s, the "
          "schedule implies %s" % (per_rank, expected))
    check(res["best_index"] == ref["best_index"],
          "restart mesh: winner %d, phase 7's %d"
          % (res["best_index"], ref["best_index"]))
    check(rel_costs <= SCHEDULER_RTOL, "restart mesh: per-restart costs "
          "%.2e from phase 7's" % rel_costs)
    check(abs(audit / REFERENCE_AUDITED_COST - 1.0) <= AUDIT_RTOL
          and abs(audit / ref["audit"] - 1.0) <= SCHEDULER_RTOL,
          "restart mesh: audited cost %.4f" % audit)
    total = dict.fromkeys(read_launches(), 0)
    for r in got:
        add_launches(total, r["launches"])
    paths["AA best of 100, restart mesh 2x1"] = total

    # The sample-sharded estimator and its transform.
    est = [r["aa estimator"] for r in ranks]
    e = est[0]
    ref = RESULTS["estimator pallas"]
    rel = abs(e["cost"] / ref["cost"] - 1.0)
    audit = audit_cost_f64(_factors(e), X_host)
    print("  ArchetypalAnalysis(6), mesh 1x%d: fit %s s by rank, n_iter %d "
          "(phase 8's K2 fit %d), cost %.4f (phase 8 %.4f, rel diff %.2e; "
          "float64 audit %.4f), K1 launches by rank %s; transform %s s, K2 "
          "launches by rank %s on %d rows each, cost %.4f"
          % (MESH_WORLD, [round(r["fit_wall"], 3) for r in est], e["n_iter"],
             ref["n_iter"], e["cost"], ref["cost"], rel, audit,
             [r["fit_launches"]["K1"] for r in est],
             [round(r["transform_wall"], 4) for r in est],
             [r["transform_launches"]["K2"] for r in est],
             N_SAMPLES // MESH_WORLD, e["transform_cost"]))
    check(rel <= SCHEDULER_RTOL, "sharded estimator: cost %.4f vs %.4f"
          % (e["cost"], ref["cost"]))
    check(abs(audit / e["cost"] - 1.0) <= 1e-4,
          "sharded estimator: audit %.4f vs %.4f" % (audit, e["cost"]))
    for r in est:
        check(r["fit_launches"] == dict(K1=e["n_iter"], K2=0, K3=0, K4=0),
              "sharded estimator: launches %s" % r["fit_launches"])
        check(r["transform_launches"] == dict(K1=0, K2=1, K3=0, K4=0),
              "sharded transform: launches %s" % r["transform_launches"])
        check(r["k1"][1].shape == (1, N_SAMPLES // MESH_WORLD, K)
              and r["k2"][1].shape == (N_SAMPLES // MESH_WORLD, K),
              "sharded estimator: local operands %s, %s"
              % (r["k1"][1].shape, r["k2"][1].shape))
    W = e["transform_weights"]
    check(W.shape == (N_SAMPLES, K)
          and float(np.abs(W.astype(np.float64).sum(axis=1) - 1).max())
          <= 1e-4 and float(W.min()) >= 0.0,
          "sharded transform: weights off the simplex")
    check(e["transform_cost"] <= e["cost"] * (1 + 1e-4),
          "sharded transform cost %.4f above the fit's %.4f"
          % (e["transform_cost"], e["cost"]))
    for key, name in (("fit_launches", "AA estimator k=6, mesh 1x2, fit"),
                      ("transform_launches",
                       "AA estimator k=6, mesh 1x2, transform")):
        total = dict.fromkeys(read_launches(), 0)
        for r in est:
            add_launches(total, r[key])
        paths[name] = total

    # Config 4's GPNH best of 100 over the restart mesh.
    g = [r["gpnh restarts"] for r in ranks]
    ref = RESULTS["gpnh 100"]
    audit = gpnh_audit(_factors(g[0]), RESULTS["pcs"])
    want, rtol = GPNH_REFERENCE[100]
    rel_costs = float(np.max(np.abs(g[0]["costs"] / ref["costs"] - 1.0)))
    print("  GPNH best of 100 (config 4), restart mesh %dx1: wall %s s by "
          "rank, K1 launches by rank %s, winner %d (phase 10: %d), audited "
          "%.4f (reference %.4f, rel diff %.2e), per-restart costs max rel "
          "diff from phase 10 %.2e"
          % (MESH_WORLD, [round(r["wall"], 3) for r in g],
             [r["launches"]["K1"] for r in g], g[0]["best_index"],
             ref["best_index"], audit, want, abs(audit / want - 1.0),
             rel_costs))
    check(abs(audit / want - 1.0) <= rtol, "GPNH restart mesh: audit %.4f"
          % audit)
    total = dict.fromkeys(read_launches(), 0)
    for r in g:
        add_launches(total, r["launches"])
    paths["GPNH best of 100, restart mesh 2x1"] = total

    # Config 2: k-means on both meshes and the gap of 20 trials.
    km = ranks[0]["kmeans"]
    ref = RESULTS["config 2"]
    for shape in ("%dx1" % MESH_WORLD, "1x%d" % MESH_WORLD):
        r = km[shape]
        print("  KMeans(4, n_init=10), mesh %s: %.3f s, inertia %.1f (phase "
              "19 %.1f, rel diff %.2e; JAX %.1f), n_iter %d, launches %s"
              % (shape, r["wall"], r["inertia"], ref["inertia"],
                 r["inertia"] / ref["inertia"] - 1.0, CONFIG2_INERTIA,
                 r["n_iter"], r["launches"]))
        check(abs(r["inertia"] / CONFIG2_INERTIA - 1.0)
              <= CONFIG2_INERTIA_RTOL, "k-means mesh %s: inertia %.1f"
              % (shape, r["inertia"]))
        check(sum(r["launches"].values()) == 0, "k-means launched a kernel")
    gap = km["gap"]
    print("  sharded_gap_statistic, 20 trials over the restart axis: %.3f "
          "s, gap %.5f (phase 19 %.5f; JAX %.4f), sk %.3e"
          % (gap["wall"], gap["gap"], ref["gap 20"][0], CONFIG2_GAP,
             gap["sk"]))
    check(abs(gap["gap"] - CONFIG2_GAP) <= CONFIG2_GAP_ATOL,
          "sharded gap %.5f" % gap["gap"])

    # PCA of config 4's data, the features split.  In float64 every mode
    # is held to 1e-5 of its own variance against the single-device Gram
    # path on the same data.  In float32 both Grams are sums in other
    # orders, so mode i's variance carries an error of ~eps lambda_1:
    # there every mode is held to 1e-5 of the leading one's, against
    # phase 10 (and the planted rank-8 signal's modes to 1e-5 of their
    # own).
    p = ranks[0]["pca"]
    want64 = p["single_explained_variance_f64"]
    rel64 = np.abs(p["explained_variance_f64"] - want64) / want64
    ref = RESULTS["pca explained variance"]
    diff = np.abs(p["explained_variance"] - ref)
    rel = diff / ref
    rel_lead = float(np.max(diff) / ref[0])
    print("  sharded_pca(%d) of %dx%d, features over %d ranks: %.3f s; "
          "float64 against the single-device Gram path: every mode's max "
          "rel diff %.2e (mode %d); float32 against phase 10: max diff / "
          "the leading mode's %.2e, modes 1-8 max rel diff %.2e, all "
          "modes max rel diff %.2e (mode %d)"
          % (PCA_MODES, GPNH_SAMPLES, GPNH_FEATURES, MESH_WORLD, p["wall"],
             float(np.max(rel64)), int(np.argmax(rel64)) + 1, rel_lead,
             float(np.max(rel[:8])), float(np.max(rel)),
             int(np.argmax(rel)) + 1))
    check(tuple(p["components_shape"]) == (PCA_MODES, GPNH_FEATURES),
          "sharded PCA components %s" % (p["components_shape"],))
    check(float(np.max(rel64)) <= SCHEDULER_RTOL,
          "sharded PCA float64: explained variance %.2e from the "
          "single-device Gram path's" % float(np.max(rel64)))
    check(rel_lead <= SCHEDULER_RTOL and np.max(rel[:8]) <= SCHEDULER_RTOL,
          "sharded PCA: explained variance %.2e of the leading mode's "
          "from phase 10's" % rel_lead)

    # k = 96: K3 and K4 on each rank's rows.
    wide = [r["wide"] for r in ranks]
    print("  ArchetypalAnalysis(96), mesh 1x%d, 3 iterations: %s s by rank, "
          "cost %.4f, transform cost %.4f on %d rows, launches by rank %s"
          % (MESH_WORLD, [round(r["wall"], 3) for r in wide], wide[0]["cost"],
             wide[0]["transform_cost"], wide[0]["transform_rows"],
             [r["launches"] for r in wide]))
    for r in wide:
        check(r["launches"] == dict(K1=0, K2=0, K3=r["n_iter"], K4=1)
              and np.isfinite(r["cost"]) and np.isfinite(
                  r["transform_cost"]),
              "k=96 mesh: launches %s, cost %s" % (r["launches"], r["cost"]))
    total = dict.fromkeys(read_launches(), 0)
    for r in wide:
        add_launches(total, r["launches"])
    paths["AA estimator k=96, mesh 1x2, fit + transform"] = total
    return paths, [r["aa estimator"] for r in ranks]


def phase_nccl(card):
    """Phase 23: a world of one process on NCCL."""
    import torch
    from convex_dim_red_tpu_torch.parallel.mesh import spawn
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    (r,) = spawn(nccl_rank, 1, backend=MESH_BACKENDS["production"],
                 device_type=DEVICE, timeout=MESH_TIMEOUT)
    print("  a world of 1 on %s (%.1f s with start-up): sharded_aa_fit "
          "(1x1) costs %s vs the single-device path's %s, n_iters %s / %s, "
          "winner's weights equal %s, launches %s"
          % (r["backend"], time.perf_counter() - t0,
             np.round(r["costs"], 4).tolist(),
             np.round(r["single_costs"], 4).tolist(), r["n_iters"].tolist(),
             r["single_n_iters"].tolist(), r["weights_equal"], r["launches"]))
    check(r["backend"] == MESH_BACKENDS["production"],
          "the world ran on %s" % r["backend"])
    check(np.array_equal(r["costs"], r["single_costs"])
          and np.array_equal(r["n_iters"], r["single_n_iters"])
          and r["weights_equal"], "NCCL (1x1): not the single-device bits")
    check(r["launches"]["K1"] == 10, "NCCL (1x1): launches %s"
          % r["launches"])
    return {"sharded_aa_fit, NCCL world of 1": r["launches"]}


def phase_mesh_kernels(est):
    """Phase 24: K1 and K2 against their plain versions on rank 0's local
    operands of the sharded estimator (its first K1 launch, the
    transform's K2 launch)."""
    import torch
    from convex_dim_red_tpu_torch.ops import simplex_qp as sq
    held = {}
    for key, name, kernel, plain in (
            ("k1", "K1 sharded estimator, rank 0",
             sq.quad_simplex_qp_packed_grouped,
             sq.quad_simplex_qp_packed_grouped_reference),
            ("k2", "K2 sharded transform, rank 0",
             sq.quad_simplex_qp_packed,
             _one_group(sq.quad_simplex_qp_packed_grouped_reference))):
        A, B, X0, kw = est[0][key]
        operands = tuple(torch.as_tensor(a, device=DEVICE)
                         for a in (A, B, X0)) + (dict(kw),)
        held[name] = hold_path_qp(name, kernel, plain, operands)
    return held


# ---------------------------------------------------------------------------
# Phase 25: the JRA-55 case study at full size, in memory
# ---------------------------------------------------------------------------

#: The JRA-55 case study: the reanalysis' own span and grid (1958-2018,
#: 145 x 288 at 1.25 degrees; SURVEY.md, run_jra55_kmeans.py), seed 0;
#: the wrappers' 167 EOFs (bin/run_jra55_pca_aa_wrapper.sh), phase 21's
#: k, and the delta of the JAX package's own AA tests.
JRA55_SYNTHETIC = dict(kind='grid', start_year=1958, n_years=61, n_lat=145,
                       n_lon=288, seed=0)
JRA55_EOFS, JRA55_DELTA = 167, 0.1
#: The jra55_pca_aa driver's solver caps (both inner solvers at one step,
#: rel_delta_f; cli/drivers.py) and its wrapper's fit settings.
JRA55_AA = dict(delta=JRA55_DELTA, init='random', n_init=100,
                tolerance=1e-6, max_iterations=10000, random_seed=0,
                dictionary_solver_kwargs={'max_iterations': 1},
                weights_solver_kwargs={'max_iterations': 1},
                stopping_criterion='rel_delta_f')
#: The k-means wrappers' settings (bin/run_jra55_kmeans_wrapper.sh,
#: bin/run_jra55_pca_kmeans_wrapper.sh) with the driver's defaults.
JRA55_KMEANS = dict(n_init=100, max_iterations=10000, n_trials=100,
                    reference='pca', random_seed=0, init='k-means++',
                    tolerance=1e-4)
#: A float32 scale factor's distance past its box that rounding allows.
ALPHA_SLACK = 1e-6


def jra55_case_study_data():
    """The synthetic JRA-55 grid through the port's pipelines as the
    jra55 drivers take it (``cli/common.py:load_field`` and
    ``cli/drivers.py:_prepare``): the JRA55_HGT spec's year and latitude
    filters (20-90 N), scos weights, flatten, missing mask and 0.1
    chronological split, in float64 as a driver reads them."""
    from convex_dim_red_tpu_torch.cli.specs import JRA55_HGT as spec
    from convex_dim_red_tpu_torch.pipelines import preprocess as pp
    from convex_dim_red_tpu_torch.pipelines.synthetic import synthetic_jra55
    t0 = time.perf_counter()
    ds = synthetic_jra55(**JRA55_SYNTHETIC)
    shape = ds[spec.var_name].data.shape
    generated = time.perf_counter() - t0
    ds = ds.sel_time_years(spec.time_name, spec.start_year, spec.end_year)
    ds = ds.sel_range(spec.lat_name, spec.min_latitude, spec.max_latitude)
    weights = pp.latitude_weights(ds.coords[spec.lat_name].data,
                                  spec.default_lat_weights)
    field = ds[spec.var_name].data
    flat = pp.weight_and_flatten(field, weights[:, None])
    missing = pp.missing_feature_mask(flat)
    valid = flat[:, ~missing]
    train, val, n_train = pp.train_validation_split(
        valid, validation_frac=spec.validation_frac)
    grid = list(field.shape[1:])
    print("  synthetic JRA-55 grid %s float32 (%.0f MB): generated in %.1f "
          "s, preparation %.1f s on the host; band %s, %d points (%d "
          "missing), %d training and %d held-out months, %s"
          % (shape, 4e-6 * np.prod(shape), generated,
             time.perf_counter() - t0 - generated, grid, valid.shape[1],
             int(missing.sum()), n_train, val.shape[0], valid.dtype))
    check(not missing.any(), "JRA-55 grid: missing points")
    return dict(train=train, val=val, missing=missing, grid=grid,
                time=ds.coords[spec.time_name], time_name=spec.time_name,
                dims=(spec.lat_name, spec.lon_name),
                coords={name: ds.coords[name] for name in
                        (spec.lat_name, spec.lon_name)})


def check_alpha(name, alpha, delta):
    """Scale factors inside ``[1 - delta, 1 + delta]`` to float32
    rounding; returns their range."""
    lo, hi = float(alpha.min()), float(alpha.max())
    check(1.0 - delta - ALPHA_SLACK <= lo and hi <= 1.0 + delta + ALPHA_SLACK,
          "%s: alpha in [%.7f, %.7f], outside [%g, %g]"
          % (name, lo, hi, 1.0 - delta, 1.0 + delta))
    return lo, hi


def phase_jra55_case_study(card):
    """The JRA-55 drivers' analyses on the reanalysis-sized synthetic
    grid, as the drivers call them (float64 host arrays,
    ``device='cuda'``, so fitted in float32): PCA(167) of the grid, AA
    with delta = 0.1 on the PCs at jra55_pca_aa's caps, GPNH on the PCs,
    k-means with the PCA-reference gap on the PCs and on the grid; K1
    held to its plain version on the AA analysis' operands and timed at
    its one-iteration launch; then a float64 delta = 0.1 fit on the card
    against the CPU and the delta = 0.1 estimator with K2 and its
    transform, K2 held to its plain version on the operands of the fit's
    first launch and of the transform's.  Returns ``(paths, held, K1's
    times at the AA launch)``."""
    import torch
    from convex_dim_red_tpu_torch.cli import common
    from convex_dim_red_tpu_torch.cli.specs import JRA55_PCS
    from convex_dim_red_tpu_torch.ops import simplex_qp as sq
    from convex_dim_red_tpu_torch.parallel.sharded_aa import _ROUND
    from convex_dim_red_tpu_torch.pipelines import preprocess as pp
    d = jra55_case_study_data()
    train, val, missing = d['train'], d['val'], d['missing']
    X64 = train.astype(np.float32).astype(np.float64)
    paths, held = {}, {}
    k1 = {K1_WRAPPER: (0, _ROUND)}

    # PCA with the wrappers' 167 EOFs (the Gram path: 16,416 features >
    # 4 x 659 samples), tolerance 1e-8.
    (result, attrs), wall, launches, _ = run_path(
        paths, "JRA-55 PCA(167) analysis", lambda: common.pca_analysis(
            train, val, n_components=JRA55_EOFS, tolerance=1e-8,
            random_seed=0, device=DEVICE))
    check(sum(launches.values()) == 0, "JRA-55 PCA: %s" % launches)
    pcs, eofs = result['pcs'], result['eofs']
    resid = X64 - pcs[:len(train)] @ eofs.astype(np.float64)
    out = analysis_output(d, pcs[:len(train)], eofs, attrs, 'EOFs',
                          JRA55_EOFS)
    rel = check_analysis("JRA-55 PCA", attrs, out, 'EOFs', missing,
                         0.5 * float(np.sum(resid ** 2)) / len(train),
                         float(attrs['training_set_cost']), len(val))
    check(bool(np.isfinite(pcs).all()) and pcs.shape == (
        len(train) + len(val), JRA55_EOFS), "JRA-55 PCs: %s" % (pcs.shape,))
    print("  pca_analysis (167 components, tolerance 1e-8) of %d x %d: "
          "%.3f s, explained variance ratio %.4f (first three %s), training "
          "cost %s (float64 audit rel diff %.1e), test cost %s, on %s"
          % (len(train), train.shape[1], wall,
             float(np.sum(result['explained_variance_ratio'])),
             np.round(result['explained_variance_ratio'][:3], 4).tolist(),
             attrs['training_set_cost'].strip(), rel,
             attrs['test_set_cost'].strip(), card))

    # The PCs as the PC drivers read them: every month, none held out.
    pc_train, pc_val, _ = pp.train_validation_split(
        pcs, validation_frac=JRA55_PCS.validation_frac)
    P64 = pc_train.astype(np.float32).astype(np.float64)

    # AA with delta = 0.1 at the jra55_pca_aa driver's caps.
    ((best, attrs), captured), wall, launches, k1_used = run_path(
        paths, "JRA-55 PCs AA analysis (k=4, delta 0.1, best of 100)",
        lambda: capture_operands(lambda: common.aa_analysis(
            pc_train, pc_val, n_components=CASE_STUDY_K, device=DEVICE,
            **JRA55_AA), k1))
    check(launches == dict(K1=k1_used, K2=0, K3=0, K4=0),
          "JRA-55 AA: launches %s, expected %d of K1" % (launches, k1_used))
    check(best['weights'].dtype == torch.float32,
          "JRA-55 AA fitted in %s" % best['weights'].dtype)
    lo, hi = check_alpha("JRA-55 AA", best['alpha'], JRA55_DELTA)
    check_simplex_rows("JRA-55 AA weights", best['weights'])
    check_simplex_rows("JRA-55 AA C", best['dictionary']
                       / best['alpha'][:, None])
    out = analysis_output(d, best['weights'], best['archetypes'], attrs,
                          'archetypes', CASE_STUDY_K,
                          cost_deltas=best['cost_deltas'],
                          dictionary=best['dictionary'], n_modes=JRA55_EOFS)
    rel = check_analysis("JRA-55 AA", attrs, out, 'archetypes',
                         np.zeros(JRA55_EOFS, bool),
                         audit_cost_f64(best, P64), best['cost'],
                         len(pc_val))
    n_iters = best['n_iters']
    print("  aa_analysis on the PCs (k=4, delta 0.1, n_init=100, rel_delta_f "
          "1e-6, both solvers capped at 1, max_iterations 10000): %.3f s, %d "
          "K1 launches, n_iter %d, n_iters mean %.1f min %d max %d (%d at "
          "the cap), cost %.6f (float64 audit of Z alpha C X rel diff "
          "%.1e), alpha in [%.6f, %.6f], on %s"
          % (wall, launches["K1"], best['n_iter'], float(np.mean(n_iters)),
             int(np.min(n_iters)), int(np.max(n_iters)),
             int(np.sum(n_iters >= JRA55_AA['max_iterations'])),
             best['cost'], rel, lo, hi, card))
    hold_recorded(held, "K1 JRA-55 AA", sq.quad_simplex_qp_packed_grouped,
                  sq.quad_simplex_qp_packed_grouped_reference, captured,
                  K1_WRAPPER, k1[K1_WRAPPER])
    As, Bs, X0s, kw = captured[K1_WRAPPER][0]
    kw = dict(kw)
    projection = kw.pop("projection")
    check(kw.pop("mask") is None and kw["max_iterations"] == 1,
          "JRA-55 AA's K1 arguments %s" % kw)
    aa_times = dict(R=Bs.shape[0], n=Bs.shape[1], k=Bs.shape[2], launch=0,
                    **kernel_times("K1 JRA-55 AA launch 0",
                                   sq.quad_simplex_qp_packed_grouped,
                                   sq.quad_simplex_qp_packed_grouped_reference,
                                   (As, Bs, X0s), projection,
                                   sq.team_width(CASE_STUDY_K),
                                   sq.PACKED_THREADS, lone=True, **kw))

    # GPNH on the PCs at the jra55_pca_gpnh driver's settings.
    (model, attrs, won, captured), wall, launches, k1_used = run_path(
        paths, "JRA-55 PCs GPNH analysis (k=4, best of 100)",
        lambda: gpnh_analysis_recorded(
            pc_train, pc_val, dict(CASE_STUDY_GPNH,
                                   n_components=CASE_STUDY_K), k1))
    check(launches == dict(K1=k1_used, K2=0, K3=0, K4=0),
          "JRA-55 GPNH: launches %s, expected %d of K1" % (launches, k1_used))
    check_simplex_rows("JRA-55 GPNH weights", won['weights'])
    out = analysis_output(d, won['weights'], won['dictionary'].T, attrs,
                          'dictionary', CASE_STUDY_K,
                          cost_deltas=won['cost_deltas'], n_modes=JRA55_EOFS)
    rel = check_analysis("JRA-55 GPNH", attrs, out, 'dictionary',
                         np.zeros(JRA55_EOFS, bool),
                         gpnh_audit(won, pc_train.astype(np.float32)),
                         won['cost'], len(pc_val))
    print("  gpnh_analysis on the PCs (k=4, lambda_W 1e-3, n_init=100, "
          "rel_delta_f 1e-6, weights QP capped at 1): %.3f s, %d K1 "
          "launches, n_iter %d, n_iters mean %.1f max %d, cost %.6f (float64 "
          "audit rel diff %.1e), on %s"
          % (wall, launches["K1"], won['n_iter'],
             float(np.mean(won['n_iters'])), int(np.max(won['n_iters'])),
             won['cost'], rel, card))
    hold_recorded(held, "K1 JRA-55 GPNH", sq.quad_simplex_qp_packed_grouped,
                  sq.quad_simplex_qp_packed_grouped_reference, captured,
                  K1_WRAPPER, k1[K1_WRAPPER])

    # k-means with the PCA-reference gap, on the PCs and on the grid.
    for label, data, held_out, X_audit, n_modes in (
            ("PCs", pc_train, pc_val, P64, JRA55_EOFS),
            ("grid", train, val, X64, None)):
        (model, onehot, attrs), wall, launches, _ = run_path(
            paths, "JRA-55 %s k-means analysis (k=4, best of 100, 100 PCA "
            "trials)" % label, lambda: common.kmeans_analysis(
                data, held_out, n_components=CASE_STUDY_K, device=DEVICE,
                **JRA55_KMEANS))
        check(sum(launches.values()) == 0, "JRA-55 %s k-means: %s"
              % (label, launches))
        out = analysis_output(d, onehot, model.cluster_centers_, attrs,
                              'centroids', CASE_STUDY_K, n_modes=n_modes)
        rel = check_analysis(
            "JRA-55 %s k-means" % label, attrs, out, 'centroids',
            missing if n_modes is None else np.zeros(n_modes, bool),
            kmeans_audit(X_audit, model), model.inertia_, len(held_out))
        check(attrs['reference'] == 'pca', "JRA-55 k-means reference %s"
              % attrs['reference'])
        print("  kmeans_analysis on the %s (%d x %d; k=4, n_init=100, 100 "
              "PCA-reference trials): %.3f s, inertia %.1f (float64 audit "
              "rel diff %.1e), gap %s, sk %s, n_iter %s, test inertia %s, "
              "on %s" % (label, data.shape[0], data.shape[1], wall,
                         model.inertia_, rel, attrs['gap_statistic'].strip(),
                         attrs['gap_sk'].strip(), attrs['n_iter'],
                         attrs['test_set_inertia'].strip(), card))

    paths.update(jra55_delta_card_against_cpu())
    paths.update(jra55_delta_estimator(pc_train, card, held))
    return paths, held, aa_times


def jra55_delta_card_against_cpu():
    """Phase 6's float64 fit with delta = 0.1 (``fit_on_card_and_cpu``):
    costs within 1e-6 relative, equal ``n_iters``, and the winner's alpha
    within 1e-6 and inside its box."""
    res, _, launches = fit_on_card_and_cpu(JRA55_DELTA)
    card, cpu = res["cuda"], res["cpu"]
    dalpha = float((card['alpha'].cpu() - cpu['alpha']).abs().max())
    check_alpha("delta fit on the card", card['alpha'], JRA55_DELTA)
    print("  delta %g: the winner's alpha on the card vs the CPU max|diff| "
          "%.3e (alpha %s)" % (JRA55_DELTA, dalpha, np.round(
              card['alpha'].cpu().numpy(), 4).tolist()))
    check(dalpha <= 1e-6, "delta fit: card and CPU alpha differ by %.3e"
          % dalpha)
    return {"AA delta 0.1 float64 fit, card against CPU": launches}


def jra55_delta_model():
    """``ArchetypalAnalysis(4, delta=0.1)`` at the jra55_pca_aa driver's
    settings, with 'pallas' weights (K2 every iteration)."""
    from convex_dim_red_tpu_torch import ArchetypalAnalysis
    return ArchetypalAnalysis(
        CASE_STUDY_K, delta=JRA55_DELTA, init='random', random_state=0,
        tolerance=JRA55_AA['tolerance'],
        max_iterations=JRA55_AA['max_iterations'],
        stopping_criterion=JRA55_AA['stopping_criterion'],
        dictionary_solver_kwargs=JRA55_AA['dictionary_solver_kwargs'],
        weights_solver_kwargs=dict(JRA55_AA['weights_solver_kwargs'],
                                   backend='pallas'))


def jra55_delta_estimator(pcs_host, card, held):
    """``jra55_delta_model()`` fitted on the JRA-55 PCs, then
    ``transform`` (one K2 launch, solved to the estimator's
    ``max_iterations``); K2 held to its plain version, into ``held``, on
    the operands of the fit's first launch and of the transform's."""
    import torch
    from convex_dim_red_tpu_torch.ops import simplex_qp as sq
    X = torch.as_tensor(pcs_host, dtype=torch.float32, device=DEVICE)
    k2_plain = _one_group(sq.quad_simplex_qp_packed_grouped_reference)
    model = jra55_delta_model()
    reset_launches()
    t0 = time.perf_counter()
    _, fit_ops = capture_operands(lambda: model.fit(X), {K2_WRAPPER: (0,)})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    audit = audit_cost_f64(dict(weights=model.weights,
                                dictionary=model.dictionary),
                           pcs_host.astype(np.float32))
    rel = abs(audit / model.cost - 1.0)
    lo, hi = check_alpha("delta estimator", model.alpha, JRA55_DELTA)
    check_factors("delta estimator", model, X)
    check(launches == dict(K1=0, K2=model.n_iter, K3=0, K4=0),
          "delta estimator: launches %s for %d iterations"
          % (launches, model.n_iter))
    check(rel <= 1e-4, "delta estimator: audit %.6f vs cost %.6f"
          % (audit, model.cost))
    reset_launches()
    t0 = time.perf_counter()
    (W, cost), transform_ops = capture_operands(lambda: model.transform(X),
                                                {K2_WRAPPER: (0,)})
    torch.cuda.synchronize()
    t_wall = time.perf_counter() - t0
    t_launches = read_launches()
    print("  ArchetypalAnalysis(4, delta=0.1), 'pallas' weights, on the PCs: "
          "fit %.3f s, n_iter %d, cost %.6f (float64 audit rel diff %.1e), "
          "alpha in [%.6f, %.6f], launches %s; transform %.4f s, cost %.6f, "
          "launches %s, on %s"
          % (wall, model.n_iter, model.cost, rel, lo, hi, launches, t_wall,
             cost, t_launches, card))
    check(t_launches == dict(K1=0, K2=1, K3=0, K4=0),
          "delta transform: launches %s" % t_launches)
    check(cost <= model.cost * 1.0001, "delta transform cost %.6f above the "
          "fit's %.6f" % (cost, model.cost))
    check_simplex_rows("delta transform", W)
    hold_recorded(held, "K2 JRA-55 delta estimator fit",
                  sq.quad_simplex_qp_packed, k2_plain, fit_ops, K2_WRAPPER,
                  (0,))
    hold_recorded(held, "K2 JRA-55 delta estimator transform",
                  sq.quad_simplex_qp_packed, k2_plain, transform_ops,
                  K2_WRAPPER, (0,))
    return {"AA estimator k=4, delta 0.1, on the JRA-55 PCs, fit":
            launches,
            "AA estimator k=4, delta 0.1, transform": t_launches}


#: ``--scale-check-ab``: the order of one round of the A/B of the
#: scale-factor SPG's host reads (every 8 steps, ``quad_spg``'s default,
#: and every step), and the iteration caps of the two profiled runs,
#: whose difference is the profile of an iteration.
SCALE_AB_ORDER = (8, 1, 1, 8)
SCALE_PROFILE_CAPS = (64, 128)


def set_scale_check_every(every):
    """How many scale-factor SPG steps run between two host reads of its
    stop, in the estimator and the restart runners."""
    from convex_dim_red_tpu_torch.models import archetypal_analysis
    from convex_dim_red_tpu_torch.parallel import sharded_aa
    archetypal_analysis._SCALE_CHECK_EVERY = every
    sharded_aa._SCALE_CHECK_EVERY = every


def profile_run(run):
    """``run()`` under ``torch.profiler`` and, again, under the CUDA sync
    debug mode: its wall, the device's busy time (its kernels'), the
    number of kernels and of host syncs, and the kernels by device
    time."""
    import warnings
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return dict(wall_ms=wall_ms,
                busy_ms=1e-3 * sum(e.self_device_time_total
                                   for e in kernels),
                kernels=sum(e.count for e in kernels),
                syncs=sum("synchroniz" in str(w.message) for w in caught),
                by_kernel={e.key: (1e-3 * e.self_device_time_total, e.count)
                           for e in kernels})


def scale_check_ab():
    """``--scale-check-ab``: phase 25's two delta = 0.1 paths on the
    JRA-55 PCs, ``aa_analysis`` and the estimator's fit, with the
    scale-factor SPG reading its stop every 8 steps and every step, in
    the order ``SCALE_AB_ORDER`` after one warm run of each; every run
    must give the same cost, ``n_iters`` and launches.  Then
    ``aa_analysis`` capped at each of ``SCALE_PROFILE_CAPS`` under the
    profiler: the difference of the two runs over their iterations is
    one iteration's wall, device busy time, kernels and host syncs."""
    import torch
    from convex_dim_red_tpu_torch.cli import common
    from convex_dim_red_tpu_torch.cli.specs import JRA55_PCS
    from convex_dim_red_tpu_torch.pipelines import preprocess as pp
    card = phase_device()
    phase_build()
    d = jra55_case_study_data()
    result, _ = common.pca_analysis(d['train'], d['val'],
                                    n_components=JRA55_EOFS, tolerance=1e-8,
                                    random_seed=0, device=DEVICE)
    pcs, pc_val, _ = pp.train_validation_split(
        result['pcs'], validation_frac=JRA55_PCS.validation_frac)
    X = torch.as_tensor(pcs, dtype=torch.float32, device=DEVICE)

    def analysis(**kw):
        best, _ = common.aa_analysis(pcs, pc_val, n_components=CASE_STUDY_K,
                                     device=DEVICE, **dict(JRA55_AA, **kw))
        return best['cost'], best['n_iters']

    def estimator():
        model = jra55_delta_model().fit(X)
        return model.cost, np.array([model.n_iter])

    runs = {"aa_analysis": analysis, "estimator fit": estimator}
    walls = {label: {every: [] for every in set(SCALE_AB_ORDER)}
             for label in runs}
    seen = {}
    set_scale_check_every(1)
    for run in runs.values():
        run()
    for every in SCALE_AB_ORDER:
        set_scale_check_every(every)
        for label, run in runs.items():
            reset_launches()
            t0 = time.perf_counter()
            cost, n_iters = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            walls[label][every].append(wall)
            got = (float(cost), np.asarray(n_iters).tolist(),
                   read_launches())
            check(seen.setdefault(label, got) == got,
                  "%s, a read every %d steps: %s, not %s"
                  % (label, every, got, seen[label]))
            print("  %s, a read every %d scale step(s): %.3f s, cost %.6f, "
                  "n_iters summed %d, launches %s, on %s"
                  % (label, every, wall, got[0], int(np.sum(n_iters)),
                     got[2], card), flush=True)
    set_scale_check_every(1)
    for cap in SCALE_PROFILE_CAPS:
        analysis(max_iterations=cap)
    prof = [profile_run(lambda: analysis(max_iterations=cap))
            for cap in SCALE_PROFILE_CAPS]
    span = SCALE_PROFILE_CAPS[1] - SCALE_PROFILE_CAPS[0]
    per = {key: (prof[1][key] - prof[0][key]) / span
           for key in ("wall_ms", "busy_ms", "kernels", "syncs")}
    per["idle_share"] = 1.0 - per["busy_ms"] / per["wall_ms"]
    print("  aa_analysis, one iteration of 100 restarts (runs capped at %d "
          "and %d iterations, the difference): wall %.3f ms, device busy "
          "%.4f ms (idle %.1f%%), %.1f kernels, %.2f host syncs, on %s"
          % (SCALE_PROFILE_CAPS + (per["wall_ms"], per["busy_ms"],
                                   100.0 * per["idle_share"],
                                   per["kernels"], per["syncs"], card)))
    top = sorted(((v[0] - prof[0]["by_kernel"].get(key, (0.0, 0))[0],
                   v[1] - prof[0]["by_kernel"].get(key, (0.0, 0))[1], key)
                  for key, v in prof[1]["by_kernel"].items()), reverse=True)
    for ms, count, key in top[:12]:
        print("    %8.4f ms %6.1f calls an iteration  %s"
              % (ms / span, count / span, key[:90]))
    print(card)
    print(json.dumps({"scale_check_ab": {
        label: {"every %d" % every: times for every, times in w.items()}
        for label, w in walls.items()}, "iteration": per}))


def main():
    t_start = time.perf_counter()
    card = phase_device()
    import torch

    def phase(name):
        print("== %s (at %.1f s)" % (name, time.perf_counter() - t_start),
              flush=True)

    phase("build")
    phase_build()
    phase("team-width sweep of the K1/K2 kernel")
    phase_sweep()
    phase("K1 against its plain version")
    kernels = {"K1": phase_kernel()}
    phase("K2, K3 and K4 against their plain versions")
    kernels.update(phase_more_kernels())
    phase("K5 against its plain version")
    k5 = phase_k5()
    phase("small fit, card against CPU")
    phase_small_fit()
    phase("main path")
    main_launches, X_host, compacted, compacted_wall = phase_main_path(card)
    paths = {"AA best of 100, compaction": main_launches}
    phase("estimator, k=6, full width")
    paths["AA estimator k=6, fits + transform"] = phase_estimator(X_host,
                                                                  card)
    phase("k=96, full width")
    paths.update(phase_wide(X_host))
    phase("PCA -> GPNH (config 4), full size")
    pcs, pcs_host, gpnh, gpnh_paths, k1_gpnh = phase_pca_gpnh(card)
    paths.update(gpnh_paths)
    kernels["K1"]["gpnh_shape"] = dict(R=100, n=GPNH_SAMPLES, k=GPNH_K,
                                       launch=0, **k1_gpnh[0])
    phase("GPNH best of 100 under compaction")
    paths.update(phase_gpnh_compaction(pcs, gpnh[100], card))
    phase("GPNH estimator on the PCs")
    paths.update(phase_gpnh_estimator(pcs, pcs_host, card))
    phase("AA main path's workload, one-shot")
    paths.update(phase_aa_one_shot(X_host, compacted, compacted_wall, card))
    phase("screened AA, best of 100")
    paths.update(phase_screened_aa(X_host, card))
    phase("kernel_aa_fit_restarts, best of 100")
    paths.update(phase_kernel_aa(X_host, card))
    phase("padded AA at config 5's shape")
    paths.update(phase_padded_aa(card)[0])
    phase("AA model-selection sweep, config 5")
    sweep_paths, kernels["K1"]["sweep_shape"], _ = phase_aa_sweep(card)
    paths.update(sweep_paths)
    phase("GPNH screened, padded and swept, config 4")
    paths.update(phase_gpnh_screened_padded(pcs, pcs_host, card))
    phase("k-means and the gap statistic, config 2")
    paths.update(phase_config2(X_host, card))
    phase("k-means model-selection sweep, config 2's data")
    paths.update(phase_kmeans_sweep(X_host, card))
    phase("HadISST case-study analyses, full size")
    case_paths, held = phase_case_study(card)
    paths.update(case_paths)
    for key, entry in held.items():  # "K1 HadISST AA, launch 0": ...
        kernels[key[:2]].setdefault("case_study_shapes", {})[
            key[3:]] = entry
    phase("mesh: restart- and sample-sharded fits, a world of 2 (gloo)")
    mesh_paths, estimator_ranks = phase_mesh(card, X_host)
    paths.update(mesh_paths)
    phase("mesh: sharded_aa_fit in a world of 1 on NCCL")
    paths.update(phase_nccl(card))
    phase("mesh: K1 and K2 on a rank's local operands")
    for key, entry in phase_mesh_kernels(estimator_ranks).items():
        kernels[key[:2]].setdefault("mesh_shapes", {})[key[3:]] = entry
    phase("JRA-55 case study at full size, in memory")
    jra55_paths, held, kernels["K1"]["jra55_aa_shape"] = \
        phase_jra55_case_study(card)
    paths.update(jra55_paths)
    for key, entry in held.items():  # "K1 JRA-55 AA, launch 0": ...
        kernels[key[:2]].setdefault("case_study_shapes", {})[
            key[3:]] = entry
    print("all phases passed in %.1f s" % (time.perf_counter() - t_start))
    print(card)
    by_path = {key: {path: counts[key] for path, counts in paths.items()
                     if counts[key]}
               for key, *_ in KERNELS}
    print(json.dumps({"kernels": [dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=sum(by_path[key].values()),
        launches_by_path=by_path[key], **kernels[key])
        for key, name, source, replaces, _ in KERNELS]}))
    print(json.dumps({"K5": dict(
        name="residual_cost", route="cuda",
        source="convex_dim_red_tpu_torch/csrc/residual_cost.cu",
        replaces=None, **k5)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def k5_only():
    """``--k5``: the device, the build and K5's phase alone."""
    card = phase_device()
    phase_build()
    k5 = phase_k5()
    print(card)
    print(json.dumps({"K5": k5}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--scale-check-ab"]:
        scale_check_ab()
    elif sys.argv[1:] == ["--k5"]:
        k5_only()
    elif sys.argv[1:]:
        raise SystemExit("usage: python3 chip_smoke.py [--scale-check-ab | "
                         "--k5]")
    else:
        main()
