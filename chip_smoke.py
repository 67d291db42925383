#!/usr/bin/env python3
"""Run the PyTorch port's main path once on one CUDA GPU and check it.

Usage, from the root of the repository, on a machine with an NVIDIA
Hopper GPU (sm_90a), PyTorch built for CUDA and ``nvcc``::

    python3 chip_smoke.py

Phases, each printing its own lines; any failed check or exception ends
the run with a non-zero exit and no result line:

1. Device: needs ``torch.cuda.is_available()``; prints the torch, CUDA
   and nvcc versions and the card's name and power limit.
2. Build: compiles ``convex_dim_red_tpu_torch/csrc/simplex_qp.cu`` with
   nvcc and prints ptxas's register and spill report.
3. Kernel against its plain PyTorch version on the card: float32 at the
   main path's shape (R=25 groups, n=1788 rows, k=6) with both
   projections and a masked case, float64 at (3, 257, 11) after 3
   iterations and at convergence, and k=20 and k=64; then both warm
   times at the main-path shape (CUDA events, median of 10).
4. Small fit: the port's ``aa_fit_restarts`` in float64 on the card and
   on the CPU (the kernel's plain version) from the same initial states.
5. Main path: the HadISST-scale best-of-100 fit that ``bench.py`` times
   (n=1788 x d=16384 synthetic data, k=6, weights QP capped at 25
   iterations, dictionary at 1, rel_delta_f 1e-5, rounds of 32, chunks
   of 25), once to warm up and once timed with the kernel launch count
   reset just before; the winner is re-costed on the host in float64 and
   held to the JAX package's audited cost on the same data.

The last two lines of standard output are a JSON object with the
kernel's launches, error and times, and the JSON result line.
"""

import json
import os
import re
import statistics
import subprocess
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

KERNEL_SOURCE = "convex_dim_red_tpu_torch/csrc/simplex_qp.cu"
KERNEL_REPLACES = "convex_dim_red_tpu/ops/pallas_qp.py:659"


def check(ok, message):
    if not ok:
        raise AssertionError(message)


def make_data():
    """bench.py:make_data: rank-8 structure plus noise, standardised,
    float32."""
    rng = np.random.RandomState(42)
    U = rng.standard_normal((N_SAMPLES, 8))
    V = rng.standard_normal((8, N_FEATURES))
    X = U @ V + 0.3 * rng.standard_normal((N_SAMPLES, N_FEATURES))
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
    """One line per kernel variant from nvcc's ``-Xptxas -v`` output:
    registers, spills and shared memory."""
    lines, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*kernelI([fd])Li(\d+)"
                      r"ELb([01])E", line)
        if m:
            name = "%s KMAX %s %s" % (
                "float" if m.group(1) == "f" else "double", m.group(2),
                "michelot" if m.group(3) == "1" else "bisect")
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "Used" in line:
            lines.append("%-24s %s; %s" % (name, line.split(":", 1)[1]
                                           .strip(), spill))
            name = None
    return sorted(lines)


def phase_build():
    from convex_dim_red_tpu_torch.ops import simplex_qp
    t0 = time.perf_counter()
    simplex_qp.load_library()
    print("build: %.1f s" % (time.perf_counter() - t0))
    for line in ptxas_report(simplex_qp.build_log()):
        print("  ptxas: " + line)


def compare_qp(name, As, Bs, X0s, tol_obj, tol_x=None, **kw):
    """Kernel against plain version on the same card and inputs."""
    import torch
    from convex_dim_red_tpu_torch.ops import simplex_qp
    got = simplex_qp.quad_simplex_qp_packed_grouped(As, Bs, X0s, **kw)
    torch.cuda.synchronize()
    want = simplex_qp.quad_simplex_qp_packed_grouped_reference(
        As, Bs, X0s, **kw)
    torch.cuda.synchronize()
    f_got = qp_objective(got, As, Bs)
    f_want = qp_objective(want, As, Bs)
    gap = float(np.max(np.abs(f_got - f_want) / (1.0 + np.abs(f_want))))
    dx = float((got - want).abs().max())
    feas = float((got.double().sum(dim=2) - 1.0).abs().max())
    print("  %-34s max|dx| %.3e  objective gap %.3e  |sum-1| %.3e"
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


def cuda_median_ms(fn, reps=10):
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    compare_qp("f32 2x500x20 (KMAX 32)",
               *qp_problem(2, 2, 500, 20, torch.float32, dev),
               tol_obj=1e-5, max_iterations=1000)
    compare_qp("f64 2x300x64 (KMAX 64)",
               *qp_problem(3, 2, 300, 64, torch.float64, dev),
               tol_obj=1e-8, max_iterations=1000)
    torch.cuda.synchronize()

    def timed(fn, projection):
        return cuda_median_ms(lambda: fn(
            *main, projection=projection,
            max_iterations=WEIGHTS_MAX_ITERATIONS))

    ms = timed(simplex_qp.quad_simplex_qp_packed_grouped, "michelot")
    plain_ms = timed(simplex_qp.quad_simplex_qp_packed_grouped_reference,
                     "michelot")
    bisect_ms = timed(simplex_qp.quad_simplex_qp_packed_grouped, "bisect")
    print("  warm time at 25x1788x6 f32, 25 iterations: kernel %.4f ms "
          "(bisect %.4f ms), plain version %.4f ms (CUDA events, median "
          "of 10)" % (ms, bisect_ms, plain_ms))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def planted(seed, n, d, k, noise):
    rng = np.random.RandomState(seed)
    basis = rng.uniform(size=(k, d))
    Z = rng.uniform(size=(n, k))
    Z /= Z.sum(axis=1, keepdims=True)
    for comp, i in enumerate(rng.choice(n, size=k, replace=False)):
        Z[i] = 0.0
        Z[i, comp] = 1.0
    return Z @ basis + noise * rng.standard_normal((n, d))


def fit_kwargs():
    return dict(init='random', tolerance=TOL, max_iterations=MAX_ITER,
                stopping_criterion='rel_delta_f',
                dictionary_solver_kwargs={
                    'max_iterations': DICT_MAX_ITERATIONS},
                weights_solver_kwargs={
                    'max_iterations': WEIGHTS_MAX_ITERATIONS},
                restart_chunk=RESTART_CHUNK,
                compact_iterations=COMPACT_ITERS)


def phase_small_fit():
    """The same float64 fit on the card and on the CPU, from the same
    initial states (a CPU generator draws them on both).  This planted
    problem is well conditioned, so rounding differences between the
    two stay far below the 1e-6 compared here."""
    import torch
    from convex_dim_red_tpu_torch import aa_fit_restarts
    X = torch.as_tensor(planted(0, 300, 40, 6, 0.01))
    kw = dict(fit_kwargs(), tolerance=1e-6, max_iterations=200,
              restart_chunk=4)
    res = {dev: aa_fit_restarts(X.to(dev), 6,
                                torch.Generator().manual_seed(0), 8, **kw)
           for dev in ("cuda", "cpu")}
    torch.cuda.synchronize()
    rel = float(np.max(np.abs(res["cuda"]["costs"] / res["cpu"]["costs"]
                              - 1.0)))
    print("  float64 300x40, k=6, 8 restarts: costs on the card vs the "
          "CPU max rel diff %.3e; n_iters %s vs %s"
          % (rel, res["cuda"]["n_iters"].tolist(),
             res["cpu"]["n_iters"].tolist()))
    check(rel <= 1e-6, "small fit: card and CPU costs differ by %.3e"
          % rel)


def audit_cost_f64(result, X32):
    """bench.py:audit_cost_f64: the winner re-costed on the host in
    float64."""
    X64 = np.asarray(X32, np.float64)
    Z = result['weights'].double().cpu().numpy()
    D = result['dictionary'].double().cpu().numpy()
    resid = Z @ (D @ X64) - X64
    return 0.5 * float(np.sum(resid * resid)) / X64.shape[0]


def phase_main_path(card):
    import torch
    from convex_dim_red_tpu_torch import aa_fit_restarts
    from convex_dim_red_tpu_torch.ops import simplex_qp
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
    simplex_qp.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = run()
    elapsed = time.perf_counter() - t0
    launches = simplex_qp.LAUNCHES
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
    check(launches >= -(-total_iters // RESTART_CHUNK),
          "kernel launches %d < restart-iterations / chunk (%d / %d)"
          % (launches, total_iters, RESTART_CHUNK))
    audit = audit_cost_f64(result, X_host)
    rel = abs(audit / REFERENCE_AUDITED_COST - 1.0)
    print("  device cost %.4f, float64 audit %.4f, JAX reference audit "
          "%.2f (rel diff %.2e)" % (result['cost'], audit,
                                    REFERENCE_AUDITED_COST, rel))
    print("  wall %.3f s timed (%.3f s first run), %d restarts, mean "
          "outer iterations %.2f, %.1f restart-iterations/s, %d kernel "
          "launches, peak memory %.2f GB, on %s"
          % (elapsed, warm_s, N_INIT, float(np.mean(n_iters)),
             total_iters / elapsed, launches, peak_gb, card))
    check(rel <= AUDIT_RTOL, "audited cost %.4f is %.2e from %.2f"
          % (audit, rel, REFERENCE_AUDITED_COST))
    return launches


def main():
    card = phase_device()
    import torch
    print("== build")
    phase_build()
    print("== kernel against its plain version")
    kernel = phase_kernel()
    print("== small fit, card against CPU")
    phase_small_fit()
    print("== main path")
    launches = phase_main_path(card)
    print(card)
    print(json.dumps({"kernels": [dict(
        name="simplex_qp_grouped", route="cuda", source=KERNEL_SOURCE,
        replaces=KERNEL_REPLACES, launches=launches, **kernel)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
