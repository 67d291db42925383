#!/usr/bin/env python3
"""Where one round of the GPNH restarts spends its time on the GPU, and
which of its operations wait on the host.

Usage, on a machine with the GPU, PyTorch built for CUDA and ``nvcc``::

    python3 tools/gpnh_round_profile.py

The workload is ``chip_smoke.py``'s config 4: ``PCA(167)`` of the
732 x 8192 matrix, then 100 GPNH restarts (k = 4, lambda_W 1e-3,
rel_delta_f 1e-5, weights QP up to 1000 iterations on K1) from seed 0.
Two rounds of 32 iterations of ``sharded_aa._keep_best_loop`` run, the
first from the initial states and the second from where the first
ended, as the default ``compact_iterations=None`` runs them (one chunk
of 100 restarts).  Each round runs once to warm
up, then:

1. under ``torch.cuda.set_sync_debug_mode('warn')``: every operation
   that synchronises the host with the card, counted by the line of
   the port that called it;
2. under ``torch.profiler``: the device's busy and idle share of the
   round (its kernels' time over its wall) and its kernels by device
   time;
3. with CUDA events around it, in turns: the round as it is, and the
   round with the SVD solve replaced by
   ``torch.linalg.solve_ex(check_errors=False)``, which does not wait
   on the host (and is no substitute: it assumes a full rank), to time
   what the SVD and its host syncs cost the round.

Last, the time of one call of the dictionary solve
(``models.gpnh_convex_coding._lstsq`` on the restarts' (100, 4, 4)
systems) and of the SVD inside it, host enqueue included.

Prints the card's name and power limit first.  Exits non-zero without
a GPU.
"""

import contextlib
import os
import statistics
import subprocess
import sys
import time
import warnings
from collections import Counter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

ROUND = 32
TOP = 15
REPS = 7


def round_runner(pcs, n_init):
    """``(states, run)``: the initial states of ``n_init`` restarts and
    ``run(states) -> (states, costs, done)`` for one round."""
    import torch
    from convex_dim_red_tpu_torch.parallel import restarts
    from convex_dim_red_tpu_torch.parallel.sharded_aa import (
        _gpnh_iterate, _keep_best_loop, _Shard)
    fit = chip_smoke.GPNH_FIT
    generator = torch.Generator(device=pcs.device).manual_seed(0)
    states = restarts._init_gpnh_state(
        generator, pcs, None, n_init, n_components=chip_smoke.GPNH_K,
        init='random', n_extra_steps=10)
    iterate, cost0 = _gpnh_iterate(
        pcs, lambda_W=fit['lambda_W'], n_components=chip_smoke.GPNH_K,
        sh=_Shard(device=pcs.device),
        weights_solver_kwargs=dict(fit['weights_solver_kwargs'],
                                   backend='pallas'))

    def run(states):
        states, costs, _, _, done = _keep_best_loop(
            states, cost0(*states), iterate, tolerance=fit['tolerance'],
            criterion=fit['stopping_criterion'], max_iterations=ROUND)
        return states, costs, done

    return states, run


def sync_sites(fn):
    """Run ``fn()`` under the CUDA sync debug mode 'warn'; return a
    Counter of the port's source lines that synchronised."""
    import torch
    sites = Counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in caught:
        if "synchroniz" not in str(w.message):
            continue
        sites[(os.path.relpath(w.filename, REPO), w.lineno)] += 1
    return sites


def event_ms(fn, reps=5):
    return statistics.median(
        chip_smoke._event_ms(fn) for _ in range(reps))


@contextlib.contextmanager
def no_svd():
    """The GPNH restarts' dictionary solve by ``solve_ex`` without its
    error check, for timing only."""
    import torch
    from convex_dim_red_tpu_torch.models import gpnh_convex_coding

    def solve(a, b):
        return torch.linalg.solve_ex(a, b, check_errors=False)[0]

    original = gpnh_convex_coding._lstsq
    gpnh_convex_coding._lstsq = solve
    try:
        yield
    finally:
        gpnh_convex_coding._lstsq = original


def profile(fn, label):
    """The device's busy share of ``fn()`` (the kernels' time over the
    wall) and its kernels by device time, under ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    # Only the kernels: an operator's device time is its kernels'.
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in kernels)
    print("  %s under torch.profiler: wall %.1f ms, %d kernels, device busy "
          "%.2f ms (%.1f%%), idle %.1f%%"
          % (label, wall_us / 1e3, sum(e.count for e in kernels),
             busy_us / 1e3, 100.0 * busy_us / wall_us,
             100.0 - 100.0 * busy_us / wall_us))
    for e in kernels[:TOP]:
        print("    %6.2f%%  %9.1f us  %5d calls  %s"
              % (100.0 * e.self_device_time_total / busy_us,
                 e.self_device_time_total, e.count, e.key[:90]))


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script profiles the GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print("card: " + card)
    print("torch %s, CUDA %s" % (torch.__version__, torch.version.cuda))
    from convex_dim_red_tpu_torch import PCA
    from convex_dim_red_tpu_torch.models.gpnh_convex_coding import _lstsq
    from convex_dim_red_tpu_torch.utils.precision import (
        matmul_precision_scope)
    X = torch.as_tensor(chip_smoke.make_data(chip_smoke.GPNH_SAMPLES,
                                             chip_smoke.GPNH_FEATURES),
                        device="cuda")
    pcs = PCA(chip_smoke.PCA_MODES).fit_transform(X)
    states, run = round_runner(pcs, 100)
    with matmul_precision_scope():
        after_first = run(states)[0]
    torch.cuda.synchronize()

    for label, start in (("round 1 (iterations 1-32)", states),
                         ("round 2 (iterations 33-64)", after_first)):
        # The library's matmul precision, as the entry points set it.
        with matmul_precision_scope():
            print("== " + label)
            run(start)  # warm
            torch.cuda.synchronize()
            sites = sync_sites(lambda: run(start))
            print("  host syncs in the round: %d" % sum(sites.values()))
            for (path, line), count in sites.most_common():
                print("    %4d  %s:%d" % (count, path, line))
            _, _, done = run(start)
            print("  %d of 100 restarts done after the round"
                  % int(done.sum()))
            profile(lambda: run(start), label)
            with no_svd():
                run(start)  # warm
                sites = sync_sites(lambda: run(start))
            print("  the round with solve_ex in place of the SVD solve: %d "
                  "host syncs" % sum(sites.values()))
            # The two in turns, so that both see the same host.
            ms = {"SVD solve": [], "solve_ex": []}
            for _ in range(REPS):
                ms["SVD solve"].append(chip_smoke._event_ms(
                    lambda: run(start)))
                with no_svd():
                    ms["solve_ex"].append(chip_smoke._event_ms(
                        lambda: run(start)))
            for name, values in ms.items():
                print("  round with the %s: %.2f ms (CUDA events, median "
                      "of %d in turns; min %.2f, max %.2f)"
                      % (name, statistics.median(values), REPS,
                         min(values), max(values)))

    # The dictionary solve alone, on the restarts' systems.
    Zs = states[0]
    ZtZ = Zs.transpose(1, 2) @ Zs
    ZtX = Zs.transpose(1, 2) @ pcs
    n = pcs.shape[0]
    lhs, rhs = ZtZ / n, ZtX / n
    solve_ms = event_ms(lambda: _lstsq(lhs, rhs))
    svd_ms = event_ms(lambda: torch.linalg.svd(lhs, full_matrices=False))
    sites = sync_sites(lambda: _lstsq(lhs, rhs))
    print("== dictionary solve of 100 (4, 4) systems: %.4f ms a call "
          "(CUDA events, host enqueue included), of which the SVD %.4f ms; "
          "host syncs a call: %d %s"
          % (solve_ms, svd_ms, sum(sites.values()),
             sorted(sites.items())))


if __name__ == "__main__":
    main()
