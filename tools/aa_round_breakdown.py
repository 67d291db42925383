#!/usr/bin/env python3
"""Where a HadISST-scale best-of-100 AA fit and the AA transform spend
their time, read from the port's own spans and counters.

Usage, from the root of a checkout on a machine with the GPU, PyTorch
built for CUDA and ``nvcc``::

    python3 tools/aa_round_breakdown.py [--seeds 1,2,3] [--requests N]
        [--phases fit,transform] [--repo PATH] [--out FILE]

The workloads are the benchmark's: the configuration
``port_bench/configs/hadisst_scale.json`` (1788 months x 24,030 points,
float32, its data recipe) and the traffic mixes ``aa_best100`` (one
``aa_fit_restarts`` call: k = 6, best of 100 in chunks of 25, rounds of
32) and ``aa_transform`` (``ArchetypalAnalysis(6).transform`` of 1-180
held-out months, log-uniform, a host array in and the weights back).
For each seed, after a warm-up fit of 2 iterations:

1. one fit without the profiler, timed to its end, with the change of
   every counter of ``utils/profiling.counters()``: the restart slots
   the device ran and those that advanced a restart, the host reads,
   the host-to-device bytes, K1's launches;
2. one fit under ``torch.profiler`` (CPU and CUDA activity), timed the
   same way, and ``profiling.span_summary`` of its trace: for each
   ``cdr.*`` span its count, host and self time, the device time it
   launched as the innermost span and in all, and the idle time that
   began inside it.

Then the transform (``--phases`` names the phases that run): the
set-up fit (the mix's arguments, ``random_state`` the first seed),
``--requests`` requests without the profiler (their median, mean and
95th-percentile latency and the counters' change per request), then
200 requests under the profiler and their span summary.

``--repo`` imports the port from another checkout (a ``git archive`` of
another commit, to compare in one call); where its ``utils/profiling``
has no counters or spans, those parts are left out and the walls are
still timed.  Prints one JSON object a phase (the span tables left out)
and, with ``--out``, writes them all, span tables included, to that
file.  Prints the card's name and power limit first.  Exits non-zero
without a GPU.
"""

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE = "cuda"


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def load(path):
    with open(os.path.join(HERE, "port_bench", path)) as f:
        return json.load(f)


def sync():
    import torch
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def counts(profiling):
    fn = getattr(profiling, "counters", None)
    if fn is None:
        from convex_dim_red_tpu_torch.ops import simplex_qp
        return {"LAUNCHES": simplex_qp.LAUNCHES}
    return fn()


def change(before, after):
    return {k: after[k] - before[k] for k in after}


def summary(profiling, prof):
    fn = getattr(profiling, "span_summary", None)
    return None if fn is None else fn(prof)


def profiled(fn):
    """``(fn's result, its wall under the profiler, the profiler)``; the
    wall leaves out the profiler's start and its reading of the trace."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t0
    return out, wall, prof


def timed(fn, profiling):
    before = counts(profiling)
    t0 = time.perf_counter()
    out = fn()
    sync()
    wall = time.perf_counter() - t0
    return out, wall, change(before, counts(profiling))


def per_step(spans, name):
    st = spans.get(name)
    if not st or not st["count"]:
        return None
    return 1e3 * st["device_s"] / st["count"]


def fit_phase(port, profiling, X, args, seed, chunk):
    k = args["n_components"]
    rest = {a: v for a, v in args.items()
            if a not in ("n_components", "n_init")}

    def fit():
        return port.aa_fit_restarts(X, k, seed, args["n_init"], **rest)

    res, wall, cnt = timed(fit, profiling)
    launches = cnt["LAUNCHES"]
    iters = int(res["n_iters"].sum())
    out = {"phase": "fit", "seed": seed, "wall_s": wall,
           "counts": cnt, "restart_iters": iters,
           "step_ms": 1e3 * wall / launches if launches else None,
           "useful_from_launches_pct": (100.0 * iters / (chunk * launches)
                                        if launches else None)}
    if "RESTART_SLOTS" in cnt and cnt["RESTART_SLOTS"]:
        out["useful_slot_pct"] = (100.0 * cnt["RESTART_ADVANCES"]
                                  / cnt["RESTART_SLOTS"])
    _, wall_t, prof = profiled(fit)
    out["traced_wall_s"] = wall_t
    table = summary(profiling, prof)
    del prof
    if table is not None:
        spans = table["spans"]
        out["spans"] = table
        out["per_step_device_ms"] = {
            n: per_step(spans, n) for n in (
                "cdr.aa.cost", "cdr.aa.dictionary", "cdr.aa.weights",
                "cdr.restarts.iteration")}
        it = spans.get("cdr.restarts.iteration")
        if it and table["busy_s"]:
            out["iteration_share_of_busy_pct"] = (
                100.0 * it["device_total_s"] / table["busy_s"])
            out["busy_per_iteration_ms"] = 1e3 * table["busy_s"] / (
                it["count"])
    return out


def transform_phase(port, profiling, data, config, seeds, n_requests):
    import numpy as np
    import torch
    sys.path.insert(0, HERE)
    from port_bench.entries.aa_transform import request_sizes
    from port_bench.harness import recipe_of
    traffic = load("traffic/aa_transform.json")
    seed = seeds[0]
    recipe = recipe_of(config)
    bank_rows = int(traffic["bank_rows"])
    bank = recipe.held_out(data, seed + 1, bank_rows,
                           noise=config["data"]["noise"],
                           dtype=config["data"]["dtype"])
    model = port.ArchetypalAnalysis(random_state=seed, device=DEVICE,
                                    **traffic["args"])
    model.fit(torch.as_tensor(data["X"]).to(DEVICE))
    low, high = traffic["rows"]["low"], traffic["rows"]["high"]
    for r in (low, high):
        model.transform(bank[:r])[0].cpu()
    total = n_requests + 200
    sizes = request_sizes(seed, total, low, high)
    rng = np.random.RandomState((seed + 2) % 2 ** 32)
    places = (rng.uniform(size=total) * (bank_rows - sizes + 1)).astype(
        np.int64)

    def request(i):
        o, r = int(places[i]), int(sizes[i])
        w, _ = model.transform(bank[o:o + r])
        w.cpu()

    before = counts(profiling)
    walls = []
    for i in range(n_requests):
        t0 = time.perf_counter()
        request(i)
        walls.append(time.perf_counter() - t0)
    cnt = change(before, counts(profiling))
    walls.sort()
    p95 = walls[min(len(walls) - 1, int(math.ceil(0.95 * len(walls))) - 1)]
    out = {"phase": "transform", "seed": seed, "requests": n_requests,
           "p50_ms": 1e3 * statistics.median(walls), "p95_ms": 1e3 * p95,
           "mean_ms": 1e3 * statistics.fmean(walls),
           "rows_mean": float(sizes[:n_requests].mean()),
           "per_request": {k: v / n_requests for k, v in cnt.items()}}
    _, wall, prof = profiled(
        lambda: [request(i) for i in range(n_requests, total)])
    out["traced_wall_s"] = wall
    table = summary(profiling, prof)
    del prof
    if table is not None:
        out["spans"] = table
        st = table["spans"].get("cdr.transform.input")
        if st:
            out["input_p50_ms"] = 1e3 * st["host_p50_s"]
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="tools/aa_round_breakdown.py")
    p.add_argument("--seeds", default="1")
    p.add_argument("--requests", type=int, default=2000)
    p.add_argument("--phases", default="fit,transform")
    p.add_argument("--repo", default=HERE)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.repo))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import convex_dim_red_tpu_torch as port
    from convex_dim_red_tpu_torch.utils import precision, profiling
    sys.path.insert(1, HERE)
    from port_bench.harness import make_data
    config = load("configs/hadisst_scale.json")
    precision.set_matmul_precision(config["matmul_precision"])
    fit_args = dict(config["aa"], **load("traffic/aa_best100.json")["args"])
    seeds = [int(s) for s in args.seeds.split(",")]
    results = [{"card": card(), "repo": os.path.abspath(args.repo),
                "port": os.path.dirname(port.__file__)}]
    print(json.dumps(results[0]), flush=True)
    data = make_data(config, seeds[0])
    X = torch.as_tensor(data["X"]).to(DEVICE)
    k, n_init = fit_args["n_components"], fit_args["n_init"]
    rest = {a: v for a, v in fit_args.items()
            if a not in ("n_components", "n_init")}
    t0 = time.perf_counter()
    port.aa_fit_restarts(X, k, seeds[0], n_init,
                         **dict(rest, max_iterations=2))
    sync()
    results.append({"phase": "warm", "wall_s": time.perf_counter() - t0})
    phases = args.phases.split(",")
    for seed in seeds if "fit" in phases else ():
        results.append(fit_phase(port, profiling, X, fit_args, seed,
                                 int(fit_args["restart_chunk"])))
        short = {k: v for k, v in results[-1].items() if k != "spans"}
        print(json.dumps(short), flush=True)
    del X
    torch.cuda.empty_cache()
    if "transform" in phases:
        results.append(transform_phase(port, profiling, data, config,
                                       seeds, args.requests))
        short = {k: v for k, v in results[-1].items() if k != "spans"}
        print(json.dumps(short), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
