"""One run of one cell: set-up, the measured window, the per-layer
readings, the reference's verdict and the result line.

Everything that belongs to one piece is found by name:

- the cell in ``BENCHMARK.json``'s ``workloads``;
- its configuration in ``port_bench/configs/<config>.json`` (the data
  recipe and the deployment's settings) and the recipe in
  ``port_bench/recipes/<recipe>.py``;
- its traffic mix in ``port_bench/traffic/<traffic>.json``, which names
  the entry it drives, found in ``port_bench/entries/<entry>.py``;
- its limits in ``port_bench/limits/<cell>.json``;
- each metric's reader in ``port_bench/metrics/<metric>.py``.
"""

import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: Top-level modules that may not be loaded in a run's process: JAX and
#: the JAX package (compared whole: the port's name begins with it).
FORBIDDEN = ("jax", "jaxlib", "flax", "convex_dim_red_tpu")


class Refused(Exception):
    """A run that may print no result: no card, too few cards, or a
    forbidden module loaded."""


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    """The module at ``path`` (a file whose name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark(root=ROOT):
    return load_json(Path(root) / "BENCHMARK.json")


def find(items, name, what):
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError("no %s named %r" % (what, name))


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name is in :data:`FORBIDDEN`."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def metrics_of(spec, cell_name, per_layer):
    """The metrics a cell reports: with ``per_layer`` its per-layer
    metrics, else its end-to-end ones.  A metric without ``workloads``
    goes to every cell; a per-layer one without it to every cell that
    reports the end-to-end metric it moves."""
    e2e = [m for m in spec["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if not per_layer:
        return e2e
    moved = {m["name"] for m in e2e}

    def reported(m):
        if "workloads" in m:
            return cell_name in m["workloads"]
        return m["moves"] in moved

    return [m for m in spec["per_layer"] if reported(m)]


def read_metrics(metrics, rec):
    """Each metric's reader applied to the run's record; a reader that
    finds nothing returns None and the metric is left out."""
    out = {}
    for m in metrics:
        reader = load_module(HERE / "metrics" / (m["name"] + ".py"),
                             "port_bench_metric_" + m["name"])
        value = reader.read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(numbers, limits):
    """``(correct, checks)``: every number that has a limit, beside it.
    A limit whose number the run did not give fails."""
    checks, correct = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        ok = value is not None and math.isfinite(value) and value <= limit
        correct &= ok
        checks[name] = {"value": value, "limit": limit}
    return correct, checks


def call_seed(seed, i):
    """The seed of a window's ``i``-th call, drawn from the run's seed:
    each call fits from initial states of its own, so a run's mean is
    over several fits and not one."""
    import numpy as np
    state = np.random.SeedSequence([int(seed) % 2 ** 63, int(i)])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(2))


def percentile(values, q):
    """The ``q``-th percentile of ``values``, linear between the order
    statistics (numpy's default)."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class Context:
    """What an entry is given: the cell, its configuration and traffic,
    the seed, the device and the data the recipe made."""

    def __init__(self, cell, config, traffic, seed, device, data, rank=0,
                 world=1):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.device, self.data = seed, device, data
        #: This process' place among the cell's processes, one a card.
        self.rank, self.world = rank, world
        #: The entry's arguments: the configuration's protocol group the
        #: traffic names, with the traffic's own arguments over it.
        self.args = dict(config.get(traffic.get("protocol"), {}),
                         **traffic.get("args", {}))


def recipe_of(config):
    """The data recipe module a configuration names."""
    return load_module(HERE / "recipes" / (config["data"]["recipe"]
                                           + ".py"), "port_bench_recipe")


def make_data(config, seed):
    """The configuration's inputs, made by its recipe from ``seed``."""
    data = dict(config["data"])
    del data["recipe"]
    return recipe_of(config).make(seed, **data)


def window(entry, seconds, sync, trace, clock=time.perf_counter):
    """Run ``entry.call()`` back to back until ``seconds`` have passed;
    the call running then completes and counts.  With ``trace`` the
    first ``entry.traced_calls`` calls run under the profiler.  Returns
    the record's window part."""
    from . import profile
    calls, profile_summary, profile_read_s = [], None, 0.0
    start = clock()
    n_traced = entry.traced_calls if trace else 0
    if n_traced:
        def traced():
            return [timed(entry, sync, clock) for _ in range(n_traced)]
        # The profiler's own reading of the trace is not window time.
        first, profile_summary, profile_read_s = profile.profiled(traced,
                                                                  sync)
        for c in first:
            c["traced"] = True
        calls.extend(first)
    while not calls or clock() - start - profile_read_s < seconds:
        calls.append(timed(entry, sync, clock))
    end = clock()
    return {"window_s": end - start - profile_read_s, "calls": calls,
            "profile": profile_summary}


def timed(entry, sync, clock):
    t0 = clock()
    info = entry.call()
    sync()
    info = dict(info or {})
    info["wall_s"] = clock() - t0
    info.setdefault("traced", False)
    return info


def k1_roofline(entry, device_name):
    """K1 timed alone at the cell's first launch, and its share of the
    bound there, or None where the cell has no K1 launch or the card's
    peaks are not in the table."""
    from . import roofline
    from .reference import row_qp
    launch = getattr(entry, "k1_launch", None)
    peaks = roofline.PEAKS.get(device_name)
    if launch is None or peaks is None:
        return None
    kernel, args, kw = launch
    As, Bs, X0s = args
    solver_kw = {k: v for k, v in kw.items()
                 if k not in ("mask", "projection")}
    projection = kw.get("projection", "michelot")
    _, iterations = row_qp.solve(As, Bs, X0s, mask=kw.get("mask"),
                                 projection=projection, **solver_kw)
    mean_it = float(iterations.double().mean())
    R, n, k = Bs.shape
    nbytes, ops = roofline.counts(R, n, k, Bs.element_size(), mean_it,
                                  projection,
                                  row_qp.bisect_steps(Bs.dtype))
    dtype_name = str(Bs.dtype).split(".")[-1]
    bound, by = roofline.bound_s(nbytes, ops, peaks, dtype_name)
    dev = roofline.device_s(lambda: kernel(*args, **kw))
    return {"shape": [R, n, k], "mean_iterations": mean_it,
            "bytes": nbytes, "operations": ops, "bound_s": bound,
            "bound_by": by, "device_s": dev,
            "share_pct": 100.0 * bound / dev}


def check_cards(chips):
    """Raise :class:`Refused` where there is no card or fewer than
    ``chips``."""
    import torch
    if not torch.cuda.is_available():
        raise Refused("no CUDA device is available")
    if torch.cuda.device_count() < chips:
        raise Refused("the cell needs %d cards, %d are visible"
                      % (chips, torch.cuda.device_count()))


def power_limit():
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out or None


def run_cell(cell_name, seed, seconds, trace, *, t_start, root=ROOT,
             files=HERE, device="cuda", control=False, require_card=True,
             entry_hook=None, rank=0, world=1):
    """One run of ``cell_name``; returns ``(result line, record, numbers
    the reference gave, one text line for each compared number)``.

    ``root`` holds ``BENCHMARK.json`` and ``files`` the ``configs``,
    ``traffic`` and ``limits`` folders.  ``require_card`` False skips the
    look for a card (the tests run the rest of a run on the CPU);
    ``control`` runs the program's own TF32 path (the control of the
    comparison); ``entry_hook(entry)`` lets a test break the timed path
    underneath.  ``rank`` of ``world`` is this process' place in a cell
    on several cards (:func:`launch`); it runs on card ``rank``."""
    import torch
    spec = benchmark(root)
    cell = find(spec["workloads"], cell_name, "workload")
    chips = int(cell["chips"])
    cuda = device == "cuda"
    if cuda and world > 1:
        device = "cuda:%d" % rank
        torch.cuda.set_device(rank)
    if require_card:
        check_cards(chips)
    files = Path(files)
    config = load_json(files / "configs" / (cell["config"] + ".json"))
    traffic = load_json(files / "traffic" / (cell["traffic"] + ".json"))
    limits = load_json(files / "limits" / (cell_name + ".json"))
    from convex_dim_red_tpu_torch.utils import precision
    precision.set_matmul_precision(
        "tensorfloat32" if control else config["matmul_precision"])

    def sync():
        if cuda:
            torch.cuda.synchronize()

    parts = {"imports_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    data = make_data(config, seed)
    parts["data_s"] = time.perf_counter() - t
    t = time.perf_counter()
    ctx = Context(cell, config, traffic, seed, torch.device(device), data,
                  rank, world)
    entry = load_module(HERE / "entries" / (traffic["entry"] + ".py"),
                        "port_bench_entry").prepare(ctx)
    if entry_hook is not None:
        entry_hook(entry)
    parts["prepare_s"] = time.perf_counter() - t
    t = time.perf_counter()
    entry.warm()
    sync()
    parts["warm_s"] = time.perf_counter() - t
    setup_peak = 0
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    t_window = time.perf_counter()
    rec = window(entry, seconds, sync, trace)
    leftover = forbidden_modules()
    if leftover:
        raise Refused("forbidden modules loaded: %s" % ", ".join(leftover))
    rec.update(kind=entry.kind, setup_s=t_window - t_start,
               setup_parts=parts)
    rec["peak_window_bytes"] = (torch.cuda.max_memory_allocated()
                                if cuda else 0)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(rank) if cuda
                   else "cpu",
                   "count": chips,
                   "memory_peak_bytes": max(setup_peak,
                                            rec["peak_window_bytes"])}
    rec["k1"] = k1_roofline(entry, device_info["kind"]) if (
        trace and cuda) else None
    metrics = read_metrics(metrics_of(spec, cell_name, bool(trace)), rec)

    entry.free()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = entry.check()
    rec["check_s"] = time.perf_counter() - t
    correct, checks = judge(numbers, limits)
    result = {"correct": bool(correct), "attempted": len(rec["calls"]),
              "failed": 0, "metrics": metrics, "device": device_info}
    if trace and rec["profile"] is not None:
        device_info["busy_s"] = rec["profile"]["busy_s"]
        device_info["window_s"] = rec["profile"]["window_s"]
        result["breakdown"] = {"device_ops": rec["profile"]["device_ops"],
                               "idle_gaps": rec["profile"]["idle_gaps"]}
    result["checks"] = checks
    lines = ["%s %.6g (limit %.6g)%s" % (
        name, c["value"] if c["value"] is not None else float("nan"),
        c["limit"], "" if c["value"] is not None
        and c["value"] <= c["limit"] else "  FAILS")
        for name, c in checks.items()]
    return result, rec, numbers, lines


def env_defaults(root=ROOT):
    """Keep every build and kernel cache inside the checkout, at fixed
    paths (the port builds its kernels into its own ``_build/``).
    Called before torch is imported."""
    cache = Path(root) / ".port_bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, queue, cell_name, seed, seconds, trace,
               t_start, kw):
    import torch
    import torch.distributed as dist
    backend = "nccl" if kw.get("device", "cuda") == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method="tcp://localhost:%d"
                            % port, world_size=world, rank=rank)
    try:
        out = run_cell(cell_name, seed, seconds, trace, t_start=t_start,
                       rank=rank, world=world, **kw)
        queue.put((rank, out[0], out[2], out[3], out[1]["setup_parts"]))
    except Refused as err:
        queue.put((rank, None, str(err), None, None))
    finally:
        dist.destroy_process_group()


def launch(cell_name, seed, seconds, trace, *, t_start, chips, timeout,
           **kw):
    """A cell on ``chips`` cards: one process a card, started with
    ``spawn`` and joined to one process group
    (``tcp://localhost:<free port>``), each running :func:`run_cell` as
    ``rank`` of ``chips``.  Returns rank 0's :func:`run_cell` output,
    with the peak memory of the fullest card, the device's busy time
    averaged over the cards, and ``correct`` only where every rank's
    is."""
    import multiprocessing
    mp = multiprocessing.get_context("spawn")
    queue = mp.Queue()
    port = _free_port()
    procs = [mp.Process(target=_rank_main, args=(
        r, chips, port, queue, cell_name, seed, seconds, trace, t_start,
        kw)) for r in range(chips)]
    for p in procs:
        p.start()
    outs = {}
    try:
        for _ in range(chips):
            rank, *rest = queue.get(timeout=timeout)
            outs[rank] = rest
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join()
    for rank, (result, detail, _, _) in sorted(outs.items()):
        if result is None:
            raise Refused("rank %d: %s" % (rank, detail))
    result, numbers, lines, parts = outs[0]
    results = [outs[r][0] for r in range(chips)]
    result["correct"] = all(r["correct"] for r in results)
    result["device"]["memory_peak_bytes"] = max(
        r["device"]["memory_peak_bytes"] for r in results)
    for key in ("busy_s", "window_s"):
        if key in result["device"]:
            result["device"][key] = sum(
                r["device"][key] for r in results) / chips
    return result, {"setup_parts": parts}, numbers, lines
