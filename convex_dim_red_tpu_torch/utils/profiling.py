"""Tracing: spans, counters, a device trace, and timing that waits for
the card.

Port of convex_dim_red_tpu/utils/profiling.py, and the port's one
tracing module.

- :func:`span` names a stretch of the program ``cdr.<layer>.<step>``.
  While a ``torch.profiler`` runs it is a ``record_function`` range, an
  event of the same trace as the kernels and copies it launches, on
  their clock; otherwise it is one shared no-op context that allocates
  nothing and reads nothing from the device.
- :func:`trace` runs ``torch.profiler`` over a block and writes the
  trace to a directory: the spans are on while it runs.
  :func:`span_summary` reads the spans out of a profiler's trace: each
  span's host time and the device time of the work launched inside
  it.
- The counters (:data:`RESTART_SLOTS`, :data:`RESTART_ADVANCES`,
  :data:`HOST_READS`, :data:`H2D_BYTES`, :data:`GRAPH_CAPTURES`,
  :data:`GRAPH_REPLAYS`) are host integers, always on, added to where
  the work happens and never read from the device, as
  ``ops/simplex_qp.LAUNCHES`` is.  :func:`counters` takes a snapshot of
  them and of the kernels' launch counts.
- :func:`block_and_time` times a call to its result on the card.
"""

import contextlib
import os
import statistics
import time

import torch

__all__ = ["span", "trace", "span_summary", "counters", "host_read",
           "to_device", "block_and_time", "RESTART_SLOTS",
           "RESTART_ADVANCES", "HOST_READS", "H2D_BYTES",
           "GRAPH_CAPTURES", "GRAPH_REPLAYS"]

#: Restart-iterations the device ran: every iteration of a batched
#: restart loop adds the batch's width, tiled duplicates and restarts
#: already frozen included.
RESTART_SLOTS = 0

#: Restart-iterations that advanced a distinct restart that had not yet
#: converged (the restarts' ``n_iters``, summed).
RESTART_ADVANCES = 0

#: Blocking reads of a tensor on the host on the fit, solver and
#: transform paths, one a tensor read (:func:`host_read`).
HOST_READS = 0

#: Bytes copied from the host to a CUDA device by :func:`to_device`: an
#: entry point's host data, a draw off a host generator, the restart
#: scheduler's index tensors.
H2D_BYTES = 0

#: Restart-loop iterations captured as a CUDA graph
#: (``parallel/iterate_graph.StepGraphs``): one a chunk shape and fit.
GRAPH_CAPTURES = 0

#: Restart-loop iterations run as a replay of such a graph: a fit's
#: chunk-iterations less those that ran eagerly.
GRAPH_REPLAYS = 0

_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name):
    """A context naming the enclosed work ``name`` in a running
    profiler's trace; the shared no-op context when none runs."""
    if _enabled():
        return torch.profiler.record_function(name)
    return _OFF


def host_read(t):
    """A tensor ``t`` on the host, counted in :data:`HOST_READS`: its
    number (``t.item()``) if it has no axes, else ``t.cpu()``.  On a
    card the host waits here for the work that makes ``t``.  Anything
    else is returned as it is, uncounted.  Raises ``RuntimeError`` while
    the current CUDA stream is capturing a graph, where no read can
    wait for its work."""
    global HOST_READS
    if not isinstance(t, torch.Tensor):
        return t
    if torch.cuda.is_initialized() and \
            torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "host_read while the current CUDA stream is capturing a "
            "graph: the captured work reads the host, so it cannot be a "
            "graph (parallel/iterate_graph.capturable)")
    HOST_READS += 1
    return t.item() if t.dim() == 0 else t.cpu()


def to_device(data, device):
    """``data`` (a tensor, an array, a list) as a tensor on ``device``,
    in its own dtype (``torch.as_tensor``); the bytes that go from the
    host to a CUDA device count in :data:`H2D_BYTES`."""
    global H2D_BYTES
    if isinstance(data, torch.Tensor):
        out = data.to(device)
        if out.is_cuda and not data.is_cuda:
            H2D_BYTES += out.numel() * out.element_size()
        return out
    out = torch.as_tensor(data, device=device)
    if out.is_cuda:
        H2D_BYTES += out.numel() * out.element_size()
    return out


def counters():
    """A snapshot of the port's counters: the six of this module and the
    kernels' launch counts (``ops.LAUNCH_COUNTERS``), by name."""
    from ..ops import LAUNCH_COUNTERS
    snap = {"RESTART_SLOTS": RESTART_SLOTS,
            "RESTART_ADVANCES": RESTART_ADVANCES,
            "HOST_READS": HOST_READS,
            "H2D_BYTES": H2D_BYTES,
            "GRAPH_CAPTURES": GRAPH_CAPTURES,
            "GRAPH_REPLAYS": GRAPH_REPLAYS}
    snap.update((name, getattr(module, attribute))
                for module, attribute, name in LAUNCH_COUNTERS)
    return snap


#: The prefix of the program's span names.
SPAN_PREFIX = "cdr."
#: Kineto's activity types of work on the device, and of the host calls
#: that launch it.
_DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CALLS = ("cuda_runtime", "cuda_driver")


def _innermost(times, spans):
    """For each of ``times``, the index in ``spans`` (``(start, end,
    name)`` ranges of one thread, so any two are nested or disjoint) of
    the innermost one open then (``start <= t < end``), or None; and
    each span's parent, the innermost span that holds it, or None."""
    order = sorted(range(len(spans)),
                   key=lambda i: (spans[i][0], -spans[i][1]))
    parents, stack = [None] * len(spans), []
    for i in order:
        while stack and spans[stack[-1]][1] <= spans[i][0]:
            stack.pop()
        parents[i] = stack[-1] if stack else None
        stack.append(i)
    where, stack, k = [None] * len(times), [], 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while k < len(order) and spans[order[k]][0] <= t:
            while stack and spans[stack[-1]][1] <= spans[order[k]][0]:
                stack.pop()
            stack.append(order[k])
            k += 1
        while stack and spans[stack[-1]][1] <= t:
            stack.pop()
        where[q] = stack[-1] if stack else None
    return where, parents


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _activity(event):
    fn = getattr(event, "activity_type", None)
    return str(fn()) if fn is not None else ""


def _on_host(event):
    return str(event.device_type()).endswith("CPU")


def _device_work(event, activity):
    """A kernel, copy or memset: by its activity type where the trace
    gives one, else an event on the device that mirrors no host range."""
    if activity:
        return activity in _DEVICE_WORK
    annotation = getattr(event, "is_user_annotation", None)
    return (not _on_host(event) and not (annotation and annotation())
            and not event.name().startswith(SPAN_PREFIX))


def _launch_call(event, activity):
    """A CUDA runtime or driver call (``cudaLaunchKernel``,
    ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...)."""
    if activity:
        return activity in _LAUNCH_CALLS
    return event.name().startswith("cu") and "::" not in event.name()


def span_summary(prof):
    """The program's spans in a stopped ``torch.profiler`` run: ``prof``
    the profiler (as :func:`trace` yields it) or its Kineto events.

    Returns ``{"spans": {name: stats}, "traced_s", "busy_s",
    "unattributed_s", "unmatched_s"}``.  For each span name, ``stats``
    holds its ``count``; ``host_s``, its summed host duration, and
    ``host_p50_s``, the median; ``self_s``, host time less what its
    child spans cover; ``device_s``, the device work (kernels, copies,
    memsets, matched to their launch by correlation id) launched while
    it was the innermost span open; ``device_total_s``, that launched
    while any span of that name was open; and ``idle_s``, the stretches
    inside a root span (one with no parent) in which the device ran
    nothing, by the innermost span open at each one's start.
    ``traced_s`` sums the root spans, ``busy_s`` the device's busy time
    inside them (a union of intervals).  Device time launched outside
    every span, or whose launch the trace lacks (``unmatched_s``), is
    ``unattributed_s``."""
    events = prof.profiler.kineto_results.events() if hasattr(
        prof, "profiler") else prof
    # A device operation's linked id is that of the host operation that
    # launched it (an aten op), else its own id is its launch call's.
    spans, host_ops, launches, ops = [], {}, {}, []
    for e in events:
        start, dur = int(e.start_ns()), int(e.duration_ns())
        activity = _activity(e)
        linked, corr = int(e.linked_correlation_id()), int(e.correlation_id())
        if _device_work(e, activity):
            ops.append((start, start + dur, linked, corr))
        elif not _on_host(e):
            continue
        elif e.name().startswith(SPAN_PREFIX):
            spans.append((start, start + dur, e.name()))
        elif _launch_call(e, activity):
            launches[corr] = start
        elif not linked:
            host_ops[corr] = start
    launch_at = [host_ops.get(linked) if linked in host_ops
                 else launches.get(corr) for _, _, linked, corr in ops]
    where, parents = _innermost(
        [-1 if t is None else t for t in launch_at], spans)

    stats = {}
    for i, (s, e, name) in enumerate(spans):
        st = stats.setdefault(name, {"count": 0, "host": [], "child": 0,
                                     "device": 0, "total": 0, "idle": 0})
        st["count"] += 1
        st["host"].append(e - s)
        if parents[i] is not None:
            stats[spans[parents[i]][2]]["child"] += e - s
    outside = unmatched = 0
    for (s, e, _, _), t, i in zip(ops, launch_at, where):
        if i is None:
            outside += e - s
            unmatched += (e - s) if t is None else 0
            continue
        stats[spans[i][2]]["device"] += e - s
        named = set()
        while i is not None:
            if spans[i][2] not in named:
                named.add(spans[i][2])
                stats[spans[i][2]]["total"] += e - s
            i = parents[i]

    roots = [(s, e) for (s, e, _), p in zip(spans, parents) if p is None]
    busy = _union([(s, e) for s, e, _, _ in ops])
    busy_ns, idle = 0, []
    for r0, r1 in roots:
        at = r0
        for s, e in busy:
            s, e = max(s, r0), min(e, r1)
            if e <= s:
                continue
            busy_ns += e - s
            if s > at:
                idle.append((at, s))
            at = max(at, e)
        if r1 > at:
            idle.append((at, r1))
    gap_at, _ = _innermost([g0 for g0, _ in idle], spans)
    for (g0, g1), i in zip(idle, gap_at):
        stats[spans[i][2]]["idle"] += g1 - g0

    table = {name: {"count": st["count"],
                    "host_s": sum(st["host"]) * 1e-9,
                    "host_p50_s": statistics.median(st["host"]) * 1e-9,
                    "self_s": (sum(st["host"]) - st["child"]) * 1e-9,
                    "device_s": st["device"] * 1e-9,
                    "device_total_s": st["total"] * 1e-9,
                    "idle_s": st["idle"] * 1e-9}
             for name, st in sorted(stats.items())}
    return {"spans": table,
            "traced_s": sum(e - s for s, e in roots) * 1e-9,
            "busy_s": busy_ns * 1e-9,
            "unattributed_s": outside * 1e-9,
            "unmatched_s": unmatched * 1e-9}


@contextlib.contextmanager
def trace(log_dir):
    """Trace the enclosed work with ``torch.profiler`` (CPU activity,
    and CUDA activity where a card is present), the port's spans
    included, and write the trace into ``log_dir`` as a
    ``*.pt.trace.json`` file (view it in TensorBoard's profiler plugin
    or Perfetto).  Yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(log_dir))) as prof:
        yield prof


def _on_card(result):
    """Whether ``result`` (a tensor, or a tuple, list or dict of them)
    holds a tensor on a CUDA device."""
    if isinstance(result, torch.Tensor):
        return result.is_cuda
    if isinstance(result, dict):
        return any(_on_card(v) for v in result.values())
    if isinstance(result, (tuple, list)):
        return any(_on_card(v) for v in result)
    return False


def _block(result):
    if _on_card(result):
        torch.cuda.synchronize()
    return result


def block_and_time(fn, *args, repeats=1, **kwargs):
    """Run ``fn`` ``repeats`` times, waiting for the card when its result
    lies there (``torch.cuda.synchronize()``); returns ``(result,
    seconds_per_call)``, the first (warm-up) call excluded."""
    result = _block(fn(*args, **kwargs))
    start = time.perf_counter()
    for _ in range(repeats):
        result = _block(fn(*args, **kwargs))
    return result, (time.perf_counter() - start) / max(repeats, 1)
