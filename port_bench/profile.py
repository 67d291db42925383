"""Device busy time, idle gaps and the heaviest device operations of one
profiled stretch, read from ``torch.profiler``'s in-memory trace.

Busy time is the union of the intervals in which some operation (a
kernel, a copy or a memset) ran on the device, not their sum; an idle
gap is a stretch of the window that no device interval covers, and is
named by the innermost host operation open at its start.  Nothing is
written to disk.
"""

import bisect
import collections
import time

WINDOW_SPAN = "port_bench.window"
TOP = 10
#: Characters of a kernel's or an operation's name kept in a breakdown.
NAME_CHARS = 120


def _ns(event, what):
    fn = getattr(event, what + "_ns", None)
    if fn is not None:
        return int(fn())
    return int(1000 * getattr(event, what + "_us")())


def _end_ns(event):
    return _ns(event, "start") + _ns(event, "duration")


#: Kineto's activity types of work that runs on the device.
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _activity(event):
    fn = getattr(event, "activity_type", None)
    return str(fn()) if fn is not None else ""


def _on_device(event):
    """A kernel, copy or memset: by its activity type where the event
    has one, else a CUDA event that is not a span's mirror on the
    device."""
    activity = _activity(event)
    if activity:
        return activity in DEVICE_ACTIVITIES
    if not str(event.device_type()).endswith("CUDA"):
        return False
    annotation = getattr(event, "is_user_annotation", None)
    return not (annotation and annotation()) and (
        event.name() != WINDOW_SPAN)


def _on_host(event):
    return str(event.device_type()).endswith("CPU")


def union(intervals):
    """Merge ``(start, end)`` intervals; returns the sorted disjoint
    union."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def gaps(busy, start, end):
    """The stretches of ``[start, end]`` that the disjoint sorted
    ``busy`` intervals leave uncovered."""
    out, at = [], start
    for s, e in busy:
        s, e = max(s, start), min(e, end)
        if e <= s:
            continue
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if end > at:
        out.append((at, end))
    return out


def name_gaps(gap_list, host_ops):
    """The innermost host operation ``(start, end, name)`` open at each
    gap's start (the window's own span when none is)."""
    ops = sorted(host_ops)
    starts = [o[0] for o in ops]
    names = []
    stack = []
    i = 0
    for g0, _ in gap_list:
        j = bisect.bisect_right(starts, g0)
        while i < j:
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][1] <= g0:
            stack.pop()
        # Ops still open but started before an op that has closed.
        inner = next((o for o in reversed(stack) if o[1] > g0), None)
        names.append(inner[2] if inner else WINDOW_SPAN)
    return names


def summarise(events):
    """``{busy_s, window_s, idle_pct, device_ops, idle_gaps}`` of the
    trace's :data:`WINDOW_SPAN` span."""
    window = [e for e in events if e.name() == WINDOW_SPAN
              and _on_host(e)]
    if not window:
        return None
    w0, w1 = _ns(window[0], "start"), _end_ns(window[0])
    device, host = [], []
    per_op = collections.Counter()
    for e in events:
        s, d = _ns(e, "start"), _ns(e, "duration")
        if _on_device(e):
            device.append((s, s + d))
            per_op[e.name()[:NAME_CHARS]] += d
        elif _on_host(e) and e.name() != WINDOW_SPAN and d > 0:
            host.append((s, s + d, e.name()))
    busy = union(device)
    busy_ns = sum(max(0, min(e, w1) - max(s, w0)) for s, e in busy)
    idle = gaps(busy, w0, w1)
    per_gap = collections.Counter()
    for (g0, g1), name in zip(idle, name_gaps(idle, host)):
        per_gap[name[:NAME_CHARS]] += g1 - g0
    window_s = (w1 - w0) * 1e-9
    return {
        "busy_s": busy_ns * 1e-9,
        "window_s": window_s,
        "idle_pct": 100.0 * (1.0 - busy_ns * 1e-9 / window_s),
        "device_ops": [[n, v * 1e-9] for n, v in per_op.most_common(TOP)],
        "idle_gaps": [[n, v * 1e-9] for n, v in per_gap.most_common(TOP)],
    }


def profiled(fn, sync):
    """Run ``fn()`` under ``torch.profiler`` (CPU and CUDA activity)
    inside the :data:`WINDOW_SPAN` span, then ``sync()``.  Returns
    ``(fn's result, summary, seconds spent reading the trace)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            out = fn()
            sync()
    t0 = time.perf_counter()
    summary = summarise(prof.profiler.kineto_results.events())
    del prof
    torch.cuda.empty_cache()
    return out, summary, time.perf_counter() - t0
