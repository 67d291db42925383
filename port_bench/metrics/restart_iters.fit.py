"""``restart_iters.fit``: the restarts' iterations per call, the sum of
the result's ``n_iters``, over the calls run without the profiler."""

from port_bench.metrics._calls import untraced


def read(rec):
    calls = untraced(rec, "fit")
    if not calls or any(c.get("restart_iters") is None for c in calls):
        return None
    return sum(c["restart_iters"] for c in calls) / len(calls)
