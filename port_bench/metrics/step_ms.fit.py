"""``step_ms.fit``: one chunk-iteration (dictionary step, weights QPs,
cost, stop read): the calls' wall over their K1 launches (one a
chunk-iteration), over the calls run without the profiler."""

from port_bench.metrics._calls import untraced


def read(rec):
    calls = untraced(rec, "fit")
    launches = sum(c["k1_launches"] for c in calls)
    if not launches:
        return None
    return 1e3 * sum(c["wall_s"] for c in calls) / launches
