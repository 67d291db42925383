"""``k1_launches.fit``: K1 launches per call (``ops/simplex_qp.
LAUNCHES``), over the calls run without the profiler."""

from port_bench.metrics._calls import untraced


def read(rec):
    calls = untraced(rec, "fit")
    if not calls:
        return None
    return sum(c["k1_launches"] for c in calls) / len(calls)
