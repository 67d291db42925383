"""``transform_p50_ms``: the median latency of the requests run without
the profiler."""

from port_bench.harness import percentile
from port_bench.metrics._calls import untraced


def read(rec):
    calls = untraced(rec, "requests")
    if not calls:
        return None
    return 1e3 * percentile([c["wall_s"] for c in calls], 50)
