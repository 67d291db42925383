"""``request_p95_ms.transform``: the 95th percentile of the latency of
every request run without the profiler, host array in to host weights
out."""

from port_bench.harness import percentile
from port_bench.metrics._calls import untraced


def read(rec):
    calls = untraced(rec, "requests")
    if not calls:
        return None
    return 1e3 * percentile([c["wall_s"] for c in calls], 95)
