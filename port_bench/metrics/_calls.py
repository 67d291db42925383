"""The calls of a run's record that ran without the profiler."""


def untraced(rec, kind):
    if rec.get("kind") != kind:
        return []
    return [c for c in rec["calls"] if not c.get("traced")]
