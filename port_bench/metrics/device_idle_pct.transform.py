"""``device_idle_pct.transform``: the share of the profiled requests'
wall that no device operation covers (the union of their
intervals)."""


def read(rec):
    if rec.get("kind") != "requests" or rec.get("profile") is None:
        return None
    return rec["profile"]["idle_pct"]
