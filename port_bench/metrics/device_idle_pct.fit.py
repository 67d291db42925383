"""``device_idle_pct.fit``: the share of the profiled call's wall that
no device operation covers (the union of their intervals)."""


def read(rec):
    if rec.get("kind") != "fit" or rec.get("profile") is None:
        return None
    return rec["profile"]["idle_pct"]
