"""``fit_s``: the window's whole time over the calls it holds; the
window is a whole number of calls, each ended by a synchronize."""


def read(rec):
    if rec.get("kind") != "fit" or not rec["calls"]:
        return None
    return rec["window_s"] / len(rec["calls"])
