"""``k1_roofline_pct.fit``: K1 timed alone at the cell's first launch
(CUDA graph of 20 launches) against the larger of its bytes and
operations bounds (``port_bench/roofline.py``)."""


def read(rec):
    k1 = rec.get("k1")
    if rec.get("kind") != "fit" or k1 is None:
        return None
    return k1["share_pct"]
