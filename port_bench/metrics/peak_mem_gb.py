"""``peak_mem_gb``: ``torch.cuda.max_memory_allocated()`` over the
window (reset after set-up), in GB."""


def read(rec):
    return rec["peak_window_bytes"] / 1e9 if rec["peak_window_bytes"] \
        else None
