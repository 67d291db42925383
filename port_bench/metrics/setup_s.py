"""``setup_s``: seconds from the process' start to the first timed call
(imports, the data, the kernel library's load or build, warm-up)."""


def read(rec):
    return rec["setup_s"]
