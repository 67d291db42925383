"""K1's share of its roofline: the operations and bytes one launch
needs, the card's published peaks, and the launch's device time.

The counting copies ``chip_smoke.py:qp_bound``: the bytes read once
(``As``, ``Bs``, ``X0s``) and written once (the result) over the HBM
rate, and ``R n I (2 k^2 + c k)`` operations over the float32 (or
float64) rate outside the tensor cores, ``I`` the mean iterations a row
takes on these operands (:mod:`.reference.row_qp`), ``c`` the operations
a coordinate of one row-iteration besides ``D A``.  The bound is the
larger of the two times.
"""

import statistics

#: Published peaks by the name ``torch.cuda.get_device_name()`` gives
#: (NVIDIA's data sheet for the H100 SXM, at its 700 W limit): HBM
#: bytes per second and FLOP/s outside the tensor cores, by dtype.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12,
                              "flops": {"float32": 67e12,
                                        "float64": 34e12}},
}

#: Operations a coordinate of one row-iteration besides ``D A``, counted
#: from csrc/simplex_qp.cu: the step (4), delta, q, ||D||^2 and
#: ||D||_inf (9), the x and xA updates (4) and fval (4).
ROW_FLOPS = 21

#: Launches one CUDA graph replays to time a launch on the device.
GRAPH_LAUNCHES = 20


def per_coordinate(projection, bisect_steps):
    """``c``: Michelot's shortest run adds 4 a coordinate, bisection 3 a
    halving and 3."""
    if projection == "michelot":
        return ROW_FLOPS + 4
    return ROW_FLOPS + 3 + 3 * bisect_steps


def counts(R, n, k, itemsize, mean_iterations, projection, bisect_steps):
    """``(bytes, operations)`` one launch at ``(R, n, k)`` needs."""
    nbytes = (3 * R * n * k + R * k * k) * itemsize
    ops = R * n * mean_iterations * (
        2 * k * k + per_coordinate(projection, bisect_steps) * k)
    return nbytes, ops


def bound_s(nbytes, ops, peaks, dtype_name):
    """``(seconds, 'bytes' or 'operations')``: the least time the card
    could take."""
    t_bytes = nbytes / peaks["bytes_per_s"]
    t_ops = ops / peaks["flops"][dtype_name]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                        "operations")


def device_s(fn, reps=5):
    """Device time of one call of ``fn``: CUDA events around a CUDA
    graph that replays :data:`GRAPH_LAUNCHES` calls, median of ``reps``
    replays, over that count."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_LAUNCHES):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e-3)
    del graph
    return statistics.median(times) / GRAPH_LAUNCHES
