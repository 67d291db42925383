"""The port's kernels and their host-side wrappers."""

from . import residual_cost, simplex_qp

#: The kernels' launch counters, ``(module, attribute, name)``: the
#: module attribute that the kernel's wrapper advances at each launch,
#: and its name in ``utils.profiling.counters()``.  A CUDA-graph replay
#: (``parallel/iterate_graph``) adds to each what its capture counted.
LAUNCH_COUNTERS = (
    (simplex_qp, "LAUNCHES", "LAUNCHES"),
    (simplex_qp, "PACKED_LAUNCHES", "PACKED_LAUNCHES"),
    (simplex_qp, "GROUPED_LAUNCHES", "GROUPED_LAUNCHES"),
    (simplex_qp, "UNPACKED_LAUNCHES", "UNPACKED_LAUNCHES"),
    (residual_cost, "LAUNCHES", "COST_LAUNCHES"),
)
