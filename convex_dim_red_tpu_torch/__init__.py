"""convex_dim_red_tpu_torch: the PyTorch and CUDA port of
convex_dim_red_tpu.

The JAX package beside it is the reference.  This package keeps its
module and function names, runs on PyTorch tensors, and replaces each
Pallas TPU kernel with a kernel written by hand for NVIDIA Hopper
(``csrc/``: all four simplex-QP kernels).  It covers archetypal
analysis so far (ROADMAP.md, queue 1): the ``ArchetypalAnalysis`` and
``KernelAA`` estimators with ``transform``, the multi-restart fit with
convergence compaction, FurthestSum, and the SPG solvers they run.  It
never imports JAX.
"""

from .models.archetypal_analysis import ArchetypalAnalysis, KernelAA
from .ops.furthest_sum import furthest_sum, furthest_sum_device
from .ops.simplex_projection import (
    simplex_project,
    simplex_project_columns,
    simplex_project_masked,
    simplex_project_rows,
    simplex_project_vector,
)
from .ops.stochastic_matrices import (
    left_stochastic_matrix,
    right_stochastic_matrix,
)
from .parallel.restarts import aa_fit_restarts
from .solvers.spg import (quad_simplex_spg, quad_simplex_spg_batch,
                          quad_simplex_spg_batch_grouped, quad_spg,
                          resolve_qp_backend)
from .utils.precision import get_matmul_precision, set_matmul_precision

__version__ = "0.1.0"

__all__ = [
    "ArchetypalAnalysis",
    "KernelAA",
    "furthest_sum",
    "furthest_sum_device",
    "simplex_project",
    "simplex_project_columns",
    "simplex_project_masked",
    "simplex_project_rows",
    "simplex_project_vector",
    "left_stochastic_matrix",
    "right_stochastic_matrix",
    "aa_fit_restarts",
    "quad_spg",
    "quad_simplex_spg",
    "quad_simplex_spg_batch",
    "quad_simplex_spg_batch_grouped",
    "resolve_qp_backend",
    "get_matmul_precision",
    "set_matmul_precision",
]
