"""convex_dim_red_tpu_torch: the PyTorch and CUDA port of
convex_dim_red_tpu.

The JAX package beside it is the reference.  This package keeps its
module and function names, runs on PyTorch tensors, and replaces each
Pallas TPU kernel with a kernel written by hand for NVIDIA Hopper
(``csrc/``).  It covers the multi-restart archetypal-analysis fit with
convergence compaction so far (ROADMAP.md, queue 1); it never imports
JAX.
"""

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
from .solvers.spg import quad_simplex_spg_batch_grouped, quad_spg
from .utils.precision import get_matmul_precision, set_matmul_precision

__version__ = "0.1.0"

__all__ = [
    "simplex_project",
    "simplex_project_columns",
    "simplex_project_masked",
    "simplex_project_rows",
    "simplex_project_vector",
    "left_stochastic_matrix",
    "right_stochastic_matrix",
    "aa_fit_restarts",
    "quad_spg",
    "quad_simplex_spg_batch_grouped",
    "get_matmul_precision",
    "set_matmul_precision",
]
