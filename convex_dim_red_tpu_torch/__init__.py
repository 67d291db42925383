"""convex_dim_red_tpu_torch: the PyTorch and CUDA port of
convex_dim_red_tpu.

The JAX package beside it is the reference.  This package keeps its
module and function names, runs on PyTorch tensors, and replaces each
Pallas TPU kernel with a kernel written by hand for NVIDIA Hopper
(``csrc/``: all four simplex-QP kernels).  It covers so far
(ROADMAP.md, queue 1): archetypal analysis (the ``ArchetypalAnalysis``
and ``KernelAA`` estimators with ``transform``, and the best-of-N fit
``aa_fit_restarts``, and ``kernel_aa_fit_restarts`` on a kernel), GPNH
convex coding (``GPNHConvexCoding`` and ``gpnh_fit_restarts``), the AA,
GPNH and k-means model-selection sweeps (``parallel.sweep``), ``PCA``,
``KMeans`` with ``gap_statistic``, FurthestSum, the SPG solvers they
run, the case-study pipelines (``pipelines``) and drivers (``cli``:
``python -m convex_dim_red_tpu_torch.cli.drivers <name> ...``).  The
best-of-N fits run under convergence compaction, in rounds of 32
iterations by default (``compact_iterations=None``, the JAX package's
one-shot default, whose results they give), or screened
(``screen_iterations``), at ``k`` or padded (``pad_components_to``).
It never imports JAX.
"""

from .models.archetypal_analysis import ArchetypalAnalysis, KernelAA
from .models.gpnh_convex_coding import GPNHConvexCoding
from .models.kmeans import KMeans, gap_statistic, kmeans_fit
from .models.pca import PCA
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
from .parallel.restarts import (aa_fit_restarts, gpnh_fit_restarts,
                                kernel_aa_fit_restarts)
from .solvers.spg import (quad_simplex_spg, quad_simplex_spg_batch,
                          quad_simplex_spg_batch_grouped, quad_spg,
                          resolve_qp_backend)
from .utils.precision import get_matmul_precision, set_matmul_precision

__version__ = "0.1.0"

__all__ = [
    "ArchetypalAnalysis",
    "KernelAA",
    "GPNHConvexCoding",
    "KMeans",
    "kmeans_fit",
    "gap_statistic",
    "PCA",
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
    "kernel_aa_fit_restarts",
    "gpnh_fit_restarts",
    "quad_spg",
    "quad_simplex_spg",
    "quad_simplex_spg_batch",
    "quad_simplex_spg_batch_grouped",
    "resolve_qp_backend",
    "get_matmul_precision",
    "set_matmul_precision",
]
