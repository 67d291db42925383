"""Shared model plumbing: solver configs and stopping criteria.

Port of convex_dim_red_tpu/models/_common.py.  The configs keep the
JAX package's fields and defaults, so a kwargs dict written for one
package builds the same config in the other.  ``prepare_estimator_mesh``
is not ported: the estimators' ``mesh=`` is multi-GPU work (ROADMAP.md
queue 1, item 17).
"""

from dataclasses import dataclass, fields

import torch

__all__ = [
    "QPSolverConfig",
    "SPGSolverConfig",
    "make_config",
    "STOPPING_CRITERIA",
    "has_converged",
]


@dataclass(frozen=True)
class QPSolverConfig:
    """Parameters of the simplex-QP SPG solver.

    ``backend``: 'pallas' (the JAX package's name for its fused-kernel
    route, kept so configs carry over) runs the hand-written QP kernels
    of ops/simplex_qp.py, 'xla' the row solver
    (solvers/spg.py:quad_simplex_spg), and the default 'auto' picks per
    call regime (solvers/spg.py:resolve_qp_backend): the kernels for
    one-shot and restart-grouped solves on a CUDA device, the row
    solver inside single fits and on the CPU.
    """
    backend: str = 'auto'
    gamma: float = 1e-4
    memory: int = 1
    sigma_one: float = 0.1
    sigma_two: float = 0.9
    lambda_min: float = 1e-10
    alpha0: float = -1.0
    alpha_min: float = 1e-5
    alpha_max: float = 1e3
    epsilon_one: float = 1e-10
    epsilon_two: float = 1e-6
    max_iterations: int = 1000
    max_feval: int = 2000

    def kwargs(self):
        """The solver arguments: every field but ``backend``."""
        return {f.name: getattr(self, f.name) for f in fields(self)
                if f.name != 'backend'}


@dataclass(frozen=True)
class SPGSolverConfig:
    """Parameters of the generic SPG solver."""
    gamma: float = 1e-4
    memory: int = 1
    sigma_one: float = 0.1
    sigma_two: float = 0.9
    lambda_min: float = 1e-10
    alpha0: float = None
    alpha_min: float = 1e-5
    alpha_max: float = 1e3
    epsilon_one: float = 1e-10
    epsilon_two: float = 1e-6
    use_infinity_norm: bool = True
    max_iterations: int = 10000
    max_feval: int = 1000000

    def kwargs(self):
        return {f.name: getattr(self, f.name) for f in fields(self)}


def make_config(cls, kwargs):
    """Build a solver config from a reference-style kwargs dict.

    Unknown keys are rejected so typos surface instead of silently
    falling back to defaults.
    """
    if kwargs is None:
        return cls()
    if isinstance(kwargs, cls):
        return kwargs
    valid = {f.name for f in fields(cls)}
    unknown = set(kwargs) - valid
    if unknown:
        raise ValueError(
            'Unknown solver parameters %r; valid keys: %r'
            % (sorted(unknown), sorted(valid)))
    return cls(**kwargs)


STOPPING_CRITERIA = ('abs_delta_f', 'rel_delta_f')


def has_converged(old_cost, new_cost, tolerance, criterion):
    """Elementwise stopping test on cost tensors (reference
    ``_get_stopping_criteria``, archetypal_analysis.py:177-197)."""
    if criterion == 'abs_delta_f':
        return torch.abs(new_cost - old_cost) < tolerance
    if criterion == 'rel_delta_f':
        max_cost = torch.maximum(torch.abs(new_cost), torch.abs(old_cost))
        return torch.abs((new_cost - old_cost) / max_cost) < tolerance
    raise ValueError("unsupported stopping criterion '%s'" % criterion)
