"""Archetypal analysis: the helpers the multi-restart fit needs.

Port of the subset of convex_dim_red_tpu/models/archetypal_analysis.py
that ``parallel.restarts.aa_fit_restarts`` runs.  The estimators
(``KernelAA``, ``ArchetypalAnalysis``) and the single-fit loop are
later slices of the port.
"""

import torch

__all__ = []


def _scalar_dtype(dtype):
    """Dtype for cost and convergence scalars: the working dtype, as on
    the JAX package's production path (x64 off)."""
    return dtype


def _cost_from_parts(trace_K, CKZ, ZtZ, CKCt, alpha, n_samples):
    """AA objective 0.5 (tr K - 2 tr(D CKZ) + tr(D Z'Z D CKC'))/n from
    the k x k intermediates.  Leading axes of the operands are batch
    axes (one cost per restart)."""
    sdt = _scalar_dtype(CKZ.dtype)
    a = alpha.to(sdt)
    tr_dckz = torch.sum(
        a * torch.diagonal(CKZ, dim1=-2, dim2=-1).to(sdt), dim=-1)
    dzzd = (a[..., :, None] * ZtZ.to(sdt)) * a[..., None, :]
    tr_quad = torch.sum(dzzd * CKCt.to(sdt).transpose(-2, -1),
                        dim=(-2, -1))
    return 0.5 * (trace_K.to(sdt) - 2.0 * tr_dckz + tr_quad) / n_samples


def _spg_cfg_to_quad_kwargs(cfg):
    """Map an :class:`SPGSolverConfig` onto :func:`quad_spg` arguments.

    The nonmonotone line-search parameters have no counterpart: the AA
    subproblems are exact quadratics, so the solver minimizes each line
    segment in closed form (see solvers/spg.py:quad_spg).
    """
    alpha0 = cfg.alpha0 if cfg.alpha0 is not None else -1.0
    return dict(alpha0=alpha0, alpha_min=cfg.alpha_min,
                alpha_max=cfg.alpha_max, epsilon_one=cfg.epsilon_one,
                epsilon_two=cfg.epsilon_two,
                max_iterations=cfg.max_iterations)
