"""Multi-restart fits and model-selection sweeps on one device (the
mesh-sharded fits are a later slice of the port)."""

from .restarts import (aa_fit_restarts, gpnh_fit_restarts,
                       kernel_aa_fit_restarts)
from .sweep import aa_model_selection_sweep, gpnh_model_selection_sweep

__all__ = ["aa_fit_restarts", "gpnh_fit_restarts", "kernel_aa_fit_restarts",
           "aa_model_selection_sweep", "gpnh_model_selection_sweep"]
