"""Multi-restart fits on one device (the mesh-sharded fits are a later
slice of the port)."""

from .restarts import aa_fit_restarts

__all__ = ["aa_fit_restarts"]
