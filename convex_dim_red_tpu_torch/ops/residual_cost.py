"""The AA residual cost's sums of squares: the CUDA kernel (K5) and its
plain PyTorch version.

For every restart ``r``, :func:`residual_sq_sums` gives
``s_r = sum_ij ((Z_r diag(alpha_r) CX_r)_ij - X_ij)^2``, the residual
form of the restart-batched AA cost (``parallel/sharded_aa.py``:
``0.5 psum(s) / n_samples``).

- On CUDA tensors it runs ``csrc/residual_cost.cu``, which reads ``X``
  tile by tile and never forms the ``(R, n, d)`` residual; it replaces no
  TPU kernel (the JAX package leaves the sum to XLA's fusion).  The
  library is built with ``nvcc`` for ``sm_90a`` at first use, once per
  dtype, by the loader of ``ops/simplex_qp`` (K1's builds start beside
  it), and bound with ``ctypes``.  Each launch adds one to
  :data:`LAUNCHES`.
- On CPU tensors it runs :func:`residual_sq_sums_reference`, the plain
  version: the product, the subtraction, the square and the sum as
  PyTorch operations.
"""

import ctypes
import threading

import torch

from . import simplex_qp

__all__ = ["LAUNCHES", "residual_sq_sums", "residual_sq_sums_reference",
           "load_library"]

#: Kernel launches made by :func:`residual_sq_sums` (K5).
LAUNCHES = 0

SOURCE = simplex_qp._CSRC / "residual_cost.cu"
_SYMBOLS = {
    # (n, d)
    "residual_cost_tiles": [ctypes.c_int] * 2,
    # (dtype, X, Z, CX, alpha, partial, out, R, n, d, k, stream)
    "residual_cost_launch": ([ctypes.c_int] + [ctypes.c_void_p] * 6
                             + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
}
_DTYPES = (torch.float32, torch.float64)
# The loaded library of each dtype.
_loaded = {}


def load_library(dtype=torch.float32):
    """Build and load ``csrc/residual_cost.cu`` (K5) for ``dtype``
    (float32 or float64); returns the ``ctypes`` handle.  The first call
    for a dtype builds K1's library of that dtype beside it, in another
    thread: the AA iterate launches both."""
    lib = _loaded.get(dtype)
    if lib is None:
        beside = threading.Thread(target=_build_k1, args=(dtype,))
        beside.start()
        try:
            lib = simplex_qp._load(SOURCE, _SYMBOLS, (
                "RESIDUAL_COST_DTYPE=%d" % _DTYPES.index(dtype),))
        finally:
            beside.join()
        _loaded[dtype] = lib
    return lib


def _build_k1(dtype):
    try:
        simplex_qp.load_library(dtype)
    except (RuntimeError, OSError):  # K1's own first call raises it again
        pass


def _check(X, Z, CX, alpha):
    """Validate the operands; return ``(R, n, d, k)``."""
    if X.ndim != 2 or Z.ndim != 3 or CX.ndim != 3 or alpha.ndim != 2:
        raise ValueError(
            "X must be (n, d), Z (R, n, k), CX (R, k, d) and alpha (R, k); "
            "got %s, %s, %s, %s" % tuple(
                tuple(t.shape) for t in (X, Z, CX, alpha)))
    n, d = X.shape
    R, _, k = Z.shape
    if (Z.shape != (R, n, k) or CX.shape != (R, k, d)
            or alpha.shape != (R, k)):
        raise ValueError(
            "with X (%d, %d) and Z of %d restarts and k = %d, Z must be "
            "%s, CX %s and alpha %s; got %s, %s, %s"
            % (n, d, R, k, (R, n, k), (R, k, d), (R, k), tuple(Z.shape),
               tuple(CX.shape), tuple(alpha.shape)))
    dtypes = {t.dtype for t in (X, Z, CX, alpha)}
    if len(dtypes) != 1 or X.dtype not in _DTYPES:
        raise ValueError("X, Z, CX and alpha must share one dtype, float32 "
                         "or float64; got %s" % sorted(map(str, dtypes)))
    if len({t.device for t in (X, Z, CX, alpha)}) != 1:
        raise ValueError("X, Z, CX and alpha must be on one device")
    return R, n, d, k


def residual_sq_sums(X, Z, CX, alpha):
    """``s_r = ||Z_r diag(alpha_r) CX_r - X||_F^2`` for each restart
    ``r`` (K5), in the operands' dtype.

    ``X``: (n, d); ``Z``: (R, n, k); ``CX``: (R, k, d); ``alpha``:
    (R, k); one dtype (float32 or float64), one device.  CUDA tensors
    must be contiguous and run the kernel on the current stream without
    synchronising (the sums are taken in float64 in a fixed order, so
    equal inputs give equal bits); CPU tensors run
    :func:`residual_sq_sums_reference`.  Returns (R,).
    """
    global LAUNCHES
    R, n, d, k = _check(X, Z, CX, alpha)
    if X.device.type == "cpu":
        return residual_sq_sums_reference(X, Z, CX, alpha)
    if X.device.type != "cuda":
        raise ValueError("K5 runs on CUDA tensors (or its plain version on "
                         "CPU ones); got %s" % X.device)
    if not all(t.is_contiguous() for t in (X, Z, CX, alpha)):
        raise ValueError("X, Z, CX and alpha must be contiguous")
    if k == 0:
        raise ValueError("K5 takes k >= 1 components")
    if R == 0 or n == 0 or d == 0:
        return torch.zeros((R,), dtype=X.dtype, device=X.device)
    with torch.cuda.device(X.device):
        lib = load_library(X.dtype)
        tiles = lib.residual_cost_tiles(n, d)
        if tiles < 1:
            raise ValueError("K5 takes at most 2**31 - 1 tiles, got n = %d "
                             "and d = %d" % (n, d))
        partial = torch.empty((R, tiles), dtype=torch.float64,
                              device=X.device)
        out = torch.empty((R,), dtype=X.dtype, device=X.device)
        err = lib.residual_cost_launch(
            _DTYPES.index(X.dtype), X.data_ptr(), Z.data_ptr(),
            CX.data_ptr(), alpha.data_ptr(), partial.data_ptr(),
            out.data_ptr(), R, n, d, k,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("residual_cost_launch failed with code %d" % err)
    LAUNCHES += 1
    return out


def residual_sq_sums_reference(X, Z, CX, alpha):
    """Plain PyTorch version of K5, on any device: the residual
    ``Z (alpha * CX) - X`` formed whole, squared and summed over each
    restart."""
    resid = Z @ (alpha[:, :, None] * CX)
    # In place: the (R, n, d) residual is the largest buffer of the fit.
    resid -= X
    resid.square_()
    return torch.sum(resid, dim=(1, 2))
