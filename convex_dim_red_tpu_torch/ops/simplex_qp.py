"""Grouped batched simplex-QP solver: the CUDA kernel and its plain
PyTorch version.

Port of convex_dim_red_tpu/ops/pallas_qp.py:
quad_simplex_qp_pallas_packed_grouped.  For every group ``r`` and row
``i`` it solves ``min 1/2 x'A_r x + b_ri'x`` over the (optionally
masked) simplex by projected spectral gradient with the exact line
search, and stops each row on the kernel's own rule (``||D|| < eps *
min(alpha, 1)`` or three stalled iterations; see csrc/simplex_qp.cu).

- :func:`quad_simplex_qp_packed_grouped` is the wrapper.  A CUDA tensor
  goes to the kernel in ``csrc/simplex_qp.cu``, which is built with
  ``nvcc`` for ``sm_90a`` at first use into ``_build/`` (the file name
  carries a hash of the source and flags) and bound with ``ctypes``.
  A CPU tensor goes to the plain version.  Each kernel launch adds one
  to :data:`LAUNCHES`.
- :func:`quad_simplex_qp_packed_grouped_reference` is the plain
  version: the same algorithm and stopping rule in PyTorch over the
  ``(R, n, k)`` batch, with per-row active masks.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = [
    "MAX_K",
    "LAUNCHES",
    "quad_simplex_qp_packed_grouped",
    "quad_simplex_qp_packed_grouped_reference",
    "load_library",
    "build_log",
]

#: Widest QP the kernel takes (the projection's active set is a 64-bit
#: mask).
MAX_K = 64

#: Kernel launches made by :func:`quad_simplex_qp_packed_grouped`.
LAUNCHES = 0

_PROJECTIONS = ("michelot", "bisect")

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "simplex_qp.cu"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
_build_log = ""


def _bisect_steps(dtype):
    # Halvings of the width-1 threshold bracket until it is below the
    # dtype's resolution.
    return 26 if dtype == torch.float32 else 52


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build csrc/simplex_qp.cu")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def load_library():
    """Build (once per source hash) and load the kernel library.

    Returns the ``ctypes`` handle.  A failed build raises with nvcc's
    output.  The build log (``-Xptxas -v``: registers, shared memory,
    spills) is kept in :func:`build_log`.
    """
    global _lib, _build_log
    if _lib is not None:
        return _lib
    source = _SOURCE.read_bytes()
    digest = hashlib.sha256(
        source + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    path = _BUILD_DIR / ("libsimplex_qp-%s.so" % digest)
    log_path = path.with_suffix(".log")
    if not path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *_NVCC_FLAGS, "-o", tmp, str(_SOURCE)],
                capture_output=True, text=True, check=False)
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed to build %s:\n%s%s"
                                   % (_SOURCE, proc.stdout, proc.stderr))
            log_path.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(str(path))
    fn = lib.simplex_qp_grouped_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_uint64, ctypes.c_int,
                   ctypes.c_double, ctypes.c_int, ctypes.c_double,
                   ctypes.c_double, ctypes.c_double, ctypes.c_double,
                   ctypes.c_int, ctypes.c_void_p]
    _build_log = log_path.read_text() if log_path.exists() else ""
    _lib = lib
    return lib


def build_log():
    """nvcc's output from the build of the loaded library ('' before
    the first load)."""
    return _build_log


def _check(As, Bs, X0s, mask, projection):
    """Validate the operands; return ``(R, n, k, bool mask on the
    host)``."""
    if projection not in _PROJECTIONS:
        raise ValueError("projection must be one of %s, got %r"
                         % (_PROJECTIONS, projection))
    if Bs.ndim != 3 or X0s.shape != Bs.shape:
        raise ValueError("Bs and X0s must both be (R, n, k); got %s and "
                         "%s" % (tuple(Bs.shape), tuple(X0s.shape)))
    R, n, k = Bs.shape
    if As.shape != (R, k, k):
        raise ValueError("As must be (R, k, k) = %s; got %s"
                         % ((R, k, k), tuple(As.shape)))
    if not 1 <= k <= MAX_K:
        raise ValueError("the grouped QP kernel takes 1 <= k <= %d, got "
                         "k = %d" % (MAX_K, k))
    dtypes = {As.dtype, Bs.dtype, X0s.dtype}
    if len(dtypes) != 1 or X0s.dtype not in (torch.float32,
                                             torch.float64):
        raise ValueError("As, Bs and X0s must share one dtype, float32 "
                         "or float64; got %s" % sorted(map(str, dtypes)))
    if len({As.device, Bs.device, X0s.device}) != 1:
        raise ValueError("As, Bs and X0s must be on one device")
    if mask is None:
        mask = torch.ones((k,), dtype=torch.bool)
    else:
        mask = torch.as_tensor(mask).detach().to("cpu", torch.bool)
        if mask.shape != (k,):
            raise ValueError("mask must have shape (%d,), got %s"
                             % (k, tuple(mask.shape)))
        if not bool(mask.any()):
            raise ValueError("mask must keep at least one component")
    return R, n, k, mask


def quad_simplex_qp_packed_grouped(As, Bs, X0s, mask=None,
                                   projection="michelot",
                                   max_iterations=1000, alpha0=-1.0,
                                   alpha_min=1e-5, alpha_max=1e3,
                                   epsilon_one=1e-10, epsilon_two=1e-6):
    """Solve ``R`` groups of ``n`` simplex QPs, one Hessian per group.

    ``As``: (R, k, k); ``Bs``/``X0s``: (R, n, k), contiguous, one dtype
    (float32 or float64), one device; ``k <= 64``.  Returns (R, n, k).
    ``mask`` ((k,) bool, shared across groups; read on the host) pins
    masked coordinates to exactly zero.  ``projection``: 'michelot'
    (exact threshold by active-set steps) or 'bisect' (26/52 halvings).

    CUDA tensors run the kernel on the current stream without
    synchronising; CPU tensors run
    :func:`quad_simplex_qp_packed_grouped_reference`.
    """
    global LAUNCHES
    R, n, k, mask_h = _check(As, Bs, X0s, mask, projection)
    kwargs = dict(max_iterations=max_iterations, alpha0=alpha0,
                  alpha_min=alpha_min, alpha_max=alpha_max,
                  epsilon_one=epsilon_one, epsilon_two=epsilon_two)
    if X0s.device.type == "cpu":
        return quad_simplex_qp_packed_grouped_reference(
            As, Bs, X0s, mask=mask, projection=projection, **kwargs)
    if X0s.device.type != "cuda":
        raise ValueError("the grouped QP kernel runs on CUDA tensors "
                         "(or its plain version on CPU ones); got %s"
                         % X0s.device)
    if not (As.is_contiguous() and Bs.is_contiguous()
            and X0s.is_contiguous()):
        raise ValueError("As, Bs and X0s must be contiguous")
    if R > 65535:
        raise ValueError("at most 65535 groups per launch, got %d" % R)
    out = torch.empty_like(X0s)
    if n == 0:
        return out
    bits = sum(1 << j for j in range(k) if bool(mask_h[j]))
    lib = load_library()
    with torch.cuda.device(X0s.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.simplex_qp_grouped_launch(
            0 if X0s.dtype == torch.float32 else 1,
            _PROJECTIONS.index(projection),
            As.data_ptr(), Bs.data_ptr(), X0s.data_ptr(), out.data_ptr(),
            R, n, k, bits, int(max_iterations), float(alpha0),
            int(alpha_min <= alpha0 <= alpha_max), float(alpha_min),
            float(alpha_max), float(epsilon_one), float(epsilon_two),
            _bisect_steps(X0s.dtype), stream)
    if err != 0:
        raise RuntimeError("simplex_qp_grouped_launch failed with code %d"
                           % err)
    LAUNCHES += 1
    return out


def _project(x, mask, projection, k, steps):
    """Row-wise projection of ``x`` (..., k) onto the masked simplex,
    the kernel's way (Michelot with ``k`` steps, or bisection)."""
    if projection == "michelot":
        act = mask.to(x.dtype).expand_as(x)

        def tau_of(act):
            s = torch.sum(x * act, dim=-1, keepdim=True)
            c = torch.clamp(torch.sum(act, dim=-1, keepdim=True), min=1.0)
            return (s - 1.0) / c

        for _ in range(k):
            act = torch.where(x > tau_of(act), act, 0.0)
        tau = tau_of(act)
    else:
        hi = torch.amax(torch.where(mask, x, -1e30), dim=-1, keepdim=True)
        lo = hi - 1.0
        for _ in range(steps):
            mid = 0.5 * (lo + hi)
            s = torch.sum(torch.where(mask, torch.clamp(x - mid, min=0.0),
                                      0.0), dim=-1, keepdim=True)
            too_big = s > 1.0
            lo = torch.where(too_big, mid, lo)
            hi = torch.where(too_big, hi, mid)
        tau = 0.5 * (lo + hi)
    return torch.where(mask, torch.clamp(x - tau, min=0.0), 0.0)


def quad_simplex_qp_packed_grouped_reference(As, Bs, X0s, mask=None,
                                             projection="michelot",
                                             max_iterations=1000,
                                             alpha0=-1.0, alpha_min=1e-5,
                                             alpha_max=1e3,
                                             epsilon_one=1e-10,
                                             epsilon_two=1e-6):
    """Plain PyTorch version of the grouped QP kernel, on any device.

    Same operands, result and stopping rule as
    :func:`quad_simplex_qp_packed_grouped`.  Every row carries its own
    active flag; a converged row is frozen (step 0, alpha unchanged), so
    its result does not depend on the other rows.
    """
    R, n, k, mask_h = _check(As, Bs, X0s, mask, projection)
    dtype = X0s.dtype
    mask = mask_h.to(X0s.device)
    steps = _bisect_steps(dtype)

    def project(v):
        return _project(v, mask, projection, k, steps)

    X = project(X0s)
    AX = torch.matmul(X, As)
    if alpha_min <= alpha0 <= alpha_max:
        alpha = torch.full((R, n, 1), alpha0, dtype=dtype,
                           device=X0s.device)
    else:
        d0 = project(X - (AX + Bs)) - X
        ainv = torch.amax(torch.where(mask, torch.abs(d0), -1e30), dim=-1,
                          keepdim=True)
        ainv = torch.where(torch.abs(ainv) < 1e-12, 1.0, ainv)
        alpha = torch.clamp(1.0 / ainv, alpha_min, alpha_max)

    active = torch.ones((R, n, 1), dtype=torch.bool, device=X0s.device)
    stall = torch.zeros((R, n, 1), dtype=dtype, device=X0s.device)
    progress_eps = 32.0 * torch.finfo(dtype).eps
    tiny = torch.finfo(dtype).tiny

    def rowsum(v):
        return torch.sum(v, dim=-1, keepdim=True)

    for _ in range(int(max_iterations)):
        if not bool(active.any()):
            break
        G = AX + Bs
        alpha_used = alpha
        D = project(X - alpha * G) - X
        AD = torch.matmul(D, As)

        delta = rowsum(D * G)
        q = rowsum(D * AD)
        safe_q = torch.where(q > 0, q, 1.0)
        lam = torch.where(q > 0, torch.clamp(-delta / safe_q, 0.0, 1.0),
                          1.0)
        lam = torch.where(active, lam, 0.0)

        X = X + lam * D
        AX = AX + lam * AD

        sksk = rowsum(D * D)
        alpha_new = torch.where(
            q > 0, torch.clamp(sksk / safe_q, alpha_min, alpha_max),
            alpha_max)
        alpha = torch.where(active, alpha_new, alpha)

        decrease = -(lam * delta + 0.5 * lam * lam * q)
        fval = torch.abs(0.5 * rowsum(X * AX) + rowsum(X * Bs))
        no_progress = decrease <= progress_eps * (fval + tiny)
        stall = torch.where(no_progress, stall + 1.0, 0.0)

        scale = torch.clamp(alpha_used, max=1.0)
        dinf = torch.amax(torch.abs(D), dim=-1, keepdim=True)
        converged = ((sksk < (epsilon_two * scale) * (epsilon_two * scale))
                     | (dinf < epsilon_one * scale) | (stall >= 3.0))
        active = active & ~converged
    # Restore exact feasibility lost to incremental-update rounding.
    return project(X)
