"""Batched simplex-QP solvers: the CUDA kernels and their plain PyTorch
versions.

Port of the four kernels of convex_dim_red_tpu/ops/pallas_qp.py.  For
every group ``r`` and row ``i`` each solves ``min 1/2 x'A_r x + b_ri'x``
over the (optionally masked) simplex by projected spectral gradient with
the exact line search, and stops each row on the kernels' own rule
(``||D|| < eps * min(alpha, 1)`` or three stalled iterations; see
csrc/simplex_qp.cu).

- K1 :func:`quad_simplex_qp_packed_grouped` replaces
  ``quad_simplex_qp_pallas_packed_grouped`` (R groups, k <= 64);
- K2 :func:`quad_simplex_qp_packed` replaces
  ``quad_simplex_qp_pallas_packed`` (one Hessian, k <= 64);
- K3 :func:`quad_simplex_qp_grouped` replaces
  ``quad_simplex_qp_pallas_grouped`` (R groups, k <= 128);
- K4 :func:`quad_simplex_qp` replaces ``quad_simplex_qp_pallas`` (one
  Hessian, k <= 128).

- K1 and K2 run the team-per-row kernel of ``csrc/simplex_qp.cu`` (K2
  is K1 with one group): :func:`team_width` lanes solve one row, with
  the Michelot or the bisection projection.  K3 and K4 run the
  one-warp-per-row kernel of ``csrc/simplex_qp_unpacked.cu`` (K4 is K3
  with one group), bisection only, as on the TPU: its resident warps
  take rows from a per-group counter, and its threshold search takes
  two halvings a round (:func:`_bisect_threshold_search` is that
  search in PyTorch, for the tests).
- Each library is built with ``nvcc`` for ``sm_90a`` at first use into
  ``_build/`` (the file name carries a hash of the source and flags)
  and bound with ``ctypes``; ``csrc/simplex_qp.cu`` is built once per
  dtype, so that its two builds run in parallel.  A CUDA tensor goes to
  the kernel, a CPU tensor to the plain version; each wrapper adds one
  to its own launch count (:data:`LAUNCHES`, :data:`PACKED_LAUNCHES`,
  :data:`GROUPED_LAUNCHES`, :data:`UNPACKED_LAUNCHES`) per kernel launch.
- The plain versions are one loop over the ``(R, n, k)`` batch with
  per-row active masks: :func:`quad_simplex_qp_packed_grouped_reference`
  (K1, and K2 at R = 1) and :func:`quad_simplex_qp_grouped_reference`
  (the same loop with bisection and k up to 128: K3, and K4 at R = 1).
  They count the row-iterations they run in
  :data:`PLAIN_ROW_ITERATIONS` and the most iterations a row took in
  :data:`PLAIN_MAX_ROW_ITERATIONS` (that row: :data:`PLAIN_SLOWEST_ROW`).

The solver arguments of every wrapper are ``max_iterations`` (1000),
``alpha0`` (-1, i.e. from the first projected gradient), ``alpha_min``
(1e-5), ``alpha_max`` (1e3), ``epsilon_one`` (1e-10) and
``epsilon_two`` (1e-6), the JAX kernels' defaults.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import torch

from ..utils.profiling import host_read

__all__ = [
    "MAX_K",
    "UNPACKED_MAX_K",
    "LAUNCHES",
    "PACKED_LAUNCHES",
    "GROUPED_LAUNCHES",
    "UNPACKED_LAUNCHES",
    "PLAIN_ROW_ITERATIONS",
    "PLAIN_MAX_ROW_ITERATIONS",
    "PLAIN_SLOWEST_ROW",
    "PACKED_THREADS",
    "team_width",
    "quad_simplex_qp_packed_grouped",
    "quad_simplex_qp_packed",
    "quad_simplex_qp_grouped",
    "quad_simplex_qp",
    "quad_simplex_qp_packed_grouped_reference",
    "quad_simplex_qp_grouped_reference",
    "load_library",
    "load_unpacked_library",
    "build_logs",
]

#: Widest QP the packed kernels (K1, K2) take: the Michelot active set
#: is a 64-bit mask.
MAX_K = 64

#: Widest QP the unpacked kernels (K3, K4) take, as on the TPU.
UNPACKED_MAX_K = 128

#: Kernel launches made by :func:`quad_simplex_qp_packed_grouped` (K1).
LAUNCHES = 0

#: Kernel launches made by :func:`quad_simplex_qp_packed` (K2).
PACKED_LAUNCHES = 0

#: Kernel launches made by :func:`quad_simplex_qp_grouped` (K3).
GROUPED_LAUNCHES = 0

#: Kernel launches made by :func:`quad_simplex_qp` (K4).
UNPACKED_LAUNCHES = 0

#: Row-iterations run by the plain versions: over the iterations of a
#: call, the number of rows still active.  Over ``R * n`` it is the mean
#: number of iterations a row takes on that input.
PLAIN_ROW_ITERATIONS = 0

#: The most iterations one row took in a call of a plain version: the
#: largest over the calls since it was last set to 0.
PLAIN_MAX_ROW_ITERATIONS = 0

#: ``(group, row)`` of the first row that took
#: :data:`PLAIN_MAX_ROW_ITERATIONS` iterations, in the call that raised it
#: (None before any).
PLAIN_SLOWEST_ROW = None

#: Lanes per block of the K1/K2 kernel (a multiple of 32, at most 256),
#: measured on an H100 (PERF.md, section 6, team-width sweep).
PACKED_THREADS = 128

_PROJECTIONS = ("michelot", "bisect")

_SOLVER_DEFAULTS = dict(max_iterations=1000, alpha0=-1.0, alpha_min=1e-5,
                        alpha_max=1e3, epsilon_one=1e-10,
                        epsilon_two=1e-6)

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
PACKED_SOURCE = _CSRC / "simplex_qp.cu"
UNPACKED_SOURCE = _CSRC / "simplex_qp_unpacked.cu"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Argument types of the C launch functions.
_SOLVE_ARGTYPES = [ctypes.c_int, ctypes.c_double, ctypes.c_int,
                   ctypes.c_double, ctypes.c_double, ctypes.c_double,
                   ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
_PACKED_SYMBOLS = {
    # (dtype, projection, team, threads, As, Bs, X0s, out, R, n, k,
    # mask, solver arguments, stream)
    "simplex_qp_grouped_launch": ([ctypes.c_int] * 4
                                  + [ctypes.c_void_p] * 4
                                  + [ctypes.c_int] * 3 + [ctypes.c_uint64]
                                  + _SOLVE_ARGTYPES),
    # (team, threads, R, n, stream)
    "simplex_qp_empty_launch": [ctypes.c_int] * 4 + [ctypes.c_void_p],
}
_UNPACKED_SYMBOLS = {
    # (dtype, row counters, As, Bs, X0s, out, R, n, k, mask words,
    # solver arguments, stream)
    "simplex_qp_unpacked_launch": ([ctypes.c_int] + [ctypes.c_void_p] * 5
                                   + [ctypes.c_int] * 3
                                   + [ctypes.c_uint64] * 2
                                   + _SOLVE_ARGTYPES),
}

_libs = {}
_build_logs = {}


def _bisect_steps(dtype):
    # Halvings of the width-1 threshold bracket until it is below the
    # dtype's resolution.
    return 26 if dtype == torch.float32 else 52


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the kernels in csrc/")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def team_width(k):
    """Lanes that solve one row together in the K1/K2 kernel at QP width
    ``k`` (1 to 64), measured on an H100 (PERF.md, section 6, team-width
    sweep): one thread a row while its row fits its registers (k <= 16),
    else a team of 8 (k <= 40) or 16.  ``csrc/simplex_qp.cu`` builds, for
    every such ``k``, a pair ``(team_width(k), NC)`` with
    ``NC >= ceil(k / team_width(k))`` coordinates a lane."""
    k = int(k)
    return 1 if k <= 16 else (8 if k <= 40 else 16)


def _load(source, symbols, defines=()):
    """Build ``source`` with the macro ``defines`` (once per hash of the
    source and flags) and load it, with the argument types ``symbols``
    maps each C function to.  A failed build raises with nvcc's output;
    the build log (``-Xptxas -v``) is kept for :func:`build_logs`."""
    key = (source, defines)
    if key in _libs:
        return _libs[key]
    flags = _NVCC_FLAGS + tuple("-D" + d for d in defines)
    text = source.read_bytes()
    digest = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()[:16]
    path = _BUILD_DIR / ("lib%s-%s.so" % (source.stem, digest))
    log_path = path.with_suffix(".log")
    if not path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *flags, "-o", tmp, str(source)],
                capture_output=True, text=True, check=False)
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed to build %s:\n%s%s"
                                   % (source, proc.stdout, proc.stderr))
            log_path.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(str(path))
    for symbol, argtypes in symbols.items():
        fn = getattr(lib, symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    _build_logs[" ".join((source.name,) + defines)] = (
        log_path.read_text() if log_path.exists() else "")
    _libs[key] = lib
    return lib


def load_library(dtype=torch.float32):
    """Build and load ``csrc/simplex_qp.cu`` (K1, K2) for ``dtype``
    (float32 or float64); returns the ``ctypes`` handle."""
    return _load(PACKED_SOURCE, _PACKED_SYMBOLS, (
        "SIMPLEX_QP_DTYPE=%d" % (0 if dtype == torch.float32 else 1),))


def load_unpacked_library():
    """Build and load ``csrc/simplex_qp_unpacked.cu`` (K3, K4); returns
    the ``ctypes`` handle."""
    return _load(UNPACKED_SOURCE, _UNPACKED_SYMBOLS)


def build_logs():
    """nvcc's output from the build of every loaded library, by source
    name and macros."""
    return dict(_build_logs)


def _solver_args(kwargs):
    unknown = set(kwargs) - set(_SOLVER_DEFAULTS)
    if unknown:
        raise TypeError("unexpected solver arguments %s; the QP kernels "
                        "take %s" % (sorted(unknown),
                                     sorted(_SOLVER_DEFAULTS)))
    return dict(_SOLVER_DEFAULTS, **kwargs)


def _check(As, Bs, X0s, mask, projection, max_k):
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
    if not 1 <= k <= max_k:
        raise ValueError("this QP kernel takes 1 <= k <= %d, got k = %d"
                         % (max_k, k))
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
        if isinstance(mask, torch.Tensor) and mask.device.type != "cpu":
            mask = host_read(mask.detach())
        mask = torch.as_tensor(mask).detach().to("cpu", torch.bool)
        if mask.shape != (k,):
            raise ValueError("mask must have shape (%d,), got %s"
                             % (k, tuple(mask.shape)))
        if not bool(mask.any()):
            raise ValueError("mask must keep at least one component")
    return R, n, k, mask


def _single(A, B, X0):
    """The one-Hessian operands as a group of one."""
    if A.ndim != 2 or B.ndim != 2 or X0.ndim != 2:
        raise ValueError("A must be (k, k) and B, X0 (n, k); got %s, %s, "
                         "%s" % (tuple(A.shape), tuple(B.shape),
                                 tuple(X0.shape)))
    return A[None], B[None], X0[None]


def _launch(load, symbol, As, Bs, X0s, R, n, head, tail):
    """Run the C launch function ``symbol(dtype, *head, As, Bs, X0s,
    out, *tail, stream)`` of the library ``load()`` builds, on CUDA
    tensors: returns ``(out, launched)``.  Raises on any other device, on
    what the kernels do not take, and on a failed launch."""
    if X0s.device.type != "cuda":
        raise ValueError("the QP kernels run on CUDA tensors (or their "
                         "plain versions on CPU ones); got %s"
                         % X0s.device)
    if not (As.is_contiguous() and Bs.is_contiguous()
            and X0s.is_contiguous()):
        raise ValueError("As, Bs and X0s must be contiguous")
    if R > 65535:
        raise ValueError("at most 65535 groups per launch, got %d" % R)
    out = torch.empty_like(X0s)
    if n == 0:
        return out, False
    launch_fn = getattr(load(), symbol)
    with torch.cuda.device(X0s.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch_fn(
            0 if X0s.dtype == torch.float32 else 1, *head,
            As.data_ptr(), Bs.data_ptr(), X0s.data_ptr(), out.data_ptr(),
            *tail, stream)
    if err != 0:
        raise RuntimeError("%s failed with code %d" % (symbol, err))
    return out, True


def _solve_args(kw, dtype):
    return (int(kw["max_iterations"]), float(kw["alpha0"]),
            int(kw["alpha_min"] <= kw["alpha0"] <= kw["alpha_max"]),
            float(kw["alpha_min"]), float(kw["alpha_max"]),
            float(kw["epsilon_one"]), float(kw["epsilon_two"]),
            _bisect_steps(dtype))


def _mask_bits(mask_h):
    return sum(1 << j for j, on in enumerate(mask_h.tolist()) if on)


def _packed(As, Bs, X0s, mask, projection, kwargs, team=None,
            threads=None):
    """K1's kernel (``csrc/simplex_qp.cu``) or, on CPU tensors, its
    plain version.  Returns ``(out, launched)``.  ``team`` and
    ``threads`` (default :func:`team_width` and
    :data:`PACKED_THREADS`) are for the team-width sweep of
    ``chip_smoke.py``, which launches here without counting."""
    R, n, k, mask_h = _check(As, Bs, X0s, mask, projection, MAX_K)
    kw = _solver_args(kwargs)
    if X0s.device.type == "cpu":
        return _solve_plain(As, Bs, X0s, mask_h, projection, **kw), False
    team = team_width(k) if team is None else int(team)
    threads = PACKED_THREADS if threads is None else int(threads)
    return _launch(lambda: load_library(X0s.dtype),
                   "simplex_qp_grouped_launch", As, Bs, X0s,
                   R, n, (_PROJECTIONS.index(projection), team, threads),
                   (R, n, k, _mask_bits(mask_h), *_solve_args(kw, X0s.dtype)))


def _empty_launch(team, threads, R, n):
    """An empty kernel on the grid of K1's kernel at ``(team,
    threads)`` over ``R`` groups of ``n`` rows, on the current stream:
    the launch floor of the kernels' bound (``chip_smoke.py``)."""
    err = load_library().simplex_qp_empty_launch(
        int(team), int(threads), int(R), int(n),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("simplex_qp_empty_launch failed with code %d"
                           % err)


def _unpacked(As, Bs, X0s, mask, kwargs):
    """The warp-per-row kernel (``csrc/simplex_qp_unpacked.cu``) or, on
    CPU tensors, its plain version.  Returns ``(out, launched)``."""
    R, n, k, mask_h = _check(As, Bs, X0s, mask, "bisect", UNPACKED_MAX_K)
    kw = _solver_args(kwargs)
    if X0s.device.type == "cpu":
        return _solve_plain(As, Bs, X0s, mask_h, "bisect", **kw), False
    bits = _mask_bits(mask_h)
    # The per-group row counters; the launch zeroes them on the stream.
    next_row = torch.empty((R,), dtype=torch.int32, device=X0s.device)
    return _launch(load_unpacked_library, "simplex_qp_unpacked_launch",
                   As, Bs, X0s, R, n, (next_row.data_ptr(),),
                   (R, n, k, bits & (2 ** 64 - 1), bits >> 64,
                    *_solve_args(kw, X0s.dtype)))


def quad_simplex_qp_packed_grouped(As, Bs, X0s, mask=None,
                                   projection="michelot", **solver_kwargs):
    """Solve ``R`` groups of ``n`` simplex QPs, one Hessian per group
    (K1).

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
    out, launched = _packed(As, Bs, X0s, mask, projection, solver_kwargs)
    LAUNCHES += launched
    return out


def quad_simplex_qp_packed(A, B, X0, mask=None, projection="michelot",
                           **solver_kwargs):
    """Solve ``n`` simplex QPs sharing the Hessian ``A`` (K2): K1's
    kernel with one group.

    ``A``: (k, k); ``B``/``X0``: (n, k); ``k <= 64``.  Returns (n, k).
    Arguments as in :func:`quad_simplex_qp_packed_grouped`; CPU tensors
    run its plain version with one group.
    """
    global PACKED_LAUNCHES
    out, launched = _packed(*_single(A, B, X0), mask, projection,
                            solver_kwargs)
    PACKED_LAUNCHES += launched
    return out[0]


def quad_simplex_qp_grouped(As, Bs, X0s, mask=None, **solver_kwargs):
    """Solve ``R`` groups of ``n`` simplex QPs, one Hessian per group,
    with the bisection projection (K3).

    Operands as in :func:`quad_simplex_qp_packed_grouped`, with
    ``k <= 128``.  CUDA tensors run ``csrc/simplex_qp_unpacked.cu``;
    CPU tensors run :func:`quad_simplex_qp_grouped_reference`.
    """
    global GROUPED_LAUNCHES
    out, launched = _unpacked(As, Bs, X0s, mask, solver_kwargs)
    GROUPED_LAUNCHES += launched
    return out


def quad_simplex_qp(A, B, X0, mask=None, **solver_kwargs):
    """Solve ``n`` simplex QPs sharing the Hessian ``A`` with the
    bisection projection (K4): K3's kernel with one group.

    ``A``: (k, k); ``B``/``X0``: (n, k); ``k <= 128``.  Returns (n, k).
    """
    global UNPACKED_LAUNCHES
    out, launched = _unpacked(*_single(A, B, X0), mask, solver_kwargs)
    UNPACKED_LAUNCHES += launched
    return out[0]


def _project(x, mask, projection, k, steps):
    """Row-wise projection of ``x`` (..., k) onto the masked simplex,
    the kernels' way (Michelot with ``k`` steps, or bisection)."""
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
            too_big = _threshold_excess(x, mask, mid) > 1.0
            lo = torch.where(too_big, mid, lo)
            hi = torch.where(too_big, hi, mid)
        tau = 0.5 * (lo + hi)
    return torch.where(mask, torch.clamp(x - tau, min=0.0), 0.0)


def _threshold_excess(x, mask, t):
    """Row sums of ``max(x - t, 0)`` over the coordinates in ``mask``:
    above 1, the simplex threshold lies above ``t``."""
    return torch.sum(torch.where(mask, torch.clamp(x - t, min=0.0), 0.0),
                     dim=-1, keepdim=True)


#: Halvings a round of the threshold search of
#: ``csrc/simplex_qp_unpacked.cu`` (its ``kLevels``).
_SEARCH_LEVELS = 2


def _bisect_threshold_search(x, mask, steps):
    """``_project(x, mask, 'bisect', k, steps)`` with the threshold
    search of ``csrc/simplex_qp_unpacked.cu``: rounds of
    :data:`_SEARCH_LEVELS` halvings (``steps`` is a multiple of it).  A
    round evaluates the excess at every midpoint that one halving at a
    time could visit in the round's halvings, each computed as that
    bisection computes it, then walks the decision tree over them, so it
    ends on the same bracket bit for bit.  For the tests only."""
    m = _SEARCH_LEVELS
    assert steps % m == 0
    hi = torch.amax(torch.where(mask, x, -1e30), dim=-1, keepdim=True)
    lo = hi - 1.0
    for _ in range(steps // m):
        # Node n of the decision tree (heap order, root 1) halves its
        # sub-bracket; child 2n keeps the lower half (excess <= 1),
        # 2n + 1 the upper.
        node_lo, node_hi, mid, big = {1: lo}, {1: hi}, {}, {}
        for n in range(1, 2 ** m):
            mid[n] = 0.5 * (node_lo[n] + node_hi[n])
            big[n] = _threshold_excess(x, mask, mid[n]) > 1.0
            node_lo[2 * n], node_hi[2 * n] = node_lo[n], mid[n]
            node_lo[2 * n + 1], node_hi[2 * n + 1] = mid[n], node_hi[n]
        node = torch.ones_like(lo, dtype=torch.long)
        for level in range(m):
            for n in range(2 ** level, 2 ** (level + 1)):
                at = node == n
                lo = torch.where(at & big[n], mid[n], lo)
                hi = torch.where(at & ~big[n], mid[n], hi)
                node = torch.where(at, 2 * n + big[n].long(), node)
    tau = 0.5 * (lo + hi)
    return torch.where(mask, torch.clamp(x - tau, min=0.0), 0.0)


def quad_simplex_qp_packed_grouped_reference(As, Bs, X0s, mask=None,
                                             projection="michelot",
                                             **solver_kwargs):
    """Plain PyTorch version of K1 (and of K2 with one group), on any
    device.

    Same operands, result and stopping rule as
    :func:`quad_simplex_qp_packed_grouped`.  Every row carries its own
    active flag; a converged row is frozen (step 0, alpha unchanged), so
    its result does not depend on the other rows.
    """
    _, _, _, mask_h = _check(As, Bs, X0s, mask, projection, MAX_K)
    return _solve_plain(As, Bs, X0s, mask_h, projection,
                        **_solver_args(solver_kwargs))


def quad_simplex_qp_grouped_reference(As, Bs, X0s, mask=None,
                                      **solver_kwargs):
    """Plain PyTorch version of K3 (and of K4 with one group): the loop
    of :func:`quad_simplex_qp_packed_grouped_reference` with the
    bisection projection and ``k <= 128``."""
    _, _, _, mask_h = _check(As, Bs, X0s, mask, "bisect", UNPACKED_MAX_K)
    return _solve_plain(As, Bs, X0s, mask_h, "bisect",
                        **_solver_args(solver_kwargs))


def _solve_plain(As, Bs, X0s, mask_h, projection, *, max_iterations,
                 alpha0, alpha_min, alpha_max, epsilon_one, epsilon_two):
    global PLAIN_ROW_ITERATIONS, PLAIN_MAX_ROW_ITERATIONS, PLAIN_SLOWEST_ROW
    R, n, k = X0s.shape
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
    iterations = torch.zeros((R, n), dtype=torch.long, device=X0s.device)
    stall = torch.zeros((R, n, 1), dtype=dtype, device=X0s.device)
    progress_eps = 32.0 * torch.finfo(dtype).eps
    tiny = torch.finfo(dtype).tiny

    def rowsum(v):
        return torch.sum(v, dim=-1, keepdim=True)

    for _ in range(int(max_iterations)):
        n_active = int(active.sum())
        if n_active == 0:
            break
        PLAIN_ROW_ITERATIONS += n_active
        iterations += active[..., 0]
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
    if iterations.numel():
        most = int(iterations.max())
        if most > PLAIN_MAX_ROW_ITERATIONS:
            PLAIN_MAX_ROW_ITERATIONS = most
            PLAIN_SLOWEST_ROW = divmod(int(iterations.argmax()), n)
    # Restore exact feasibility lost to incremental-update rounding.
    return project(X)
