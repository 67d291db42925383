// Grouped batched simplex-QP solver for Hopper (sm_90a): a team of TW
// lanes per row, 1 <= k <= 64.
//
// Replaces convex_dim_red_tpu/ops/pallas_qp.py:
// quad_simplex_qp_pallas_packed_grouped (K1; body _grouped_packed_kernel
// and _packed_solve_vmem) and quad_simplex_qp_pallas_packed (K2; body
// _packed_kernel), which is K1 with one group.  For every group r and
// row i it solves
//
//     min_x  1/2 x'A_r x + b_ri'x   over the (optionally masked) simplex
//
// by projected spectral gradient with the exact line search: x <- P(x0);
// each iteration takes D = P(x - alpha g) - x with g = xA + b, the step
// lam = clip(-D.g / D.AD, 0, 1) (1 if D.AD <= 0), carries xA
// incrementally and sets alpha = clip(D.D / D.AD) (alpha_max if
// D.AD <= 0).  A row stops when ||D||_2 < eps2 min(alpha, 1) or
// ||D||_inf < eps1 min(alpha, 1) (alpha as used by that iteration, whose
// update is still applied) or after 3 iterations in a row without
// representable progress.  A final projection restores exact
// feasibility.  P is the Michelot active-set projection (at most k
// steps) or a bisection on the threshold (26 halvings in float, 52 in
// double).
//
// What bounds it on this card.  At the main-path shape (R = 25 groups,
// n = 1788 rows, k = 6, float32, 25 iterations; 13.9 iterations a row on
// average) the kernel moves 3.2 MB (1.0 us at 3.35 TB/s) and does
// 2k^2 + 25k flops a row-iteration with Michelot (2k^2 + 102k with
// bisection): 2.1 us at 67 TFLOP/s.  An empty launch of its grid takes
// 1.5 us and the kernel 39 us (PERF.md, section 6), so neither bytes nor
// FLOPs bound it: the serial chain of one row's iterations (latency), the
// issue slots of its scalar work (the divisions of the step and of the
// projection's threshold, the stopping test) and rows of one warp that
// need different iteration counts (divergence) do.
//
// What the design does about it.  A team of TW lanes (a power of two, 1
// to 32; a warp holds 32 / TW rows) owns one row: lane t holds the
// coordinates t, t + TW, t + 2 TW, ... (NC >= ceil(k / TW) of them), so
// x, xA, b, D and DA are NC registers a lane, and every loop over them is
// unrolled over NC.  Row scalars (the Michelot sum and count, delta, q,
// ||D||^2, ||D||_inf, fval) are xor-butterfly shuffles inside the team,
// which leave the same bits in every lane of it (a + b and b + a round
// alike), so every branch on a row scalar is uniform in the team.  D A
// broadcasts D_i from the lane that holds it, and each lane adds
// D_i A[i][j] for its own j, reading row i of A from shared memory,
// where the block loads its group's k x k Hessian once (consecutive
// lanes read consecutive words; other teams read the same words).  A
// team leaves its loop together when its row converges: the TPU kernel
// freezes a converged row (step 0), so a row's result never depends on
// its neighbours.  Lane t reads and writes the words base + t + c TW, so
// a warp touches contiguous runs.
//
// Which TW.  A team spends shuffles on every row scalar and runs the
// row's scalar work in each of its lanes, so on an H100 one thread a row
// (TW = 1) is the fastest while the row fits one thread's registers: 3.9x
// faster than TW = 8 at k = 6 and 3.5x at k = 16.  Above that a team is
// what keeps the row out of local memory: TW = 8 up to k = 40, TW = 16
// above (PERF.md, section 6).  team_width(k) in ops/simplex_qp.py is that
// rule; only the (TW, NC) pairs it and its sweep launch are built.  The
// lane packing of the TPU kernel (block-diagonal kron Hessian,
// segment-sum matmul, roll butterfly, padding of k) has no counterpart.
//
// Built once per dtype, with -DSIMPLEX_QP_DTYPE=0 (float32) or 1
// (float64), so that the two builds run in parallel.  Plain C interface
// for ctypes; a launch returns cudaGetLastError().

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#ifndef SIMPLEX_QP_DTYPE
#error "build with -DSIMPLEX_QP_DTYPE=0 (float32) or 1 (float64)"
#endif

namespace {

using Real = std::conditional_t<SIMPLEX_QP_DTYPE == 0, float, double>;

constexpr int kMaxThreads = 256;

// The (TW, NC) pairs built, by team width and then NC: RULE pairs, for
// both dtypes and projections, are those the rule team_width(k) of
// ops/simplex_qp.py launches; SWEEP pairs, float only, those that only
// the team-width sweep of chip_smoke.py launches.  A launch at team width
// TW takes the first pair of that width with NC >= ceil(k / TW).
#define SIMPLEX_QP_PAIRS(RULE, SWEEP)                                \
  RULE(1, 6) RULE(1, 8) RULE(1, 12) RULE(1, 16) SWEEP(2, 3) SWEEP(4, 2) \
  SWEEP(8, 1) RULE(8, 3) RULE(8, 5) SWEEP(8, 8) RULE(16, 4) SWEEP(32, 2)

template <typename T>
struct Limits;

template <>
struct Limits<float> {
  static constexpr float eps = 1.1920928955078125e-07f;
  static constexpr float tiny = 1.1754943508222875e-38f;
};

template <>
struct Limits<double> {
  static constexpr double eps = 2.220446049250313e-16;
  static constexpr double tiny = 2.2250738585072014e-308;
};

template <typename T>
__device__ __forceinline__ T clip(T v, T lo, T hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <typename T>
__device__ __forceinline__ T absv(T v) {
  return v < T(0) ? -v : v;
}

template <typename T>
__device__ __forceinline__ T max0(T v) {
  return v > T(0) ? v : T(0);
}

__device__ __forceinline__ bool has(unsigned bits, int c) {
  return (bits >> c) & 1u;
}

// The lanes of the calling thread's team: TW consecutive lanes of its
// warp, from a multiple of TW.
template <int TW>
__device__ __forceinline__ unsigned team_mask() {
  if constexpr (TW == 32) {
    return 0xffffffffu;
  } else {
    const unsigned lane = threadIdx.x & 31u;
    return ((1u << TW) - 1u) << (lane & ~unsigned(TW - 1));
  }
}

template <int TW, typename V>
__device__ __forceinline__ V team_sum(V v, unsigned tm) {
#pragma unroll
  for (int m = TW / 2; m > 0; m >>= 1) v += __shfl_xor_sync(tm, v, m);
  return v;
}

template <int TW, typename V>
__device__ __forceinline__ V team_max(V v, unsigned tm) {
#pragma unroll
  for (int m = TW / 2; m > 0; m >>= 1) {
    const V o = __shfl_xor_sync(tm, v, m);
    v = o > v ? o : v;
  }
  return v;
}

template <int TW>
__device__ __forceinline__ bool team_any(bool p, unsigned tm) {
  if constexpr (TW == 1) {
    return p;
  } else {
    return __any_sync(tm, p);
  }
}

// Number of set bits over the team (each lane holds NC of them).
template <int TW, int NC>
__device__ __forceinline__ int team_count(unsigned bits, unsigned tm) {
  if constexpr (TW == 1) {
    return __popc(bits);
  } else if constexpr (NC == 1) {
    return __popc(__ballot_sync(tm, bits & 1u) & tm);
  } else {
    return team_sum<TW>(__popc(bits), tm);
  }
}

// In-place projection of the row y (NC coordinates a lane) onto the
// simplex over the coordinates flagged in `on`; the others come out 0.
template <typename T, bool MICHELOT, int TW, int NC>
__device__ __forceinline__ void project(T (&y)[NC], unsigned on, int k,
                                        unsigned tm, int bisect_steps) {
  T tau;
  if (MICHELOT) {
    // Michelot (1986): tau = (sum_active y - 1)/|active|; drop y <= tau.
    // The JAX kernel runs k steps; once the active set stops changing,
    // every further step recomputes the same tau and set, so leaving
    // early gives the same bits.
    unsigned act = on;
    T s, c;
    for (int step = 0;; ++step) {
      s = T(0);
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        if (has(act, i)) s += y[i];
      }
      s = team_sum<TW>(s, tm);
      c = T(team_count<TW, NC>(act, tm));
      if (step == k) break;
      const T t = (s - T(1)) / (c > T(1) ? c : T(1));
      unsigned next = act;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        if (has(act, i) && !(y[i] > t)) next &= ~(1u << i);
      }
      if (!team_any<TW>(next != act, tm)) break;
      act = next;
    }
    tau = (s - T(1)) / (c > T(1) ? c : T(1));
  } else {
    T hi = T(-1e30);
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      if (has(on, i) && y[i] > hi) hi = y[i];
    }
    hi = team_max<TW>(hi, tm);
    T lo = hi - T(1);
    for (int step = 0; step < bisect_steps; ++step) {
      const T mid = T(0.5) * (lo + hi);
      T s = T(0);
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        if (has(on, i)) s += max0(y[i] - mid);
      }
      if (team_sum<TW>(s, tm) > T(1)) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
    tau = T(0.5) * (lo + hi);
  }
#pragma unroll
  for (int i = 0; i < NC; ++i) y[i] = has(on, i) ? max0(y[i] - tau) : T(0);
}

// Whether a lane reads A from shared memory in every iteration.  A lane
// of a team, or a thread with more than 8 coordinates, would otherwise
// keep its k NC values of A in registers across iterations, at more
// registers than its row's own state and fewer warps in flight; a thread
// with up to 8 keeps them (at most 64 values).
template <int TW, int NC>
__host__ __device__ constexpr bool reread_a() {
  return TW > 1 || NC > 8;
}

// Broadcasts of vec_mat in flight at a time: up to 8 loads of A a lane.
template <int TW, int NC>
__host__ __device__ constexpr int broadcast_unroll() {
  return TW * NC <= 8 ? TW : (NC >= 8 ? 1 : 8 / NC);
}

// out_j = sum_i v_i A[i][j] for the lane's coordinates j (row vector
// times A; A need not be symmetric).  v_i reaches the team from the lane
// that holds it.
template <typename T, int TW, int NC>
__device__ __forceinline__ void vec_mat(const T (&v)[NC], const T* sA,
                                        int k, int t, unsigned tm,
                                        T (&out)[NC]) {
  constexpr int kUnroll = broadcast_unroll<TW, NC>();
#pragma unroll
  for (int c = 0; c < NC; ++c) out[c] = T(0);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    // Loads of A for the next coordinate group wait for this one.
    if constexpr (NC > 1 && reread_a<TW, NC>()) {
      asm volatile("" ::: "memory");
    }
#pragma unroll (kUnroll)
    for (int s = 0; s < TW; ++s) {
      const int i = c * TW + s;
      if (i < k) {
        T vi = v[c];
        if constexpr (TW > 1) vi = __shfl_sync(tm, vi, s, TW);
        const T* row = sA + i * k;
#pragma unroll
        for (int cj = 0; cj < NC; ++cj) {
          const int j = t + cj * TW;
          if (j < k) out[cj] += vi * row[j];
        }
      }
    }
  }
}

// Whether a lane keeps its coordinates of the row's linear term b in
// registers.  A thread-per-row float64 row of more than 12 coordinates
// would need more than the 255 registers a thread has with them, so that
// pair reads b from the L1 cache where it uses it (b is read-only).
template <typename T, int TW, int NC>
__host__ __device__ constexpr bool b_in_registers() {
  return !(TW == 1 && NC > 12 && sizeof(T) == 8);
}

// At least one block an SM: without it ptxas holds a thread-per-row
// kernel to 64 registers and spills.
template <typename T, bool MICHELOT, int TW, int NC>
__global__ void __launch_bounds__(kMaxThreads, 1)
simplex_qp_grouped_kernel(const T* __restrict__ As,
                          const T* __restrict__ Bs,
                          const T* __restrict__ X0s, T* __restrict__ out,
                          int n, int k, uint64_t mask, int max_iterations,
                          T alpha0, int alpha0_in_range, T alpha_min,
                          T alpha_max, T eps1, T eps2, int bisect_steps) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sA = reinterpret_cast<T*>(smem);
  const int r = blockIdx.y;
  const int kk = k * k;
  for (int i = threadIdx.x; i < kk; i += blockDim.x) {
    sA[i] = As[static_cast<int64_t>(r) * kk + i];
  }
  __syncthreads();

  const int t = threadIdx.x % TW;
  const int row = blockIdx.x * (blockDim.x / TW) + threadIdx.x / TW;
  if (row >= n) return;  // the whole team leaves together
  const unsigned tm = team_mask<TW>();
  const int64_t base = (static_cast<int64_t>(r) * n + row) * k;

  // Bit c of `on`: coordinate t + c TW exists and is in the mask.
  unsigned on = 0;
  constexpr bool kKeepB = b_in_registers<T, TW, NC>();
  T x[NC], ax[NC], b[kKeepB ? NC : 1], d[NC], ad[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int j = t + c * TW;
    const bool in = j < k;
    if (in && ((mask >> j) & 1ull)) on |= 1u << c;
    if constexpr (kKeepB) b[c] = in ? Bs[base + j] : T(0);
    x[c] = in ? X0s[base + j] : T(0);
  }
  // Coordinate t + c TW of b (0 past k).
  auto b_at = [&](int c) -> T {
    if constexpr (kKeepB) {
      return b[c];
    } else {
      const int j = t + c * TW;
      return j < k ? __ldg(Bs + base + j) : T(0);
    }
  };
  project<T, MICHELOT, TW, NC>(x, on, k, tm, bisect_steps);
  vec_mat<T, TW, NC>(x, sA, k, t, tm, ax);

  T alpha;
  if (alpha0_in_range) {
    alpha = alpha0;
  } else {
#pragma unroll
    for (int c = 0; c < NC; ++c) d[c] = x[c] - (ax[c] + b_at(c));
    project<T, MICHELOT, TW, NC>(d, on, k, tm, bisect_steps);
    T ainv = T(0);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const T v = has(on, c) ? absv(d[c] - x[c]) : T(0);
      if (v > ainv) ainv = v;
    }
    ainv = team_max<TW>(ainv, tm);
    if (absv(ainv) < T(1e-12)) ainv = T(1);
    alpha = clip(T(1) / ainv, alpha_min, alpha_max);
  }

  const T progress_eps = T(32) * Limits<T>::eps;
  int stall = 0;
  for (int it = 0; it < max_iterations; ++it) {
    if constexpr (reread_a<TW, NC>()) asm volatile("" ::: "memory");
    // D = P(x - alpha g) - x, with g = xA + b.
#pragma unroll
    for (int c = 0; c < NC; ++c) d[c] = x[c] - alpha * (ax[c] + b_at(c));
    project<T, MICHELOT, TW, NC>(d, on, k, tm, bisect_steps);
#pragma unroll
    for (int c = 0; c < NC; ++c) d[c] -= x[c];
    vec_mat<T, TW, NC>(d, sA, k, t, tm, ad);

    T delta = T(0), q = T(0), sksk = T(0), dinf = T(0);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      delta += d[c] * (ax[c] + b_at(c));
      q += d[c] * ad[c];
      sksk += d[c] * d[c];
      const T v = absv(d[c]);
      if (v > dinf) dinf = v;
    }
    // Four butterflies side by side: the same bits as one at a time.
#pragma unroll
    for (int m = TW / 2; m > 0; m >>= 1) {
      delta += __shfl_xor_sync(tm, delta, m);
      q += __shfl_xor_sync(tm, q, m);
      sksk += __shfl_xor_sync(tm, sksk, m);
      const T o = __shfl_xor_sync(tm, dinf, m);
      dinf = o > dinf ? o : dinf;
    }

    const T lam = q > T(0) ? clip(-delta / q, T(0), T(1)) : T(1);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      x[c] += lam * d[c];
      ax[c] += lam * ad[c];
    }
    const T alpha_used = alpha;
    alpha = q > T(0) ? clip(sksk / q, alpha_min, alpha_max) : alpha_max;

    const T decrease = -(lam * delta + T(0.5) * lam * lam * q);
    T xax = T(0), xb = T(0);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      xax += x[c] * ax[c];
      xb += x[c] * b_at(c);
    }
#pragma unroll
    for (int m = TW / 2; m > 0; m >>= 1) {
      xax += __shfl_xor_sync(tm, xax, m);
      xb += __shfl_xor_sync(tm, xb, m);
    }
    const T fval = absv(T(0.5) * xax + xb);
    stall = decrease <= progress_eps * (fval + Limits<T>::tiny) ? stall + 1
                                                                 : 0;

    const T scale = alpha_used < T(1) ? alpha_used : T(1);
    if (sksk < (eps2 * scale) * (eps2 * scale) || dinf < eps1 * scale ||
        stall >= 3) {
      break;
    }
  }

  project<T, MICHELOT, TW, NC>(x, on, k, tm, bisect_steps);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int j = t + c * TW;
    if (j < k) out[base + j] = x[c];
  }
}

__global__ void empty_kernel() {}

// Blocks of `threads` lanes, threads / team rows each, over n rows and R
// groups.
dim3 grid_of(int team, int threads, int R, int n) {
  const int rows = threads / team;
  return dim3((n + rows - 1) / rows, R);
}

template <typename T, bool MICHELOT, int TW, int NC>
int launch(int threads, const void* As, const void* Bs, const void* X0s,
           void* out, int R, int n, int k, uint64_t mask,
           int max_iterations, double alpha0, int alpha0_in_range,
           double alpha_min, double alpha_max, double eps1, double eps2,
           int bisect_steps, cudaStream_t stream) {
  const size_t shared = static_cast<size_t>(k) * k * sizeof(T);
  simplex_qp_grouped_kernel<T, MICHELOT, TW, NC>
      <<<grid_of(TW, threads, R, n), threads, shared, stream>>>(
          static_cast<const T*>(As), static_cast<const T*>(Bs),
          static_cast<const T*>(X0s), static_cast<T*>(out), n, k, mask,
          max_iterations, T(alpha0), alpha0_in_range, T(alpha_min),
          T(alpha_max), T(eps1), T(eps2), bisect_steps);
  return static_cast<int>(cudaGetLastError());
}

// The first pair of SIMPLEX_QP_PAIRS at width `team` with NC >=
// ceil(k / team), or -1 where there is none.
template <typename T, bool MICHELOT>
int launch_team(int team, int threads, const void* As, const void* Bs,
                const void* X0s, void* out, int R, int n, int k,
                uint64_t mask, int max_iterations, double alpha0,
                int alpha0_in_range, double alpha_min, double alpha_max,
                double eps1, double eps2, int bisect_steps,
                cudaStream_t stream) {
  const int nc = (k + team - 1) / team;
#define SIMPLEX_QP_RULE(TW, NC)                                           \
  if (team == TW && nc <= NC) {                                           \
    return launch<T, MICHELOT, TW, NC>(                                   \
        threads, As, Bs, X0s, out, R, n, k, mask, max_iterations, alpha0, \
        alpha0_in_range, alpha_min, alpha_max, eps1, eps2, bisect_steps,  \
        stream);                                                          \
  }
#define SIMPLEX_QP_SWEEP(TW, NC)                   \
  if constexpr (std::is_same<T, float>::value) { \
    SIMPLEX_QP_RULE(TW, NC)                        \
  }
  SIMPLEX_QP_PAIRS(SIMPLEX_QP_RULE, SIMPLEX_QP_SWEEP)
#undef SIMPLEX_QP_SWEEP
#undef SIMPLEX_QP_RULE
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = float64 (that of this build, else -1).
// projection: 0 = Michelot, 1 = bisect.
// team: lanes per row (a power of two, 1 to 32); threads: lanes per
// block (a multiple of 32, at most 256).  Returns cudaGetLastError()
// after the launch, or -1 for arguments or a team width the library has
// no pair for at this k (the Python wrapper checks them first).
extern "C" int simplex_qp_grouped_launch(
    int dtype, int projection, int team, int threads, const void* As,
    const void* Bs, const void* X0s, void* out, int R, int n, int k,
    uint64_t mask, int max_iterations, double alpha0, int alpha0_in_range,
    double alpha_min, double alpha_max, double eps1, double eps2,
    int bisect_steps, void* stream) {
  if (R < 1 || R > 65535 || n < 1 || k < 1 || k > 64 || team < 1 ||
      team > 32 || (team & (team - 1)) != 0 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0) {
    return -1;
  }
  if (dtype != SIMPLEX_QP_DTYPE) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SIMPLEX_QP_ARGS                                                   \
  team, threads, As, Bs, X0s, out, R, n, k, mask, max_iterations, alpha0, \
      alpha0_in_range, alpha_min, alpha_max, eps1, eps2, bisect_steps, s
  return projection == 0 ? launch_team<Real, true>(SIMPLEX_QP_ARGS)
                         : launch_team<Real, false>(SIMPLEX_QP_ARGS);
#undef SIMPLEX_QP_ARGS
}

// An empty kernel on the grid the solver launches with (team, threads)
// over R groups of n rows: the floor that no launch beats.
extern "C" int simplex_qp_empty_launch(int team, int threads, int R, int n,
                                       void* stream) {
  if (R < 1 || R > 65535 || n < 1 || team < 1 || team > 32 ||
      threads < 32 || threads > 1024 || threads % team != 0) {
    return -1;
  }
  empty_kernel<<<grid_of(team, threads, R, n), threads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
