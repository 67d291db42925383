// Grouped batched simplex-QP solver for Hopper (sm_90a).
//
// Replaces convex_dim_red_tpu/ops/pallas_qp.py:
// quad_simplex_qp_pallas_packed_grouped (body: _grouped_packed_kernel and
// _packed_solve_vmem).  For every group r and row i it solves
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
// feasibility.  P is the Michelot active-set projection (k steps) or a
// bisection on the threshold (26 halvings in float, 52 in double).
//
// What bounds it on this card.  At the main-path shape (R = 25 groups,
// n = 1788 rows, k = 6) there are R n = 44,700 independent rows: about
// 350 blocks of 128 threads over 132 SMs, and about 2 MB of input.  Each
// iteration of a row is O(k^2) flops on data that never leaves the
// thread, so neither bytes nor FLOPs bound the kernel: the serial
// dependency chain of one row's iterations (latency) and the number of
// warps in flight (occupancy) do, and rows of one warp that need
// different iteration counts leave lanes idle (divergence).
//
// What the design does about it.  One thread owns one row: x, xA, b, D
// and DA live in registers (loops over KMAX are unrolled and guarded by
// j < k), so an iteration touches memory only to read A from shared
// memory, where the block loads its group's k x k Hessian once.  There
// is no cross-thread reduction and no synchronisation inside the solve,
// and a thread leaves its loop as soon as its own row converges (a row
// the JAX kernel has frozen never changes, so the result of a row does
// not depend on its neighbours).  The lane packing of the TPU kernel
// (block-diagonal kron Hessian, segment-sum matmul, roll butterfly,
// padding of k) has no counterpart here.  At KMAX 32 and 64 the five
// per-row arrays do not fit the register budget and live in local
// memory (a per-thread stack frame); that is accepted for now (a
// warp-per-row variant is later work).
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// Loops over the k lanes of a row.  Up to KMAX 16 they are unrolled over
// KMAX and guarded by j < k, so the per-row arrays stay in registers.
// Above that they run k times without unrolling: the arrays live in
// local memory either way, and unrolling 64 x 64 guarded matvecs costs
// minutes of compile time for nothing.
#define FOR_LANES(j)                                \
  _Pragma("unroll (KMAX <= 16 ? KMAX : 1)")         \
  for (int j = 0; j < (KMAX <= 16 ? KMAX : k); ++j) \
    if (j < k)

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

__device__ __forceinline__ bool lane_on(uint64_t bits, int j) {
  return (bits >> j) & 1ull;
}

// In-place projection of y onto the simplex over the lanes set in
// `mask`; masked-out lanes come out exactly 0.
template <typename T, int KMAX, bool MICHELOT>
__device__ __forceinline__ void project(T (&y)[KMAX], int k,
                                        uint64_t mask, int bisect_steps) {
  T tau;
  if (MICHELOT) {
    // Michelot (1986): tau = (sum_active y - 1)/|active|; drop y <= tau.
    // The JAX kernel runs k steps; once the active set stops changing,
    // every further step recomputes the same tau and set, so leaving
    // early gives the same bits.
    uint64_t act = mask;
    T s = T(0), c = T(0);
    for (int step = 0; step <= k; ++step) {
      s = T(0);
      c = T(0);
      FOR_LANES(j) {
        if (lane_on(act, j)) {
          s += y[j];
          c += T(1);
        }
      }
      if (step == k) break;
      const T t = (s - T(1)) / (c > T(1) ? c : T(1));
      uint64_t next = act;
      FOR_LANES(j) {
        if (lane_on(act, j) && !(y[j] > t)) next &= ~(1ull << j);
      }
      if (next == act) break;
      act = next;
    }
    tau = (s - T(1)) / (c > T(1) ? c : T(1));
  } else {
    T hi = T(-1e30);
    FOR_LANES(j) {
      if (lane_on(mask, j) && y[j] > hi) hi = y[j];
    }
    T lo = hi - T(1);
    for (int step = 0; step < bisect_steps; ++step) {
      const T mid = T(0.5) * (lo + hi);
      T s = T(0);
      FOR_LANES(j) {
        if (lane_on(mask, j)) s += max0(y[j] - mid);
      }
      if (s > T(1)) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
    tau = T(0.5) * (lo + hi);
  }
  FOR_LANES(j) { y[j] = lane_on(mask, j) ? max0(y[j] - tau) : T(0); }
}

// out[j] = sum_i v[i] A[i][j]  (row vector times A; A need not be
// symmetric).
template <typename T, int KMAX>
__device__ __forceinline__ void vec_mat(const T (&v)[KMAX], const T* sA,
                                        int k, T (&out)[KMAX]) {
  FOR_LANES(j) {
    T acc = T(0);
    FOR_LANES(i) { acc += v[i] * sA[i * k + j]; }
    out[j] = acc;
  }
}

template <typename T, int KMAX, bool MICHELOT>
__global__ void __launch_bounds__(kThreads)
simplex_qp_grouped_kernel(const T* __restrict__ As,
                          const T* __restrict__ Bs,
                          const T* __restrict__ X0s, T* __restrict__ out,
                          int n, int k, uint64_t mask, int max_iterations,
                          T alpha0, int alpha0_in_range, T alpha_min,
                          T alpha_max, T eps1, T eps2, int bisect_steps) {
  __shared__ T sA[KMAX * KMAX];
  const int r = blockIdx.y;
  const int kk = k * k;
  for (int t = threadIdx.x; t < kk; t += blockDim.x) {
    sA[t] = As[static_cast<int64_t>(r) * kk + t];
  }
  __syncthreads();

  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int64_t base = (static_cast<int64_t>(r) * n + row) * k;

  T x[KMAX], ax[KMAX], b[KMAX], d[KMAX], ad[KMAX];
  FOR_LANES(j) {
    b[j] = Bs[base + j];
    x[j] = X0s[base + j];
  }
  project<T, KMAX, MICHELOT>(x, k, mask, bisect_steps);
  vec_mat<T, KMAX>(x, sA, k, ax);

  T alpha;
  if (alpha0_in_range) {
    alpha = alpha0;
  } else {
    FOR_LANES(j) { d[j] = x[j] - (ax[j] + b[j]); }
    project<T, KMAX, MICHELOT>(d, k, mask, bisect_steps);
    T ainv = T(0);
    FOR_LANES(j) {
      if (lane_on(mask, j)) {
        const T v = absv(d[j] - x[j]);
        if (v > ainv) ainv = v;
      }
    }
    if (absv(ainv) < T(1e-12)) ainv = T(1);
    alpha = clip(T(1) / ainv, alpha_min, alpha_max);
  }

  const T progress_eps = T(32) * Limits<T>::eps;
  int stall = 0;
  for (int it = 0; it < max_iterations; ++it) {
    // D = P(x - alpha g) - x, with g = xA + b.
    FOR_LANES(j) { d[j] = x[j] - alpha * (ax[j] + b[j]); }
    project<T, KMAX, MICHELOT>(d, k, mask, bisect_steps);
    FOR_LANES(j) { d[j] -= x[j]; }
    vec_mat<T, KMAX>(d, sA, k, ad);

    T delta = T(0), q = T(0), sksk = T(0), dinf = T(0);
    FOR_LANES(j) {
      delta += d[j] * (ax[j] + b[j]);
      q += d[j] * ad[j];
      sksk += d[j] * d[j];
      const T v = absv(d[j]);
      if (v > dinf) dinf = v;
    }
    const T lam = q > T(0) ? clip(-delta / q, T(0), T(1)) : T(1);
    FOR_LANES(j) {
      x[j] += lam * d[j];
      ax[j] += lam * ad[j];
    }
    const T alpha_used = alpha;
    alpha = q > T(0) ? clip(sksk / q, alpha_min, alpha_max) : alpha_max;

    const T decrease = -(lam * delta + T(0.5) * lam * lam * q);
    T xax = T(0), xb = T(0);
    FOR_LANES(j) {
      xax += x[j] * ax[j];
      xb += x[j] * b[j];
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

  project<T, KMAX, MICHELOT>(x, k, mask, bisect_steps);
  FOR_LANES(j) { out[base + j] = x[j]; }
}

template <typename T, int KMAX, bool MICHELOT>
void launch(const void* As, const void* Bs, const void* X0s, void* out,
            int R, int n, int k, uint64_t mask, int max_iterations,
            double alpha0, int alpha0_in_range, double alpha_min,
            double alpha_max, double eps1, double eps2, int bisect_steps,
            cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, R);
  simplex_qp_grouped_kernel<T, KMAX, MICHELOT><<<grid, kThreads, 0,
                                                  stream>>>(
      static_cast<const T*>(As), static_cast<const T*>(Bs),
      static_cast<const T*>(X0s), static_cast<T*>(out), n, k, mask,
      max_iterations, T(alpha0), alpha0_in_range, T(alpha_min),
      T(alpha_max), T(eps1), T(eps2), bisect_steps);
}

template <typename T, bool MICHELOT>
void launch_k(const void* As, const void* Bs, const void* X0s, void* out,
              int R, int n, int k, uint64_t mask, int max_iterations,
              double alpha0, int alpha0_in_range, double alpha_min,
              double alpha_max, double eps1, double eps2,
              int bisect_steps, cudaStream_t stream) {
#define SIMPLEX_QP_LAUNCH(KMAX)                                           \
  launch<T, KMAX, MICHELOT>(As, Bs, X0s, out, R, n, k, mask,              \
                            max_iterations, alpha0, alpha0_in_range,      \
                            alpha_min, alpha_max, eps1, eps2,             \
                            bisect_steps, stream)
  if (k <= 8) {
    SIMPLEX_QP_LAUNCH(8);
  } else if (k <= 16) {
    SIMPLEX_QP_LAUNCH(16);
  } else if (k <= 32) {
    SIMPLEX_QP_LAUNCH(32);
  } else {
    SIMPLEX_QP_LAUNCH(64);
  }
#undef SIMPLEX_QP_LAUNCH
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  projection: 0 = Michelot, 1 = bisect.
// Returns cudaGetLastError() after the launch, or -1 for arguments the
// kernel does not take (the Python wrapper checks them first).
extern "C" int simplex_qp_grouped_launch(
    int dtype, int projection, const void* As, const void* Bs,
    const void* X0s, void* out, int R, int n, int k, uint64_t mask,
    int max_iterations, double alpha0, int alpha0_in_range,
    double alpha_min, double alpha_max, double eps1, double eps2,
    int bisect_steps, void* stream) {
  if (R < 1 || R > 65535 || n < 1 || k < 1 || k > 64) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (projection == 0) {
      launch_k<float, true>(As, Bs, X0s, out, R, n, k, mask,
                            max_iterations, alpha0, alpha0_in_range,
                            alpha_min, alpha_max, eps1, eps2,
                            bisect_steps, s);
    } else {
      launch_k<float, false>(As, Bs, X0s, out, R, n, k, mask,
                             max_iterations, alpha0, alpha0_in_range,
                             alpha_min, alpha_max, eps1, eps2,
                             bisect_steps, s);
    }
  } else if (dtype == 1) {
    if (projection == 0) {
      launch_k<double, true>(As, Bs, X0s, out, R, n, k, mask,
                             max_iterations, alpha0, alpha0_in_range,
                             alpha_min, alpha_max, eps1, eps2,
                             bisect_steps, s);
    } else {
      launch_k<double, false>(As, Bs, X0s, out, R, n, k, mask,
                              max_iterations, alpha0, alpha0_in_range,
                              alpha_min, alpha_max, eps1, eps2,
                              bisect_steps, s);
    }
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
