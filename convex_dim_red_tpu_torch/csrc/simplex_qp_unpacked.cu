// Unpacked batched simplex-QP solver for Hopper (sm_90a), 1 <= k <= 128.
//
// Replaces convex_dim_red_tpu/ops/pallas_qp.py:
// quad_simplex_qp_pallas_grouped (K3; body _grouped_qp_kernel,
// _qp_solve_vmem and the bisection _masked_project) and
// quad_simplex_qp_pallas (K4; body _qp_kernel), which is K3 with one
// group.  For every group r and row i it solves
//
//     min_x  1/2 x'A_r x + b_ri'x   over the (optionally masked) simplex
//
// by projected spectral gradient with the exact line search, as
// csrc/simplex_qp.cu does, with the projection fixed to a bisection on
// the threshold (26 halvings in float, 52 in double, from
// [rowmax - 1, rowmax]).  x <- P(x0); alpha0 if it is in range, else
// clip(1 / max|P(x - g) - x|); each iteration takes D = P(x - alpha g) - x
// with g = xA + b, lam = clip(-D.g / D.AD, 0, 1) (1 if D.AD <= 0), carries
// xA incrementally and sets alpha = clip(D.D / D.AD) (alpha_max if
// D.AD <= 0).  A row stops when ||D||_2 < eps2 min(alpha, 1) or
// ||D||_inf < eps1 min(alpha, 1) (alpha as used by that iteration) or
// after 3 iterations in a row without representable progress.  A final
// projection restores exact feasibility; masked coordinates come out
// exactly 0.
//
// What bounds it on this card.  Each iteration of a row is O(k^2) flops
// (one vector-matrix product) plus 26-52 bisection steps, each a sum
// over k; the rows are independent and their data never leaves the
// chip after the first load.  At k up to 128 one thread cannot hold a
// row in registers (simplex_qp.cu gives a thread at most 16
// coordinates), so latency of the serial iteration chain and
// the width of the per-row reductions bound it, not bytes or FLOPs.
//
// What the design does about it.  One warp owns one row: lane l holds
// coordinates l, l + 32, l + 64 and l + 96 (NC = ceil(k / 32) of them),
// so x, xA, b, D and DA are NC registers a lane.  Row sums and maxima are
// xor-butterfly shuffles, which leave the same bits in every lane (a + b
// and b + a round alike), so every branch on a row scalar is uniform in
// the warp.  The product D A broadcasts D one coordinate at a time with
// a shuffle and reads row i of A from shared memory, where the block
// loads its group's k x k Hessian once (above 48 KiB, i.e. float k > 110
// and double k > 78, after opting in to the larger dynamic shared
// memory).  A warp leaves its loop when its row converges: the TPU
// kernel freezes a converged row (step 0), so a row's result never
// depends on its neighbours.  Loops over k are not unrolled.  The lane
// padding and VMEM scratch of the TPU kernel have no counterpart.
//
// Plain C interface for ctypes; the launch returns cudaGetLastError()
// (or the error of the shared-memory opt-in).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDefaultSharedBytes = 48 * 1024;

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

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    const T o = __shfl_xor_sync(kFull, v, m);
    v = o > v ? o : v;
  }
  return v;
}

// In-place projection of the row y (NC coordinates a lane) onto the
// simplex over the coordinates flagged `on`; the others come out 0.
template <typename T, int NC>
__device__ __forceinline__ void project(T (&y)[NC], const bool (&on)[NC],
                                        int bisect_steps) {
  T hi = T(-1e30);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (on[c] && y[c] > hi) hi = y[c];
  }
  hi = warp_max(hi);
  T lo = hi - T(1);
  for (int step = 0; step < bisect_steps; ++step) {
    const T mid = T(0.5) * (lo + hi);
    T s = T(0);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (on[c]) s += max0(y[c] - mid);
    }
    if (warp_sum(s) > T(1)) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const T tau = T(0.5) * (lo + hi);
#pragma unroll
  for (int c = 0; c < NC; ++c) y[c] = on[c] ? max0(y[c] - tau) : T(0);
}

// out_j = sum_i v_i A[i][j] for the lane's coordinates j (row vector
// times A; A need not be symmetric).  v_i reaches every lane by a
// shuffle from the lane that holds it.
template <typename T, int NC>
__device__ __forceinline__ void vec_mat(const T (&v)[NC], const T* sA,
                                        int k, int lane, T (&out)[NC]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) out[c] = T(0);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int first = 32 * c;
    const int count = k - first < 32 ? k - first : 32;
#pragma unroll 1
    for (int s = 0; s < count; ++s) {
      const T vi = __shfl_sync(kFull, v[c], s);
      const T* row = sA + (first + s) * k;
#pragma unroll
      for (int cj = 0; cj < NC; ++cj) {
        const int j = 32 * cj + lane;
        if (j < k) out[cj] += vi * row[j];
      }
    }
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
simplex_qp_unpacked_kernel(const T* __restrict__ As,
                           const T* __restrict__ Bs,
                           const T* __restrict__ X0s, T* __restrict__ out,
                           int n, int k, uint64_t mask_lo,
                           uint64_t mask_hi, int max_iterations, T alpha0,
                           int alpha0_in_range, T alpha_min, T alpha_max,
                           T eps1, T eps2, int bisect_steps) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sA = reinterpret_cast<T*>(smem);
  const int r = blockIdx.y;
  const int kk = k * k;
  for (int t = threadIdx.x; t < kk; t += blockDim.x) {
    sA[t] = As[static_cast<int64_t>(r) * kk + t];
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= n) return;  // the whole warp leaves together
  const int64_t base = (static_cast<int64_t>(r) * n + row) * k;

  bool on[NC];
  T x[NC], ax[NC], b[NC], d[NC], ad[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int j = 32 * c + lane;
    const uint64_t word = j < 64 ? mask_lo : mask_hi;
    on[c] = j < k && ((word >> (j & 63)) & 1ull);
    b[c] = j < k ? Bs[base + j] : T(0);
    x[c] = j < k ? X0s[base + j] : T(0);
  }
  project<T, NC>(x, on, bisect_steps);
  vec_mat<T, NC>(x, sA, k, lane, ax);

  T alpha;
  if (alpha0_in_range) {
    alpha = alpha0;
  } else {
#pragma unroll
    for (int c = 0; c < NC; ++c) d[c] = x[c] - (ax[c] + b[c]);
    project<T, NC>(d, on, bisect_steps);
    T ainv = T(0);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const T v = absv(d[c] - x[c]);
      if (v > ainv) ainv = v;
    }
    ainv = warp_max(ainv);
    if (absv(ainv) < T(1e-12)) ainv = T(1);
    alpha = clip(T(1) / ainv, alpha_min, alpha_max);
  }

  const T progress_eps = T(32) * Limits<T>::eps;
  int stall = 0;
  for (int it = 0; it < max_iterations; ++it) {
    // D = P(x - alpha g) - x, with g = xA + b.
#pragma unroll
    for (int c = 0; c < NC; ++c) d[c] = x[c] - alpha * (ax[c] + b[c]);
    project<T, NC>(d, on, bisect_steps);
#pragma unroll
    for (int c = 0; c < NC; ++c) d[c] -= x[c];
    vec_mat<T, NC>(d, sA, k, lane, ad);

    T delta = T(0), q = T(0), sksk = T(0), dinf = T(0);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      delta += d[c] * (ax[c] + b[c]);
      q += d[c] * ad[c];
      sksk += d[c] * d[c];
      const T v = absv(d[c]);
      if (v > dinf) dinf = v;
    }
    delta = warp_sum(delta);
    q = warp_sum(q);
    sksk = warp_sum(sksk);
    dinf = warp_max(dinf);

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
      xb += x[c] * b[c];
    }
    const T fval = absv(T(0.5) * warp_sum(xax) + warp_sum(xb));
    stall = decrease <= progress_eps * (fval + Limits<T>::tiny) ? stall + 1
                                                                 : 0;

    const T scale = alpha_used < T(1) ? alpha_used : T(1);
    if (sksk < (eps2 * scale) * (eps2 * scale) || dinf < eps1 * scale ||
        stall >= 3) {
      break;
    }
  }

  project<T, NC>(x, on, bisect_steps);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int j = 32 * c + lane;
    if (j < k) out[base + j] = x[c];
  }
}

template <typename T, int NC>
int launch(const void* As, const void* Bs, const void* X0s, void* out,
           int R, int n, int k, uint64_t mask_lo, uint64_t mask_hi,
           int max_iterations, double alpha0, int alpha0_in_range,
           double alpha_min, double alpha_max, double eps1, double eps2,
           int bisect_steps, cudaStream_t stream) {
  const size_t shared = static_cast<size_t>(k) * k * sizeof(T);
  if (shared > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        simplex_qp_unpacked_kernel<T, NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n + kWarps - 1) / kWarps, R);
  simplex_qp_unpacked_kernel<T, NC><<<grid, kThreads, shared, stream>>>(
      static_cast<const T*>(As), static_cast<const T*>(Bs),
      static_cast<const T*>(X0s), static_cast<T*>(out), n, k, mask_lo,
      mask_hi, max_iterations, T(alpha0), alpha0_in_range, T(alpha_min),
      T(alpha_max), T(eps1), T(eps2), bisect_steps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_k(const void* As, const void* Bs, const void* X0s, void* out,
             int R, int n, int k, uint64_t mask_lo, uint64_t mask_hi,
             int max_iterations, double alpha0, int alpha0_in_range,
             double alpha_min, double alpha_max, double eps1, double eps2,
             int bisect_steps, cudaStream_t stream) {
#define SIMPLEX_QP_UNPACKED_LAUNCH(NC)                                      \
  return launch<T, NC>(As, Bs, X0s, out, R, n, k, mask_lo, mask_hi,        \
                       max_iterations, alpha0, alpha0_in_range, alpha_min, \
                       alpha_max, eps1, eps2, bisect_steps, stream)
  if (k <= 32) {
    SIMPLEX_QP_UNPACKED_LAUNCH(1);
  } else if (k <= 64) {
    SIMPLEX_QP_UNPACKED_LAUNCH(2);
  } else if (k <= 96) {
    SIMPLEX_QP_UNPACKED_LAUNCH(3);
  } else {
    SIMPLEX_QP_UNPACKED_LAUNCH(4);
  }
#undef SIMPLEX_QP_UNPACKED_LAUNCH
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  mask_lo / mask_hi: the active
// coordinates 0-63 and 64-127 as bits.  Returns the CUDA error of the
// launch (0 on success), or -1 for arguments the kernel does not take
// (the Python wrapper checks them first).
extern "C" int simplex_qp_unpacked_launch(
    int dtype, const void* As, const void* Bs, const void* X0s, void* out,
    int R, int n, int k, uint64_t mask_lo, uint64_t mask_hi,
    int max_iterations, double alpha0, int alpha0_in_range,
    double alpha_min, double alpha_max, double eps1, double eps2,
    int bisect_steps, void* stream) {
  if (R < 1 || R > 65535 || n < 1 || k < 1 || k > 128) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_k<float>(As, Bs, X0s, out, R, n, k, mask_lo, mask_hi,
                           max_iterations, alpha0, alpha0_in_range,
                           alpha_min, alpha_max, eps1, eps2, bisect_steps,
                           s);
  }
  if (dtype == 1) {
    return launch_k<double>(As, Bs, X0s, out, R, n, k, mask_lo, mask_hi,
                            max_iterations, alpha0, alpha0_in_range,
                            alpha_min, alpha_max, eps1, eps2,
                            bisect_steps, s);
  }
  return -1;
}
