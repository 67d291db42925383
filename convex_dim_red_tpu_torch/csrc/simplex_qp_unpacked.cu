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
// row in registers, so one warp owns a row, and a row is a chain of
// dependent iterations: a launch lasts at least as long as its slowest
// row's chain, set by the latency of the warp's reductions and of the
// product D A, not by bytes or flops.  When the rows outnumber the
// resident warps (K3 at k = 96: 7152 rows, 4224 warps), the warps share
// each SM's issue slots and shared-memory pipe instead: there the
// instructions an iteration takes (about 1,800 at k = 96) bound it.
//
// What the design does about it.  Lane l holds coordinates l, l + 32,
// l + 64 and l + 96 (NC = ceil(k / 32) of them), so x, xA, b, D and DA
// are NC registers a lane; row sums and maxima are xor-butterfly
// shuffles, which leave the same bits in every lane (a + b and b + a
// round alike), so every branch on a row scalar is uniform in the warp.
// Three parts shorten the chain, and none changes a bit of the result:
//
// 1. The threshold search takes kLevels halvings a round: it sums
//    max(y - t, 0) at the 2^kLevels - 1 midpoints that the sequential
//    bisection could visit in its next kLevels steps (each computed as
//    that bisection computes it, 0.5 (lo + hi) of its sub-bracket), then
//    walks the decision tree over those sums, so it takes the same
//    decisions and ends on the same bracket.  The sums are reduced
//    together (transpose_sum): the first xor stages halve the values a
//    lane holds, so a round costs 2^kLevels - 1 + 5 - kLevels shuffles
//    on a chain of 5 instead of 5 kLevels on a chain of 5 kLevels, and
//    each sum adds the same pairs in the same order as warp_sum.  A
//    ballot hands every lane the decisions.
// 2. D A reads D from the warp's slice of shared memory (written once,
//    then read as broadcast 16-byte loads), not by a shuffle per
//    coordinate; rows of A are 32 NC wide, so a lane's loads of a row
//    sit at constant offsets, and the loop, unrolled 16 rows deep,
//    issues the loads of D_i and of row i of A ahead of the FMAs.  Each
//    output is still one accumulator summed over i = 0 .. k-1 in order.
// 3. Only as many blocks are launched as can be resident, spread over
//    the R groups; each loads its group's A once into shared memory, and
//    each warp takes the next row of its group from a per-group counter
//    until the group is exhausted, so a slow row holds one warp, not a
//    block of a second wave.  The counters are zeroed on the launch's
//    stream by the launch itself, so a replayed CUDA graph starts anew.
//    Rows are independent (a converged row leaves its loop), so a row's
//    result does not depend on which warp solved it.
//
// Two halvings a round and 64 registers a thread (four blocks an SM) in
// float up to k = 96 measured fastest on an H100 (PERF.md).
//
// Plain C interface for ctypes; the launch returns the first CUDA error
// of the shared-memory opt-in, the occupancy query, the counters' reset
// or the launch.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDefaultSharedBytes = 48 * 1024;
// Halvings a round of the threshold search; the bisection's step count
// (26 or 52) must be a multiple of it.
constexpr int kLevels = 2;

template <typename T>
struct Limits;

template <>
struct Limits<float> {
  static constexpr float eps = 1.1920928955078125e-07f;
  static constexpr float tiny = 1.1754943508222875e-38f;
  static __device__ __forceinline__ float neg_inf() {
    return __int_as_float(0xff800000);
  }
};

template <>
struct Limits<double> {
  static constexpr double eps = 2.220446049250313e-16;
  static constexpr double tiny = 2.2250738585072014e-308;
  static __device__ __forceinline__ double neg_inf() {
    return __longlong_as_double(0xfff0000000000000ll);
  }
};

// 16-byte shared-memory loads of T, for the broadcast of D, and their
// parts.  In PTX, so that the compiler does not split them into scalar
// loads (it does so for a vector load whose parts are used one by one).
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  using type = float4;
  static __device__ __forceinline__ float4 load_shared(const float* p) {
    float4 v;
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
    return v;
  }
  static __device__ __forceinline__ float part(const float4& v, int u) {
    return u == 0 ? v.x : (u == 1 ? v.y : (u == 2 ? v.z : v.w));
  }
};

template <>
struct Vec<double> {
  using type = double2;
  static __device__ __forceinline__ double2 load_shared(const double* p) {
    double2 v;
    asm volatile("ld.shared.v2.f64 {%0, %1}, [%2];"
                 : "=d"(v.x), "=d"(v.y)
                 : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
    return v;
  }
  static __device__ __forceinline__ double part(const double2& v, int u) {
    return u == 0 ? v.x : v.y;
  }
};

template <typename T>
struct Solver {
  int max_iterations;
  T alpha0;
  int alpha0_in_range;
  T alpha_min, alpha_max, eps1, eps2;
  int bisect_steps;
};

__host__ __device__ constexpr int round_up16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

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

// The warp sums of v[0 .. 2^M - 1] (one value a candidate), each with
// warp_sum's bits.  In xor stage s < M a lane keeps the half of its
// values that bit 4 - s of its lane index selects and sends the other
// half to its partner, which keeps that half: each kept value becomes
// own + partner's, the pair warp_sum adds at that stage.  The last 5 - M
// stages are warp_sum's.  Returns the sum of candidate lane >> (5 - M).
template <typename T, int M>
__device__ __forceinline__ T transpose_sum(T (&v)[1 << M], int lane) {
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int m = 16 >> s;
    if (s < M) {
      const int half = (1 << M) >> (s + 1);
      const bool upper = (lane & m) != 0;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const T send = upper ? v[i] : v[i + half];
        const T keep = upper ? v[i + half] : v[i];
        v[i] = keep + __shfl_xor_sync(kFull, send, m);
      }
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], m);
    }
  }
  return v[0];
}

// kLevels halvings of the bracket [lo, hi] of the threshold of ym (the
// row with its masked coordinates at -inf, where max(y - t, 0) adds an
// exact 0), taking the decisions one halving at a time would take.  Node
// n of the round's decision tree (heap order, root 1) halves its own
// sub-bracket; its children 2n (sum <= 1: hi = mid) and 2n + 1 (sum > 1:
// lo = mid) halve the two halves.
template <typename T, int NC>
__device__ __forceinline__ void search_round(const T (&ym)[NC], T& lo,
                                             T& hi, int lane) {
  constexpr int C = (1 << kLevels) - 1;
  T node_lo[C + 1], node_hi[C + 1], mid[C + 1];
  node_lo[1] = lo;
  node_hi[1] = hi;
#pragma unroll
  for (int n = 1; n <= C; ++n) {
    mid[n] = T(0.5) * (node_lo[n] + node_hi[n]);
    if (2 * n <= C) {
      node_lo[2 * n] = node_lo[n];
      node_hi[2 * n] = mid[n];
      node_lo[2 * n + 1] = mid[n];
      node_hi[2 * n + 1] = node_hi[n];
    }
  }
  // Each sum starts from its first term: 0 + t = t exactly for t >= +0.
  T sums[C + 1];
#pragma unroll
  for (int n = 1; n <= C; ++n) {
    T s = max0(ym[0] - mid[n]);
#pragma unroll
    for (int c = 1; c < NC; ++c) s += max0(ym[c] - mid[n]);
    sums[n - 1] = s;
  }
  sums[C] = T(0);
  const unsigned big =
      __ballot_sync(kFull, transpose_sum<T, kLevels>(sums, lane) > T(1));
  int node = 1;
#pragma unroll
  for (int level = 0; level < kLevels; ++level) {
    // mid[node], with constant indices only (no local memory).
    T m = mid[1];
#pragma unroll
    for (int j = 2; j <= C; ++j) {
      if (node == j) m = mid[j];
    }
    if ((big >> ((node - 1) << (5 - kLevels))) & 1u) {
      lo = m;
      node = 2 * node + 1;
    } else {
      hi = m;
      node = 2 * node;
    }
  }
}

// In-place projection of the row y (NC coordinates a lane) onto the
// simplex over the coordinates flagged `on`; the others come out 0.
template <typename T, int NC>
__device__ __forceinline__ void project(T (&y)[NC], const bool (&on)[NC],
                                        int bisect_steps, int lane) {
  T hi = T(-1e30);
  T ym[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (on[c] && y[c] > hi) hi = y[c];
    ym[c] = on[c] ? y[c] : Limits<T>::neg_inf();
  }
  hi = warp_max(hi);
  T lo = hi - T(1);
  for (int step = 0; step < bisect_steps; step += kLevels) {
    search_round<T, NC>(ym, lo, hi, lane);
  }
  const T tau = T(0.5) * (lo + hi);
#pragma unroll
  for (int c = 0; c < NC; ++c) y[c] = on[c] ? max0(y[c] - tau) : T(0);
}

// out_j = sum_i v_i A[i][j] for the lane's coordinates j (row vector
// times A; A need not be symmetric), one accumulator a coordinate, summed
// over i = 0 .. k-1 in order.
template <typename T, int NC>
__device__ __forceinline__ void vec_mat(const T (&v)[NC], const T* sA,
                                        T* sv, int k, int lane,
                                        T (&out)[NC]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) out[c] = T(0);
  // v goes to the warp's 16-byte aligned slice sv of shared memory and
  // comes back to every lane as broadcast 16-byte loads.  Rows of A are
  // 32 NC wide (a_bytes), so every load of a row is at a constant offset
  // from the lane's column; past k they are 0 and leave out_j at +0.
  constexpr int V = 16 / sizeof(T);
  constexpr int S = 32 * NC;
  __syncwarp();  // the previous product's reads of sv are done
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int j = 32 * c + lane;
    if (j < k) sv[j] = v[c];
  }
  __syncwarp();
  const T* column = sA + lane;
  const int k_vec = k - k % V;
#pragma unroll 4
  for (int i = 0; i < k_vec; i += V) {
    const auto packed = Vec<T>::load_shared(sv + i);
    const T* rows = column + i * S;
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const T vi = Vec<T>::part(packed, u);
#pragma unroll
      for (int cj = 0; cj < NC; ++cj) out[cj] += vi * rows[u * S + 32 * cj];
    }
  }
#pragma unroll 1
  for (int i = k_vec; i < k; ++i) {
    const T vi = sv[i];
#pragma unroll
    for (int cj = 0; cj < NC; ++cj) out[cj] += vi * column[i * S + 32 * cj];
  }
}

// One row: b and x0 at `base`, the result written there in `out`.
template <typename T, int NC>
__device__ __forceinline__ void solve_row(
    const T* sA, T* sv, const T* __restrict__ Bs, const T* __restrict__ X0s,
    T* __restrict__ out, int64_t base, int k, int lane, const bool (&on)[NC],
    const Solver<T>& p) {
  T x[NC], ax[NC], b[NC], d[NC], ad[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int j = 32 * c + lane;
    b[c] = j < k ? Bs[base + j] : T(0);
    x[c] = j < k ? X0s[base + j] : T(0);
  }
  project<T, NC>(x, on, p.bisect_steps, lane);
  vec_mat<T, NC>(x, sA, sv, k, lane, ax);

  T alpha;
  if (p.alpha0_in_range) {
    alpha = p.alpha0;
  } else {
#pragma unroll
    for (int c = 0; c < NC; ++c) d[c] = x[c] - (ax[c] + b[c]);
    project<T, NC>(d, on, p.bisect_steps, lane);
    T ainv = T(0);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const T v = absv(d[c] - x[c]);
      if (v > ainv) ainv = v;
    }
    ainv = warp_max(ainv);
    if (absv(ainv) < T(1e-12)) ainv = T(1);
    alpha = clip(T(1) / ainv, p.alpha_min, p.alpha_max);
  }

  const T progress_eps = T(32) * Limits<T>::eps;
  int stall = 0;
  for (int it = 0; it < p.max_iterations; ++it) {
    // D = P(x - alpha g) - x, with g = xA + b.
#pragma unroll
    for (int c = 0; c < NC; ++c) d[c] = x[c] - alpha * (ax[c] + b[c]);
    project<T, NC>(d, on, p.bisect_steps, lane);
#pragma unroll
    for (int c = 0; c < NC; ++c) d[c] -= x[c];
    vec_mat<T, NC>(d, sA, sv, k, lane, ad);

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
    alpha = q > T(0) ? clip(sksk / q, p.alpha_min, p.alpha_max)
                     : p.alpha_max;

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
    if (sksk < (p.eps2 * scale) * (p.eps2 * scale) ||
        dinf < p.eps1 * scale || stall >= 3) {
      break;
    }
  }

  project<T, NC>(x, on, p.bisect_steps, lane);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int j = 32 * c + lane;
    if (j < k) out[base + j] = x[c];
  }
}

// Bytes of dynamic shared memory: A, then one slice of k values a warp
// (each 16-byte aligned).  A is row-major, k x 32 NC (0 past column k).
template <typename T, int NC>
__host__ __device__ int a_bytes(int k) {
  return round_up16(k * 32 * NC * static_cast<int>(sizeof(T)));
}

template <typename T>
__host__ __device__ int slice_bytes(int k) {
  return round_up16(k * static_cast<int>(sizeof(T)));
}

// Resident blocks an SM that ptxas must leave room for: 4 (64 registers
// a thread) for float up to k = 96, where it measured faster than ptxas's
// own choice of 72-76 (PERF.md); else 1, without which ptxas
// spilled 8 bytes of double NC = 3 at 80 registers.
template <typename T, int NC>
constexpr int min_blocks() {
  return sizeof(T) == 4 && NC <= 3 ? 4 : 1;
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, (min_blocks<T, NC>()))
simplex_qp_unpacked_kernel(const T* __restrict__ As,
                           const T* __restrict__ Bs,
                           const T* __restrict__ X0s, T* __restrict__ out,
                           int* __restrict__ next_row, int n, int k,
                           uint64_t mask_lo, uint64_t mask_hi, Solver<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sA = reinterpret_cast<T*>(smem);
  const int r = blockIdx.y;
  const T* A = As + static_cast<int64_t>(r) * k * k;
  for (int t = threadIdx.x; t < k * 32 * NC; t += blockDim.x) {
    const int i = t / (32 * NC), j = t % (32 * NC);
    sA[t] = j < k ? A[i * k + j] : T(0);
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  T* sv = reinterpret_cast<T*>(smem + a_bytes<T, NC>(k) +
                               warp * slice_bytes<T>(k));
  bool on[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int j = 32 * c + lane;
    const uint64_t word = j < 64 ? mask_lo : mask_hi;
    on[c] = j < k && ((word >> (j & 63)) & 1ull);
  }
  for (;;) {
    int row = 0;
    if (lane == 0) row = atomicAdd(next_row + r, 1);
    row = __shfl_sync(kFull, row, 0);
    if (row >= n) break;  // the whole warp leaves together
    solve_row<T, NC>(sA, sv, Bs, X0s, out,
                     (static_cast<int64_t>(r) * n + row) * k, k, lane, on,
                     p);
  }
}

template <typename T, int NC>
int shared_bytes(int k) {
  return a_bytes<T, NC>(k) + kWarps * slice_bytes<T>(k);
}

// The blocks of simplex_qp_unpacked_kernel<T, NC> that the current device
// holds at once at this k.  They do not change for a device and k, so the
// shared-memory opt-in (set for the instantiation's largest k) and the
// occupancy query run once per device and k.
template <typename T, int NC>
cudaError_t resident_blocks(int k, int* blocks) {
  constexpr int kDevices = 64;
  // By device and k - 32 (NC - 1) (1 .. 32); 0 = not queried yet.
  static std::atomic<int> cached[kDevices][33];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::atomic<int>* slot =
      device < kDevices ? &cached[device][k - 32 * (NC - 1)] : nullptr;
  if (slot != nullptr &&
      (*blocks = slot->load(std::memory_order_relaxed)) > 0) {
    return cudaSuccess;
  }
  const int most = shared_bytes<T, NC>(32 * NC);
  if (most > kDefaultSharedBytes) {
    err = cudaFuncSetAttribute(
        simplex_qp_unpacked_kernel<T, NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return err;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, simplex_qp_unpacked_kernel<T, NC>, kThreads,
      shared_bytes<T, NC>(k));
  if (err != cudaSuccess) return err;
  *blocks = (per_sm > 0 ? per_sm : 1) * sms;
  if (slot != nullptr) slot->store(*blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

template <typename T, int NC>
int launch(const void* As, const void* Bs, const void* X0s, void* out,
           int* next_row, int R, int n, int k, uint64_t mask_lo,
           uint64_t mask_hi, const Solver<T>& p, cudaStream_t stream) {
  int resident = 0;
  cudaError_t err = resident_blocks<T, NC>(k, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  // The resident blocks, spread over the groups (at least one a group).
  const int row_blocks = (n + kWarps - 1) / kWarps;
  const int per_group = resident / R > 1 ? resident / R : 1;
  const int blocks = per_group < row_blocks ? per_group : row_blocks;
  err = cudaMemsetAsync(next_row, 0, sizeof(int) * R, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int shared = shared_bytes<T, NC>(k);
  const dim3 grid(blocks, R);
  simplex_qp_unpacked_kernel<T, NC><<<grid, kThreads, shared, stream>>>(
      static_cast<const T*>(As), static_cast<const T*>(Bs),
      static_cast<const T*>(X0s), static_cast<T*>(out), next_row, n, k,
      mask_lo, mask_hi, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_k(const void* As, const void* Bs, const void* X0s, void* out,
             int* next_row, int R, int n, int k, uint64_t mask_lo,
             uint64_t mask_hi, int max_iterations, double alpha0,
             int alpha0_in_range, double alpha_min, double alpha_max,
             double eps1, double eps2, int bisect_steps,
             cudaStream_t stream) {
  const Solver<T> p{max_iterations, T(alpha0), alpha0_in_range,
                    T(alpha_min), T(alpha_max), T(eps1), T(eps2),
                    bisect_steps};
#define SIMPLEX_QP_UNPACKED_LAUNCH(NC)                                      \
  return launch<T, NC>(As, Bs, X0s, out, next_row, R, n, k, mask_lo,       \
                       mask_hi, p, stream)
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

// dtype: 0 = float32, 1 = float64.  next_row: R ints of device memory,
// the per-group row counters (the launch zeroes them on `stream`).
// mask_lo / mask_hi: the active coordinates 0-63 and 64-127 as bits.
// Returns the CUDA error of the launch (0 on success), or -1 for
// arguments the kernel does not take (the Python wrapper checks them
// first).
extern "C" int simplex_qp_unpacked_launch(
    int dtype, void* next_row, const void* As, const void* Bs,
    const void* X0s, void* out, int R, int n, int k, uint64_t mask_lo,
    uint64_t mask_hi, int max_iterations, double alpha0,
    int alpha0_in_range, double alpha_min, double alpha_max, double eps1,
    double eps2, int bisect_steps, void* stream) {
  if (R < 1 || R > 65535 || n < 1 || k < 1 || k > 128 ||
      bisect_steps < 0 || bisect_steps % kLevels != 0) {
    return -1;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* rows = static_cast<int*>(next_row);
  if (dtype == 0) {
    return launch_k<float>(As, Bs, X0s, out, rows, R, n, k, mask_lo,
                           mask_hi, max_iterations, alpha0, alpha0_in_range,
                           alpha_min, alpha_max, eps1, eps2, bisect_steps,
                           s);
  }
  if (dtype == 1) {
    return launch_k<double>(As, Bs, X0s, out, rows, R, n, k, mask_lo,
                            mask_hi, max_iterations, alpha0,
                            alpha0_in_range, alpha_min, alpha_max, eps1,
                            eps2, bisect_steps, s);
  }
  return -1;
}
