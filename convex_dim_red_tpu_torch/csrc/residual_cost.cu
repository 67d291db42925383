// Fused AA residual cost for Hopper (sm_90a): K5.
//
// For every restart r it computes
//
//     s_r = sum_ij (sum_c Z[r,i,c] alpha[r,c] CX[r,c,j] - X[i,j])^2
//
// from X (n, d), Z (R, n, k), CX (R, k, d) and alpha (R, k): the
// residual-form cost of the restart-batched AA iterate
// (parallel/sharded_aa.py:_aa_iter_cost) before its 0.5 / n_samples,
// without forming the (R, n, d) residual.
//
// It replaces no TPU kernel: the JAX package leaves this sum to XLA's
// fusion of the product, the subtraction, the square and the reduction.
// As separate PyTorch operations the same four steps write and read the
// (R, n, d) residual about six times (26 GB at the main path's
// (25, 1788, 24030) in float32, at least 7.7 ms at 3.35 TB/s).
//
// What bounds it on this card.  The data it needs is X once (172 MB at
// that shape), CX (14 MB), Z (1 MB) and alpha: 0.06 ms at 3.35 TB/s.
// The arithmetic is k + 1 fused multiply-adds for every (r, i, j), k for
// the product and one for the square and its sum: 2 R n d (k + 1) = 15.0
// GFLOP there, 0.22 ms at the 67 TFLOP/s of float32 FMA outside the
// tensor cores.  So the FMA pipes bound it, and the design keeps them
// fed: the data tile stays in registers, every pair of 16-byte reads
// from shared memory feeds kTM kTN / 2 FMAs, and the per-restart work
// around the FMAs is kept short.
//
// Design.  A block of 256 threads (16 x 16) owns a tile of kTileM x kTileN
// data points (128 x 128 in float, 64 x 64 in double).  Each thread holds
// kTM x kTN of them (8 x 8 or 4 x 4, in runs of one 16-byte vector half a
// tile apart on each axis, so that its shared-memory reads are 16-byte
// vectors).  The block copies its X tile to shared memory with cp.async
// (neighbouring threads on neighbouring points), and each thread keeps
// its points of -X in registers from then on.  The block then walks over
// its restarts.  Per restart, in chunks of kChunk components:
//
// - Z[r, rows, chunk] (transposed, so that a thread's rows are
//   contiguous), CX[r, chunk, cols] and alpha[r, chunk] are staged in
//   shared memory with cp.async, kStages buffers deep: two stages'
//   copies are in flight during a stage's FMAs.  Copies past n, d or k
//   are zero-filled (src-size 0), so the ragged edges need no masks in
//   the inner loop: a point past an edge has x = 0 and a residual of 0.
// - Each thread computes acc = fma(alpha_c z_c, y_c, acc) over the
//   chunk's components, from acc = -x at a restart's first component
//   (that FMA reads -x itself).  The chunk's width is a template
//   argument, so the loop is unrolled without branches for every width.
//   Scaling its kTM values of z by alpha costs kTM multiplies a
//   component; scaling the staged CX in place instead cost a pass and a
//   wait a stage, 10% slower at the main path's shape on an H100.
// - After the last chunk the thread sums acc^2 in the working dtype (in
//   kTM independent chains) and stores the sum in a ring of shared
//   memory.  Every kWarps restarts each warp adds the block's 256 sums of
//   one of the last kWarps restarts in float64 in a fixed order and
//   writes the tile's partial sum for it; the ring holds two such
//   batches, so that no barrier waits on these sums.
//
// A second kernel adds each restart's partial sums over the tiles in
// float64, in a fixed order (no atomics), and writes s_r in the working
// dtype: the same inputs give the same bits run after run.
//
// Restart groups.  The grid is tiles x groups: a block takes the
// restarts of one group.  Where the tiles alone do not give every SM a
// block (the JRA-55 PCs, (100, 732, 167): 12 tiles), the restarts are
// split into groups until they do; at the main path's shape 2632 tiles
// make one group.  The launch computes the groups from the shapes and
// the card's SMs and resident blocks, and takes no setting.
//
// k is a loop bound at run time (chunks of kChunk), so any k >= 1 runs.
//
// Built once per dtype, with -DRESIDUAL_COST_DTYPE=0 (float32) or 1
// (float64), so that the builds run in parallel.  Plain C interface for
// ctypes; a launch returns cudaGetLastError().

#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#ifndef RESIDUAL_COST_DTYPE
#error "build with -DRESIDUAL_COST_DTYPE=0 (float32) or 1 (float64)"
#endif

namespace {

using Real = std::conditional_t<RESIDUAL_COST_DTYPE == 0, float, double>;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Values of one 16-byte vector.
constexpr int kVec = 16 / sizeof(Real);
// Points a thread holds: kTM rows by kTN columns, in runs of kVec.
constexpr int kTM = sizeof(Real) == 4 ? 8 : 4;
constexpr int kTN = kTM;
constexpr int kRunsM = kTM / kVec, kRunsN = kTN / kVec;
// The block's tile: 16 x 16 threads.
constexpr int kTileM = 16 * kTM, kTileN = 16 * kTN;
// Components staged at once, and stage buffers (two stages in flight).
constexpr int kChunk = 8;
constexpr int kStages = 3;
// Elements of a stage each thread copies, of Z and of CX.
constexpr int kCopiesZ = kTileM * kChunk / kThreads;
constexpr int kCopiesY = kTileN * kChunk / kThreads;
// Restarts whose thread sums wait in shared memory: two batches of one
// restart a warp.
constexpr int kRing = 2 * kWarps;
static_assert(kTM % kVec == 0 && kTN % kVec == 0, "whole vectors");
static_assert(kCopiesZ >= 1 && kCopiesY >= 1, "whole copies a thread");
static_assert(kThreads >= kChunk, "a thread for each alpha of a chunk");
// Dynamic shared memory: the ring of thread sums, then the X tile.
constexpr size_t kRingBytes = sizeof(Real) * kRing * kThreads;
constexpr size_t kDynamicShared =
    kRingBytes + sizeof(Real) * kTileM * kTileN;

template <typename T>
struct alignas(16) Vec {
  T v[kVec];
};

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// One element from global to shared memory, or a zero where !valid.
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(sizeof(Real)),
               "r"(valid ? static_cast<int>(sizeof(Real)) : 0));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's newest groups are in flight.
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The tile offset of a thread's point a on an axis with RUNS runs of
// kVec points, where the thread sits at t (0 to 15).
template <int RUNS, int TILE>
__device__ __forceinline__ int point(int a, int t) {
  return (a / kVec) * (TILE / RUNS) + t * kVec + a % kVec;
}

// The thread's values of one staged row: RUNS vectors, TILE / RUNS apart.
template <int RUNS, int TILE, typename T>
__device__ __forceinline__ void operand(const T* row, int t,
                                        T (&out)[RUNS * kVec]) {
#pragma unroll
  for (int h = 0; h < RUNS; ++h) {
    const Vec<T> v = *reinterpret_cast<const Vec<T>*>(
        row + h * (TILE / RUNS) + t * kVec);
#pragma unroll
    for (int q = 0; q < kVec; ++q) out[h * kVec + q] = v.v[q];
  }
}

// acc += Z_chunk diag(alpha_chunk) Y_chunk over the first W components
// of the staged chunk; with FROM_X the first component starts from -x.
template <typename T, int W, bool FROM_X>
__device__ __forceinline__ void multiply_add(
    const T (&zs)[kChunk][kTileM], const T (&ys)[kChunk][kTileN],
    const T (&as)[kChunk], int tx, int ty, const T (&xneg)[kTM][kTN],
    T (&acc)[kTM][kTN]) {
#pragma unroll
  for (int c = 0; c < W; ++c) {
    T z[kTM], y[kTN];
    operand<kRunsM, kTileM>(zs[c], ty, z);
    operand<kRunsN, kTileN>(ys[c], tx, y);
    const T a = as[c];
#pragma unroll
    for (int i = 0; i < kTM; ++i) z[i] *= a;
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        acc[i][j] = fmadd(z[i], y[j],
                          FROM_X && c == 0 ? xneg[i][j] : acc[i][j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    residual_cost_kernel(const T* __restrict__ X, const T* __restrict__ Z,
                         const T* __restrict__ CX,
                         const T* __restrict__ alpha,
                         double* __restrict__ partial, int R, int n, int d,
                         int k, int per_group, int col_tiles) {
  __shared__ __align__(16) T zs[kStages][kChunk][kTileM];
  __shared__ __align__(16) T ys[kStages][kChunk][kTileN];
  __shared__ __align__(16) T as[kStages][kChunk];
  extern __shared__ __align__(16) unsigned char dynamic_shared[];
  T (*ring)[kThreads] = reinterpret_cast<T (*)[kThreads]>(dynamic_shared);
  T (*xs)[kTileN] =
      reinterpret_cast<T (*)[kTileN]>(dynamic_shared + kRingBytes);

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const int tile = blockIdx.x;
  const int tiles = gridDim.x;
  const int m0 = (tile / col_tiles) * kTileM;
  const int n0 = (tile % col_tiles) * kTileN;
  const int r0 = blockIdx.y * per_group;
  const int restarts = min(R, r0 + per_group) - r0;
  if (restarts <= 0) return;  // the whole block leaves
  const int chunks = (k + kChunk - 1) / kChunk;
  const int stages = restarts * chunks;

  // Where this thread's copies of a stage go and come from, but for the
  // restart's and the chunk's offsets.
  int z_off[kCopiesZ], z_comp[kCopiesZ];
  bool z_row[kCopiesZ];
#pragma unroll
  for (int q = 0; q < kCopiesZ; ++q) {
    const int e = tid + q * kThreads;
    const int p = e % kTileM;
    z_comp[q] = e / kTileM;
    z_row[q] = m0 + p < n;
    z_off[q] = (m0 + p) * k + z_comp[q];
  }
  int y_off[kCopiesY], y_comp[kCopiesY];
  bool y_col[kCopiesY];
#pragma unroll
  for (int q = 0; q < kCopiesY; ++q) {
    const int e = tid + q * kThreads;
    const int p = e % kTileN;
    y_comp[q] = e / kTileN;
    y_col[q] = n0 + p < d;
    y_off[q] = y_comp[q] * d + n0 + p;
  }

  // The X tile, one group of copies ahead of the stages'.
  for (int e = tid; e < kTileM * kTileN; e += kThreads) {
    const int i = m0 + e / kTileN, j = n0 + e % kTileN;
    const bool in = i < n && j < d;
    copy_async(&xs[e / kTileN][e % kTileN],
               in ? X + static_cast<size_t>(i) * d + j : X, in);
  }
  copy_commit();

  // Issue the copies of stage s (restart s / chunks, chunk s % chunks)
  // into its buffer; a stage past the last issues nothing.  Always
  // commits a group, so that the groups count the stages.
  auto stage = [&](int s) {
    if (s < stages) {
      const int buf = s % kStages;
      const int r = r0 + s / chunks;
      const int c0 = (s % chunks) * kChunk;
      const T* z = Z + static_cast<size_t>(r) * n * k + c0;
      const T* y = CX + (static_cast<size_t>(r) * k + c0) * d;
#pragma unroll
      for (int q = 0; q < kCopiesZ; ++q) {
        const bool in = z_row[q] && c0 + z_comp[q] < k;
        copy_async(&zs[buf][z_comp[q]][(tid + q * kThreads) % kTileM],
                   in ? z + z_off[q] : Z, in);
      }
#pragma unroll
      for (int q = 0; q < kCopiesY; ++q) {
        const bool in = y_col[q] && c0 + y_comp[q] < k;
        copy_async(&ys[buf][y_comp[q]][(tid + q * kThreads) % kTileN],
                   in ? y + y_off[q] : CX, in);
      }
      if (tid < kChunk) {
        const bool in = c0 + tid < k;
        copy_async(&as[buf][tid],
                   in ? alpha + static_cast<size_t>(r) * k + c0 + tid
                      : alpha,
                   in);
      }
    }
    copy_commit();
  };

  // Warp w adds the block's sums of restart first + w (local index), if
  // there is one, in float64 and a fixed order, and writes the tile's
  // partial sum.
  auto finish = [&](int first) {
    const int r = first + warp;
    if (r >= restarts) return;
    const T* sums = ring[r % kRing];
    double s = 0.0;
#pragma unroll
    for (int q = 0; q < kWarps; ++q)
      s += static_cast<double>(sums[lane + 32 * q]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0)
      partial[static_cast<size_t>(r0 + r) * tiles + tile] = s;
  };

  T xneg[kTM][kTN];
  T acc[kTM][kTN];
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) stage(s);
  for (int s = 0; s < stages; ++s) {
    const int buf = s % kStages;
    const int r = s / chunks, chunk = s % chunks;
    // This thread's copies of stage s (and of X) have landed; after the
    // barrier, everyone's have, and every thread is done with the buffer
    // of stage s - 1 and has stored its sums of the restarts before r.
    copy_wait<kStages - 2>();
    __syncthreads();
    stage(s + kStages - 1);
    if (chunk == 0 && r > 0 && r % kWarps == 0) finish(r - kWarps);
    if (s == 0) {
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        T row[kTN];
        operand<kRunsN, kTileN>(xs[point<kRunsM, kTileM>(i, ty)], tx, row);
#pragma unroll
        for (int j = 0; j < kTN; ++j) xneg[i][j] = -row[j];
      }
    }

    const bool first = chunk == 0;
    switch (min(kChunk, k - chunk * kChunk)) {
#define RESIDUAL_COST_WIDTH(W)                                              \
  case W:                                                                   \
    if (first) {                                                            \
      multiply_add<T, W, true>(zs[buf], ys[buf], as[buf], tx, ty, xneg,     \
                               acc);                                        \
    } else {                                                                \
      multiply_add<T, W, false>(zs[buf], ys[buf], as[buf], tx, ty, xneg,    \
                                acc);                                       \
    }                                                                       \
    break;
      RESIDUAL_COST_WIDTH(1)
      RESIDUAL_COST_WIDTH(2)
      RESIDUAL_COST_WIDTH(3)
      RESIDUAL_COST_WIDTH(4)
      RESIDUAL_COST_WIDTH(5)
      RESIDUAL_COST_WIDTH(6)
      RESIDUAL_COST_WIDTH(7)
      RESIDUAL_COST_WIDTH(8)
#undef RESIDUAL_COST_WIDTH
    }
    static_assert(kChunk == 8, "one case a chunk width");

    if (chunk == chunks - 1) {
      T row[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        row[i] = acc[i][0] * acc[i][0];
#pragma unroll
        for (int j = 1; j < kTN; ++j)
          row[i] = fmadd(acc[i][j], acc[i][j], row[i]);
      }
#pragma unroll
      for (int w = kTM / 2; w > 0; w >>= 1)
#pragma unroll
        for (int i = 0; i < w; ++i) row[i] += row[i + w];
      ring[r % kRing][tid] = row[0];
    }
  }
  __syncthreads();
  finish((restarts - 1) / kWarps * kWarps);
}

// out[r] = the sum of partial[r, :] over the tiles, in float64 and a
// fixed order, cast to the working dtype.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    residual_cost_sum_kernel(const double* __restrict__ partial,
                             T* __restrict__ out, int tiles) {
  __shared__ double sums[kThreads];
  const int tid = threadIdx.x;
  const double* row = partial + static_cast<size_t>(blockIdx.x) * tiles;
  double s = 0.0;
  for (int t = tid; t < tiles; t += kThreads) s += row[t];
  sums[tid] = s;
  __syncthreads();
#pragma unroll
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (tid < w) sums[tid] += sums[tid + w];
    __syncthreads();
  }
  if (tid == 0) out[blockIdx.x] = static_cast<T>(sums[0]);
}

long long div_up(long long a, long long b) { return (a + b - 1) / b; }

// Blocks of the main kernel that the current device holds at once,
// found once a device (0 where the runtime cannot tell).  Sets the
// kernel's dynamic shared memory limit on the way.
int resident_blocks() {
  static int cached[64] = {0};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= 64)
    return 0;
  if (cached[device] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaFuncSetAttribute(residual_cost_kernel<Real>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kDynamicShared)) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, residual_cost_kernel<Real>, kThreads,
            kDynamicShared) != cudaSuccess) {
      return 0;
    }
    cached[device] = sms * per_sm;
  }
  return cached[device];
}

}  // namespace

// Tiles of one restart at (n, d): the partial sums a launch needs for
// each restart (the caller allocates R x tiles doubles), or -1 where
// the grid would not fit.
extern "C" int residual_cost_tiles(int n, int d) {
  if (n < 1 || d < 1) return -1;
  const long long tiles = div_up(n, kTileM) * div_up(d, kTileN);
  return tiles > INT_MAX ? -1 : static_cast<int>(tiles);
}

// dtype: 0 = float32, 1 = float64 (that of this build, else -1).
// X (n, d), Z (R, n, k), CX (R, k, d), alpha (R, k): contiguous, on the
// current device; partial: R x residual_cost_tiles(n, d) doubles of
// scratch; out: R values.  Returns cudaGetLastError() after the two
// launches, or -1 for arguments the kernels do not take (among them
// offsets within a restart's Z, or within kChunk rows of CX, past
// 2**31 - 1 elements).
extern "C" int residual_cost_launch(int dtype, const void* X, const void* Z,
                                    const void* CX, const void* alpha,
                                    void* partial, void* out, int R, int n,
                                    int d, int k, void* stream) {
  if (dtype != RESIDUAL_COST_DTYPE || R < 1 || n < 1 || d < 1 || k < 1 ||
      (static_cast<long long>(n) + kTileM) * k > INT_MAX ||
      static_cast<long long>(kChunk + 1) * d > INT_MAX)
    return -1;
  const int tiles = residual_cost_tiles(n, d);
  if (tiles < 1) return -1;
  const long long slots = resident_blocks();
  if (slots < 1) return -1;
  // Restart groups: enough for every resident slot to get a block.
  const long long wanted = tiles >= slots ? 1 : div_up(slots, tiles);
  const long long per_group = div_up(R, wanted < R ? wanted : R);
  const long long groups = div_up(R, per_group);
  if (groups > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  residual_cost_kernel<Real>
      <<<dim3(tiles, static_cast<unsigned>(groups)), kThreads,
         kDynamicShared, s>>>(
          static_cast<const Real*>(X), static_cast<const Real*>(Z),
          static_cast<const Real*>(CX), static_cast<const Real*>(alpha),
          static_cast<double*>(partial), R, n, d, k,
          static_cast<int>(per_group), static_cast<int>(div_up(d, kTileN)));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  residual_cost_sum_kernel<Real><<<R, kThreads, 0, s>>>(
      static_cast<const double*>(partial), static_cast<Real*>(out), tiles);
  return static_cast<int>(cudaGetLastError());
}
