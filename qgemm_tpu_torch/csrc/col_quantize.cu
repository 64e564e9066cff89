// Kernel K9: per-column absmax int8 weight quantization, for Hopper
// (sm_90a), written straight into the K-major layout the int8 GEMMs read.
//
// Replaces the TPU kernel _col_quantize_kernel of
// qgemm_tpu/ops/pallas/quantized_matmul.py (behind col_quantize_pallas):
//
//   c[e, n] = max(max_k |w[e, k, n]|, 1e-12)           (in f32)
//   q = clip(rint(w * (127 / c)), -127, 127)            (rounding "nearest")
//   q = trunc(w * (127 / c))                            (rounding "truncate")
//
// with 127 / c a true IEEE division and every step in f32, so it equals
// its plain version (col_quantize_plain) bit for bit. Input w [E, K, N]
// (f32 or bf16), outputs qt int8 [E, N, K] (K-major: the transpose that
// QuantizedWeight.from_kn would make happens here) and c f32 [E, N]. The
// maximum propagates a NaN as torch's amax does: a column holding a NaN
// gets the scale NaN and codes 0 (the card's conversion of NaN), an inf
// column the scale inf.
//
// What bounds it on the H100: bytes. It reads w and writes a quarter (f32)
// or a half (bf16) of that as int8; there is no arithmetic to speak of.
//
// Design (the "cluster" route, ops/cuda/quant_plan.py): w is read once. A
// strip of 128 bytes of columns (64 bf16 or 32 f32) is spread along K over
// one thread-block cluster of 1, 2, 4 or 8 blocks; block r of the cluster
// holds the K-slab [r * slab_rows, (r + 1) * slab_rows) of the strip.
//   1. it loads its slab into shared memory with 16-byte cp.async copies,
//      whole 128-byte lines per row (element loads at a ragged or unaligned
//      edge);
//   2. reduces the slab's absmax per column;
//   3. cluster barrier; reads its peers' partial maxima through distributed
//      shared memory, in rank order (no atomics, no memset), and arrives on
//      a second cluster barrier once it has read them;
//   4. quantizes its own slab from shared memory (rounding through a
//      1.5 * 2^23 bias, exact) and writes each column's runs of 32 codes
//      with two 16-byte stores (bytes where K is not a multiple of 16);
//      rank 0 writes the scales;
//   5. waits on that second barrier before it exits, so that no block
//      leaves while a peer still reads its shared memory.
// One launch per call. Where a strip's K does not fit one cluster's shared
// memory (K > 8 x kMaxSlabRows), the "two_pass" route runs: the first
// design, kept for those shapes (a memset, an absmax pass folding with an
// integer atomicMax on the f32 bits, and a quantize pass that reads w again).
#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kQRange = 127.f;
constexpr float kEps = 1e-12f;
constexpr int kStripBytes = 128;       // a strip's row: one 128-byte line
constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;         // the portable cluster size
constexpr int kRowAlign = 16;          // slab rows: a multiple of one 16-byte code run
constexpr int kTargetRows = 256;       // the slab rows the plan aims at
constexpr int kReserve = 2048;         // shared bytes kept beside the slab (its static arrays)
constexpr int kSmemLimit = 232448;
constexpr int kMaxSlabRows = (kSmemLimit - kReserve) / kStripBytes / kRowAlign * kRowAlign;

// max that keeps a NaN, as torch's amax does (fmaxf drops it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// rint (half to even) or trunc of y = w * (127 / c), |y| <= 127, through the
// 1.5 * 2^23 bias: exact and at the full f32 rate (the converting
// instruction runs at a quarter of it); a NaN gives 0, as the card's
// conversion does.
__device__ __forceinline__ int quant(float y, int truncate) {
  const float t = truncate ? truncf(y) : y;
  const int q = y == y ? __float_as_int(__fadd_rn(t, 12582912.f)) - 0x4B400000 : 0;
  return max(-127, min(127, q));
}

// ------------------------------------------------------------ cluster route
// grid (strips * cluster * E) (flattened: the strips' clusters, then the
// expert), cluster (cluster, 1, 1), kThreads threads;
// dynamic shared memory slab_rows * 128 bytes.
template <typename T>
__global__ void __launch_bounds__(kThreads)
col_quant_cluster_kernel(const T* __restrict__ w, int8_t* __restrict__ qt, float* __restrict__ c,
                         int k, int n, int slab_rows, int truncate) {
  constexpr int W = kStripBytes / sizeof(T);   // columns of a strip
  constexpr int V = 16 / sizeof(T);            // elements of a 16-byte chunk
  constexpr int RG = kThreads / W;             // row groups of the absmax
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[RG][W];
  __shared__ float part[W];                    // this slab's maxima, read by the peers
  __shared__ float scale[W];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cs = static_cast<int>(cluster.num_blocks());
  T* slab = reinterpret_cast<T*>(smem);        // [slab_rows][W]
  const qg::FlatIdx blk = qg::flat_block(((n + W - 1) / W) * cs);   // (strip block, expert)
  const size_t e = blk.o;
  w += e * k * n;
  qt += e * n * k;
  c += e * n;
  const int n0 = (blk.i / cs) * W;
  const int k0 = rank * slab_rows;
  const int rows = max(0, min(k, k0 + slab_rows) - k0);
  const int tid = threadIdx.x;

  // 1. the slab into shared memory: 16-byte cp.async copies, all in flight
  // at once (element loads at a ragged or unaligned edge)
  const bool vec = n0 + W <= n && (static_cast<size_t>(n) * sizeof(T)) % 16 == 0;
  for (int i = tid; i < rows * (W / V); i += kThreads) {
    const int r = i / (W / V), cc = (i % (W / V)) * V;
    const T* src = w + static_cast<size_t>(k0 + r) * n + n0 + cc;
    T* dst = slab + r * W + cc;
    if (vec) {
      qg::cp_async16(qg::smem_addr(dst), src, 16);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) dst[j] = n0 + cc + j < n ? src[j] : qg::from_f32<T>(0.f);
    }
  }
  qg::cp_async_commit();
  qg::cp_async_wait<0>();
  __syncthreads();

  // 2. the slab's absmax per column
  const int col = tid % W, rg = tid / W;
  float mx = 0.f;
  for (int r = rg; r < rows; r += RG) mx = nan_max(mx, fabsf(qg::to_f32(slab[r * W + col])));
  red[rg][col] = mx;
  __syncthreads();
  if (tid < W) {
    float m = red[0][tid];
#pragma unroll
    for (int i = 1; i < RG; ++i) m = nan_max(m, red[i][tid]);
    part[tid] = m;
  }
  // 3. merge the cluster's partial maxima in rank order
  cluster.sync();
  if (tid < W) {
    float m = 0.f;
    for (int p = 0; p < cs; ++p)
      m = nan_max(m, *cluster.map_shared_rank(part + tid, static_cast<unsigned int>(p)));
    m = m != m ? m : fmaxf(m, kEps);           // clamp_min keeps a NaN
    scale[tid] = kQRange / m;
    if (rank == 0 && n0 + tid < n) c[n0 + tid] = m;
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");   // peers' reads done
  __syncthreads();

  // 4. codes: thread (column, 32-row run) quantizes down its column
  // (neighbouring threads on neighbouring columns: no bank conflicts) and
  // stores the run along K, one whole 32-byte sector
  const bool vec_out = k % 16 == 0;
  const int runs = (rows + 31) / 32;
  for (int i = tid; i < W * runs; i += kThreads) {
    const int cl = i % W, run = i / W, gc = n0 + cl;
    if (gc >= n) continue;
    const float s = scale[cl];
    const int r0 = run * 32;
    uint32_t packed[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = r0 + 4 * j + b;
        const int q = r < rows ? quant(qg::to_f32(slab[r * W + cl]) * s, truncate) : 0;
        word |= (static_cast<uint32_t>(q) & 0xffu) << (8 * b);
      }
      packed[j] = word;
    }
    int8_t* dst = qt + static_cast<size_t>(gc) * k + k0 + r0;
    if (vec_out) {   // k0 + r0, k and rows are multiples of 16
      *reinterpret_cast<uint4*>(dst) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      if (r0 + 16 < rows)
        *reinterpret_cast<uint4*>(dst + 16) =
            make_uint4(packed[4], packed[5], packed[6], packed[7]);
    } else {
      for (int r = 0; r < 32 && r0 + r < rows; ++r)
        dst[r] = static_cast<int8_t>((packed[r / 4] >> (8 * (r % 4))) & 0xffu);
    }
  }
  // 5. no block leaves while a peer may still read its maxima
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ----------------------------------------------------------- two-pass route
constexpr int kCols = 64;       // columns per block (threadIdx.x)
constexpr int kRowGroups = 4;   // threadIdx.y
constexpr int kSlabK = 256;     // rows per absmax block
constexpr int kTileK = 64;      // rows per quantize block

// grid (ceil(n / kCols) * ceil(k / kSlabK) * E), flattened in that order;
// cmax [E, n] zeroed before.
// Non-negative floats, +NaN included, order as their bits.
template <typename T>
__global__ void __launch_bounds__(kCols * kRowGroups)
col_absmax_kernel(const T* __restrict__ w, unsigned int* __restrict__ cmax, int k, int n) {
  __shared__ float red[kRowGroups][kCols];
  const int nb = (n + kCols - 1) / kCols, ns = (k + kSlabK - 1) / kSlabK;
  const qg::FlatIdx blk = qg::flat_block(nb * ns);   // (column block, slab; expert)
  const size_t e = blk.o;
  w += e * k * n;
  cmax += e * n;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = (blk.i % nb) * kCols + tx;
  const int k0 = (blk.i / nb) * kSlabK, k1 = min(k, k0 + kSlabK);
  float mx = 0.f;
  if (col < n) {
#pragma unroll 8
    for (int r = k0 + ty; r < k1; r += kRowGroups)
      mx = nan_max(mx, fabsf(qg::to_f32(w[static_cast<size_t>(r) * n + col])));
  }
  red[ty][tx] = mx;
  __syncthreads();
  if (ty == 0 && col < n) {
#pragma unroll
    for (int i = 1; i < kRowGroups; ++i) mx = nan_max(mx, red[i][tx]);
    atomicMax(cmax + col, __float_as_uint(mx));
  }
}

// grid (ceil(n / kCols) * ceil(k / kTileK) * E), flattened in that order
template <typename T>
__global__ void __launch_bounds__(kCols * kRowGroups)
col_quant_kernel(const T* __restrict__ w, const unsigned int* __restrict__ cmax,
                 int8_t* __restrict__ qt, float* __restrict__ c, int k, int n, int truncate) {
  __shared__ float scale[kCols];
  __shared__ int8_t tile[kCols][kTileK + 4];
  const int nb = (n + kCols - 1) / kCols, nt = (k + kTileK - 1) / kTileK;
  const qg::FlatIdx blk = qg::flat_block(nb * nt);   // (column block, row tile; expert)
  const size_t e = blk.o;
  w += e * k * n;
  cmax += e * n;
  qt += e * n * k;
  c += e * n;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kCols + tx;
  const int tile_k = blk.i / nb;
  const int n0 = (blk.i % nb) * kCols, k0 = tile_k * kTileK;
  const int col = n0 + tx;
  if (ty == 0) {
    float m = col < n ? __uint_as_float(cmax[col]) : 1.f;
    m = m != m ? m : fmaxf(m, kEps);
    if (tile_k == 0 && col < n) c[col] = m;
    scale[tx] = kQRange / m;
  }
  __syncthreads();
  const float s = scale[tx];
  for (int r = ty; r < kTileK; r += kRowGroups) {
    const int gk = k0 + r;
    int q = 0;
    if (gk < k && col < n) q = quant(qg::to_f32(w[static_cast<size_t>(gk) * n + col]) * s, truncate);
    tile[tx][r] = static_cast<int8_t>(q);
  }
  __syncthreads();
  for (int i = tid; i < kCols * kTileK; i += kCols * kRowGroups) {
    const int cc = i / kTileK, r = i % kTileK;
    const int gc = n0 + cc, gk = k0 + r;
    if (gc < n && gk < k) qt[static_cast<size_t>(gc) * k + gk] = tile[cc][r];
  }
}

// ---------------------------------------------------------------- the plan
// ops/cuda/quant_plan.py's plan, recomputed: the C entry runs no other.
struct Plan {
  int route, cluster, slab_rows, smem;   // route 0 = cluster, 1 = two_pass
};

inline Plan make_plan(int k) {
  int cs = 1;
  while (cs < kMaxCluster && (k + cs - 1) / cs > kTargetRows) cs *= 2;
  const int rows = ((k + cs - 1) / cs + kRowAlign - 1) / kRowAlign * kRowAlign;
  if (rows > kMaxSlabRows) return {1, 0, 0, 0};
  return {0, cs, rows, rows * kStripBytes};
}

template <typename T>
cudaError_t launch_cluster(const T* w, int8_t* qt, float* c, int e, int k, int n, int truncate,
                           const Plan& p, cudaStream_t s) {
  constexpr int W = kStripBytes / sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(col_quant_cluster_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((n + W - 1) / W) * p.cluster * e);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, col_quant_cluster_kernel<T>, w, qt, c, k, n, p.slab_rows,
                           truncate);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t launch_two_pass(const T* w, unsigned int* cmax, int8_t* qt, float* c, int e, int k,
                            int n, int truncate, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(cmax, 0, sizeof(unsigned int) * e * n, s);
  if (err != cudaSuccess) return err;
  const dim3 block(kCols, kRowGroups);
  const int nb = (n + kCols - 1) / kCols;
  col_absmax_kernel<T><<<dim3(nb * ((k + kSlabK - 1) / kSlabK) * e), block, 0, s>>>(w, cmax, k,
                                                                                    n);
  col_quant_kernel<T><<<dim3(nb * ((k + kTileK - 1) / kTileK) * e), block, 0, s>>>(
      w, cmax, qt, c, k, n, truncate);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const T* w, unsigned int* cmax, int8_t* qt, float* c, int e, int k, int n,
                   int truncate, const Plan& p, cudaStream_t s) {
  if (p.route == 0) return launch_cluster(w, qt, c, e, k, n, truncate, p, s);
  if (cmax == nullptr ||
      !qg::flat_grid_ok(static_cast<long long>((n + kCols - 1) / kCols) * ((k + kTileK - 1) / kTileK) * e))
    return cudaErrorInvalidValue;
  return launch_two_pass(w, cmax, qt, c, e, k, n, truncate, s);
}

}  // namespace

// w [e, k, n] (w_dtype 0 = f32, 1 = bf16, 16-byte aligned), qt int8 [e, n, k],
// c f32 [e, n]; the plan's route (0 cluster, 1 two_pass), cluster size, slab
// rows and dynamic shared memory, as quant_plan.py gives them (refused
// otherwise); cmax [e, n] 32-bit scratch for the two_pass route (null on
// the cluster route). Returns the first CUDA error.
extern "C" int qgemm_col_quantize(const void* w, int w_dtype, void* qt, void* c, void* cmax,
                                  int e, int k, int n, int truncate, int route, int cluster,
                                  int slab_rows, int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (e <= 0 || k <= 0 || n <= 0 ||
      !qg::flat_grid_ok(static_cast<long long>((n + 15) / 16) * kMaxCluster * e))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(k);
  if (route != p.route || cluster != p.cluster || slab_rows != p.slab_rows || smem != p.smem)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* q8 = static_cast<int8_t*>(qt);
  auto* cf = static_cast<float*>(c);
  auto* cm = static_cast<unsigned int*>(cmax);
  cudaError_t err;
  if (w_dtype == 0)
    err = launch(static_cast<const float*>(w), cm, q8, cf, e, k, n, truncate, p, s);
  else if (w_dtype == 1)
    err = launch(static_cast<const __nv_bfloat16*>(w), cm, q8, cf, e, k, n, truncate, p, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
