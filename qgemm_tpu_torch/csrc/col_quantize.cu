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
// QuantizedWeight.from_kn would make happens here) and c f32 [E, N].
//
// What bounds it on the H100: bytes. It reads w and writes a quarter (f32)
// or a half (bf16) of that as int8; there is no arithmetic to speak of.
//
// Design: two passes over w, each a grid that fills the card whatever
// the shape (the TPU kernel's full-K column blocks give 2048^2 only 32
// blocks of 64 columns). Pass 1 (col_absmax_kernel): a block of 64 x 4
// threads reads a 256-row slab of 64 columns (each warp 32 neighbouring
// columns of a row: one coalesced line), reduces its absmax in shared
// memory and folds it into the column's maximum with an integer atomicMax
// on the f32 bit pattern (non-negative floats order as their bits), exact
// in any order. Pass 2 (col_quant_kernel): a block takes a 64-row x
// 64-column tile, computes the scale from the finished maximum, quantizes
// the tile into shared memory as [column][k] and writes it out along K,
// 64 bytes per column, neighbouring threads on neighbouring bytes; the
// blocks of the first row tile write the clamped scales. w is read twice;
// the second read hits L2 where the slab still lies there.
#include "common.cuh"

namespace {

constexpr float kQRange = 127.f;
constexpr float kEps = 1e-12f;
constexpr int kCols = 64;       // columns per block (threadIdx.x)
constexpr int kRowGroups = 4;   // threadIdx.y
constexpr int kThreads = kCols * kRowGroups;
constexpr int kSlabK = 256;     // rows per absmax block
constexpr int kTileK = 64;      // rows per quantize block

// grid (ceil(n / kCols), ceil(k / kSlabK), E); cmax [E, n] zeroed before
template <typename T>
__global__ void __launch_bounds__(kThreads)
col_absmax_kernel(const T* __restrict__ w, unsigned int* __restrict__ cmax, int k, int n) {
  __shared__ float red[kRowGroups][kCols];
  const size_t e = blockIdx.z;
  w += e * k * n;
  cmax += e * n;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * kCols + tx;
  const int k0 = blockIdx.y * kSlabK, k1 = min(k, k0 + kSlabK);
  float mx = 0.f;
  if (col < n) {
#pragma unroll 8
    for (int r = k0 + ty; r < k1; r += kRowGroups)
      mx = fmaxf(mx, fabsf(qg::to_f32(w[static_cast<size_t>(r) * n + col])));
  }
  red[ty][tx] = mx;
  __syncthreads();
  if (ty == 0 && col < n) {
#pragma unroll
    for (int i = 1; i < kRowGroups; ++i) mx = fmaxf(mx, red[i][tx]);
    atomicMax(cmax + col, __float_as_uint(mx));
  }
}

// grid (ceil(n / kCols), ceil(k / kTileK), E)
template <typename T>
__global__ void __launch_bounds__(kThreads)
col_quant_kernel(const T* __restrict__ w, const unsigned int* __restrict__ cmax,
                 int8_t* __restrict__ qt, float* __restrict__ c, int k, int n, int truncate) {
  __shared__ float scale[kCols];
  __shared__ int8_t tile[kCols][kTileK + 4];
  const size_t e = blockIdx.z;
  w += e * k * n;
  cmax += e * n;
  qt += e * n * k;
  c += e * n;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kCols + tx;
  const int n0 = blockIdx.x * kCols, k0 = blockIdx.y * kTileK;
  const int col = n0 + tx;
  if (ty == 0) {
    const float m = col < n ? fmaxf(__uint_as_float(cmax[col]), kEps) : 1.f;
    if (blockIdx.y == 0 && col < n) c[col] = m;
    scale[tx] = kQRange / m;
  }
  __syncthreads();
  const float s = scale[tx];
  for (int r = ty; r < kTileK; r += kRowGroups) {
    const int gk = k0 + r;
    int q = 0;
    if (gk < k && col < n) {
      const float y = qg::to_f32(w[static_cast<size_t>(gk) * n + col]) * s;
      q = truncate ? static_cast<int>(truncf(y)) : __float2int_rn(y);
      q = max(-127, min(127, q));
    }
    tile[tx][r] = static_cast<int8_t>(q);
  }
  __syncthreads();
  for (int i = tid; i < kCols * kTileK; i += kThreads) {
    const int cc = i / kTileK, r = i % kTileK;
    const int gc = n0 + cc, gk = k0 + r;
    if (gc < n && gk < k) qt[static_cast<size_t>(gc) * k + gk] = tile[cc][r];
  }
}

template <typename T>
cudaError_t launch(const T* w, unsigned int* cmax, int8_t* qt, float* c, int e, int k, int n,
                   int truncate, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(cmax, 0, sizeof(unsigned int) * e * n, s);
  if (err != cudaSuccess) return err;
  const dim3 block(kCols, kRowGroups);
  const int nb = (n + kCols - 1) / kCols;
  col_absmax_kernel<T><<<dim3(nb, (k + kSlabK - 1) / kSlabK, e), block, 0, s>>>(w, cmax, k, n);
  col_quant_kernel<T><<<dim3(nb, (k + kTileK - 1) / kTileK, e), block, 0, s>>>(
      w, cmax, qt, c, k, n, truncate);
  return cudaGetLastError();
}

}  // namespace

// w [e, k, n] (w_dtype 0 = f32, 1 = bf16), qt int8 [e, n, k], c f32 [e, n],
// cmax [e, n] 32-bit scratch. Returns the first CUDA error.
extern "C" int qgemm_col_quantize(const void* w, int w_dtype, void* qt, void* c, void* cmax,
                                  int e, int k, int n, int truncate, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (e <= 0 || e > 65535 || k <= 0 || n <= 0 || (k + kTileK - 1) / kTileK > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* q8 = static_cast<int8_t*>(qt);
  auto* cf = static_cast<float*>(c);
  auto* cm = static_cast<unsigned int*>(cmax);
  cudaError_t err;
  if (w_dtype == 0)
    err = launch(static_cast<const float*>(w), cm, q8, cf, e, k, n, truncate, s);
  else if (w_dtype == 1)
    err = launch(static_cast<const __nv_bfloat16*>(w), cm, q8, cf, e, k, n, truncate, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
