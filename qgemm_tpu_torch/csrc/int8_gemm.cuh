// The fused row-quantize -> int8 GEMM -> dequant kernels shared by K1
// (quantized_matmul.cu, one matrix) and K8 (expert_matmul.cu, a batch of
// expert matrices, one per blockIdx.y / blockIdx.z).
//
//   out[e, m, n] = (acc[e, m, n] * (cx[e, m] / 127^2)) * cw[e, n],
//   acc = sum_k q(x[e, m, k]) * wq[e, k, n]   (exact, int32),
//   q(x) = clip(rint(x * (127 / cx[e, m])), -127, 127),  cx[e, m] = max|x[e, m, :]|,
//
// then max(out, 0) when relu is set. Operands are contiguous batches: x
// [E, m, k] (f32 or bf16), K-major weights wt [E, n, k] int8, cw [E, n],
// out [E, m, n]; E = 1 is K1's single matrix.
//
// Design:
//   * a row-absmax pre-pass writes cx for all E * m rows; X itself is never
//     written back as int8 — each GEMM block quantizes its X tile in
//     registers on the way into shared memory, with the same f32 ops as
//     the TPU kernels (scale 127/c first, then x * scale, round half to
//     even with __float2int_rn), so the int8 codes match bit for bit;
//   * weights are stored K-major ([n, k], the tensor cores' "col" B
//     operand), so both operands load as 16-byte vectors along K;
//   * m <= 16: a GEMV-shaped kernel — each warp streams whole weight
//     columns with 16-byte loads and __dp4a against the quantized X rows
//     held in shared memory, many loads in flight per SM to keep HBM busy;
//   * m > 16: 64x128x64 block tiles, mma.sync m16n8k32 s8 -> s32;
//   * int32 accumulation is exact, so every tiling gives the same bits —
//     a row's result does not depend on m or on which kernel ran;
//   * ragged m and n edges are masked in the kernels (the 50272 vocab is
//     not a multiple of the tile); k must be a multiple of 16: the
//     wrappers zero-pad x and W along K on the calls where it is not (no
//     model of the repo takes that path at full width), since zeros
//     change neither the row absmax nor the int32 sums. A row of zeros (an empty
//     expert capacity slot) has cx = 1e-12, codes 0 and output exactly 0.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace qg {
namespace gemm {

constexpr float kQRange = 127.f;
constexpr float kEps = 1e-12f;

__device__ __forceinline__ int quant(float x, float s, int truncate) {
  const float y = x * s;
  const int q = truncate ? static_cast<int>(truncf(y)) : __float2int_rn(y);
  return max(-127, min(127, q));
}

// pack 8 quantized values into two 32-bit words (byte i = element i)
__device__ __forceinline__ uint2 quant8(const float v[8], float s, int truncate) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i / 4] |= (static_cast<uint32_t>(quant(v[i], s, truncate)) & 0xffu) << (8 * (i % 4));
  return make_uint2(w[0], w[1]);
}

__device__ __forceinline__ float epilogue(int acc, float cx, float cw, int relu) {
  const float v = (static_cast<float>(acc) * (cx * (1.0f / (kQRange * kQRange)))) * cw;
  return relu ? fmaxf(v, 0.f) : v;
}

template <typename T>
__global__ void row_absmax_kernel(const T* __restrict__ x, float* __restrict__ cx,
                                  int rows, int k) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * k;
  float mx = 0.f;
  for (int i = lane * 8; i < k; i += 32 * 8) {
    float v[8];
    load8(xr + i, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fabsf(v[j]));
  }
  mx = warp_max(mx);
  if (lane == 0) cx[row] = fmaxf(mx, kEps);
}

// ----------------------------------------------------------- m <= 16 rows
constexpr int kSmThreads = 256;                       // 8 warps
constexpr int kSmColsPerWarp = 2;
constexpr int kSmCols = (kSmThreads / 32) * kSmColsPerWarp;  // 16 per block
constexpr int kSmKc = 1024;                           // K chunk staged in smem

// grid (ceil(n / kSmCols), E)
template <typename T, int MR>
__global__ void __launch_bounds__(kSmThreads)
qmm_small_m_kernel(const T* __restrict__ x, const float* __restrict__ cx,
                   const int8_t* __restrict__ wt, const float* __restrict__ cw,
                   float* __restrict__ out, int m, int n, int k, int truncate, int relu) {
  __shared__ __align__(16) int8_t xs[MR][kSmKc];
  __shared__ float sx[MR];
  const size_t e = blockIdx.y;
  x += e * m * k;
  cx += e * m;
  wt += e * n * k;
  cw += e * n;
  out += e * m * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = blockIdx.x * kSmCols + warp * kSmColsPerWarp;
  if (threadIdx.x < MR) sx[threadIdx.x] = threadIdx.x < m ? kQRange / cx[threadIdx.x] : 0.f;
  int acc[kSmColsPerWarp][MR];
#pragma unroll
  for (int c = 0; c < kSmColsPerWarp; ++c)
#pragma unroll
    for (int r = 0; r < MR; ++r) acc[c][r] = 0;
  __syncthreads();

  for (int k0 = 0; k0 < k; k0 += kSmKc) {
    const int kc = min(kSmKc, k - k0);
    // stage the quantized X chunk: rows >= m and k >= kc are zeros
    for (int i = threadIdx.x; i < MR * (kSmKc / 8); i += kSmThreads) {
      const int r = i / (kSmKc / 8), kk = (i % (kSmKc / 8)) * 8;
      uint2 packed = make_uint2(0u, 0u);
      if (r < m && kk < kc) {
        float v[8];
        load8(x + static_cast<size_t>(r) * k + k0 + kk, v);
        packed = quant8(v, sx[r], truncate);
      }
      *reinterpret_cast<uint2*>(&xs[r][kk]) = packed;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kSmColsPerWarp; ++c) {
      const int col = col0 + c;
      if (col < n) {
        const int8_t* wcol = wt + static_cast<size_t>(col) * k + k0;
        for (int v = lane * 16; v < kc; v += 32 * 16) {
          const int4 w4 = __ldg(reinterpret_cast<const int4*>(wcol + v));
#pragma unroll
          for (int r = 0; r < MR; ++r) {
            const int4 x4 = *reinterpret_cast<const int4*>(&xs[r][v]);
            int a = acc[c][r];
            a = __dp4a(x4.x, w4.x, a);
            a = __dp4a(x4.y, w4.y, a);
            a = __dp4a(x4.z, w4.z, a);
            a = __dp4a(x4.w, w4.w, a);
            acc[c][r] = a;
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < kSmColsPerWarp; ++c) {
    const int col = col0 + c;
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      const int s = warp_sum_int(acc[c][r]);
      if (lane == 0 && col < n && r < m)
        out[static_cast<size_t>(r) * n + col] = epilogue(s, cx[r], cw[col], relu);
    }
  }
}

// ------------------------------------------------------------ m > 16 rows
constexpr int kBM = 64, kBN = 128, kBK = 64, kPad = 16;
constexpr int kMmaThreads = 128;   // 4 warps as 2 x 2, each a 32 x 64 tile

// grid (ceil(n / kBN), ceil(m / kBM), E)
template <typename T>
__global__ void __launch_bounds__(kMmaThreads)
qmm_mma_kernel(const T* __restrict__ x, const float* __restrict__ cx,
               const int8_t* __restrict__ wt, const float* __restrict__ cw,
               float* __restrict__ out, int m, int n, int k, int truncate, int relu) {
  __shared__ __align__(16) int8_t As[kBM][kBK + kPad];
  __shared__ __align__(16) int8_t Bs[kBN][kBK + kPad];
  __shared__ float sx[kBM];
  const size_t e = blockIdx.z;
  x += e * m * k;
  cx += e * m;
  wt += e * n * k;
  cw += e * n;
  out += e * m * n;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  if (tid < kBM) sx[tid] = row0 + tid < m ? kQRange / cx[row0 + tid] : 0.f;
  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;
  __syncthreads();

  for (int k0 = 0; k0 < k; k0 += kBK) {
    // A tile: quantize 8 X values per step into shared memory
    for (int i = tid; i < kBM * (kBK / 8); i += kMmaThreads) {
      const int r = i / (kBK / 8), kv = (i % (kBK / 8)) * 8;
      const int gr = row0 + r, gk = k0 + kv;
      uint2 packed = make_uint2(0u, 0u);
      if (gr < m && gk < k) {
        float v[8];
        load8(x + static_cast<size_t>(gr) * k + gk, v);
        packed = quant8(v, sx[r], truncate);
      }
      *reinterpret_cast<uint2*>(&As[r][kv]) = packed;
    }
    // B tile: 16-byte vectors of the K-major weights
    for (int i = tid; i < kBN * (kBK / 16); i += kMmaThreads) {
      const int r = i / (kBK / 16), kv = (i % (kBK / 16)) * 16;
      const int gn = col0 + r, gk = k0 + kv;
      int4 v = make_int4(0, 0, 0, 0);
      if (gn < n && gk < k) v = __ldg(reinterpret_cast<const int4*>(wt + static_cast<size_t>(gn) * k + gk));
      *reinterpret_cast<int4*>(&Bs[r][kv]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[2][4], b[8][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm * 32 + mt * 16 + g;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + t * 4]);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + t * 4]);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 16 + t * 4]);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 16 + t * 4]);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c = wn * 64 + nt * 8 + g;
        b[nt][0] = *reinterpret_cast<const uint32_t*>(&Bs[c][kk + t * 4]);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(&Bs[c][kk + 16 + t * 4]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = row0 + wm * 32 + mt * 16 + g + (q >= 2 ? 8 : 0);
        const int c = col0 + wn * 64 + nt * 8 + t * 2 + (q & 1);
        if (r < m && c < n)
          out[static_cast<size_t>(r) * n + c] = epilogue(acc[mt][nt][q], cx[r], cw[c], relu);
      }
}

// E batches of [m, k] x [k, n]; cx is scratch for E * m row scales.
template <typename T>
cudaError_t launch(const T* x, const int8_t* wt, const float* cw, float* cx, float* out,
                   int batches, int m, int n, int k, int truncate, int relu, cudaStream_t s) {
  const int rows = batches * m;
  row_absmax_kernel<T><<<(rows + 7) / 8, 256, 0, s>>>(x, cx, rows, k);
  if (m <= 16) {
    const dim3 grid((n + kSmCols - 1) / kSmCols, batches);
#define QG_SMALL(MR)                                                              \
  qmm_small_m_kernel<T, MR><<<grid, kSmThreads, 0, s>>>(x, cx, wt, cw, out, m, n, k, \
                                                         truncate, relu)
    if (m <= 1) QG_SMALL(1);
    else if (m <= 2) QG_SMALL(2);
    else if (m <= 4) QG_SMALL(4);
    else if (m <= 8) QG_SMALL(8);
    else QG_SMALL(16);
#undef QG_SMALL
  } else {
    const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, batches);
    qmm_mma_kernel<T><<<grid, kMmaThreads, 0, s>>>(x, cx, wt, cw, out, m, n, k, truncate,
                                                   relu);
  }
  return cudaGetLastError();
}

// x_dtype 0 = f32, 1 = bf16
inline cudaError_t launch_any(const void* x, int x_dtype, const void* wt, const void* cw,
                              void* cx, void* out, int batches, int m, int n, int k,
                              int truncate, int relu, cudaStream_t s) {
  if (batches <= 0 || batches > 65535 || m <= 0 || n <= 0 || k <= 0 || k % 16 != 0)
    return cudaErrorInvalidValue;
  const auto* w8 = static_cast<const int8_t*>(wt);
  const auto* cwf = static_cast<const float*>(cw);
  auto* cxf = static_cast<float*>(cx);
  auto* of = static_cast<float*>(out);
  if (x_dtype == 0)
    return launch(static_cast<const float*>(x), w8, cwf, cxf, of, batches, m, n, k, truncate,
                  relu, s);
  if (x_dtype == 1)
    return launch(static_cast<const __nv_bfloat16*>(x), w8, cwf, cxf, of, batches, m, n, k,
                  truncate, relu, s);
  return cudaErrorInvalidValue;
}

}  // namespace gemm
}  // namespace qg
