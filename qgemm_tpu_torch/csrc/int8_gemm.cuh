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
// What bounds it on the H100: at decode (m <= 16) the weight stream, every
// int8 weight byte read once for ~2 int8 operations per byte, far under the
// card's 1979 TOP/s : 3.35 TB/s balance; at prefill the tensor-core rate.
// Measured on an H100 80GB HBM3 at 700 W at m 8 (PERF.md), the decode call
// (pre-pass and GEMV) reaches 0.35 of the byte bound at k = n = 4096, where
// two launches' latency outweighs the 5 us stream, 0.57-0.66 at the FFN
// shapes and 0.81 at the lm_head; the GEMV alone streams at 72-87 % of
// 3.35 TB/s at the larger shapes.
//
// Design:
//   * one pre-pass (row_quantize.cuh, one block per row) writes cx and the
//     int8 codes xq [E * m, k] with the plain version's f32 operations; both
//     GEMM kernels read only codes;
//   * weights are stored K-major ([n, k]), so W and X load as 16-byte
//     vectors along K;
//   * m <= 16, the decode GEMV (qmm_gemv_kernel): mma.sync m16n8k32 with W
//     as the A operand (16 output columns x 32 K) and X^T as B (8 rows; two
//     n8 tiles for m 9-16). The int32 sum does not depend on the order of K,
//     so a lane loads 16 contiguous bytes of a column straight from device
//     memory into its A registers (bytes 16t..16t+15 of each 64-code step
//     stand for the fragment's k 4t..4t+3 and 16+4t..16+4t+3 of two k32
//     products) and the X fragment is one 16-byte load of the same bytes of
//     its row: no shared-memory staging of W, no shuffles. A block holds 16
//     output columns; each warp owns a K slice (a multiple of 64 codes) and
//     walks it in batches of 256 codes, 8 weight and 4 X loads of 16 bytes
//     per lane in flight at a time (4 KB of weights a warp; at m <= 8, 74
//     registers, three blocks and ~96 KB a SM);
//     no block barrier stands in the K loop. The warps' int32 partials meet
//     once in shared memory. The GEMV is launched with programmatic
//     dependent launch: it starts while the pre-pass runs, prefetches its
//     first batch of weights into L2 and waits for the codes with
//     griddepcontrol.wait. The launch plan (warps, K slice, shared memory)
//     comes from ops/cuda/gemv_plan.py and is checked here;
//   * m > 16: 64x128x64 block tiles, mma.sync m16n8k32 s8 -> s32;
//   * int32 accumulation is exact, so every tiling gives the same bits —
//     a row's result does not depend on m or on which kernel ran;
//   * ragged m, n and k edges are masked in the kernels (the 50272 vocab is
//     not a multiple of the tile); k must be a multiple of 16: the
//     wrappers zero-pad x and W along K on the calls where it is not (no
//     model of the repo takes that path at full width), since zeros
//     change neither the row absmax nor the int32 sums. A row of zeros (an empty
//     expert capacity slot) has cx = 1e-12, codes 0 and output exactly 0.
#pragma once

#include "mma.cuh"
#include "row_quantize.cuh"

namespace qg {
namespace gemm {

__device__ __forceinline__ float epilogue(int acc, float cx, float cw, int relu) {
  const float v = (static_cast<float>(acc) * (cx * (1.0f / (kQRange * kQRange)))) * cw;
  return relu ? fmaxf(v, 0.f) : v;
}

__device__ __forceinline__ uint32_t u32(int v) { return static_cast<uint32_t>(v); }

// ------------------------------------------------------- m <= 16 rows: GEMV
constexpr int kGvStep = 64;        // K codes per lane step: two k32 products
constexpr int kGvBatch = 4;        // steps whose X fragments a warp holds (256 codes)
constexpr int kGvMaxWarps = 8;

// grid (ceil(n / 16), E), 32 * warps threads; warp w takes K codes
// [w * k_slice, min(k, (w + 1) * k_slice)) of the block's 16 columns.
// Dynamic shared memory: int32 partials [warps][16 columns][8 * NR rows].
template <int NR>
__global__ void __launch_bounds__(32 * kGvMaxWarps)
qmm_gemv_kernel(const int8_t* __restrict__ xq, const float* __restrict__ cx,
                const int8_t* __restrict__ wt, const float* __restrict__ cw,
                float* __restrict__ out, int m, int n, int k, int k_slice, int relu) {
  constexpr int R = 8 * NR;
  extern __shared__ int part[];
  const size_t e = blockIdx.y;
  xq += e * m * k;
  cx += e * m;
  wt += e * n * k;
  cw += e * n;
  out += e * m * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.x * 16, col = col0 + g;
  const int kb = warp * k_slice, ke = min(k, kb + k_slice);
  // while the pre-pass may still run: the warp's first batch of weights into L2
  if (lane < 16 && col0 + lane < n && kb < ke)
    prefetch_l2(wt + static_cast<size_t>(col0 + lane) * k + kb,
                min(kGvBatch * kGvStep, ke - kb));
  grid_dependency_wait();   // the pre-pass's codes and scales are written

  int acc[NR][4];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0;
  const int8_t* wa = wt + static_cast<size_t>(col) * k;   // columns g and g + 8
  const int8_t* wb = wa + static_cast<size_t>(8) * k;
  for (int k0 = kb; k0 < ke; k0 += kGvBatch * kGvStep) {
    // A fragments: bytes [16t, 16t + 16) of each step of columns g and g + 8;
    // B fragments: the same bytes of rows g and g + 8
    int4 va[kGvBatch], vb[kGvBatch], xf[NR][kGvBatch];
#pragma unroll
    for (int s = 0; s < kGvBatch; ++s) {
      const int kk = k0 + s * kGvStep + 16 * t;
      va[s] = load16(wa + kk, col < n && kk < ke);
      vb[s] = load16(wb + kk, col + 8 < n && kk < ke);
#pragma unroll
      for (int r = 0; r < NR; ++r)
        xf[r][s] = load16(xq + static_cast<size_t>(g + 8 * r) * k + kk, g + 8 * r < m && kk < ke);
    }
#pragma unroll
    for (int s = 0; s < kGvBatch; ++s) {
      const uint32_t a0[4] = {u32(va[s].x), u32(vb[s].x), u32(va[s].y), u32(vb[s].y)};
      const uint32_t a1[4] = {u32(va[s].z), u32(vb[s].z), u32(va[s].w), u32(vb[s].w)};
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const uint32_t b0[2] = {u32(xf[r][s].x), u32(xf[r][s].y)};
        const uint32_t b1[2] = {u32(xf[r][s].z), u32(xf[r][s].w)};
        mma_s8(acc[r], a0, b0);
        mma_s8(acc[r], a1, b1);
      }
    }
  }

  // C fragment: (column g, rows 2t, 2t + 1) and (column g + 8, the same rows)
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    int* p = part + (static_cast<size_t>(warp) * 16 + g) * R + 8 * r + 2 * t;
    *reinterpret_cast<int2*>(p) = make_int2(acc[r][0], acc[r][1]);
    *reinterpret_cast<int2*>(p + 8 * R) = make_int2(acc[r][2], acc[r][3]);
  }
  __syncthreads();
  const int warps = blockDim.x >> 5;
  for (int i = threadIdx.x; i < 16 * m; i += blockDim.x) {
    const int cl = i / m, row = i % m, c = col0 + cl;
    if (c >= n) continue;
    int sum = 0;
    for (int w = 0; w < warps; ++w) sum += part[(static_cast<size_t>(w) * 16 + cl) * R + row];
    out[static_cast<size_t>(row) * n + c] = epilogue(sum, cx[row], cw[c], relu);
  }
}

// ------------------------------------------------------------ m > 16 rows
constexpr int kBM = 64, kBN = 128, kBK = 64, kPad = 16;
constexpr int kMmaThreads = 128;   // 4 warps as 2 x 2, each a 32 x 64 tile

// grid (ceil(n / kBN), ceil(m / kBM), E)
__global__ void __launch_bounds__(kMmaThreads)
qmm_mma_kernel(const int8_t* __restrict__ xq, const float* __restrict__ cx,
               const int8_t* __restrict__ wt, const float* __restrict__ cw,
               float* __restrict__ out, int m, int n, int k, int relu) {
  __shared__ __align__(16) int8_t As[kBM][kBK + kPad];
  __shared__ __align__(16) int8_t Bs[kBN][kBK + kPad];
  const size_t e = blockIdx.z;
  xq += e * m * k;
  cx += e * m;
  wt += e * n * k;
  cw += e * n;
  out += e * m * n;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    // A tile: 16-byte vectors of the pre-pass's codes
    for (int i = tid; i < kBM * (kBK / 16); i += kMmaThreads) {
      const int r = i / (kBK / 16), kv = (i % (kBK / 16)) * 16;
      const int gr = row0 + r, gk = k0 + kv;
      *reinterpret_cast<int4*>(&As[r][kv]) =
          load16(xq + static_cast<size_t>(gr) * k + gk, gr < m && gk < k);
    }
    // B tile: 16-byte vectors of the K-major weights
    for (int i = tid; i < kBN * (kBK / 16); i += kMmaThreads) {
      const int r = i / (kBK / 16), kv = (i % (kBK / 16)) * 16;
      const int gn = col0 + r, gk = k0 + kv;
      *reinterpret_cast<int4*>(&Bs[r][kv]) =
          load16(wt + static_cast<size_t>(gn) * k + gk, gn < n && gk < k);
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

// The GEMV's launch plan (ops/cuda/gemv_plan.py): warps per block, K codes
// per warp, dynamic shared memory in bytes.
struct GemvPlan {
  int warps, k_slice, smem;
};

inline bool plan_ok(const GemvPlan& p, int m, int k) {
  const int nr = m <= 8 ? 1 : 2;
  return p.warps >= 1 && p.warps <= kGvMaxWarps && p.k_slice > 0 && p.k_slice % kGvStep == 0 &&
         static_cast<long long>(p.k_slice) * p.warps >= k &&
         static_cast<long long>(p.k_slice) * (p.warps - 1) < k &&
         p.smem == 4 * p.warps * 16 * 8 * nr;
}

template <int NR>
cudaError_t launch_gemv(const int8_t* xq, const float* cx, const int8_t* wt, const float* cw,
                        float* out, int batches, int m, int n, int k, int relu,
                        const GemvPlan& p, cudaStream_t s) {
  const dim3 grid((n + 15) / 16, batches);
  return launch_pdl(qmm_gemv_kernel<NR>, grid, dim3(32 * p.warps), p.smem, s, xq, cx, wt, cw,
                    out, m, n, k, p.k_slice, relu);
}

// E batches of [m, k] x [k, n]; xq [E * m, k] and cx [E * m] are scratch for
// the pre-pass's codes and row scales.
template <typename T>
cudaError_t launch(const T* x, const int8_t* wt, const float* cw, int8_t* xq, float* cx,
                   float* out, int batches, int m, int n, int k, int truncate, int relu,
                   const GemvPlan& p, cudaStream_t s) {
  if (m <= 16 && !plan_ok(p, m, k)) return cudaErrorInvalidValue;
  row_quantize_kernel<T><<<batches * m, quant_threads(k), 0, s>>>(x, xq, cx, k, k, k, 1, 1,
                                                                  truncate, 1.f);
  cudaError_t e = cudaSuccess;
  if (m > 16) {
    const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, batches);
    qmm_mma_kernel<<<grid, kMmaThreads, 0, s>>>(xq, cx, wt, cw, out, m, n, k, relu);
  } else if (m <= 8) {
    e = launch_gemv<1>(xq, cx, wt, cw, out, batches, m, n, k, relu, p, s);
  } else {
    e = launch_gemv<2>(xq, cx, wt, cw, out, batches, m, n, k, relu, p, s);
  }
  return e != cudaSuccess ? e : cudaGetLastError();
}

// x_dtype 0 = f32, 1 = bf16; x 16-byte aligned
inline cudaError_t launch_any(const void* x, int x_dtype, const void* wt, const void* cw,
                              void* xq, void* cx, void* out, int batches, int m, int n, int k,
                              int truncate, int relu, const GemvPlan& p, cudaStream_t s) {
  if (batches <= 0 || batches > 65535 || m <= 0 || n <= 0 || k <= 0 || k % 16 != 0)
    return cudaErrorInvalidValue;
  const auto* w8 = static_cast<const int8_t*>(wt);
  const auto* cwf = static_cast<const float*>(cw);
  auto* x8 = static_cast<int8_t*>(xq);
  auto* cxf = static_cast<float*>(cx);
  auto* of = static_cast<float*>(out);
  if (x_dtype == 0)
    return launch(static_cast<const float*>(x), w8, cwf, x8, cxf, of, batches, m, n, k,
                  truncate, relu, p, s);
  if (x_dtype == 1)
    return launch(static_cast<const __nv_bfloat16*>(x), w8, cwf, x8, cxf, of, batches, m, n,
                  k, truncate, relu, p, s);
  return cudaErrorInvalidValue;
}

}  // namespace gemm
}  // namespace qg
