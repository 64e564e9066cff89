// The wide routes of K3, K7 and K6 (flash_attention.cu,
// flash_attention_bwd.cu, paged_context_attention.cu): blockwise attention
// at head widths past 256, where the tiled kernels' registers and shared
// memory run out (a 16-row warp tile of O at D 512 is 256 f32 registers a
// thread). Replaces nothing of its own: it serves _flash_kernel and
// _flash_bwd_dq_kernel / _flash_bwd_dkv_kernel of
// qgemm_tpu/ops/pallas/flash_attention.py, which pad any width to a
// multiple of 128, and _context_kernel of paged_attention.py, at the widths
// the tiled kernels do not take.
//
// Design (right and simple first): one block of 256 SIMT threads per (64
// own rows, output column chunk, batch*head), as K3's and K7's f32 kernels
// lay out a 64 x 32 score tile (a thread a 4 x 2 patch) and a 64-row output
// (a thread 4 rows x 16 columns). The widths are runtime values, multiples
// of 64 (the wrapper pads): a score tile accumulates over the width in
// chunks of 64 columns staged from device memory into shared memory, so
// neither the tile nor shared memory grows with the width, and an output
// chunk holds at most 256 columns, a block per chunk, each block
// recomputing its scores. Products are f32 FMAs on the CUDA cores (bf16
// inputs are exact in f32), so what bounds it is the operations at f32's
// rate, and the recomputation: chunks of Dv times the score work.
#pragma once

#include "common.cuh"

namespace qg {
namespace wide {

constexpr int kRows = 64, kTile = 32, kThreads = 256;
constexpr int kChunk = 64;                 // columns of a staged chunk of the width
constexpr int kOut = 256;                  // output columns a block
constexpr int kLdC = kChunk + 4;           // f32 row stride of a staged chunk (16 B aligned)
constexpr int kLdO = kOut + 4;             // f32 row stride of a staged output-width tile
constexpr int kLdS = kTile + 1;            // the score tile's row stride

// rows [r0, r0 + ROWS) x columns [c0, c0 + ncols) of a [n, width] matrix
// into f32 shared memory of row stride ld; rows past n are zeros. width,
// c0 and ncols are multiples of 8 and the rows 16-byte aligned.
template <typename T, int ROWS>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src, size_t width, int r0,
                                      int n, int c0, int ncols) {
  const int per = ncols / 8;
  for (int i = threadIdx.x; i < ROWS * per; i += kThreads) {
    const int r = i / per, c = (i % per) * 8;
    float vals[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r0 + r < n) load8(src + static_cast<size_t>(r0 + r) * width + c0 + c, vals);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[r * ld + c + e] = vals[e];
  }
}

// out[i][j] += As[ty*4 + i] . Bs[tx*2 + j] over one staged chunk of 64
// columns (As [kRows][kLdC], Bs [kTile][kLdC]).
__device__ __forceinline__ void dot_chunk(const float* As, const float* Bs, float out[4][2]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int d = 0; d < kChunk; d += 4) {
    float4 a[4], b[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(&As[(ty * 4 + i) * kLdC + d]);
#pragma unroll
    for (int j = 0; j < 2; ++j) b[j] = *reinterpret_cast<const float4*>(&Bs[(tx * 2 + j) * kLdC + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float s = out[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        out[i][j] = s;
      }
  }
}

// out[i][j] = A[a0 + ty*4 + i] . B[b0 + tx*2 + j] over the width, in
// chunks of 64 columns staged in As [kRows][kLdC] and Bs [kTile][kLdC];
// rows past na / nb count as zeros. Ends with the block synchronised.
template <typename T>
__device__ __forceinline__ void dot_tile(const T* A, int a0, int na, const T* B, int b0, int nb,
                                         int width, float* As, float* Bs, float out[4][2]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i][0] = out[i][1] = 0.f;
  for (int c0 = 0; c0 < width; c0 += kChunk) {
    stage<T, kRows>(As, kLdC, A, width, a0, na, c0, kChunk);
    stage<T, kTile>(Bs, kLdC, B, width, b0, nb, c0, kChunk);
    __syncthreads();
    dot_chunk(As, Bs, out);
    __syncthreads();
  }
}

// acc[i][j] (row ty*4 + i, column tx + 16 j of the chunk) += W[row] . M[:,
// column] over the tile's kTile rows: W [kRows][kLdS], M [kTile][kLdO]
// staged; columns past ncols (a multiple of 16) are left alone.
__device__ __forceinline__ void acc_tile(const float* W, const float* M, int ncols,
                                         float acc[4][kOut / 16]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int c = 0; c < kTile; ++c) {
    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = W[(ty * 4 + i) * kLdS + c];
#pragma unroll
    for (int j = 0; j < kOut / 16; ++j) {
      if (16 * j >= ncols) break;
      const float m = M[c * kLdO + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(w[i], m, acc[i][j]);
    }
  }
}

// f32 shared memory of one block: two staged chunks, the score tile, a
// staged output-width tile, and 3 x 64 row statistics
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kRows) * kLdC + kTile * kLdC + kRows * kLdS +
                          kTile * kLdO + 3 * kRows);
}

}  // namespace wide
}  // namespace qg
