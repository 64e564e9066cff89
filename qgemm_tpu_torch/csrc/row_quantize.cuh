// The activation pre-pass of K1, K4 and K8: per (row, K segment) the absmax
// c of the segment and its int8 codes q = clip(rint(x * (127 / c)), -127,
// 127) (or truncation), written once for the GEMM kernels to read. The f32
// steps are the plain versions' (the scale 127 / c first, then x * scale,
// round half to even with __float2int_rn), so the codes match bit for bit.
#pragma once

#include <algorithm>

#include "common.cuh"

namespace qg {

constexpr float kQRange = 127.f;
constexpr float kEps = 1e-12f;
constexpr int kQuantMaxThreads = 1024;

// threads of a pre-pass block over a segment of ``seg`` columns: one 8-wide
// load each (whole warps), at most 1024
inline int quant_threads(int seg) {
  return std::min(kQuantMaxThreads, std::max(32, (seg / 8 + 31) / 32 * 32));
}

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

// 8 elements of a row from column i on, zeros at and past column k; ``vec``
// says rows are 16-byte aligned with k % 8 == 0
template <typename T>
__device__ __forceinline__ void load8_masked(const T* row, int i, int k, int vec, float v[8]) {
  if (vec && i + 8 <= k) {
    load8(row + i, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = i + j < k ? to_f32(row[i + j]) : 0.f;
}

// grid (rows * nseg), quant_threads(seg) threads. Block b is segment s = b %
// nseg of row r = b / nseg: columns [s * seg, min((s + 1) * seg, kp)) of x
// [rows, k] (zeros at and past k) and of the codes xq [rows, kp] (kp and seg
// multiples of 8); scale[b] = c / div with c = max(absmax, 1e-12). With
// ``given`` (the caller's scales, one per block: a row-parallel shard
// quantizes on the row absmax of the whole K) c = given[b], no absmax is
// taken and ``scale`` is not written.
template <typename T>
__global__ void __launch_bounds__(kQuantMaxThreads)
row_quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ scale,
                    int k, int kp, int seg, int nseg, int vec, int truncate, float div,
                    const float* __restrict__ given = nullptr) {
  __shared__ float red[kQuantMaxThreads / 32];
  launch_dependents();   // the GEMV may start prefetching its weights
  const int row = blockIdx.x / nseg, s = blockIdx.x % nseg;
  const int k0 = s * seg, k1 = min(k0 + seg, kp);
  const int step = blockDim.x * 8;
  const T* xr = x + static_cast<size_t>(row) * k;
  float c;
  if (given != nullptr) {
    c = given[blockIdx.x];
  } else {
    float mx = 0.f;
    for (int i = k0 + threadIdx.x * 8; i < min(k1, k); i += step) {
      float v[8];
      load8_masked(xr, i, k, vec, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fabsf(v[j]));
    }
    mx = warp_max(mx);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
    __syncthreads();
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) mx = fmaxf(mx, red[w]);
    c = fmaxf(mx, kEps);
    if (threadIdx.x == 0) scale[blockIdx.x] = c / div;
  }
  const float sc = kQRange / c;
  for (int i = k0 + threadIdx.x * 8; i < k1; i += step) {
    float v[8];
    load8_masked(xr, i, k, vec, v);
    *reinterpret_cast<uint2*>(xq + static_cast<size_t>(row) * kp + i) = quant8(v, sc, truncate);
  }
}

// 16 bytes of int8 codes from device memory, or zeros where ``ok`` is false
// (nothing is read then)
__device__ __forceinline__ int4 load16(const int8_t* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const int4*>(p)) : make_int4(0, 0, 0, 0);
}

}  // namespace qg
