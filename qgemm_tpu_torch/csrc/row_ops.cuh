// Shared pieces of the row kernels (softmax.cu, layernorm.cu): one block
// per row, the row held in registers as f32, block-wide reductions.
//
// A thread owns the 16-byte vector slots tid, tid + NT, ... of its row
// (V = 4 f32 or 8 bf16 elements a slot), MAXV slots at most, so a block of
// NT <= 1024 threads holds rows of up to NT * MAXV * V elements. Where the
// width is a multiple of V (every row then starts 16-byte aligned) a slot
// is one vector load; otherwise each slot loads its V elements one by one
// and the elements past the width are masked (the TPU kernels' padded
// lanes). Rows wider than the registers hold are read from device memory
// once per pass instead (the loop variants in each kernel).
#pragma once

#include "common.cuh"

namespace qg {
namespace rows {

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Load V elements starting at element e0 of a row of width n; `vec` means
// the whole slot is inside the row and 16-byte aligned. Lanes past n get
// `fill`.
template <typename T>
__device__ __forceinline__ void load_slot(const T* row, int e0, int n, bool vec, float fill,
                                          float* out) {
  constexpr int V = Vec<T>::N;
  if (vec && e0 + V <= n) {
    if constexpr (V == 4) {
      const float4 a = *reinterpret_cast<const float4*>(row + e0);
      out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    } else {
      load8(row + e0, out);
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = e0 + j < n ? to_f32(row[e0 + j]) : fill;
  }
}

template <typename T>
__device__ __forceinline__ void store_slot(T* row, int e0, int n, bool vec, const float* v) {
  constexpr int V = Vec<T>::N;
  if (vec && e0 + V <= n) {
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(row + e0) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i]));
        const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1]));
        w[i] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(row + e0) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (e0 + j < n) row[e0 + j] = from_f32<T>(v[j]);
  }
}

// Block-wide max or sum of one value per thread; every thread gets the
// result. `red` is 32 floats of shared memory; blockDim.x a multiple of 32.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();                 // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = lane < nw ? red[lane] : (MAX ? neg_inf() : 0.f);
  return MAX ? warp_max(r) : warp_sum(r);
}

// Threads per block and register slots for a row of n elements of T: the
// fewest slots (1, 2, 4 or 8) that fit the row in 256 threads, else 8
// slots in up to 1024 threads; 0 slots means the row is too wide for
// registers.
template <typename T>
inline void plan(int n, int* threads, int* slots) {
  const int nvec = (n + Vec<T>::N - 1) / Vec<T>::N;
  for (int s = 1; s <= 8; s *= 2) {
    const int t = (nvec + s - 1) / s;
    if (t <= 256 || (s == 8 && t <= 1024)) {
      *slots = s;
      *threads = ((t < 32 ? 32 : t) + 31) / 32 * 32;
      return;
    }
  }
  *slots = 0;
  *threads = 1024;
}

}  // namespace rows
}  // namespace qg
