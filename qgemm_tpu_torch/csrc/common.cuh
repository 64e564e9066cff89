// Small device helpers shared by the port's kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qg {

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t v) {
  return static_cast<float>(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round an f32 to the nearest bf16 and back: the "cast to bf16" of the TPU
// kernels, kept in an f32 register.
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Load 8 consecutive elements (16-byte aligned for bf16, 32-byte for f32)
// into f32 registers.
__device__ __forceinline__ void load8(const float* p, float out[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float out[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Four paged-pool KV codes of one 32-bit word as exact f32 values: the
// int8 codes of its bytes (BITS 8), or one sign-extended nibble of each
// byte (BITS 4; ``hi`` picks the high nibbles, the page's second half).
// Each code, biased to an unsigned byte u, becomes the f32 2^23 + u by one
// byte permute, and less 2^23 + the bias it is the code, exactly: no
// int-to-float convert, which runs at a quarter of the f32 rate.
template <int BITS>
__device__ __forceinline__ void kv_codes4(uint32_t w, bool hi, float out[4]) {
  uint32_t u;
  if constexpr (BITS == 8) {
    u = w ^ 0x80808080u;                               // code + 128
  } else {
    u = ((hi ? w >> 4 : w) & 0x0f0f0f0fu) ^ 0x08080808u;  // nibble + 8
  }
  constexpr float bias = BITS == 8 ? 8388736.f : 8388616.f;  // 2^23 + 128, 2^23 + 8
#pragma unroll
  for (int e = 0; e < 4; ++e)
    out[e] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7440 + e)) - bias;
}

// Two such codes as a bf16 pair, ``lo`` in the low half: an integer of at
// most 8 significant bits is its f32's high half, exactly.
__device__ __forceinline__ uint32_t pack_code_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Flat grids. A grid's y and z stop at 65,535 blocks, x at 2^31 - 1, so a
// kernel whose batch, head, expert or split count can grow takes a 1-D
// grid of (inner x outer) blocks and splits blockIdx.x itself. x runs
// fastest, so the blocks start in the order of the (inner, outer) grid
// they replace, and no arithmetic changes.
constexpr long long kMaxGridX = 0x7fffffffLL;

__host__ inline bool flat_grid_ok(long long blocks) { return blocks >= 1 && blocks <= kMaxGridX; }

// blockIdx.x as (i, o): i in [0, inner), the index that ran on grid x
struct FlatIdx {
  int i, o;
};
__device__ __forceinline__ FlatIdx flat_block(int inner) {
  return {static_cast<int>(blockIdx.x % static_cast<unsigned>(inner)),
          static_cast<int>(blockIdx.x / static_cast<unsigned>(inner))};
}

// Programmatic dependent launch (sm_90). A kernel launched by launch_pdl may
// start while the kernel ahead of it in the stream still runs:
// grid_dependency_wait() blocks until that kernel has finished and its
// writes are visible (a no-op in a kernel launched without the attribute),
// and launch_dependents() lets the next kernel start before this one ends.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Prefetch [p, p + bytes) from device memory into L2 (p 16-byte aligned,
// bytes a positive multiple of 16); no registers are written.
__device__ __forceinline__ void prefetch_l2(const void* p, int bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p), "r"(bytes) : "memory");
}

template <typename... Params, typename... Args>
cudaError_t launch_pdl(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                       cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

}  // namespace qg
