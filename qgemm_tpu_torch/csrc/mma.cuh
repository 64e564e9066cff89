// Warp-level tensor-core and asynchronous-copy helpers (sm_80+ PTX, run on
// sm_90a), shared by the port's mma.sync kernels.
//
// Fragment layouts of mma.sync m16n8k16 (row.col), for lane = 4 * g + t:
//   A (16 x 16, row-major), four 32-bit registers of two elements each:
//     a[0] = (row g, cols 2t, 2t+1), a[1] = (row g+8, cols 2t, 2t+1),
//     a[2] = (row g, cols 2t+8, 2t+9), a[3] = (row g+8, cols 2t+8, 2t+9);
//   B (16 x 8, k x n): b[0] = (k 2t, 2t+1; col g), b[1] = (k 2t+8, 2t+9; col g);
//   C (16 x 8, f32): c[0], c[1] = (row g, cols 2t, 2t+1), c[2], c[3] = row g+8.
// So the C fragments of two adjacent n-tiles, rounded to bf16 and packed in
// pairs, are the A fragment of one 16-wide k-chunk (``pack_bf16``): a
// product's result feeds the next product from registers.
// m16n8k32 s8 has the same layout with four int8 per register.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace qg {

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two f32 values rounded to bf16 (nearest even) in one register, ``lo`` in
// the low half: the lower-indexed element of an mma fragment pair.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// exp(x) as the tensor-core kernels take it: 2^(x * log2 e) on the SFU
// (ex2.approx, ~2 ulp; denormal results flush to 0, exp(-inf) = 0).
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 b16 matrices from shared memory: lanes 8i .. 8i+7 give the
// row addresses (16 bytes each) of matrix i, and r[i] receives, at lane
// 4g + t, elements (g, 2t) and (g, 2t+1) of matrix i (of its transpose
// with ``trans``).
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Asynchronous global -> shared copies (cp.async): ``src_bytes`` 0 fills the
// destination with zeros and reads nothing. 16-byte copies bypass L1 and
// need 16-byte-aligned addresses; 4-byte ones need 4-byte alignment.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed copy groups are pending.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace qg
