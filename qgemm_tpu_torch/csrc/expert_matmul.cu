// Kernel K8: grouped (per-expert) fused row-quantize -> int8 GEMM ->
// dequant, for Hopper (sm_90a): the two products of the int8 MoE expert
// FFN.
//
// Replaces the TPU kernel _expert_qmm_kernel of
// qgemm_tpu/ops/pallas/expert_matmul.py, behind
// grouped_quantized_matmul_pallas (and quantized_expert_ffn_pallas, its
// up -> ReLU -> down composition). Same contract and the same epilogue
// order, (acc * (cx / 127^2)) * cw, so it equals its plain version
// (grouped_quantized_matmul_plain) bit for bit.
//
// What bounds it on the H100: at decode every expert holds C = 8 capacity
// slots (most of them empty), so each call streams all E experts' int8
// weights once for ~2 int8 operations per byte — the weight stream (67 MB
// per call at E 8, 2048 x 4096). At prefill (C = 168 for a 512-token
// bucket) it is still the bytes (weights, f32 x and out: ~225 operations a
// byte, under the card's ~590). Measured on an H100 80GB HBM3 at 700 W (PERF.md): the
// decode GEMV at 0.61-0.64 of the byte bound, the prefill tile kernel at
// ~0.4 of it (C 168 and 328).
//
// Design: K1's kernels (int8_gemm.cuh) with the expert as a grid
// dimension — the tensor-core GEMV (qmm_gemv_kernel, W straight from
// device memory into mma.sync A fragments, X's codes held in registers)
// for C <= 16, the wgmma tile kernel fed by TMA above, its tensor maps 3-D
// over [E, rows, K] so a tile never reads the next expert's rows; the row
// scales and int8 codes of all E * C rows come from one pre-pass. The
// ReLU between the two products is fused into the first call's epilogue
// (relu = 1); its output stays f32, because the second call row-quantizes
// it. Empty capacity rows (all zeros) give cx = 1e-12, codes 0 and an
// output of exactly 0.
#include "int8_gemm.cuh"

// x [e, c, k] (x_dtype 0 = f32, 1 = bf16), wt int8 [e, n, k], cw f32 [e, n],
// xq int8 [e * c, k] and cx f32 [e * c] scratch, out f32 [e, c, n]; for
// c <= 16 the GEMV's plan (warps, k_slice, smem: ops/cuda/gemv_plan.py),
// for more rows the tile kernel's (tile_bm, tile_bn, tile_smem:
// ops/cuda/tile_plan.py), each refused unless it matches a compiled
// instantiation. Returns cudaGetLastError().
extern "C" int qgemm_grouped_quantized_matmul(const void* x, int x_dtype, const void* wt,
                                              const void* cw, void* xq, void* cx, void* out,
                                              int e, int c, int n, int k, int relu, int warps,
                                              int k_slice, int smem, int tile_bm, int tile_bn,
                                              int tile_smem, void* stream) {
  return static_cast<int>(qg::gemm::launch_any(x, x_dtype, wt, cw, xq, cx, out, e, c, n, k, 0,
                                               relu, {warps, k_slice, smem},
                                               {tile_bm, tile_bn, tile_smem},
                                               static_cast<cudaStream_t>(stream)));
}
