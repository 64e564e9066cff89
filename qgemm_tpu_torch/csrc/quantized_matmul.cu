// Kernel K1: fused row-quantize -> int8 GEMM -> dequant, for Hopper (sm_90a).
//
// Replaces the TPU kernels _qmm_fused_cx_kernel (full-K, in-kernel row
// absmax) and _qmm_kernel (split-K with a separate absmax pass) of
// qgemm_tpu/ops/pallas/quantized_matmul.py, behind
// quantized_matmul_prequant_pallas.
//
// What bounds it on the H100: at decode (m <= 16 rows) it is the weight
// stream — every int8 weight byte is read once per call and the card does
// ~2 int8 operations per byte, far under its 1979 TOP/s : 3.35 TB/s
// balance; at prefill (m = prompt bucket) it is the int8 tensor-core rate.
// A decode call is two launches, the pre-pass and the GEMV, so at the
// small GPT_6_7B shape (k = n = 4096, 16.8 MB, 5 us at the byte bound) their
// latency rather than the stream sets its time.
//
// Design: the pre-pass writes the int8 codes once; the decode GEMV feeds W
// from device memory straight into mma.sync fragments, holds X's codes in
// registers, splits K across a block's warps and is launched with
// programmatic dependent launch, its first weights prefetched into L2
// while the pre-pass runs. The prefill tile kernel runs wgmma on tiles of
// up to 128 x 256 that a producer warp brings into a shared-memory ring by
// TMA, on tensor maps built per call (cuTensorMapEncodeTiled, reached
// through the runtime, so no -lcuda). Measured on an H100 80GB HBM3 at 700
// W (PERF.md): at m 8, 0.35 of the byte bound at k = n = 4096, 0.57-0.66 at
// the FFN shapes, 0.81 at the lm_head; at m 512, 0.27 of the operations
// bound at k = n = 4096 and ~0.4 at the FFN shapes and the lm_head, level
// with cuBLAS's int8 product alone. The kernels, their arithmetic and their
// design are in int8_gemm.cuh, shared with K8 (expert_matmul.cu); K1 runs
// them on one matrix.
#include "int8_gemm.cuh"

// x [m, k] (x_dtype 0 = f32, 1 = bf16), wt int8 [n, k], cw f32 [n], xq int8
// [m, k] and cx f32 [m] scratch, out f32 [m, n]; for m <= 16 the GEMV's plan
// (warps, k_slice, smem: ops/cuda/gemv_plan.py), for more rows the tile
// kernel's (tile_bm, tile_bn, tile_smem: ops/cuda/tile_plan.py), each
// refused unless it matches a compiled instantiation. ``given_cx`` f32 [m],
// or null: the caller's row scales (the TPU kernel _qmm_kernel's cx input,
// which a row-parallel shard takes from the all-reduced absmax of the whole
// K); the pre-pass quantizes x with them and writes no scale. Returns
// cudaGetLastError().
extern "C" int qgemm_quantized_matmul(const void* x, int x_dtype, const void* wt,
                                      const void* cw, void* xq, void* cx, void* out, int m,
                                      int n, int k, int truncate, int warps, int k_slice,
                                      int smem, int tile_bm, int tile_bn, int tile_smem,
                                      const void* given_cx, void* stream) {
  return static_cast<int>(qg::gemm::launch_any(x, x_dtype, wt, cw, xq, cx, out, 1, m, n, k,
                                               truncate, 0, {warps, k_slice, smem},
                                               {tile_bm, tile_bn, tile_smem},
                                               static_cast<cudaStream_t>(stream), given_cx));
}
