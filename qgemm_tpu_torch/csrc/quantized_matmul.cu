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
//
// The kernels, their arithmetic and their design are in int8_gemm.cuh,
// shared with K8 (expert_matmul.cu); K1 runs them on one matrix.
#include "int8_gemm.cuh"

// x [m, k] (x_dtype 0 = f32, 1 = bf16), wt int8 [n, k], cw f32 [n],
// cx f32 [m] scratch, out f32 [m, n]. Returns cudaGetLastError().
extern "C" int qgemm_quantized_matmul(const void* x, int x_dtype, const void* wt,
                                      const void* cw, void* cx, void* out, int m,
                                      int n, int k, int truncate, void* stream) {
  return static_cast<int>(qg::gemm::launch_any(x, x_dtype, wt, cw, cx, out, 1, m, n, k,
                                               truncate, 0,
                                               static_cast<cudaStream_t>(stream)));
}
