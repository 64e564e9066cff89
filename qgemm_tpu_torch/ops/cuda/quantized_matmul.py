"""Binding of kernel K1 (``csrc/quantized_matmul.cu``): fused row-quantize
-> int8 GEMM -> dequant, the matmul behind every ``QuantizedLinear``.

Replaces ``quantized_matmul_prequant_pallas`` (``_qmm_fused_cx_kernel`` and
``_qmm_kernel``) of ``qgemm_tpu/ops/pallas/quantized_matmul.py``. The source
note in the .cu file says what bounds it and how it is built. The wrapper
that checks its arguments, runs the plain version on CPU tensors and this
launch on CUDA tensors is ``qgemm_tpu_torch.ops.quantize.
quantized_matmul_prequant``, as the JAX package's ``quantize`` module
dispatches to its Pallas kernel.
"""

from __future__ import annotations

import ctypes

import torch

from qgemm_tpu_torch.ops.cuda import _build

ROUNDING = {"nearest": 0, "truncate": 1}
X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.library("quantized_matmul")
    fn = lib.qgemm_quantized_matmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, p, i, i, i, i, p]
        fn.restype = i
    return fn


def quantized_matmul_cuda(x: torch.Tensor, wt: torch.Tensor, cw: torch.Tensor,
                          rounding: str) -> torch.Tensor:
    """Launch K1 on checked CUDA tensors: x [m, k] f32/bf16, K-major int8
    weights wt [n, k] (k % 16 == 0), per-column scales cw [1, n] -> f32
    [m, n]. Counts each launch in ``quantized_matmul_cuda.launches``."""
    if not (x.is_cuda and x.device == wt.device == cw.device):
        raise ValueError("x, wt and cw must lie on one CUDA device")
    m, k = x.shape
    n = wt.shape[0]
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    wt = wt.contiguous()
    cw = cw.to(torch.float32).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    cx = torch.empty((m,), dtype=torch.float32, device=x.device)
    rc = _lib()(x.data_ptr(), X_DTYPES[x.dtype], wt.data_ptr(), cw.data_ptr(),
                cx.data_ptr(), out.data_ptr(), m, n, k, ROUNDING[rounding],
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch("qgemm_quantized_matmul", rc)
    quantized_matmul_cuda.launches += 1
    return out


quantized_matmul_cuda.launches = 0
