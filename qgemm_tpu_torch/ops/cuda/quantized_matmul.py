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
from types import SimpleNamespace
from typing import Optional

import torch

from qgemm_tpu_torch.ops.cuda import _build
from qgemm_tpu_torch.ops.cuda.gemv_plan import gemv_args
from qgemm_tpu_torch.ops.cuda.tile_plan import tile_args

ROUNDING = {"nearest": 0, "truncate": 1}
X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.library("quantized_matmul")
    fn = lib.qgemm_quantized_matmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p, p]
        fn.restype = i
    return fn


def quantized_matmul_cuda(x: torch.Tensor, wt: torch.Tensor, cw: torch.Tensor,
                          rounding: str, cx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K1 on checked CUDA tensors: x [m, k] f32/bf16, K-major int8
    weights wt [n, k] (k % 16 == 0: the caller pads K), per-column scales cw [1, n] -> f32
    [m, n]. The pre-pass writes x's int8 codes into ``xq``; m <= 16 runs the
    GEMV on ``gemv_plan``'s launch plan. ``cx`` f32 [m, 1], where given, is
    the caller's row scales: the pre-pass quantizes on them and takes no
    absmax. Counts each launch in ``quantized_matmul_cuda.launches``, and a
    launch on given scales in ``given_cx.launches`` too."""
    if not (x.is_cuda and x.device == wt.device == cw.device):
        raise ValueError("x, wt and cw must lie on one CUDA device")
    m, k = x.shape
    n = wt.shape[0]
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    wt = wt.contiguous()
    if wt.data_ptr() % 16:   # TMA reads the weights from a 16-byte aligned base
        wt = wt.clone()
    cw = cw.to(torch.float32).contiguous()
    if cx is not None:
        if cx.device != x.device or cx.dtype != torch.float32 or cx.numel() != m:
            raise ValueError(f"cx: expected f32 row scales [{m}, 1] on {x.device}")
        cx = cx.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    # one scratch allocation: the pre-pass's int8 codes xq [m, k], then its
    # f32 row scales [m] (m * k is a multiple of 16)
    xq = torch.empty((m * k + 4 * m,), dtype=torch.int8, device=x.device)
    rc = _lib()(x.data_ptr(), X_DTYPES[x.dtype], wt.data_ptr(), cw.data_ptr(),
                xq.data_ptr(), xq.data_ptr() + m * k, out.data_ptr(), m, n, k,
                ROUNDING[rounding],
                *gemv_args("int8", 1, m, n, k), *tile_args("int8", 1, m, n, k),
                None if cx is None else cx.data_ptr(),
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch("qgemm_quantized_matmul", rc)
    quantized_matmul_cuda.launches += 1
    if cx is not None:
        given_cx.launches += 1
    return out


quantized_matmul_cuda.launches = 0
# K1's launches on caller-given row scales (the row-parallel route), also
# counted in quantized_matmul_cuda.launches
given_cx = SimpleNamespace(launches=0)
