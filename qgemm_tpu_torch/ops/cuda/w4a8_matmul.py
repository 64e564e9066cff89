"""Binding of kernel K4 (``csrc/w4a8_matmul.cu``): the W4A8 GEMM (int4
group-quantized weights, int8 per-slab activations) behind every int4
``QuantizedLinear``.

Replaces ``w4a8_matmul_pallas`` (``_w4a8_kernel``) of
``qgemm_tpu/ops/pallas/w4a8_matmul.py``. The source note in the .cu file
says what bounds it and how it is built. The wrapper that checks its
arguments, runs the plain version on CPU tensors and this launch on CUDA
tensors is ``qgemm_tpu_torch.ops.quantize.quantized_matmul_prequant_w4``.
"""

from __future__ import annotations

import ctypes

import torch

from qgemm_tpu_torch.ops.cuda import _build
from qgemm_tpu_torch.ops.cuda.gemv_plan import gemv_args
from qgemm_tpu_torch.ops.cuda.tile_plan import tile_args

X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.library("w4a8_matmul")
    fn = lib.qgemm_w4a8_matmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, i, p]
        fn.restype = i
    return fn


def w4a8_matmul_cuda(x: torch.Tensor, qpt: torch.Tensor, cw: torch.Tensor,
                     bk: int) -> torch.Tensor:
    """Launch K4 on checked CUDA tensors: x [m, k] f32/bf16, K-major packed
    int4 weights qpt int8 [n, kp/2] (kp = k rounded up to 128), group scales
    cw [kp/128, n], activation slabs of bk columns -> f32 [m, n]; m <= 16
    runs the GEMV on ``gemv_plan``'s launch plan, more rows the tile kernel
    on ``tile_plan``'s. Counts each launch in
    ``w4a8_matmul_cuda.launches``."""
    if not (x.is_cuda and x.device == qpt.device == cw.device):
        raise ValueError("x, qpt and cw must lie on one CUDA device")
    m, k = x.shape
    n, kp = qpt.shape[0], 2 * qpt.shape[1]
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    qpt = qpt.contiguous()
    if qpt.data_ptr() % 16:   # TMA reads the weights from a 16-byte aligned base
        qpt = qpt.clone()
    cw = cw.to(torch.float32).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    # one scratch allocation: the pre-pass's int8 codes xq [m, kp], then its
    # f32 slab scales ds [m, ceil(kp / bk)] (m * kp is a multiple of 128)
    xq = torch.empty((m * kp + 4 * m * -(-kp // bk),), dtype=torch.int8, device=x.device)
    rc = _lib()(x.data_ptr(), X_DTYPES[x.dtype], qpt.data_ptr(), cw.data_ptr(),
                xq.data_ptr(), xq.data_ptr() + m * kp, out.data_ptr(), m, n, k, kp, bk,
                *gemv_args("w4a8", 1, m, n, k, kp, bk), *tile_args("w4a8", 1, m, n, k, kp, bk),
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch("qgemm_w4a8_matmul", rc)
    w4a8_matmul_cuda.launches += 1
    return out


w4a8_matmul_cuda.launches = 0
