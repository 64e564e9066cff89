"""Wrapper of kernel K8 (``csrc/expert_matmul.cu``): the grouped
(per-expert) fused row-quantize -> int8 GEMM -> dequant behind every
quantized MoE expert FFN.

Replaces ``grouped_quantized_matmul_pallas`` / ``_expert_qmm_kernel`` of
``qgemm_tpu/ops/pallas/expert_matmul.py`` and computes what it computes, in
its epilogue order: out = (acc * (cx / 127^2)) * cw. The JAX model path
(``qgemm_tpu/models/moe.py::quantized_expert_ffn``) keeps an einsum that
dequantizes as acc * (cx * cw) / 127^2, which can differ in the last bit;
the port runs K8 on its model path. The source note in the .cu file says
what bounds it and how it is built.
"""

from __future__ import annotations

import ctypes

import torch

from qgemm_tpu_torch.ops.cuda import _build
from qgemm_tpu_torch.ops.cuda.gemv_plan import gemv_args
from qgemm_tpu_torch.ops.cuda.tile_plan import tile_args
from qgemm_tpu_torch.ops.quantize import QRANGE, absmax_quantize, int8_matmul, k_tile
from qgemm_tpu_torch.ops.validation import (check, check_dtype, check_float, check_rank,
                                            pad_last)

X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def grouped_quantized_matmul_plain(x: torch.Tensor, wt: torch.Tensor, cw: torch.Tensor,
                                   relu: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K8: per (expert, row) the f32 row absmax and
    round-to-nearest int8 codes, an exact int32 product per expert, and
    (acc * (cx * (1 / 127^2))) * cw; then max(., 0) with ``relu``.
    x [E, C, K] float, wt int8 [E, N, K], cw f32 [E, 1, N] -> f32 [E, C, N]."""
    xq, cx = absmax_quantize(x.to(torch.float32), axis=-1)
    acc = int8_matmul(xq, wt.transpose(1, 2))
    out = (acc.to(torch.float32) * (cx * (1.0 / (QRANGE * QRANGE)))) * cw
    return torch.relu(out) if relu else out


def _lib():
    fn = _build.library("expert_matmul").qgemm_grouped_quantized_matmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, p]
        fn.restype = i
    return fn


def grouped_quantized_matmul(x: torch.Tensor, wt: torch.Tensor, cw: torch.Tensor,
                             relu: bool = False) -> torch.Tensor:
    """x [E, C, K] (f32 or bf16) @ per-expert int8 weights (K-major wt
    [E, N, K], scales cw [E, 1, N]) -> f32 [E, C, N], ReLU applied in the
    epilogue with ``relu``. CPU tensors run the plain version; CUDA tensors
    launch K8 (C <= 16 on ``gemv_plan``'s GEMV, more rows on
    ``tile_plan``'s tile kernel) or raise (a K that is not a
    multiple of 16 is zero-padded, x and the weight codes, on that call
    only). Counts each launch in ``grouped_quantized_matmul.launches``."""
    check_rank("x", x, 3)
    check_rank("wt", wt, 3)
    check_float("x", x)
    check_dtype("wt", wt, torch.int8)
    e, c, k = x.shape
    n = wt.shape[1]
    check(wt.shape[0] == e and wt.shape[2] == k,
          f"x {tuple(x.shape)} @ wt {tuple(wt.shape)}: expected wt [{e}, N, {k}]")
    check(tuple(cw.shape) == (e, 1, n),
          f"cw: expected per-(expert, column) scales {(e, 1, n)}, got {tuple(cw.shape)}")
    if not x.is_cuda:
        return grouped_quantized_matmul_plain(x, wt, cw, relu)
    check(x.dtype in X_DTYPES, f"x: K8 takes float32 or bfloat16, got {x.dtype}")
    check(x.device == wt.device == cw.device, "x, wt and cw must lie on one CUDA device")
    out = torch.empty((e, c, n), dtype=torch.float32, device=x.device)
    if c == 0:
        return out
    k = k_tile(k)
    x, wt = pad_last(x, k), pad_last(wt, k)
    if x.data_ptr() % 16:
        x = x.clone()
    wt = wt.contiguous()
    if wt.data_ptr() % 16:   # TMA reads the weights from a 16-byte aligned base
        wt = wt.clone()
    cw = cw.to(torch.float32).contiguous()
    # one scratch allocation: the pre-pass's int8 codes [E * C, K], then its
    # f32 row scales [E * C] (E * C * K is a multiple of 16)
    xq = torch.empty((e * c * k + 4 * e * c,), dtype=torch.int8, device=x.device)
    rc = _lib()(x.data_ptr(), X_DTYPES[x.dtype], wt.data_ptr(), cw.data_ptr(), xq.data_ptr(),
                xq.data_ptr() + e * c * k, out.data_ptr(), e, c, n, k, int(relu),
                *gemv_args("int8", e, c, n, k), *tile_args("int8", e, c, n, k),
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch("qgemm_grouped_quantized_matmul", rc)
    grouped_quantized_matmul.launches += 1
    return out


grouped_quantized_matmul.launches = 0


def quantized_expert_ffn_kernel(expert_in: torch.Tensor, w_up, w_down) -> torch.Tensor:
    """The int8 expert FFN through K8 (JAX ``quantized_expert_ffn_pallas``):
    up with the ReLU fused into its epilogue, then down. The hidden
    activation stays f32 between the two launches: the second one
    row-quantizes it, and a bf16 copy would flip codes. ``w_up`` and
    ``w_down`` carry K-major codes ``qt`` [E, N, K] and scales ``c``
    [E, 1, N]. expert_in [E, C, d] -> f32 [E, C, d]."""
    h = grouped_quantized_matmul(expert_in, w_up.qt, w_up.c, relu=True)
    return grouped_quantized_matmul(h, w_down.qt, w_down.c)
