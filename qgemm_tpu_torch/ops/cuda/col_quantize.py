"""Wrapper of kernel K9 (``csrc/col_quantize.cu``): per-column absmax int8
quantization of weights, in f32, written in the K-major layout that K1 and
K8 read.

Replaces ``col_quantize_pallas`` / ``_col_quantize_kernel`` of
``qgemm_tpu/ops/pallas/quantized_matmul.py``. It quantizes every expert
weight (``models/moe.py::quantize_expert_weights``) and the weight of the
dynamic ``ops/quantize.py::quantized_matmul``. Its launch plan (one read of
w on a thread-block cluster, or the two-pass route past the cluster's K) is
``ops/cuda/quant_plan.py``'s. The dense
``quantize_weights`` keeps computing in the weight's dtype, as the JAX
package's does, and does not come here. The source note in the .cu file
says what bounds it and how it is built.
"""

from __future__ import annotations

import ctypes

import torch

from qgemm_tpu_torch.ops.cuda import _build
from qgemm_tpu_torch.ops.cuda.quant_plan import col_quantize_args
from qgemm_tpu_torch.ops.validation import check, check_float

QRANGE = 127.0
_EPS = 1e-12
ROUNDING = {"nearest": 0, "truncate": 1}
W_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def col_quantize_plain(w: torch.Tensor, rounding: str = "nearest"):
    """Plain PyTorch version of K9: w [..., k, n] float -> (int8 codes
    [..., n, k] K-major, f32 absmax [..., 1, n]), every step in f32 as the
    TPU kernel computes: c = max(max_k |w|, 1e-12), codes
    clip(round(w * (127 / c))) (round half to even) or, for ``"truncate"``,
    trunc(w * (127 / c))."""
    wf = w.to(torch.float32)
    c = torch.clamp_min(wf.abs().amax(dim=-2, keepdim=True), _EPS)
    # a true division: torch evaluates `float / tensor` as float * (1 / c)
    scaled = wf * (torch.full_like(c, QRANGE) / c)
    if rounding == "nearest":
        q = torch.clamp(torch.round(scaled), -QRANGE, QRANGE)
    else:
        q = torch.trunc(scaled)
    return q.to(torch.int8).transpose(-1, -2).contiguous(), c


def _lib():
    fn = _build.library("col_quantize").qgemm_col_quantize
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = i
    return fn


def col_quantize(w: torch.Tensor, rounding: str = "nearest"):
    """w [E, k, n] or [k, n] (f32 or bf16) -> (codes int8 [E, n, k] or
    [n, k], K-major; scales f32 [E, 1, n] or [1, n]). CPU tensors run the
    plain version; CUDA tensors launch K9 (one launch for all E on the
    cluster route) or raise. Counts each launch in ``col_quantize.launches``."""
    check(w.ndim in (2, 3), f"w: expected [k, n] or [E, k, n], got shape {tuple(w.shape)}")
    check_float("w", w)
    check(rounding in ROUNDING, f"unknown rounding {rounding!r}")
    if not w.is_cuda:
        return col_quantize_plain(w, rounding)
    check(w.dtype in W_DTYPES, f"w: K9 takes float32 or bfloat16, got {w.dtype}")
    e, k, n = w.shape if w.ndim == 3 else (1, *w.shape)
    w = w.contiguous()
    if w.data_ptr() % 16:
        w = w.clone()     # the kernel's 16-byte loads need an aligned base
    route, cluster, rows, smem, words = col_quantize_args(e, k, n, str(w.dtype)[6:])
    qt = torch.empty((*w.shape[:-2], n, k), dtype=torch.int8, device=w.device)
    c = torch.empty((*w.shape[:-2], 1, n), dtype=torch.float32, device=w.device)
    # the two_pass route's column maxima, zeroed by its launch
    cmax = torch.empty((words,), dtype=torch.int32, device=w.device) if words else None
    rc = _lib()(w.data_ptr(), W_DTYPES[w.dtype], qt.data_ptr(), c.data_ptr(),
                cmax.data_ptr() if words else None, e, k, n, ROUNDING[rounding], route, cluster,
                rows, smem, torch.cuda.current_stream(w.device).cuda_stream)
    _build.check_launch("qgemm_col_quantize", rc)
    col_quantize.launches += 1
    return qt, c


col_quantize.launches = 0
