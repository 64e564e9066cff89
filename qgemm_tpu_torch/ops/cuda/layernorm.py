"""Wrapper of the fused residual + LayerNorm kernel (``csrc/layernorm.cu``),
row 13 of the TPU kernel table.

Replaces ``layernorm_residual_pallas`` / ``_ln_kernel`` of
``qgemm_tpu/ops/pallas/layernorm.py``: LN(x [+ residual]) * gamma + beta
over the last axis, in f32, in the kernel's own arithmetic (sums times
1/n, rsqrt), not ``ops/layernorm.layernorm``'s. It does not replace the
GPT's layer norms: JAX's model path uses the XLA ``layernorm``, and a
pre-LN block needs the residual sum itself. The source note in the .cu
file says what bounds it and how it is built.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from qgemm_tpu_torch.ops.cuda import _build
from qgemm_tpu_torch.ops.cuda.softmax import DTYPES, vector_ok
from qgemm_tpu_torch.ops.validation import check, check_float


def layernorm_residual_plain(x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                             gamma: Optional[torch.Tensor] = None,
                             beta: Optional[torch.Tensor] = None,
                             eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of the kernel, in f32: x (+ residual),
    mean = sum * (1/n), var = sum((x - mean)^2) * (1/n),
    (x - mean) * rsqrt(var + eps) * gamma + beta (ones and zeros when not
    given), cast to x's dtype."""
    n = x.shape[-1]
    inv_n = 1.0 / n
    xf = x.to(torch.float32)
    if residual is not None:
        xf = xf + residual.reshape(x.shape).to(torch.float32)
    mean = xf.sum(dim=-1, keepdim=True) * inv_n
    cx = xf - mean
    var = (cx * cx).sum(dim=-1, keepdim=True) * inv_n
    y = cx * torch.rsqrt(var + eps)
    g = torch.ones(n, device=x.device) if gamma is None else gamma.to(torch.float32)
    b = torch.zeros(n, device=x.device) if beta is None else beta.to(torch.float32)
    return (y * g.reshape(n) + b.reshape(n)).to(x.dtype)


def _lib():
    fn = _build.library("layernorm").qgemm_layernorm_residual
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = i
    return fn


def _row_param(name: str, t: Optional[torch.Tensor], x: torch.Tensor):
    if t is None:
        return None
    check_float(name, t)
    check(t.numel() == x.shape[-1], f"{name}: expected {x.shape[-1]} values, got "
          f"{tuple(t.shape)}")
    check(t.device == x.device, f"{name} must lie on x's device")
    return t.reshape(-1).to(torch.float32).contiguous()


def layernorm_residual(x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                       gamma: Optional[torch.Tensor] = None,
                       beta: Optional[torch.Tensor] = None,
                       eps: float = 1e-5) -> torch.Tensor:
    """LN(x [+ residual]) * gamma + beta over the last axis of x (any
    leading shape), in x's dtype; residual of x's shape, gamma and beta of
    its width, each optional. CPU tensors run the plain version; CUDA
    tensors launch the kernel (x and residual f32 or bf16) or raise.
    Counts each launch in ``layernorm_residual.launches``."""
    check_float("x", x)
    check(x.ndim >= 1 and x.shape[-1] > 0, f"x: expected a last axis, got {tuple(x.shape)}")
    if residual is not None:
        check_float("residual", residual)
        check(residual.numel() == x.numel(), f"residual {tuple(residual.shape)} does not "
              f"match x {tuple(x.shape)}")
    g, b = _row_param("gamma", gamma, x), _row_param("beta", beta, x)
    if not x.is_cuda:
        return layernorm_residual_plain(x, residual, g, b, eps)
    check(x.dtype in DTYPES, f"x: the layernorm kernel takes float32 or bfloat16, got {x.dtype}")
    n = x.shape[-1]
    x2 = x.reshape(-1, n).contiguous()
    out = torch.empty_like(x2)
    if x2.shape[0] == 0:
        return out.reshape(x.shape)
    r2 = None
    if residual is not None:
        check(residual.dtype in DTYPES, f"residual: the layernorm kernel takes float32 or "
              f"bfloat16, got {residual.dtype}")
        check(residual.device == x.device, "residual must lie on x's device")
        r2 = residual.reshape(-1, n).contiguous()
    vec = vector_ok(n, x2, out, *([r2] if r2 is not None else []))
    rc = _lib()(x2.data_ptr(), None if r2 is None else r2.data_ptr(),
                None if g is None else g.data_ptr(), None if b is None else b.data_ptr(),
                out.data_ptr(), DTYPES[x.dtype], DTYPES[r2.dtype] if r2 is not None else 0,
                x2.shape[0], n, int(vec), eps, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch("qgemm_layernorm_residual", rc)
    layernorm_residual.launches += 1
    return out.reshape(x.shape)


layernorm_residual.launches = 0
