"""Wrapper of kernel K3 (``csrc/flash_attention.cu``): blockwise attention
forward returning O and the per-row logsumexp.

Replaces ``_flash_attention_fwd_impl`` / ``_flash_kernel`` of
``qgemm_tpu/ops/pallas/flash_attention.py``. ``flash_attention_fwd`` is the
forward alone; ``flash_attention`` is differentiable (JAX's ``custom_vjp``):
a ``torch.autograd.Function`` whose forward is K3 and saves (q, k, v, O,
lse) and whose backward is kernel K7 (``flash_attention_bwd.py``). CPU
tensors run the two plain versions. The source note in the .cu file says
what bounds it and how it is built.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from qgemm_tpu_torch.ops.cuda import _build
from qgemm_tpu_torch.ops.cuda.flash_attention_bwd import flash_attention_bwd
from qgemm_tpu_torch.ops.validation import (check, check_attention_4d, pad_last,
                                            padded_head_dim)

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False, scale: Optional[float] = None):
    """Plain PyTorch version of K3 (the TPU kernel's math without its
    blocking): products in the input dtype with f32 sums, masked entries
    p = 0 (k >= Sk; k > q when causal), P cast to V's dtype for the second
    product; ``scale`` defaults to 1/sqrt(D). Returns (O [B, H, Sq, Dv] in
    q's dtype, lse f32 [B, H, Sq])."""
    sq, sk = q.shape[2], k.shape[2]
    s = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2)) \
        * (scale or 1.0 / math.sqrt(q.shape[-1]))
    if causal:
        mask = (torch.arange(sk, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = torch.where(mask, p, torch.zeros_like(p))
    l = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    o = torch.matmul(p.to(v.dtype).to(torch.float32), v.to(torch.float32)) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def _lib():
    fn = _build.library("flash_attention").qgemm_flash_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = i
    return fn


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False):
    """q [B, H, Sq, D], k [B, H, Sk, D], v [B, H, Sk, Dv] -> (O [B, H, Sq, Dv],
    lse f32 [B, H, Sq]); causal means key j attends query i iff j <= i. CPU
    tensors run the plain version; CUDA tensors launch K3 (f32 or bf16, D
    and Dv up to 128: q, k and v are zero-padded to the kernel's width
    when D or Dv is not 32, 64 or 128, or they differ) or raise."""
    check_attention_4d(q, k, v)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    check(q.dtype in _DTYPES and k.dtype == v.dtype == q.dtype,
          f"K3 takes float32 or bfloat16 q/k/v of one dtype, got "
          f"{q.dtype}/{k.dtype}/{v.dtype}")
    check(k.is_cuda and v.is_cuda and q.device == k.device == v.device,
          "flash_attention: q, k and v must lie on one CUDA device")
    check(b * h <= 65535, f"K3 takes at most 65535 batch*heads, got {b * h}")
    dv = v.shape[3]
    dp = padded_head_dim(max(d, dv))
    q, k, v = (pad_last(t, dp) for t in (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), _DTYPES[q.dtype], b * h, sq, sk, dp, int(causal),
                1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch("qgemm_flash_attention_fwd", rc)
    flash_attention_fwd.launches += 1
    return (o if dp == dv else o[..., :dv].contiguous()), lse


flash_attention_fwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """K3 forward saving (q, k, v, O, lse); K7 backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_attention_fwd(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, g, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = False) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v, blockwise and differentiable
    (``qgemm_tpu``'s ``flash_attention``)."""
    return _FlashAttention.apply(q, k, v, causal)
