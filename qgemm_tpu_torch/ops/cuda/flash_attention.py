"""Wrapper of kernel K3 (``csrc/flash_attention.cu``): blockwise attention
forward returning O and the per-row logsumexp.

Replaces ``_flash_attention_fwd_impl`` / ``_flash_kernel`` of
``qgemm_tpu/ops/pallas/flash_attention.py``. ``flash_attention_fwd`` is the
forward alone, so a later port of the blockwise backward can wrap it in a
``torch.autograd.Function`` that saves (q, k, v, O, lse). The source note in
the .cu file says what bounds it and how it is built.
"""

from __future__ import annotations

import ctypes
import math

import torch

from qgemm_tpu_torch.ops.cuda import _build
from qgemm_tpu_torch.ops.validation import check, check_attention_4d

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False):
    """Plain PyTorch version of K3 (the TPU kernel's math without its
    blocking): products in the input dtype with f32 sums, masked entries
    p = 0 (k >= Sk; k > q when causal), P cast to V's dtype for the second
    product. Returns (O [B, H, Sq, Dv] in q's dtype, lse f32 [B, H, Sq])."""
    d = q.shape[-1]
    sq, sk = q.shape[2], k.shape[2]
    s = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2)) \
        * (1.0 / math.sqrt(d))
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
    """q [B, H, Sq, D], k/v [B, H, Sk, D] -> (O [B, H, Sq, D], lse f32
    [B, H, Sq]); causal means key j attends query i iff j <= i. CPU tensors
    run the plain version; CUDA tensors launch K3 (f32 or bf16, D in
    {64, 128}, Dv == D) or raise."""
    check_attention_4d(q, k, v)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    check(q.dtype in _DTYPES and k.dtype == v.dtype == q.dtype,
          f"K3 takes float32 or bfloat16 q/k/v of one dtype, got "
          f"{q.dtype}/{k.dtype}/{v.dtype}")
    check(d in (64, 128) and v.shape[3] == d,
          f"K3 takes head_dim 64 or 128 with Dv == D, got {d}/{v.shape[3]}")
    check(k.is_cuda and v.is_cuda and q.device == k.device == v.device,
          "flash_attention: q, k and v must lie on one CUDA device")
    check(b * h <= 65535, f"K3 takes at most 65535 batch*heads, got {b * h}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), _DTYPES[q.dtype], b * h, sq, sk, d, int(causal),
                1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch("qgemm_flash_attention_fwd", rc)
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention(q, k, v, causal: bool = False) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v, blockwise (``qgemm_tpu``'s
    ``flash_attention``, forward only)."""
    return flash_attention_fwd(q, k, v, causal)[0]
