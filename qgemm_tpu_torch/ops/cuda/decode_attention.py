"""Wrapper of kernel K2 (``csrc/decode_attention.cu``): one decode step of
attention over the int8 (or float) KV cache.

Replaces ``decode_attention`` / ``_decode_kernel`` of
``qgemm_tpu/ops/pallas/decode_attention.py``. The source note in the .cu
file says what bounds it and how it is built.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from qgemm_tpu_torch.ops.cuda import _build
from qgemm_tpu_torch.ops.kv_cache import QRANGE
from qgemm_tpu_torch.ops.validation import check, check_rank

_NEG_INF = -1e30
_KV_DTYPES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}


def _check(q, k_cache, v_cache, lengths, kc, vc):
    for name, a in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        check_rank(name, a, 4)
    check(q.shape[2] == 1, f"q: decode step expects Sq == 1, got {tuple(q.shape)}")
    check(k_cache.shape == v_cache.shape,
          f"k_cache {tuple(k_cache.shape)} != v_cache {tuple(v_cache.shape)}")
    check(q.shape[0] == k_cache.shape[0]
          and q.shape[1] % k_cache.shape[1] == 0
          and q.shape[3] == k_cache.shape[3],
          f"q {tuple(q.shape)} incompatible with cache {tuple(k_cache.shape)}")
    check(tuple(lengths.shape) == (q.shape[0],),
          f"lengths: expected shape ({q.shape[0]},), got {tuple(lengths.shape)}")
    check((kc is None) == (vc is None), "pass both kc and vc or neither")
    check((kc is not None) == (k_cache.dtype == torch.int8),
          "an int8 cache needs kc/vc scales; a float cache takes none")


def decode_attention_plain(q, k_cache, v_cache, lengths, kc=None, vc=None):
    """Plain PyTorch version of K2 (and of the TPU kernel's math, without
    its blocking): products in bf16 (int8 cache) or the cache's float
    dtype with f32 sums, per-position scales, length mask, softmax in f32,
    p * vc/127 cast to the product dtype before the V product."""
    b, hq, _, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    quantized = kc is not None
    cd = torch.bfloat16 if quantized else k_cache.dtype
    qg = q[:, :, 0].to(cd).to(torch.float32).reshape(b, hkv, g, d)
    kf = k_cache.to(cd).to(torch.float32)
    vf = v_cache.to(cd).to(torch.float32)
    sc = torch.matmul(qg, kf.transpose(-1, -2)) * (1.0 / math.sqrt(d))  # [B,Hkv,G,S]
    if quantized:
        sc = sc * (kc[..., 0] * (1.0 / QRANGE))[:, :, None, :]
    pos = torch.arange(s, device=q.device)
    valid = (pos[None, :] < lengths.to(q.device)[:, None])[:, None, None, :]
    sc = torch.where(valid, sc, torch.full_like(sc, _NEG_INF))
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(sc - m), torch.zeros_like(sc))
    l = p.sum(dim=-1, keepdim=True)
    if quantized:
        p = p * (vc[..., 0] * (1.0 / QRANGE))[:, :, None, :]
    p = p.to(cd).to(torch.float32)
    out = torch.matmul(p, vf) / torch.clamp_min(l, 1e-30)           # [B,Hkv,G,D]
    return out.reshape(b, hq, 1, d).to(q.dtype)


def _lib():
    fn = _build.library("decode_attention").qgemm_decode_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = i
    return fn


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     lengths: torch.Tensor, kc: Optional[torch.Tensor] = None,
                     vc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, Hq, 1, D]; k_cache/v_cache [B, Hkv, S, D] (int8 with kc/vc
    [B, Hkv, S, 1] absmax scales, or a bf16/f32 float cache) with Hq a
    multiple of Hkv (GQA: query heads i*g..(i+1)*g-1 share KV head i);
    lengths [B] — position j of slot b attends iff j < lengths[b].
    Returns [B, Hq, 1, D] in q's dtype. CPU tensors run the plain version;
    CUDA tensors launch K2 (D in {64, 128}, g in {1, 2, 4, 8}) or raise."""
    _check(q, k_cache, v_cache, lengths, kc, vc)
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, lengths, kc, vc)
    b, hq, _, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    check(k_cache.dtype in _KV_DTYPES, f"k_cache: K2 takes int8, bfloat16 or "
          f"float32, got {k_cache.dtype}")
    check(d in (64, 128), f"K2 takes head_dim 64 or 128, got {d}")
    check(g in (1, 2, 4, 8), f"K2 takes GQA groups 1, 2, 4 or 8, got {g}")
    tensors = [q, k_cache, v_cache, lengths] + ([kc, vc] if kc is not None else [])
    check(all(t.is_cuda and t.device == q.device for t in tensors),
          "decode_attention: all tensors must lie on q's CUDA device")
    qf = q[:, :, 0].to(torch.float32).contiguous()
    k_cache, v_cache = k_cache.contiguous(), v_cache.contiguous()
    lens = lengths.to(torch.int32).contiguous()
    if kc is not None:
        kc = kc.to(torch.float32).contiguous()
        vc = vc.to(torch.float32).contiguous()
        kc_ptr, vc_ptr = kc.data_ptr(), vc.data_ptr()
    else:
        kc_ptr = vc_ptr = None
    out = torch.empty((b, hq, d), dtype=torch.float32, device=q.device)
    rc = _lib()(qf.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), kc_ptr,
                vc_ptr, lens.data_ptr(), out.data_ptr(), _KV_DTYPES[k_cache.dtype],
                b, hkv, g, s, d, 1.0 / math.sqrt(d),
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch("qgemm_decode_attention", rc)
    decode_attention.launches += 1
    return out[:, :, None, :].to(q.dtype)


decode_attention.launches = 0
