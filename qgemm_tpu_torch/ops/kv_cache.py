"""int8 KV cache (int8 parts of ``qgemm_tpu/ops/kv_cache.py``): K/V rows are
quantized per (batch, head, position) with an absmax scale over the head
dim on write and read back with the scale factored out of the attention
products. Halves the cache's memory and its decode read stream.

The port writes cache rows in place (``models/attention.py``); the JAX
version returns new arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

QRANGE = 127.0
_EPS = 1e-12


class QuantizedKVCache(NamedTuple):
    """One layer's cache: int8 values + per-position float scales."""
    kq: torch.Tensor  # int8 [B, H, S, Dh]
    kc: torch.Tensor  # f32  [B, H, S, 1]  absmax over Dh
    vq: torch.Tensor  # int8 [B, H, S, Dv]
    vc: torch.Tensor  # f32  [B, H, S, 1]


def init_quantized_kv_cache(batch: int, n_heads: int, max_len: int, d_head: int,
                            device=None) -> QuantizedKVCache:
    z8 = lambda: torch.zeros((batch, n_heads, max_len, d_head), dtype=torch.int8,
                             device=device)
    # scale 1.0 keeps untouched (padding) rows decoding to exact zeros
    c = lambda: torch.ones((batch, n_heads, max_len, 1), dtype=torch.float32,
                           device=device)
    return QuantizedKVCache(kq=z8(), kc=c(), vq=z8(), vc=c())


def quantize_kv(x: torch.Tensor):
    """x [..., Dh] -> (int8 [..., Dh], f32 absmax [..., 1]); one row is one
    (batch, head, position) vector, round half to even."""
    xf = x.to(torch.float32)
    c = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), _EPS)
    # a true division, as in quantize.absmax_quantize; full_like keeps the
    # numerator on the device (a host scalar copied in would sync the stream)
    q = torch.clamp(torch.round(xf * (torch.full_like(c, QRANGE) / c)), -QRANGE,
                    QRANGE).to(torch.int8)
    return q, c


def dequantize_kv(q: torch.Tensor, c: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (q.to(torch.float32) * (c * (1.0 / QRANGE))).to(dtype)
