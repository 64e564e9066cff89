"""int8 and int4 KV cache (port of ``qgemm_tpu/ops/kv_cache.py``): K/V rows
are quantized per (batch, head, position) with an absmax scale over the head
dim on write and read back with the scale factored out of the attention
products. int8 halves the cache's memory and its decode read stream; int4
(the paged pools' ``kv_bits=4``) halves them again.

int4 codes lie in [-7, 7] and their stored scale is pre-multiplied by
127/7, so every reader keeps the int8 math ``value * scale / 127``. Codes
are packed two to a byte at the page level, pairing PAGE POSITIONS: row r
of a page in the low nibble of byte-row r, row r + page/2 in the high
nibble (``pack_int4_rows``).

The port writes cache rows in place (``models/attention.py``,
``serving/paged_cache.py``); the JAX version returns new arrays.
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


QRANGE4 = 7.0


def quantize_kv_int4(x: torch.Tensor):
    """x [..., D] -> (int4 values as int8 in [-7, 7] [..., D], f32 scale
    [..., 1] in the int8 convention: absmax * 127/7). Packing into bytes is
    ``pack_int4_rows``'s, at the page level."""
    xf = x.to(torch.float32)
    c = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), _EPS)
    q = torch.clamp(torch.round(xf * (torch.full_like(c, QRANGE4) / c)), -QRANGE4,
                    QRANGE4).to(torch.int8)
    return q, c * (QRANGE / QRANGE4)


def pack_int4_rows(vals: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Pair rows along ``axis``: its first half goes to the low nibbles, its
    second half to the high nibbles. int8 values in [-7, 7] with an
    even-sized axis -> packed int8, the axis halved."""
    n = vals.shape[axis]
    lo = vals.narrow(axis, 0, n // 2).to(torch.int32)
    hi = vals.narrow(axis, n // 2, n - n // 2).to(torch.int32)
    return ((hi << 4) | (lo & 0xF)).to(torch.int8)


def unpack_int4_rows(packed: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Inverse of ``pack_int4_rows``: the axis doubles, row order kept (low
    nibbles first, then high). Both nibbles are sign-extended."""
    p = packed.to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = p >> 4
    return torch.cat([lo, hi], dim=axis).to(torch.int8)
