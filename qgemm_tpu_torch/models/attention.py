"""Attention (port of ``scaled_dot_product_attention``, ``MultiHeadAttention``
and ``_dispatch_attention`` of ``qgemm_tpu/models/attention.py``; the paged,
tensor-parallel and cross-attention branches are not ported yet).

Dispatch by device, mirroring the JAX package's by backend:
  * full-sequence attention — kernel K3 (flash) on CUDA at any length,
    the plain composition on the CPU;
  * full-prompt prefill (cache index 0, causal, Sq == Sk) — K3 on the
    unquantized K/V on CUDA; on the CPU the prompt attends the cache rows
    just written (re-read int8 rows for an int8 cache), as JAX does there;
  * one decode step over an int8 cache — kernel K2 on CUDA, MHA or GQA;
    on the CPU the bf16-product composition the JAX package runs there;
  * a float cache — the plain composition on both.
Cache rows are written in place.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from qgemm_tpu_torch.models.linear import Linear
from qgemm_tpu_torch.ops.cuda.decode_attention import decode_attention
from qgemm_tpu_torch.ops.cuda.flash_attention import flash_attention
from qgemm_tpu_torch.ops.kv_cache import QRANGE, QuantizedKVCache, quantize_kv
from qgemm_tpu_torch.ops.softmax import softmax

_NEG = -1e30


def scaled_dot_product_attention(q, k, v, causal: bool = False,
                                 mask: Optional[torch.Tensor] = None,
                                 kv_offset: int = 0) -> torch.Tensor:
    """q [..., Sq, d], k [..., Sk, d], v [..., Sk, dv] -> [..., Sq, dv].
    ``kv_offset`` shifts the causal comparison (query i attends kv <= i +
    offset); ``mask`` (broadcastable to the scores) marks attended keys."""
    d = q.shape[-1]
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
    if causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        qi = torch.arange(sq, device=q.device)[:, None] + kv_offset
        kj = torch.arange(sk, device=q.device)[None, :]
        scores = torch.where(kj <= qi, scores, torch.full_like(scores, _NEG))
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, _NEG))
    return torch.matmul(softmax(scores, axis=-1), v)


def _dispatch_attention(q, k, v, causal: bool) -> torch.Tensor:
    """Full-sequence attention: K3 on CUDA, the plain composition on CPU."""
    if q.is_cuda:
        return flash_attention(q, k, v, causal=causal)
    return scaled_dot_product_attention(q, k, v, causal=causal)


def _write_rows(cache: torch.Tensor, new: torch.Tensor, index) -> None:
    """Write new [B, H, Sq, *] into cache [B, H, S, *] at position ``index``
    (an int, or a [B] tensor of per-slot positions). The start clamps so
    the block fits, as JAX's dynamic_update_slice does."""
    s, sq = cache.shape[2], new.shape[2]
    new = new.to(cache.dtype)
    if isinstance(index, torch.Tensor) and index.ndim == 1:
        start = index.to(cache.device).clamp(0, s - sq)
        rows = torch.arange(cache.shape[0], device=cache.device)[:, None]
        pos = start[:, None] + torch.arange(sq, device=cache.device)[None, :]
        cache[rows, :, pos] = new.transpose(1, 2)       # [B, Sq, H, *]
    else:
        start = min(max(int(index), 0), s - sq)
        cache[:, :, start:start + sq] = new


class MultiHeadAttention(nn.Module):
    """Batched multi-head attention with output projection; projections are
    ``Linear`` or ``QuantizedLinear``. ``n_kv_heads < n_heads`` is GQA:
    query heads i*g..(i+1)*g-1 share KV head i."""

    def __init__(self, wqkv_q, wqkv_k, wqkv_v, w_o, n_heads: int,
                 n_kv_heads: int = 0):
        super().__init__()
        self.wqkv_q, self.wqkv_k, self.wqkv_v, self.w_o = wqkv_q, wqkv_k, wqkv_v, w_o
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads

    @classmethod
    def init(cls, generator: torch.Generator, d_model: int, n_heads: int,
             bias: bool = False, dtype: torch.dtype = torch.float32,
             n_kv_heads: int = 0) -> "MultiHeadAttention":
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} not divisible by n_heads {n_heads}")
        nkv = n_kv_heads or n_heads
        if n_heads % nkv:
            raise ValueError(f"n_heads {n_heads} not divisible by n_kv_heads {nkv}")
        d_kv = (d_model // n_heads) * nkv
        mk = lambda dout: Linear.init(generator, d_model, dout, bias=bias, dtype=dtype)
        return cls(mk(d_model), mk(d_kv), mk(d_kv), mk(d_model), n_heads, n_kv_heads)

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    def quantize(self, **qkw) -> "MultiHeadAttention":
        return MultiHeadAttention(self.wqkv_q.quantize(**qkw), self.wqkv_k.quantize(**qkw),
                                  self.wqkv_v.quantize(**qkw), self.w_o.quantize(**qkw),
                                  self.n_heads, self.n_kv_heads)

    def _split(self, x, heads: int):
        b, s, d = x.shape
        return x.reshape(b, s, heads, d // heads).transpose(1, 2)

    def _merge(self, x):
        b, h, s, dh = x.shape
        return x.transpose(1, 2).reshape(b, s, h * dh)

    def _repeat_kv(self, x):
        g = self.n_heads // self.kv_heads
        return x if g == 1 else torch.repeat_interleave(x, g, dim=1)

    def forward(self, x_q, x_kv=None, causal: bool = False, kv_cache=None,
                cache_index=None):
        """x_q [B, Sq, D]; x_kv [B, Sk, D] or None (self-attention).

        With ``kv_cache`` ((k, v) float [B, Hkv, S, Dh] or a
        ``QuantizedKVCache``) and ``cache_index`` (an int, or [B] per-slot
        positions), the new K/V rows are written at cache_index in place and
        (out, kv_cache) is returned."""
        q = self._split(self.wqkv_q(x_q), self.n_heads)
        if x_kv is None:
            x_kv = x_q
        k = self._split(self.wqkv_k(x_kv), self.kv_heads)
        v = self._split(self.wqkv_v(x_kv), self.kv_heads)
        if kv_cache is not None:
            out = self._cached(q, k, v, kv_cache, cache_index, causal)
            return self.w_o(self._merge(out)), kv_cache
        out = _dispatch_attention(q, self._repeat_kv(k), self._repeat_kv(v), causal)
        return self.w_o(self._merge(out))

    def _cached(self, q, k, v, kv_cache, cache_index, causal: bool):
        g = self.n_heads // self.kv_heads
        quantized = isinstance(kv_cache, QuantizedKVCache)
        if quantized:
            kq, kc = quantize_kv(k)
            vq, vc = quantize_kv(v)
            for dst, src in zip(kv_cache, (kq, kc, vq, vc)):
                _write_rows(dst, src, cache_index)
            k_cache, v_cache = kv_cache.kq, kv_cache.vq
        else:
            k_cache, v_cache = kv_cache
            _write_rows(k_cache, k, cache_index)
            _write_rows(v_cache, v, cache_index)

        sq = q.shape[2]
        if (q.is_cuda and isinstance(cache_index, int) and cache_index == 0
                and causal and sq == k.shape[2]):
            # full-prompt prefill: attend the just-projected K/V (exact, and
            # O(S_p * d) traffic instead of scores over the whole extent)
            return _dispatch_attention(q, self._repeat_kv(k), self._repeat_kv(v), True)

        per_slot = isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1
        if quantized and sq == 1 and q.is_cuda:
            pos = (cache_index.to(q.device) if per_slot
                   else torch.full((q.shape[0],), int(cache_index), device=q.device))
            return decode_attention(q, kv_cache.kq, kv_cache.vq,
                                    (pos + 1).to(torch.int32),
                                    kc=kv_cache.kc, vc=kv_cache.vc)

        s_max = k_cache.shape[2]
        idx = (cache_index.to(q.device)[:, None, None, None] if per_slot
               else int(cache_index))
        kj = torch.arange(s_max, device=q.device).reshape(1, 1, 1, s_max)
        valid = kj < (idx + sq)
        if causal:
            qi = torch.arange(sq, device=q.device).reshape(1, 1, sq, 1) + idx
            valid = valid & (kj <= qi)
        b, hq, _, d = q.shape
        if g > 1:
            # GQA: fold the query groups into the row axis so the cache is
            # read unreplicated — [B, Hq, Sq, D] -> [B, Hkv, g*Sq, D]
            q = q.reshape(b, self.kv_heads, g * sq, d)
            valid = valid.repeat(1, 1, g, 1)
        if quantized:
            # products in bf16 with the absmax scales factored out, rounded
            # where the JAX package's CPU path rounds
            cd = torch.bfloat16
            s = torch.matmul(q.to(cd), k_cache.to(cd).transpose(-1, -2)).to(torch.float32)
            s = s * (kv_cache.kc[..., 0] / (QRANGE * d ** 0.5))[:, :, None, :]
            s = torch.where(valid, s, torch.full_like(s, _NEG))
            p = softmax(s, axis=-1)
            p = p * (kv_cache.vc[..., 0] * (1.0 / QRANGE))[:, :, None, :]
            out = torch.matmul(p.to(cd), v_cache.to(cd)).to(q.dtype)
        else:
            out = scaled_dot_product_attention(q, k_cache, v_cache, mask=valid)
        if g > 1:
            out = out.reshape(b, hq, sq, out.shape[-1])
        return out
