"""Attention (port of ``scaled_dot_product_attention``, ``Attention``,
``MultiHeadAttention``, ``_quantized_cross_attention`` and
``_dispatch_attention`` of ``qgemm_tpu/models/attention.py``, and its
tensor-parallel ``with_tp``).

Dispatch by device, mirroring the JAX package's by backend:
  * full-sequence attention with no mask (self-attention, causal or not,
    and cross-attention, Sq != Sk) — kernel K3 (flash forward) on CUDA at
    any length, differentiable through kernel K7 (the blockwise backward);
    on the CPU the plain composition under autograd (GQA gradients flow
    back through ``_repeat_kv``);
  * a key mask ([B, Sk] bool: padded encoder positions, or each serving
    slot's true source length) — the plain composition on both, as JAX's
    jnp path;
  * cross-attention over precomputed K/V: a float (k, v) pair takes the two
    routes above; an int8 4-tuple (kq, kc, vq, vc) the factored-scale
    composition of ``_quantized_cross_attention``, products in f32 on the
    CPU and bf16 on CUDA, as JAX's (f32 on its CPU backend);
  * full-prompt prefill (cache index 0, causal, Sq == Sk) — K3 on the
    unquantized K/V on CUDA; on the CPU the prompt attends the cache rows
    just written (re-read int8 rows for an int8 cache), as JAX does there;
  * one decode step over an int8 cache — kernel K2 on CUDA, MHA or GQA;
    on the CPU the bf16-product composition the JAX package runs there;
  * a float cache — the plain composition on both;
  * a paged cache (``serving/paged_cache.PagedKVCache``, detected as JAX
    detects it, by its page table): a decode step writes its row and runs
    kernel K5 (the ragged entry when the cache carries step tables); a
    per-slot chunk (B == 1, page-aligned int offset) writes its pages and
    runs kernel K6, and so does the speculative verify chunk ([B] per-slot
    offsets, unaligned: its rows are written one at a time). On the CPU
    both wrappers run their plain versions in float32, the JAX package's
    CPU path. The dense verify chunk ([B] offsets over a dense cache) takes
    the plain composition, as JAX's jnp path does.
Cache rows are written in place.

Tensor parallelism (``MultiHeadAttention.with_tp``): this rank's block holds
``n_heads / p`` query heads and ``kv_heads / p`` KV heads (QKV column shards
kept head-local, W_O a row shard, one MAX and one SUM a call), so every
route above runs unchanged on the local heads, with no collective of its
own, and caches allocated for the block are head-local. Query heads
``r H/p ..`` map to KV heads ``r Hkv/p ..``: GQA groups stay whole on a
rank. Where a head count does not divide the axis the block stays whole
and replicated on every rank (JAX mixes sharded and resharded pieces
there; both compute the same function).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from qgemm_tpu_torch.models.linear import Linear, shard_by_plan
from qgemm_tpu_torch.ops.cuda.decode_attention import decode_attention
from qgemm_tpu_torch.ops.cuda.flash_attention import flash_attention
from qgemm_tpu_torch.ops.cuda.paged_context_attention import paged_context_attention
from qgemm_tpu_torch.ops.cuda.paged_decode_attention import (paged_decode_attention,
                                                             paged_decode_attention_ragged)
from qgemm_tpu_torch.ops.kv_cache import QRANGE, QuantizedKVCache, quantize_kv
from qgemm_tpu_torch.ops.softmax import softmax
from qgemm_tpu_torch.serving.paged_cache import paged_write_prompt, paged_write_step
from qgemm_tpu_torch.utils.prng import uniform_init

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


def _quantized_cross_attention(q, kq, kc, vq, vc, mask=None) -> torch.Tensor:
    """q [B, Hq, Sq, D]; kq/vq int8 [B, Hkv, S, D] (GQA: query heads fold
    into the row axis, Hq a multiple of Hkv); kc/vc f32 [B, Hkv, S, 1]
    per-position absmax; ``mask`` [B, S] bool. The scales are factored out
    of the products (q.(kq*kc) == (q.kq)*kc, p@(vq*vc) == (p*vc)@vq), so
    the dequantized K/V never exist."""
    b, hq, sq, d = q.shape
    hkv = kq.shape[1]
    if hq != hkv:
        q = q.reshape(b, hkv, (hq // hkv) * sq, d)
    cd = torch.bfloat16 if q.is_cuda else torch.float32
    s = torch.matmul(q.to(cd), kq.to(cd).transpose(-1, -2)).to(torch.float32)
    s = s * (kc[..., 0] / (QRANGE * d ** 0.5))[:, :, None, :]
    if mask is not None:
        s = torch.where(mask[:, None, None, :], s, torch.full_like(s, _NEG))
    p = softmax(s, axis=-1)
    p = p * (vc[..., 0] * (1.0 / QRANGE))[:, :, None, :]
    out = torch.matmul(p.to(cd), vq.to(cd)).to(q.dtype)
    return out.reshape(b, hq, sq, out.shape[-1]) if hq != hkv else out


def _dispatch_attention(q, k, v, causal: bool) -> torch.Tensor:
    """Full-sequence attention: K3 (backward K7) on CUDA, the plain
    composition on CPU; differentiable on both."""
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


class Attention(nn.Module):
    """Single-head scaled dot-product attention, the reference-parity layer:
    Q/K/V projections, softmax(QK^T / sqrt(d_k)) V, no bias and no output
    projection. Self-attention when ``x_kv`` is None, cross-attention
    otherwise."""

    def __init__(self, w_q: torch.Tensor, w_k: torch.Tensor, w_v: torch.Tensor):
        super().__init__()
        self.w_q = nn.Parameter(w_q)     # [d_model, d_k]
        self.w_k = nn.Parameter(w_k)     # [d_model, d_k]
        self.w_v = nn.Parameter(w_v)     # [d_model, d_v]

    @classmethod
    def init(cls, generator: torch.Generator, d_model: int, d_k: int, d_v: int,
             dtype: torch.dtype = torch.float32) -> "Attention":
        """Uniform ±1/sqrt(d_k) from ``generator``."""
        bound = 1.0 / (d_k ** 0.5)
        return cls(*(uniform_init(generator, (d_model, n), bound, dtype)
                     for n in (d_k, d_k, d_v)))

    def forward(self, x_q, x_kv=None, causal: bool = False) -> torch.Tensor:
        if x_kv is None:
            x_kv = x_q
        return scaled_dot_product_attention(x_q @ self.w_q, x_kv @ self.w_k, x_kv @ self.w_v,
                                            causal=causal)


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

    # Megatron's pairing: QKV column-sharded without gathering, W_O row-sharded
    TP_PLAN = {"wqkv_q": ("column", False), "wqkv_k": ("column", False),
               "wqkv_v": ("column", False), "w_o": ("row", True)}

    def with_tp(self, mesh, axis: str = "model") -> "MultiHeadAttention":
        """This rank's block, sharded by ``TP_PLAN``; or the block itself,
        replicated, where a head count or a projection does not divide the
        axis."""
        from qgemm_tpu_torch.parallel.mesh import axis_size
        p = axis_size(mesh, axis)
        if self.n_heads % p or self.kv_heads % p:
            return self
        lins = shard_by_plan(self, mesh, axis)
        if lins is None:
            return self
        return MultiHeadAttention(lins["wqkv_q"], lins["wqkv_k"], lins["wqkv_v"], lins["w_o"],
                                  self.n_heads // p, self.n_kv_heads // p)

    def _split(self, x, heads: int):
        b, s, d = x.shape
        return x.reshape(b, s, heads, d // heads).transpose(1, 2)

    def _merge(self, x):
        b, h, s, dh = x.shape
        return x.transpose(1, 2).reshape(b, s, h * dh)

    def _repeat_kv(self, x):
        g = self.n_heads // self.kv_heads
        return x if g == 1 else torch.repeat_interleave(x, g, dim=1)

    def precompute_kv(self, x_kv):
        """Project and head-split K/V once: the cross-attention's K/V of an
        encoder output, static over every decode step. -> (k, v), each
        [B, Hkv, Sk, Dh]."""
        return (self._split(self.wqkv_k(x_kv), self.kv_heads),
                self._split(self.wqkv_v(x_kv), self.kv_heads))

    def forward(self, x_q, x_kv=None, causal: bool = False, kv_cache=None,
                cache_index=None, precomputed_kv=None, mask=None):
        """x_q [B, Sq, D]; x_kv [B, Sk, D] or None (self-attention).

        With ``kv_cache`` ((k, v) float [B, Hkv, S, Dh], a
        ``QuantizedKVCache`` or a ``PagedKVCache``) and ``cache_index`` (an
        int, or [B] per-slot positions), the new K/V rows are written at
        cache_index in place and (out, kv_cache) is returned.
        ``precomputed_kv``: the K/V instead of projecting ``x_kv``, a float
        (k, v) pair or an int8 (kq, kc, vq, vc) 4-tuple (cross-attention).
        ``mask`` [B, Sk] bool marks the keys attended (padded encoder
        positions, or a serving slot's true source length)."""
        q = self._split(self.wqkv_q(x_q), self.n_heads)
        if precomputed_kv is not None and len(precomputed_kv) == 4:
            out = _quantized_cross_attention(q, *precomputed_kv, mask=mask)
            return self.w_o(self._merge(out))
        if precomputed_kv is not None:
            k, v = precomputed_kv
        else:
            if x_kv is None:
                x_kv = x_q
            k, v = self.precompute_kv(x_kv)
        if kv_cache is not None:
            out = self._cached(q, k, v, kv_cache, cache_index, causal)
            return self.w_o(self._merge(out)), kv_cache
        k, v = self._repeat_kv(k), self._repeat_kv(v)
        if mask is not None:
            out = scaled_dot_product_attention(q, k, v, causal=causal,
                                               mask=mask[:, None, None, :])
        else:
            out = _dispatch_attention(q, k, v, causal)
        return self.w_o(self._merge(out))

    def _paged(self, q, k, v, cache, cache_index):
        """The paged branch (JAX's ``models/attention.py:212-284``): a decode
        step (Sq == 1, per-slot positions), a per-slot chunk prefill, or the
        verify chunk at [B] per-slot offsets."""
        sq = q.shape[2]
        if sq > 1:
            if isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1:
                # the speculative verify chunk: every slot's candidate rows
                # at its own offset, unaligned to pages, so the rows are
                # written one at a time through the decode-step write (past
                # the table: the null page; int4 merges each row's nibble
                # in order), then K6 attends at the per-slot offsets
                offsets = cache_index.to(device=q.device, dtype=torch.int64)
                for j in range(sq):
                    paged_write_step(cache, k[:, :, j:j + 1], v[:, :, j:j + 1], offsets + j)
                return paged_context_attention(q, cache, (offsets + sq).to(torch.int32),
                                               offsets)
            offset = int(cache_index)
            ps = cache.page_size
            if q.shape[0] != 1 or offset % ps:
                raise ValueError(f"paged chunk prefill is per slot (B == 1) at a page-"
                                 f"aligned offset; got B={q.shape[0]}, offset {offset}, "
                                 f"page {ps}")
            paged_write_prompt(cache, 0, k[0], v[0], first_page=offset // ps)
            lengths = torch.full((1,), offset + sq, dtype=torch.int32, device=q.device)
            return paged_context_attention(q, cache, lengths, offset)
        positions = (cache_index.to(q.device) if isinstance(cache_index, torch.Tensor)
                     else torch.full((q.shape[0],), int(cache_index), device=q.device))
        positions = positions.reshape(-1).expand(q.shape[0])
        paged_write_step(cache, k, v, positions)
        lengths = (positions + 1).to(torch.int32)
        attend = (paged_decode_attention_ragged if cache.step_slot is not None
                  else paged_decode_attention)
        return attend(q, cache, lengths)

    def _cached(self, q, k, v, kv_cache, cache_index, causal: bool):
        if getattr(kv_cache, "page_table", None) is not None:
            return self._paged(q, k, v, kv_cache, cache_index)
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
