"""Decoder-only transformer, the serving-path model family (port of
``qgemm_tpu/models/gpt.py``; ``beam_search`` and MoE blocks are not ported
yet): pre-LN causal LM, KV-cache decoding with per-slot positions, offline
int8 or int4 (W4A8) quantization of every GEMM, optionally with the
LLM.int8() outlier split.

Caches are updated in place: ``decode_step``, ``prefill`` and
``prefill_chunk`` write into the cache tensors they are given and return
the same objects. The cache extent is exactly what the caller asks for (the
JAX package rounds it up to 128 rows off the CPU for its TPU kernels; the
port's kernels mask by length and need no such padding).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch
from torch import nn

from qgemm_tpu_torch.device import DeviceLike, resolve_device, torch_dtype
from qgemm_tpu_torch.models.attention import MultiHeadAttention
from qgemm_tpu_torch.models.embedding import Embedding
from qgemm_tpu_torch.models.linear import Linear, check_quantize_options
from qgemm_tpu_torch.models.transformer import FeedForward, LayerNorm
from qgemm_tpu_torch.ops.kv_cache import init_quantized_kv_cache


@dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    # n_kv_heads < n_heads = grouped-query attention; 0 = MHA
    n_kv_heads: int = 0
    d_ff: int = 2048
    n_layers: int = 6
    max_seq_len: int = 1024
    dtype: str = "float32"
    n_experts: int = 0
    moe_top_k: int = 2

    @property
    def tdtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)


# the LLM.int8() regime: BASELINE config 5
GPT_6_7B = GPTConfig(vocab_size=50272, d_model=4096, n_heads=32, d_ff=16384,
                     n_layers=32, max_seq_len=2048, dtype="bfloat16")


def _generator(device: torch.device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


class GPTBlock(nn.Module):
    def __init__(self, attn: MultiHeadAttention, ffn: FeedForward, ln1: LayerNorm,
                 ln2: LayerNorm):
        super().__init__()
        self.attn, self.ffn, self.ln1, self.ln2 = attn, ffn, ln1, ln2

    @classmethod
    def init(cls, generator: torch.Generator, cfg: GPTConfig) -> "GPTBlock":
        if cfg.n_experts > 0:
            raise NotImplementedError("GPTConfig(n_experts > 0): MoE blocks are not ported")
        d = cfg.tdtype
        attn = MultiHeadAttention.init(generator, cfg.d_model, cfg.n_heads, dtype=d,
                                       n_kv_heads=cfg.n_kv_heads)
        ffn = FeedForward.init(generator, cfg.d_model, cfg.d_ff, dtype=d)
        return cls(attn, ffn, LayerNorm.init(cfg.d_model, d, generator.device),
                   LayerNorm.init(cfg.d_model, d, generator.device))

    def quantize(self, **qkw) -> "GPTBlock":
        return GPTBlock(self.attn.quantize(**qkw), self.ffn.quantize(**qkw),
                        self.ln1, self.ln2)

    def forward(self, x, cache=None, cache_index=None):
        if cache is None:
            x = x + self.attn(self.ln1(x), causal=True)
            return x + self.ffn(self.ln2(x))
        a, cache = self.attn(self.ln1(x), causal=True, kv_cache=cache,
                             cache_index=cache_index)
        x = x + a
        return x + self.ffn(self.ln2(x)), cache


class GPT(nn.Module):
    def __init__(self, embed: Embedding, blocks: List[GPTBlock], ln_f: LayerNorm,
                 lm_head: nn.Module, cfg: GPTConfig):
        super().__init__()
        self.embed = embed
        self.blocks = nn.ModuleList(blocks)
        self.ln_f = ln_f
        self.lm_head = lm_head
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    @classmethod
    def init(cls, cfg: GPTConfig, seed: int = 0, device: DeviceLike = None) -> "GPT":
        """Random weights from ``torch.Generator(seed)`` on ``device``
        (default: the GPU — raises without one)."""
        gen = _generator(resolve_device(device), seed)
        d = cfg.tdtype
        embed = Embedding.init(gen, cfg.vocab_size, cfg.d_model, cfg.max_seq_len, d)
        blocks = [GPTBlock.init(gen, cfg) for _ in range(cfg.n_layers)]
        lm_head = Linear.init(gen, cfg.d_model, cfg.vocab_size, bias=False, dtype=d)
        return cls(embed, blocks, LayerNorm.init(cfg.d_model, d, gen.device),
                   lm_head, cfg)

    @classmethod
    def init_quantized(cls, cfg: GPTConfig, seed: int = 0, device: DeviceLike = None,
                       **qkw) -> "GPT":
        """Initialize straight into quantized weights (``qkw`` as for
        ``quantize``): each block is built, quantized and its float weights
        dropped before the next is built, so peak memory is the quantized
        model plus one float block."""
        check_quantize_options(**qkw)
        gen = _generator(resolve_device(device), seed)
        d = cfg.tdtype
        embed = Embedding.init(gen, cfg.vocab_size, cfg.d_model, cfg.max_seq_len, d)
        blocks = []
        for _ in range(cfg.n_layers):
            blk = GPTBlock.init(gen, cfg)
            blocks.append(blk.quantize(**qkw))
            del blk
        lm_head = Linear.init(gen, cfg.d_model, cfg.vocab_size, bias=False,
                              dtype=d).quantize(**qkw)
        return cls(embed, blocks, LayerNorm.init(cfg.d_model, d, gen.device),
                   lm_head, cfg)

    def quantize(self, **qkw) -> "GPT":
        """Quantize every GEMM, ``lm_head`` included: int8 weights, or int4
        with ``bits=4``; ``outlier_threshold=6.0`` (and ``outlier_capacity``)
        turns on the LLM.int8() outlier split (BASELINE config 5)."""
        check_quantize_options(**qkw)
        return GPT(self.embed, [b.quantize(**qkw) for b in self.blocks], self.ln_f,
                   self.lm_head.quantize(**qkw), self.cfg)

    def num_params(self) -> int:
        return sum(t.numel() for t in self.state_dict().values())

    # ------------------------------------------------------------------ fwd
    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] -> logits [B, S, vocab] (causal, teacher forcing)."""
        x = self.embed(tokens)
        for blk in self.blocks:
            x = blk(x)
        return self.lm_head(self.ln_f(x))

    # ------------------------------------------------------------- decoding
    def init_cache(self, batch: int, max_len: Optional[int] = None,
                   quantized: bool = False):
        """Per layer: (k, v) in the model dtype, or a ``QuantizedKVCache``
        (int8 rows + per-position absmax), each [batch, Hkv, max_len, Dh]."""
        cfg = self.cfg
        s = max_len or cfg.max_seq_len
        dh = cfg.d_model // cfg.n_heads
        hkv = cfg.n_kv_heads or cfg.n_heads
        dev = self.device
        if quantized:
            return [init_quantized_kv_cache(batch, hkv, s, dh, device=dev)
                    for _ in self.blocks]
        z = lambda: torch.zeros((batch, hkv, s, dh), dtype=cfg.tdtype, device=dev)
        return [(z(), z()) for _ in self.blocks]

    @torch.no_grad()
    def decode_step(self, tok: torch.Tensor, pos, caches):
        """tok [B, 1]; pos an int or [B] per-slot positions. Returns
        (logits [B, vocab], caches)."""
        if isinstance(pos, torch.Tensor) and pos.ndim == 1:
            x = self.embed.lookup(tok) + self.embed.positions(pos)[:, None, :]
        else:
            x = self.embed(tok, offset=int(pos))
        for blk, cache in zip(self.blocks, caches):
            x, _ = blk(x, cache=cache, cache_index=pos)
        return self.lm_head(self.ln_f(x))[:, -1, :], caches

    def prefill(self, tokens: torch.Tensor, caches):
        """Write a whole prompt's K/V (positions from 0) and return the
        logits at every position. tokens [B, S_prompt], left-aligned."""
        return self.prefill_chunk(tokens, 0, caches)

    @torch.no_grad()
    def prefill_chunk(self, tokens: torch.Tensor, offset, caches):
        """Prefill a chunk at ``offset`` (an int, or [B] per-slot offsets):
        writes its K/V and returns logits for its positions. The chunk
        attends the cache rows before it plus causally within itself."""
        if isinstance(offset, torch.Tensor) and offset.ndim == 1:
            c = tokens.shape[1]
            posi = offset.to(tokens.device)[:, None] + torch.arange(c, device=tokens.device)
            x = self.embed.lookup(tokens) + self.embed.positions(posi)
        else:
            x = self.embed(tokens, offset=int(offset))
        for blk, cache in zip(self.blocks, caches):
            x, _ = blk(x, cache=cache, cache_index=offset)
        return self.lm_head(self.ln_f(x)), caches

    @torch.no_grad()
    def generate(self, prompt: torch.Tensor, max_new_tokens: int,
                 quantized_cache: bool = False) -> torch.Tensor:
        """Greedy continuation: prefill the prompt, then decode one token at
        a time. prompt [B, S_p] -> [B, max_new_tokens]."""
        b, s_p = prompt.shape
        caches = self.init_cache(b, s_p + max_new_tokens, quantized=quantized_cache)
        logits, caches = self.prefill(prompt, caches)
        tok = logits[:, -1, :].argmax(dim=-1, keepdim=True)
        out = [tok]
        for t in range(max_new_tokens - 1):
            logits, caches = self.decode_step(tok, s_p + t, caches)
            tok = logits.argmax(dim=-1, keepdim=True)
            out.append(tok)
        return torch.cat(out, dim=1)
