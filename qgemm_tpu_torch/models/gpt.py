"""Decoder-only transformer, the serving-path model family (port of
``qgemm_tpu/models/gpt.py``): pre-LN causal LM, KV-cache decoding with
per-slot positions, greedy generation and beam search, offline int8 or int4
(W4A8) quantization of every GEMM, optionally with the LLM.int8() outlier
split. ``GPTConfig(n_experts > 0)`` swaps every block's FFN for a top-k
routed ``MoEFeedForward`` (``models/moe.py``), whose experts quantize to
int8 whatever ``bits`` and outlier options the rest of the model takes.

``forward`` is differentiable (the training path: the float leaves are
trainable parameters, listed in the JAX package's pytree order by
``named_trainable``); the decoding entry points run under ``no_grad``.
Caches are updated in place: ``decode_step``, ``prefill`` and
``prefill_chunk`` write into the cache tensors they are given and return
the same objects. The cache extent is exactly what the caller asks for (the
JAX package rounds it up to 128 rows off the CPU for its TPU kernels; the
port's kernels mask by length and need no such padding).

``with_tp(mesh)`` gives this rank's model (tensor parallelism,
``parallel/``; a quantized model for serving, a float one for training
through ``parallel.sharding.shard_model``): attention blocks and dense FFNs
sharded, Megatron's pairing, the head column-sharded over the vocabulary
with its output gathered (every rank samples from the same full logits),
embedding and LayerNorms replicated, and an MoE FFN's experts sharded over
the model axis (``parallel/expert.py``: the rank's E/p experts, one SUM a
layer), or whole where E does not divide it. Its caches are head-local.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
from torch import nn

from qgemm_tpu_torch.device import DeviceLike, resolve_device, torch_dtype
from qgemm_tpu_torch.models.attention import MultiHeadAttention
from qgemm_tpu_torch.models.embedding import Embedding
from qgemm_tpu_torch.models.linear import Linear, check_quantize_options, shard_by_plan
from qgemm_tpu_torch.models.moe import MoEFeedForward
from qgemm_tpu_torch.models.transformer import FeedForward, LayerNorm, _beam_loop
from qgemm_tpu_torch.ops.kv_cache import QuantizedKVCache, init_quantized_kv_cache


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
    def __init__(self, attn: MultiHeadAttention, ffn: nn.Module, ln1: LayerNorm,
                 ln2: LayerNorm):
        """``ffn`` is a ``FeedForward`` or a ``MoEFeedForward``."""
        super().__init__()
        self.attn, self.ffn, self.ln1, self.ln2 = attn, ffn, ln1, ln2

    @classmethod
    def init(cls, generator: torch.Generator, cfg: GPTConfig) -> "GPTBlock":
        d = cfg.tdtype
        attn = MultiHeadAttention.init(generator, cfg.d_model, cfg.n_heads, dtype=d,
                                       n_kv_heads=cfg.n_kv_heads)
        if cfg.n_experts > 0:
            ffn = MoEFeedForward.init(generator, cfg.d_model, cfg.d_ff, cfg.n_experts,
                                      top_k=cfg.moe_top_k, dtype=d)
        else:
            ffn = FeedForward.init(generator, cfg.d_model, cfg.d_ff, dtype=d)
        return cls(attn, ffn, LayerNorm.init(cfg.d_model, d, generator.device),
                   LayerNorm.init(cfg.d_model, d, generator.device))

    def quantize(self, **qkw) -> "GPTBlock":
        return GPTBlock(self.attn.quantize(**qkw), self.ffn.quantize(**qkw),
                        self.ln1, self.ln2)

    def with_tp(self, mesh, axis: str = "model") -> "GPTBlock":
        """The attention block and a dense FFN sharded by Megatron's
        pairing; an MoE FFN's experts sharded over the axis (JAX's
        ``("model", None, None)`` for the expert leaves), or the FFN whole
        where E does not divide it."""
        if isinstance(self.ffn, MoEFeedForward):
            from qgemm_tpu_torch.parallel.expert import shard_moe
            from qgemm_tpu_torch.parallel.mesh import axis_size
            ffn = (self.ffn if self.ffn.n_experts % axis_size(mesh, axis)
                   else shard_moe(self.ffn, mesh, axis))
        else:
            ffn = self.ffn.with_tp(mesh, axis)
        return GPTBlock(self.attn.with_tp(mesh, axis), ffn, self.ln1, self.ln2)

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
        turns on the LLM.int8() outlier split (BASELINE config 5). MoE
        experts become int8 and ignore both options, as in JAX."""
        check_quantize_options(**qkw)
        return GPT(self.embed, [b.quantize(**qkw) for b in self.blocks], self.ln_f,
                   self.lm_head.quantize(**qkw), self.cfg)

    # the head column-sharded over the vocabulary, its output gathered
    TP_PLAN = {"lm_head": ("column", True)}

    def with_tp(self, mesh, axis: str = "model") -> "GPT":
        """This rank's model (see the module note)."""
        head = (shard_by_plan(self, mesh, axis) or {"lm_head": self.lm_head})["lm_head"]
        return GPT(self.embed, [b.with_tp(mesh, axis) for b in self.blocks], self.ln_f, head,
                   self.cfg)

    @property
    def kv_heads(self) -> int:
        """The KV heads each cache holds (this rank's, under a mesh)."""
        return self.blocks[0].attn.kv_heads

    def num_params(self) -> int:
        """Elements of every leaf (weights, codes, scales, tables), as JAX's
        ``num_params`` counts the pytree's leaves."""
        return sum(t.numel() for t in self.state_dict().values())

    def named_trainable(self) -> List[Tuple[str, nn.Parameter]]:
        """The trainable parameters (every float leaf of a float model: the
        embedding and positional tables, weights, biases, LayerNorm gains
        and shifts; an MoE block's ``router_w``, ``w_up`` and ``w_down``),
        keyed by their JAX pytree path (``blocks/0/attn/wqkv_q/w``) and in
        the order of ``jax.tree_util.tree_leaves``."""
        return [(name.replace(".", "/"), p) for name, p in self.named_parameters()
                if p.requires_grad]

    # ------------------------------------------------------------------ fwd
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
        hkv = self.kv_heads
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

    @torch.no_grad()
    def beam_search(self, prompt: torch.Tensor, max_new_tokens: int, beam_size: int = 4,
                    eos_token: Optional[int] = None, length_penalty: float = 0.6,
                    quantized_cache: bool = False):
        """Beam-search continuation of prompt [B, S_p], the decoder-only twin
        of ``Transformer.beam_search``: the prompt prefills once at batch B,
        its cache rows are repeated into the B*K beam rows, the first token
        of each beam is one of the K best after the prompt, then the beam
        steps. Returns (tokens [B, max_new_tokens], scores [B])."""
        b, s_p = prompt.shape
        k = beam_size
        caches = self.init_cache(b, s_p + max_new_tokens, quantized=quantized_cache)
        logits, caches = self.prefill(prompt, caches)
        rows = [[t.repeat_interleave(k, dim=0) for t in c] for c in caches]
        caches = [QuantizedKVCache(*r) if isinstance(c, QuantizedKVCache) else tuple(r)
                  for c, r in zip(caches, rows)]
        lp0 = torch.log_softmax(logits[:, s_p - 1, :].to(torch.float32), dim=-1)
        scores, nxt0 = torch.topk(lp0, k, dim=-1)
        toks = torch.zeros((b, k, max_new_tokens), dtype=torch.int64, device=prompt.device)
        toks[:, :, 0] = nxt0
        done = (nxt0 == eos_token) if eos_token is not None else \
            torch.zeros((b, k), dtype=torch.bool, device=prompt.device)
        step = lambda tok, t, caches: self.decode_step(tok, s_p + t, caches)
        return _beam_loop(step, nxt0.reshape(-1, 1), caches, scores, 1, max_new_tokens,
                          eos_token, length_penalty, toks=toks, done=done)
