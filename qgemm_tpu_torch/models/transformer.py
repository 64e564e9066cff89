"""The encoder-decoder transformer and the blocks the model families share
(port of ``qgemm_tpu/models/transformer.py``):
``LayerNorm``, ``FeedForward``, ``EncoderBlock``, ``DecoderBlock`` and
``Transformer``.

``Transformer`` is pre-LN: a bidirectional encoder, a causal decoder with
cross-attention over the encoder output, a logits head; every GEMM
quantizes offline (int8, or int4 with ``bits=4``). ``forward`` is
differentiable (the training path: K3 forward and K7 backward on CUDA for
the encoder's, the decoder's and the cross-attention); the decoding entry
points run under ``no_grad`` and write the caches they are given in
place. The self-cache extent is exactly what the caller asks for (the JAX
package rounds it up to 128 rows off its CPU backend for its TPU kernels;
the port's kernels mask by length). ``generate`` and ``beam_search`` are
host loops over ``decode_step``/``decode_logits`` with one read of the
result at the end (JAX scans them under jit).

``with_tp(mesh)`` gives this rank's model (tensor parallelism,
``parallel/``; quantized for serving, float for training through
``parallel.sharding.shard_model``): every attention block (the
cross-attention's K/V projections too) and FFN sharded, Megatron's
pairing, the head column-sharded over the vocabulary with its output
gathered, embedding and LayerNorms replicated.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch
from torch import nn

from qgemm_tpu_torch.device import DeviceLike, resolve_device, torch_dtype
from qgemm_tpu_torch.models.attention import MultiHeadAttention
from qgemm_tpu_torch.models.embedding import Embedding
from qgemm_tpu_torch.models.linear import Linear, check_quantize_options, shard_by_plan
from qgemm_tpu_torch.ops.kv_cache import init_quantized_kv_cache
from qgemm_tpu_torch.ops.layernorm import layernorm

_NEG = -1e30


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    # n_kv_heads < n_heads = grouped-query attention for both the decoder
    # self-attention cache and the cross-attention K/V; 0 = MHA
    n_kv_heads: int = 0
    d_ff: int = 2048
    n_layers: int = 2
    max_seq_len: int = 512
    dtype: str = "float32"

    @property
    def tdtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)


# BASELINE config 4 at the size scripts/bench_seq2seq.py serves: 12 encoder
# and 12 decoder layers, d_model 2048, 16 heads of 128, 1.54B parameters
S2S_1_5B = TransformerConfig(vocab_size=32000, d_model=2048, n_heads=16, d_ff=8192,
                             n_layers=12, max_seq_len=136, dtype="bfloat16")


class LayerNorm(nn.Module):
    def __init__(self, gamma: torch.Tensor, beta: torch.Tensor):
        super().__init__()
        self.gamma = nn.Parameter(gamma)
        self.beta = nn.Parameter(beta)

    @classmethod
    def init(cls, d: int, dtype: torch.dtype = torch.float32, device=None) -> "LayerNorm":
        return cls(torch.ones((d,), dtype=dtype, device=device),
                   torch.zeros((d,), dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.gamma, self.beta)


class FeedForward(nn.Module):
    """Linear(d, d_ff) + ReLU + Linear(d_ff, d)."""

    def __init__(self, up: nn.Module, down: nn.Module):
        super().__init__()
        self.up = up
        self.down = down

    @classmethod
    def init(cls, generator: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype = torch.float32) -> "FeedForward":
        return cls(Linear.init(generator, d_model, d_ff, dtype=dtype),
                   Linear.init(generator, d_ff, d_model, dtype=dtype))

    def quantize(self, **qkw) -> "FeedForward":
        return FeedForward(self.up.quantize(**qkw), self.down.quantize(**qkw))

    # up column-sharded (kept sharded), down row-sharded: one MAX and one SUM a call
    TP_PLAN = {"up": ("column", False), "down": ("row", True)}

    def with_tp(self, mesh, axis: str = "model") -> "FeedForward":
        """This rank's FFN, sharded by ``TP_PLAN``; both layers whole where
        either does not divide the axis."""
        lins = shard_by_plan(self, mesh, axis)
        return self if lins is None else FeedForward(lins["up"], lins["down"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(torch.relu(self.up(x)))


def _mha(generator: torch.Generator, cfg: TransformerConfig) -> MultiHeadAttention:
    return MultiHeadAttention.init(generator, cfg.d_model, cfg.n_heads, dtype=cfg.tdtype,
                                   n_kv_heads=cfg.n_kv_heads)


def _ln(cfg: TransformerConfig, generator: torch.Generator) -> LayerNorm:
    return LayerNorm.init(cfg.d_model, cfg.tdtype, generator.device)


class EncoderBlock(nn.Module):
    def __init__(self, attn: MultiHeadAttention, ffn: FeedForward, ln1: LayerNorm,
                 ln2: LayerNorm):
        super().__init__()
        self.attn, self.ffn, self.ln1, self.ln2 = attn, ffn, ln1, ln2

    @classmethod
    def init(cls, generator: torch.Generator, cfg: TransformerConfig) -> "EncoderBlock":
        return cls(_mha(generator, cfg),
                   FeedForward.init(generator, cfg.d_model, cfg.d_ff, dtype=cfg.tdtype),
                   _ln(cfg, generator), _ln(cfg, generator))

    def quantize(self, **qkw) -> "EncoderBlock":
        return EncoderBlock(self.attn.quantize(**qkw), self.ffn.quantize(**qkw),
                            self.ln1, self.ln2)

    def with_tp(self, mesh, axis: str = "model") -> "EncoderBlock":
        return EncoderBlock(self.attn.with_tp(mesh, axis), self.ffn.with_tp(mesh, axis),
                            self.ln1, self.ln2)

    def forward(self, x, mask=None):
        """``mask`` [B, S] bool marks real source positions: the encoder is
        bidirectional, so unmasked padding would reach every position."""
        x = x + self.attn(self.ln1(x), mask=mask)
        return x + self.ffn(self.ln2(x))


class DecoderBlock(nn.Module):
    def __init__(self, self_attn: MultiHeadAttention, cross_attn: MultiHeadAttention,
                 ffn: FeedForward, ln1: LayerNorm, ln2: LayerNorm, ln3: LayerNorm):
        super().__init__()
        self.self_attn, self.cross_attn, self.ffn = self_attn, cross_attn, ffn
        self.ln1, self.ln2, self.ln3 = ln1, ln2, ln3

    @classmethod
    def init(cls, generator: torch.Generator, cfg: TransformerConfig) -> "DecoderBlock":
        return cls(_mha(generator, cfg), _mha(generator, cfg),
                   FeedForward.init(generator, cfg.d_model, cfg.d_ff, dtype=cfg.tdtype),
                   _ln(cfg, generator), _ln(cfg, generator), _ln(cfg, generator))

    def quantize(self, **qkw) -> "DecoderBlock":
        return DecoderBlock(self.self_attn.quantize(**qkw), self.cross_attn.quantize(**qkw),
                            self.ffn.quantize(**qkw), self.ln1, self.ln2, self.ln3)

    def with_tp(self, mesh, axis: str = "model") -> "DecoderBlock":
        return DecoderBlock(self.self_attn.with_tp(mesh, axis),
                            self.cross_attn.with_tp(mesh, axis),
                            self.ffn.with_tp(mesh, axis), self.ln1, self.ln2, self.ln3)

    def forward(self, x, enc_kv, self_cache=None, cache_index=None, src_mask=None):
        """``enc_kv``: the cross-attention's precomputed K/V (a float pair or
        an int8 4-tuple). Full-sequence (causal) without ``self_cache``;
        with it the rows are written at ``cache_index`` and (x, self_cache)
        is returned. ``src_mask`` [B, S_src] bool masks source positions."""
        if self_cache is None:
            x = x + self.self_attn(self.ln1(x), causal=True)
        else:
            a, self_cache = self.self_attn(self.ln1(x), causal=True, kv_cache=self_cache,
                                           cache_index=cache_index)
            x = x + a
        x = x + self.cross_attn(self.ln2(x), precomputed_kv=enc_kv, mask=src_mask)
        x = x + self.ffn(self.ln3(x))
        return x if self_cache is None else (x, self_cache)


def _generator(device: torch.device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


class Transformer(nn.Module):
    def __init__(self, embed: Embedding, enc_blocks: List[EncoderBlock],
                 dec_blocks: List[DecoderBlock], ln_enc: LayerNorm, ln_dec: LayerNorm,
                 lm_head: nn.Module, cfg: TransformerConfig):
        super().__init__()
        self.embed = embed
        self.enc_blocks = nn.ModuleList(enc_blocks)
        self.dec_blocks = nn.ModuleList(dec_blocks)
        self.ln_enc, self.ln_dec = ln_enc, ln_dec
        self.lm_head = lm_head
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    @classmethod
    def init(cls, cfg: TransformerConfig, seed: int = 0,
             device: DeviceLike = None) -> "Transformer":
        """Random weights from ``torch.Generator(seed)`` on ``device``
        (default: the GPU — raises without one)."""
        return cls._draw(cfg, seed, device, lambda m: m)

    @classmethod
    def init_quantized(cls, cfg: TransformerConfig, seed: int = 0,
                       device: DeviceLike = None, **qkw) -> "Transformer":
        """Initialize straight into quantized weights (``qkw`` as for
        ``quantize``): each block is quantized and its float weights dropped
        before the next is drawn, so peak memory is the quantized model
        plus one float block. The draws are ``init``'s, so ``init`` and then
        ``quantize`` give the same model."""
        check_quantize_options(**qkw)
        return cls._draw(cfg, seed, device, lambda m: m.quantize(**qkw))

    @classmethod
    def _draw(cls, cfg: TransformerConfig, seed: int, device: DeviceLike,
              convert) -> "Transformer":
        """The draws in the JAX package's order (embedding, encoder blocks,
        decoder blocks, head), each block passed through ``convert`` as
        soon as it is drawn."""
        gen = _generator(resolve_device(device), seed)
        d = cfg.tdtype
        embed = Embedding.init(gen, cfg.vocab_size, cfg.d_model, cfg.max_seq_len, d)
        enc = [convert(EncoderBlock.init(gen, cfg)) for _ in range(cfg.n_layers)]
        dec = [convert(DecoderBlock.init(gen, cfg)) for _ in range(cfg.n_layers)]
        lm_head = convert(Linear.init(gen, cfg.d_model, cfg.vocab_size, bias=False, dtype=d))
        return cls(embed, enc, dec, _ln(cfg, gen), _ln(cfg, gen), lm_head, cfg)

    def quantize(self, **qkw) -> "Transformer":
        """Quantize every GEMM, ``lm_head`` included (int8, or int4 with
        ``bits=4``; ``outlier_threshold`` for the LLM.int8() split)."""
        check_quantize_options(**qkw)
        return Transformer(self.embed, [b.quantize(**qkw) for b in self.enc_blocks],
                           [b.quantize(**qkw) for b in self.dec_blocks], self.ln_enc,
                           self.ln_dec, self.lm_head.quantize(**qkw), self.cfg)

    # the head column-sharded over the vocabulary, its output gathered
    TP_PLAN = {"lm_head": ("column", True)}

    def with_tp(self, mesh, axis: str = "model") -> "Transformer":
        """This rank's model (see the module note)."""
        head = (shard_by_plan(self, mesh, axis) or {"lm_head": self.lm_head})["lm_head"]
        return Transformer(self.embed, [b.with_tp(mesh, axis) for b in self.enc_blocks],
                           [b.with_tp(mesh, axis) for b in self.dec_blocks], self.ln_enc,
                           self.ln_dec, head, self.cfg)

    @property
    def kv_heads(self) -> int:
        """The decoder's KV heads held here (this rank's, under a mesh)."""
        return self.dec_blocks[0].self_attn.kv_heads

    @property
    def cross_kv_heads(self) -> int:
        """The cross-attention's KV heads held here."""
        return self.dec_blocks[0].cross_attn.kv_heads

    def num_params(self) -> int:
        """Elements of every leaf (weights, codes, scales, tables)."""
        return sum(t.numel() for t in self.state_dict().values())

    # ------------------------------------------------------------------ fwd
    def encode(self, src_tokens: torch.Tensor, mask: Optional[torch.Tensor] = None):
        """src [B, S_src] -> [B, S_src, d_model]; ``mask`` [B, S_src] bool
        marks real (non-padding) positions."""
        x = self.embed(src_tokens)
        for blk in self.enc_blocks:
            x = blk(x, mask=mask)
        return self.ln_enc(x)

    def decode_full(self, tgt_tokens: torch.Tensor, enc_out: torch.Tensor) -> torch.Tensor:
        """Teacher-forced decode over the whole target -> logits [B, S_tgt,
        vocab]."""
        x = self.embed(tgt_tokens)
        for blk in self.dec_blocks:
            x = blk(x, blk.cross_attn.precompute_kv(enc_out))
        return self.lm_head(self.ln_dec(x))

    def forward(self, src_tokens: torch.Tensor, tgt_tokens: torch.Tensor) -> torch.Tensor:
        """The full encoder-decoder -> logits [B, S_tgt, vocab]."""
        return self.decode_full(tgt_tokens, self.encode(src_tokens))

    # ------------------------------------------------------------- decoding
    def init_cache(self, batch: int, max_len: int, quantized: bool = False):
        """The decoder's self-attention caches: per layer (k, v) in the model
        dtype or a ``QuantizedKVCache``, each [batch, Hkv, max_len, Dh]."""
        cfg = self.cfg
        dh = cfg.d_model // cfg.n_heads
        hkv = self.kv_heads
        dev = self.device
        if quantized:
            return [init_quantized_kv_cache(batch, hkv, max_len, dh, device=dev)
                    for _ in self.dec_blocks]
        z = lambda: torch.zeros((batch, hkv, max_len, dh), dtype=cfg.tdtype, device=dev)
        return [(z(), z()) for _ in self.dec_blocks]

    def cross_kvs(self, enc_out: torch.Tensor) -> list:
        """Every decoder layer's cross-attention (k, v) of ``enc_out``."""
        return [blk.cross_attn.precompute_kv(enc_out) for blk in self.dec_blocks]

    @torch.no_grad()
    def decode_chunk(self, tok: torch.Tensor, pos, enc_kvs, caches, src_mask=None):
        """Decoder rows tok [B, C] at positions pos..pos+C-1 (``pos`` an int
        or [B] per-slot offsets): their K/V are written into ``caches``,
        each row attends every cached position up to its own and the
        encoder output (``src_mask`` [B, S_src]). Returns (logits [B, C,
        vocab], caches): the speculative verify chunk."""
        if isinstance(pos, torch.Tensor) and pos.ndim == 1:
            c = tok.shape[1]
            posi = pos.to(tok.device)[:, None] + torch.arange(c, device=tok.device)
            x = self.embed.lookup(tok) + self.embed.positions(posi)
        else:
            x = self.embed(tok, offset=int(pos))
        for blk, kv, cache in zip(self.dec_blocks, enc_kvs, caches):
            x, _ = blk(x, kv, self_cache=cache, cache_index=pos, src_mask=src_mask)
        return self.lm_head(self.ln_dec(x)), caches

    def decode_logits(self, tok: torch.Tensor, pos, enc_kvs, caches, src_mask=None):
        """One decode step: tok [B, 1] at ``pos`` (an int or [B]) -> (logits
        [B, vocab], caches)."""
        logits, caches = self.decode_chunk(tok, pos, enc_kvs, caches, src_mask=src_mask)
        return logits[:, -1, :], caches

    def decode_step(self, tok: torch.Tensor, pos, enc_kvs, caches, src_mask=None):
        """Greedy decode step -> (next tokens [B, 1], caches)."""
        logits, caches = self.decode_logits(tok, pos, enc_kvs, caches, src_mask=src_mask)
        return logits.to(torch.float32).argmax(dim=-1, keepdim=True), caches

    @torch.no_grad()
    def generate(self, src_tokens: torch.Tensor, max_new_tokens: int, bos_token: int = 1,
                 eos_token: Optional[int] = None, quantized_cache: bool = False) -> torch.Tensor:
        """Greedy KV-cache generation: src [B, S_src] -> tokens [B,
        max_new_tokens]. After a row emits ``eos_token`` every later token
        of it is ``eos_token``. ``quantized_cache``: the int8 self-cache
        (kernel K2 on CUDA)."""
        b = src_tokens.shape[0]
        enc_kvs = self.cross_kvs(self.encode(src_tokens))
        caches = self.init_cache(b, max_new_tokens, quantized=quantized_cache)
        tok = torch.full((b, 1), bos_token, dtype=torch.int64, device=src_tokens.device)
        done = torch.zeros((b,), dtype=torch.bool, device=src_tokens.device)
        out = []
        for t in range(max_new_tokens):
            tok, caches = self.decode_step(tok, t, enc_kvs, caches)
            if eos_token is not None:
                tok = torch.where(done[:, None], torch.full_like(tok, eos_token), tok)
                done = done | (tok[:, 0] == eos_token)
            out.append(tok)
        return torch.cat(out, dim=1)

    @torch.no_grad()
    def beam_search(self, src_tokens: torch.Tensor, max_new_tokens: int, beam_size: int = 4,
                    bos_token: int = 1, eos_token: Optional[int] = None,
                    length_penalty: float = 0.6, quantized_cache: bool = False):
        """Beam search: beams fold into the batch axis (B*K cache rows), each
        step's reindex is one gather of the cache rows through the winning
        beams, copied back in place; finished beams are pinned (score
        frozen, EOS emitted). src [B, S_src] -> (tokens [B, max_new_tokens],
        scores [B]): per row the best beam by the GNMT length-normalized
        log-prob sum(logp) / ((5 + len) / 6) ** length_penalty (a beam that
        never finishes competes at full length). ``beam_size=1`` is greedy."""
        b, k = src_tokens.shape[0], beam_size
        enc_kvs = [tuple(t.repeat_interleave(k, dim=0) for t in kv)
                   for kv in self.cross_kvs(self.encode(src_tokens))]
        caches = self.init_cache(b * k, max_new_tokens, quantized=quantized_cache)
        tok = torch.full((b * k, 1), bos_token, dtype=torch.int64, device=src_tokens.device)
        # only beam 0 of each row is live at the start (identical beams
        # would spend the whole width on one continuation)
        scores = torch.full((b, k), _NEG, dtype=torch.float32, device=src_tokens.device)
        scores[:, 0] = 0.0
        return _beam_loop(lambda tok, t, caches: self.decode_logits(tok, t, enc_kvs, caches),
                          tok, caches, scores, 0, max_new_tokens, eos_token, length_penalty)


def reindex_caches(caches, rows: torch.Tensor) -> None:
    """Gather every cache tensor's batch rows through ``rows`` and write them
    back in place (a float pair's two tensors, an int8 cache's four)."""
    for cache in caches:
        for t in cache:
            t.copy_(t[rows])


def _beam_loop(logits_fn, tok, caches, scores, t0: int, max_new_tokens: int,
               eos_token: Optional[int], length_penalty: float, toks=None, done=None):
    """The beam steps shared by ``Transformer.beam_search`` and
    ``GPT.beam_search``: from step ``t0`` on, ``logits_fn(tok, t, caches)``
    gives the next logits of every beam row (B*K rows, beam-major), the
    top K of each row's K*V continuations survive, and the caches, tokens
    and finished flags follow their source beams. ``toks`` [B, K, T] and
    ``done`` [B, K] carry what steps before ``t0`` produced."""
    b, k = scores.shape
    dev = scores.device
    if toks is None:
        toks = torch.zeros((b, k, max_new_tokens), dtype=torch.int64, device=dev)
    if done is None:
        done = torch.zeros((b, k), dtype=torch.bool, device=dev)
    offsets = (torch.arange(b, device=dev) * k)[:, None]
    pin = None
    for t in range(t0, max_new_tokens):
        logits, caches = logits_fn(tok, t - t0, caches)
        v = logits.shape[-1]
        lp = torch.log_softmax(logits.to(torch.float32), dim=-1).reshape(b, k, v)
        if eos_token is not None:
            # a finished beam continues only with EOS, at no cost
            if pin is None:
                pin = torch.full((v,), _NEG, dtype=torch.float32, device=dev)
                pin[eos_token] = 0.0
            lp = torch.where(done[..., None], pin, lp)
        cand = scores[..., None] + lp
        scores, top_i = torch.topk(cand.reshape(b, k * v), k, dim=-1)
        src_beam = torch.div(top_i, v, rounding_mode="floor")
        nxt = top_i % v
        reindex_caches(caches, (src_beam + offsets).reshape(-1))
        toks = torch.gather(toks, 1, src_beam[..., None].expand(b, k, max_new_tokens))
        toks[:, :, t] = nxt
        done = torch.gather(done, 1, src_beam)
        if eos_token is not None:
            done = done | (nxt == eos_token)
        tok = nxt.reshape(-1, 1)
    return _best_beam(toks, scores, eos_token, length_penalty)


def _best_beam(toks: torch.Tensor, scores: torch.Tensor, eos_token: Optional[int],
               length_penalty: float):
    """The best beam of each row by the GNMT-normalized score: a finished
    beam's length counts to its first EOS. -> (tokens [B, T], scores [B])."""
    b, k, n = toks.shape
    if eos_token is not None:
        is_eos = toks == eos_token
        first = torch.argmax(is_eos.to(torch.int64), dim=-1)
        lens = torch.where(is_eos.any(dim=-1), first + 1, torch.full_like(first, n))
    else:
        lens = torch.full((b, k), n, dtype=torch.int64, device=toks.device)
    final = scores / (((5.0 + lens.to(torch.float32)) / 6.0) ** length_penalty)
    best = torch.argmax(final, dim=-1)
    out = torch.gather(toks, 1, best[:, None, None].expand(b, 1, n))[:, 0]
    return out, torch.gather(final, 1, best[:, None])[:, 0]
