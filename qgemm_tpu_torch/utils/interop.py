"""Carry a ``qgemm_tpu`` model's weights, and a paged cache's state, into
the port.

The JAX package's checkpoints (``qgemm_tpu/utils/checkpoint.py``) are
``.npz`` files keyed by pytree path — ``embed/table``,
``blocks/0/attn/wqkv_q/wq/q``, ``blocks/0/ffn/up/b``, ``ln_f/gamma``,
``lm_head/w`` — with bf16 (and other non-numpy) leaves stored as unsigned
bits beside a ``<key>.__dtype__`` tag. ``gpt_from_jax_params`` takes that
mapping (``np.load`` of such a file, or the same dict built in memory) and
returns the port's ``GPT``: float weights as they are, int8 codes
(``.../wq/q``), packed int4 codes (``.../wq/qp``) and their scales bit for
bit (codes transposed once to the port's K-major layout). An MoE block's
FFN holds ``ffn/router_w`` and ``ffn/w_up``, ``ffn/w_down`` (float), or
``ffn/w_up/q`` and ``ffn/w_up/c`` (and ``w_down``'s) when int8. The outlier
options are meta fields, which checkpoints do not hold, so they are
arguments. ``transformer_from_jax_params`` does the same for the
encoder-decoder ``Transformer`` (``enc_blocks/0/attn/...``,
``dec_blocks/0/self_attn/...``, ``dec_blocks/0/cross_attn/...``,
``ln_enc``, ``ln_dec``), and ``mlp_from_jax_params`` for the ``MLP``
(``layers/0/w``, ``layers/0/b``, ``layers/0/wq/q``). ``gpt_to_numpy_params``,
``transformer_to_numpy_params`` and ``mlp_to_numpy_params`` are the reverse:
the port's model (float, int8 or int4) as the same path-keyed numpy leaves,
so a model trained by the port loads into the JAX package; ``gpt_leaves``,
``transformer_leaves`` and ``mlp_leaves`` give the same leaves as tensors.
``paged_cache_from_numpy`` builds the port's ``PagedKVCache`` from a JAX
``PagedKVCache``'s arrays. All of them read and write numpy only; they
never import JAX. A rank's model of a tensor-parallel deployment is the
unsharded load followed by ``parallel.sharding.shard_quantized_model``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from qgemm_tpu_torch.device import DeviceLike, resolve_device
from qgemm_tpu_torch.models.attention import MultiHeadAttention
from qgemm_tpu_torch.models.embedding import Embedding
from qgemm_tpu_torch.models.gpt import GPT, GPTBlock, GPTConfig
from qgemm_tpu_torch.models.linear import Linear, QuantizedLinear
from qgemm_tpu_torch.models.mlp import MLP
from qgemm_tpu_torch.models.moe import MoEFeedForward, QuantizedExpertWeight
from qgemm_tpu_torch.models.transformer import (DecoderBlock, EncoderBlock, FeedForward,
                                                LayerNorm, Transformer, TransformerConfig)
from qgemm_tpu_torch.ops.quantize import QuantizedWeight, QuantizedWeight4
from qgemm_tpu_torch.serving.paged_cache import PAGE_SIZE, PagedKVCache, check_kv_bits

DTYPE_TAG = ".__dtype__"
_TAGGED = {"bfloat16": torch.bfloat16}


def to_tensor(params: Mapping[str, np.ndarray], key: str, device) -> torch.Tensor:
    """One leaf as a torch tensor, decoding a dtype tag if present."""
    arr = np.asarray(params[key])
    tag = key + DTYPE_TAG
    if tag in params:
        name = str(np.asarray(params[tag]))
        if name not in _TAGGED:
            raise ValueError(f"{key}: unsupported tagged dtype {name!r}")
        bits = torch.from_numpy(np.array(arr).view(np.int16))
        return bits.view(_TAGGED[name]).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def to_numpy_leaves(key: str, t: torch.Tensor) -> Dict[str, np.ndarray]:
    """One tensor as ``save_checkpoint`` stores a leaf: native numpy dtypes
    as they are, bf16 as its uint16 bits beside a ``<key>.__dtype__`` tag."""
    t = t.detach().to("cpu").contiguous()
    inv = {v: k for k, v in _TAGGED.items()}
    if t.dtype in inv:
        return {key: t.view(torch.int16).numpy().view(np.uint16),
                key + DTYPE_TAG: np.array(inv[t.dtype])}
    return {key: t.numpy()}


def _linear_leaves(mod, prefix: str) -> Dict[str, torch.Tensor]:
    if isinstance(mod, QuantizedLinear):
        wq = mod.wq
        out = ({f"{prefix}/wq/qp": wq.qp} if mod.bits == 4 else {f"{prefix}/wq/q": wq.q})
        out[f"{prefix}/wq/c"] = wq.c
    else:
        out = {f"{prefix}/w": mod.w}
    if mod.b is not None:
        out[f"{prefix}/b"] = mod.b
    return out


def _ffn_leaves(ffn, prefix: str) -> Dict[str, torch.Tensor]:
    if not isinstance(ffn, MoEFeedForward):
        return {**_linear_leaves(ffn.up, f"{prefix}/up"),
                **_linear_leaves(ffn.down, f"{prefix}/down")}
    out = {f"{prefix}/router_w": ffn.router_w}
    for name, w in zip(("w_up", "w_down"), ffn.expert_weights()):
        if ffn.is_quantized:
            out.update({f"{prefix}/{name}/q": w.q, f"{prefix}/{name}/c": w.c})
        else:
            out[f"{prefix}/{name}"] = w
    return out


def _attention_leaves(attn, prefix: str) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for n in ("wqkv_q", "wqkv_k", "wqkv_v", "w_o"):
        out.update(_linear_leaves(getattr(attn, n), f"{prefix}/{n}"))
    return out


def _layernorm_leaves(ln, prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}/gamma": ln.gamma, f"{prefix}/beta": ln.beta}


def _embed_leaves(embed) -> Dict[str, torch.Tensor]:
    return {"embed/table": embed.table, "embed/pos": embed.pos}


def gpt_leaves(model: GPT) -> Dict[str, torch.Tensor]:
    """The port's GPT as its JAX pytree's leaves, keyed by path in the
    pytree's order, as tensors (int8 and packed int4 codes as ``[k, n]``
    views of the K-major buffers; nothing is copied)."""
    out = _embed_leaves(model.embed)
    for i, blk in enumerate(model.blocks):
        p = f"blocks/{i}"
        out.update(_attention_leaves(blk.attn, f"{p}/attn"))
        out.update(_ffn_leaves(blk.ffn, f"{p}/ffn"))
        out.update(_layernorm_leaves(blk.ln1, f"{p}/ln1"))
        out.update(_layernorm_leaves(blk.ln2, f"{p}/ln2"))
    out.update(_layernorm_leaves(model.ln_f, "ln_f"))
    out.update(_linear_leaves(model.lm_head, "lm_head"))
    return out


def transformer_leaves(model: Transformer) -> Dict[str, torch.Tensor]:
    """The port's encoder-decoder ``Transformer`` as its JAX pytree's
    leaves, keyed by path in the pytree's order, as tensors."""
    out = _embed_leaves(model.embed)
    for i, blk in enumerate(model.enc_blocks):
        p = f"enc_blocks/{i}"
        out.update(_attention_leaves(blk.attn, f"{p}/attn"))
        out.update(_ffn_leaves(blk.ffn, f"{p}/ffn"))
        out.update(_layernorm_leaves(blk.ln1, f"{p}/ln1"))
        out.update(_layernorm_leaves(blk.ln2, f"{p}/ln2"))
    for i, blk in enumerate(model.dec_blocks):
        p = f"dec_blocks/{i}"
        out.update(_attention_leaves(blk.self_attn, f"{p}/self_attn"))
        out.update(_attention_leaves(blk.cross_attn, f"{p}/cross_attn"))
        out.update(_ffn_leaves(blk.ffn, f"{p}/ffn"))
        for n in ("ln1", "ln2", "ln3"):
            out.update(_layernorm_leaves(getattr(blk, n), f"{p}/{n}"))
    out.update(_layernorm_leaves(model.ln_enc, "ln_enc"))
    out.update(_layernorm_leaves(model.ln_dec, "ln_dec"))
    out.update(_linear_leaves(model.lm_head, "lm_head"))
    return out


def mlp_leaves(model: MLP) -> Dict[str, torch.Tensor]:
    """The port's ``MLP`` as its JAX pytree's leaves (``layers/<i>/...``)."""
    out: Dict[str, torch.Tensor] = {}
    for i, layer in enumerate(model.layers):
        out.update(_linear_leaves(layer, f"layers/{i}"))
    return out


def _to_numpy_params(leaves: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, t in leaves.items():
        out.update(to_numpy_leaves(key, t))
    return out


def gpt_to_numpy_params(model: GPT) -> Dict[str, np.ndarray]:
    """The port's GPT as the path-keyed leaves ``gpt_from_jax_params`` reads
    and the JAX package's ``load_checkpoint`` restores: bf16 as uint16 bits
    + a dtype tag, int8 codes (``wq/q``) and packed int4 codes (``wq/qp``)
    back in JAX's ``[k, n]`` layout, scales as they are."""
    return _to_numpy_params(gpt_leaves(model))


def transformer_to_numpy_params(model: Transformer) -> Dict[str, np.ndarray]:
    """The port's ``Transformer`` as path-keyed numpy leaves, as
    ``gpt_to_numpy_params`` gives a GPT's."""
    return _to_numpy_params(transformer_leaves(model))


def mlp_to_numpy_params(model: MLP) -> Dict[str, np.ndarray]:
    """The port's ``MLP`` as path-keyed numpy leaves, as
    ``gpt_to_numpy_params`` gives a GPT's."""
    return _to_numpy_params(mlp_leaves(model))


def _in_features(prefix: str, cfg) -> int:
    """The true K of a model's linear at ``prefix`` (JAX keeps it as a
    meta field, which the leaves do not carry; row-parallel W4A8 needs it)."""
    return cfg.d_ff if prefix.endswith("ffn/down") else cfg.d_model


def _linear(params, prefix: str, device, in_features: Optional[int] = None, **outliers):
    bias = f"{prefix}/b"
    b = to_tensor(params, bias, device) if bias in params else None
    for leaf, kind in (("q", QuantizedWeight), ("qp", QuantizedWeight4)):
        if f"{prefix}/wq/{leaf}" in params:
            wq = kind.from_kn(to_tensor(params, f"{prefix}/wq/{leaf}", device),
                              to_tensor(params, f"{prefix}/wq/c", device))
            return QuantizedLinear(wq, b, in_features=in_features, **outliers)
    return Linear(to_tensor(params, f"{prefix}/w", device), b)


def _moe(params, prefix: str, device, top_k: int) -> MoEFeedForward:
    def experts(name):
        if f"{prefix}/{name}/q" in params:
            return QuantizedExpertWeight.from_kn(to_tensor(params, f"{prefix}/{name}/q", device),
                                                 to_tensor(params, f"{prefix}/{name}/c", device))
        return to_tensor(params, f"{prefix}/{name}", device)
    return MoEFeedForward(to_tensor(params, f"{prefix}/router_w", device), experts("w_up"),
                          experts("w_down"), top_k=top_k)


def _attention(linear, prefix: str, cfg) -> MultiHeadAttention:
    """The attention module at ``prefix`` (its four projections by
    ``linear``)."""
    return MultiHeadAttention(*(linear(f"{prefix}/{n}")
                                for n in ("wqkv_q", "wqkv_k", "wqkv_v", "w_o")),
                              n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads)


def _layernorm(params, prefix: str, device) -> LayerNorm:
    return LayerNorm(to_tensor(params, f"{prefix}/gamma", device),
                     to_tensor(params, f"{prefix}/beta", device))


def gpt_from_jax_params(params: Mapping[str, np.ndarray], cfg: GPTConfig,
                        device: DeviceLike = None, outlier_threshold: float = 0.0,
                        outlier_capacity: int = 32) -> GPT:
    """Build the port's GPT from a ``qgemm_tpu`` GPT's path-keyed leaves
    (float, int8 or int4, any mix). Every quantized linear gets the outlier
    options the JAX model was quantized with. ``device`` defaults to the
    GPU."""
    dev = resolve_device(device)
    outliers = dict(outlier_threshold=outlier_threshold,
                    outlier_capacity=outlier_capacity)

    def linear(prefix):
        return _linear(params, prefix, dev, _in_features(prefix, cfg), **outliers)

    blocks = []
    for i in range(cfg.n_layers):
        p = f"blocks/{i}"
        attn = _attention(linear, f"{p}/attn", cfg)
        if cfg.n_experts > 0:
            ffn = _moe(params, f"{p}/ffn", dev, cfg.moe_top_k)
        else:
            ffn = FeedForward(linear(f"{p}/ffn/up"), linear(f"{p}/ffn/down"))
        blocks.append(GPTBlock(attn, ffn, _layernorm(params, f"{p}/ln1", dev),
                               _layernorm(params, f"{p}/ln2", dev)))
    embed = Embedding(to_tensor(params, "embed/table", dev),
                      to_tensor(params, "embed/pos", dev))
    return GPT(embed, blocks, _layernorm(params, "ln_f", dev), linear("lm_head"), cfg)


def transformer_from_jax_params(params: Mapping[str, np.ndarray], cfg: TransformerConfig,
                                device: DeviceLike = None) -> Transformer:
    """Build the port's encoder-decoder ``Transformer`` from a ``qgemm_tpu``
    Transformer's path-keyed leaves (float, int8 or int4, any mix), as
    ``gpt_from_jax_params`` builds the GPT. ``device`` defaults to the
    GPU."""
    dev = resolve_device(device)
    linear = lambda prefix: _linear(params, prefix, dev, _in_features(prefix, cfg))
    ln = lambda prefix: _layernorm(params, prefix, dev)
    mha = lambda prefix: _attention(linear, prefix, cfg)
    ffn = lambda prefix: FeedForward(linear(f"{prefix}/up"), linear(f"{prefix}/down"))
    enc = [EncoderBlock(mha(f"enc_blocks/{i}/attn"), ffn(f"enc_blocks/{i}/ffn"),
                        ln(f"enc_blocks/{i}/ln1"), ln(f"enc_blocks/{i}/ln2"))
           for i in range(cfg.n_layers)]
    dec = [DecoderBlock(mha(f"dec_blocks/{i}/self_attn"), mha(f"dec_blocks/{i}/cross_attn"),
                        ffn(f"dec_blocks/{i}/ffn"),
                        *(ln(f"dec_blocks/{i}/ln{j}") for j in (1, 2, 3)))
           for i in range(cfg.n_layers)]
    embed = Embedding(to_tensor(params, "embed/table", dev), to_tensor(params, "embed/pos", dev))
    return Transformer(embed, enc, dec, ln("ln_enc"), ln("ln_dec"), linear("lm_head"), cfg)


def mlp_from_jax_params(params: Mapping[str, np.ndarray], device: DeviceLike = None,
                        remat: bool = False, outlier_threshold: float = 0.0,
                        outlier_capacity: int = 32) -> MLP:
    """Build the port's ``MLP`` from a ``qgemm_tpu`` MLP's path-keyed leaves
    (float, int8 or int4 layers; as many layers as ``layers/<i>`` keys).
    ``remat`` and the outlier options are meta fields, which checkpoints do
    not hold. ``device`` defaults to the GPU."""
    dev = resolve_device(device)
    n = 1 + max(int(k.split("/")[1]) for k in params if k.startswith("layers/"))
    outliers = dict(outlier_threshold=outlier_threshold, outlier_capacity=outlier_capacity)
    return MLP([_linear(params, f"layers/{i}", dev, **outliers) for i in range(n)],
               remat=remat)


def paged_cache_from_numpy(kq: np.ndarray, kc: np.ndarray, vq: np.ndarray, vc: np.ndarray,
                           page_table: np.ndarray, step_slot: Optional[np.ndarray] = None,
                           step_page: Optional[np.ndarray] = None,
                           page_size: int = PAGE_SIZE, kv_bits: int = 8,
                           device: DeviceLike = None) -> PagedKVCache:
    """The port's ``PagedKVCache`` from a JAX ``PagedKVCache``'s arrays (the
    pools, scales and page table, and the step tables if it has them) and
    meta fields, in the same layout. Pools, scales and page table go to
    ``device`` (default: the GPU); the step tables stay on the host, where
    the port's engine keeps them (kernel K5 does not read them)."""
    check_kv_bits(kv_bits, page_size)
    dev = resolve_device(device)
    put = lambda a, dtype: torch.from_numpy(np.array(a, dtype=dtype)).to(dev)
    host = lambda a: None if a is None else torch.from_numpy(np.array(a, dtype=np.int32))
    return PagedKVCache(kq=put(kq, np.int8), kc=put(kc, np.float32), vq=put(vq, np.int8),
                        vc=put(vc, np.float32), page_table=put(page_table, np.int32),
                        step_slot=host(step_slot), step_page=host(step_page),
                        page_size=page_size, kv_bits=kv_bits)
