"""Carry a ``qgemm_tpu`` model's weights into the port.

The JAX package's checkpoints (``qgemm_tpu/utils/checkpoint.py``) are
``.npz`` files keyed by pytree path — ``embed/table``,
``blocks/0/attn/wqkv_q/wq/q``, ``blocks/0/ffn/up/b``, ``ln_f/gamma``,
``lm_head/w`` — with bf16 (and other non-numpy) leaves stored as unsigned
bits beside a ``<key>.__dtype__`` tag. ``gpt_from_jax_params`` takes that
mapping (``np.load`` of such a file, or the same dict built in memory) and
returns the port's ``GPT``: float weights as they are, int8 codes
(``.../wq/q``), packed int4 codes (``.../wq/qp``) and their scales bit for
bit (codes transposed once to the port's K-major layout). The outlier
options are meta fields, which checkpoints do not hold, so they are
arguments. It reads numpy only; it never imports JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from qgemm_tpu_torch.device import DeviceLike, resolve_device
from qgemm_tpu_torch.models.attention import MultiHeadAttention
from qgemm_tpu_torch.models.embedding import Embedding
from qgemm_tpu_torch.models.gpt import GPT, GPTBlock, GPTConfig
from qgemm_tpu_torch.models.linear import Linear, QuantizedLinear
from qgemm_tpu_torch.models.transformer import FeedForward, LayerNorm
from qgemm_tpu_torch.ops.quantize import QuantizedWeight, QuantizedWeight4

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


def _linear(params, prefix: str, device, **outliers):
    bias = f"{prefix}/b"
    b = to_tensor(params, bias, device) if bias in params else None
    for leaf, kind in (("q", QuantizedWeight), ("qp", QuantizedWeight4)):
        if f"{prefix}/wq/{leaf}" in params:
            wq = kind.from_kn(to_tensor(params, f"{prefix}/wq/{leaf}", device),
                              to_tensor(params, f"{prefix}/wq/c", device))
            return QuantizedLinear(wq, b, **outliers)
    return Linear(to_tensor(params, f"{prefix}/w", device), b)


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
        return _linear(params, prefix, dev, **outliers)

    blocks = []
    for i in range(cfg.n_layers):
        p = f"blocks/{i}"
        attn = MultiHeadAttention(*(linear(f"{p}/attn/{n}")
                                    for n in ("wqkv_q", "wqkv_k", "wqkv_v", "w_o")),
                                  n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads)
        ffn = FeedForward(linear(f"{p}/ffn/up"), linear(f"{p}/ffn/down"))
        blocks.append(GPTBlock(attn, ffn, _layernorm(params, f"{p}/ln1", dev),
                               _layernorm(params, f"{p}/ln2", dev)))
    embed = Embedding(to_tensor(params, "embed/table", dev),
                      to_tensor(params, "embed/pos", dev))
    return GPT(embed, blocks, _layernorm(params, "ln_f", dev), linear("lm_head"), cfg)
