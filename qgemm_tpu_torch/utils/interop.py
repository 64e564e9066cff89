"""Carry a ``qgemm_tpu`` model's weights into the port.

The JAX package's checkpoints (``qgemm_tpu/utils/checkpoint.py``) are
``.npz`` files keyed by pytree path — ``embed/table``,
``blocks/0/attn/wqkv_q/wq/q``, ``blocks/0/ffn/up/b``, ``ln_f/gamma``,
``lm_head/w`` — with bf16 (and other non-numpy) leaves stored as unsigned
bits beside a ``<key>.__dtype__`` tag. ``gpt_from_jax_params`` takes that
mapping (``np.load`` of such a file, or the same dict built in memory) and
returns the port's ``GPT``: float weights as they are, int8 codes and
scales bit for bit (codes transposed once to the port's K-major layout).
It reads numpy only; it never imports JAX.
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
from qgemm_tpu_torch.ops.quantize import QuantizedWeight

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


def _linear(params, prefix: str, device):
    bias = f"{prefix}/b"
    b = to_tensor(params, bias, device) if bias in params else None
    if f"{prefix}/wq/q" in params:
        wq = QuantizedWeight.from_kn(to_tensor(params, f"{prefix}/wq/q", device),
                                     to_tensor(params, f"{prefix}/wq/c", device))
        return QuantizedLinear(wq, b)
    return Linear(to_tensor(params, f"{prefix}/w", device), b)


def _layernorm(params, prefix: str, device) -> LayerNorm:
    return LayerNorm(to_tensor(params, f"{prefix}/gamma", device),
                     to_tensor(params, f"{prefix}/beta", device))


def gpt_from_jax_params(params: Mapping[str, np.ndarray], cfg: GPTConfig,
                        device: DeviceLike = None) -> GPT:
    """Build the port's GPT from a ``qgemm_tpu`` GPT's path-keyed leaves
    (float or quantized, any mix). ``device`` defaults to the GPU."""
    dev = resolve_device(device)
    blocks = []
    for i in range(cfg.n_layers):
        p = f"blocks/{i}"
        attn = MultiHeadAttention(*(_linear(params, f"{p}/attn/{n}", dev)
                                    for n in ("wqkv_q", "wqkv_k", "wqkv_v", "w_o")),
                                  n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads)
        ffn = FeedForward(_linear(params, f"{p}/ffn/up", dev),
                          _linear(params, f"{p}/ffn/down", dev))
        blocks.append(GPTBlock(attn, ffn, _layernorm(params, f"{p}/ln1", dev),
                               _layernorm(params, f"{p}/ln2", dev)))
    embed = Embedding(to_tensor(params, "embed/table", dev),
                      to_tensor(params, "embed/pos", dev))
    return GPT(embed, blocks, _layernorm(params, "ln_f", dev),
               _linear(params, "lm_head", dev), cfg)
