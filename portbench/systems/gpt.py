"""The system under test for the GPT family: ``qgemm_tpu_torch``'s ``GPT``
built from the benchmark's float weights (``inputs/gpt.py``), quantized by
the port, and served by its ``ContinuousBatchingEngine``.

The port's own classes take the weights as they are: ``Linear`` per
projection ([in, out]), ``MultiHeadAttention``, ``FeedForward``,
``LayerNorm``, ``GPTBlock``, ``Embedding`` with the port's sinusoidal
table, ``GPT``; each block is quantized as soon as it is built
(``GPTBlock.quantize``, the port's offline weight quantization), then the
head.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.inputs.gpt import dims, split_in


def prebuild() -> None:
    """Build every CUDA library of the port at once (their ``nvcc`` runs
    side by side) where none is built yet; a no-op once they are."""
    try:
        from qgemm_tpu_torch.ops.cuda import _build
    except ImportError:
        return
    build = getattr(_build, "build", None)
    if build is not None:
        build()


@torch.no_grad()
def build_model(model: dict, weights: Dict[str, torch.Tensor], quantize: dict):
    from qgemm_tpu_torch.models.attention import MultiHeadAttention
    from qgemm_tpu_torch.models.embedding import Embedding, sinusoidal_positions
    from qgemm_tpu_torch.models.gpt import GPT, GPTBlock, GPTConfig
    from qgemm_tpu_torch.models.linear import Linear
    from qgemm_tpu_torch.models.transformer import FeedForward, LayerNorm

    k = dims(model)
    cfg = GPTConfig(**model)
    gam, bet = weights["ln_gamma"], weights["ln_beta"]
    blocks = []
    for i in range(k["layers"]):
        p = split_in(weights["w_in"][i], model)
        attn = MultiHeadAttention(Linear(p["wq"]), Linear(p["wk"]), Linear(p["wv"]),
                                  Linear(p["wo"]), cfg.n_heads, cfg.n_kv_heads)
        ffn = FeedForward(Linear(p["up"], weights["b_up"][i]),
                          Linear(weights["w_down"][i], weights["b_down"][i]))
        blk = GPTBlock(attn, ffn, LayerNorm(gam[2 * i], bet[2 * i]),
                       LayerNorm(gam[2 * i + 1], bet[2 * i + 1]))
        blocks.append(blk.quantize(**quantize))
        del blk, attn, ffn
    dev = weights["embed"].device
    embed = Embedding(weights["embed"], sinusoidal_positions(cfg.max_seq_len, cfg.d_model,
                                                             cfg.tdtype, dev))
    head = Linear(weights["lm_head"]).quantize(**quantize)
    return GPT(embed, blocks, LayerNorm(gam[-1], bet[-1]), head, cfg)


def build_engine(model, engine: dict, device):
    from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine
    return ContinuousBatchingEngine(model, device=device, **engine)


def request(prompt, max_new: int):
    """A greedy request of the engine's own type."""
    from qgemm_tpu_torch.serving.engine import Request
    return Request(prompt=prompt, max_new_tokens=max_new, temperature=0.0)
