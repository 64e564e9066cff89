"""The float weights of a decoder-only GPT (the port's ``GPT`` family), made
on the device from the seed: the benchmark's input, handed alike to the
port (``systems/gpt.py``) and to the plain reference (``reference/gpt.py``).

A few large draws in the served dtype, one per kind of leaf across all
layers, in a fixed order, so the same seed on the same device gives the
same weights every time: the reference draws them again after the window.
The distributions are the port's initialisers': embedding N(0, 1/d),
every linear uniform within ±1/sqrt(fan_in) (weights and the FFN's biases),
LayerNorm gains 1 and shifts 0, no attention biases.
"""

from __future__ import annotations

from typing import Dict

import torch

SEED_MASK = (1 << 64) - 1


def dims(model: dict) -> dict:
    d, h = int(model["d_model"]), int(model["n_heads"])
    hkv = int(model.get("n_kv_heads") or h)
    dh = d // h
    return dict(d=d, h=h, hkv=hkv, dh=dh, dkv=hkv * dh, ff=int(model["d_ff"]),
                layers=int(model["n_layers"]), vocab=int(model["vocab_size"]))


def _uniform(g: torch.Generator, shape, bound: float, dtype) -> torch.Tensor:
    w = torch.rand(shape, generator=g, device=g.device, dtype=dtype)
    return w.mul_(2.0 * bound).sub_(bound)


def make(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """``embed`` [V, d]; ``w_in`` [L, d, d + 2 dkv + d + ff] holding, along
    its last axis, W_Q | W_K | W_V | W_O | W_up, each [in, out]; ``w_down``
    [L, ff, d]; ``b_up`` [L, ff]; ``b_down`` [L, d]; ``ln_gamma`` and
    ``ln_beta`` [2 L + 1, d] (ln1 and ln2 of each layer, then ln_f);
    ``lm_head`` [d, V]."""
    k = dims(model)
    d, ff, L, V = k["d"], k["ff"], k["layers"], k["vocab"]
    dtype = getattr(torch, model["dtype"])
    g = torch.Generator(device=device)
    g.manual_seed(seed & SEED_MASK)
    embed = torch.randn((V, d), generator=g, device=g.device, dtype=dtype)
    embed.mul_(1.0 / d ** 0.5)
    return {
        "embed": embed,
        "w_in": _uniform(g, (L, d, 2 * d + 2 * k["dkv"] + ff), 1.0 / d ** 0.5, dtype),
        "w_down": _uniform(g, (L, ff, d), 1.0 / ff ** 0.5, dtype),
        "b_up": _uniform(g, (L, ff), 1.0 / d ** 0.5, dtype),
        "b_down": _uniform(g, (L, d), 1.0 / ff ** 0.5, dtype),
        "ln_gamma": torch.ones((2 * L + 1, d), device=g.device, dtype=dtype),
        "ln_beta": torch.zeros((2 * L + 1, d), device=g.device, dtype=dtype),
        "lm_head": _uniform(g, (d, V), 1.0 / d ** 0.5, dtype),
    }


def split_in(w_in_layer: torch.Tensor, model: dict) -> Dict[str, torch.Tensor]:
    """One layer's ``w_in`` [d, ...] as views: wq, wk, wv, wo, up."""
    k = dims(model)
    d, dkv = k["d"], k["dkv"]
    cuts = [("wq", d), ("wk", dkv), ("wv", dkv), ("wo", d), ("up", k["ff"])]
    out, at = {}, 0
    for name, n in cuts:
        out[name] = w_in_layer[:, at:at + n]
        at += n
    return out
