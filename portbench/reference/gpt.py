"""Plain PyTorch reference of the GPT family as the configuration states it.

A pre-LN decoder: token embedding plus a sinusoidal table, then per layer
x += W_O attn(LN1 x) and x += W_down relu(W_up LN2 x + b_up) + b_down, then
the head on LN_f x. Every linear is int8 by LLM.int8()'s vector-wise
absmax rule: the weight's columns quantized offline in the served dtype
(codes round(w * (127 / max|w_col|)), half to even), each activation row
quantized per call in float32, the codes multiplied exactly (float64 holds
every sum) and scaled back by both absmaxes over 127^2. Keys and values
are cached as int8 per (position, head) with their absmax.

Which keys a query attends in float and which through the int8 cache
follows where the query was computed: a prompt prefilled whole attends the
projected keys and values themselves; a prompt's rows after a cached prefix
(a prefix-cache hit) and every decoded token attend the int8 cache, their
own row included. ``float_end`` says where the first kind ends.

Everything else is float32 with TF32 off, layer by layer over the sampled
sequences, so it fits beside nothing else on the card. It imports nothing
of the program: it is given the float weights the benchmark made and works
out codes, scales, tables and caches itself.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

QRANGE = 127.0
EPS = 1e-12
LN_EPS = 1e-5
Q_BLOCK = 256


@dataclass
class Sequence:
    """A served request: ``prompt`` ids, the ``served`` ids it was given,
    and ``float_end``: queries before it attend keys in float."""
    prompt: List[int]
    served: List[int]
    float_end: int


def weight_codes(w: torch.Tensor):
    """int8 codes [K, N] (as float64) and column absmax / 127 [N] (float64)
    of a weight [K, N], computed in its own dtype."""
    c = w.abs().amax(dim=0, keepdim=True).clamp_min(EPS)
    q = torch.clamp(torch.round(w * (torch.full_like(c, QRANGE) / c)), -QRANGE, QRANGE)
    return q.to(torch.float64), c.to(torch.float64)[0] / QRANGE


class QLinear:
    def __init__(self, w: torch.Tensor, b=None):
        self.codes, self.scale = weight_codes(w)
        self.b = None if b is None else b.to(torch.float32)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x [m, K] float32 -> [m, N] float32."""
        c = x.abs().amax(dim=-1, keepdim=True).clamp_min(EPS)
        q = torch.clamp(torch.round(x * (torch.full_like(c, QRANGE) / c)), -QRANGE, QRANGE)
        acc = q.to(torch.float64) @ self.codes
        y = (acc * (c.to(torch.float64) / QRANGE) * self.scale).to(torch.float32)
        return y if self.b is None else y + self.b


def sinusoid(n: int, d: int, device) -> torch.Tensor:
    pos = np.arange(n)[:, None].astype(np.float64)
    inv = 1.0 / (10000.0 ** (np.arange(0, d, 2).astype(np.float64) / d))
    ang = pos * inv[None, :]
    t = np.zeros((n, d))
    t[:, 0::2] = np.sin(ang)
    t[:, 1::2] = np.cos(ang[:, : d // 2])
    return torch.as_tensor(t, dtype=torch.float32, device=device)


def layernorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * g.to(torch.float32) + b.to(torch.float32)


def int8_rows(x: torch.Tensor) -> torch.Tensor:
    """x [..., D] through the int8 cache: quantized per row and read back."""
    c = x.abs().amax(dim=-1, keepdim=True).clamp_min(EPS)
    q = torch.clamp(torch.round(x * (torch.full_like(c, QRANGE) / c)), -QRANGE, QRANGE)
    return q * (c / QRANGE)


def attention(q, k, v, float_end: int) -> torch.Tensor:
    """Causal attention of q [n, H, Dh] over k, v [n, Hkv, Dh]; queries
    before ``float_end`` read k and v, the rest their int8 rows."""
    n, h, dh = q.shape
    g = h // k.shape[1]
    kf, vf = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    k8, v8 = int8_rows(k).repeat_interleave(g, dim=1), int8_rows(v).repeat_interleave(g, dim=1)
    out = torch.empty_like(q)
    qh = q.transpose(0, 1)                                        # [H, n, Dh]
    for a in range(0, n, Q_BLOCK):
        b = min(n, a + Q_BLOCK)
        rows = torch.arange(a, b, device=q.device)
        mask = torch.arange(b, device=q.device)[None, :] <= rows[:, None]
        blk = []
        for kk, vv in ((kf, vf), (k8, v8)):
            s = qh[:, a:b] @ kk[:b].transpose(0, 1).transpose(1, 2) / math.sqrt(dh)
            s = torch.where(mask[None], s, torch.full_like(s, -math.inf))
            blk.append(torch.softmax(s, dim=-1) @ vv[:b].transpose(0, 1))
        use_float = (rows < float_end)[None, :, None]
        out[a:b] = torch.where(use_float, blk[0], blk[1]).transpose(0, 1)
    return out


@torch.no_grad()
def served_gaps(model: dict, weights: Dict[str, torch.Tensor],
                seqs: List[Sequence]) -> List[np.ndarray]:
    """For each sequence, the reference's best logit minus its logit of each
    served token, at every served position (float64 arrays)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    d, h = int(model["d_model"]), int(model["n_heads"])
    hkv = int(model.get("n_kv_heads") or h)
    dh, ff = d // h, int(model["d_ff"])
    dkv = hkv * dh
    dev = weights["embed"].device
    table = sinusoid(int(model["max_seq_len"]), d, dev)
    gam, bet = weights["ln_gamma"], weights["ln_beta"]
    toks = [torch.as_tensor(s.prompt + s.served[:-1], device=dev) for s in seqs]
    xs = [weights["embed"][t].to(torch.float32) + table[:len(t)] for t in toks]
    for i in range(int(model["n_layers"])):
        w = weights["w_in"][i]
        at = np.cumsum([0, d, dkv, dkv, d, ff])
        wq, wk, wv, wo = (QLinear(w[:, at[j]:at[j + 1]]) for j in range(4))
        up = QLinear(w[:, at[4]:at[5]], weights["b_up"][i])
        down = QLinear(weights["w_down"][i], weights["b_down"][i])
        for j, s in enumerate(seqs):
            x = xs[j]
            n = x.shape[0]
            a = layernorm(x, gam[2 * i], bet[2 * i])
            q = wq(a).reshape(n, h, dh)
            k = wk(a).reshape(n, hkv, dh)
            v = wv(a).reshape(n, hkv, dh)
            x = x + wo(attention(q, k, v, s.float_end).reshape(n, d))
            a = layernorm(x, gam[2 * i + 1], bet[2 * i + 1])
            xs[j] = x + down(torch.relu(up(a)))
        del wq, wk, wv, wo, up, down
    head = QLinear(weights["lm_head"])
    gaps = []
    for j, s in enumerate(seqs):
        plen = len(s.prompt)
        rows = xs[j][plen - 1:]
        logits = head(layernorm(rows, gam[-1], bet[-1])).to(torch.float64)
        served = torch.as_tensor(s.served, device=dev)
        gap = logits.max(dim=-1).values - logits.gather(1, served[:, None])[:, 0]
        gaps.append(gap.cpu().numpy())
    return gaps
