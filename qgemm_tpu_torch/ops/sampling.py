"""Token sampling: temperature / top-k / top-p (port of ``sample_logits`` and
``token_logprob`` of ``qgemm_tpu/ops/sampling.py``).

Filter order follows the HF serving convention, as in the JAX version:
top-k cut, then temperature, then top-p on the renormalized survivors; a
temperature <= 1e-6 is greedy for that slot. Every knob may be a scalar or
a per-slot [B] tensor. Random draws come from an explicit
``torch.Generator``; its stream differs from JAX's keys, so sampled tokens
are compared by distribution, greedy ones exactly.
"""

from __future__ import annotations

from typing import Optional

import torch


def _per_slot(v, b: int, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=dtype, device=device).broadcast_to((b,))


def sample_logits(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                  temperature=1.0, top_k=0, top_p=1.0) -> torch.Tensor:
    """logits [B, V] -> tokens [B] int64."""
    lg = logits.to(torch.float32)
    b, v = lg.shape
    greedy_tok = lg.argmax(dim=-1)
    temp = _per_slot(temperature, b, torch.float32, lg.device)
    topp = _per_slot(top_p, b, torch.float32, lg.device)
    topk = _per_slot(top_k, b, torch.int64, lg.device)

    # one descending sort serves both filters (stable, like jnp.argsort)
    sort_idx = torch.argsort(-lg, dim=-1, stable=True)
    sorted_lg = torch.gather(lg, -1, sort_idx)
    rank = torch.arange(v, device=lg.device)[None, :]
    keep = torch.where(topk[:, None] > 0, rank < topk[:, None],
                       torch.ones_like(rank, dtype=torch.bool))
    scaled = sorted_lg / torch.clamp_min(temp, 1e-6)[:, None]
    scaled = torch.where(keep, scaled, torch.full_like(scaled, -torch.inf))
    # nucleus on the survivors: the smallest prefix whose mass reaches
    # top_p (the first token always kept)
    probs = torch.softmax(scaled, dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    keep = keep & ((csum - probs) < topp[:, None])
    scaled = torch.where(keep, scaled, torch.full_like(scaled, -torch.inf))
    choice = torch.multinomial(torch.softmax(scaled, dim=-1), 1, generator=generator)
    sampled = torch.gather(sort_idx, -1, choice)[:, 0]
    return torch.where(temp <= 1e-6, greedy_tok, sampled)


def token_logprob(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """ln p(token) under the unmodified softmax (the standard serving
    logprob). logits [B, V], tokens [B] -> [B] f32."""
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return torch.gather(lp, 1, tokens.to(torch.int64)[:, None])[:, 0]
