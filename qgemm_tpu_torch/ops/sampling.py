"""Token sampling: temperature / top-k / top-p (port of
``qgemm_tpu/ops/sampling.py``).

Filter order follows the HF serving convention, as in the JAX version:
top-k cut, then temperature, then top-p on the renormalized survivors; a
temperature <= 1e-6 is greedy for that slot. Every knob may be a scalar or
a per-slot [B] tensor. One descending sort serves both filters
(``_warped_sorted``); where top-k and top-p are Python literals that turn
them off (``_filters_off``) the warp is ``softmax(logits / T)`` and no sort
runs (the speculative draft samples that way). Random draws come from an
explicit ``torch.Generator``; its stream differs from JAX's keys, so
sampled tokens are compared by distribution, greedy ones and the
probabilities exactly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _per_slot(v, b: int, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=dtype, device=device).broadcast_to((b,))


def _filters_off(top_k, top_p) -> bool:
    """True when top-k and top-p are Python literals that disable them (the
    speculative draft's ``0, 1.0``): the warp is then the temperature
    softmax, with no sort over the vocabulary."""
    return (isinstance(top_k, int) and top_k == 0
            and isinstance(top_p, (int, float)) and top_p >= 1.0)


def _warped_sorted(logits: torch.Tensor, temperature, top_k, top_p):
    """The filter pipeline in sorted space: (the scaled sorted logits with
    the filtered entries at -inf, the sort permutation, temperature [B])."""
    lg = logits.to(torch.float32)
    b, v = lg.shape
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
    return scaled, sort_idx, temp


def _temperature_scaled(logits: torch.Tensor, temperature):
    """(logits / T in float32, T [B]): the warp with the filters off."""
    lg = logits.to(torch.float32)
    temp = _per_slot(temperature, lg.shape[0], torch.float32, lg.device)
    return lg / torch.clamp_min(temp, 1e-6)[:, None], temp


def sample_logits(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                  temperature=1.0, top_k=0, top_p=1.0) -> torch.Tensor:
    """logits [B, V] -> tokens [B] int64."""
    greedy_tok = logits.to(torch.float32).argmax(dim=-1)
    scaled, sort_idx, temp = _warped_sorted(logits, temperature, top_k, top_p)
    # sample a rank, then map it back through the sort permutation
    choice = torch.multinomial(torch.softmax(scaled, dim=-1), 1, generator=generator)
    sampled = torch.gather(sort_idx, -1, choice)[:, 0]
    return torch.where(temp <= 1e-6, greedy_tok, sampled)


def warped_probs(logits: torch.Tensor, temperature=1.0, top_k=0, top_p=1.0) -> torch.Tensor:
    """The filtered distribution [B, V] that ``sample_logits`` draws from,
    in token order; a temperature <= 1e-6 gives the greedy one-hot."""
    lg = logits.to(torch.float32)
    vocab = torch.arange(lg.shape[1], device=lg.device)
    onehot = (vocab[None, :] == lg.argmax(dim=-1)[:, None]).to(torch.float32)
    if _filters_off(top_k, top_p):
        scaled, temp = _temperature_scaled(lg, temperature)
        probs = torch.softmax(scaled, dim=-1)
    else:
        scaled, sort_idx, temp = _warped_sorted(lg, temperature, top_k, top_p)
        # scatter back to token order through the sort permutation
        probs = torch.zeros_like(scaled).scatter(-1, sort_idx, torch.softmax(scaled, dim=-1))
    return torch.where((temp <= 1e-6)[:, None], onehot, probs)


def sample_logits_with_prob(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                            temperature=1.0, top_k=0,
                            top_p=1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``sample_logits`` that also returns each drawn token's probability
    under the warped distribution it was drawn from, read in sorted space
    (the rank is the draw), so no [B, V] distribution is scattered back.
    Greedy slots return probability 1. -> (tokens [B] int64, probs [B] f32)."""
    greedy_tok = logits.to(torch.float32).argmax(dim=-1)
    if _filters_off(top_k, top_p):
        scaled, temp = _temperature_scaled(logits, temperature)
        sampled = torch.multinomial(torch.softmax(scaled, dim=-1), 1, generator=generator)
        picked = torch.gather(scaled, -1, sampled)[:, 0]
        sampled = sampled[:, 0]
    else:
        scaled, sort_idx, temp = _warped_sorted(logits, temperature, top_k, top_p)
        choice = torch.multinomial(torch.softmax(scaled, dim=-1), 1, generator=generator)
        sampled = torch.gather(sort_idx, -1, choice)[:, 0]
        picked = torch.gather(scaled, -1, choice)[:, 0]
    qx = torch.exp(picked - torch.logsumexp(scaled, dim=-1))
    greedy = temp <= 1e-6
    return (torch.where(greedy, greedy_tok, sampled),
            torch.where(greedy, torch.ones_like(qx), qx))


def warped_token_probs(logits: torch.Tensor, tokens: torch.Tensor, temperature=1.0,
                       top_k=0, top_p=1.0) -> torch.Tensor:
    """Probability of the given tokens [B] under the warped distribution
    (``warped_probs``' pipeline), read in sorted space: each token's rank
    from one compare against the sort permutation. Filtered-out tokens get
    0; greedy slots 1 at the argmax, else 0. -> [B] f32."""
    tokens = tokens.to(torch.int64)
    if _filters_off(top_k, top_p):
        lg = logits.to(torch.float32)
        scaled, temp = _temperature_scaled(lg, temperature)
        picked = torch.gather(scaled, -1, tokens[:, None])[:, 0]
        greedy_hit = (tokens == lg.argmax(dim=-1)).to(torch.float32)
    else:
        scaled, sort_idx, temp = _warped_sorted(logits, temperature, top_k, top_p)
        rank = (sort_idx == tokens[:, None]).to(torch.int32).argmax(dim=-1)
        picked = torch.gather(scaled, -1, rank[:, None])[:, 0]
        greedy_hit = (rank == 0).to(torch.float32)
    px = torch.exp(picked - torch.logsumexp(scaled, dim=-1))
    return torch.where(temp <= 1e-6, greedy_hit, px)


def token_logprob(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """ln p(token) under the unmodified softmax (the standard serving
    logprob). logits [B, V], tokens [B] -> [B] f32."""
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return torch.gather(lp, 1, tokens.to(torch.int64)[:, None])[:, 0]
