"""Speculative decoding for one sequence (port of
``qgemm_tpu/serving/speculative.py``): a cheap draft model proposes gamma
tokens, the target verifies them in one multi-token forward, and the
longest acceptable prefix is kept, so a target forward yields (accepted + 1)
tokens instead of 1.

Both models keep position-masked dense caches: each writes K/V at the
positions its tokens would take, and the rows of rejected proposals are
never attended (decode masks by position) and are overwritten by the next
round. The draft takes gamma + 1 decode steps a round (the last one only
writes the last proposal's K/V, so a fully accepted round leaves no hole);
the target verifies with one ``prefill_chunk`` at the round's offset.

The round loop runs on the host, with one device-to-host read a round (the
block and how much of it counts), where JAX runs one ``lax.while_loop`` on
the device. The natural draft is the target's own W4A8 copy
(``GPT.init_quantized(cfg, seed=s, bits=4)`` beside the target's int8
``GPT.init_quantized(cfg, seed=s)``): no second model is trained.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from qgemm_tpu_torch.ops.sampling import sample_logits_with_prob, warped_probs
from qgemm_tpu_torch.serving.engine import spec_accept, spec_accept_greedy


class SpecResult(NamedTuple):
    tokens: torch.Tensor   # [max_new_tokens] int64, on the host
    rounds: int            # target forwards taken (the prefill included)
    drafted: int           # draft tokens proposed
    accepted: int          # draft tokens accepted


def _check(target, draft, prompt: torch.Tensor, max_new_tokens: int, gamma: int) -> int:
    """The batch-1 and extent checks of both entry points; returns the
    cache extent, prompt + max_new_tokens + gamma + 2."""
    b, s_p = prompt.shape
    if b != 1:
        raise ValueError(f"speculative decoding is per sequence (batch 1), got {b}")
    ext = s_p + max_new_tokens + gamma + 2
    for name, m in (("target", target), ("draft", draft)):
        limit = m.cfg.max_seq_len
        if ext > limit:
            raise ValueError(f"{name}: prompt + max_new_tokens + gamma + 2 = {ext} exceeds "
                             f"max_seq_len {limit} (the verify chunk may run past the "
                             "position table)")
    return ext


@torch.no_grad()
def _speculate(target, draft, prompt: torch.Tensor, max_new_tokens: int, gamma: int,
               quantized_cache: bool, eos_token: Optional[int], first, propose,
               accept) -> SpecResult:
    """The round loop both entry points share. ``first(logits [1, V])``
    picks the first token; ``propose(logits [1, V])`` -> (token [1], its
    draft probability [1] or None); ``accept(tlogits, d, qx, dlogits)`` ->
    ``spec_accept``'s (cand, produced, cur_new, lps) for batch 1."""
    ext = _check(target, draft, prompt, max_new_tokens, gamma)
    s_p = prompt.shape[1]
    tc = target.init_cache(1, ext, quantized=quantized_cache)
    dc = draft.init_cache(1, ext, quantized=quantized_cache)
    tl, _ = target.prefill(prompt, tc)
    draft.prefill(prompt, dc)
    cur = first(tl[:, s_p - 1])[:, None]                                  # [1, 1]
    buf = np.zeros((max_new_tokens + gamma + 1,), np.int64)
    buf[0] = int(cur[0, 0])
    count, pos, rounds, acc_total = 1, s_p, 1, 0
    while count < max_new_tokens and not (eos_token is not None and buf[count - 1] == eos_token):
        tok, props, qxs, dlogits = cur, [], [], []
        for j in range(gamma + 1):
            logits, _ = draft.decode_step(tok, pos + j, dc)
            nxt, qx = propose(logits)
            props.append(nxt)
            qxs.append(qx)
            dlogits.append(logits)
            tok = nxt[:, None]
        d = torch.stack(props[:gamma], dim=1)                             # [1, gamma]
        tlogits, _ = target.prefill_chunk(torch.cat([cur, d], dim=1), pos, tc)
        qx = None if qxs[0] is None else torch.stack(qxs[:gamma], dim=1)
        cand, produced, _, _ = accept(tlogits, d, qx, torch.stack(dlogits[:gamma], dim=1))
        host = torch.cat([cand[0], produced]).cpu().numpy()               # the round's read
        cand, n = host[:-1], int(host[-1])
        if eos_token is not None:
            # truncate the block at its first EOS: the loop stops on it
            hits = np.flatnonzero(cand[:n] == eos_token)
            n = int(hits[0]) + 1 if hits.size else n
        buf[count:count + gamma + 1] = cand
        count, pos, rounds = count + n, pos + n, rounds + 1
        acc_total += int(host[-1]) - 1
        cur = torch.tensor([[int(cand[n - 1])]], device=prompt.device)
    if eos_token is not None:
        # pin everything from the first EOS on (generate's padded contract)
        buf[count:] = eos_token
    return SpecResult(tokens=torch.from_numpy(buf[:max_new_tokens]), rounds=rounds,
                      drafted=(rounds - 1) * gamma, accepted=acc_total)


def speculative_generate(target, draft, prompt: torch.Tensor, max_new_tokens: int,
                         gamma: int = 4, quantized_cache: bool = False,
                         eos_token: Optional[int] = None) -> SpecResult:
    """Greedy speculative decoding, batch 1. prompt [1, S_p] int.

    Gives the target's greedy transcript (acceptance compares the draft's
    greedy choices with the target's; a disagreement truncates to the
    target's token) in ``rounds`` target forwards. In float32 it equals
    ``generate``'s; in bf16 the verify chunk and single-step decode may
    round a near-tie apart."""
    argmax = lambda lg: lg.to(torch.float32).argmax(dim=-1)
    return _speculate(target, draft, prompt, max_new_tokens, gamma, quantized_cache,
                      eos_token, argmax, lambda lg: (argmax(lg), None),
                      lambda tl, d, qx, dl: spec_accept_greedy(tl, d))


def speculative_sample(target, draft, prompt: torch.Tensor,
                       generator: Optional[torch.Generator], max_new_tokens: int,
                       gamma: int = 4, temperature=1.0, top_k=0, top_p=1.0,
                       quantized_cache: bool = False,
                       eos_token: Optional[int] = None) -> SpecResult:
    """Stochastic speculative decoding (Leviathan rejection sampling),
    batch 1, with the engine's temperature / top-k / top-p semantics; the
    tokens are distributed as sequential warped-target sampling. The draft
    proposes from its unfiltered temperature distribution (no sort); the
    target's warped distribution holds the filters, so a proposal outside
    the nucleus is rejected. Random numbers come from ``generator`` (JAX
    takes a key). A temperature <= 1e-6 gives ``speculative_generate``'s
    transcript."""
    def first(logits):
        p0 = warped_probs(logits, temperature, top_k, top_p)
        return torch.multinomial(p0, 1, generator=generator)[:, 0]

    return _speculate(
        target, draft, prompt, max_new_tokens, gamma, quantized_cache, eos_token, first,
        lambda lg: sample_logits_with_prob(lg, generator, temperature),
        lambda tl, d, qx, dl: spec_accept(tl, d, qx, dl, temperature, top_p, top_k,
                                          generator, gamma))
