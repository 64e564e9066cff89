"""Sequence parallelism: ring attention over a ``seq`` mesh axis (port of
``qgemm_tpu/parallel/ring_attention.py``).

Q, K and V are sharded on S: each rank holds [B, H, S/p, D] and keeps its
Q shard; the K/V shards travel the ring one hop a step (``ppermute``: rank
r sends to r + 1), so after j hops rank r holds the block that started at
(r - j) mod p. Each visiting block runs kernel K3 (``flash_attention_fwd``,
which returns the block's logsumexp) on CUDA and its plain version on the
CPU, and the blocks merge in f32 by logsumexp; the S x S scores exist
nowhere. Causal masking takes the block's regime from its origin: the
rank's own block is the causal diagonal, an earlier one fully visible, a
later one contributes nothing and launches nothing.

The backward is a second ring pass (JAX's ``_ring_local_bwd``): for each
visiting block kernel K7 (``flash_attention_bwd``) runs against the saved
GLOBAL output and logsumexp, so each block's dQ, dK, dV are exactly its
share of the global softmax's gradients; dQ accumulates at home, and the
dK/dV accumulators (f32) travel with their blocks and are home after p
hops.

The block loops (``ring_forward_blocks``, ``ring_backward_blocks``) take
the rotation as an argument and run over "lanes", the shards this process
holds: over a process group a rank holds one lane and the rotation is a
``ppermute``; a check can hold all p shards of one sequence on one device
and rotate the list. ``ring_attention`` is JAX's API on the rank's shards;
``shard_sequence`` cuts the rank's shard from a whole sequence, and raises
where S does not divide the axis (JAX's ring raises on the global S).
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from qgemm_tpu_torch.ops.cuda.flash_attention import flash_attention_fwd
from qgemm_tpu_torch.ops.cuda.flash_attention_bwd import flash_attention_bwd
from qgemm_tpu_torch.parallel.collectives import ring_shift_
from qgemm_tpu_torch.parallel.mesh import axis_rank, axis_size

_NEG_INF = -1e30
VISIBLE, DIAGONAL, FUTURE = 0, 1, 2

# lanes -> lanes: each lane's tensors moved one hop along the ring (lane i
# receives the tensors of the rank before it)
Rotation = Callable[[List[tuple]], List[tuple]]


def _regime(src: int, me: int) -> int:
    """The causal regime of the block that started at ring position ``src``
    for the queries of position ``me``."""
    return DIAGONAL if src == me else (VISIBLE if src < me else FUTURE)


def _block_fwd(q, k, v, causal: bool):
    """One visiting block: K3 on CUDA (its plain version on the CPU) ->
    (out [B, H, Sq, Dv] in q's dtype, lse f32 [B, H, Sq])."""
    return flash_attention_fwd(q, k, v, causal)


def _block_bwd(q, k, v, out, lse, g, causal: bool):
    """One visiting block's gradients against the global ``out`` and
    ``lse``: K7 on CUDA (its plain version on the CPU)."""
    return flash_attention_bwd(q, k, v, out, lse, g, causal)


def ring_forward_blocks(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                        vs: Sequence[torch.Tensor], positions: Sequence[int], n: int,
                        causal: bool, rotate: Rotation):
    """The forward ring (JAX's ``_ring_fwd_scan``) over the lanes this
    process holds: lane i's shards ``qs[i]``, ``ks[i]``, ``vs[i]`` [B, H,
    S/n, D] at ring position ``positions[i]``. -> (outs, lses): each lane's
    output [B, H, S/n, Dv] in q's dtype and global logsumexp f32 [B, H,
    S/n]. ``rotate`` moves every lane's (k, v) one hop; it runs n - 1
    times."""
    kv = [(k, v) for k, v in zip(ks, vs)]
    state = []
    for q, v in zip(qs, vs):
        b, h, sl, dv = q.shape[0], q.shape[1], q.shape[2], v.shape[-1]
        state.append([torch.full((b, h, sl), _NEG_INF, dtype=torch.float32, device=q.device),
                      torch.zeros((b, h, sl, 1), dtype=torch.float32, device=q.device),
                      torch.zeros((b, h, sl, dv), dtype=torch.float32, device=q.device)])
    for j in range(n):
        for i, (q, me) in enumerate(zip(qs, positions)):
            regime = _regime((me - j) % n, me) if causal else VISIBLE
            if regime == FUTURE:
                continue
            out_j, lse_j = _block_fwd(q, kv[i][0], kv[i][1], regime == DIAGONAL)
            m, l, acc = state[i]
            m_new = torch.maximum(m, lse_j)
            alpha = torch.exp(m - m_new)[..., None]
            w = torch.exp(lse_j - m_new)[..., None]
            state[i] = [m_new, l * alpha + w, acc * alpha + out_j.to(torch.float32) * w]
        if j < n - 1:
            kv = rotate(kv)
    outs, lses = [], []
    for q, (m, l, acc) in zip(qs, state):
        l = torch.clamp_min(l, 1e-30)
        outs.append((acc / l).to(q.dtype))
        lses.append(m + torch.log(l[..., 0]))
    return outs, lses


def ring_backward_blocks(qs, ks, vs, outs, lses, gs, positions: Sequence[int], n: int,
                         causal: bool, rotate: Rotation):
    """The backward ring (JAX's ``_ring_local_bwd``) over the lanes, from
    the forward's global ``outs`` and ``lses`` and the output gradients
    ``gs``. -> (dqs, dks, dvs) in the dtypes of q, k, v. ``rotate`` moves
    every lane's (k, v, dk, dv) one hop n - 1 times, then (dk, dv) once
    more, home."""
    f32 = torch.float32
    carry = [(k, v, torch.zeros(k.shape, dtype=f32, device=k.device),
              torch.zeros(v.shape, dtype=f32, device=v.device)) for k, v in zip(ks, vs)]
    dqs = [torch.zeros(q.shape, dtype=f32, device=q.device) for q in qs]
    for j in range(n):
        nxt = []
        for i, me in enumerate(positions):
            k, v, dk, dv = carry[i]
            regime = _regime((me - j) % n, me) if causal else VISIBLE
            if regime != FUTURE:
                dq_j, dk_j, dv_j = _block_bwd(qs[i], k, v, outs[i], lses[i], gs[i],
                                              regime == DIAGONAL)
                dqs[i] = dqs[i] + dq_j.to(f32)
                dk, dv = dk + dk_j.to(f32), dv + dv_j.to(f32)
            nxt.append((k, v, dk, dv) if j < n - 1 else (dk, dv))
        carry = rotate(nxt)
    dks = [c[-2].to(k.dtype) for c, k in zip(carry, ks)]
    dvs = [c[-1].to(v.dtype) for c, v in zip(carry, vs)]
    return [dq.to(q.dtype) for dq, q in zip(dqs, qs)], dks, dvs


def _group_rotation(mesh, axis: str) -> Rotation:
    """The ring over the axis's ranks: this process's one lane's tensors
    sent to the next rank, the previous rank's received."""
    return lambda lanes: [ring_shift_(lanes[0], mesh, axis, 1)]


def local_rotation(lanes: List[tuple]) -> List[tuple]:
    """The ring over lanes held by one process: lane i takes lane i - 1's."""
    return lanes[-1:] + lanes[:-1]


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal):
        n, r = axis_size(mesh, axis), axis_rank(mesh, axis)
        rot = _group_rotation(mesh, axis)
        (out,), (lse,) = ring_forward_blocks([q], [k], [v], [r], n, causal, rot)
        ctx.args = (mesh, axis, causal, n, r)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        mesh, axis, causal, n, r = ctx.args
        q, k, v, out, lse = ctx.saved_tensors
        (dq,), (dk,), (dv,) = ring_backward_blocks(
            [q], [k], [v], [out], [lse], [g.contiguous()], [r], n, causal,
            _group_rotation(mesh, axis))
        return dq, dk, dv, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, mesh,
                   axis: str = "seq", causal: bool = False) -> torch.Tensor:
    """Sequence-sharded attention: q, k, v are this rank's shards [B, H,
    S/p, D] of a sequence cut in p equal blocks in rank order
    (``shard_sequence``); returns the rank's shard [B, H, S/p, Dv] of the
    output. Differentiable (the blockwise ring backward)."""
    if not (q.shape[2] == k.shape[2] == v.shape[2]):
        raise ValueError(f"ring_attention: q, k, v shards of {q.shape[2]}, {k.shape[2]}, "
                         f"{v.shape[2]} positions; the ring needs equal shards")
    return _RingAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), mesh, axis,
                                causal)


def shard_sequence(x: torch.Tensor, mesh, axis: str = "seq", dim: int = 2) -> torch.Tensor:
    """This rank's block of ``x``'s sequence dimension (block r of p, r the
    rank's coordinate on ``axis``). A length that does not divide the axis
    raises ``ValueError``."""
    n, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    s = x.shape[dim]
    if s % n:
        raise ValueError(f"seq len {s} not divisible by {n} '{axis}' devices")
    return x.narrow(dim, r * (s // n), s // n).contiguous()
