"""Expert parallelism: the MoE experts sharded over a mesh axis (port of
``qgemm_tpu/parallel/expert.py``).

The stacked [E, ...] expert tensors of ``models/moe.MoEFeedForward`` are
cut on E: rank r of the axis holds experts r E/p .. (r + 1) E/p
(``shard_moe``), the router whole. Two formulations, as in JAX:

  * ``ep_moe_forward`` (dense dispatch): every rank routes the same
    (replicated) tokens, dispatches those sent to its experts, runs its
    E/p experts (kernel K8 when int8) and combines their outputs into a
    partial [T, d]; one SUM over the axis completes it. JAX slices one-hot
    [T, E, C] dispatch and combine tensors; the port reuses the layer's
    index dispatch (``models/moe.dispatch``/``combine``) with the slots of
    the other ranks' experts sent to the dropped row, which computes the
    same function and, over one rank, is the un-sharded layer bit for bit;
  * ``ep_moe_forward_a2a``: the tokens are sharded — each rank routes its
    T/p tokens with a capacity of its own (JAX's per-source capacity),
    dispatches them into [E, C, d], one ``all_to_all`` sends every
    expert's slots to the rank holding it ([E/p, p C, d]), the rank runs
    its experts, and the reverse ``all_to_all`` brings the outputs home for
    a local combine.

Both are differentiable: the tokens and the router enter the dense form
through Megatron's f (the ranks' partial gradients summed in the
backward), its partial leaves through g; the a2a form's exchanges are
the differentiable ``all_to_all`` (the router through f: each rank routes
other tokens). In SPMD a rank passes its own tensors: the replicated
[..., d] tokens to the dense form, its [T/p, d] tokens to the a2a form.
"""

from __future__ import annotations

from typing import Tuple

import torch

from qgemm_tpu_torch.models.moe import (MoEFeedForward, QuantizedExpertWeight, _capacity,
                                        combine, dispatch, route_slots, run_experts)
from qgemm_tpu_torch.parallel import collectives as cl
from qgemm_tpu_torch.parallel.mesh import axis_rank, axis_size


def _expert_offset(r: int, n_local: int) -> int:
    """The first global expert of rank r's block."""
    return r * n_local


def _rank_experts(moe: MoEFeedForward, mesh, axis: str) -> Tuple[int, int, tuple]:
    """(first global expert, experts, (w_up, w_down)) of this rank: the
    layer's own weights where it is a rank's layer (``shard_moe``), else
    its block of a whole layer (a differentiable slice: the whole layer's
    gradients then hold this rank's block, the other ranks' zero)."""
    p, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    if moe.n_experts % p:
        raise ValueError(f"{moe.n_experts} experts do not divide the {p} ranks of {axis!r}")
    n = moe.n_experts // p
    lo = _expert_offset(r, n)
    weights = moe.expert_weights()
    if moe.tp_mode == "expert":
        if moe.n_local_experts != n or moe.tp_axis != axis:
            raise ValueError(f"the layer holds {moe.n_local_experts} of {moe.n_experts} "
                             f"experts over {moe.tp_axis!r}, not 1/{p} over {axis!r}")
        return lo, n, weights
    if moe.is_quantized:
        weights = tuple(QuantizedExpertWeight(w.qt.narrow(0, lo, n), w.c.narrow(0, lo, n))
                        for w in weights)
    else:
        weights = tuple(w.narrow(0, lo, n) for w in weights)
    return lo, n, weights


def ep_moe_forward(x: torch.Tensor, moe: MoEFeedForward, mesh,
                   axis: str = "expert") -> torch.Tensor:
    """``moe`` with its experts sharded over ``axis``: x [..., d], the same
    on every rank -> [..., d] in x's dtype, the same on every rank. ``moe``
    is a rank's layer (``shard_moe``) or the whole one (the rank's experts
    are sliced from it); float or int8 experts; E must divide the axis.
    The capacity follows the T tokens of the call, as the whole layer's."""
    lo, n, (w_up, w_down) = _rank_experts(moe, mesh, axis)
    shape = x.shape
    xf = cl.copy_to_axis(x.reshape(-1, shape[-1]).to(torch.float32), mesh, axis)
    cap = _capacity(xf.shape[0], moe.n_experts, moe.top_k, moe.capacity_factor)
    slot, gates = route_slots(xf, cl.copy_to_axis(moe.router_w, mesh, axis), moe.top_k, cap)
    # this rank's experts' slots, from 0; every other slot is dropped here
    n_loc = n * cap
    loc = slot - lo * cap
    loc = torch.where((loc >= 0) & (loc < n_loc), loc, torch.full_like(loc, n_loc))
    expert_in = dispatch(xf, loc, moe.top_k, n, cap)
    partial = combine(run_experts(expert_in, w_up, w_down), loc, gates, moe.top_k)
    return cl.reduce_over_axis(partial, mesh, axis).reshape(shape).to(x.dtype)


def ep_moe_forward_a2a(x: torch.Tensor, moe: MoEFeedForward, mesh,
                       axis: str = "expert") -> torch.Tensor:
    """The all-to-all formulation: x [T/p, d(, ...)], this rank's tokens
    (every rank the same count) -> [T/p, d] in x's dtype. Routing state and
    traffic are O(T/p) a rank; no SUM. Where capacity binds, choices drop
    per source rank (a capacity from T/p tokens), the standard EP
    behaviour and JAX's."""
    _, _, (w_up, w_down) = _rank_experts(moe, mesh, axis)
    shape = x.shape
    xf = x.reshape(-1, shape[-1]).to(torch.float32)
    e = moe.n_experts
    cap = _capacity(xf.shape[0], e, moe.top_k, moe.capacity_factor)
    slot, gates = route_slots(xf, cl.copy_to_axis(moe.router_w, mesh, axis), moe.top_k, cap)
    expert_in = dispatch(xf, slot, moe.top_k, e, cap)                    # [E, C, d]
    # split E into p blocks (block j -> rank j), join the blocks received
    # along capacity: [E/p, p C, d], this rank's experts' slots from every
    # source
    gathered = cl.all_to_all(expert_in, 0, 1, mesh, axis)
    out = run_experts(gathered, w_up, w_down).to(torch.float32)
    # back home: split capacity per source, join the experts -> [E, C, d]
    returned = cl.all_to_all(out, 1, 0, mesh, axis)
    return combine(returned, slot, gates, moe.top_k).reshape(shape).to(x.dtype)


def shard_moe(moe: MoEFeedForward, mesh, axis: str = "expert") -> MoEFeedForward:
    """This rank's layer: its block of E/p experts (float parameters, or
    int8 codes and scales), the router whole, marked to run
    ``ep_moe_forward`` on ``mesh`` (``tp_mode`` "expert"). Float experts
    become new trainable parameters (at p = 1 they share the layer's
    storage). E must divide the axis."""
    if moe.tp_mode != "none":
        raise ValueError("the layer is expert-sharded already")
    _, _, (w_up, w_down) = _rank_experts(moe, mesh, axis)
    if moe.is_quantized:
        w_up, w_down = (QuantizedExpertWeight(w.qt.contiguous(), w.c.contiguous())
                        for w in (w_up, w_down))
    else:
        w_up, w_down = (w.detach().contiguous() for w in (w_up, w_down))
    out = MoEFeedForward(moe.router_w.detach(), w_up, w_down, top_k=moe.top_k,
                         capacity_factor=moe.capacity_factor)
    out.tp_mode, out.tp_axis, out.mesh = "expert", axis, mesh
    return out
