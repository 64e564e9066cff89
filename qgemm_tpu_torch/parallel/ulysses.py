"""Ulysses sequence parallelism: an all-to-all exchange of heads for
sequence (port of ``qgemm_tpu/parallel/ulysses.py``).

The activations arrive sequence-sharded, [B, H, S/p, D] on each rank; one
``all_to_all`` re-shards them to head-sharded [B, H/p, S, D], each rank
runs full-sequence attention for its head group, and a second
``all_to_all`` restores sequence sharding. Two collectives whatever p
(ring attention takes p - 1 hops), a single dense attention per rank.

The local attention is the models' full-sequence route
(``models/attention._dispatch_attention``): kernel K3, differentiable
through kernel K7, on CUDA at every length; the plain composition on the
CPU. JAX takes its flash kernel only off the CPU at S >= 128. Both
exchanges are the differentiable ``all_to_all``, so the whole is
differentiable.
"""

from __future__ import annotations

import torch

from qgemm_tpu_torch.models.attention import _dispatch_attention
from qgemm_tpu_torch.parallel.collectives import all_to_all
from qgemm_tpu_torch.parallel.mesh import axis_size


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, mesh,
                      axis: str = "seq", causal: bool = False) -> torch.Tensor:
    """q, k, v: this rank's shards [B, H, S/p, D] of a sequence cut in p
    equal blocks in rank order (``ring_attention.shard_sequence``); returns
    the rank's shard [B, H, S/p, Dv]. H must divide the axis (heads are
    exchanged for sequence)."""
    n = axis_size(mesh, axis)
    h = q.shape[1]
    if h % n:
        raise ValueError(f"n_heads {h} not divisible by {n} '{axis}' devices")
    # [B, H, S/p, D] -> [B, H/p, S, D]: heads split across ranks, the
    # sequence gathered
    a2a = lambda x: all_to_all(x, 1, 2, mesh, axis)
    out = _dispatch_attention(a2a(q), a2a(k), a2a(v), causal)
    # the inverse: [B, H/p, S, D] -> [B, H, S/p, D]
    return all_to_all(out, 2, 1, mesh, axis)
