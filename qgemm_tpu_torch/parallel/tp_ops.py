"""Explicit-collective tensor-parallel quantized matmuls (port of
``qgemm_tpu/parallel/tp_ops.py``).

JAX runs the fused int8 kernels inside ``shard_map`` with explicit
collectives; here every rank runs the same program on its own shards and
the collectives are ``torch.distributed`` calls on the mesh's ``"model"``
group. Two Megatron layouts:

  * ``column``: the weight is sharded on N — each rank computes the full
    [M, K] activation against its [K, N/p] shard (kernel K1 or K4); the
    output stays [M, N/p] or is all-gathered along N;
  * ``row``: the weight is sharded on K and the activation arrives as its
    [M, K/p] slice — each rank computes an f32 partial [M, N] and ONE
    all-reduce SUM adds them, in f32, before any cast.

Row-parallel int8 quantizes every K shard on the GLOBAL row grid: the
local row absmax [M, 1] is all-reduced (MAX), floored at 1e-12, and K1
runs on those caller-given scales (``quantized_matmul_prequant(cx=...)``).
W4A8 needs no global grid: K4 quantizes each K slab on its own scale and
dequantizes with it, so the partials are exact contributions whatever the
split; its row mode needs the true K equal to the packed extent.

Every collective is counted by kind and payload bytes in a per-process
counter (``collective_counts``); a replayed decode graph adds the
collectives its capture recorded (``serving/decode_graph.py``), as it does
kernel launches.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from qgemm_tpu_torch.ops.quantize import (_EPS, QRANGE, QuantizedWeight, QuantizedWeight4,
                                          _outlier_dot, _take_rows_w4,
                                          quantized_matmul_prequant,
                                          quantized_matmul_prequant_outlier,
                                          quantized_matmul_prequant_w4)
from qgemm_tpu_torch.parallel.mesh import axis_rank, axis_size

_KINDS = ("all_reduce_max", "all_reduce_sum", "all_gather", "all_to_all", "ppermute")
_COUNTS: Dict[str, int] = {}


def reset_collective_counts() -> None:
    for kind in _KINDS:
        _COUNTS[kind] = 0
        _COUNTS[kind + "_bytes"] = 0


def collective_counts() -> Dict[str, int]:
    """Collectives this process ran since the last reset, by kind
    (``all_reduce_max``, ``all_reduce_sum``, ``all_gather``, and the
    differentiable ``all_to_all`` and ``ppermute`` of
    ``parallel/collectives.py``), and the bytes of each kind's payload
    (``<kind>_bytes``: the input tensor's size)."""
    return dict(_COUNTS)


def add_collective_counts(delta: Dict[str, int]) -> None:
    for k, v in delta.items():
        _COUNTS[k] += v


reset_collective_counts()


def count_collective(kind: str, t: torch.Tensor) -> None:
    """Count one collective of ``kind`` whose payload is ``t``."""
    _COUNTS[kind] += 1
    _COUNTS[kind + "_bytes"] += t.numel() * t.element_size()


def all_reduce_max_(t: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """In place: the elementwise max of ``t`` over the axis."""
    count_collective("all_reduce_max", t)
    with torch.no_grad():   # the quantized products carry no gradient
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.get_group(axis))
    return t


def all_reduce_sum_(t: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """In place: the sum of ``t`` over the axis."""
    count_collective("all_reduce_sum", t)
    with torch.no_grad():
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return t


def all_gather_last(t: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """[..., n] on each rank -> [..., p * n], rank r's block at columns
    r * n .. (r + 1) * n."""
    p = axis_size(mesh, axis)
    lead, n = t.shape[:-1], t.shape[-1]
    src = t.reshape(-1, n).contiguous()
    count_collective("all_gather", src)
    out = torch.empty((p * src.shape[0], n), dtype=t.dtype, device=t.device)
    with torch.no_grad():
        dist.all_gather_into_tensor(out, src, group=mesh.get_group(axis))
    return out.reshape(p, src.shape[0], n).permute(1, 0, 2).reshape(*lead, p * n)


def global_row_scales(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """x [M, K/p] -> the absmax of each whole row, f32 [M, 1], floored at
    1e-12: the local absmax, then one all-reduce MAX."""
    cx = x.to(torch.float32).abs().amax(dim=1, keepdim=True)
    return all_reduce_max_(cx, mesh, axis).clamp_min_(_EPS)


def reduce_partial(partial: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """Sum the ranks' f32 partial products (in place): the one SUM of a
    row-parallel layer."""
    return all_reduce_sum_(partial, mesh, axis)


def _int8(wq: torch.Tensor, cw: torch.Tensor) -> QuantizedWeight:
    """JAX's [k, n] codes (a view of a K-major buffer, or any tensor) as a
    ``QuantizedWeight``."""
    return QuantizedWeight(qt=wq.t().contiguous(), c=cw)


def _int4(qp: torch.Tensor, c: torch.Tensor) -> QuantizedWeight4:
    return QuantizedWeight4(qpt=qp.t().contiguous(), c=c)


def tp_quantized_matmul_column(x, wq, cw, mesh, axis: str = "model",
                               gather_output: bool = True) -> torch.Tensor:
    """x [M, K] (every rank the same); wq int8 [K, N/p] and cw [1, N/p],
    this rank's column shard -> f32 [M, N] gathered, or this rank's
    [M, N/p] with ``gather_output=False`` (to feed a row-parallel layer)."""
    out = quantized_matmul_prequant(x, _int8(wq, cw))
    return all_gather_last(out, mesh, axis) if gather_output else out


def tp_quantized_matmul_row(x, wq, cw, mesh, axis: str = "model") -> torch.Tensor:
    """x [M, K/p] (this rank's slice of the activation); wq int8 [K/p, N],
    this rank's row shard; cw [1, N] whole -> f32 [M, N], the same on every
    rank: K1 on the global row grid, one MAX and one SUM."""
    cx = global_row_scales(x, mesh, axis)
    return reduce_partial(quantized_matmul_prequant(x, _int8(wq, cw), cx=cx), mesh, axis)


def tp_w4a8_matmul_column(x, qp, c, mesh, axis: str = "model",
                          gather_output: bool = True) -> torch.Tensor:
    """W4A8 column parallelism: packed int4 [kp/2, N/p] and group scales
    [kp/128, N/p], this rank's column shard; K4 on it."""
    out = quantized_matmul_prequant_w4(x, _int4(qp, c))
    return all_gather_last(out, mesh, axis) if gather_output else out


def tp_w4a8_matmul_row(x, qp, c, mesh, axis: str = "model") -> torch.Tensor:
    """W4A8 row parallelism: x [M, K/p]; packed rows [K/(2p), N] and group
    scales [K/(128 p), N] (whole groups) of this rank; one SUM of the f32
    partials. The true K must equal the packed extent."""
    if x.shape[-1] != 2 * qp.shape[0]:
        raise ValueError(f"w4a8 row-TP needs the true K ({x.shape[-1]}) to equal the "
                         f"packed extent ({2 * qp.shape[0]}): pad K to a multiple of "
                         "group * p before sharding")
    return reduce_partial(quantized_matmul_prequant_w4(x, _int4(qp, c)), mesh, axis)


def _weight_rows(wq, idx: torch.Tensor) -> torch.Tensor:
    """The dequantized K-rows ``idx`` of a (local) quantized weight, f32
    [cap, n]."""
    if isinstance(wq, QuantizedWeight4):
        return _take_rows_w4(wq, idx)
    return wq.qt.index_select(1, idx).t().to(torch.float32) * wq.c * (1.0 / QRANGE)


def tp_outlier_matmul_column(x, wq, threshold: float, capacity: int, mesh,
                             axis: str = "model", gather_output: bool = True):
    """The LLM.int8() outlier split on a column shard: x is whole, so the
    split is the unsharded layer's; the output is gathered or kept."""
    out = quantized_matmul_prequant_outlier(x, wq, threshold, capacity)
    return all_gather_last(out, mesh, axis) if gather_output else out


def tp_outlier_matmul_row(x, wq, threshold: float, capacity: int, mesh,
                          axis: str = "model") -> torch.Tensor:
    """The outlier split on a row shard, equal to the unsharded layer's:
    the ranks' column maxima are all-gathered and every rank picks the
    same top-``capacity`` global dims; each zeroes the selected dims of its
    own slice, runs the inlier product on the global grid (one MAX), and
    adds the float product of its own outlier dims to its partial before
    the one SUM. x [M, K/p]; ``wq`` this rank's row shard."""
    kl = x.shape[-1]
    r = axis_rank(mesh, axis)
    col_absmax = all_gather_last(x.abs().amax(dim=0).to(torch.float32), mesh, axis)
    top_vals, top_idx = torch.topk(col_absmax, min(capacity, col_absmax.shape[0]))
    local = top_idx - r * kl
    mine = (top_vals > threshold) & (local >= 0) & (local < kl)
    local = local.clamp(0, kl - 1)
    # several unselected dims clamp onto one index: count the selected ones
    hits = torch.zeros((kl,), dtype=torch.int32, device=x.device)
    mask = hits.index_add_(0, local, mine.to(torch.int32)) > 0
    x_in = x.masked_fill(mask, 0)
    if isinstance(wq, QuantizedWeight4):
        if kl != 2 * wq.qpt.shape[1]:
            raise ValueError(f"w4a8 row-TP needs the true K shard ({kl}) to equal the "
                             f"packed extent ({2 * wq.qpt.shape[1]})")
        partial = quantized_matmul_prequant_w4(x_in, wq)
    else:
        partial = quantized_matmul_prequant(x_in, wq, cx=global_row_scales(x_in, mesh, axis))
    x_o = x.index_select(-1, local) * mine.to(x.dtype)
    partial = partial + _outlier_dot(x_o, _weight_rows(wq, local))
    return reduce_partial(partial, mesh, axis)
