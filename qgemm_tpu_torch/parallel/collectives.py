"""Autograd-aware collectives (the differentiable half of
``qgemm_tpu/parallel``'s ``psum``, ``all_gather``, ``ppermute`` and
``all_to_all``).

JAX differentiates straight through its collectives: the transpose of a
``psum`` of replicated cotangents is the identity, of ``ppermute`` the
inverse permutation, of a tiled ``all_to_all`` the inverse exchange. Here
each is a ``torch.autograd.Function`` over the mesh axis's group, so a
rank's ``loss.backward()`` runs the matching collective of the backward:

  * ``copy_to_axis`` — Megatron's *f*: the identity forward, a SUM of the
    gradient over the axis in the backward (a replicated input of a
    sharded computation: each rank holds a partial gradient);
  * ``reduce_over_axis`` — Megatron's *g*: a SUM forward (the ranks'
    partial products), the identity backward (the sum is replicated, and
    so is its gradient);
  * ``gather_last`` — an all-gather of the last dimension whose backward
    takes the rank's own block of the (replicated) gradient;
  * ``ring_shift`` — ``ppermute`` by ``shift`` along the axis (rank r sends
    to r + shift), its backward the shift the other way;
  * ``all_to_all`` — JAX's tiled ``all_to_all(split_axis, concat_axis)``,
    its backward the inverse exchange.

Every collective that runs, forward or backward, is counted by kind and
payload bytes in ``tp_ops``'s counter (``all_reduce_sum``,
``all_gather``, ``ppermute``, ``all_to_all``). Under ``no_grad`` (the
serving path) the forwards run without building a graph; the SUM then
reduces its input in place. A ring shift over one rank is the identity
and runs no collective.

The ranks must run the same collectives in the same order, backward
included: the graphs of SPMD ranks have one shape, so the autograd engine
visits their collective nodes alike. A schedule whose ranks differ in
shape (the pipeline's) runs its own backward (``parallel/pipeline.py``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from qgemm_tpu_torch.parallel import tp_ops
from qgemm_tpu_torch.parallel.mesh import axis_rank, axis_size


def _needs_graph(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


# ---------------------------------------------------------------------------
# Megatron's f and g
# ---------------------------------------------------------------------------

class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return tp_ops.all_reduce_sum_(g.contiguous().clone(), ctx.mesh, ctx.axis), None, None


def copy_to_axis(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """Megatron's f: ``x`` itself; in the backward the gradient is summed
    over ``axis`` (every rank's partial gradient of a replicated input)."""
    if not _needs_graph(x):
        return x
    return _CopyToAxis.apply(x, mesh, axis)


class _ReduceOverAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return tp_ops.all_reduce_sum_(x.contiguous().clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def reduce_over_axis(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """Megatron's g: the SUM of ``x`` over ``axis``; the identity in the
    backward. Without a graph to build, ``x`` is reduced in place."""
    if not _needs_graph(x):
        return tp_ops.all_reduce_sum_(x if x.is_contiguous() else x.contiguous(), mesh, axis)
    return _ReduceOverAxis.apply(x, mesh, axis)


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis, ctx.n = mesh, axis, x.shape[-1]
        return tp_ops.all_gather_last(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        r = axis_rank(ctx.mesh, ctx.axis)
        return g.narrow(-1, r * ctx.n, ctx.n).contiguous(), None, None


def gather_last(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """[..., n] on each rank -> [..., p n] (rank r's block at r n); the
    backward takes the rank's block of the gradient."""
    if not _needs_graph(x):
        return tp_ops.all_gather_last(x, mesh, axis)
    return _GatherLast.apply(x, mesh, axis)


# ---------------------------------------------------------------------------
# ppermute
# ---------------------------------------------------------------------------

def ring_shift_(tensors: Sequence[torch.Tensor], mesh, axis: str,
                shift: int = 1) -> Tuple[torch.Tensor, ...]:
    """No autograd: each tensor moved ``shift`` ranks along the axis (rank r
    receives rank r - shift's), all in one batch of point-to-point
    operations. Over one rank: the tensors themselves."""
    p = axis_size(mesh, axis)
    if p == 1 or shift % p == 0:
        return tuple(tensors)
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    r = axis_rank(mesh, axis)
    dst, src = ranks[(r + shift) % p], ranks[(r - shift) % p]
    ops, outs = [], []
    with torch.no_grad():
        for t in tensors:
            t = t.contiguous()
            out = torch.empty_like(t)
            tp_ops.count_collective("ppermute", t)
            ops += [dist.P2POp(dist.isend, t, dst, group),
                    dist.P2POp(dist.irecv, out, src, group)]
            outs.append(out)
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return tuple(outs)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, shift, *tensors):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return ring_shift_(tensors, mesh, axis, shift)

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros_like(g) if g is None else g for g in grads]
        return (None, None, None) + ring_shift_(grads, ctx.mesh, ctx.axis, -ctx.shift)


def ring_shift(tensors: Sequence[torch.Tensor], mesh, axis: str,
               shift: int = 1) -> Tuple[torch.Tensor, ...]:
    """JAX's ``ppermute`` with the permutation r -> r + shift along the
    axis, of several tensors at once; differentiable (the backward shifts
    the gradients by -shift)."""
    if not _needs_graph(*tensors):
        return ring_shift_(tensors, mesh, axis, shift)
    out = _RingShift.apply(mesh, axis, shift, *tensors)
    return out if isinstance(out, tuple) else (out,)


# ---------------------------------------------------------------------------
# all_to_all
# ---------------------------------------------------------------------------

def all_to_all_(x: torch.Tensor, split_dim: int, concat_dim: int, mesh,
                axis: str) -> torch.Tensor:
    """No autograd: JAX's tiled ``all_to_all``. ``x``'s ``split_dim`` is cut
    into p blocks, block j sent to rank j; the blocks received are joined
    along ``concat_dim`` in source order. One ``all_to_all_single`` on a
    contiguous [p, ...] permutation of ``x``."""
    p = axis_size(mesh, axis)
    nd = x.dim()
    split_dim, concat_dim = split_dim % nd, concat_dim % nd
    if x.shape[split_dim] % p:
        raise ValueError(f"all_to_all: dimension {split_dim} ({x.shape[split_dim]}) does not "
                         f"divide the {p} ranks of {axis!r}")
    moved = x.movedim(split_dim, 0)
    blocks = moved.reshape(p, moved.shape[0] // p, *moved.shape[1:]).contiguous()
    recv = torch.empty_like(blocks)
    tp_ops.count_collective("all_to_all", blocks)
    with torch.no_grad():
        dist.all_to_all_single(recv, blocks, group=mesh.get_group(axis))
    # [src, (split block), others...] -> x's layout with the block at
    # split_dim, then the source index merged in front of concat_dim
    y = recv.movedim(1, 1 + split_dim).movedim(0, concat_dim)
    shape = list(y.shape)
    shape[concat_dim:concat_dim + 2] = [shape[concat_dim] * shape[concat_dim + 1]]
    return y.reshape(shape)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, mesh, axis):
        ctx.args = (split_dim, concat_dim, mesh, axis)
        return all_to_all_(x, split_dim, concat_dim, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim, mesh, axis = ctx.args
        return all_to_all_(g, concat_dim, split_dim, mesh, axis), None, None, None, None


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, mesh,
               axis: str) -> torch.Tensor:
    """JAX's tiled ``all_to_all(x, axis, split_axis, concat_axis)``,
    differentiable (the backward exchanges back: split ``concat_dim``,
    join ``split_dim``)."""
    if not _needs_graph(x):
        return all_to_all_(x, split_dim, concat_dim, mesh, axis)
    return _AllToAll.apply(x, split_dim, concat_dim, mesh, axis)
