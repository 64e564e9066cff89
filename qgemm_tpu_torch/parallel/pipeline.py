"""Pipeline parallelism: the GPipe microbatch schedule over a ``pipe``
mesh axis (port of ``qgemm_tpu/parallel/pipeline.py``).

Homogeneous blocks are cut into ``n_stages`` stages of ``n_layers /
n_stages`` consecutive blocks, n_stages the size of the ``pipe`` axis; rank
s of the axis holds and runs stage s (``stack_stages``). ``pipeline_apply`` runs JAX's tick schedule: at tick t stage 0
injects microbatch t, every stage applies its blocks to its current
activation, and the activations move one stage forward (``ppermute``);
the last stage collects finished microbatches; ticks T = n_micro +
n_stages - 1, bubble share (n_stages - 1) / T. A masked SUM over the axis
replicates the outputs on every rank. A stage runs no blocks on a bubble
tick (JAX computes there and discards the result).

It is differentiable. JAX transposes its scan of ``ppermute``s; here the
schedule is one ``torch.autograd.Function`` whose backward runs the
ticks in reverse on every rank: each tick's gradient arrives from the
next stage by the inverse shift, runs back through the stage's blocks
(their parameters' ``.grad`` accumulate, as under ``loss.backward()``), and
the gradient of the tick's input goes to the stage before. Every rank
runs the same shifts in the same order, which autograd's own order does
not promise across ranks whose graphs differ in shape (the first stage
injects, the last collects). The input's gradient is the first stage's
(zero on the others): ``pipeline_gpt_forward`` passes the embedding
through Megatron's f, so every rank's embedding gradient is whole.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
from torch import nn

from qgemm_tpu_torch.parallel import collectives as cl
from qgemm_tpu_torch.parallel.mesh import axis_rank, axis_size


def stack_stages(blocks: Sequence[nn.Module], mesh, axis: str = "pipe") -> list:
    """This rank's stage: its ``n_layers / n_stages`` consecutive blocks,
    n_stages the size of ``axis``. A count that does not divide raises."""
    n, n_stages = len(blocks), axis_size(mesh, axis)
    if n % n_stages:
        raise ValueError(f"{n} layers not divisible by {n_stages} stages")
    per = n // n_stages
    r = axis_rank(mesh, axis)
    return list(blocks[r * per:(r + 1) * per])


def _collect_index(t: int, n_stages: int) -> int:
    """The microbatch the last stage finishes at tick t (negative: none)."""
    return t - (n_stages - 1)


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xm, stage_fn, mesh, axis, n_micro, grad, *params):
        # ``params``: the stage's trainable parameters, inputs only so that
        # the output needs a gradient when they do (they get theirs in the
        # backward's per-tick passes)
        n_stages, sid = axis_size(mesh, axis), axis_rank(mesh, axis)
        n_ticks = n_micro + n_stages - 1
        last = sid == n_stages - 1
        outs = torch.zeros_like(xm)
        buf = torch.zeros_like(xm[0])
        saved = []                          # per tick: (input leaf, output) or None
        for t in range(n_ticks):
            mb = t - sid                    # the microbatch this stage holds
            if 0 <= mb < n_micro:
                x_in = xm[t] if sid == 0 else buf
                if grad:
                    with torch.enable_grad():
                        x_in = x_in.detach().requires_grad_(True)
                        y = stage_fn(x_in)
                    saved.append((x_in, y))
                    y = y.detach()
                else:
                    y = stage_fn(x_in)
                    saved.append(None)
            else:
                y = torch.zeros_like(buf)
                saved.append(None)
            out_t = _collect_index(t, n_stages)
            if last and 0 <= out_t < n_micro:
                outs[out_t] = y
            if t < n_ticks - 1:
                (buf,) = cl.ring_shift_((y,), mesh, axis, 1)
        ctx.args = (mesh, axis, n_micro, saved, len(params))
        # the outputs live on the last stage: replicate by a masked SUM
        return cl.reduce_over_axis(outs if last else torch.zeros_like(outs), mesh, axis)

    @staticmethod
    def backward(ctx, g_outs):
        mesh, axis, n_micro, saved, n_params = ctx.args
        n_stages, sid = axis_size(mesh, axis), axis_rank(mesh, axis)
        n_ticks = n_micro + n_stages - 1
        last = sid == n_stages - 1
        g_xm = torch.zeros_like(g_outs)
        g_buf = None                        # the gradient of the buffer received at t + 1
        for t in reversed(range(n_ticks)):
            g_y = torch.zeros_like(g_outs[0])
            out_t = _collect_index(t, n_stages)
            if last and 0 <= out_t < n_micro:
                g_y = g_y + g_outs[out_t]
            if t < n_ticks - 1:
                (back,) = cl.ring_shift_((g_buf,), mesh, axis, -1)
                g_y = g_y + back
            g_in = torch.zeros_like(g_y)
            if saved[t] is not None and saved[t][1].requires_grad:
                x_in, y = saved[t]
                torch.autograd.backward(y, g_y.to(y.dtype))
                if x_in.grad is not None:
                    g_in = x_in.grad.to(g_in.dtype)
            if sid == 0:
                if 0 <= t < n_micro:
                    g_xm[t] = g_in
                g_buf = torch.zeros_like(g_in)
            else:
                g_buf = g_in
        ctx.args = None
        return (g_xm, None, None, None, None, None) + (None,) * n_params


def pipeline_apply(block_fn: Callable, stage_params, x: torch.Tensor, *, mesh,
                   axis: str = "pipe", n_microbatches: Optional[int] = None) -> torch.Tensor:
    """Run ``block_fn(block, x) -> x`` through every stage. ``stage_params``
    is this rank's blocks (``stack_stages``). x [B, ...] the same on every
    rank, B divisible by ``n_microbatches`` (default the stage count) ->
    [B, ...], the same on every rank. The stage's parameters get their
    gradients in ``.grad`` during the backward."""
    n_micro = n_microbatches or axis_size(mesh, axis)
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by {n_micro} microbatches")
    blocks: List = list(stage_params)

    def stage_fn(h):
        for blk in blocks:
            h = block_fn(blk, h)
        return h

    xm = x.reshape(n_micro, b // n_micro, *x.shape[1:])
    params = [p for blk in blocks for p in blk.parameters() if p.requires_grad]
    grad = torch.is_grad_enabled() and (x.requires_grad or bool(params))
    out = _GPipe.apply(xm, stage_fn, mesh, axis, n_micro, grad, *params)
    return out.reshape(b, *out.shape[2:])


def pipeline_gpt_forward(model, tokens: torch.Tensor, *, mesh, axis: str = "pipe",
                         n_microbatches: Optional[int] = None) -> torch.Tensor:
    """A GPT's forward with its blocks pipelined over ``axis``: the
    embedding and the head run replicated on every rank (a small share of
    the work), the blocks on the GPipe schedule; int8 blocks run their
    kernels stage by stage. tokens [B, S] -> logits [B, S, vocab]."""
    stage = stack_stages(model.blocks, mesh, axis)
    x = cl.copy_to_axis(model.embed(tokens), mesh, axis)
    x = pipeline_apply(lambda blk, h: blk(h), stage, x, mesh=mesh, axis=axis,
                       n_microbatches=n_microbatches)
    return model.lm_head(model.ln_f(x))
