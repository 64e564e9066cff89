"""Softmax cross-entropy with the analytic gradient (port of
``qgemm_tpu/ops/cross_entropy.py``).

``cross_entropy_loss`` is a ``torch.autograd.Function`` (JAX's
``custom_vjp``): the forward is the mean NLL over the batch from
max-shifted logits, and the backward is d_logits = (softmax - onehot) *
g / batch, computed in the logits' dtype, with no recompute through the
softmax's graph.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from qgemm_tpu_torch.ops.softmax import softmax


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    m = logits.amax(dim=-1, keepdim=True)
    shifted = logits - m
    lse = torch.log(torch.exp(shifted).sum(dim=-1))
    picked = shifted.gather(-1, targets[:, None].long())[:, 0]
    return (lse - picked).mean()


def _d_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """softmax - onehot, in the logits' dtype."""
    onehot = F.one_hot(targets.long(), logits.shape[-1]).to(logits.dtype)
    return softmax(logits, axis=-1) - onehot


class _CrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets):
        ctx.save_for_backward(logits, targets)
        return _nll(logits, targets)

    @staticmethod
    def backward(ctx, g):
        logits, targets = ctx.saved_tensors
        return _d_logits(logits, targets) * (g / logits.shape[0]), None


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean NLL over the batch. logits [B, C] float, targets [B] int."""
    return _CrossEntropy.apply(logits, targets)


def cross_entropy_loss_and_grad(logits: torch.Tensor, targets: torch.Tensor):
    """(loss, d_logits = (softmax - onehot) / batch): the reference op's
    dual return, without autograd."""
    with torch.no_grad():
        return _nll(logits, targets), _d_logits(logits, targets) / logits.shape[0]
