"""Reduction op family (port of ``qgemm_tpu/ops/reduction.py``), plain
PyTorch, the axis explicit."""

from __future__ import annotations

import torch


def reduce_sum(x: torch.Tensor, axis: int, keepdims: bool = True) -> torch.Tensor:
    return torch.sum(x, dim=axis, keepdim=keepdims)


def reduce_max(x: torch.Tensor, axis: int, keepdims: bool = True) -> torch.Tensor:
    return torch.amax(x, dim=axis, keepdim=keepdims)


def argmax(x: torch.Tensor, axis: int, keepdims: bool = True) -> torch.Tensor:
    """Index of the maximum along ``axis``, the first one on ties (as
    ``jnp.argmax``); int64 where JAX returns int32."""
    return torch.argmax(x, dim=axis, keepdim=keepdims)


def absmax(x: torch.Tensor, axis: int, keepdims: bool = True) -> torch.Tensor:
    """max |x| along ``axis``: the quantization statistic, row-wise for
    activations and column-wise for weights."""
    return torch.amax(torch.abs(x), dim=axis, keepdim=keepdims)
