"""LayerNorm (port of ``qgemm_tpu/ops/layernorm.py``):
(x - mean) * rsqrt(var + eps) * gamma + beta over one axis, the last by
default.

Over the last axis with per-feature (1-D) gamma and beta it runs as
``torch.nn.functional.layer_norm``, which reduces each row on its own: a
row's result does not depend on how many rows share the call, so a slot
decoded in a batch of 8 gets the same bits as the same sequence decoded
alone (the engine-vs-generate transcript check relies on that). Over
another axis, or with gamma and beta of another shape, it is the JAX
version's composition: mean and population variance kept as size-1 axes,
then gamma and beta broadcast against the result. The JAX version
computes in x's dtype; in float32 the two agree to rounding. Neither
reaches a kernel: the fused kernel of row 13 is ``layernorm_residual``'s
on the op layer (``ops/cuda/layernorm.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def layernorm(x: torch.Tensor, gamma: Optional[torch.Tensor] = None,
              beta: Optional[torch.Tensor] = None, eps: float = 1e-5,
              axis: int = -1) -> torch.Tensor:
    d = x.shape[axis]
    if axis in (-1, x.ndim - 1) and all(t is None or tuple(t.shape) == (d,)
                                        for t in (gamma, beta)):
        return F.layer_norm(x, (d,), gamma, beta, eps)
    mean = x.mean(dim=axis, keepdim=True)
    var = torch.square(x - mean).mean(dim=axis, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    if gamma is not None:
        y = y * gamma
    if beta is not None:
        y = y + beta
    return y


def layernorm_residual(x: torch.Tensor, residual: torch.Tensor, gamma=None,
                       beta=None, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm(x + residual) — the transformer block's add+norm."""
    return layernorm(x + residual, gamma=gamma, beta=beta, eps=eps)


def layernorm_reference_semantics(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """The reference kernel's own math, (x - mean) / var (population
    variance, no eps, no affine), for parity tests only."""
    mean = x.mean(dim=axis, keepdim=True)
    var = torch.square(x - mean).mean(dim=axis, keepdim=True)
    return (x - mean) / var
