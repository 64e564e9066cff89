"""Row-wise LayerNorm (port of ``qgemm_tpu/ops/layernorm.py``):
(x - mean) * rsqrt(var + eps) * gamma + beta over the last axis.

It runs as ``torch.nn.functional.layer_norm``, which reduces each row on
its own: a row's result does not depend on how many rows share the call,
so a slot decoded in a batch of 8 gets the same bits as the same sequence
decoded alone (the engine-vs-generate transcript check relies on that).
The JAX version computes in x's dtype; in float32 the two agree to
rounding.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def layernorm(x: torch.Tensor, gamma: Optional[torch.Tensor] = None,
              beta: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), gamma, beta, eps)


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
