"""Transformer building blocks shared by the model families (``LayerNorm``
and ``FeedForward`` of ``qgemm_tpu/models/transformer.py``)."""

from __future__ import annotations

import torch
from torch import nn

from qgemm_tpu_torch.models.linear import Linear
from qgemm_tpu_torch.ops.layernorm import layernorm


class LayerNorm(nn.Module):
    def __init__(self, gamma: torch.Tensor, beta: torch.Tensor):
        super().__init__()
        self.gamma = nn.Parameter(gamma, requires_grad=False)
        self.beta = nn.Parameter(beta, requires_grad=False)

    @classmethod
    def init(cls, d: int, dtype: torch.dtype = torch.float32, device=None) -> "LayerNorm":
        return cls(torch.ones((d,), dtype=dtype, device=device),
                   torch.zeros((d,), dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.gamma, self.beta)


class FeedForward(nn.Module):
    """Linear(d, d_ff) + ReLU + Linear(d_ff, d)."""

    def __init__(self, up: nn.Module, down: nn.Module):
        super().__init__()
        self.up = up
        self.down = down

    @classmethod
    def init(cls, generator: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype = torch.float32) -> "FeedForward":
        return cls(Linear.init(generator, d_model, d_ff, dtype=dtype),
                   Linear.init(generator, d_ff, d_model, dtype=dtype))

    def quantize(self, **qkw) -> "FeedForward":
        return FeedForward(self.up.quantize(**qkw), self.down.quantize(**qkw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(torch.relu(self.up(x)))
