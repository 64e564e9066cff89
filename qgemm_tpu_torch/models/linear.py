"""Linear layers (port of ``qgemm_tpu/models/linear.py`` without tensor
parallelism, outliers or int4).

``Linear`` is y = x W + b with W [in, out]. ``QuantizedLinear`` holds int8
weights quantized offline with per-column absmax scales, stored K-major
for kernel K1; its forward quantizes the activations per call and runs
K1 on CUDA tensors (its plain version on CPU tensors).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from qgemm_tpu_torch.ops.quantize import (QuantizedWeight, quantize_weights,
                                          quantized_matmul_prequant)
from qgemm_tpu_torch.utils.prng import uniform_init


def _frozen(t: Optional[torch.Tensor]) -> Optional[nn.Parameter]:
    return None if t is None else nn.Parameter(t, requires_grad=False)


def check_quantize_options(outlier_threshold: float = 0.0,
                           outlier_capacity: int = 32, bits: int = 8) -> None:
    """The int8 path is the only one ported: the others raise."""
    if bits != 8:
        raise NotImplementedError(f"quantize(bits={bits}): only bits=8 is ported")
    if outlier_threshold > 0:
        raise NotImplementedError(
            f"quantize(outlier_threshold={outlier_threshold}): the outlier "
            "split is not ported")


class Linear(nn.Module):
    def __init__(self, w: torch.Tensor, b: Optional[torch.Tensor] = None):
        super().__init__()
        self.w = _frozen(w)    # [in_dim, out_dim]
        self.b = _frozen(b)    # [out_dim] or None

    @classmethod
    def init(cls, generator: torch.Generator, in_dim: int, out_dim: int,
             bias: bool = True, dtype: torch.dtype = torch.float32) -> "Linear":
        """Kaiming-uniform ±1/sqrt(in_dim)."""
        bound = 1.0 / (in_dim ** 0.5)
        w = uniform_init(generator, (in_dim, out_dim), bound, dtype)
        b = uniform_init(generator, (out_dim,), bound, dtype) if bias else None
        return cls(w, b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.w.to(x.dtype))
        if self.b is not None:
            y = y + self.b
        return y

    def quantize(self, outlier_threshold: float = 0.0, outlier_capacity: int = 32,
                 bits: int = 8) -> "QuantizedLinear":
        check_quantize_options(outlier_threshold, outlier_capacity, bits)
        return QuantizedLinear(quantize_weights(self.w.data),
                               None if self.b is None else self.b.data)


class QuantizedLinear(nn.Module):
    def __init__(self, wq: QuantizedWeight, b: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("qt", wq.qt)   # int8 [out, in], K-major
        self.register_buffer("c", wq.c)     # f32 [1, out]
        self.b = _frozen(b)
        self.out_features, self.in_features = wq.qt.shape

    @property
    def wq(self) -> QuantizedWeight:
        return QuantizedWeight(qt=self.qt, c=self.c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        y = quantized_matmul_prequant(x.reshape(-1, shape[-1]), self.wq).to(x.dtype)
        y = y.reshape(*shape[:-1], self.out_features)
        if self.b is not None:
            y = y + self.b
        return y
