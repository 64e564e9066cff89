"""Linear layers (port of ``qgemm_tpu/models/linear.py`` without tensor
parallelism).

``Linear`` is y = x W + b with W [in, out]. ``QuantizedLinear`` holds
weights quantized offline: int8 with per-column absmax scales (stored
K-major for kernel K1), or with ``bits=4`` int4 with per-(128-row group,
column) scales (packed K-major for kernel K4). Its forward quantizes the
activations per call and runs K1 or K4 on CUDA tensors (their plain
versions on CPU tensors). A ``Linear``'s weight and bias are trainable
parameters; a ``QuantizedLinear`` holds its codes and scales as buffers and
its bias frozen (the quantized product has no gradient).
``outlier_threshold > 0`` adds the LLM.int8()
outlier split: activation dims above the threshold (up to
``outlier_capacity`` of them) bypass the quantized product and multiply
the dequantized weight rows in bf16 (f32 on the CPU).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from qgemm_tpu_torch.ops.quantize import (QuantizedWeight, QuantizedWeight4,
                                          quantize_weights, quantize_weights_int4,
                                          quantized_matmul_prequant,
                                          quantized_matmul_prequant_outlier,
                                          quantized_matmul_prequant_w4)
from qgemm_tpu_torch.utils.prng import uniform_init


def _trainable(t: Optional[torch.Tensor]) -> Optional[nn.Parameter]:
    return None if t is None else nn.Parameter(t)


def _frozen(t: Optional[torch.Tensor]) -> Optional[nn.Parameter]:
    return None if t is None else nn.Parameter(t, requires_grad=False)


def check_quantize_options(outlier_threshold: float = 0.0,
                           outlier_capacity: int = 32, bits: int = 8) -> None:
    """Weights are int8 or int4: any other width raises."""
    if bits not in (4, 8):
        raise ValueError(f"quantize(bits={bits}): bits must be 8 or 4")


class Linear(nn.Module):
    def __init__(self, w: torch.Tensor, b: Optional[torch.Tensor] = None):
        super().__init__()
        self.w = _trainable(w)    # [in_dim, out_dim]
        self.b = _trainable(b)    # [out_dim] or None

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
        """``bits=4``: W4A8 weights; ``outlier_threshold > 0``: the outlier
        split at inference. The two compose."""
        check_quantize_options(outlier_threshold, outlier_capacity, bits)
        wq = quantize_weights_int4(self.w.data) if bits == 4 \
            else quantize_weights(self.w.data)
        return QuantizedLinear(wq, None if self.b is None else self.b.data,
                               outlier_threshold=outlier_threshold,
                               outlier_capacity=outlier_capacity)


class QuantizedLinear(nn.Module):
    def __init__(self, wq, b: Optional[torch.Tensor] = None,
                 outlier_threshold: float = 0.0, outlier_capacity: int = 32):
        """``wq`` is a ``QuantizedWeight`` (int8) or a ``QuantizedWeight4``."""
        super().__init__()
        self.bits = 4 if isinstance(wq, QuantizedWeight4) else 8
        if self.bits == 4:
            self.register_buffer("qpt", wq.qpt)   # int8 [out, kp/2], packed K-major
        else:
            self.register_buffer("qt", wq.qt)     # int8 [out, in], K-major
        self.register_buffer("c", wq.c)   # f32 [1, out] or [kp/128, out]
        self.b = _frozen(b)
        self.out_features = wq.c.shape[1]
        self.outlier_threshold = outlier_threshold
        self.outlier_capacity = outlier_capacity

    @property
    def wq(self):
        if self.bits == 4:
            return QuantizedWeight4(qpt=self.qpt, c=self.c)
        return QuantizedWeight(qt=self.qt, c=self.c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        if self.outlier_threshold > 0:
            y = quantized_matmul_prequant_outlier(x2, self.wq, self.outlier_threshold,
                                                  self.outlier_capacity)
        elif self.bits == 4:
            y = quantized_matmul_prequant_w4(x2, self.wq)
        else:
            y = quantized_matmul_prequant(x2, self.wq)
        y = y.to(x.dtype).reshape(*shape[:-1], self.out_features)
        if self.b is not None:
            y = y + self.b
        return y
