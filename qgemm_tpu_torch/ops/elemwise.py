"""Elementwise op family (port of ``qgemm_tpu/ops/elemwise.py``): one name
per op of the reference's elementwise library, plain PyTorch. Broadcasting
is torch's, a superset of the reference's rule (the second operand
broadcast along its size-1 dims), as jnp's is.

Float-to-int8 casts agree with the JAX package on values within
[-128, 127]. Outside that range the two differ on purpose: XLA saturates a
float-to-int8 conversion, torch wraps it (and C leaves it undefined), so
``cast_int8_truncate`` of 300.0 is not 127 here. ``round_int8`` clips to
±127 first and is the same in both.
"""

from __future__ import annotations

import torch


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def relu_back(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dx = dy * (x > 0)."""
    return torch.where(x > 0, dy, torch.zeros_like(dy))


def sgd_update(w, dw, lr):
    """w - lr * dw."""
    return w - lr * dw


def add(a, b):
    return a + b


def subtract(a, b):
    return a - b


def multiply(a, b):
    return a * b


def exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x)


def log(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x)


def inv_divide(x: torch.Tensor, c) -> torch.Tensor:
    """c / x (scale = 127 / absmax) as a true division: torch evaluates
    ``float / tensor`` as float * (1 / x), which rounds differently."""
    if not isinstance(c, torch.Tensor):
        c = torch.full_like(x, c)
    return c / x


def equal(a, b) -> torch.Tensor:
    """Elementwise equality as float32 0/1."""
    return torch.eq(a, b).to(torch.float32)


def cast_int8_truncate(x: torch.Tensor) -> torch.Tensor:
    """Truncating float -> int8 cast (the reference's quantization
    rounding); in range only, see the module note."""
    return torch.trunc(x).to(torch.int8)


def round_int8(x: torch.Tensor) -> torch.Tensor:
    """Round half to even, clipped to ±127, as int8."""
    return torch.clamp(torch.round(x), -127, 127).to(torch.int8)


def dequantize(acc_i32: torch.Tensor, scale) -> torch.Tensor:
    """acc * scale in float32, the scale broadcast against acc."""
    return acc_i32.to(torch.float32) * scale


def outlier_mask(x: torch.Tensor, threshold: float) -> torch.Tensor:
    """|x| > threshold elementwise (the outlier split's selection is
    ``ops/quantize.py::quantized_matmul_outlier``)."""
    return torch.abs(x) > threshold


def const_init(shape, value, dtype: torch.dtype = torch.float32,
               device="cuda") -> torch.Tensor:
    """A tensor of ``shape`` filled with ``value``, on the card unless the
    caller names another device."""
    return torch.full(tuple(shape), value, dtype=dtype, device=device)
