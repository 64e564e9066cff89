"""LLM.int8()-style absmax vector-wise int8 quantization (int8 parts of
``qgemm_tpu/ops/quantize.py``).

Pipeline: per-row absmax of activations Cx, per-column absmax of weights
Cw, scales 127/C, round half to even (``torch.round``, like ``jnp.round``;
``rounding="truncate"`` keeps the reference's truncating cast), exact int8
products summed in int32, and out = acc * (Cx Cw) / 127^2.

On CUDA tensors the serving matmul runs kernel K1
(``ops/cuda/quantized_matmul.py``); on CPU tensors its plain version.
int4 weights (W4A8) and the outlier split are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from qgemm_tpu_torch.ops.cuda import quantized_matmul as _k1
from qgemm_tpu_torch.ops.validation import (check, check_dtype, check_float,
                                            check_matmul_2d)

QRANGE = 127.0
_EPS = 1e-12  # guards all-zero rows/cols (scale would be inf)


def absmax_scales(x: torch.Tensor, axis: int) -> torch.Tensor:
    """max|x| along ``axis`` with keepdim — the Cx / Cw statistic."""
    return torch.clamp_min(x.abs().amax(dim=axis, keepdim=True), _EPS)


def absmax_quantize(x: torch.Tensor, axis: int, rounding: str = "nearest",
                    qrange: float = QRANGE):
    """Quantize to int8 along ``axis`` (rows of activations: axis=-1;
    columns of weights: axis=0), computing in x's dtype as the JAX version
    does. Returns (q int8, c absmax float32)."""
    c = absmax_scales(x, axis)
    # a true division: torch evaluates `float / tensor` as float * (1 / c),
    # which rounds differently from JAX's qrange / c. full_like keeps the
    # numerator on the device: a host scalar copied in would sync the stream
    scaled = x * (torch.full_like(c, qrange) / c)
    if rounding == "nearest":
        q = torch.clamp(torch.round(scaled), -qrange, qrange).to(torch.int8)
    elif rounding == "truncate":  # reference bit-parity
        q = torch.trunc(scaled).to(torch.int8)
    else:
        raise ValueError(f"unknown rounding {rounding!r}")
    return q, c.to(torch.float32)


def dequantize(acc_i32: torch.Tensor, cx: torch.Tensor, cw: torch.Tensor,
               qrange: float = QRANGE) -> torch.Tensor:
    """out = acc * (Cx outer Cw) / R^2."""
    return acc_i32.to(torch.float32) * (cx * cw) * (1.0 / (qrange * qrange))


class QuantizedWeight(NamedTuple):
    """Offline-quantized weight. Stored K-major (``qt`` [n, k], the layout
    kernel K1 reads with 16-byte vectors along K); ``q`` is the JAX
    package's [k, n] view of the same bytes."""
    qt: torch.Tensor  # int8 [n, k]
    c: torch.Tensor   # float32 [1, n] per-column absmax

    @property
    def q(self) -> torch.Tensor:
        return self.qt.t()

    @classmethod
    def from_kn(cls, q: torch.Tensor, c: torch.Tensor) -> "QuantizedWeight":
        """From JAX's [k, n] int8 codes and [1, n] scales."""
        return cls(qt=q.t().contiguous(), c=c.to(torch.float32).reshape(1, -1))


def quantize_weights(w: torch.Tensor, rounding: str = "nearest") -> QuantizedWeight:
    """w [k, n] -> per-column int8 codes and absmax (JAX ``quantize_weights``)."""
    q, c = absmax_quantize(w, axis=0, rounding=rounding)
    return QuantizedWeight.from_kn(q, c)


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 [m, k] x int8 [k, n] -> exact int32. ``int8 @ int8`` in torch
    returns int8 and wraps, so the CPU sums in int32; torch has no int32
    matmul on CUDA, so there it sums in float64, exact while k * 127^2 < 2^53."""
    if xq.is_cuda:
        return torch.matmul(xq.to(torch.float64), wq.to(torch.float64)).to(torch.int32)
    return torch.matmul(xq.to(torch.int32), wq.to(torch.int32))


def quantized_matmul_plain(x: torch.Tensor, wq: QuantizedWeight,
                           rounding: str = "nearest") -> torch.Tensor:
    """Plain PyTorch version of kernel K1: x is upcast to f32 (as the TPU
    kernel does), row-quantized, multiplied exactly and dequantized.
    x [m, k] float -> f32 [m, n]."""
    xq, cx = absmax_quantize(x.to(torch.float32), axis=-1, rounding=rounding)
    return dequantize(int8_matmul(xq, wq.q), cx, wq.c)


def quantized_matmul_prequant(x: torch.Tensor, wq: QuantizedWeight,
                              rounding: str = "nearest") -> torch.Tensor:
    """Serving path: weights already int8, activations quantized per call.
    x [m, k] float -> f32 [m, n]. CPU tensors run the plain version; CUDA
    tensors launch K1 (x f32 or bf16, k a multiple of 16) or raise."""
    check_matmul_2d(x, wq.q, "x", "wq.q")
    check_float("x", x)
    check_dtype("wq.q", wq.qt, torch.int8)
    check(tuple(wq.c.shape) == (1, wq.qt.shape[0]),
          f"wq.c: expected per-column scales (1, {wq.qt.shape[0]}), "
          f"got {tuple(wq.c.shape)}")
    check(rounding in _k1.ROUNDING, f"unknown rounding {rounding!r}")
    if not x.is_cuda:
        return quantized_matmul_plain(x, wq, rounding)
    check(x.dtype in _k1.X_DTYPES, f"x: K1 takes float32 or bfloat16, got {x.dtype}")
    check(x.shape[1] % 16 == 0, f"K1 needs k % 16 == 0, got k={x.shape[1]}")
    return _k1.quantized_matmul_cuda(x, wq.qt, wq.c, rounding)


def quantized_matmul(x: torch.Tensor, w: torch.Tensor,
                     rounding: str = "nearest") -> torch.Tensor:
    """Dynamic quantized matmul: quantizes BOTH operands on the fly. W is
    column-quantized in torch (in f32, as the JAX Pallas path does), then
    K1 runs as on the serving path. x [m, k], w [k, n] float."""
    check_matmul_2d(x, w)
    check_float("x", x)
    check_float("w", w)
    return quantized_matmul_prequant(
        x, quantize_weights(w.to(torch.float32), rounding=rounding),
        rounding=rounding)
