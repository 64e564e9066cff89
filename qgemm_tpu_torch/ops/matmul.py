"""Matmul wrapper (port of ``qgemm_tpu/ops/matmul.py``): a @ b over a's
last and b's first axis with an explicit accumulation dtype. JAX leaves
this product to XLA outside any Pallas kernel; here it is torch's."""

from __future__ import annotations

import torch


def matmul(a: torch.Tensor, b: torch.Tensor,
           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """a [..., k] @ b [k, ...] summed in ``out_dtype``. Integer operands
    (int8 codes) sum exactly: in int64 on the CPU, where torch's
    ``int8 @ int8`` would wrap; in float64 on the card, which has no
    integer matmul (exact while k * max|a| * max|b| < 2^53)."""
    dims = ([a.ndim - 1], [0])
    if not (a.is_floating_point() and b.is_floating_point()):
        wide = torch.float64 if a.is_cuda else torch.int64
        return torch.tensordot(a.to(wide), b.to(wide), dims=dims).to(out_dtype)
    return torch.tensordot(a.to(out_dtype), b.to(out_dtype), dims=dims)


def matmul_flops(m: int, n: int, k: int) -> int:
    return 2 * m * n * k
