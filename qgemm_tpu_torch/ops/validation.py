"""Argument validation for the public kernel wrappers (port of
``qgemm_tpu/ops/validation.py``): every wrapper checks shapes and dtypes
before a pointer reaches a kernel and raises a ``ValueError`` naming the
offending argument."""

from __future__ import annotations

import torch

_FLOATS = (torch.float32, torch.bfloat16, torch.float16, torch.float64)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_rank(name: str, x, rank: int) -> None:
    check(getattr(x, "ndim", None) == rank,
          f"{name}: expected a rank-{rank} array, got shape "
          f"{tuple(getattr(x, 'shape', ())) or type(x)}")


def check_float(name: str, x) -> None:
    check(x.dtype in _FLOATS, f"{name}: expected a float dtype, got {x.dtype}")


def check_dtype(name: str, x, dtype: torch.dtype) -> None:
    check(x.dtype == dtype, f"{name}: expected dtype {dtype}, got {x.dtype}")


def check_matmul_2d(x, w, xname: str = "x", wname: str = "w") -> None:
    check_rank(xname, x, 2)
    check_rank(wname, w, 2)
    check(x.shape[1] == w.shape[0],
          f"{xname} @ {wname}: inner dims differ — {xname} is "
          f"{tuple(x.shape)}, {wname} is {tuple(w.shape)}")


def check_attention_4d(q, k, v) -> None:
    for name, a in (("q", q), ("k", k), ("v", v)):
        check_rank(name, a, 4)
        check_float(name, a)
    check(q.shape[:2] == k.shape[:2] == v.shape[:2],
          f"q/k/v batch+head dims differ: {tuple(q.shape)}, "
          f"{tuple(k.shape)}, {tuple(v.shape)}")
    check(q.shape[3] == k.shape[3],
          f"q head_dim {q.shape[3]} != k head_dim {k.shape[3]}")
    check(k.shape[2] == v.shape[2],
          f"k length {k.shape[2]} != v length {v.shape[2]}")


def check_aligned16(name: str, *tensors: torch.Tensor) -> None:
    """Every tensor's data starts on a 16-byte boundary: the kernels copy
    rows with 16-byte ``cp.async``, which faults on anything less."""
    for t in tensors:
        check(t.data_ptr() % 16 == 0,
              f"{name}: tensor data at {t.data_ptr():#x} is not 16-byte aligned")


HEAD_DIMS = (32, 64, 128, 256, 512, 1024)   # the decode kernels' compiled head widths


def padded_head_dim(d: int) -> int:
    """The head width a decode kernel (K2, K5) is compiled for that holds
    ``d``: 32, 64, 128, 256, 512 or 1024 (they take any d up to 1,024;
    above it they raise). K3, K6 and K7 take their own widths."""
    check(1 <= d <= HEAD_DIMS[-1],
          f"the decode attention kernels take head_dim 1 to {HEAD_DIMS[-1]}, got {d}")
    return next(w for w in HEAD_DIMS if d <= w)


# CUDA's grid limits: x up to 2^31 - 1 blocks, y and z up to 65,535
MAX_GRID = (2 ** 31 - 1, 65535, 65535)


def check_grid(name: str, grid: tuple) -> tuple:
    """``grid`` (x[, y[, z]] blocks) within CUDA's limits, returned as it
    is; a kernel whose count can grow puts it on x."""
    check(1 <= len(grid) <= 3 and all(1 <= n <= m for n, m in zip(grid, MAX_GRID)),
          f"{name}: grid {tuple(grid)} is outside CUDA's limits {MAX_GRID}")
    return tuple(grid)


def pad_last(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` contiguous with its last axis zero-padded to ``width`` (no copy
    beyond ``contiguous`` when it already has that width): how the
    wrappers widen K for K1/K8 and head widths for the attention kernels,
    as the JAX wrappers pad before their kernels."""
    if t.shape[-1] != width:
        t = torch.nn.functional.pad(t, (0, width - t.shape[-1]))
    return t.contiguous()
