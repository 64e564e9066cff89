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

