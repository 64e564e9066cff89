"""Numeric comparison harness (port of ``qgemm_tpu/utils/testing.py``) and
the shared setup of the port's CPU tests."""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_RTOL = 1e-6
DEFAULT_ATOL = 1e-6


def use_test_threads() -> None:
    """One intra-op thread per test process: the suite runs several pytest
    workers on a few cores."""
    torch.set_num_threads(1)


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu")
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.numpy()
    return np.asarray(x)


def assert_allclose(a, b, rtol: float = DEFAULT_RTOL, atol: float = DEFAULT_ATOL,
                    msg: str = ""):
    """|a - b| <= atol + rtol * |b| elementwise, reporting the worst entry."""
    a = np.asarray(to_numpy(a), dtype=np.float64)
    b = np.asarray(to_numpy(b), dtype=np.float64)
    assert a.shape == b.shape, f"shape mismatch {a.shape} vs {b.shape} {msg}"
    err = np.abs(a - b) - (atol + rtol * np.abs(b))
    if np.any(err > 0):
        worst = np.unravel_index(np.argmax(err), err.shape)
        raise AssertionError(
            f"allclose failed {msg}: worst at {worst}: a={a[worst]!r} b={b[worst]!r} "
            f"(max |a-b|={np.max(np.abs(a - b)):.3e}, rtol={rtol}, atol={atol})")
