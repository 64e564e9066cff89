"""Numeric comparison harness (port of ``qgemm_tpu/utils/testing.py``) and
the shared setup of the port's CPU tests, among them ``run_world``, which
runs a function in a world of processes over a process group (the
tensor-parallel tests run gloo on the CPU)."""

from __future__ import annotations

import gc
import os
import time
import uuid
from datetime import timedelta

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


def _f64(x) -> np.ndarray:
    return np.asarray(to_numpy(x), dtype=np.float64)


def allclose(a, b, rtol: float = DEFAULT_RTOL, atol: float = DEFAULT_ATOL) -> bool:
    """|a - b| <= atol + rtol * |b| everywhere, in float64; False when the
    shapes differ."""
    a, b = _f64(a), _f64(b)
    if a.shape != b.shape:
        return False
    return bool(np.all(np.abs(a - b) <= atol + rtol * np.abs(b)))


def assert_allclose(a, b, rtol: float = DEFAULT_RTOL, atol: float = DEFAULT_ATOL,
                    msg: str = ""):
    """|a - b| <= atol + rtol * |b| elementwise, reporting the worst entry."""
    a, b = _f64(a), _f64(b)
    assert a.shape == b.shape, f"shape mismatch {a.shape} vs {b.shape} {msg}"
    err = np.abs(a - b) - (atol + rtol * np.abs(b))
    if np.any(err > 0):
        worst = np.unravel_index(np.argmax(err), err.shape)
        raise AssertionError(
            f"allclose failed {msg}: worst at {worst}: a={a[worst]!r} b={b[worst]!r} "
            f"(max |a-b|={np.max(np.abs(a - b)):.3e}, rtol={rtol}, atol={atol})")


def mean_abs_error(a, b) -> float:
    """Mean |a - b| in float64, the quantization error the JAX package
    reports."""
    return float(np.mean(np.abs(_f64(a) - _f64(b))))


def rel_fro_error(a, b) -> float:
    """||a - b||_F / ||b||_F in float64 (the denominator floored at 1e-30)."""
    a, b = _f64(a), _f64(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def activation_values(x, slab: int = 0) -> np.ndarray:
    """The int8 activation codes' values before rounding, x * (127 / c), in
    float32, on each row's absmax grid ``c`` (floored at 1e-12) over K
    slabs of ``slab`` columns (0: the whole row), as the quantized matmuls
    compute them."""
    x = np.asarray(to_numpy(x), np.float32)
    slab = slab or x.shape[1]
    out = np.empty_like(x)
    for s0 in range(0, x.shape[1], slab):
        xs = x[:, s0:s0 + slab]
        c = np.maximum(np.abs(xs).max(axis=1, keepdims=True), np.float32(1e-12))
        out[:, s0:s0 + slab] = xs * (np.float32(127) / c)
    return out


def activation_code_ties(port, ref, seq: int, eps: float) -> tuple:
    """Two packages' activation codes, layer by layer: ``port[layer][part]``
    and ``ref[layer][part]`` are the values before rounding
    (``activation_values``) of one quantized layer's input, [rows, K'], in
    call order (parts: the ranks' shards, or one). Every code of a row
    that no earlier differing code reaches must be equal (round half to
    even, as torch and jnp round), or both values must lie within ``eps``
    of a rounding boundary k + 1/2: a tie, which the two packages may break
    apart from last-bit differences in their inputs. Rows are sequence-
    major (row = b * seq + t); a differing code at (b, t) reaches every
    later layer's rows (b, t') for t' >= t, since attention carries it
    forward. Returns (the rows reached, the ties: (layer, part, row,
    column, port value, ref value)); raises AssertionError on a differing
    code that is no tie."""
    rows = port[0][0].shape[0]
    reached = np.zeros(rows, bool)
    ties = []
    tie = lambda v: np.abs(v - np.floor(v) - 0.5) < eps
    for li, (pl, rl) in enumerate(zip(port, ref)):
        new = np.zeros(rows, bool)
        for part, (a, b) in enumerate(zip(pl, rl)):
            differ = (np.round(a) != np.round(b)) & ~reached[:, None]
            bad = differ & ~(tie(a) & tie(b))
            if bad.any():
                i, k = np.argwhere(bad)[0]
                raise AssertionError(f"layer {li} part {part}: {int(bad.sum())} codes differ "
                                     f"and are not at a rounding tie, e.g. row {i} column "
                                     f"{k}: {a[i, k]!r} against {b[i, k]!r}")
            for i, k in np.argwhere(differ):
                ties.append((li, part, int(i), int(k), float(a[i, k]), float(b[i, k])))
                new[i] = True
        for i in np.flatnonzero(new):
            b0, t = divmod(int(i), seq)
            reached[b0 * seq + t:(b0 + 1) * seq] = True
    return reached, ties


def _world_child(rank: int, fn, world: int, store: str, device, args) -> None:
    import torch.distributed as dist

    from qgemm_tpu_torch.parallel.mesh import initialize_distributed
    use_test_threads()
    initialize_distributed(init_method=f"file://{store}", world_size=world, rank=rank,
                           device=device, timeout=timedelta(seconds=180))
    try:
        fn(rank, world, *args)
    finally:
        gc.collect()   # objects in reference cycles may hold the group's work
        dist.destroy_process_group()


def run_world(fn, world: int, workdir: str, *args, device="cpu",
              timeout: float = 300.0) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes, each
    with one intra-op thread and a default process group over a file store
    in ``workdir`` (``device`` "cpu": gloo; None or "cuda": NCCL, one card
    per rank). ``fn`` must be importable by the children (a module-level
    function of a module that imports no JAX); it passes its results back
    through files. Raises if any process fails or the world outlives
    ``timeout`` seconds (the others are then killed)."""
    import torch.multiprocessing as mp
    store = os.path.join(os.path.abspath(workdir), f"store-{uuid.uuid4().hex}")
    ctx = mp.start_processes(_world_child, args=(fn, world, store, device, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"run_world({fn.__name__}, {world}) ran past {timeout} s")
