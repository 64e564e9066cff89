"""Kernel timing on the card with CUDA events (the port's counterpart of
``qgemm_tpu/utils/profiling.py``'s ``bench_ms``)."""

from __future__ import annotations

import statistics
import time
from typing import Callable

import torch

# more than twice the H100's 50 MB L2, so one read of it evicts every line
_L2_FLUSH_FLOATS = 32 << 20
# cycles per second of the device-side sleep, at or above the H100's top
# clock, so a sleep of n cycles lasts at least n / _SLEEP_HZ seconds
_SLEEP_HZ = 2.0e9


def bench_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 3,
             flush_l2: bool = True, queue_ahead: bool = True) -> float:
    """Median device milliseconds of one ``fn()`` call over ``iters`` calls,
    after ``warmup`` untimed ones.

    The timed calls are queued behind a device-side sleep long enough for
    the host to enqueue all of them, so the device runs them back to back
    and the host's part of a call (checks, allocation, the ctypes call,
    PyTorch's dispatch) overlaps the device's work instead of adding to
    it. Each call is bracketed by its own pair of CUDA events. With
    ``flush_l2`` the L2 cache is evicted before every call by reading a
    buffer of more than twice its size, outside the call's events, so
    weights are read from device memory as a serving step reads them.
    Raises without a GPU (a CPU time is never reported as a device time)
    and if the host could not queue the calls before the sleep ended.

    ``queue_ahead=False`` is for a function that launches more kernels
    than the device's launch queue holds (a plain version that loops over
    groups in Python): no sleep, so each call's events also take in the
    time the device waits for the host to launch the call's kernels.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("bench_ms times on a CUDA device; none is available")
    scratch = torch.zeros(_L2_FLUSH_FLOATS, dtype=torch.float32, device="cuda") \
        if flush_l2 else None

    def enqueue():
        pairs = []
        for _ in range(iters):
            if scratch is not None:
                # a read, not a write: written lines would stay dirty and be
                # written back to HBM inside the timed call
                scratch.sum()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        return pairs

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if not queue_ahead:
        pairs = enqueue()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)
    t = time.perf_counter()
    enqueue()                   # the host's time to enqueue every call
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t
    for _ in range(4):
        torch.cuda._sleep(int((2 * host_s + 2e-3) * _SLEEP_HZ))
        awake = torch.cuda.Event()
        awake.record()
        pairs = enqueue()
        queued_ahead = not awake.query()
        torch.cuda.synchronize()
        if queued_ahead:
            return statistics.median(s.elapsed_time(e) for s, e in pairs)
        host_s *= 2
    raise RuntimeError("bench_ms: the host could not queue the timed calls ahead "
                       "of the device (does fn synchronize?)")
