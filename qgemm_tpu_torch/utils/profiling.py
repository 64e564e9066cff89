"""Timing and tracing (port of ``qgemm_tpu/utils/profiling.py``): kernel
timing on the card with CUDA events (``bench_ms``), the rate of a timed
call (``flops_per_sec``) and a trace of the work run inside a context
(``trace``)."""

from __future__ import annotations

import os
import statistics
import time
import uuid
from typing import Callable, Optional

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


def flops_per_sec(ms: float, flops: int) -> float:
    return flops / (ms * 1e-3)


class trace:
    """A torch.profiler trace of the work run inside the context, written
    as a Chrome trace file (JSON, which Perfetto and chrome://tracing open)
    under ``log_dir`` when the context exits, also when it exits by an
    exception; its path is then ``self.path``::

        with trace("profile") as t:
            engine.step()
        print(t.path)

    It records the host's activity always and the card's kernels (CUPTI)
    when the process has a card, and moves no work between devices. One
    profiler runs at a time in a process, as one ``jax.profiler`` trace
    does: entering while any torch profiler runs raises ``RuntimeError``.
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.path: Optional[str] = None
        self._prof = None

    def __enter__(self) -> "trace":
        from torch.profiler import ProfilerActivity, profile
        if torch.autograd._profiler_enabled():
            raise RuntimeError("trace: a torch profiler is already running in this process")
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self.log_dir, exist_ok=True)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        prof, self._prof = self._prof, None
        if torch.cuda.is_available():
            torch.cuda.synchronize()    # the kernels queued inside the context
        prof.__exit__(*exc)
        self.path = os.path.join(self.log_dir, f"trace-{uuid.uuid4().hex}.json")
        prof.export_chrome_trace(self.path)
        return False
