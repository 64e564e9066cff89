"""The device trace of a ``--trace 1`` run: torch.profiler with CUDA
activity over a sub-window of the measured window, reduced to the union of
the kernels' intervals, time by kernel name and the idle gaps.

``device_spans`` is ``chip_smoke.py``'s (the union of kernel intervals,
time by name), here over plain ``(start, end, name)`` tuples so that it
can be tested without a card. Timestamps are nanoseconds on the epoch
clock the profiler gives its events, which ``time.time_ns`` reads too, so
host spans recorded by the harness label the gaps between kernels.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


def device_spans(spans: Sequence[Tuple[float, float, str]]) -> Tuple[float, Dict[str, float]]:
    """(length of the union of the intervals, summed length by name)."""
    busy, end, by_name = 0.0, float("-inf"), {}
    for s, e, name in sorted(spans):
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    return busy, by_name


def idle_gaps(spans: Sequence[Tuple[float, float, str]], lo: float,
              hi: float) -> List[Tuple[float, float]]:
    """The intervals of [lo, hi] that no span covers."""
    gaps, at = [], lo
    for s, e, _ in sorted(spans):
        if s > at:
            gaps.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        gaps.append((at, hi))
    return [(a, b) for a, b in gaps if b > a]


@dataclass
class Trace:
    """A traced sub-window: its host bounds (ns, epoch clock), busy
    seconds, kernel seconds by name, and idle seconds by what the host was
    doing."""
    t0_ns: int
    t1_ns: int
    busy_s: float
    by_name: Dict[str, float]
    idle_by_host: Dict[str, float] = field(default_factory=dict)
    kernels: int = 0
    outside: int = 0

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def family_s(self, patterns: Sequence[str]) -> float:
        """Seconds of the kernels whose names hold one of ``patterns``."""
        return sum(s for n, s in self.by_name.items() if any(p in n for p in patterns))


class HostSpans:
    """What the host was doing, as labelled intervals on the epoch clock."""

    def __init__(self):
        self.starts: List[int] = []
        self.items: List[Tuple[int, int, str]] = []

    def add(self, start_ns: int, end_ns: int, label: str) -> None:
        self.starts.append(start_ns)
        self.items.append((start_ns, end_ns, label))

    def label(self, t_ns: float) -> str:
        i = bisect.bisect_right(self.starts, t_ns) - 1
        if i >= 0 and self.items[i][1] >= t_ns:
            return self.items[i][2]
        return "harness between steps"


class Recorder:
    """Start and stop the profiler around a sub-window and reduce it."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.t0_ns = self.t1_ns = 0

    def start(self) -> None:
        import torch
        self.prof.start()
        torch.cuda.synchronize()
        self.t0_ns = time.time_ns()

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self.prof.stop()

    def _kernel_spans(self) -> List[Tuple[float, float, str]]:
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        # the raw events: building the profiler's own event tree for the
        # ~100,000 kernels a second of a decode-heavy window takes longer
        return [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                for e in self.prof.profiler.kineto_results.events() if e.device_type() == cuda]

    def reduce(self, host: Optional[HostSpans]) -> Trace:
        spans = self._kernel_spans()
        if not spans:
            raise RuntimeError("the profiler recorded no device kernel in the traced window")
        lo, hi = self.t0_ns, self.t1_ns
        inside = [(max(s, lo), min(e, hi), n) for s, e, n in spans if e > lo and s < hi]
        busy, by_name = device_spans(inside)
        idle: Dict[str, float] = {}
        for a, b in idle_gaps(inside, lo, hi):
            key = host.label((a + b) / 2) if host is not None else "unlabelled"
            idle[key] = idle.get(key, 0.0) + (b - a) / 1e9
        return Trace(t0_ns=lo, t1_ns=hi, busy_s=busy / 1e9,
                     by_name={n: s / 1e9 for n, s in by_name.items()}, idle_by_host=idle,
                     kernels=len(inside), outside=len(spans) - len(inside))
