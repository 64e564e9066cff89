"""How the metric files (``metrics/<name>.py``) read a run
(``bench.RunRecord``). A reader that finds nothing to read returns None and
the metric is left out of the result line; a share of a roofline or a peak
is never made up as 0.

Tails are over every request of the window, by nearest rank from above:
time to first token over the requests whose first token came inside the
window (from submission in a closed loop, from the due time in an open
one), time per output token over those that finished inside it.
"""

from __future__ import annotations

from statistics import median
from typing import Optional, Sequence

import numpy as np

from portbench.yardstick import INT8_OPS

NEVER = float("inf")


def p_high(values, q: float) -> float:
    """The q-th percentile, by nearest rank from above (no interpolation)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q, method="higher"))


def _p95(values) -> Optional[float]:
    return p_high(values, 95) if values else None


def setup_s(run) -> float:
    return run.setup_s


def output_tokens_per_s(run) -> Optional[float]:
    steps = run.window_steps()
    return sum(s.tokens for s in steps) / run.window_s if steps else None


def ttft_p95_ms(run) -> Optional[float]:
    vals = [(NEVER if r.error else (r.first - r.sent) * 1e3) for r in run.recs
            if r.first is not None and run.t0 < r.first <= run.t1]
    vals += [NEVER for r in run.recs if r.error and r.first is None
             and r.finish is not None and run.t0 < r.finish <= run.t1]
    return _p95(vals)


def tpot_p95_ms(run) -> Optional[float]:
    vals = [(r.finish - r.first) / (r.seen - 1) * 1e3 for r in run.recs
            if r.finish is not None and run.t0 < r.finish <= run.t1 and not r.error
            and r.seen > 1]
    return _p95(vals)


def admission_ms_p50(run) -> Optional[float]:
    return median(run.admit_s) * 1e3 if run.admit_s else None


def mfu(run) -> Optional[float]:
    """Per cent of the int8 peak that the window's needed operations are,
    over the window's wall time."""
    ops = sum(s.work.ops for s in run.window_steps())
    return 100.0 * ops / (run.window_s * INT8_OPS) if ops else None


def _traced(run, patterns: Sequence[str], attr: str) -> Optional[float]:
    if run.trace is None:
        return None
    t = run.trace.family_s(patterns)
    need = sum(getattr(s.work, attr) for s in run.traced_steps())
    if t <= 0 or need <= 0:
        return None
    return 100.0 * need / t


def gemm_roofline(run, patterns: Sequence[str]) -> Optional[float]:
    """Per cent: the traced steps' linears' least time on K1's roofline over
    the device time of the kernels named by ``patterns``."""
    return _traced(run, patterns, "gemm_s")


def attention_roofline(run, patterns: Sequence[str]) -> Optional[float]:
    """Per cent: the traced steps' decode attention's least time over the
    device time of the kernels named by ``patterns``."""
    return _traced(run, patterns, "attn_s")


def idle_share(run) -> Optional[float]:
    """Per cent of the traced window in which no kernel ran."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
