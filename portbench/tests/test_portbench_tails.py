"""The end-to-end tails are taken over every request of the window: a
stall planted in one stretch of the window moves the 95th percentile,
where the median of per-chunk percentiles would not move."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import readers
from portbench.bench import Rec, RunRecord
from portbench.readers import p_high


def _run(ttfts, t0=0.0):
    recs = []
    for i, v in enumerate(ttfts):
        r = Rec(prompt=[1], max_new=4, shared=0, sent=t0 + 0.01 * i)
        r.first, r.finish, r.seen = r.sent + v, r.sent + v + 0.3, 4
        recs.append(r)
    return RunRecord(cell=None, setup_s=1.0, t0=t0 - 1, t1=t0 + 100, recs=recs, steps=[],
                     counters={}, admit_s=[])


def test_planted_stall_moves_p95_but_not_a_median_of_chunks():
    calm = [0.05] * 200
    stalled = calm[:100] + [2.0] * 15 + calm[100:]
    p_calm, p_stall = readers.ttft_p95_ms(_run(calm)), readers.ttft_p95_ms(_run(stalled))
    assert p_calm == pytest.approx(50.0) and p_stall == pytest.approx(2000.0)
    chunks = [stalled[i:i + 15] for i in range(0, len(stalled), 15)]
    assert float(np.median([p_high(c, 95) for c in chunks])) * 1e3 == pytest.approx(50.0)


def test_failed_request_counts_as_never():
    run = _run([0.05] * 10)
    for r in run.recs[:1]:
        r.error = "boom"
    assert readers.ttft_p95_ms(run) == float("inf")


def test_tpot_over_finished_requests():
    run = _run([0.05] * 20)
    assert abs(readers.tpot_p95_ms(run) - 100.0) < 1e-9
