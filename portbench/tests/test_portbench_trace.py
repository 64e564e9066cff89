"""The device trace's reduction: the union of overlapping kernel intervals,
time by kernel name, the idle gaps and their host labels."""

from __future__ import annotations

from portbench.trace import HostSpans, Trace, device_spans, idle_gaps


def test_union_of_overlapping_intervals():
    spans = [(0, 10, "a"), (5, 15, "b"), (20, 30, "a"), (22, 25, "c"), (40, 41, "b")]
    busy, by_name = device_spans(spans)
    assert busy == 15 + 10 + 1
    assert by_name == {"a": 20, "b": 11, "c": 3}


def test_idle_gaps_and_labels():
    spans = [(10, 20, "k"), (15, 30, "k"), (50, 60, "k")]
    assert idle_gaps(spans, 0, 100) == [(0, 10), (30, 50), (60, 100)]
    host = HostSpans()
    host.add(0, 35, "admission")
    host.add(35, 70, "decode")
    assert host.label(5) == "admission" and host.label(40) == "decode"
    assert host.label(80) == "harness between steps"


def test_family_time_by_name_patterns():
    t = Trace(t0_ns=0, t1_ns=2_000_000_000, busy_s=1.5,
              by_name={"void qmm_gemv_kernel<1>(x)": 0.5, "row_quantize_kernel": 0.25,
                       "dense_decode_split_kernel<128>": 0.5, "elementwise": 0.25})
    assert t.window_s == 2.0
    assert t.family_s(("qmm_gemv_kernel", "row_quantize_kernel")) == 0.75
    assert t.family_s(("paged_decode_split_kernel",)) == 0
