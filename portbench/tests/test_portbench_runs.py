"""Whole runs of the tiny cells on the CPU: the harness drives the port's
engine (its CPU path) through set-up and a window, reads every metric that
needs no card, and the plain reference agrees with what the port served;
the port's W4A8 path (the control) does not."""

from __future__ import annotations

import time

import pytest

from portbench import bench, control, spec
from portbench.tests.conftest import CELLS, TINY_LIMIT, run_tiny


@pytest.mark.parametrize("cell", list(CELLS))
def test_tiny_cell_runs_and_agrees_with_the_reference(tiny, cell):
    res = run_tiny(tiny, cell, seed=2 ** 31 + 11)
    m = res["metrics"]
    assert {"ttft_p95_ms", "tpot_p95_ms", "setup_s"} <= set(m)
    assert ("output_tokens_per_s" in m) == (cell != "t.open")
    assert all(v["value"] > 0 for v in m.values())
    assert res["attempted"] > 0 and res["failed"] == 0
    checks = res["checks"]
    assert checks["served_tokens"]["value"] >= 96
    assert bench.is_correct(checks)
    run = res["run"]
    if cell == "t.doc":
        # every admission after the set-up hits its document's 4 pages
        prompt = sum(s.prompt_tokens for s in run.window_steps())
        assert run.counters["prefill_tokens_skipped"] / prompt > 0.75


@pytest.mark.parametrize("cell", ["t.chat", "t.doc"])
def test_control_is_not_correct(tiny, cell):
    """The control (int4 weights, the port's W4A8 path) fails the cell's
    own check on every seed tried, while the program passes on the same
    seeds, read as ``portbench.control`` reads them."""
    lines = []
    for seed in (21, 22, 23):
        for side, quant in (("program", None), ("control", control.CONTROL)):
            res = run_tiny(tiny, cell, seed=seed, quantize=quant)
            lines.append({"side": side, **control.reading(res)})
    summ = control.summary(lines)
    assert summ["program_always_correct"] and summ["control_never_correct"], lines
    assert summ["max_logit_gap"]["upper"] > 3 * summ["max_logit_gap"]["lower"]


def test_control_reads_the_gaps_a_cell_does_not_limit(tiny):
    """A cell that limits only the mean gap still gives both readings."""
    root, bench_json = tiny
    cell = spec.load_cell("t.open", bench_json, root)
    cell.options = dict(cell.options, check=dict(cell.options["check"],
                                                 limits={"mean_logit_gap": TINY_LIMIT}))
    res = bench.run_cell(cell, 41, 4.0, False, "cpu", time.perf_counter(), log=lambda s: None)
    assert set(res["checks"]) == {"mean_logit_gap", "served_tokens", "failed"}
    line = control.reading(res)
    assert line["max_logit_gap"] >= line["mean_logit_gap"] >= 0 and line["correct"]
