"""Every cell, configuration, traffic mix and metric of BENCHMARK.json loads
by name as data; a new cell with its own files needs no edit of any file
that is there; BENCHMARK.json keeps to the contract's shape."""

from __future__ import annotations

import json
import re

import numpy as np
import pytest

from portbench import spec
from portbench.tests.conftest import TRAFFIC, run_tiny, write_fixture

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_loads_with_its_files_and_readers():
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["generator"]
        spec.generator_module(cell)
        for kind in ("inputs", "systems", "reference"):
            spec.family_module(cell, kind)
        assert cell.end_to_end and cell.per_layer
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2
        for m in cell.per_layer:
            assert m["moves"] in names, (w["name"], m["name"])
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.metric_reader(cell, m["name"]))
        check = cell.options["check"]
        assert set(check["limits"]) & {"max_logit_gap", "mean_logit_gap"}
        assert all(v > 0 for v in check["limits"].values()) and check["served_tokens"] > 0


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"}}
    for kind, allowed in keys.items():
        for e in BENCH[kind]:
            assert set(e) == allowed, e
            assert NAME.match(e["name"])
            assert len(e["why"]) <= 200 and "\n" not in e["why"]
    for c in BENCH["configs"]:
        data = json.loads((spec.ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] == []
    seen = set()
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A cell, a configuration, a mix and a per-layer metric added as new
    files and entries in a copy run without touching a file that exists."""
    before = {p: p.read_bytes() for p in spec.HERE.rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}
    bench_json = write_fixture(tmp_path)
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "steps_in_window.py").write_text(
        "def read(run):\n    return float(len(run.window_steps())) or None\n")
    b = json.loads(bench_json.read_text())
    b["per_layer"].append({"name": "steps_in_window", "unit": "steps", "better": "higher",
                           "source": "host_clock", "layer": "engine", "moves": "ttft_p95_ms",
                           "workloads": ["t.open"]})
    bench_json.write_text(json.dumps(b))
    cell = spec.load_cell("t.open", bench_json, tmp_path)
    assert [m["name"] for m in cell.per_layer][-1] == "steps_in_window"
    run = run_tiny((tmp_path, bench_json), "t.open", check=False)["run"]
    assert spec.metric_reader(cell, "steps_in_window")(run) > 0
    after = {p: p.read_bytes() for p in spec.HERE.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert before == after


@pytest.mark.parametrize("mix", ["chat", "long-prompt", "tdoc"])
def test_generator_gives_every_seed_the_same_work(mix):
    from portbench.generators import sessions
    t = TRAFFIC.get(mix) or json.loads((spec.HERE / "traffic" / f"{mix}.json").read_text())
    sets = []
    for seed in (1, 2 ** 40 + 7):
        s = sessions.stream(dict(t, order="seed"), 1000, seed)
        reqs = [s.next()[0] for _ in range(2 * t["block"])]
        sets.append(sorted((len(r.prompt), r.max_new, r.shared) for r in reqs))
        if "documents" in t:
            assert len({tuple(d) for d in s.documents}) == t["documents"]["count"]
    assert sets[0] == sets[1]


def test_exponential_lengths_keep_the_published_centre():
    from portbench.generators import sessions
    q = sessions.quantiles({"dist": "exponential", "mean": 337.99, "min": 0, "max": 10 ** 9},
                           4096)
    assert abs(q.mean() / 337.99 - 1) < 0.01
    q = sessions.quantiles({"dist": "exponential", "median": 1500, "min": 4, "max": 1984}, 64)
    assert q.min() >= 4 and q.max() == 1984 and abs(np.median(q) / 1500 - 1) < 0.05


def test_open_loop_gaps_are_independent_exponential_draws():
    """The gaps are drawn, not stratified: each seed draws its own, with the
    rate's mean and an exponential's spread, bursts included."""
    from portbench.generators import sessions
    o = dict(json.loads((spec.HERE / "traffic" / "long-prompt.json").read_text()), order="seed")
    rate = o["rate_per_s"]
    draws = []
    for seed in (3, 2 ** 33 + 4):
        s = sessions.stream(o, 1000, seed)
        draws.append(np.array([s.next()[1] for _ in range(40 * o["block"])]))
    assert not np.allclose(draws[0], draws[1])
    for g in draws:
        assert abs(g.mean() * rate - 1) < 0.06 and abs(g.std() / g.mean() - 1) < 0.1
        # stratified quantiles would hold every block's smallest gap at
        # -log(1 - 0.5 / block) / rate; a Poisson process goes far below it
        assert g.min() < 0.1 * -np.log1p(-0.5 / o["block"]) / rate


def test_fixed_order_replays_one_schedule_with_the_seed_s_tokens():
    from portbench.generators import sessions
    o = json.loads((spec.HERE / "traffic" / "long-prompt.json").read_text())
    assert o["order"] == "fixed"
    runs = []
    for seed in (5, 6):
        s = sessions.stream(o, 1000, seed)
        runs.append([s.next() for _ in range(3 * o["block"])])
    assert [(len(a.prompt), a.max_new, g) for a, g in runs[0]] == \
        [(len(a.prompt), a.max_new, g) for a, g in runs[1]]
    assert runs[0][0][0].prompt != runs[1][0][0].prompt
    shuffled = sessions.stream(dict(o, order="seed"), 1000, 5)
    assert [len(shuffled.next()[0].prompt) for _ in range(o["block"])] != \
        [len(a.prompt) for a, _ in runs[0][:o["block"]]]
