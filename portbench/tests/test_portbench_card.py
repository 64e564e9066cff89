"""Card tests: skipped without an NVIDIA card (the ``card`` marker; the
fixture decides, never the import). On the chip:
``python3 -m pytest portbench/tests -m card``."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import spec


@pytest.mark.card
def test_each_cell_runs_correct_on_the_card(card):
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", w["name"],
                              "--seed", "77", "--seconds", "5", "--trace", "0"],
                             cwd=spec.ROOT, capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-4000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["correct"] and res["device"]["platform"] == "gpu", res


@pytest.mark.card
def test_trace_reads_device_kernels(card):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "opt-6.7b.long-prompt", "--seed", "78", "--seconds", "8",
                          "--trace", "1"], cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert res["breakdown"]["device_ops"]
