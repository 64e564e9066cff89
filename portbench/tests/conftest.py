"""Fixtures of the benchmark's tests: a tiny benchmark in a temporary folder
(its own ``BENCHMARK.json``, a 2-layer GPT configuration, three traffic mixes
and three cells, one of each loop and cache kind), and the card check,
made inside a fixture so that collecting the tests never asks for a card."""

from __future__ import annotations

import json
import time
from pathlib import Path

import pytest

from portbench import bench, spec

TINY = {"name": "tiny", "source": "tests", "family": "gpt",
        "model": {"vocab_size": 512, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 128,
                  "n_layers": 2, "max_seq_len": 256, "dtype": "float32"},
        "reduced": []}
TRAFFIC = {
    "tchat": {"generator": "sessions", "loop": "closed", "clients": 4, "block": 16,
              "prompt": {"dist": "lognormal", "median": 24, "sigma": 0.8, "min": 8, "max": 64},
              "output": {"dist": "lognormal", "median": 12, "sigma": 0.5, "min": 4, "max": 32}},
    "tdoc": {"generator": "sessions", "loop": "closed", "clients": 4, "block": 16,
             "documents": {"count": 2, "tokens": 64},
             "prompt": {"dist": "uniform", "min": 4, "max": 16},
             "output": {"dist": "uniform", "min": 4, "max": 16}},
    "topen": {"generator": "sessions", "loop": "open", "rate_per_s": 40.0, "block": 16,
              "prompt": {"dist": "uniform", "min": 40, "max": 120},
              "output": {"dist": "uniform", "min": 8, "max": 24}},
}
PAGED = {"max_slots": 4, "paged": True, "page_size": 16, "prefix_cache": True,
         "scheduler": "python"}
# the tiny cells' limit on the widest logit gap: the float32 port on the
# CPU reads 0 to ~0.004 against the reference, its W4A8 control ~0.05 and up
TINY_LIMIT = 0.02
CELLS = {
    "t.chat": ("tchat", {"max_slots": 4, "quantized_cache": True, "multi_step": 4,
                         "scheduler": "python"}),
    "t.doc": ("tdoc", PAGED),
    "t.open": ("topen", PAGED),
}


def write_fixture(root: Path) -> Path:
    """The tiny benchmark under ``root``; returns its BENCHMARK.json."""
    for kind in ("configs", "traffic", "cells"):
        (root / kind).mkdir(parents=True, exist_ok=True)
    (root / "configs" / "tiny.json").write_text(json.dumps(TINY))
    for name, t in TRAFFIC.items():
        (root / "traffic" / f"{name}.json").write_text(json.dumps(t))
    real = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    # each real cell stands for the tiny cells of its loop kind
    names = {w["name"]: [n for n, (t, _) in CELLS.items()
                         if TRAFFIC[t]["loop"] == spec.load_cell(w["name"]).traffic["loop"]]
             for w in real["workloads"]}
    for name, (_, eng) in CELLS.items():
        (root / "cells" / f"{name}.json").write_text(json.dumps(
            {"engine": eng, "quantize": {"bits": 8},
             "check": {"served_tokens": 96, "min_requests": 12,
                       "limits": {"max_logit_gap": TINY_LIMIT}}}))
    for m in real["end_to_end"] + real["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [n for w in m["workloads"] for n in names[w]]
    real["configs"] = [{"name": "tiny", "source": "tests", "file": "configs/tiny.json",
                        "reduced": [], "why": "tests"}]
    real["workloads"] = [{"name": n, "config": "tiny", "traffic": t, "chips": 1, "why": "tests"}
                         for n, (t, _) in CELLS.items()]
    path = root / "BENCHMARK.json"
    path.write_text(json.dumps(real))
    return path


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    import torch
    # one thread a process: the tiny runs are timed windows, and test
    # workers that each spawn a thread per core would starve one another
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("tinybench")
    return root, write_fixture(root)


def run_tiny(tiny, cell: str, seed: int = 5, seconds: float = 4.0, **kw) -> dict:
    root, bench_json = tiny
    c = spec.load_cell(cell, bench_json, root)
    return bench.run_cell(c, seed, seconds, False, "cpu", time.perf_counter(),
                          log=lambda s: None, **kw)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
