"""Load a cell and everything it names, by name, from the benchmark's files.

``load_cell(name)`` reads ``BENCHMARK.json`` at the checkout's root and
returns the cell: its ``workloads`` entry, its configuration, its traffic
mix, its cell file (engine options, quantization, the correctness check and
its limit) and the metric entries that the cell reports. Nothing here knows
a cell, a configuration, a mix or a metric by name, so a later change adds
one with new files and new entries only.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """Import a file by its path (metric files carry dots in their names),
    once per path."""
    name = f"{name}_{abs(hash(str(path)))}".replace(".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict            # configs/<config>.json
    traffic: dict           # traffic/<mix>.json
    options: dict           # cells/<cell>.json
    end_to_end: List[dict]  # BENCHMARK.json metrics this cell reports
    per_layer: List[dict]
    root: Path = field(default=HERE)

    def metrics(self, trace: bool) -> List[dict]:
        return self.per_layer if trace else self.end_to_end

    def find(self, kind: str, name: str, ext: str) -> Path:
        return find(self.root, kind, name, ext)


def find(root: Path, kind: str, name: str, ext: str) -> Path:
    """``<kind>/<name><ext>`` under ``root``, else under this folder."""
    for base in (root, HERE):
        p = base / kind / f"{name}{ext}"
        if p.exists():
            return p
    raise FileNotFoundError(f"no {kind}/{name}{ext} under {root} or {HERE}")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: Optional[Path] = None, root: Path = HERE) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (``bench_path``, default the
    checkout's), each of its files read from ``root`` where it is there,
    else from this folder."""
    bench = read_json(bench_path or ROOT / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = entries[0]
    return Cell(name=name, chips=int(w["chips"]),
                config=read_json(find(root, "configs", w["config"], ".json")),
                traffic=read_json(find(root, "traffic", w["traffic"], ".json")),
                options=read_json(find(root, "cells", name, ".json")),
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
                root=root)


def metric_reader(cell: Cell, metric: str):
    """``read(run) -> float | None`` of ``metrics/<metric>.py``."""
    mod = load_module(cell.find("metrics", metric, ".py"), f"portbench_metric_{metric}")
    return mod.read


def family_module(cell: Cell, kind: str) -> ModuleType:
    """``inputs/``, ``systems/`` or ``reference/<family>.py`` of the cell's
    configuration."""
    fam = cell.config["family"]
    return load_module(cell.find(kind, fam, ".py"), f"portbench_{kind}_{fam}")


def generator_module(cell: Cell) -> ModuleType:
    gen = cell.traffic["generator"]
    return load_module(cell.find("generators", gen, ".py"), f"portbench_generator_{gen}")
