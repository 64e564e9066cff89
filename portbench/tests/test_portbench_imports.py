"""Nothing the benchmark runs imports JAX or the JAX package, by top-level
module names compared whole (``qgemm_tpu_torch`` starts with
``qgemm_tpu``), and the plain reference imports nothing of the program."""

from __future__ import annotations

import ast
import sys
import types

from portbench import bench, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "qgemm_tpu"}
PROGRAM = "qgemm_tpu_torch"
# the files that may not reach the program: the reference and what it
# reads (the inputs it is handed, the yardstick, the generator)
NO_PROGRAM = ("reference", "inputs", "generators", "metrics")


def top_names(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def sources():
    return [p for p in spec.HERE.rglob("*.py") if "__pycache__" not in p.parts]


def test_no_source_imports_jax_or_the_jax_package():
    for p in sources():
        assert not FORBIDDEN & set(top_names(p)), p


def test_reference_imports_nothing_of_the_program():
    for p in sources():
        rel = p.relative_to(spec.HERE).parts
        if rel[0] in NO_PROGRAM or p.name in ("yardstick.py", "readers.py", "trace.py"):
            assert PROGRAM not in set(top_names(p)), p


def test_runtime_check_compares_whole_top_level_names(monkeypatch):
    for name in ("qgemm_tpu_torch", "qgemm_tpu_torchx", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert bench.forbidden_modules() == []
    for name in ("qgemm_tpu.ops", "jax", "jaxlib.xla_client", "flax.linen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert bench.forbidden_modules() == sorted(["flax.linen", "jax", "jaxlib.xla_client",
                                                "qgemm_tpu.ops"])
