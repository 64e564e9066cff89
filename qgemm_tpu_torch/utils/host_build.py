"""Build and load the port's host-side C++ libraries.

The counterpart of ``ops/cuda/_build.py`` for the two C++ sources that run
on the host: ``csrc/scheduler.cpp`` (the continuous-batching scheduler
behind ``serving/native.py``) and ``csrc/idx_loader.cpp`` (the idx loader
and shuffle behind ``data/native.py``). Each is compiled at first use by
``g++`` with the flags of the JAX package's ``csrc/Makefile`` into
``build/qgemm_tpu_torch/<name>.<hash>.so`` at the repository root (ignored
by git), the hash covering the source and the flags. The compiler writes a
file of its own process's name that is then renamed into place, so
processes that build the same library at once each publish a whole one. A
failed compile raises.

``digest``, ``tmp_path`` and ``publish`` are shared with ``_build.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "qgemm_tpu_torch"
HOST_LIBS = ("scheduler", "idx_loader")
GXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra"]
GXX_LDFLAGS = ["-shared", "-pthread"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def digest(flags: Iterable[str], paths: Iterable[Path]) -> str:
    """16 hex digits of sha256 over the flags and each file's name and
    bytes: a library's file name carries it, so any change rebuilds."""
    h = hashlib.sha256(" ".join(flags).encode())
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def tmp_path(out: Path) -> Path:
    """Where this process's compiler writes ``out`` before ``publish``."""
    return out.with_suffix(f".{os.getpid()}.tmp")


def publish(out: Path) -> None:
    """Rename this process's finished build into place (atomic)."""
    os.replace(tmp_path(out), out)


def gxx_path() -> str:
    cand = os.environ.get("CXX") or shutil.which("g++")
    if not cand:
        raise RuntimeError("g++ not found: the port's host libraries are built "
                           "from csrc/*.cpp at first use and need a C++ compiler")
    return cand


def lib_path(name: str) -> Path:
    """The library file of ``csrc/<name>.cpp`` as it stands now."""
    return BUILD_DIR / f"{name}.{digest(GXX_FLAGS + GXX_LDFLAGS, [CSRC / f'{name}.cpp'])}.so"


def built(name: str) -> bool:
    """True when the library of the current source exists; builds nothing."""
    return lib_path(name).exists()


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cpp`` unless its library exists. Raises
    ``RuntimeError`` with the compiler's output when ``g++`` fails."""
    if name not in HOST_LIBS:
        raise ValueError(f"unknown host library {name!r}; expected one of {HOST_LIBS}")
    out = lib_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [gxx_path(), *GXX_FLAGS, str(CSRC / f"{name}.cpp"), *GXX_LDFLAGS,
           "-o", str(tmp_path(out))]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp_path(out).unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for csrc/{name}.cpp (exit {res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    publish(out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cpp``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)))
    return lib


def load_built(name: str) -> Optional[ctypes.CDLL]:
    """The library of ``csrc/<name>.cpp`` if it is built and loads, else
    None; never builds."""
    if name not in _libs and not built(name):
        return None
    try:
        return load(name)
    except OSError:
        return None
