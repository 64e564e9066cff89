"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled at first use, by ``nvcc`` alone, into a
shared library with a plain C interface under ``build/qgemm_tpu_torch/``
at the repository root (ignored by git), and loaded with ``ctypes``. The
library's file name carries a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads as built. A failed ``nvcc``
raises: nothing falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "qgemm_tpu_torch"
KERNELS = ("quantized_matmul", "decode_attention", "flash_attention", "w4a8_matmul")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# ptxas register/shared-memory report of each build, by kernel source
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from csrc/ at first use and need the CUDA toolkit")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}.{_digest(name)}.so"


def _compile(name: str) -> subprocess.Popen:
    out = _lib_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _finish(name: str, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    build_logs[name] = log


def build(names: Optional[Iterable[str]] = None) -> List[str]:
    """Compile every listed kernel source that has no up-to-date library,
    one ``nvcc`` per source, all started together. Returns the names built."""
    names = list(KERNELS if names is None else names)
    with _lock:
        todo = [n for n in names if not _lib_path(n).exists()]
        procs = [(n, _compile(n)) for n in todo]
        try:
            for n, p in procs:
                _finish(n, p)
        finally:
            for _, p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return todo


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_lib_path(name)))
                _libs[name] = lib
    return lib


def check_launch(fn_name: str, rc: int) -> None:
    """Raise on a nonzero cudaError_t returned by a kernel's C entry."""
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed with cudaError {rc}")
