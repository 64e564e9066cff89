"""ctypes bindings for the native idx loader (port of
``qgemm_tpu/data/native.py``) over the port's copy of
``csrc/idx_loader.cpp``.

mmap + multithreaded /255 normalization, bit-identical to the numpy parser
in ``data/mnist.py`` (the C++ side divides through a lookup table), and the
splitmix64 Fisher-Yates shuffle. ``build()`` compiles the library with
``g++`` into ``build/qgemm_tpu_torch/`` (``utils/host_build.py``);
``available()`` only says whether the library of the current source is
built and loads, and never starts a build, so the dataset's routes do not
change on their own.
"""

from __future__ import annotations

import ctypes

import numpy as np

from qgemm_tpu_torch.utils import host_build

_NAME = "idx_loader"
_lib = None

_ERRORS = {1: "open failed", 2: "bad idx magic", 3: "truncated file"}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.qg_idx_images_info.argtypes = [ctypes.c_char_p, i64p, i64p, i64p]
    lib.qg_idx_images_info.restype = ctypes.c_int
    lib.qg_idx_load_images.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float)]
    lib.qg_idx_load_images.restype = ctypes.c_int
    lib.qg_idx_labels_info.argtypes = [ctypes.c_char_p, i64p]
    lib.qg_idx_labels_info.restype = ctypes.c_int
    lib.qg_idx_load_labels.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32)]
    lib.qg_idx_load_labels.restype = ctypes.c_int
    lib.qg_shuffle_indices.argtypes = [i64p, ctypes.c_int64, ctypes.c_uint64]
    lib.qg_shuffle_indices.restype = None
    return lib


def build() -> None:
    """Build and load the library, or raise."""
    global _lib
    if _lib is None:
        _lib = _bind(host_build.load(_NAME))


def available() -> bool:
    """The library of the current source is built and loads."""
    global _lib
    if _lib is None and (lib := host_build.load_built(_NAME)) is not None:
        _lib = _bind(lib)
    return _lib is not None


def _loaded() -> ctypes.CDLL:
    build()
    return _lib


def _check(rc: int, path: str) -> None:
    if rc != 0:
        raise ValueError(f"{path}: {_ERRORS.get(rc, f'error {rc}')}")


def load_idx_images(path: str) -> np.ndarray:
    """idx3-ubyte images -> float32 [N, rows * cols] in [0, 1]."""
    lib = _loaded()
    n, rows, cols = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    p = path.encode()
    _check(lib.qg_idx_images_info(p, n, rows, cols), path)
    out = np.empty((n.value, rows.value * cols.value), dtype=np.float32)
    _check(lib.qg_idx_load_images(p, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))),
           path)
    return out


def load_idx_labels(path: str) -> np.ndarray:
    """idx1-ubyte labels -> int32 [N]."""
    lib = _loaded()
    n = ctypes.c_int64()
    p = path.encode()
    _check(lib.qg_idx_labels_info(p, n), path)
    out = np.empty((n.value,), dtype=np.int32)
    _check(lib.qg_idx_load_labels(p, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))),
           path)
    return out


def shuffle_indices(n: int, seed: int) -> np.ndarray:
    """Deterministic Fisher-Yates permutation of range(n) (splitmix64)."""
    lib = _loaded()
    out = np.empty((n,), dtype=np.int64)
    lib.qg_shuffle_indices(out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n, seed)
    return out
