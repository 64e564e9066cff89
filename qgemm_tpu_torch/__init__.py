"""qgemm_tpu_torch — the PyTorch/CUDA port of qgemm_tpu for NVIDIA Hopper.

Same layout and names as ``qgemm_tpu`` (``ops/``, ``models/``,
``serving/``, ``utils/``) so every module has an obvious counterpart. Plain
tensor code is PyTorch; the TPU package's Pallas kernels on the serving
path are CUDA C++ kernels written for ``sm_90a`` (``csrc/``), built with
``nvcc`` at first use and bound through ``ctypes`` (``ops/cuda/``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for the default device without a GPU raises (``device.py``).
"""

__version__ = "0.1.0"   # the JAX package's


def _lazy_exports(package: str, exports: dict):
    """A module ``__getattr__`` for ``package`` that imports each name of
    ``exports`` (name -> submodule) on first use. The packages export the
    JAX package's names this way: importing them eagerly would import the
    models and the engines, which import parts of these packages."""
    def __getattr__(name: str):
        module = exports.get(name)
        if module is None:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        import importlib
        import sys
        value = getattr(importlib.import_module(f"{package}.{module}"), name)
        setattr(sys.modules[package], name, value)
        return value
    return __getattr__


__getattr__ = _lazy_exports(__name__, {
    "absmax_quantize": "ops.quantize", "dequantize": "ops.quantize",
    "quantized_matmul": "ops.quantize", "quantized_matmul_outlier": "ops.quantize"})
