"""Input pipelines (port of ``qgemm_tpu/data``): the idx-format (MNIST)
parser and writer, the in-memory dataset, and the native C++ loader and
shuffle (``csrc/idx_loader.cpp``, built with ``g++`` at first use)."""

from qgemm_tpu_torch.data.mnist import MNIST  # noqa: F401
