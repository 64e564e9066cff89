"""qgemm_tpu_torch — the PyTorch/CUDA port of qgemm_tpu for NVIDIA Hopper.

Same layout and names as ``qgemm_tpu`` (``ops/``, ``models/``,
``serving/``, ``utils/``) so every module has an obvious counterpart. Plain
tensor code is PyTorch; the TPU package's Pallas kernels on the serving
path are CUDA C++ kernels written for ``sm_90a`` (``csrc/``), built with
``nvcc`` at first use and bound through ``ctypes`` (``ops/cuda/``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for the default device without a GPU raises (``device.py``).
"""
