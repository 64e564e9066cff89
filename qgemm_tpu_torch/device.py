"""Default-device resolution for the port's entry points.

The port is written for the GPU: ``GPT.init``, ``GPT.init_quantized``, the
interop loader and the engine place tensors on ``cuda`` unless the caller
names another device. Without a GPU, asking for the default raises instead
of quietly running on the CPU — a CPU run is never mistaken for a GPU one.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the GPU: raise when CUDA is unavailable. An explicit
    ``cuda`` device is checked the same way; ``"cpu"`` is taken as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "qgemm_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:   # "cuda" means the current device, by index
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def torch_dtype(name: Optional[str]) -> torch.dtype:
    """'float32' / 'bfloat16' / 'float16' (the JAX config strings)."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name or "float32"]
