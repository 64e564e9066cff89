"""Initialisation draws from an explicit ``torch.Generator`` (the port's
counterpart of ``qgemm_tpu/utils/prng.py``). The distributions match the
JAX package's; the bits do not — exact weights cross over through
``utils/interop.py``."""

from __future__ import annotations

import torch


def uniform_init(generator: torch.Generator, shape, bound: float,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Uniform(-bound, +bound), drawn in f32 on the generator's device and
    cast to ``dtype``."""
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=torch.float32)
    return ((u * 2.0 - 1.0) * bound).to(dtype)


def normal_init(generator: torch.Generator, shape, scale: float,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """N(0, 1) * scale, drawn in f32 and cast to ``dtype``."""
    return (torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32) * scale).to(dtype)
