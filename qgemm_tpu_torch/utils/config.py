"""Config / flag system (port of ``qgemm_tpu/utils/config.py``).

The reference's getopt short flags ``-s`` (seed), ``-c`` (CPU) and
``-m/-n/-k`` (GEMM dims) and the encoder-decoder demo's hyperparameters
as dataclasses with an argparse bridge. ``-c/--cpu`` runs on the CPU: the
port's entry points take ``GemmConfig.device`` ("cpu", or None for the
GPU).
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass
class GemmConfig:
    m: int = 2048
    n: int = 2048
    k: int = 2048
    seed: int = 0
    on_cpu: bool = False  # the reference's -c escape hatch
    iters: int = 50       # the reference's benchmark protocol: 50 iterations

    @property
    def device(self) -> Optional[str]:
        """"cpu" with ``-c``, else None (the entry points' default: the GPU)."""
        return "cpu" if self.on_cpu else None


@dataclass
class TransformerConfig:
    """Hyperparameters of the encoder-decoder demo (the reference's
    seq=6, d_model=8, heads=4, blocks=2, d_ff=8), generalized."""

    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    d_ff: int = 2048
    n_layers: int = 2
    max_seq_len: int = 512
    dtype: str = "bfloat16"
    quantized: bool = True          # route every GEMM through the int8 path
    outlier_threshold: float = 0.0  # 0 disables the outlier split
    outlier_capacity: int = 0       # outlier feature dims kept at most


def add_gemm_flags(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("-s", "--seed", type=int, default=0)
    p.add_argument("-c", "--cpu", action="store_true", help="run on the CPU")
    p.add_argument("-m", type=int, default=2048)
    p.add_argument("-n", type=int, default=2048)
    p.add_argument("-k", type=int, default=2048)
    p.add_argument("--iters", type=int, default=50)
    return p


def gemm_config_from_args(args) -> GemmConfig:
    return GemmConfig(m=args.m, n=args.n, k=args.k, seed=args.seed,
                      on_cpu=args.cpu, iters=args.iters)


def asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)
