"""Quantized GEMM correctness demo (port of ``examples/quantize_demo.py``),
with the reference's flags ``-s/-c/-m/-n/-k``.

With no dims: the reference's hand-written 3x3 @ 3x2 case. With
``-m/-n/-k``: uniform(-1, 1) matrices of that size from ``torch.Generator
(seed)`` (drawn on the CPU, then moved, so every device multiplies the same
inputs). Prints the unquantized result, the quantized one and the mean
quantization error. The quantized product is the dynamic
``quantized_matmul`` — kernel K9 column-quantizes W, then K1 runs — or
with ``--outlier-threshold`` the LLM.int8() outlier split. ``-c`` (or
``--device cpu``) runs the plain PyTorch path.

Usage: python -m qgemm_tpu_torch.examples.quantize_demo [-m M -n N -k K]
    [--rounding truncate] [--outlier-threshold 6.0] [-c]
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import torch

from qgemm_tpu_torch.device import DeviceLike, resolve_device
from qgemm_tpu_torch.ops.quantize import quantized_matmul, quantized_matmul_outlier
from qgemm_tpu_torch.utils.config import add_gemm_flags, gemm_config_from_args


def inputs(m: int = 0, n: int = 0, k: int = 0, seed: int = 0) -> tuple:
    """(x [m, k], w [k, n]) f32 on the CPU: the reference's 3x3 @ 3x2 case
    when any dim is 0, else uniform(-1, 1) draws from ``seed``."""
    if m and n and k:
        g = torch.Generator().manual_seed(seed)
        return (torch.rand((m, k), generator=g) * 2 - 1,
                torch.rand((k, n), generator=g) * 2 - 1)
    return (torch.tensor([[2.0, -1.0, -1.0], [0.0, 3.0, 2.0], [-1.0, -1.0, 0.0]]),
            torch.tensor([[-1.0, 0.0], [0.0, -2.0], [-1.0, 2.0]]))


def demo(x: torch.Tensor, w: torch.Tensor, rounding: str = "nearest",
         outlier_threshold: float = 0.0, device: DeviceLike = None) -> Dict[str, object]:
    """The exact product, the quantized one and the mean absolute error
    between them, on ``device`` (default: the GPU)."""
    dev = resolve_device(device)
    x, w = x.to(dev), w.to(dev)
    exact = x @ w
    if outlier_threshold > 0:
        q = quantized_matmul_outlier(x, w, threshold=outlier_threshold)
    else:
        q = quantized_matmul(x, w, rounding=rounding)
    return {"exact": exact, "quantized": q,
            "mean_error": float((exact - q).abs().mean())}


def _show(t: torch.Tensor) -> str:
    if t.numel() <= 64:
        return str(t.cpu())
    return f"  [{t.shape[0]}x{t.shape[1]}] mean={float(t.mean()):.6f}"


def main(argv: Optional[list] = None) -> Dict[str, object]:
    ap = add_gemm_flags(argparse.ArgumentParser(description=__doc__.split("\n\n")[0]))
    ap.set_defaults(m=0, n=0, k=0)
    ap.add_argument("--rounding", choices=["nearest", "truncate"], default="nearest")
    ap.add_argument("--outlier-threshold", type=float, default=0.0)
    ap.add_argument("--device", default=None, help="default: the GPU ('-c' for the CPU)")
    args = ap.parse_args(argv)
    cfg = gemm_config_from_args(args)
    res = demo(*inputs(cfg.m, cfg.n, cfg.k, cfg.seed), rounding=args.rounding,
               outlier_threshold=args.outlier_threshold, device=cfg.device or args.device)
    print("Unquantized result:")
    print(_show(res["exact"]))
    print("Quantized result:")
    print(_show(res["quantized"]))
    print("Mean quantization error:")
    print(res["mean_error"])
    return res


if __name__ == "__main__":
    main()
