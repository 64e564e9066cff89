"""Encoder-decoder transformer inference demo (port of
``examples/transformer_demo.py``): a random-weight encoder-decoder at one
of three sizes generates greedily from random sources with the KV cache,
every GEMM optionally int8 (kernel K1 on the card).

Usage (on the GPU; ``--device cpu`` runs the plain PyTorch path):

    python -m qgemm_tpu_torch.examples.transformer_demo                   # reference dims
    python -m qgemm_tpu_torch.examples.transformer_demo --preset serving
    python -m qgemm_tpu_torch.examples.transformer_demo --quantized --bench

The "reference" preset has the reference demo's widths (d_model 8, 4
heads of 2, 2 blocks) with a real vocabulary. ``--bench`` times one whole
``generate`` call on the card with ``utils/profiling.bench_ms``: CUDA
events around each call, which the host drives step by step (not queued
ahead: the host loop's time is inside the span, so the reading is close
to wall time), and prints tokens/s from it; it needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from qgemm_tpu_torch.device import resolve_device
from qgemm_tpu_torch.models.transformer import Transformer, TransformerConfig

PRESETS = {
    "reference": TransformerConfig(vocab_size=256, d_model=8, n_heads=4, d_ff=8, n_layers=2,
                                   max_seq_len=64),
    "small": TransformerConfig(vocab_size=8192, d_model=256, n_heads=8, d_ff=1024, n_layers=4,
                               max_seq_len=256),
    "serving": TransformerConfig(vocab_size=32000, d_model=1024, n_heads=16, d_ff=4096,
                                 n_layers=8, max_seq_len=512),
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=PRESETS, default="reference")
    ap.add_argument("-s", "--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--src-len", type=int, default=6)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--quantized", action="store_true")
    ap.add_argument("--bench", action="store_true")
    ap.add_argument("--device", default=None, help="default: the GPU")
    args = ap.parse_args(argv)

    cfg = PRESETS[args.preset]
    dev = resolve_device(args.device)
    print(f"config: {cfg}", file=sys.stderr)
    model = Transformer.init(cfg, seed=args.seed, device=dev)
    if args.quantized:
        model = model.quantize()
        print("weights quantized to int8 (absmax per column)", file=sys.stderr)
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed + 1)
    src = torch.randint(0, cfg.vocab_size, (args.batch, args.src_len), generator=g, device=dev)
    tokens = model.generate(src, args.new_tokens)
    print(f"generated tokens (greedy, KV-cache):\n{tokens.cpu()}")
    res = {"preset": args.preset, "quantized": args.quantized, "device": str(dev),
           "tokens": tokens.tolist()}
    if args.bench:
        from qgemm_tpu_torch.utils.profiling import bench_ms
        ms = bench_ms(lambda: model.generate(src, args.new_tokens), iters=10,
                      queue_ahead=False)
        res.update(ms_per_generate=ms,
                   tokens_per_s=args.batch * args.new_tokens * 1e3 / ms,
                   card=torch.cuda.get_device_name(dev))
        print(f"throughput: {res['tokens_per_s']:.1f} tokens/s ({ms:.2f} ms per "
              f"{args.new_tokens}-token generate, CUDA events around the host-driven call)",
              file=sys.stderr)
    print(json.dumps({k: v for k, v in res.items() if k != "tokens"}))
    return res


if __name__ == "__main__":
    main()
