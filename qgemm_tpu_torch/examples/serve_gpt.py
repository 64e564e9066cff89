"""Continuous-batching GPT serving demo (port of ``examples/serve_gpt.py``).

Stands up a GPT with random weights from ``--seed`` (int8 unless
``--no-quantize``, W4A8 with ``--w4``), submits ``--requests`` requests of
mixed prompt and generation lengths, and drives the engine to completion,
reporting slot occupancy and throughput. ``--scheduler auto`` (the
default) keeps the host-side bookkeeping in the native C++ scheduler when
its library is built (``serving/native.py``), ``native`` builds it first,
``python`` runs the Python bookkeeper; the line "scheduler:" says which
ran.

``--tp N`` serves the int8 model tensor-parallel over N processes, one per
card (NCCL; gloo with ``--device cpu``), each with its rank's shards
(``parallel.sharding.shard_quantized_model``), the draft sharded too;
start it under ``torchrun``, which gives each process its rank. Rank 0
prints.

Usage (on the GPU; ``--device cpu`` runs the plain PyTorch path):

    python -m qgemm_tpu_torch.examples.serve_gpt [--layers N] [--requests R] \\
        [--slots K] [--scheduler native] [--paged] [--multi-step 4]
    torchrun --nproc-per-node N -m qgemm_tpu_torch.examples.serve_gpt --tp N
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch.distributed as dist

from qgemm_tpu_torch.device import resolve_device
from qgemm_tpu_torch.models.gpt import GPT, GPTConfig
from qgemm_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
from qgemm_tpu_torch.parallel.sharding import shard_quantized_model
from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine, Request


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-s", "--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-seq-len", type=int, default=256)
    ap.add_argument("--scheduler", default="auto", choices=["auto", "python", "native"])
    ap.add_argument("--no-quantize", action="store_true")
    ap.add_argument("--w4", action="store_true",
                    help="W4A8: int4 group-quantized weights (half the int8 weight bytes)")
    ap.add_argument("--kv-heads", type=int, default=0,
                    help="GQA: KV heads fewer than query heads (0 = MHA)")
    ap.add_argument("--paged", action="store_true",
                    help="paged int8 KV cache: memory scales with resident tokens")
    ap.add_argument("--n-pages", type=int, default=0, help="page-pool size (0 = full)")
    ap.add_argument("--chunked", type=int, default=0,
                    help="chunked prefill size (0 = off), dense and paged modes")
    ap.add_argument("--multi-step", type=int, default=0,
                    help="decode K steps per dispatch when nothing waits")
    ap.add_argument("--draft-layers", type=int, default=0,
                    help="speculative decoding: a draft of this many layers (d_model/4) "
                         "proposing --spec-gamma tokens a round")
    ap.add_argument("--spec-gamma", type=int, default=4)
    ap.add_argument("--tp", type=int, default=0,
                    help="tensor-parallel ways: one process per rank, under torchrun")
    ap.add_argument("--device", default=None, help="default: the GPU; 'cpu' for the plain path")
    return ap


def serve(args) -> Dict[str, object]:
    mesh = None
    if args.tp:
        if args.no_quantize:
            raise SystemExit("--tp shards the quantized model; drop --no-quantize")
        initialize_distributed(device=args.device)
        if dist.get_world_size() != args.tp:
            raise SystemExit(f"--tp {args.tp} needs {args.tp} processes (torchrun "
                             f"--nproc-per-node {args.tp}), have {dist.get_world_size()}")
        mesh = make_mesh((1, args.tp), device=args.device)
    dev = resolve_device(args.device)
    say = print if mesh is None or dist.get_rank() == 0 else (lambda *a, **k: None)
    cfg = GPTConfig(vocab_size=args.vocab, d_model=args.d_model, n_heads=args.heads,
                    n_kv_heads=args.kv_heads, d_ff=4 * args.d_model, n_layers=args.layers,
                    max_seq_len=args.max_seq_len)
    model = GPT.init(cfg, seed=args.seed, device=dev)
    if not args.no_quantize:
        model = model.quantize(bits=4 if args.w4 else 8)
    draft: Optional[GPT] = None
    if args.draft_layers:
        dcfg = GPTConfig(vocab_size=args.vocab, d_model=max(64, args.d_model // 4),
                         n_heads=max(1, args.heads // 2), d_ff=args.d_model,
                         n_layers=args.draft_layers, max_seq_len=args.max_seq_len)
        draft = GPT.init(dcfg, seed=args.seed + 1, device=dev)
        if not args.no_quantize:
            draft = draft.quantize()
    if mesh is not None:
        model = shard_quantized_model(model, mesh)
        draft = None if draft is None else shard_quantized_model(draft, mesh)
    spec = dict(draft_model=draft, spec_gamma=args.spec_gamma) if draft is not None else {}
    engine = ContinuousBatchingEngine(model, max_slots=args.slots, scheduler=args.scheduler,
                                      paged=args.paged, n_pages=args.n_pages or None,
                                      chunked_prefill=args.chunked or None,
                                      multi_step=args.multi_step, device=dev, mesh=mesh,
                                      **spec)
    say(f"tensor parallel: {args.tp or 1} rank(s)")
    say(f"model: {model.num_params() / 1e6:.1f}M params "
          f"({'float' if args.no_quantize else 'int4' if args.w4 else 'int8'}); "
          f"scheduler: {engine.scheduler}; slots: {args.slots}; device: {dev}")

    rng = np.random.default_rng(args.seed)
    reqs = []
    for _ in range(args.requests):
        plen = int(rng.integers(2, 8))
        reqs.append(Request(prompt=[int(t) for t in rng.integers(0, args.vocab, plen)],
                            max_new_tokens=int(rng.integers(4, 32))))
        engine.submit(reqs[-1])

    t0 = time.perf_counter()
    occupancy = []
    while engine.book.num_waiting or engine.book.num_active:
        engine.step()
        occupancy.append(engine.book.num_active)
    dt = time.perf_counter() - t0

    fin = engine.finished
    n_toks = sum(len(r.generated) for r in fin)
    st = engine.stats
    say(f"served {len(fin)} requests, {n_toks} tokens in {dt:.2f}s "
          f"({n_toks / dt:,.0f} tok/s host-stepped), {engine.steps} steps, "
          f"mean occupancy {np.mean(occupancy):.2f}/{args.slots}")
    say(f"engine stats: {st['tokens_generated']} tokens, "
          f"{st['tokens_per_s']:,.0f} tok/s engine-counted (wall {st['wall_s']}s)")
    for r in fin[:4]:
        say(f"  req {r.id}: prompt[{len(r.prompt)}] -> {len(r.generated)} tokens: "
              f"{r.generated[:8]}...")
    if not (all(r.done and r.error is None for r in fin) and len(fin) == args.requests):
        raise RuntimeError(f"{len(fin)} of {args.requests} requests finished, errors: "
                           f"{[r.error for r in fin if r.error]}")
    return {"scheduler": engine.scheduler, "requests": reqs, "stats": st}


def main(argv=None) -> Dict[str, object]:
    args = parser().parse_args(argv)
    try:
        return serve(args)
    finally:
        if args.tp and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
