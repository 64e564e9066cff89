"""End-to-end causal-LM training of a small GPT (port of
``examples/train_gpt_lm.py``): the port's training path — flash attention
forward (kernel K3) and blockwise backward (kernel K7) on the card, the
cross-entropy with its analytic gradient, Adam, and checkpointing.

Task: the induction/copy task. Each sequence is a random first half
repeated verbatim as the second half; predicting the second half is exact
in-context copying, the first half is noise. Held-out accuracy is
next-token top-1 over the copied half.

``train_model`` is importable; batches come from a ``torch.Generator`` on
the model's device unless the caller hands them in (``batches``).

Usage (on the GPU; ``--device cpu`` runs the plain PyTorch path):

    python -m qgemm_tpu_torch.examples.train_gpt_lm [--d-model 128 --heads 4] \\
        [--steps 1500] [--seq-len 128] [--ckpt model.npz]

The defaults are the JAX example's: ``--d-model 128 --heads 4``, a head_dim
of 32, which K3 and K7 take at their 32-wide instantiation.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Iterable, Iterator, Optional

import torch

from qgemm_tpu_torch.device import DeviceLike, resolve_device
from qgemm_tpu_torch.models.gpt import GPT, GPTConfig
from qgemm_tpu_torch.models.optim import Adam, AdamState
from qgemm_tpu_torch.ops.cross_entropy import cross_entropy_loss


def _generator(device: torch.device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def batch_iter(generator: torch.Generator, batch: int, seq_len: int,
               vocab: int) -> Iterator[torch.Tensor]:
    """[B, S+1] sequences on the generator's device: a random half,
    repeated (cut to S+1 tokens)."""
    half = (seq_len + 1) // 2
    while True:
        first = torch.randint(0, vocab, (batch, half), generator=generator,
                              device=generator.device)
        yield torch.cat([first, first], dim=1)[:, :seq_len + 1]


def heldout_eval(model: GPT, seq_len: int, vocab: int, n: int = 64, seed: int = 7):
    """(loss over all positions, top-1 accuracy over the copied half) on a
    fresh generator stream."""
    test = next(batch_iter(_generator(model.device, seed), n, seq_len, vocab))
    with torch.no_grad():
        logits = model.forward(test[:, :-1])
        loss = float(cross_entropy_loss(logits.to(torch.float32).reshape(-1, vocab),
                                        test[:, 1:].reshape(-1)))
    half = (seq_len + 1) // 2
    pred = logits[:, half - 1:].argmax(dim=-1)
    acc = float((pred == test[:, half:]).to(torch.float32).mean())
    return loss, acc


def loss_fn(model: GPT, seqs: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL of seqs [B, S+1] under teacher forcing."""
    logits = model.forward(seqs[:, :-1])
    return cross_entropy_loss(logits.reshape(-1, model.cfg.vocab_size),
                              seqs[:, 1:].reshape(-1))


def train_step(model: GPT, params, opt: Adam, state: AdamState, seqs: torch.Tensor):
    """One step: forward, backward, Adam in place on ``params`` (the model's
    trainable parameters). Returns (state, loss as a device tensor)."""
    for p in params:
        p.grad = None
    loss = loss_fn(model, seqs)
    loss.backward()
    state = opt.step(params, [p.grad for p in params], state)
    return state, loss.detach()


def train_model(steps: int = 200, batch: int = 16, seq_len: int = 128, vocab: int = 64,
                lr: float = 3e-3, d_model: int = 128, n_heads: int = 4, d_ff: int = 512,
                n_layers: int = 2, max_seq_len: Optional[int] = None, seed: int = 0,
                data_seed: int = 1, log=None, device: DeviceLike = None,
                batches: Optional[Iterable] = None):
    """Train a GPT on the induction task; returns (model, stats dict).
    ``batches`` (an iterable of [B, S+1] token arrays) replaces the
    generated stream."""
    dev = resolve_device(device)
    cfg = GPTConfig(vocab_size=vocab, d_model=d_model, n_heads=n_heads, d_ff=d_ff,
                    n_layers=n_layers, max_seq_len=max_seq_len or seq_len + 1)
    model = GPT.init(cfg, seed=seed, device=dev)
    params = [p for _, p in model.named_trainable()]
    opt = Adam(lr=lr)
    state = opt.init(params)
    it = (iter(batches) if batches is not None
          else batch_iter(_generator(dev, data_seed), batch, seq_len, vocab))
    first = loss = None
    for i in range(steps):
        seqs = torch.as_tensor(next(it)).to(dev)
        state, loss = train_step(model, params, opt, state, seqs)
        if i == 0:
            first = float(loss)
        if log and i % max(1, steps // 10) == 0:
            log(f"step {i:4d}  loss {float(loss):.4f}")
    last = float(loss)
    hl, acc = heldout_eval(model, seq_len, vocab)
    return model, {"loss_first": first, "loss_last": last,
                   "heldout_loss": hl, "heldout_acc": acc}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--d-ff", type=int, default=512)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--ckpt", default="", help="save the trained model here")
    ap.add_argument("--device", default=None, help="default: the GPU")
    args = ap.parse_args()

    model, st = train_model(
        steps=args.steps, batch=args.batch, seq_len=args.seq_len, vocab=args.vocab,
        lr=args.lr, d_model=args.d_model, n_heads=args.heads, d_ff=args.d_ff,
        n_layers=args.layers, device=args.device,
        log=lambda m: print(m, file=sys.stderr))
    print(f"loss {st['loss_first']:.3f} -> {st['loss_last']:.3f}; held-out "
          f"next-token acc {st['heldout_acc']:.3f}", file=sys.stderr)

    if args.ckpt:
        from qgemm_tpu_torch.utils.checkpoint import save_checkpoint
        save_checkpoint(args.ckpt, model)
        print(f"saved {args.ckpt}", file=sys.stderr)

    print(json.dumps({"metric": "gpt_lm_heldout_acc",
                      "value": round(st["heldout_acc"], 4),
                      "loss_first": round(st["loss_first"], 4),
                      "loss_last": round(st["loss_last"], 4),
                      "device": str(model.device)}))


if __name__ == "__main__":
    main()
