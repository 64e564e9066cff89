"""MNIST MLP training and int8-quantized inference (port of
``examples/train_mnist.py``).

The workload of the reference's MNIST oracle: a 784-16-10 MLP trained by
SGD (lr 0.01, batch 32) on the fused cross-entropy, then evaluated with
every layer quantized to int8, each product through kernel K1 on the card.
The dataset lives on the device for the whole run: each epoch uploads one
index order (shuffled by ``MNIST.batches``' rule, or in order with
``--no-shuffle``, the oracle's protocol) and batches are gathered there.

Without idx files under ``--data`` it trains on ``MNIST.synthetic`` at
``--noise`` (0.3 nearly separable; the oracle protocol uses 2.0).
``--init CKPT`` starts from a checkpoint's weights instead of the seed's
(either package's file: the JAX package's PRNG draws other initial
weights than the port's from the same seed).

``train_mlp`` and ``evaluate`` are importable.

Usage (on the GPU; ``--device cpu`` runs the plain PyTorch path):

    python -m qgemm_tpu_torch.examples.train_mnist [-s SEED] [--epochs N] \\
        [--data DIR] [--noise 2.0] [--no-shuffle] [--init CKPT]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from qgemm_tpu_torch.data.mnist import MNIST
from qgemm_tpu_torch.device import DeviceLike, resolve_device
from qgemm_tpu_torch.models.mlp import MLP
from qgemm_tpu_torch.models.optim import sgd_step
from qgemm_tpu_torch.ops.cross_entropy import cross_entropy_loss
from qgemm_tpu_torch.utils.checkpoint import load_checkpoint


def load_or_synthesize(data: str, seed: int, noise: float) -> tuple:
    """(train, test, source): the idx files under ``data``, or the
    synthetic stand-in (8,192 / 2,048 samples) when there are none."""
    try:
        return MNIST.load(data, "train"), MNIST.load(data, "test"), f"idx files from {data}"
    except (FileNotFoundError, ValueError):
        return (MNIST.synthetic(8192, seed=seed, noise=noise),
                MNIST.synthetic(2048, seed=seed + 1, noise=noise),
                f"synthetic (noise {noise}; no MNIST under {data})")


@torch.no_grad()
def evaluate(model: MLP, x: torch.Tensor, y: torch.Tensor) -> float:
    """Top-1 accuracy of ``model`` on [N, 784] images and [N] labels."""
    return float((model(x).argmax(-1) == y).float().mean())


def train_mlp(train: MNIST, dims: List[int], epochs: int, batch: int, lr: float,
              seed: int, device: DeviceLike = None, shuffle: bool = True,
              init: Optional[str] = None, log=None) -> tuple:
    """SGD on ``train`` from the seed's weights, or a checkpoint's
    (``init``): per epoch the mean loss and the running train accuracy (the
    oracle's), read once an epoch. Returns (model, per-epoch records,
    training wall seconds)."""
    dev = resolve_device(device)
    model = MLP.init(seed, dims, device=dev)
    if init is not None:
        model = load_checkpoint(init, model)
    params = [p for p in model.parameters() if p.requires_grad]
    xs = torch.as_tensor(train.images, device=dev)
    ys = torch.as_tensor(train.targets.astype(np.int64), device=dev)
    n_batches = len(train) // batch
    records = []
    t0 = time.perf_counter()
    for epoch in range(epochs):
        order = torch.as_tensor(train.order(seed + epoch if shuffle else None), device=dev)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        correct = torch.zeros((), dtype=torch.int64, device=dev)
        for b in range(n_batches):
            idx = order[b * batch:(b + 1) * batch]
            x, y = xs[idx], ys[idx]
            logits = model(x)
            loss = cross_entropy_loss(logits, y)
            sgd_step(params, torch.autograd.grad(loss, params), lr)
            loss_sum += loss.detach()
            correct += (logits.detach().argmax(-1) == y).sum()
        rec = {"epoch": epoch, "loss": float(loss_sum) / n_batches,
               "train_acc": int(correct) / (n_batches * batch)}
        records.append(rec)
        if log is not None:
            print(json.dumps(rec), file=log)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return model, records, time.perf_counter() - t0


def run(args) -> Dict[str, object]:
    dev = resolve_device(args.device)
    train, test, source = load_or_synthesize(args.data, args.seed, args.noise)
    print(f"dataset: {source}: train {train.images.shape}, test {test.images.shape}",
          file=sys.stderr)
    model, records, wall = train_mlp(train, args.dims, args.epochs, args.batch, args.lr,
                                     args.seed, dev, shuffle=not args.no_shuffle,
                                     init=args.init, log=sys.stderr)
    tx = torch.as_tensor(test.images, device=dev)
    ty = torch.as_tensor(test.targets.astype(np.int64), device=dev)
    qmodel = model.quantize()      # every layer int8: K1 on the card
    res = {"dataset": source, "dims": args.dims, "epochs": args.epochs,
           "train_acc": records[-1]["train_acc"] if records else None,
           "fp32_test_acc": evaluate(model, tx, ty), "int8_test_acc": evaluate(qmodel, tx, ty),
           "train_wall_s": wall, "device": str(dev)}
    print(f"training wall-clock: {wall:.1f}s", file=sys.stderr)
    print(f"fp32 test acc: {res['fp32_test_acc']:.4f}  int8 test acc: "
          f"{res['int8_test_acc']:.4f} (delta "
          f"{res['fp32_test_acc'] - res['int8_test_acc']:+.4f})")
    return res


def main(argv=None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-s", "--seed", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--data", default="./data/MNIST/raw")
    ap.add_argument("--dims", type=int, nargs="+", default=[784, 16, 10])
    ap.add_argument("--noise", type=float, default=0.3,
                    help="noise of the synthetic stand-in (without idx files)")
    ap.add_argument("--no-shuffle", action="store_true",
                    help="batches in order every epoch (the oracle's protocol)")
    ap.add_argument("--init", default=None, help="a checkpoint of the MLP to start from")
    ap.add_argument("--device", default=None, help="default: the GPU; 'cpu' for the plain path")
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    main()
