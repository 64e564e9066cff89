"""Optimizers (port of ``qgemm_tpu/models/optim.py``): SGD and Adam with
decoupled weight decay, over a list of parameter tensors and a list of
their gradients (``None`` for a frozen leaf: it passes through).

The JAX versions return new parameters; these update the parameters (and
Adam's moments) in place, which keeps one copy of a large model's
training state on the card. Adam's arithmetic is JAX's, not
``torch.optim.Adam``'s: f32 moments for bf16 parameters, bias corrections
computed in f32, and the step cast to the parameter's dtype before the
subtraction.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence

import torch

Grads = Sequence[Optional[torch.Tensor]]


@torch.no_grad()
def sgd_step(params: Sequence[torch.Tensor], grads: Grads, lr: float) -> None:
    """p -= lr * g for every parameter with a gradient, lr taken in the
    gradient's dtype first (JAX's weak typing rounds it to bf16 for a bf16
    gradient; ``full`` keeps it off the host-to-device copy path)."""
    for p, g in zip(params, grads, strict=True):
        if g is not None:
            p.sub_(g * g.new_full((), lr))


@dataclass
class SGD:
    lr: float = 0.01

    def step(self, params: Sequence[torch.Tensor], grads: Grads) -> None:
        sgd_step(params, grads, self.lr)


class AdamState(NamedTuple):
    """First and second moments (f32, one per parameter, ``None`` for a
    frozen leaf) and the step count."""
    m: List[Optional[torch.Tensor]]
    v: List[Optional[torch.Tensor]]
    t: int


def adam_init(params: Sequence[Optional[torch.Tensor]]) -> AdamState:
    z = lambda p: None if p is None else torch.zeros_like(p, dtype=torch.float32)
    return AdamState(m=[z(p) for p in params], v=[z(p) for p in params], t=0)


def _bias_correction(b: float, t: int) -> float:
    """1 - b ** t, computed in f32 (JAX's ``1.0 - b ** t.astype(f32)``)."""
    f32 = torch.float32
    return float(1.0 - torch.pow(torch.tensor(b, dtype=f32), torch.tensor(t, dtype=f32)))


@torch.no_grad()
def adam_step(params: Sequence[torch.Tensor], grads: Grads, state: AdamState,
              lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
              weight_decay: float = 0.0) -> AdamState:
    """One Adam update with decoupled weight decay, in place; returns the
    new state (the same moment tensors, the step count advanced)."""
    t = state.t + 1
    bc1, bc2 = _bias_correction(b1, t), _bias_correction(b2, t)
    for p, g, m, v in zip(params, grads, state.m, state.v, strict=True):
        if g is None:
            continue
        g32 = g.to(torch.float32)
        m.mul_(b1).add_(g32, alpha=1 - b1)
        v.mul_(b2).addcmul_(g32, g32, value=1 - b2)
        step = (m / bc1).mul_(lr).div_((v / bc2).sqrt_().add_(eps))
        if weight_decay:
            step.add_(p.to(torch.float32), alpha=lr * weight_decay)
        p.sub_(step.to(p.dtype))
    return AdamState(m=state.m, v=state.v, t=t)


@dataclass
class Adam:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params: Sequence[Optional[torch.Tensor]]) -> AdamState:
        return adam_init(params)

    def step(self, params: Sequence[torch.Tensor], grads: Grads,
             state: AdamState) -> AdamState:
        return adam_step(params, grads, state, lr=self.lr, b1=self.b1, b2=self.b2,
                         eps=self.eps, weight_decay=self.weight_decay)
