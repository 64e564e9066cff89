"""Row-wise numerically stable softmax (port of ``qgemm_tpu/ops/softmax.py``):
max-subtract, exp, normalize — the three steps of the reference kernel."""

from __future__ import annotations

import torch


def softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    m = x.amax(dim=axis, keepdim=True)
    e = torch.exp(x - m)
    return e / e.sum(dim=axis, keepdim=True)
