"""Token embedding + sinusoidal positional encoding (port of
``qgemm_tpu/models/embedding.py``)."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from qgemm_tpu_torch.utils.prng import normal_init


def sinusoidal_positions(max_len: int, d_model: int,
                         dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """Classic fixed sin/cos table [max_len, d_model] (computed in float64)."""
    pos = np.arange(max_len)[:, None].astype(np.float64)
    dim = np.arange(0, d_model, 2).astype(np.float64)
    inv_freq = 1.0 / (10000.0 ** (dim / d_model))
    angles = pos * inv_freq[None, :]
    table = np.zeros((max_len, d_model))
    table[:, 0::2] = np.sin(angles)
    table[:, 1::2] = np.cos(angles[:, : d_model // 2])
    return torch.as_tensor(table).to(dtype=dtype, device=device)


class Embedding(nn.Module):
    def __init__(self, table: torch.Tensor, pos: torch.Tensor):
        super().__init__()
        self.table = nn.Parameter(table, requires_grad=False)  # [vocab, d]
        self.register_buffer("pos", pos)                       # [max_len, d]

    @classmethod
    def init(cls, generator: torch.Generator, vocab_size: int, d_model: int,
             max_len: int, dtype: torch.dtype = torch.float32) -> "Embedding":
        table = normal_init(generator, (vocab_size, d_model), 1.0 / (d_model ** 0.5),
                            dtype)
        return cls(table, sinusoidal_positions(max_len, d_model, dtype,
                                               generator.device))

    def lookup(self, tokens: torch.Tensor) -> torch.Tensor:
        """Out-of-vocab ids clamp (JAX ``take(mode="clip")``)."""
        return self.table[tokens.clamp(0, self.table.shape[0] - 1)]

    def positions(self, pos: torch.Tensor) -> torch.Tensor:
        """Rows of the positional table at ``pos``, clamped into it."""
        return self.pos[pos.clamp(0, self.pos.shape[0] - 1)]

    def forward(self, tokens: torch.Tensor, offset: int = 0) -> torch.Tensor:
        """tokens [B, S] -> [B, S, D] with positions offset..offset+S-1."""
        s = tokens.shape[-1]
        tab = self.pos
        if s > tab.shape[0]:
            # a prefill bucket may exceed the table; the rows past it are
            # prompt padding (masked by true length), so zero-extend
            tab = torch.cat([tab, tab.new_zeros((s, tab.shape[1]))])
        # a slice start clamps so the slice fits (JAX dynamic_slice)
        start = min(max(int(offset), 0), tab.shape[0] - s)
        return self.lookup(tokens) + tab[start:start + s]
