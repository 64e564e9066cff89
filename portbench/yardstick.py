"""The yardstick: the card's peaks and the work the served tokens need.

Peaks are the H100 SXM's published dense rates at its 700 W limit (copied
from ``chip_smoke.py``: ``HBM_BPS``, ``INT8_OPS``, ``BF16_FLOPS`` and
``bound``). The counts are of the work the inputs need, whatever kernel
does it: rows of idle slots, of tokens decoded past a request's finish and
of bucket padding are not counted, and a prefill needs the head's product
for its last position only. A prompt's leading pages that a prefix cache
holds (``skip``) need no prefill.

Per linear of K inputs and N outputs at m rows: 2 m K N int8 operations;
bytes as ``chip_smoke.py``'s ``gemv_bounds`` / ``tile_bounds`` count them:
bf16 x read once, the int8 codes and the f32 column scales once, the f32
output written once. Decode attention per row at a context of c positions,
per layer: each KV head's K and V codes and f32 scales of c positions read
once and q and the output (bf16) once (``chip_smoke.py``'s
``decode_attn_bytes``), 4 c H Dh bf16 operations; a prefill row at
position i does 4 (i + 1) H Dh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Tuple

HBM_BPS = 3.35e12
INT8_OPS = 1979e12
BF16_FLOPS = 989e12


def bound_s(bytes_moved: float, ops: float, peak_ops: float) -> float:
    """Least seconds for the work on the card (the larger roof)."""
    return max(bytes_moved / HBM_BPS, ops / peak_ops)


@dataclass
class Work:
    """Work of some forward passes: all operations (``ops``), the least
    seconds of their linears on K1's roofline (``gemm_s``) and of their
    decode attention (``attn_s``)."""
    ops: float = 0.0
    gemm_s: float = 0.0
    attn_s: float = 0.0

    def add(self, other: "Work") -> None:
        self.ops += other.ops
        self.gemm_s += other.gemm_s
        self.attn_s += other.attn_s


class Model:
    """The counts of one GPT configuration (``configs/<config>.json``
    ``model``)."""

    def __init__(self, model: dict):
        d, h = int(model["d_model"]), int(model["n_heads"])
        self.d, self.h = d, h
        self.hkv = int(model.get("n_kv_heads") or h)
        self.dh = d // h
        self.layers = int(model["n_layers"])
        self.vocab = int(model["vocab_size"])
        ff, dkv = int(model["d_ff"]), self.hkv * self.dh
        self.linears: List[Tuple[int, int]] = [(d, d), (d, dkv), (d, dkv), (d, d), (d, ff),
                                               (ff, d)]
        self.head = (d, self.vocab)

    @staticmethod
    def _linear(m: int, k: int, n: int) -> Tuple[float, float]:
        ops = 2.0 * m * k * n
        return ops, bound_s(m * k * 2 + k * n + n * 4 + m * n * 4, ops, INT8_OPS)

    def linears_work(self, m: int, head_rows: int) -> Work:
        """Every layer's linears at ``m`` rows and the head at ``head_rows``."""
        w = Work()
        if m <= 0:
            return w
        for k, n in self.linears:
            ops, s = self._linear(m, k, n)
            w.ops += self.layers * ops
            w.gemm_s += self.layers * s
        if head_rows > 0:
            ops, s = self._linear(head_rows, *self.head)
            w.ops += ops
            w.gemm_s += s
        return w

    def decode_step(self, contexts: Iterable[int]) -> Work:
        """One decode step whose needed rows attend ``contexts`` positions."""
        ctx = list(contexts)
        w = self.linears_work(len(ctx), len(ctx))
        if not ctx:
            return w
        tot = sum(ctx)
        attn_ops = self.layers * 4.0 * tot * self.h * self.dh
        attn_bytes = self.layers * (self.hkv * 2.0 * tot * (self.dh + 4)
                                    + len(ctx) * 2 * self.h * self.dh * 2)
        w.ops += attn_ops
        w.attn_s += bound_s(attn_bytes, attn_ops, BF16_FLOPS)
        return w

    def prefill(self, plen: int, skip: int) -> Work:
        """A prompt of ``plen`` tokens whose first ``skip`` are cached."""
        rows = plen - skip
        w = self.linears_work(rows, 1)
        # sum of (i + 1) for i in [skip, plen)
        pairs = (plen * (plen + 1) - skip * (skip + 1)) // 2
        w.ops += self.layers * 4.0 * pairs * self.h * self.dh
        return w
