"""What the wrappers of the decode kernels on the split body of
``csrc/split_decode.cuh`` share: K2 (``decode_attention``, the dense int8
cache) and K5 (``paged_decode_attention``, the paged pools); K6
(``paged_context_attention``) takes q the same way.

The kernels read q in float32 or bfloat16 and write the output in q's
dtype; the wrappers pass other float dtypes through float32. The last
block of each (slot, KV head) merges the splits' partial states after
counting itself on a counter of a persistent int32 buffer, one per device
and stream, that every call leaves at zero.
"""

from __future__ import annotations

import torch

# q's dtypes the kernels take, and the code their C entries know them by
Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def kernel_q(q: torch.Tensor) -> torch.Tensor:
    """q as the kernels take it: itself in float32 or bfloat16, another
    float dtype (float16, float64) in float32, whose output the wrapper
    casts back to q's dtype."""
    return q if q.dtype in Q_DTYPES else q.to(torch.float32)


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` (contiguous) itself, or a copy where its data does not start on
    the 16-byte boundary the kernels' vector loads of q need."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


# (device, stream) -> int32 counters of the split merge, left at 0 by every
# call of K2 or K5. One buffer a stream, allocated outside the launch: the
# blocks of two launches running at once on two streams would otherwise
# count on the same (slot, KV head) counters. K2 and K5 launched one after
# the other on one stream share it.
_counters = {}


def merge_counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The merge counters of ``device`` and ``stream`` (its CUDA handle), at
    least ``n`` of them."""
    buf = _counters.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros((max(n, 256),), dtype=torch.int32, device=device)
        _counters[(device, stream)] = buf
    return buf
