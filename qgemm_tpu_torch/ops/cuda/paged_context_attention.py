"""Wrapper of kernel K6 (``csrc/paged_context_attention.cu``): chunk attention
over the paged int8 or int4 KV cache, causal at a per-slot offset.

Replaces ``paged_context_attention`` / ``_context_kernel`` of
``qgemm_tpu/ops/pallas/paged_attention.py``. The TPU kernel takes int8 pools
only, and the JAX model path keeps its gather oracle for chunks; in the
port K6 serves every paged chunk, int8 and int4 pools alike, so no plain
version runs on the card's main path. K6 runs on the plan of
``paged_plan.k6_plan``. The source note in the .cu file says what bounds it
and how it is built.
"""

from __future__ import annotations

import ctypes
import math

import torch

from qgemm_tpu_torch.ops.cuda import _build
from qgemm_tpu_torch.ops.cuda.paged_decode_attention import check_args, check_kernel_args
from qgemm_tpu_torch.ops.cuda.paged_plan import K6_HEAD_DIMS, k6_args, k6_width
from qgemm_tpu_torch.ops.cuda.split_decode import Q_DTYPES, aligned, kernel_q
from qgemm_tpu_torch.ops.kv_cache import QRANGE
from qgemm_tpu_torch.ops.validation import check, pad_last
from qgemm_tpu_torch.serving.paged_cache import (PagedKVCache,
                                                 paged_context_attention_reference)


def _lib(wide: bool = False):
    lib = _build.library("paged_context_attention")
    fn = lib.qgemm_paged_context_attention_wide if wide else lib.qgemm_paged_context_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * 8 + [i, p] + [i] * 10 + [ctypes.c_float, i, p] if wide
                       else [p] * 8 + [i, p] + [i] * 10 + [ctypes.c_float, i, i, i, p])
        fn.restype = i
    return fn


def paged_context_attention(q: torch.Tensor, cache: PagedKVCache, lengths: torch.Tensor,
                            offset) -> torch.Tensor:
    """q [B, Hq, C, D], rows at positions offset..offset+C-1 (``offset`` an
    int or [B]), attend every cached position <= their own and <
    lengths[b]; the chunk's K/V must already be written. Hq a multiple of
    the pool heads (GQA). Returns [B, Hq, C, D] in q's dtype. CPU tensors
    run the plain version in float32 (the JAX package's CPU path); CUDA
    tensors launch K6 (any page; D up to 256 on the tensor cores, past it
    the wide kernel, to 1,024; float32 or bfloat16 q, other float dtypes
    through float32) or raise."""
    check_args(q, cache, lengths)
    b, hq, c, d = q.shape
    hkv = cache.kq.shape[1]
    if not q.is_cuda:
        return paged_context_attention_reference(q, cache, lengths, offset,
                                                 compute_dtype=torch.float32)
    dtype, q = q.dtype, kernel_q(q)
    offs, offset0 = None, 0
    if isinstance(offset, torch.Tensor):
        check(offset.numel() in (1, b), f"offset: expected 1 or {b} values, got "
              f"{tuple(offset.shape)}")
        offs = offset.reshape(-1).to(device=q.device, dtype=torch.int32).expand(b).contiguous()
    else:
        offset0 = int(offset)     # one offset for every slot: passed by value
    pt = cache.page_table
    check_kernel_args(q, cache, (cache.kq, cache.kc, cache.vq, cache.vc, pt, lengths))
    rows = (hq // hkv) * c
    dp = k6_width(d)
    block_rows, key_tile, smem = k6_args(cache.kv_bits, dp, d, cache.page_size, pt.shape[1],
                                         b, hkv, rows)
    qk = aligned(pad_last(q.reshape(b, hkv, rows, d), dp))   # the per-call q; never the pools
    lens = lengths.to(torch.int32).contiguous()
    kq, kc, vq, vc = (t.contiguous() for t in (cache.kq, cache.kc, cache.vq, cache.vc))
    out = torch.empty((b, hkv, rows, dp), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if dp > K6_HEAD_DIMS[-1]:   # the wide kernel: kc over the plain version's f32 127 sqrt(d)
        kden = float(torch.tensor(QRANGE * d ** 0.5, dtype=torch.float32))
        rc = _lib(True)(qk.data_ptr(), kq.data_ptr(), kc.data_ptr(), vq.data_ptr(),
                        vc.data_ptr(), pt.data_ptr(), lens.data_ptr(),
                        0 if offs is None else offs.data_ptr(), offset0, out.data_ptr(),
                        Q_DTYPES[q.dtype], cache.kv_bits, b, hkv, c, rows, dp, d,
                        cache.page_size, pt.shape[1], kden, smem, stream)
        _build.check_launch("qgemm_paged_context_attention_wide", rc)
    else:
        rc = _lib()(qk.data_ptr(), kq.data_ptr(), kc.data_ptr(), vq.data_ptr(), vc.data_ptr(),
                    pt.data_ptr(), lens.data_ptr(), 0 if offs is None else offs.data_ptr(),
                    offset0, out.data_ptr(), Q_DTYPES[q.dtype], cache.kv_bits, b, hkv, c, rows,
                    dp, d, cache.page_size, pt.shape[1], 1.0 / math.sqrt(d), block_rows,
                    key_tile, smem, stream)
        _build.check_launch("qgemm_paged_context_attention", rc)
    paged_context_attention.launches += 1
    return out[..., :d].reshape(b, hq, c, d).to(dtype)


paged_context_attention.launches = 0
