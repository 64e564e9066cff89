"""Wrappers of kernel K5 (``csrc/paged_decode_attention.cu``): one decode step
of attention over the paged int8 or int4 KV cache.

Two entries keep the JAX package's signatures and both launch K5:
``paged_decode_attention`` replaces ``paged_decode_attention`` /
``_paged_kernel`` and ``paged_decode_attention_ragged`` replaces
``paged_decode_attention_ragged`` / ``_ragged_kernel`` of
``qgemm_tpu/ops/pallas/paged_attention.py``. The step tables are the TPU
grid's schedule: the ragged entry checks their shapes (the engine checks
what they hold where it builds them, on the host) and K5 does not read
them. Each entry counts its own
launches. K5 splits each slot's pages across blocks (flash-decoding) on
the plan of ``paged_plan.k5_plan``; the last block of a (slot, KV head)
merges the splits' partial states, kept in a scratch tensor this wrapper
allocates, and counts on the merge counters of the device and stream
(``split_decode.merge_counters``, shared with K2). The source note in the
.cu file says what bounds K5 and how it is built.
"""

from __future__ import annotations

import ctypes
import math

import torch

from qgemm_tpu_torch.ops.cuda import _build
from qgemm_tpu_torch.ops.cuda.paged_plan import k5_args
from qgemm_tpu_torch.ops.cuda.split_decode import Q_DTYPES, aligned, kernel_q, merge_counters
from qgemm_tpu_torch.ops.validation import (check, check_aligned16, check_rank, pad_last,
                                            padded_head_dim)
from qgemm_tpu_torch.serving.paged_cache import PagedKVCache, paged_attention_reference


def check_paged_pool(cache: PagedKVCache) -> None:
    """Shapes and dtypes of a paged cache's pools, scales and page table."""
    ps = cache.page_size
    check(cache.kv_bits in (4, 8), f"kv_bits must be 4 or 8, got {cache.kv_bits}")
    rows = ps if cache.kv_bits == 8 else ps // 2
    for name, t in (("kq", cache.kq), ("vq", cache.vq)):
        check_rank(name, t, 4)
        check(t.dtype == torch.int8 and t.shape == cache.kq.shape and t.shape[2] == rows,
              f"{name}: expected int8 [P, Hkv, {rows}, D], got {t.dtype} {tuple(t.shape)}")
    want = (cache.kq.shape[0], cache.kq.shape[1], 1, ps)
    for name, t in (("kc", cache.kc), ("vc", cache.vc)):
        check(t.dtype == torch.float32 and tuple(t.shape) == want,
              f"{name}: expected float32 {want}, got {t.dtype} {tuple(t.shape)}")
    check_rank("page_table", cache.page_table, 2)


def check_kernel_args(q: torch.Tensor, cache: PagedKVCache, tensors) -> None:
    """What K5 and K6 take on the card, beyond the shapes: raises on the
    rest rather than running wrong."""
    ps = cache.page_size
    check(q.dtype in Q_DTYPES, f"the paged kernels take float32 or bfloat16 q, got {q.dtype} "
          "(the wrappers pass other float dtypes in float32)")
    check(ps >= 1 and (cache.kv_bits == 8 or ps % 2 == 0),
          f"the paged kernels take any page size >= 1 (int4 pools: even), got {ps}")
    check(all(t.is_cuda and t.device == q.device for t in tensors),
          "paged attention: q, pools, scales, page table and lengths must lie on "
          "q's CUDA device")
    check(cache.page_table.dtype == torch.int32 and cache.page_table.is_contiguous(),
          "page_table: the paged kernels read a contiguous int32 table")
    check_aligned16("paged attention pools", cache.kq, cache.vq, cache.kc, cache.vc)


def check_args(q: torch.Tensor, cache: PagedKVCache, lengths: torch.Tensor) -> None:
    """q [B, Hq, Sq, D] against the cache (Hq a multiple of the pool heads)
    and lengths [B]: what K5 and K6 share."""
    check_paged_pool(cache)
    check_rank("q", q, 4)
    b, hq = q.shape[0], q.shape[1]
    check(b == cache.page_table.shape[0] and hq % cache.kq.shape[1] == 0
          and q.shape[3] == cache.kq.shape[3],
          f"q {tuple(q.shape)} incompatible with pools {tuple(cache.kq.shape)} and "
          f"page table {tuple(cache.page_table.shape)}")
    check(tuple(lengths.shape) == (b,),
          f"lengths: expected shape ({b},), got {tuple(lengths.shape)}")


def _check(q, cache, lengths):
    check_args(q, cache, lengths)
    check(q.shape[2] == 1, f"q: decode step expects Sq == 1, got {tuple(q.shape)}")


def _lib():
    fn = _build.library("paged_decode_attention").qgemm_paged_decode_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 10 + [i] * 9 + [ctypes.c_float, i, i, i, p]
        fn.restype = i
    return fn


def _launch(q: torch.Tensor, cache: PagedKVCache, lengths: torch.Tensor, entry) -> torch.Tensor:
    dtype, q = q.dtype, kernel_q(q)
    b, hq, _, d = q.shape
    hkv = cache.kq.shape[1]
    g = hq // hkv
    pt = cache.page_table
    check_kernel_args(q, cache, (cache.kq, cache.kc, cache.vq, cache.vc, pt, lengths))
    dp = padded_head_dim(d)
    ps, pps = cache.page_size, pt.shape[1]
    split_pages, nsplit, smem, n_scratch = k5_args(cache.kv_bits, dp, d, g, ps, pps, b, hkv)
    qk = aligned(pad_last(q[:, :, 0], dp))   # the per-call q; never the pools
    lens = lengths.to(torch.int32).contiguous()
    kq, kc, vq, vc = (t.contiguous() for t in (cache.kq, cache.kc, cache.vq, cache.vc))
    out = torch.empty((b, hq, dp), dtype=q.dtype, device=q.device)
    scratch = torch.empty((n_scratch,), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counters = merge_counters(q.device, stream, b * hkv)
    rc = _lib()(qk.data_ptr(), kq.data_ptr(), kc.data_ptr(), vq.data_ptr(), vc.data_ptr(),
                pt.data_ptr(), lens.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                counters.data_ptr(), Q_DTYPES[q.dtype], cache.kv_bits, b, hkv, g, dp, d, ps,
                pps, 1.0 / math.sqrt(d), split_pages, nsplit, smem, stream)
    _build.check_launch("qgemm_paged_decode_attention", rc)
    entry.launches += 1
    return out[:, :, None, :d].to(dtype)


def paged_decode_attention(q: torch.Tensor, cache: PagedKVCache,
                           lengths: torch.Tensor) -> torch.Tensor:
    """q [B, Hq, 1, D]; cache a ``PagedKVCache`` with Hq a multiple of its
    pool heads (GQA); lengths [B], position j of slot b attends iff j <
    lengths[b]. Returns [B, Hq, 1, D] in q's dtype. CPU tensors run the
    plain version in float32 (the JAX package's CPU path); CUDA tensors
    launch K5 (D <= 1024, any g, any page; float32 or bfloat16 q, other
    float dtypes through float32) or raise."""
    _check(q, cache, lengths)
    if not q.is_cuda:
        return paged_attention_reference(q, cache, lengths, compute_dtype=torch.float32)
    return _launch(q, cache, lengths, paged_decode_attention)


def _check_step_table_shapes(cache: PagedKVCache) -> None:
    """Two int32 [T] tables of one shape. What they hold (every slot
    present, pages in range) is checked where they are built
    (``paged_cache.check_step_tables``, once per engine rebuild), not here
    at every layer of every step."""
    ss, sp = cache.step_slot, cache.step_page
    check(ss is not None and sp is not None,
          "paged_decode_attention_ragged needs the cache's step tables")
    check(ss.ndim == 1 and ss.shape == sp.shape and ss.shape[0] > 0
          and ss.dtype == sp.dtype == torch.int32,
          f"step tables: expected two int32 [T] tables, got {ss.dtype} "
          f"{tuple(ss.shape)} and {sp.dtype} {tuple(sp.shape)}")


def paged_decode_attention_ragged(q: torch.Tensor, cache: PagedKVCache,
                                  lengths: torch.Tensor) -> torch.Tensor:
    """``paged_decode_attention`` for a cache that carries step tables (the
    engine's): checks their shapes, then the same plain version on CPU
    tensors or K5 on CUDA tensors."""
    _check(q, cache, lengths)
    _check_step_table_shapes(cache)
    if not q.is_cuda:
        return paged_attention_reference(q, cache, lengths, compute_dtype=torch.float32)
    return _launch(q, cache, lengths, paged_decode_attention_ragged)


paged_decode_attention.launches = 0
paged_decode_attention_ragged.launches = 0
