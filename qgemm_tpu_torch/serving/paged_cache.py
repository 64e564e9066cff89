"""Paged KV cache: block-table indirection over a fixed page pool (port of
``qgemm_tpu/serving/paged_cache.py``).

The dense cache allocates ``max_slots x max_seq_len`` rows up front. Here
the cache is a pool of fixed-size pages plus a per-slot page table, and
pages are allocated on demand as sequences grow, so device memory scales
with the tokens actually resident. K/V are stored int8 (or int4, two codes
per byte) with per-position absmax scales, as in ``ops/kv_cache.py``.

Layout, as in the JAX package: pools ``[P, Hkv, page, D]`` (int4:
``[P, Hkv, page/2, D]``, page positions r and r + page/2 paired in one
byte), scales ``[P, Hkv, 1, page]`` f32, page table ``[B, pps]`` int32.
Page 0 is the reserved null page: unallocated table entries hold 0, and
attention masks strictly by per-slot length, so it is never read.

The writers update the pools in place (the JAX versions return new
arrays). A write whose logical page lies past the page table writes
nothing (a whole page) or the null page (one decode row); it never wraps.

``paged_attention_reference`` and ``paged_context_attention_reference``
are the plain versions of kernels K5 and K6 (``ops/cuda/``). Their compute
dtype is an argument: float32 reproduces the JAX package's CPU path, bf16
rounds where K5 and K6 round (q, and p x vc/127, to bf16; products summed
in f32). The default picks by device, as JAX picks by backend.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from qgemm_tpu_torch.device import DeviceLike, resolve_device
from qgemm_tpu_torch.ops.kv_cache import (QRANGE, pack_int4_rows, quantize_kv,
                                          quantize_kv_int4, unpack_int4_rows)
from qgemm_tpu_torch.ops.softmax import softmax

PAGE_SIZE = 128
# pages per step of the JAX ragged kernel's schedule (its RAGGED_UNROLL)
PAGES_PER_STEP = 2
_NEG = -1e30


@dataclass
class PagedKVCache:
    """One layer's paged cache.

    kq/vq: int8 pools [P, Hkv, page, D] (int4-packed: [P, Hkv, page/2, D]);
    kc/vc: f32 scales [P, Hkv, 1, page], positions on the last axis.
    page_table: int32 [B, pps] — logical page j of slot b lives in physical
    page page_table[b, j]. step_slot/step_page: optional int32 [T] tables
    from ``build_step_tables`` (the JAX ragged kernel's schedule); with them
    decode goes through the ragged entry of K5. K5 does not read them, so
    the engine keeps them on the host. ``kv_bits`` 4 = int4 pools whose
    scales keep the int8 convention (pre-multiplied by 127/7)."""
    kq: torch.Tensor
    kc: torch.Tensor
    vq: torch.Tensor
    vc: torch.Tensor
    page_table: torch.Tensor
    step_slot: Optional[torch.Tensor] = None
    step_page: Optional[torch.Tensor] = None
    page_size: int = PAGE_SIZE
    kv_bits: int = 8

    @property
    def n_pages(self) -> int:
        return self.kq.shape[0]


def build_step_tables(alloc_counts, pages_per_slot: int, bucket: int = 16,
                      pages_per_step: int = PAGES_PER_STEP):
    """Host-side ragged-grid tables from per-slot ALLOCATED page counts:
    (step_slot, step_page) int32 numpy arrays of length T, the step count
    rounded up to ``bucket``. One step covers ``pages_per_step`` logical
    pages; every slot has at least its page-0 step; tail padding repeats
    the last slot with step_page == pages_per_slot (always invalid)."""
    ss, sp = [], []
    for b, n in enumerate(alloc_counts):
        n = max(1, int(n))
        pages = range(0, n, pages_per_step)
        ss.extend([b] * len(pages))
        sp.extend(pages)
    t = -(-len(ss) // bucket) * bucket
    pad = t - len(ss)
    ss.extend([ss[-1]] * pad)
    sp.extend([pages_per_slot] * pad)
    return np.asarray(ss, np.int32), np.asarray(sp, np.int32)


def check_step_tables(step_slot, step_page, batch: int, pages_per_slot: int) -> None:
    """The ragged schedule's invariants (host [T] tables, as
    ``build_step_tables`` makes them): slots in order and every slot
    0..batch-1 present, logical pages in [0, pages_per_slot]. Raises
    ``ValueError``. The engine checks its tables here once per rebuild, so
    the per-layer ragged entry checks only their shapes."""
    ss, sp = np.asarray(step_slot), np.asarray(step_page)
    if not (ss.size and ss.min() >= 0 and ss.max() < batch and (np.diff(ss) >= 0).all()
            and (np.bincount(ss, minlength=batch) > 0).all()):
        raise ValueError(f"step_slot: every slot 0..{batch - 1} must have a step, in order")
    if not (sp.min() >= 0 and sp.max() <= pages_per_slot):
        raise ValueError(f"step_page: logical pages must lie in [0, {pages_per_slot}]")


def check_kv_bits(kv_bits: int, page_size: int) -> None:
    """int8 or int4 pools; int4 pairs page positions, so its page is even."""
    if kv_bits not in (4, 8):
        raise ValueError(f"kv_bits={kv_bits}: paged pools are int8 (8) or int4 (4)")
    if kv_bits == 4 and page_size % 2:
        raise ValueError(f"kv_bits=4 pairs page positions r and r + page/2 in one "
                         f"byte, so page_size must be even, got {page_size}")


def init_paged_cache(n_heads: int, head_dim: int, n_pages: int, batch: int,
                     pages_per_slot: int, page_size: int = PAGE_SIZE,
                     kv_bits: int = 8, device: DeviceLike = None) -> PagedKVCache:
    """Zero pools, unit scales and an all-null page table on ``device``
    (default: the GPU — raises without one)."""
    check_kv_bits(kv_bits, page_size)
    dev = resolve_device(device)
    rw = page_size if kv_bits == 8 else page_size // 2      # packed rows
    z8 = lambda: torch.zeros((n_pages, n_heads, rw, head_dim), dtype=torch.int8,
                             device=dev)
    ones = lambda: torch.ones((n_pages, n_heads, 1, page_size), dtype=torch.float32,
                              device=dev)
    return PagedKVCache(kq=z8(), kc=ones(), vq=z8(), vc=ones(),
                        page_table=torch.zeros((batch, pages_per_slot), dtype=torch.int32,
                                               device=dev),
                        page_size=page_size, kv_bits=kv_bits)


class PageAllocator:
    """Host-side page free list and PREFIX CACHE (pure Python, as in the JAX
    package). Page 0 is reserved as the null page.

    A full prompt page's content is a pure function of its token chunk and
    positions, so identical prompt prefixes share physical pages, found by
    a hash chain over the page chunks. Pages are refcounted; published
    pages whose refcount drops to zero go to an LRU cache instead of the
    free list, and are evicted only when the free list runs dry."""

    def __init__(self, n_pages: int, batch: int, pages_per_slot: int):
        self.free: List[int] = list(range(n_pages - 1, 0, -1))  # 0 reserved
        self.slot_pages: List[List[int]] = [[] for _ in range(batch)]
        self.pages_per_slot = pages_per_slot
        self.refs = {}          # page -> live refcount
        self.page_hash = {}     # published page -> chain hash
        self.prefix_map = {}    # chain hash -> page
        self.cached = OrderedDict()  # refcount-0 published pages (LRU)
        self.prefix_hits = 0

    @property
    def n_free(self) -> int:
        """Allocatable pages: the free list plus evictable cached pages."""
        return len(self.free) + len(self.cached)

    def pages_needed(self, n_tokens: int, page_size: int = PAGE_SIZE) -> int:
        return -(-n_tokens // page_size)

    def _take_page(self) -> int:
        if self.free:
            return self.free.pop()
        if self.cached:                     # evict the LRU cached prefix
            page, _ = self.cached.popitem(last=False)
            h = self.page_hash.pop(page)
            del self.prefix_map[h]
            return page
        raise RuntimeError("page pool exhausted")

    def grow(self, slot: int, n_tokens: int, page_size: int = PAGE_SIZE) -> List[tuple]:
        """Ensure ``slot`` has pages for ``n_tokens``; returns the newly
        allocated (logical_index, physical_page) entries. Raises (taking
        nothing) if the slot's table or the pool cannot hold them."""
        need = self.pages_needed(n_tokens, page_size)
        have = len(self.slot_pages[slot])
        if need > self.pages_per_slot:
            raise RuntimeError(f"slot {slot}: page table full ({need})")
        if need - have > self.n_free:
            raise RuntimeError("page pool exhausted")
        new = []
        while len(self.slot_pages[slot]) < need:
            j = len(self.slot_pages[slot])
            p = self._take_page()
            self.refs[p] = 1
            self.slot_pages[slot].append(p)
            new.append((j, p))
        return new

    def acquire_shared(self, slot: int, h) -> Optional[int]:
        """Attach the page published under chain-hash ``h`` (if any) as the
        slot's next logical page: refcount + 1, resurrected from the LRU if
        idle. Returns its id, or None."""
        page = self.prefix_map.get(h)
        if page is None:
            return None
        if page in self.cached:
            del self.cached[page]
        self.refs[page] = self.refs.get(page, 0) + 1
        self.slot_pages[slot].append(page)
        self.prefix_hits += 1
        return page

    def peek_prefix(self, hashes) -> int:
        """Length of the longest contiguous published prefix of the hash
        chain (acquires nothing)."""
        n = 0
        for h in hashes:
            if h not in self.prefix_map:
                break
            n += 1
        return n

    def peek_prefix_cached(self, hashes, n_match: int) -> int:
        """How many of the first ``n_match`` matched pages are idle in the
        LRU: acquiring them takes them out of ``n_free``."""
        return sum(1 for h in hashes[:n_match] if self.prefix_map[h] in self.cached)

    def reset_prefix_cache(self) -> None:
        """Drop every published mapping and free the idle cached pages."""
        self.free.extend(self.cached.keys())
        self.cached.clear()
        self.prefix_map.clear()
        self.page_hash.clear()

    def publish(self, slot: int, j: int, h) -> None:
        """Register the slot's logical page ``j`` under chain-hash ``h``.
        First publisher wins."""
        page = self.slot_pages[slot][j]
        if h in self.prefix_map or page in self.page_hash:
            return
        self.prefix_map[h] = page
        self.page_hash[page] = h

    def release(self, slot: int) -> None:
        for p in self.slot_pages[slot]:
            self.refs[p] = self.refs.get(p, 1) - 1
            if self.refs[p] <= 0:
                del self.refs[p]
                if p in self.page_hash:
                    self.cached[p] = None   # kept for future prefix hits
                else:
                    self.free.append(p)
        self.slot_pages[slot] = []


def _quantizer(cache: PagedKVCache):
    return quantize_kv_int4 if cache.kv_bits == 4 else quantize_kv


def paged_write_step(cache: PagedKVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                     positions: torch.Tensor) -> PagedKVCache:
    """Write one decode step's K/V in place. k_new/v_new [B, Hkv, 1, D];
    positions [B], the positions being written. A position whose logical
    page lies past the table writes the null page."""
    ps = cache.page_size
    pt = cache.page_table
    pps = pt.shape[1]
    pos = positions.to(device=pt.device, dtype=torch.int64)
    logical = pos // ps
    phys = pt.gather(1, logical.clamp(0, pps - 1)[:, None])[:, 0].to(torch.int64)
    phys = torch.where(logical < pps, phys, torch.zeros_like(phys))
    off = pos % ps
    qrows = _quantizer(cache)
    hp = ps // 2
    for pool, scales, x in ((cache.kq, cache.kc, k_new), (cache.vq, cache.vc, v_new)):
        vals, c = qrows(x[:, :, 0, :])                          # [B, H, D], [B, H, 1]
        if cache.kv_bits == 4:
            # the written position shares its byte-row with its pair:
            # merge its nibble into the resident byte
            row = off % hp
            hi = (off >= hp)[:, None, None]
            old = pool[phys, :, row].to(torch.int32)             # [B, H, D]
            nib = vals.to(torch.int32) & 0xF
            merged = torch.where(hi, (old & 0x0F) | (nib << 4), (old & ~0xF) | nib)
            pool[phys, :, row] = (((merged + 128) & 0xFF) - 128).to(torch.int8)
        else:
            pool[phys, :, off] = vals
        scales[:, :, 0][phys, :, off] = c[..., 0]
    return cache


def _page_major(x: torch.Tensor, n: int, ps: int) -> torch.Tensor:
    """[H, S, X] -> its first n pages as [n, H, ps, X]."""
    h = x.shape[0]
    return x[:, :n * ps].reshape(h, n, ps, x.shape[-1]).transpose(0, 1)


def paged_write_prompt(cache: PagedKVCache, slot: int, k_prompt: torch.Tensor,
                       v_prompt: torch.Tensor, first_page: int = 0) -> PagedKVCache:
    """Prefill: write a bucket-padded prompt segment's K/V for one slot in
    place, from logical page ``first_page`` on (0 = the whole prompt; > 0 =
    the suffix after prefix-cache pages). k_prompt/v_prompt [Hkv, S, D],
    S a multiple of the page size. Rows past the true prompt length are
    junk that attention never reads; pages past the table are not
    written."""
    ps = cache.page_size
    h, s_bucket, _ = k_prompt.shape
    if s_bucket % ps:
        raise ValueError(f"prompt segment of {s_bucket} rows is not a whole number "
                         f"of {ps}-row pages")
    n = max(0, min(s_bucket // ps, cache.page_table.shape[1] - first_page))
    if n == 0:
        return cache
    phys = cache.page_table[slot, first_page:first_page + n].to(torch.int64)
    qrows = _quantizer(cache)
    for pool, scales, x in ((cache.kq, cache.kc, k_prompt), (cache.vq, cache.vc, v_prompt)):
        vals, c = qrows(x)                                      # [H, S, D], [H, S, 1]
        vals = _page_major(vals, n, ps)                         # [n, H, ps, D]
        if cache.kv_bits == 4:
            vals = pack_int4_rows(vals, axis=2)
        pool[phys] = vals
        scales[phys] = _page_major(c, n, ps)[..., 0][:, :, None, :]
    return cache


def paged_write_prompt_batch(cache: PagedKVCache, k_prompts: torch.Tensor,
                             v_prompts: torch.Tensor) -> PagedKVCache:
    """Prefill every slot at once, in place: k/v_prompts [B, Hkv, S, D], S a
    multiple of the page size. One scatter per logical page; slots whose
    entry is 0 write the null page."""
    ps = cache.page_size
    n_log = min(k_prompts.shape[2] // ps, cache.page_table.shape[1])
    qrows = _quantizer(cache)
    for pool, scales, x in ((cache.kq, cache.kc, k_prompts), (cache.vq, cache.vc, v_prompts)):
        vals, c = qrows(x)                                      # [B, H, S, D]
        for j in range(n_log):
            phys = cache.page_table[:, j].to(torch.int64)
            sl = slice(j * ps, (j + 1) * ps)
            page = vals[:, :, sl]
            pool[phys] = pack_int4_rows(page, axis=2) if cache.kv_bits == 4 else page
            scales[phys] = c[:, :, sl, 0][:, :, None, :]
    return cache


def gather_slot_kv(cache: PagedKVCache, max_pages: Optional[int] = None):
    """Each slot's logical K/V [B, Hkv, S_max, D] and scales [B, Hkv, S_max,
    1], gathered from its pages (int4 unpacked). S_max = pages_per_slot x
    page unless ``max_pages`` caps it."""
    pt = cache.page_table if max_pages is None else cache.page_table[:, :max_pages]
    pt = pt.to(torch.int64)

    def gather(pool):
        g = pool[pt]                                    # [B, n, H, rows, D]
        if cache.kv_bits == 4:
            g = unpack_int4_rows(g, axis=3)
        b, n, h, p, d = g.shape
        return g.permute(0, 2, 1, 3, 4).reshape(b, h, n * p, d)

    def gather_scale(pool):
        g = pool[pt][:, :, :, 0]                        # [B, n, H, page]
        b, n, h, p = g.shape
        return g.permute(0, 2, 1, 3).reshape(b, h, n * p)[..., None]

    return (gather(cache.kq), gather_scale(cache.kc), gather(cache.vq),
            gather_scale(cache.vc))


def _compute_dtype(q: torch.Tensor, compute_dtype: Optional[torch.dtype]) -> torch.dtype:
    if compute_dtype is not None:
        return compute_dtype
    return torch.float32 if q.device.type == "cpu" else torch.bfloat16


def _dot(a: torch.Tensor, b: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """a @ b with both operands rounded to ``cd`` and f32 sums."""
    return torch.matmul(a.to(cd).to(torch.float32), b.to(cd).to(torch.float32))


def _attend(qg, kq, kc, vq, vc, valid, cd):
    """Masked softmax attention over gathered int8 rows, scales factored out
    of the products. qg [B, Hkv, R, D]; valid broadcasts to [B, Hkv, R, S]."""
    d = qg.shape[-1]
    s = _dot(qg, kq.transpose(-1, -2), cd)
    kscale = kc[..., 0]
    # a true division by the f32 constant, as jnp divides
    s = s * (kscale / torch.full_like(kscale, QRANGE * d ** 0.5))[:, :, None, :]
    s = torch.where(valid, s, torch.full_like(s, _NEG))
    p = softmax(s, axis=-1)
    p = p * (vc[..., 0] * (1.0 / QRANGE))[:, :, None, :]
    return _dot(p, vq, cd)


def paged_context_attention_reference(q: torch.Tensor, cache: PagedKVCache,
                                      lengths: torch.Tensor, offset,
                                      compute_dtype: Optional[torch.dtype] = None):
    """Plain version of K6: chunk attention over the paged cache. q [B, Hq,
    C, D] rows at positions offset..offset+C-1 attend every cached position
    <= their own and < lengths[b] (the chunk's K/V already written).
    ``offset`` an int or [B]. GQA query groups fold into the row axis.
    Returns [B, Hq, C, D] in q's dtype."""
    kq, kc, vq, vc = gather_slot_kv(cache)
    b, hq, c, d = q.shape
    hkv = kq.shape[1]
    g = hq // hkv
    s = kq.shape[2]
    dev = q.device
    # an int offset is made on the device: a host scalar copied there would
    # synchronise the stream
    off = (offset.to(dev) if isinstance(offset, torch.Tensor)
           else torch.full((1,), int(offset), device=dev)).reshape(-1).to(torch.int64)
    off = off.expand(b) if off.shape[0] == 1 else off
    qg = q.reshape(b, hkv, g * c, d)
    kj = torch.arange(s, device=dev)[None, None, None, :]
    row_pos = torch.arange(c, device=dev).repeat(g)[None, None, :, None] \
        + off[:, None, None, None]
    valid = (kj <= row_pos) & (kj < lengths.to(dev)[:, None, None, None])
    out = _attend(qg, kq, kc, vq, vc, valid, _compute_dtype(q, compute_dtype))
    return out.to(q.dtype).reshape(b, hq, c, d)


def paged_attention_reference(q: torch.Tensor, cache: PagedKVCache, lengths: torch.Tensor,
                              max_pages: Optional[int] = None,
                              compute_dtype: Optional[torch.dtype] = None):
    """Plain version of K5: one decode step over the paged cache. q [B, Hq,
    1, D] with Hq a multiple of the pool's heads (GQA: query heads
    i*g..(i+1)*g-1 share pool head i); lengths [B], the valid positions per
    slot. Returns [B, Hq, 1, D] in q's dtype."""
    kq, kc, vq, vc = gather_slot_kv(cache, max_pages)
    b, hq, _, d = q.shape
    hkv = kq.shape[1]
    s = kq.shape[2]
    qg = q[:, :, 0].reshape(b, hkv, hq // hkv, d)
    kj = torch.arange(s, device=q.device)[None, None, None, :]
    valid = kj < lengths.to(q.device)[:, None, None, None]
    out = _attend(qg, kq, kc, vq, vc, valid, _compute_dtype(q, compute_dtype))
    return out.to(q.dtype).reshape(b, hq, d)[:, :, None, :]
