"""Launch plan of the paged attention kernels K5 and K6
(qgemm_tpu_torch/ops/cuda/paged_plan.py): K5's page splits cover each live
position of a slot once and nothing past its length; K6's row blocks cover
each folded query row once and its tight causal bound never drops a key a
row attends; the int4 byte row and nibble of a page position are the pool
layout's; the shared memory fits the H100; the plans' constants are the
kernels'; the plans refuse what the kernels refuse. One more test runs the
plain math split by split and merges the partial states in split order, as
K5's last block does, against the plain version. The plan is pure Python,
so these run without a card. The index mappings below (a split's
positions, K6's tight bound, an int4 position's byte row) are this test's
oracles of what the kernels compute; the card holds the kernels to them
through chip_smoke.py's parity checks, and the C entries refuse a plan
(or a shared-memory size) that is not a compiled kernel's."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from qgemm_tpu_torch.ops.cuda import paged_plan as pp
from qgemm_tpu_torch.ops.kv_cache import pack_int4_rows
from qgemm_tpu_torch.serving.paged_cache import (PagedKVCache, gather_slot_kv,
                                                 paged_attention_reference)
from qgemm_tpu_torch.utils.testing import assert_allclose, use_test_threads

use_test_threads()

CSRC = Path(pp.__file__).resolve().parents[2] / "csrc"
SMEM_LIMIT = 232448        # the dynamic shared memory one H100 block may use
MAX_GRID = (2 ** 31 - 1, 65535, 65535)   # CUDA's grid limits (x, y, z)
# every page the JAX kernels take: below and past the split, not multiples
# of 8, odd (int8 only), larger than 256
PAGES = (1, 3, 4, 8, 12, 16, 24, 32, 128, 256, 272, 512)
COMPILED = [(bits, D, G) for bits in (8, 4) for D in pp.HEAD_DIMS for G in (1, 2, 4, 8)]
# (bits, D, G, page): every compiled instantiation at every page its pools take
K5_CASES = [(bits, D, G, page) for bits, D, G in COMPILED for page in PAGES
            if bits == 8 or page % 2 == 0]
# GQA groups that are no compiled row tile (passes of 8 rows), or wider
GROUPS = (3, 7, 16, 32, 71)


def _pages(bits: int) -> list:
    """The pages a pool of ``bits`` takes: int4 pages hold two positions a
    byte, so they are even."""
    return [p for p in PAGES if bits == 8 or p % 2 == 0]


def _within_limits(grid) -> bool:
    return 1 <= len(grid) <= 3 and all(1 <= n <= m for n, m in zip(grid, MAX_GRID))


def _lengths(page: int, pps: int, bits: int = 8, D: int = 128) -> list:
    """Slot lengths at and around every page, split and nibble edge, 0,
    and past the table's width."""
    npos = pp.split_pages(page, D) * page
    rows = page if bits == 8 else page // 2
    edges = {0, 1, page - 1, page, page + 1, npos - 1, npos, npos + 1, 2 * npos + 3,
             rows - 1, rows + 1, page + rows + 3, pps * page - 1, pps * page, pps * page + 50}
    return sorted(n for n in edges if n >= 0)


def k5_split_positions(split: int, length: int, page: int, pps: int, bits: int = 8,
                       D: int = 128) -> np.ndarray:
    """Positions that K5's block ``split`` attends for a slot of ``length``
    positions (capped at the table's pps * page): K2's positions on int8
    pools (``aligned``), whole pages of a split, or, for an int4 page past
    ``max_whole_page(D)``, a chunk of its byte rows [a, a + rc): positions
    a.. (low nibbles) and page/2 + a.. (high ones). Empty past the length,
    where the block exits."""
    n = min(length, pps * page)
    if pp.aligned(bits, page, D):
        sp = pp.split_positions(D)
        return np.arange(split * sp, max(split * sp, min((split + 1) * sp, n)))
    cpp = pp.chunks_per_page(bits, page, D)
    if not cpp:
        np_ = pp.split_pages(page, D) * page
        start = split * np_
        return np.arange(start, max(start, min(start + np_, n)))
    rows = page if bits == 8 else page // 2
    j, a = split // cpp, (split % cpp) * pp.chunk_rows(bits, D)
    rc = min(pp.chunk_rows(bits, D), rows - a)
    pos = j * page + a + np.arange(rc)
    if bits == 4:
        pos = np.concatenate([pos, pos + rows])
    return pos[pos < n]


def k5_live_splits(length: int, page: int, pps: int, bits: int = 8, D: int = 128) -> int:
    """The slot's live splits as the kernel's last block counts them
    (``PagedRows::geom``): a prefix of its splits."""
    n = min(length, pps * page)
    if pp.aligned(bits, page, D):
        return -(-n // pp.split_positions(D))
    cpp = pp.chunks_per_page(bits, page, D)
    if not cpp:
        np_ = pp.split_pages(page, D) * page
        return -(-n // np_)
    rc = pp.chunk_rows(bits, D)
    return (n // page) * cpp + min(cpp, -(-(n % page) // rc))


def k6_kv_end(row_block: int, rows: int, C: int, offset: int, length: int, page: int,
              pps: int) -> int:
    """One past the last position K6's row block ``row_block`` reads (the
    kernel's tight bound): its rows' last causal position, off + (last row)
    % C within one head-group, off + C - 1 across a group boundary, capped
    at the slot's length and the table's width. (Row blocks are counted in
    rows' order; the kernel launches the last ones first.)"""
    r0 = row_block * pp.K6_BLOCK_ROWS
    r_last = min(r0 + pp.K6_BLOCK_ROWS, rows) - 1
    bound = offset + r_last % C if r0 // C == r_last // C else offset + C - 1
    return max(0, min(bound + 1, min(length, pps * page)))


def int4_byte_row(w: int, page: int) -> tuple:
    """(byte row, high nibble) of position ``w`` of an int4 page: the page's
    byte row r holds position r in its low nibbles and r + page/2 in its
    high ones."""
    half = page // 2
    return (w - half, True) if w >= half else (w, False)


@pytest.mark.parametrize("bits,D,G,page", K5_CASES)
def test_k5_splits_cover_each_live_position_once(bits, D, G, page):
    """Every position below a slot's length (capped at the table) lies in
    exactly one split; a split past the length covers nothing, and the
    live splits are the prefix the last block merges; the grid has a
    split for every ``split_pages`` table entries, ``chunks_per_page`` for
    each entry of a large int4 page, or, on int8 pools (``aligned``), one
    per K2 split of the table's positions."""
    pps = 1024 // page + 1
    plan = pp.k5_plan(bits, D, D, G, page, pps, 3, 2)
    assert plan["grid"] == (6, plan["nsplit"]) and _within_limits(plan["grid"])
    assert plan["launches"] == 1
    cpp, al = plan["chunks_per_page"], plan["aligned"]
    sp = pp.split_positions(D)
    assert al == (bits == 8 and not (D <= 256 and page % 8 == 0 and page <= 256))
    assert plan["nsplit"] == (-(-pps * page // sp) if al else pps * cpp if cpp
                              else -(-pps // plan["split_pages"]))
    assert (cpp > 0) == (bits == 4 and page > pp.max_whole_page(D))
    assert plan["split_positions"] == (sp if cpp or al else plan["split_pages"] * page)
    assert plan["split_positions"] >= min(pp.split_positions(D), page) - page % 2
    assert plan["scratch_floats"] == 6 * plan["nsplit"] * G * (D + 2)
    for n in _lengths(page, pps, bits, D):
        live = min(n, pps * page)
        covered = np.zeros(pps * page, dtype=np.int64)
        live_splits = []
        for s in range(plan["nsplit"]):
            pos = k5_split_positions(s, n, page, pps, bits, D)
            assert len(pos) <= plan["split_positions"]
            covered[pos] += 1
            if len(pos):
                live_splits.append(s)
        assert (covered[:live] == 1).all() and (covered[live:] == 0).all()
        assert live_splits == list(range(k5_live_splits(n, page, pps, bits, D)))


@pytest.mark.parametrize("bits,D,G,page", K5_CASES)
def test_shared_memory_matches_the_kernels_and_fits(bits, D, G, page):
    """Each compiled instantiation's shared memory fits one H100 block, is
    whole 16-byte rows, and holds at least what the kernel stages: K5 a
    split's K and V code rows and scales (a chunk of a large page as a page
    of one split's positions), K6 two stages of both warp groups' K and V
    code tiles. The exact size is the C entries' to check: they refuse any
    other."""
    k5 = pp.k5_plan(bits, D, D, G, page, 8, 1, 1)["smem"]
    laid = (pp.split_positions(D) if pp.chunks_per_page(bits, page, D)
            or pp.aligned(bits, page, D) else page)
    sp = pp.split_pages(laid, D)
    staged = 2 * sp * (laid if bits == 8 else laid // 2) * D + 2 * sp * laid * 4
    assert staged < k5 <= SMEM_LIMIT and k5 % 16 == 0
    if D in pp.K6_HEAD_DIMS:
        k6 = pp.k6_plan(bits, D, D, page, 8, 1, 1, 256 * G)["smem"]
        groups, key_tile = pp.k6_tiling(D)
        assert 2 * groups * 2 * key_tile * D < k6 <= SMEM_LIMIT
        assert k6 % 16 == 0


def test_plan_constants_are_the_kernels():
    """The tile and split sizes the plan assumes are the ones compiled (K5's
    in the split body it shares with K2, which K5's source includes)."""
    assert '#include "split_decode.cuh"' in (CSRC / "paged_decode_attention.cu").read_text()
    k5 = (CSRC / "split_decode.cuh").read_text()
    k6 = (CSRC / "paged_context_attention.cu").read_text()
    const = lambda src, name: int(re.search(rf"{name} = (\d+);", src).group(1))
    # splits of 128 positions, 64 at D 1024; whole pages up to 256 up to D 256
    assert re.search(r"return D <= 512 \? (\d+) : (\d+);", k5).groups() == (
        str(pp.SPLIT_POSITIONS), str(pp.SPLIT_POSITIONS // 2))
    assert (pp.split_positions(512), pp.split_positions(1024)) == (128, 64)
    assert "return D <= 256 ? 256 : split_positions(D);" in k5
    assert (pp.max_whole_page(256), pp.max_whole_page(512)) == (256, 128)
    assert const(k5, "kThreads") == pp.K5_THREADS
    assert const(k6, "kBQ") == pp.K6_BLOCK_ROWS
    # K6's tiling: (groups, key tile) at D <= 128 and at D 256
    assert re.search(r"kGroups = kWide \? 1 : (\d+);", k6).group(1) == str(pp.K6_GROUPS)
    assert re.search(r"kBK = kWide \? (\d+) : (\d+);", k6).groups() == (
        str(pp.K6_WIDE_KEY_TILE), str(pp.K6_KEY_TILE))
    assert re.search(r"kWide = D > 128;", k6)
    assert pp.k6_tiling(128) == (pp.K6_GROUPS, pp.K6_KEY_TILE)
    assert pp.k6_tiling(256) == (1, pp.K6_WIDE_KEY_TILE)
    # sub-tiles of 16 where pages are multiples of 16, else 8, else 1
    assert "if (page % 16 == 0) {" in k6 and "} else if (page % 8 == 0) {" in k6
    assert "QG_K6(16)" in k6 and "QG_K6(8)" in k6 and "QG_K6(1)" in k6
    assert (pp.k6_sub_tile(32), pp.k6_sub_tile(8), pp.k6_sub_tile(24)) == (16, 8, 8)
    assert (pp.k6_sub_tile(12), pp.k6_sub_tile(3), pp.k6_sub_tile(272)) == (1, 1, 16)
    assert re.search(r"kThreads = 128 \* kGroups;", k6) and pp.K6_THREADS == 128 * pp.K6_GROUPS
    # the split body's row tiles: 8 rows at most, 4 at D 1024
    assert ("(g == 1 || g == 2 || g == 4 || g == 8) && g <= max_rows(D) ? g : max_rows(D)"
            in k5) and "return D <= 512 ? 8 : 4;" in k5 and pp.ROW_TILES == (1, 2, 4, 8)
    assert (pp.row_tile(8, 512), pp.row_tile(8, 1024), pp.row_tile(3, 1024)) == (8, 4, 4)


@pytest.mark.parametrize("C,G", [(256, 1), (256, 4), (100, 4), (1, 8), (65, 2), (16, 8)])
@pytest.mark.parametrize("page", PAGES)
def test_k6_row_blocks_cover_each_folded_row_once(C, G, page):
    rows = G * C
    plan = pp.k6_plan(8, 128, 128, page, 4, 2, 8, rows)
    assert plan["grid"] == (plan["row_blocks"] * 16,) and _within_limits(plan["grid"])
    covered = np.zeros(plan["row_blocks"] * plan["block_rows"], dtype=np.int64)
    for blk in range(plan["row_blocks"]):
        covered[blk * plan["block_rows"]:(blk + 1) * plan["block_rows"]] += 1
    assert (covered[:rows] == 1).all()
    assert (plan["row_blocks"] - 1) * plan["block_rows"] < rows


@pytest.mark.parametrize("C,G", [(256, 1), (256, 4), (100, 4), (1, 8), (65, 2), (16, 8)])
@pytest.mark.parametrize("offset", [0, 1, 300, 768])
def test_k6_tight_bound_keeps_every_attended_key(C, G, offset):
    """Row r attends k <= offset + r % C, k < length; its block reads keys
    below ``k6_kv_end``, which never exceeds the length."""
    page, pps = 16, -(-(offset + C + 40) // 16)
    rows = G * C
    for length in (offset + C, offset + C // 2 + 1, offset + 1, 0, pps * page + 9):
        for blk in range(-(-rows // pp.K6_BLOCK_ROWS)):
            end = k6_kv_end(blk, rows, C, offset, length, page, pps)
            assert end <= min(length, pps * page)
            r0 = blk * pp.K6_BLOCK_ROWS
            for r in range(r0, min(r0 + pp.K6_BLOCK_ROWS, rows)):
                last = min(offset + r % C, min(length, pps * page) - 1)
                assert last < end


@pytest.mark.parametrize("page", _pages(4))
def test_int4_byte_row_and_nibble_are_the_pool_layout(page):
    """The pool packs a page's positions w and w + page/2 into byte row w
    (low, high nibble): ``int4_byte_row`` and the kernels' nibble pick
    (sign-extended) give every position's code back."""
    rng = np.random.default_rng(page)
    codes = torch.from_numpy(rng.integers(-8, 8, size=(page, 8)).astype(np.int8))
    packed = pack_int4_rows(codes, axis=0).to(torch.int32)
    assert packed.shape[0] == page // 2
    for w in range(page):
        r, hi = int4_byte_row(w, page)
        byte = packed[r]
        got = (byte >> 4) if hi else (((byte & 15) ^ 8) - 8)
        # the kernels' byte permute: (nibble + 8) as an unsigned byte, less 8
        u = (((byte >> 4) if hi else byte) & 15) ^ 8
        assert torch.equal(got.to(torch.int8), codes[w])
        assert torch.equal((u - 8).to(torch.int8), codes[w])


@pytest.mark.parametrize("page", [8, 24, 4, 12])
@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("bits", [8, 4])
def test_k5_plan_takes_any_group_at_d256_and_pages_of_8(bits, g, page):
    """A group that is no row tile runs in passes of 8 rows at the row
    tile 8's shared memory; the scratch holds every row's state."""
    plan = pp.k5_plan(bits, 256, 160, g, page, 40, 3, 2)
    assert pp.row_tile(g) == plan["row_tile"] == 8
    assert plan["passes"] == -(-g // 8) and (plan["passes"] - 1) * 8 < g
    assert plan["smem"] == pp.k5_smem(bits, 256, 8, page) <= SMEM_LIMIT
    if plan["aligned"]:   # int8 pages that are not multiples of 8: K2's splits
        assert plan["split_pages"] == 1 and plan["nsplit"] == -(-40 * page // 128)
    else:
        assert plan["split_pages"] == 128 // page and plan["nsplit"] == -(-40 // (128 // page))
    assert plan["scratch_floats"] == 6 * plan["nsplit"] * g * (256 + 2)
    assert pp.k6_plan(bits, 256, 160, page, 40, 3, 2, g * 64)["smem"] <= SMEM_LIMIT


@pytest.mark.parametrize("kw,match", [
    (dict(page=0), "at least one position"), (dict(bits=4, page=5), "even page"),
    (dict(D=2048), "head widths"),
    (dict(D=48), "head widths"), (dict(d=129), "width d"), (dict(d=0), "width d"),
    (dict(bits=3), "kv_bits"), (dict(G=0), "GQA group"), (dict(D=256, d=257), "width d"),
    (dict(D=1024, d=1025), "width d"), (dict(b=0), "positive"),
])
def test_k5_plan_refuses_what_the_kernel_refuses(kw, match):
    args = dict(bits=8, D=128, d=128, G=1, page=128, pps=8, b=8, hkv=32)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        pp.k5_plan(**args)


@pytest.mark.parametrize("kw", [
    dict(page=12), dict(page=272), dict(page=4), dict(page=1), dict(page=512),
    dict(bits=4, page=4), dict(bits=4, page=12), dict(bits=4, page=272), dict(D=512),
    dict(D=512, page=200), dict(D=1024, d=576, page=12), dict(D=1024, G=8, page=512),
    dict(pps=65536 * 8, page=16), dict(b=65536, hkv=2, pps=1),
])
def test_k5_plan_takes_the_shapes_it_refused_before(kw):
    """Pages that are not multiples of 8 or pass 256, widths past 256, and
    splits past 65,535: a plan whose shared memory fits and whose grid is
    within CUDA's limits."""
    args = dict(bits=8, D=128, d=128, G=1, page=128, pps=8, b=8, hkv=32)
    args.update(kw)
    plan = pp.k5_plan(**args)
    assert plan["smem"] <= SMEM_LIMIT and _within_limits(plan["grid"])
    assert plan["grid"] == (args["b"] * args["hkv"], min(plan["nsplit"], 65535))
    assert plan["launches"] == -(-plan["nsplit"] // 65535)


@pytest.mark.parametrize("kw,match", [
    (dict(page=0), "at least one position"), (dict(bits=4, page=7), "even page"),
    (dict(D=48), "head widths"), (dict(D=520), "multiples of 64"), (dict(d=200), "width d"),
    (dict(bits=2), "kv_bits"), (dict(rows=0), "rows"),
])
def test_k6_plan_refuses_what_the_kernel_refuses(kw, match):
    args = dict(bits=8, D=128, d=128, page=128, pps=8, b=1, hkv=32, rows=256)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        pp.k6_plan(**args)


@pytest.mark.parametrize("kw", [
    dict(page=12), dict(page=4), dict(page=1), dict(page=272), dict(page=512),
    dict(bits=4, page=4), dict(bits=4, page=12), dict(D=256, page=12),
    dict(b=2, hkv=32768), dict(b=65536, hkv=1), dict(b=65600, hkv=2, rows=8),
    dict(D=512, d=384), dict(D=576, d=576, page=12), dict(D=1024, d=1024, bits=4, page=272),
])
def test_k6_plan_takes_the_shapes_it_refused_before(kw):
    """Pages that are not multiples of 8 or pass 256 (sub-tiles of 1 that
    never straddle a page) and slots x KV heads past 65,535."""
    args = dict(bits=8, D=128, d=128, page=128, pps=8, b=1, hkv=32, rows=256)
    args.update(kw)
    plan = pp.k6_plan(**args)
    assert plan["smem"] <= SMEM_LIMIT and _within_limits(plan["grid"])
    assert args["page"] % plan["sub_tile"] == 0
    chunks = -(-args["D"] // 256) if plan["route"] == "wide" else 1
    assert plan["route"] == ("wide" if args["D"] > 256 else "mma")
    assert plan["grid"] == (plan["row_blocks"] * chunks * args["b"] * args["hkv"],)


def test_plan_arguments_are_the_plans():
    p5 = pp.k5_plan(4, 64, 48, 4, 32, 10, 3, 8)
    assert pp.k5_args(4, 64, 48, 4, 32, 10, 3, 8) == (
        p5["split_pages"], p5["nsplit"], p5["smem"], p5["scratch_floats"])
    p6 = pp.k6_plan(8, 32, 2, 16, 9, 2, 4, 300)
    assert pp.k6_args(8, 32, 2, 16, 9, 2, 4, 300) == (p6["block_rows"], p6["key_tile"],
                                                      p6["smem"])


def _random_cache(seed, lengths, hkv, page, bits, pps, d):
    """A CPU paged cache of random codes and scales, pages shuffled."""
    rng = np.random.default_rng(seed)
    counts = [-(-n // page) for n in lengths]
    n_pages = 1 + sum(counts) + 2
    perm = list(rng.permutation(np.arange(1, n_pages)))
    pt = np.zeros((len(lengths), pps), dtype=np.int32)
    for s, n in enumerate(counts):
        pt[s, :n] = perm[:n]
        perm = perm[n:]
    rows = page if bits == 8 else page // 2
    lo = -127 if bits == 8 else -128
    codes = lambda: torch.from_numpy(rng.integers(lo, 128, size=(n_pages, hkv, rows, d))
                                     .astype(np.int8))
    scales = lambda: torch.from_numpy((rng.random((n_pages, hkv, 1, page)) * 2 + 0.05)
                                      .astype(np.float32))
    return PagedKVCache(kq=codes(), kc=scales(), vq=codes(), vc=scales(),
                        page_table=torch.from_numpy(pt), page_size=page, kv_bits=bits)


def _split_merge(q, cache, lengths, D=256):
    """K5's algorithm in torch, in f32 without its bf16 roundings: per
    split of ``k5_plan`` at width ``D``, the partial state (m, l, O) of
    the positions ``k5_split_positions`` gives; then the live splits merged
    in split order."""
    kq, kc, vq, vc = gather_slot_kv(cache)
    b, hq, _, d = q.shape
    hkv, page, pps = kq.shape[1], cache.page_size, cache.page_table.shape[1]
    g = hq // hkv
    plan = pp.k5_plan(cache.kv_bits, D, d, g, page, pps, b, hkv)
    out = torch.zeros((b, hq, 1, d))
    for s_ in range(b):
        n = int(lengths[s_])
        for h in range(hkv):
            qg_ = q[s_, h * g:(h + 1) * g, 0].float()                # [g, d]
            states = []
            for sp_ in range(plan["nsplit"]):
                pos = torch.from_numpy(k5_split_positions(sp_, n, page, pps,
                                                          cache.kv_bits, D))
                if not len(pos):
                    continue
                sc = (qg_ @ kq[s_, h, pos].float().T) * (1 / math.sqrt(d)) \
                    * (kc[s_, h, pos, 0] / 127)
                m = sc.max(dim=1).values
                p = torch.exp(sc - m[:, None])
                o = (p * (vc[s_, h, pos, 0] / 127)) @ vq[s_, h, pos].float()
                states.append((m, p.sum(dim=1), o))
            if not states:
                continue                                         # length 0: zeros
            mx = torch.stack([m for m, _, _ in states]).max(dim=0).values
            l_tot = torch.zeros_like(mx)
            o_tot = torch.zeros((g, d))
            for m, l_, o in states:
                f = torch.exp(m - mx)
                l_tot = l_tot + l_ * f
                o_tot = o_tot + o * f[:, None]
            out[s_, h * g:(h + 1) * g, 0] = o_tot / torch.clamp_min(l_tot, 1e-30)[:, None]
    return out


@pytest.mark.parametrize("bits,page,g", [(8, 128, 1), (4, 128, 1), (8, 16, 4), (4, 16, 2),
                                         (8, 32, 8), (4, 48, 1), (8, 256, 2), (8, 8, 7),
                                         (4, 8, 3), (4, 24, 16), (8, 3, 1), (8, 12, 2),
                                         (4, 12, 2), (4, 4, 1), (8, 272, 1), (4, 272, 2),
                                         (8, 512, 4), (4, 514, 1)])
def test_split_partial_states_merged_in_order_match_the_plain_version(bits, page, g):
    """The flash-decoding split changes only the order of f32 sums: at
    every page, in-page chunks included (at D 256, and at D 1024's
    64-position splits)."""
    hkv, d = 2, 32
    pps = 640 // page + 1
    lengths = [0, 1, page, page + 1, 300, 640]
    cache = _random_cache(page + bits + g, lengths, hkv, page, bits, pps, d)
    q = torch.from_numpy(np.random.default_rng(g).standard_normal(
        (len(lengths), hkv * g, 1, d)).astype(np.float32))
    lens = torch.tensor(lengths, dtype=torch.int32)
    ref = paged_attention_reference(q, cache, lens, compute_dtype=torch.float32)
    live = lens > 0
    for D in (256, 1024):
        got = _split_merge(q, cache, lens, D)
        assert_allclose(got[live], ref[live], rtol=1e-5,
                        atol=1e-5 * float(ref[live].abs().max()))
        assert not bool(got[~live].any())
