"""Launch plan of the paged attention kernels K5 (``csrc/paged_decode_attention.cu``,
one decode step as page-split flash-decoding) and K6
(``csrc/paged_context_attention.cu``, causal chunk attention on mma.sync).

K5 runs one block of 128 threads per (slot * KV head, split), a split
being ``split_pages`` = max(1, 128 // page) consecutive logical pages; the
grid has a split for every ``split_pages`` entries of the page table (the
host knows its width; the lengths stay on the device, and a block past its
slot's length exits at once). A block takes the GQA group's g query rows
in passes of its row tile (``row_tile``: g itself for 1, 2, 4 and 8, else
passes of 8), sized into its shared memory. K6 runs one block of two
groups of 4 warps per (64 folded query rows, slot * KV head) at head
widths up to 128; the groups walk alternate 64-position key tiles of the
slot (each sub-tile of 16, or of 8 where pages are not multiples of 16, in
one page) and merge their states at the end. At D 256 a K6 block is one
group over 32-position tiles with q in shared memory. This module gives
both plans and their shared memory. It is pure Python; the C entries refuse a plan that matches
no compiled instantiation or whose shared memory differs from theirs.
"""

from __future__ import annotations

import functools

from qgemm_tpu_torch.ops.validation import check

K5_THREADS = 128           # K5: 4 warps
SPLIT_POSITIONS = 128      # K5: a split holds max(1, 128 // page) pages
K6_GROUPS = 2              # K6: warp groups, group g takes key tiles g, g + 2, ...
K6_THREADS = 128 * K6_GROUPS
K6_BLOCK_ROWS = 64         # K6: folded query rows per block (4 warps x 16 a group)
K6_KEY_TILE = 64           # K6: key positions per tile
K6_WIDE_KEY_TILE = 32      # K6 at D 256: one warp group, 32-position tiles
K6_SUB_TILE = 16           # K6: positions per sub-tile, one page each (8 for other pages)
HEAD_DIMS = (32, 64, 128, 256)  # the compiled head widths D
ROW_TILES = (1, 2, 4, 8)   # K2's and K5's compiled row tiles (a group's query rows a pass)
MAX_GRID_Y = 65535         # K5's splits, K6's slots x KV heads
SMEM_LIMIT = 232448        # the dynamic shared memory one H100 block may use


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def _check_pool(bits: int, D: int, d: int, page: int, pps: int, b: int, hkv: int) -> None:
    check(bits in (4, 8), f"paged plan: kv_bits must be 4 or 8, got {bits}")
    check(D in HEAD_DIMS, f"paged plan: the kernels are compiled for head widths "
          f"{HEAD_DIMS}, got {D}")
    check(1 <= d <= D, f"paged plan: the pools' width d must be 1 to {D}, got {d}")
    check(page % 8 == 0 and 8 <= page <= 256,
          f"paged plan: pages must be multiples of 8 from 8 to 256, got {page}")
    check(pps >= 1 and b >= 1 and hkv >= 1,
          f"paged plan: pages per slot, slots and KV heads must be positive, got "
          f"{pps}, {b}, {hkv}")


def split_pages(page: int) -> int:
    """K5's pages per split: ~128 positions a block where pages are small."""
    return max(1, SPLIT_POSITIONS // page)


def row_tile(g: int) -> int:
    """K2's and K5's row tile for a GQA group of ``g`` query heads: ``g``
    itself where it is compiled (one pass), else 8 (ceil(g / 8) passes over
    the split staged once)."""
    check(g >= 1, f"the decode kernels need a GQA group of at least 1, got {g}")
    return g if g in ROW_TILES else 8


def k5_smem(bits: int, D: int, G: int, page: int) -> int:
    """K5's dynamic shared memory at row tile ``G``, region by region as
    the kernel lays it out: the split's K and V code rows, its kc and vc,
    the scores (then p) of the tile's G query rows, their m and l, the P V
    partial sums of the 512 / D row sets, and the last-block flag."""
    sp = split_pages(page)
    rows = page if bits == 8 else page // 2
    return (2 * sp * rows * D + 2 * sp * page * 4 + G * sp * page * 4 + _round16(8 * G)
            + (512 // D) * G * D * 4 + 16)


def k5_plan(bits: int, D: int, d: int, G: int, page: int, pps: int, b: int, hkv: int) -> dict:
    """K5's plan for ``b`` slots of ``hkv`` KV heads, ``G`` query rows each,
    over pools of ``page``-position pages (int8 or int4 ``bits``, true
    width ``d`` in a kernel compiled for ``D``) and a page table of ``pps``
    pages a slot. Returns ``split_pages``, ``split_positions``, ``nsplit``,
    ``grid`` (slots x KV heads, splits), ``threads``, ``smem`` (bytes) and
    ``scratch_floats`` (the partial states: m, l and O[G, D] per block)."""
    _check_pool(bits, D, d, page, pps, b, hkv)
    tile = row_tile(G)
    sp = split_pages(page)
    nsplit = -(-pps // sp)
    check(nsplit <= MAX_GRID_Y, f"K5: at most {MAX_GRID_Y} splits a slot, got {nsplit}")
    smem = k5_smem(bits, D, tile, page)
    check(smem <= SMEM_LIMIT, f"K5: {smem} bytes of shared memory")
    return {"split_pages": sp, "split_positions": sp * page, "nsplit": nsplit,
            "grid": (b * hkv, nsplit), "threads": K5_THREADS, "row_tile": tile,
            "passes": -(-G // tile), "smem": smem,
            "scratch_floats": b * hkv * nsplit * G * (D + 2)}


def k6_tiling(D: int) -> tuple:
    """K6's (warp groups, key tile) at width ``D``: two groups over 64-key
    tiles up to 128, one group over 32-key tiles at 256."""
    return (1, K6_WIDE_KEY_TILE) if D > 128 else (K6_GROUPS, K6_KEY_TILE)


def k6_sub_tile(page: int) -> int:
    """K6's positions per sub-tile (each in one page): 16, or 8 where
    pages are not multiples of 16."""
    return K6_SUB_TILE if page % K6_SUB_TILE == 0 else 8


def k6_smem(D: int, page: int = 16) -> int:
    """K6's dynamic shared memory as the kernel lays it out: a two-stage
    ring holding each warp group's K and V code tile and their scales, each
    group's K and V tile in bf16 (rows of D + 8; up to D 128 q is staged in
    group 0's K), its scales / 127, each stage's sub-tiles' first page row,
    and at D 256 q in bf16."""
    g, t = k6_tiling(D)
    q_rows = K6_BLOCK_ROWS * (D + 8) * 2 if D > 128 else 0
    return 2 * g * 2 * t * D + 2 * g * 2 * t * 4 + g * 2 * t * (D + 8) * 2 + g * 2 * t * 4 \
        + 2 * g * (t // k6_sub_tile(page)) * 4 + q_rows


def k6_plan(bits: int, D: int, d: int, page: int, pps: int, b: int, hkv: int,
            rows: int) -> dict:
    """K6's plan for ``b`` slots of ``hkv`` KV heads with ``rows`` folded
    query rows each (G * C). Returns ``block_rows``, ``key_tile``,
    ``row_blocks``, ``grid`` (row blocks, slots x KV heads), ``threads``
    and ``smem`` (bytes)."""
    _check_pool(bits, D, d, page, pps, b, hkv)
    check(rows >= 1, f"K6: rows must be positive, got {rows}")
    check(b * hkv <= MAX_GRID_Y, f"K6 takes at most {MAX_GRID_Y} slots x KV heads, "
          f"got {b * hkv}")
    smem = k6_smem(D, page)
    check(smem <= SMEM_LIMIT, f"K6: {smem} bytes of shared memory")
    blocks = -(-rows // K6_BLOCK_ROWS)
    groups, key_tile = k6_tiling(D)
    return {"block_rows": K6_BLOCK_ROWS, "key_tile": key_tile, "row_blocks": blocks,
            "sub_tile": k6_sub_tile(page), "grid": (blocks, b * hkv),
            "threads": 128 * groups, "smem": smem}


@functools.lru_cache(maxsize=None)
def k5_args(bits: int, D: int, d: int, G: int, page: int, pps: int, b: int,
            hkv: int) -> tuple:
    """K5's C entry's plan arguments (split pages, splits, shared memory)
    and the scratch floats to allocate. Cached: every decode step asks."""
    p = k5_plan(bits, D, d, G, page, pps, b, hkv)
    return p["split_pages"], p["nsplit"], p["smem"], p["scratch_floats"]


@functools.lru_cache(maxsize=None)
def k6_args(bits: int, D: int, d: int, page: int, pps: int, b: int, hkv: int,
            rows: int) -> tuple:
    """K6's C entry's plan arguments (block rows, key tile, shared memory).
    Cached: every chunk's layers ask."""
    p = k6_plan(bits, D, d, page, pps, b, hkv, rows)
    return p["block_rows"], p["key_tile"], p["smem"]
