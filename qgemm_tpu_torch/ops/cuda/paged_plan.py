"""Launch plan of the paged attention kernels K5 (``csrc/paged_decode_attention.cu``,
one decode step as page-split flash-decoding) and K6
(``csrc/paged_context_attention.cu``, causal chunk attention on mma.sync).

K5 runs one block of 128 threads per (slot * KV head, split). A split
holds about ``split_positions(D)`` positions (128; 64 at D 1024). On int8
pools it is K2's split, that many consecutive positions from position 0
(``aligned``), except at the pages the kernel took first (D up to 256,
pages that are multiples of 8 up to 256), which keep whole pages. Whole
pages (and every int4 pool): the ``split_pages`` = split_positions // page
whole pages where pages are smaller, one page where it is at most
``max_whole_page(D)`` (256 up to D 256), and a chunk of a larger int4
page's rows (``chunk_rows``: half as many byte rows as positions, each
holding two) else. The grid has a split for every ``split_pages`` entries
of the page table, ``chunks_per_page`` splits for each entry, or, aligned,
one per split's positions of the table's width (the host knows it; the
lengths stay on the device, and a block past its slot's length exits at
once); a launch per 65,535 splits (grid y). A block takes the GQA
group's g query rows in passes of its row tile (``row_tile``: g itself for
1, 2, 4 and 8, else passes of 8; at D 1024 at most 4), sized into its
shared memory. K6 runs one block of two groups of 4 warps per (64 folded
query rows, slot * KV head) at head widths up to 128; the groups walk
alternate 64-position key tiles of the slot (each sub-tile of 16, 8 or 1
positions in one page: the largest of those that divides the page) and
merge their states at the end. At D 256 a K6 block is one group over
32-position tiles with q in shared memory; past 256 a wide SIMT kernel
takes the chunk (widths padded to a multiple of 64, ``k6_width``), one
block per (64 folded rows, 256 output columns). Every grid is one dimension
(``check_grid``). This module gives both plans and their shared memory. It
is pure Python; the C entries refuse a plan that matches no compiled
instantiation or whose shared memory differs from theirs.
"""

from __future__ import annotations

import functools

from qgemm_tpu_torch.ops.validation import check, check_grid

K5_THREADS = 128           # K5: 4 warps
SPLIT_POSITIONS = 128      # K5: the positions of a split (64 at D 1024: split_positions)
K6_GROUPS = 2              # K6: warp groups, group g takes key tiles g, g + 2, ...
K6_THREADS = 128 * K6_GROUPS
K6_BLOCK_ROWS = 64         # K6: folded query rows per block (4 warps x 16 a group)
K6_KEY_TILE = 64           # K6: key positions per tile
K6_WIDE_KEY_TILE = 32      # K6 at D 256: one warp group, 32-position tiles
K6_SUB_TILES = (16, 8, 1)  # K6: positions per sub-tile, one page each
HEAD_DIMS = (32, 64, 128, 256, 512, 1024)  # K2's and K5's compiled head widths D
K6_HEAD_DIMS = (32, 64, 128, 256)          # K6's tiled widths; past 256 the wide kernel
K6_WIDE_CHUNK = 64         # K6's wide kernel: widths are multiples of this
# K6's wide kernel's dynamic shared memory (csrc/flash_wide.cuh smem_bytes)
K6_WIDE_SMEM = 4 * (64 * 68 + 32 * 68 + 64 * 33 + 32 * 260 + 3 * 64)
ROW_TILES = (1, 2, 4, 8)   # K2's and K5's compiled row tiles (a group's query rows a pass)
SMEM_LIMIT = 232448        # the dynamic shared memory one H100 block may use
MAX_GRID_SPLITS = 65535    # K2's and K5's splits a launch (grid y); a launch per chunk past it


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def _check_pool(bits: int, D: int, d: int, page: int, pps: int, b: int, hkv: int,
                dims=HEAD_DIMS) -> None:
    check(bits in (4, 8), f"paged plan: kv_bits must be 4 or 8, got {bits}")
    check(D in dims, f"paged plan: the kernels are compiled for head widths {dims}, got {D}")
    check(1 <= d <= D, f"paged plan: the pools' width d must be 1 to {D}, got {d}")
    check(page >= 1, f"paged plan: pages must hold at least one position, got {page}")
    check(bits == 8 or page % 2 == 0,
          f"paged plan: int4 pools need an even page (two positions a byte), got {page}")
    check(pps >= 1 and b >= 1 and hkv >= 1,
          f"paged plan: pages per slot, slots and KV heads must be positive, got "
          f"{pps}, {b}, {hkv}")


def split_positions(D: int = 128) -> int:
    """K5's (and K2's) positions a split: 128, or 64 at D 1024, whose code
    rows would not fit one block's shared memory."""
    return SPLIT_POSITIONS if D <= 512 else SPLIT_POSITIONS // 2


def aligned(bits: int, page: int, D: int = 128) -> bool:
    """Whether K5's splits on this pool are K2's (``split_positions(D)``
    consecutive positions from position 0): every int8 pool but those at
    the pages the kernel took first (D up to 256, pages that are multiples
    of 8 up to 256). K5 then equals K2 bit for bit on the same rows."""
    return bits == 8 and not (D <= 256 and page % 8 == 0 and page <= 256)


def max_whole_page(D: int = 128) -> int:
    """The largest page a K5 split holds whole: 256 up to D 256, else one
    split's positions. A larger page is split into chunks of its rows."""
    return 256 if D <= 256 else split_positions(D)


def split_pages(page: int, D: int = 128) -> int:
    """K5's whole pages a split: ~``split_positions(D)`` positions a block
    where pages are small; 1 where a split is one page or a chunk of one."""
    return max(1, split_positions(D) // page)


def chunk_rows(bits: int, D: int = 128) -> int:
    """A chunk of a large page: its byte rows a split takes (int4 rows hold
    two positions)."""
    return split_positions(D) if bits == 8 else split_positions(D) // 2


def chunks_per_page(bits: int, page: int, D: int = 128) -> int:
    """K5's splits of one int4 page larger than ``max_whole_page(D)``; 0
    where splits hold whole pages or are K2's."""
    if page <= max_whole_page(D) or aligned(bits, page, D):
        return 0
    return -(-(page if bits == 8 else page // 2) // chunk_rows(bits, D))


def row_tile(g: int, D: int = 128) -> int:
    """K2's and K5's row tile for a GQA group of ``g`` query heads: ``g``
    itself where it is compiled (one pass), else the width's most rows (8;
    4 at D 1024), in ceil(g / tile) passes over the split staged once."""
    check(g >= 1, f"the decode kernels need a GQA group of at least 1, got {g}")
    most = 8 if D <= 512 else 4
    return g if g in ROW_TILES and g <= most else most


def _pv_row_sets(D: int) -> int:
    """Row sets of K5's P V pass: 128 threads over D / (4, or D / 128 past
    512) columns each."""
    return max(1, 512 // D)


def k5_smem(bits: int, D: int, G: int, page: int) -> int:
    """K5's dynamic shared memory at row tile ``G``, region by region as
    the kernel lays it out: the split's K and V code rows, its kc and vc,
    the scores (then p) of the tile's G query rows (these three per
    position, rounded up to 4 positions), their m and l, the P V
    partial sums of the row sets, and the last-block flag. K2's splits
    and a chunk of a page are laid out as a page of ``split_positions(D)``."""
    if chunks_per_page(bits, page, D) or aligned(bits, page, D):
        page = split_positions(D)
    sp = split_pages(page, D)
    rows = page if bits == 8 else page // 2
    npad = -(-sp * page // 4) * 4   # the per-position regions, 16-byte aligned at any page
    return (2 * sp * rows * D + 2 * npad * 4 + G * npad * 4 + _round16(8 * G)
            + _pv_row_sets(D) * G * D * 4 + 16)


def k5_plan(bits: int, D: int, d: int, G: int, page: int, pps: int, b: int, hkv: int) -> dict:
    """K5's plan for ``b`` slots of ``hkv`` KV heads, ``G`` query rows each,
    over pools of ``page``-position pages (int8 or int4 ``bits``, true
    width ``d`` in a kernel compiled for ``D``) and a page table of ``pps``
    pages a slot. Returns ``aligned`` (K2's splits), ``split_pages`` (1
    where aligned or chunked), ``chunks_per_page``, ``split_positions`` (a
    split's most positions), ``nsplit``, ``grid`` (slots x KV heads,
    splits: a launch's), ``launches`` (one per 65,535 splits), ``threads``,
    ``smem`` (bytes) and ``scratch_floats`` (the partial states: m, l and
    O[G, D] per block)."""
    _check_pool(bits, D, d, page, pps, b, hkv)
    tile = row_tile(G, D)
    al, cpp = aligned(bits, page, D), chunks_per_page(bits, page, D)
    sp = 1 if al or cpp else split_pages(page, D)
    nsplit = (-(-pps * page // split_positions(D)) if al else pps * cpp if cpp
              else -(-pps // sp))
    smem = k5_smem(bits, D, tile, page)
    check(smem <= SMEM_LIMIT, f"K5: {smem} bytes of shared memory")
    return {"aligned": al, "split_pages": sp, "chunks_per_page": cpp,
            "split_positions": split_positions(D) if al or cpp else sp * page,
            "nsplit": nsplit, "launches": -(-nsplit // MAX_GRID_SPLITS),
            "grid": check_grid("K5", (b * hkv, min(nsplit, MAX_GRID_SPLITS))),
            "threads": K5_THREADS,
            "row_tile": tile, "passes": -(-G // tile), "smem": smem,
            "scratch_floats": b * hkv * nsplit * G * (D + 2)}


def k6_tiling(D: int) -> tuple:
    """K6's (warp groups, key tile) at width ``D``: two groups over 64-key
    tiles up to 128, one group over 32-key tiles at 256."""
    return (1, K6_WIDE_KEY_TILE) if D > 128 else (K6_GROUPS, K6_KEY_TILE)


def k6_sub_tile(page: int) -> int:
    """K6's positions per sub-tile (each in one page): the largest of 16,
    8 and 1 that divides the page."""
    return next(t for t in K6_SUB_TILES if page % t == 0)


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


def k6_width(d: int) -> int:
    """The width K6 runs a pool of true width ``d`` at: a tiled width up to
    256, else ``d`` rounded up to a multiple of 64 (the wide kernel)."""
    check(d >= 1, f"K6: head_dim must be positive, got {d}")
    if d <= K6_HEAD_DIMS[-1]:
        return next(w for w in K6_HEAD_DIMS if d <= w)
    return -(-d // K6_WIDE_CHUNK) * K6_WIDE_CHUNK


def k6_plan(bits: int, D: int, d: int, page: int, pps: int, b: int, hkv: int,
            rows: int) -> dict:
    """K6's plan for ``b`` slots of ``hkv`` KV heads with ``rows`` folded
    query rows each (G * C), at the width ``D`` (``k6_width``). Returns
    ``route`` ("mma", or "wide" past 256), ``block_rows``, ``key_tile``,
    ``row_blocks``, ``sub_tile``, ``grid`` (row blocks [x output chunks] x
    slots x KV heads, row blocks fastest), ``threads`` and ``smem``
    (bytes)."""
    wide = D > K6_HEAD_DIMS[-1]
    if wide:
        check(D % K6_WIDE_CHUNK == 0, f"K6's wide kernel takes widths that are multiples of "
              f"{K6_WIDE_CHUNK}, got {D}")
    _check_pool(bits, D, d, page, pps, b, hkv, (D,) if wide else K6_HEAD_DIMS)
    check(rows >= 1, f"K6: rows must be positive, got {rows}")
    if wide:
        blocks = -(-rows // K6_BLOCK_ROWS)
        return {"route": "wide", "block_rows": K6_BLOCK_ROWS, "key_tile": 32,
                "row_blocks": blocks, "sub_tile": 1,
                "grid": check_grid("K6", (blocks * -(-D // 256) * b * hkv,)),
                "threads": 256, "smem": K6_WIDE_SMEM}
    smem = k6_smem(D, page)
    check(smem <= SMEM_LIMIT, f"K6: {smem} bytes of shared memory")
    blocks = -(-rows // K6_BLOCK_ROWS)
    groups, key_tile = k6_tiling(D)
    return {"route": "mma", "block_rows": K6_BLOCK_ROWS, "key_tile": key_tile,
            "row_blocks": blocks, "sub_tile": k6_sub_tile(page),
            "grid": check_grid("K6", (blocks * b * hkv,)),
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
