"""Launch plan of kernel K2's int8 route (``csrc/decode_attention.cu``, one
decode step over the dense int8 KV cache as flash-decoding on the split
body of ``csrc/split_decode.cuh``, which K5 shares).

K2 runs one block of 128 threads per (slot * KV head, split), a split
being ``SPLIT_POSITIONS`` consecutive positions from position 0, as K5's
splits are at pages of at most 128; the grid has a split for every 128
positions of the cache extent S (the host knows it; the lengths stay on the
device, and a block past its slot's length exits at once). A block takes
the GQA group's query rows in passes of K5's row tile (``row_tile``), and
its shared memory is K5's at int8 pages of 128. This module is pure Python; the C entry
refuses a plan whose split, split count or shared memory is not its own.
"""

from __future__ import annotations

import functools

from qgemm_tpu_torch.ops.cuda.paged_plan import (HEAD_DIMS, MAX_GRID_Y, SMEM_LIMIT,
                                                 SPLIT_POSITIONS, k5_smem, row_tile)
from qgemm_tpu_torch.ops.validation import check

K2_THREADS = 128           # 4 warps, the split body's


def k2_smem(D: int, G: int) -> int:
    """K2's dynamic shared memory at row tile ``G``: K5's at int8 pages of
    128 (one split of ``SPLIT_POSITIONS`` code rows, their scales, the
    scores of the tile's G query rows, their m and l, the P V partial sums
    and the last-block flag)."""
    return k5_smem(8, D, G, SPLIT_POSITIONS)


def k2_plan(D: int, d: int, G: int, S: int, b: int, hkv: int) -> dict:
    """K2's plan for ``b`` slots of ``hkv`` KV heads, ``G`` query rows each,
    over an int8 cache of extent ``S`` and true width ``d`` in a kernel
    compiled for ``D``. Returns ``split_positions``, ``nsplit``, ``grid``
    (slots x KV heads, splits), ``threads``, ``row_tile`` and ``passes``
    (the group's rows a pass, and its passes), ``smem`` (bytes) and
    ``scratch_floats`` (the partial states: m, l and O[G, D] per block)."""
    check(D in HEAD_DIMS, f"K2 is compiled for head widths {HEAD_DIMS}, got {D}")
    check(1 <= d <= D, f"K2: the cache's width d must be 1 to {D}, got {d}")
    tile = row_tile(G)
    check(S >= 1 and b >= 1 and hkv >= 1,
          f"K2: the cache extent, slots and KV heads must be positive, got {S}, {b}, {hkv}")
    nsplit = -(-S // SPLIT_POSITIONS)
    check(nsplit <= MAX_GRID_Y, f"K2: at most {MAX_GRID_Y} splits a slot, got {nsplit}")
    smem = k2_smem(D, tile)
    check(smem <= SMEM_LIMIT, f"K2: {smem} bytes of shared memory")
    return {"split_positions": SPLIT_POSITIONS, "nsplit": nsplit, "grid": (b * hkv, nsplit),
            "threads": K2_THREADS, "row_tile": tile, "passes": -(-G // tile), "smem": smem,
            "scratch_floats": b * hkv * nsplit * G * (D + 2)}


@functools.lru_cache(maxsize=None)
def k2_args(D: int, d: int, G: int, S: int, b: int, hkv: int) -> tuple:
    """K2's C entry's plan arguments (split positions, splits, shared
    memory) and the scratch floats to allocate. Cached: every decode step
    asks."""
    p = k2_plan(D, d, G, S, b, hkv)
    return p["split_positions"], p["nsplit"], p["smem"], p["scratch_floats"]
