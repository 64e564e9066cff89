"""Launch plan of kernel K2's int8 route (``csrc/decode_attention.cu``, one
decode step over the dense int8 KV cache as flash-decoding on the split
body of ``csrc/split_decode.cuh``, which K5 shares).

K2 runs one block of 128 threads per (slot * KV head, split), a split
being ``split_positions(D)`` consecutive positions from position 0 (128;
64 at D 1024), as K5's splits are on int8 pools (``paged_plan.aligned``,
and at the first pages that divide it); the grid (slot * KV head, split;
a launch per 65,535 splits) has a split for every split's positions of the
cache extent S (the host knows it; the lengths stay on the device, and a
block past its slot's length exits at once). A block takes the GQA
group's query rows in passes of K5's row tile (``row_tile``), and its
shared memory is K5's at int8 pages of one split. This module is pure
Python; the C entry refuses a plan whose split, split count or shared
memory is not its own.
"""

from __future__ import annotations

import functools

from qgemm_tpu_torch.ops.cuda.paged_plan import (HEAD_DIMS, MAX_GRID_SPLITS,  # noqa: F401
                                                 SMEM_LIMIT, SPLIT_POSITIONS, k5_smem,
                                                 row_tile, split_positions)
from qgemm_tpu_torch.ops.validation import check, check_grid

K2_THREADS = 128           # 4 warps, the split body's


def k2_smem(D: int, G: int) -> int:
    """K2's dynamic shared memory at row tile ``G``: K5's at int8 pages of
    one split (``split_positions(D)`` code rows, their scales, the scores
    of the tile's G query rows, their m and l, the P V partial sums and the
    last-block flag)."""
    return k5_smem(8, D, G, split_positions(D))


def k2_plan(D: int, d: int, G: int, S: int, b: int, hkv: int) -> dict:
    """K2's plan for ``b`` slots of ``hkv`` KV heads, ``G`` query rows each,
    over an int8 cache of extent ``S`` and true width ``d`` in a kernel
    compiled for ``D``. Returns ``split_positions``, ``nsplit``, ``grid``
    (slots x KV heads, splits: a launch's), ``launches`` (one per 65,535
    splits), ``threads``, ``row_tile`` and ``passes``
    (the group's rows a pass, and its passes), ``smem`` (bytes) and
    ``scratch_floats`` (the partial states: m, l and O[G, D] per block)."""
    check(D in HEAD_DIMS, f"K2 is compiled for head widths {HEAD_DIMS}, got {D}")
    check(1 <= d <= D, f"K2: the cache's width d must be 1 to {D}, got {d}")
    tile = row_tile(G, D)
    check(S >= 1 and b >= 1 and hkv >= 1,
          f"K2: the cache extent, slots and KV heads must be positive, got {S}, {b}, {hkv}")
    sp = split_positions(D)
    nsplit = -(-S // sp)
    smem = k2_smem(D, tile)
    check(smem <= SMEM_LIMIT, f"K2: {smem} bytes of shared memory")
    return {"split_positions": sp, "nsplit": nsplit,
            "grid": check_grid("K2", (b * hkv, min(nsplit, MAX_GRID_SPLITS))),
            "launches": -(-nsplit // MAX_GRID_SPLITS), "threads": K2_THREADS,
            "row_tile": tile, "passes": -(-G // tile), "smem": smem,
            "scratch_floats": b * hkv * nsplit * G * (D + 2)}


@functools.lru_cache(maxsize=None)
def k2_args(D: int, d: int, G: int, S: int, b: int, hkv: int) -> tuple:
    """K2's C entry's plan arguments (split positions, splits, shared
    memory) and the scratch floats to allocate. Cached: every decode step
    asks."""
    p = k2_plan(D, d, G, S, b, hkv)
    return p["split_positions"], p["nsplit"], p["smem"], p["scratch_floats"]
