"""Launch plan of the decode GEMVs (m <= 16 rows) of kernels K1, K4 and K8:
``qmm_gemv_kernel`` (``csrc/int8_gemm.cuh``, K1 and K8) and
``w4a8_gemv_kernel`` (``csrc/w4a8_matmul.cu``, K4).

Each warp owns a slice of K and streams the block's column tiles (16
output columns each, the A operand of ``mma.sync m16n8k32``) over it,
with the slice's X codes held in registers as B fragments; the block's
warps then meet once in shared memory: int32 partials summed (int8), or
per-group f32 products folded in the plain version's order (W4A8). This
module picks the warps per block, the K slice per warp, the column tiles
per block, the grid and the dynamic shared memory. It is pure Python, so
the CPU tests check it; the C entries refuse a plan that matches no
compiled instantiation or whose shared memory differs from theirs.

Tiles per block, from a sweep of the compiled plans on the H100 (PERF.md
§6): the int8 GEMV was fastest with one tile per block at every GPT_6_7B
decode shape, so it is compiled for one; the W4A8 GEMV folds its groups once
per block, and takes the most tiles that still give every SM a block
(four at n 16384 and 50272, one at 4096).
"""

from __future__ import annotations

import functools

from qgemm_tpu_torch.ops.validation import check, check_grid

GEMV_MAX_M = 16          # rows the GEMV takes; more go to the mma.sync tile kernels
COL_TILE = 16            # output columns per tile (the m16 side of m16n8k32)
W4_TILES_PER_BLOCK = (4, 2, 1)   # the W4A8 GEMV's compiled tiles per block, largest first
MAX_WARPS = 8            # warps per block along K (256 threads)
INT8_STEP = 64           # K codes per lane step of the int8 GEMV: two k32 mma
GROUP = 128              # W4A8 scale group along K: four k32 mma
MAX_GROUPS_PER_WARP = 16  # the W4A8 GEMV's largest compiled K slice, in groups
SMS = 132                # the H100's streaming multiprocessors
W4_SMEM_CAP = 144 * 1024  # the W4A8 group products a block may hold at once
MAX_GRID_BATCHES = 65535   # a launch's batches (grid y); the C entries launch once per
                           # 65,535 batches past it
SMEM_LIMIT = 232448      # the dynamic shared memory one H100 block may use
KINDS = ("int8", "w4a8")


def _w4_tiles_per_block(batches: int, tiles: int, fits) -> int:
    """The most column tiles per block that still give each SM a block (and
    whose shared memory ``fits``), else one."""
    for ct in W4_TILES_PER_BLOCK:
        if batches * -(-tiles // ct) >= SMS and fits(ct):
            return ct
    return 1


def gemv_plan(kind: str, batches: int, m: int, n: int, k: int, kp: int = None,
              bk: int = None) -> dict:
    """The decode GEMV's launch plan for ``batches`` products (K8's experts;
    1 for K1 and K4) of ``m`` rows (1 to 16) of K ``k`` into ``n`` columns.

    ``kind`` "int8" (K1, K8): k is a multiple of 16 (the wrappers pad it);
    warps take slices of ``k_slice`` codes, multiples of 64. "w4a8" (K4):
    ``kp`` is k rounded up to the 128-row group and ``bk`` the activation
    slab (``w4a8_slab``, a multiple of 128); warps take ``groups_per_warp``
    whole groups, a power of two that divides the slab's groups (any, when
    one slab holds all of K), so no slice crosses a slab, and a block
    walks K in ``rounds`` of ``warps * groups_per_warp`` groups when one
    round's products would not fit ``W4_SMEM_CAP``.

    Returns the kind, ``nr`` (n8 tiles of rows: 1 for m <= 8, else 2),
    ``warps``, ``threads``, ``k_slice``, ``tiles_per_block`` (``ct``),
    ``grid`` (column blocks, batches; past 65,535 batches a launch's:
    ``launches`` launches of at most 65,535 each), ``smem`` (bytes), and
    for W4A8
    ``groups_per_warp`` and ``rounds``."""
    check(kind in KINDS, f"gemv_plan: kind must be one of {KINDS}, got {kind!r}")
    check(1 <= m <= GEMV_MAX_M, f"gemv_plan: the GEMV takes 1 to {GEMV_MAX_M} rows, got {m}")
    check(batches > 0, f"gemv_plan: batches must be positive, got {batches}")
    check(n > 0 and k > 0, f"gemv_plan: n and k must be positive, got {n}, {k}")
    nr = 1 if m <= 8 else 2
    rows = 8 * nr                  # rows of the B operand the warps compute
    tiles = -(-n // COL_TILE)
    if kind == "int8":
        check(k % 16 == 0, f"gemv_plan: int8 K must be a multiple of 16, got {k}")
        check(kp is None and bk is None, "gemv_plan: kp and bk are for w4a8")
        steps = -(-k // INT8_STEP)
        per_warp = -(-steps // min(MAX_WARPS, steps))
        warps = -(-steps // per_warp)
        ct = 1                     # the int8 GEMV is compiled for one tile per block
        plan = {"k_slice": per_warp * INT8_STEP,
                # int32 partials [warps][16 columns][rows]
                "smem": 4 * warps * COL_TILE * rows}
    else:
        check(kp is not None and bk is not None, "gemv_plan: w4a8 needs kp and bk")
        check(kp % GROUP == 0 and k <= kp < k + GROUP,
              f"gemv_plan: kp must be k={k} rounded up to {GROUP}, got {kp}")
        check(bk > 0 and bk % GROUP == 0,
              f"gemv_plan: bk must be a positive multiple of {GROUP}, got {bk}")
        groups, slab = kp // GROUP, bk // GROUP
        gs = 1
        while (gs < MAX_GROUPS_PER_WARP and gs * MAX_WARPS < groups
               and (slab >= groups or slab % (2 * gs) == 0)):
            gs *= 2

        def smem(ct: int, gs: int) -> int:
            # f32 group products [warps * gs][ct * 16][rows] + fold state [2][ct * 16][rows]
            warps = min(MAX_WARPS, -(-groups // gs))
            return 4 * (warps * gs + 2) * ct * COL_TILE * rows

        while gs > 1 and smem(1, gs) > W4_SMEM_CAP:
            gs //= 2
        warps = min(MAX_WARPS, -(-groups // gs))
        ct = _w4_tiles_per_block(batches, tiles, lambda c: smem(c, gs) <= W4_SMEM_CAP)
        plan = {"k_slice": gs * GROUP, "groups_per_warp": gs,
                "rounds": -(-groups // (warps * gs)), "smem": smem(ct, gs)}
    plan.update(kind=kind, nr=nr, warps=warps, threads=32 * warps, tiles_per_block=ct,
                grid=check_grid("gemv_plan", (-(-tiles // ct), min(batches, MAX_GRID_BATCHES))),
                launches=-(-batches // MAX_GRID_BATCHES))
    check(plan["smem"] <= SMEM_LIMIT, f"gemv_plan: {plan['smem']} bytes of shared memory")
    return plan


@functools.lru_cache(maxsize=None)
def gemv_args(kind: str, batches: int, m: int, n: int, k: int, kp: int = None,
              bk: int = None) -> tuple:
    """The C entries' plan arguments, or zeros for m > 16, where the tile
    kernels run: (warps, ``k_slice``, shared memory bytes) for int8, whose
    GEMV takes one tile per block; (warps, ``groups_per_warp``, tiles per
    block, shared memory bytes) for w4a8. Cached: every decode GEMV asks
    for it."""
    if m > GEMV_MAX_M:
        return (0, 0, 0) if kind == "int8" else (0, 0, 0, 0)
    p = gemv_plan(kind, batches, m, n, k, kp, bk)
    if kind == "int8":
        return (p["warps"], p["k_slice"], p["smem"])
    return (p["warps"], p["groups_per_warp"], p["tiles_per_block"], p["smem"])
