"""Launch plan of the tile kernels (m > 16 rows) of kernels K1, K4 and K8:
``qmm_wgmma_kernel<BM, BN>`` (``csrc/int8_gemm.cuh``, K1 and K8) and
``w4a8_wgmma_kernel<WGS, XR>`` (``csrc/w4a8_matmul.cu``, K4).

A block computes a tile of the output with one consumer warpgroup per 64
rows of wgmma's m64 side and one producer warp that keeps a ring of stages
full by TMA. A stage is one K step of 128 codes (int8: the X codes' tile
[BM x 128] and the weights' tile [BN x 128]; W4A8: the X codes' tile [BM x
128] and the packed weights' tile [BN x 64 bytes], one scale group). The
ring takes as many stages as fit the block's shared memory (at most 8).

This module picks the compiled tile that the card runs fastest by its
model, the stages, the grid and the dynamic shared memory, and describes
the TMA boxes. It is pure Python, so the CPU tests check it; the C entries
refuse a plan whose tile is not compiled or whose shared memory differs
from the compiled kernel's.

The model: a grid's time is its waves of blocks over the 132 SMs times a
block's time, and a block's time is its K steps times its stage's bytes.
It is fitted to a sweep of every compiled tile at GPT_6_7B's and the MoE
model's shapes on the H100 (PERF.md §6), where it picked the fastest tile
or one within 2 % at every swept shape: each int8 tile took in 63-69 GB/s
an SM, so stage bytes track a block's time, though they do not set it
(halving them saved 5-13 %). K4's blocks, held by their fold, followed the
same proportion; its 128-row tiles read half the shared-memory bytes of X
a product that its 64-row tiles read. On a tie the larger tile wins.
"""

from __future__ import annotations

import functools

from qgemm_tpu_torch.ops.cuda.gemv_plan import (GEMV_MAX_M, GROUP, KINDS, MAX_GRID_BATCHES,
                                                SMEM_LIMIT, SMS)
from qgemm_tpu_torch.ops.validation import check, check_grid

K_STEP = 128             # K codes per ring stage (one 128-byte swizzled row); W4A8: one group
ALIGN = 1024             # a 128-byte swizzle atom: the ring starts on one
MAX_STAGES = 8
# the compiled tiles (rows, columns), rows = 64 x consumer warpgroups
INT8_TILES = ((64, 32), (64, 64), (64, 128), (64, 256), (128, 128), (128, 256))
# K4: 64 or 128 x rows (wgmma's N) by 64 or 128 output columns (wgmma's m64 a warpgroup)
W4_TILES = ((64, 64), (64, 128), (128, 64), (128, 128))


def stage_bytes(kind: str, bm: int, bn: int) -> int:
    """Shared memory of one ring stage: the X codes' tile, then the
    weights' (int8 codes, or W4A8's packed bytes: half)."""
    return bm * K_STEP + bn * (K_STEP if kind == "int8" else K_STEP // 2)


def fold_bytes(kind: str, bm: int, bn: int) -> int:
    """Shared memory K4 keeps after the ring: per consumer thread (128 per
    64 output columns) its bm / 2 f32 totals and its rows' bm / 4 slab
    scales."""
    return 0 if kind == "int8" else 128 * (bn // 64) * (bm // 2 + bm // 4) * 4


def ring_stages(kind: str, bm: int, bn: int) -> int:
    """Stages that fit beside the alignment slack, the barriers and K4's
    fold state, as ``sm90::ring_stages`` computes them (at most
    ``MAX_STAGES``)."""
    room = SMEM_LIMIT - 2 * ALIGN - fold_bytes(kind, bm, bn)
    return min(MAX_STAGES, room // stage_bytes(kind, bm, bn))


def tile_smem(kind: str, bm: int, bn: int) -> int:
    """Dynamic shared memory of the compiled tile: the slack to align the
    ring to a swizzle atom, its stages, then K4's fold state."""
    return (ALIGN + ring_stages(kind, bm, bn) * stage_bytes(kind, bm, bn)
            + fold_bytes(kind, bm, bn))


def _blocks(batches: int, m: int, n: int, bm: int, bn: int) -> int:
    return batches * -(-m // bm) * -(-n // bn)


def tile_plan(kind: str, batches: int, m: int, n: int, k: int, kp: int = None,
              bk: int = None) -> dict:
    """The tile kernel's launch plan for ``batches`` products (K8's experts;
    1 for K1 and K4) of ``m`` rows (more than 16) of K ``k`` into ``n``
    columns.

    ``kind`` "int8" (K1, K8): k is a multiple of 16 (the wrappers pad it);
    the ring walks ``k_steps`` steps of 128 codes, the last one ragged (TMA
    reads zeros past k). "w4a8" (K4): ``kp`` is k rounded up to the
    128-row group and ``bk`` the activation slab (a multiple of 128); a
    stage is one group, and one block walks every group of K in order, so
    no slab is split.

    Returns the kind, ``bm`` (rows of x a block takes), ``bn`` (output
    columns), ``consumers`` (warpgroups), ``threads``, ``stages``,
    ``stage_bytes``, ``k_steps``, ``grid`` (row blocks, column blocks,
    batches: a column block's row blocks run together and read its weights
    once; past 65,535 batches a launch's: ``launches`` launches of at most
    65,535 each), ``smem`` (bytes) and ``tma``: per operand its box (inner
    bytes, rows) and global pitches (row, batch) in bytes."""
    check(kind in KINDS, f"tile_plan: kind must be one of {KINDS}, got {kind!r}")
    check(m > GEMV_MAX_M, f"tile_plan: the tile kernels take more than {GEMV_MAX_M} rows, "
                          f"got {m}")
    check(batches > 0, f"tile_plan: batches must be positive, got {batches}")
    check(n > 0 and k > 0, f"tile_plan: n and k must be positive, got {n}, {k}")
    if kind == "int8":
        check(k % 16 == 0, f"tile_plan: int8 K must be a multiple of 16, got {k}")
        check(kp is None and bk is None, "tile_plan: kp and bk are for w4a8")
        tiles, kx, kw, steps = INT8_TILES, k, k, -(-k // K_STEP)
    else:
        check(batches == 1, f"tile_plan: w4a8 takes one matrix, got {batches}")
        check(kp is not None and bk is not None, "tile_plan: w4a8 needs kp and bk")
        check(kp % GROUP == 0 and k <= kp < k + GROUP,
              f"tile_plan: kp must be k={k} rounded up to {GROUP}, got {kp}")
        check(bk > 0 and bk % GROUP == 0,
              f"tile_plan: bk must be a positive multiple of {GROUP}, got {bk}")
        tiles, kx, kw, steps = W4_TILES, kp, kp // 2, kp // GROUP
    # x rows past 64 only where m needs them
    fit = [t for t in tiles if t[0] == 64 or m > 64]

    def cost(t):
        bm, bn = t
        waves = -(-_blocks(batches, m, n, bm, bn) // SMS)
        return (waves * stage_bytes(kind, bm, bn), -bm * bn, -bm)

    bm, bn = min(fit, key=cost)
    plan = {"kind": kind, "bm": bm, "bn": bn, "consumers": (bn if kind == "w4a8" else bm) // 64,
            "stages": ring_stages(kind, bm, bn), "stage_bytes": stage_bytes(kind, bm, bn),
            "k_steps": steps,
            "grid": check_grid("tile_plan", (-(-m // bm), -(-n // bn),
                                             min(batches, MAX_GRID_BATCHES))),
            "launches": -(-batches // MAX_GRID_BATCHES),
            "smem": tile_smem(kind, bm, bn),
            "tma": {"x": {"box": (K_STEP, bm), "pitch": (kx, m * kx)},
                    "w": {"box": (K_STEP if kind == "int8" else GROUP // 2, bn),
                          "pitch": (kw, n * kw)}}}
    plan["threads"] = 128 * plan["consumers"] + 32
    check(plan["smem"] <= SMEM_LIMIT, f"tile_plan: {plan['smem']} bytes of shared memory")
    return plan


@functools.lru_cache(maxsize=None)
def tile_args(kind: str, batches: int, m: int, n: int, k: int, kp: int = None,
              bk: int = None) -> tuple:
    """The C entries' tile arguments (rows, columns, shared memory bytes) of
    ``tile_plan``, or zeros for m <= 16, where the GEMVs run. Cached: every
    prefill GEMM asks for it."""
    if m <= GEMV_MAX_M:
        return (0, 0, 0)
    p = tile_plan(kind, batches, m, n, k, kp, bk)
    return (p["bm"], p["bn"], p["smem"])
