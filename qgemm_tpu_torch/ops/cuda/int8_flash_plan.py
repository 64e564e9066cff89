"""Launch plan of the int8 flash attention of row 12
(``csrc/int8_flash_attention.cu``): its pre-pass kernels and its wgmma
kernel.

Head widths. Q and K code rows are ``code_row(d)`` bytes: 128 up to d
128, else d padded to 256, 512 or 1024 (``MAX_WIDTH``), loaded as boxes of
128 bytes; V's channels run in chunks of ``dv_pad`` (32, 64 or 128; 128
where d or dv passes 128), one block per chunk, every chunk recomputing S:
P's codes do not depend on V, so the chunks' outputs are the whole one's.

Pre-pass (two launches). The column pass takes one block of
``PREPASS_COL_THREADS`` threads (a thread per channel, in turns past 128) per chunk of
``CHUNK_ROWS`` keys of one batch*head: each thread sums its channel of K
over the chunk's rows in row order, in f32 from 0, and takes the absmax of
its channel of V. The row pass then adds the chunks' partial sums in chunk
order, from 0, and divides by Sk: that is the mean the centered K takes
(``tests/test_torch_int8_flash_plan.py`` mirrors it). Its blocks are of three kinds, in
grid order: Q rows and K rows (``ROWS_PER_BLOCK`` a block, one warp a row
at a time) write int8 codes rows of ``code_row(d)`` bytes (zero past the head
width) and their scales; V blocks of ``KEY_TILE`` keys write V's codes
transposed, ``[BH, v_width, Skp]`` with Skp Sk rounded up to the key tile,
their keys permuted within each group of 32 (``key_of_position``) so that
the P codes a warpgroup holds in registers, in the layout of its S
accumulator, are the A operand of the P V product as they lie. With
``qk_only`` V stays bf16 in key order, the P V product's B operand
MN-major: the main kernel reads the caller's V where it is bf16 with a
multiple of 8 channels (``v_width`` 0: no V blocks), else the V blocks
write a bf16 copy with rows of ``v_width`` channels, zero past dv. The last
K block writes K's scales past Sk as zeros.

Main kernel. One block per (query tile of ``QUERY_TILE`` rows, V chunk,
batch*head), the grid one dimension in that order (``check_grid``):
one consumer warpgroup (wgmma m64) and one producer warp that loads the Q
tile once and keeps a ring of ``stages(d)`` stages (``STAGES``; one at d
past 512, where two would not fit) of K's code tile [128 keys x code row]
and V's transposed tile [DV x 128 keys] (``qk_only``: V's bf16
tile, [128 keys x 64 channels] per 64 channels) full by TMA in the 128-byte
swizzle, and the tile's K row scales by a bulk copy (the
pre-pass writes them [BH, Skp], zero past Sk). Two blocks share an SM
(``BLOCKS_PER_SM``, the kernel's launch bound), so that one's softmax runs
beside the other's products. Scores and P codes convert between int32 and
f32 exactly through a 1.5 * 2^23 bias, at the full f32 rate. S runs the
D / 32 k32 slices of the code rows that hold the padded head width. Causal
grids take their longest query tiles first; a query tile walks the key
tiles up to the one that holds its last row, and masks only where a tile
runs past Sk or, causal, past the tile's first row. This module is pure Python, so the CPU tests check it; the C entries
refuse a plan whose numbers are not their own.
"""

from __future__ import annotations

import numpy as np

from qgemm_tpu_torch.ops.validation import check, check_grid

QUERY_TILE = 64            # query rows a block: one consumer warpgroup
KEY_TILE = 128             # keys a ring stage (KERNEL_KEY_TILE)
CODE_ROW = 128             # bytes of a swizzled box row: a code row up to d 128
STAGES = 2                 # the ring's depth (deeper ran no faster, PERF.md §6)
THREADS = 160              # one consumer warpgroup and one producer warp
BLOCKS_PER_SM = 2          # the main kernel's __launch_bounds__ minimum
HEAD_DIMS = (32, 64, 128)  # compiled chunks of V's channels (DV); D pads to one of them up to 128
WIDE_DIMS = (256, 512, 1024)   # the padded head widths past 128
MAX_WIDTH = WIDE_DIMS[-1]  # the widest d and dv the kernels take
ALIGN = 1024
SMEM_LIMIT = 232448
CHUNK_ROWS = 64            # the column pass's keys a block
MAX_PREPASS_BH = 65535     # a pre-pass launch's batch*heads (grid y); past it the C entry
                           # launches both passes once per 65,535
PREPASS_COL_THREADS = 128
ROWS_PER_BLOCK = 32        # the row pass's Q or K rows a block (8 warps x 4)
PREPASS_ROW_THREADS = 256


def padded_width(d: int) -> int:
    """The compiled width that holds ``d``: 32, 64 or 128 (``HEAD_DIMS``),
    or past 128 256, 512 or 1024 (``WIDE_DIMS``)."""
    check(1 <= d <= MAX_WIDTH, f"the int8 flash kernel takes head widths 1 to {MAX_WIDTH}, "
          f"got {d}")
    return next(w for w in HEAD_DIMS + WIDE_DIMS if d <= w)


def code_row(d: int) -> int:
    """Bytes of a Q or K code row at head width ``d``: 128 up to 128, else
    the padded width."""
    return max(CODE_ROW, padded_width(d))


def chunk_width(d: int, dv: int) -> int:
    """DV, the main kernel's compiled chunk of V's channels: ``dv``'s
    padded width up to d and dv 128, else 128 (a block a chunk)."""
    dv_pad = padded_width(dv)
    return dv_pad if max(padded_width(d), dv_pad) <= CODE_ROW else CODE_ROW


def stages(d: int) -> int:
    """The ring's stages: ``STAGES``, or one at code rows past 512 bytes."""
    return STAGES if code_row(d) <= 512 else 1


def stage_bytes(dv_pad: int, p_int8: bool, d: int = 128) -> int:
    """One ring stage: K's code tile, then V's tile (int8: DV rows of 128
    keys; bf16: a box of 128 keys x 64 channels, 128 bytes a key, per 64
    channels of DV)."""
    v_tile = dv_pad * KEY_TILE if p_int8 else -(-dv_pad // 64) * KEY_TILE * 128
    return KEY_TILE * code_row(d) + v_tile


def flash_smem(dv_pad: int, p_int8: bool, d: int = 128) -> int:
    """Dynamic shared memory: the slack to align to a swizzle atom, the Q
    tile, the ring, then each stage's K row scales (f32, by bulk copy)."""
    n = stages(d)
    return (ALIGN + QUERY_TILE * code_row(d) + n * stage_bytes(dv_pad, p_int8, d)
            + n * KEY_TILE * 4)


def key_of_position(p: int) -> int:
    """The key (within its group of 32) at position ``p`` of V's transposed
    codes: P's S-accumulator fragment holds, in thread t of its quad, keys
    8j + 2t and 8j + 2t + 1 (j = 0..3 in a group of 32), and the k32 A
    operand wants positions 4t..4t+3 and 16+4t..19+4t, so position p takes
    key 16 (p // 16) + 8 ((p % 4) // 2) + 2 ((p // 4) % 4) + p % 2."""
    return 16 * (p // 16) + 8 * ((p % 4) // 2) + 2 * ((p // 4) % 4) + p % 2


def v_positions(skp: int) -> np.ndarray:
    """For each position of a transposed V row of ``skp`` keys, its key."""
    pos = np.arange(skp)
    return pos // 32 * 32 + np.array([key_of_position(p) for p in range(32)])[pos % 32]


def v_width(dv: int, qk_only: bool, f32: bool, d: int = 1) -> int:
    """The rows of V the pre-pass writes: DV (int8 codes transposed), or
    past d or dv 128 dv rounded up to a whole chunk of 128; with
    ``qk_only``, 0 where the main kernel reads the caller's bf16 V (dv a
    multiple of 8), else the bf16 copy's width, dv rounded up to 8."""
    if not qk_only:
        dv_pad = chunk_width(d, dv)
        return -(-dv // dv_pad) * dv_pad
    return 0 if not f32 and dv % 8 == 0 else -(-dv // 8) * 8


def prepass_plan(bh: int, sq: int, sk: int, d: int, dv: int, qk_only: bool,
                 f32: bool) -> dict:
    """The pre-pass's grids and layout for q/k/v in f32 (``f32``) or bf16:
    ``nchunk``, ``col_grid``, ``row_grid`` (a launch's, of at most 65,535
    batch*heads; ``launches``: the two passes per 65,535) (its Q, K and V blocks
    ``nq_blocks``, ``nk_blocks``, ``nv_blocks``), ``skp``, ``dv_pad``,
    ``code_row``, ``v_width``, and the scratch floats of the chunks'
    partial K sums and V maxima."""
    check(bh >= 1, f"the int8 flash kernel needs batch*heads >= 1, got {bh}")
    check(sq >= 1 and sk >= 1, f"the int8 flash kernel takes Sq, Sk >= 1, got {sq}, {sk}")
    padded_width(d)
    dv_pad = chunk_width(d, dv)
    nchunk = -(-sk // CHUNK_ROWS)
    vw = v_width(dv, qk_only, f32, d)
    nq, nk, ntiles = -(-sq // ROWS_PER_BLOCK), -(-sk // ROWS_PER_BLOCK), -(-sk // KEY_TILE)
    nv = ntiles if vw else 0
    per = min(bh, MAX_PREPASS_BH)
    return {"nchunk": nchunk, "col_grid": check_grid("row 12 columns", (nchunk, per)),
            "col_threads": PREPASS_COL_THREADS, "nq_blocks": nq, "nk_blocks": nk,
            "nv_blocks": nv, "row_grid": check_grid("row 12 rows", (nq + nk + nv, per)),
            "launches": 2 * -(-bh // MAX_PREPASS_BH),
            "row_threads": PREPASS_ROW_THREADS, "skp": ntiles * KEY_TILE, "dv_pad": dv_pad,
            "code_row": code_row(d), "v_width": vw,
            "scratch_floats": bh * nchunk * (d + (0 if qk_only else dv))}


def flash_plan(bh: int, sq: int, sk: int, d: int, dv: int, causal: bool, p_int8: bool) -> dict:
    """The main kernel's plan: ``grid`` (query tiles x V chunks x
    batch*heads), ``threads``, ``smem``, ``stages``, ``d_pad``, ``dv_pad``
    (the chunk DV), ``v_chunks`` and ``tile_order``."""
    check(bh >= 1, f"the int8 flash kernel needs batch*heads >= 1, got {bh}")
    check(sq >= 1 and sk >= 1, f"the int8 flash kernel takes Sq, Sk >= 1, got {sq}, {sk}")
    d_pad, dv_pad = padded_width(d), chunk_width(d, dv)
    smem = flash_smem(dv_pad, p_int8, d)
    check(smem <= SMEM_LIMIT, f"the int8 flash kernel: {smem} bytes of shared memory")
    nq, nvc = -(-sq // QUERY_TILE), -(-dv // dv_pad)
    return {"grid": check_grid("row 12", (nq * nvc * bh,)), "threads": THREADS, "smem": smem,
            "stages": stages(d), "d_pad": d_pad, "dv_pad": dv_pad, "v_chunks": nvc,
            "tile_order": "longest first" if causal else "in order"}
