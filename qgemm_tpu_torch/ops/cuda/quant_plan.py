"""Launch plan of kernel K9 (``csrc/col_quantize.cu``, per-column absmax
int8 quantization of a weight [E, K, N] into K-major codes).

The "cluster" route reads w once: a strip of 128 bytes of columns (64 bf16
or 32 f32, one 128-byte line per row) is spread along K over one
thread-block cluster of 1, 2, 4 or 8 blocks (the portable sizes), the
fewest that give each block at most ``TARGET_ROWS`` rows of K; block r holds
the K-slab [r * slab_rows, (r + 1) * slab_rows) in shared memory, slab rows
a multiple of 16 (one 16-byte run of codes). The blocks merge their partial
column maxima through distributed shared memory. Where the slab does not
fit one block's shared memory beside its static arrays (K past
``CLUSTER_MAX_K``), the "two_pass" route runs instead: a memset, an absmax
pass and a quantize pass that reads w a second time (K9's first design).

This module is pure Python, so the CPU tests check it; the C entry
recomputes the plan and refuses any other.
"""

from __future__ import annotations

import functools

from qgemm_tpu_torch.ops.validation import check, check_grid

STRIP_BYTES = 128          # a strip's row of w: one 128-byte line
THREADS = 256
MAX_CLUSTER = 8            # the portable cluster size
ROW_ALIGN = 16             # slab rows: a multiple of one 16-byte run of codes
TARGET_ROWS = 256          # the slab rows a block aims at
RESERVE = 2048             # shared bytes kept beside the slab for its static arrays
SMEM_LIMIT = 232448        # the shared memory one H100 block may use
MAX_SLAB_ROWS = (SMEM_LIMIT - RESERVE) // STRIP_BYTES // ROW_ALIGN * ROW_ALIGN
CLUSTER_MAX_K = MAX_CLUSTER * MAX_SLAB_ROWS
TWO_PASS_TILE_K = 64       # the two_pass quantize blocks' rows
TWO_PASS_COLS = 64         # the two_pass blocks' columns
TWO_PASS_SLAB_K = 256      # the two_pass absmax blocks' rows
ELEM_BYTES = {"float32": 4, "bfloat16": 2}
ROUTES = ("cluster", "two_pass")


def col_quantize_plan(e: int, k: int, n: int, dtype: str) -> dict:
    """K9's plan for ``e`` weights [k, n] of ``dtype`` (``"float32"`` or
    ``"bfloat16"``): ``route``; on the cluster route ``strip_cols``,
    ``cluster``, ``slab_rows``, ``smem`` (dynamic bytes), ``grid`` (strips x
    cluster x e, one dimension) and ``threads``; on the two_pass route the
    scratch it needs (``cmax_words``) and its two grids (one dimension:
    column blocks x row slabs or tiles x e). Every grid is one dimension,
    so e and k may pass 65,535 blocks."""
    check(dtype in ELEM_BYTES, f"K9 takes float32 or bfloat16, got {dtype}")
    check(e >= 1, f"K9 needs at least one weight, got {e}")
    check(k >= 1 and n >= 1, f"K9: k and n must be positive, got {k}, {n}")
    cs = 1
    while cs < MAX_CLUSTER and -(-k // cs) > TARGET_ROWS:
        cs *= 2
    rows = -(-(-(-k // cs)) // ROW_ALIGN) * ROW_ALIGN
    if rows > MAX_SLAB_ROWS:
        nb = -(-n // TWO_PASS_COLS)
        return {"route": "two_pass", "cluster": 0, "slab_rows": 0, "smem": 0,
                "cmax_words": e * n,
                "absmax_grid": check_grid("K9 absmax", (nb * -(-k // TWO_PASS_SLAB_K) * e,)),
                "quant_grid": check_grid("K9 quantize", (nb * -(-k // TWO_PASS_TILE_K) * e,))}
    cols = STRIP_BYTES // ELEM_BYTES[dtype]
    strips = -(-n // cols)
    return {"route": "cluster", "strip_cols": cols, "cluster": cs, "slab_rows": rows,
            "smem": rows * STRIP_BYTES, "grid": check_grid("K9", (strips * cs * e,)),
            "threads": THREADS,
            "cmax_words": 0}


@functools.lru_cache(maxsize=None)
def col_quantize_args(e: int, k: int, n: int, dtype: str) -> tuple:
    """The C entry's plan arguments (route index, cluster, slab rows,
    shared bytes) and the two_pass scratch words. Cached: every expert
    weight of a model asks."""
    p = col_quantize_plan(e, k, n, dtype)
    return ROUTES.index(p["route"]), p["cluster"], p["slab_rows"], p["smem"], p["cmax_words"]
