"""Launch plans of kernels K3 and K7 (``flash_fwd_plan`` in
qgemm_tpu_torch/ops/cuda/flash_attention.py, ``flash_bwd_plan`` in
flash_attention_bwd.py): the route each dtype takes, the dynamic shared
memory each kernel asks for, the grids' coverage of every query and key
row, and the checks that refuse what the kernels cannot take. The plans
are pure Python, so these run without a card; the C entries refuse a plan
whose shared memory differs from their compiled kernels'."""

import pytest
import torch

from qgemm_tpu_torch.ops.cuda.flash_attention import flash_fwd_plan
from qgemm_tpu_torch.ops.cuda.flash_attention_bwd import (WIDE_SMEM, flash_bwd_plan,
                                                          kernel_widths)
from qgemm_tpu_torch.ops.validation import check_aligned16

SMEM_LIMIT = 232448          # the dynamic shared memory one H100 block may use
WIDTHS = (32, 64, 128, 256)  # the kernels' compiled head widths
DTYPES = (torch.bfloat16, torch.float32)
# (Sq, Sk) at the tensor-core tiles' edges (16-row warps, 64-row blocks and
# key tiles), Sq != Sk both ways, and the training shape
LENGTHS = [(1, 1), (1, 129), (63, 64), (64, 65), (65, 63), (129, 1), (300, 72),
           (2048, 2048)]

# the dynamic shared memory of each compiled instantiation, in bytes, as
# the .cu files compute it (bf16: padded bf16 rows; f32: K3's SIMT layout)
SMEM = {(torch.bfloat16, 32): (25600, 30720, 31744),
        (torch.bfloat16, 64): (46080, 55296, 56320),
        (torch.bfloat16, 128): (87040, 104448, 105472),
        (torch.float32, 32): (27648, 36608, 44800),
        (torch.float32, 64): (44032, 61184, 69376),
        (torch.float32, 128): (76800, 110336, 118528),
        (torch.bfloat16, 256): (101376, 202752, 203776),
        (torch.float32, 256): (142336, 208640, 216832)}


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "mma"), (torch.float32, "simt")])
def test_bf16_takes_the_tensor_cores_and_f32_the_simt_kernels(dtype, route, d):
    assert flash_fwd_plan(dtype, 32, 512, 512, d)["route"] == route
    assert flash_bwd_plan(dtype, 32, 512, 512, d)["route"] == route


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_shared_memory_is_the_kernels_and_fits_a_block(dtype, d):
    fwd = flash_fwd_plan(dtype, 128, 2048, 2048, d)
    bwd = flash_bwd_plan(dtype, 128, 2048, 2048, d)
    got = (fwd["smem"], bwd["smem_dq"], bwd["smem_dkv"])
    assert got == SMEM[(dtype, d)]
    assert all(0 < b <= SMEM_LIMIT for b in got)


@pytest.mark.parametrize("sq,sk", LENGTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_grids_cover_every_query_and_key_row(dtype, sq, sk):
    bh = 6
    for d in WIDTHS:
        fwd = flash_fwd_plan(dtype, bh, sq, sk, d)
        bq = fwd["block_q"]
        # one dimension: query tiles fastest, then batch*heads
        nq = fwd["grid"][0] // bh
        assert len(fwd["grid"]) == 1 and nq * bh == fwd["grid"][0]
        assert (nq - 1) * bq < sq <= nq * bq
        assert fwd["threads"] % 32 == 0
        bwd = flash_bwd_plan(dtype, bh, sq, sk, d)
        gq, gk = bwd["grid_dq"], bwd["grid_dkv"]
        assert gq[0] % bh == 0 and gk[0] % bh == 0 and len(gq) == 1
        assert (gq[0] // bh - 1) * bwd["block_q"] < sq <= gq[0] // bh * bwd["block_q"]
        assert (gk[0] // bh - 1) * bwd["block_k"] < sk <= gk[0] // bh * bwd["block_k"]
        # the delta pre-pass: one warp per query row, 8 rows per 256-thread block
        assert (bwd["grid_delta"][0] - 1) * 8 < bh * sq <= bwd["grid_delta"][0] * 8


@pytest.mark.parametrize("bh", [65535, 65536, 70000, 65600 * 32])
@pytest.mark.parametrize("plan", [flash_fwd_plan, flash_bwd_plan])
def test_more_than_65535_batch_heads_run_on_a_flat_grid(plan, bh):
    """Batch*heads past 65,535 (the old grid y's limit) sit on grid x with
    the query or key tiles, whose limit is 2^31 - 1."""
    for dtype, d in ((torch.bfloat16, 128), (torch.float32, 64), (torch.bfloat16, 256)):
        p = plan(dtype, bh, 8, 8, d)
        grids = [p["grid"]] if plan is flash_fwd_plan else [p["grid_delta"], p["grid_dq"],
                                                            p["grid_dkv"]]
        for g in grids:
            assert 1 <= g[0] <= 2 ** 31 - 1 and all(n <= 65535 for n in g[1:])
    with pytest.raises(ValueError, match="limits"):
        plan(torch.bfloat16, 2 ** 31, 8, 8, 128)


@pytest.mark.parametrize("dtype", DTYPES)
def test_d256_tiles(dtype):
    """D 256: the mma route's K3 takes 32-key tiles and its K7 two dK/dV
    blocks per 64 keys (grid z: dV, then dK); the f32 route keeps its
    tiles and grids."""
    fwd = flash_fwd_plan(dtype, 32, 2048, 2048, 256)
    bwd = flash_bwd_plan(dtype, 32, 2048, 2048, 256)
    mma = dtype == torch.bfloat16
    assert fwd["block_k"] == 32 and fwd["block_q"] == 64
    assert bwd["grid_dkv"] == ((32 * 32, 1, 2) if mma else (32 * 32,))
    narrow = flash_bwd_plan(dtype, 32, 2048, 2048, 128)
    assert narrow["grid_dkv"] == (32 * 32,)
    assert flash_fwd_plan(dtype, 32, 2048, 2048, 128)["block_k"] == (64 if mma else 32)


@pytest.mark.parametrize("d", [48, 257, 512])
@pytest.mark.parametrize("plan", [flash_fwd_plan, flash_bwd_plan])
def test_plans_refuse_uncompiled_widths(plan, d):
    """The tiled routes take the compiled widths only; past 256 the wrapper
    asks for the wide route (``test_wide_route_takes_widths_past_256``)."""
    with pytest.raises(ValueError, match="widths"):
        plan(torch.bfloat16, 4, 8, 8, d)
    with pytest.raises(ValueError, match="widths"):
        plan(torch.float32, 4, 8, 8, d)


@pytest.mark.parametrize("d,dv", [(257, 257), (512, 512), (576, 512), (320, 64), (64, 320),
                                  (1024, 1024), (4096, 4096)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_wide_route_takes_widths_past_256(dtype, d, dv):
    """Widths past 256: q/k and v padded each to a multiple of 64
    (``kernel_widths``), the wide route for both dtypes, its shared memory
    one layout that does not grow with the width, its grids one dimension
    within CUDA's limits covering every row and 256-column chunk."""
    dqk, dvp = kernel_widths(d, dv)
    assert dqk % 64 == 0 and dvp % 64 == 0 and d <= dqk < d + 64 and dv <= dvp < dv + 64
    fwd = flash_fwd_plan(dtype, 6, 300, 72, dqk, dvp)
    bwd = flash_bwd_plan(dtype, 6, 300, 72, dqk, dvp)
    assert fwd["route"] == bwd["route"] == "wide"
    assert fwd["smem"] == bwd["smem_dq"] == bwd["smem_dkv"] == WIDE_SMEM <= SMEM_LIMIT
    assert fwd["grid"] == (5 * -(-dvp // 256) * 6,)
    assert bwd["grid_dq"] == (5 * -(-dqk // 256) * 6,)
    assert bwd["grid_dk"] == (2 * -(-dqk // 256) * 6,)
    assert bwd["grid_dv"] == (2 * -(-dvp // 256) * 6,)
    assert kernel_widths(100, 256) == (256, 256) and kernel_widths(1, 1) == (32, 32)


@pytest.mark.parametrize("plan", [flash_fwd_plan, flash_bwd_plan])
def test_plans_refuse_uncompiled_widths_dtypes_and_empty_lengths(plan):
    with pytest.raises(ValueError, match="widths"):
        plan(torch.bfloat16, 4, 8, 8, 48)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        plan(torch.float16, 4, 8, 8, 64)
    with pytest.raises(ValueError, match="sq and sk"):
        plan(torch.bfloat16, 4, 0, 8, 64)


@pytest.mark.parametrize("offset", [1, 2, 4])
def test_unaligned_pointer_raises(offset):
    base = torch.zeros(256, dtype=torch.bfloat16)
    assert base.data_ptr() % 16 == 0
    check_aligned16("K3", base, base[8:])          # 16 bytes in: still aligned
    with pytest.raises(ValueError, match="16-byte aligned"):
        check_aligned16("K3", base, base[offset:])  # 2, 4 or 8 bytes in
