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
from qgemm_tpu_torch.ops.cuda.flash_attention_bwd import flash_bwd_plan
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
        assert fwd["grid"][1] == bh and (fwd["grid"][0] - 1) * bq < sq <= fwd["grid"][0] * bq
        assert fwd["threads"] % 32 == 0
        bwd = flash_bwd_plan(dtype, bh, sq, sk, d)
        gq, gk = bwd["grid_dq"], bwd["grid_dkv"]
        assert gq[1] == gk[1] == bh
        assert (gq[0] - 1) * bwd["block_q"] < sq <= gq[0] * bwd["block_q"]
        assert (gk[0] - 1) * bwd["block_k"] < sk <= gk[0] * bwd["block_k"]
        # the delta pre-pass: one warp per query row, 8 rows per 256-thread block
        assert (bwd["grid_delta"][0] - 1) * 8 < bh * sq <= bwd["grid_delta"][0] * 8


@pytest.mark.parametrize("plan", [flash_fwd_plan, flash_bwd_plan])
def test_more_than_65535_batch_heads_raises(plan):
    assert plan(torch.bfloat16, 65535, 8, 8, 128)["route"] == "mma"
    with pytest.raises(ValueError, match="65535"):
        plan(torch.bfloat16, 65536, 8, 8, 128)
    with pytest.raises(ValueError, match="65535"):
        plan(torch.float32, 70000, 8, 8, 64)


@pytest.mark.parametrize("dtype", DTYPES)
def test_d256_tiles(dtype):
    """D 256: the mma route's K3 takes 32-key tiles and its K7 two dK/dV
    blocks per 64 keys (grid z: dV, then dK); the f32 route keeps its
    tiles and grids."""
    fwd = flash_fwd_plan(dtype, 32, 2048, 2048, 256)
    bwd = flash_bwd_plan(dtype, 32, 2048, 2048, 256)
    mma = dtype == torch.bfloat16
    assert fwd["block_k"] == 32 and fwd["block_q"] == 64
    assert bwd["grid_dkv"] == ((32, 32, 2) if mma else (32, 32))
    narrow = flash_bwd_plan(dtype, 32, 2048, 2048, 128)
    assert narrow["grid_dkv"] == (32, 32)
    assert flash_fwd_plan(dtype, 32, 2048, 2048, 128)["block_k"] == (64 if mma else 32)


@pytest.mark.parametrize("d", [48, 257, 512])
@pytest.mark.parametrize("plan", [flash_fwd_plan, flash_bwd_plan])
def test_plans_refuse_uncompiled_widths(plan, d):
    with pytest.raises(ValueError, match="widths"):
        plan(torch.bfloat16, 4, 8, 8, d)
    with pytest.raises(ValueError, match="widths"):
        plan(torch.float32, 4, 8, 8, d)


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
