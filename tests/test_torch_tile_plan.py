"""Launch plan of the tile kernels (m > 16 rows) of kernels K1, K4 and K8
(``tile_plan`` in qgemm_tpu_torch/ops/cuda/tile_plan.py): the compiled
tiles it picks, the shared memory it asks for, the coverage of every
output element by the grid, the K steps of 128 codes (whole groups for
K4, walked in order, so no slab is split), the TMA boxes and pitches, the
refusals, and, on the plain versions' own int32 sums, that the kernels'
K walk and K4's fold of 16-times codes reproduce the plain results bit for
bit. The plan is pure Python, so these run without a card; the C entries
refuse a plan whose tile or shared memory is not a compiled kernel's."""

import numpy as np
import pytest
import torch

from qgemm_tpu_torch.ops.cuda.expert_matmul import grouped_quantized_matmul_plain
from qgemm_tpu_torch.ops.cuda.tile_plan import tile_args, tile_plan
from qgemm_tpu_torch.ops.quantize import (GROUP, QRANGE, W4RANGE, _div, absmax_quantize,
                                          int8_matmul, quantize_weights, quantize_weights_int4,
                                          unpack_int4, w4a8_matmul_plain, w4a8_slab)
from qgemm_tpu_torch.utils.testing import use_test_threads

use_test_threads()

SMEM_LIMIT = 232448        # the dynamic shared memory one H100 block may use
SMS = 132                  # the H100's streaming multiprocessors
# the compiled tiles (rows, columns), as csrc/int8_gemm.cuh and w4a8_matmul.cu list them
COMPILED = {"int8": {(64, 32), (64, 64), (64, 128), (64, 256), (128, 128), (128, 256)},
            "w4a8": {(64, 64), (64, 128), (128, 64), (128, 128)}}
# (batches, n, k): GPT_6_7B's GEMMs (QKV / W_O, FFN up, FFN down, lm_head),
# the MoE model's expert products (E 8) and its dense ones (d_model 2048),
# and the shape_limits phase's n 96 at k 3, 17, 784 and K8's n 48 at k 17
GPT_SHAPES = [(1, 4096, 4096), (1, 16384, 4096), (1, 4096, 16384), (1, 50272, 4096)]
MOE_SHAPES = [(8, 4096, 2048), (8, 2048, 4096), (1, 2048, 2048), (1, 50272, 2048),
              (1, 4096, 2048), (1, 2048, 4096)]
LIMIT_SHAPES = [(1, 96, 3), (1, 96, 17), (1, 96, 784), (8, 48, 17)]
SHAPES = GPT_SHAPES + MOE_SHAPES + LIMIT_SHAPES
# prefill rows: the engine's power-of-two buckets, the parity phase's edges
# and ragged rows, the MoE capacities C 17, 168 (512-token bucket) and 328
ROWS = (17, 32, 40, 63, 64, 65, 128, 168, 256, 300, 328, 512, 2048)


def _kp(k):
    return -(-k // GROUP) * GROUP


def _plan(kind, e, m, n, k):
    if kind == "int8":
        return tile_plan("int8", e, m, n, -(-k // 16) * 16)
    return tile_plan("w4a8", 1, m, n, k, _kp(k), w4a8_slab(_kp(k)))


def _smem(kind, bm, bn):
    """The compiled kernels' shared memory, as sm90::ring_stages and the
    TileCfg / W4TileCfg structs compute it: 1024 bytes of alignment slack,
    then min(8, (232448 - 2048 - fold) // stage) stages, then K4's fold
    state (3 bm bytes a consumer thread, 128 threads per 64 columns)."""
    stage = bm * 128 + bn * (128 if kind == "int8" else 64)
    fold = 0 if kind == "int8" else 3 * bm * 128 * (bn // 64)
    return 1024 + min(8, (SMEM_LIMIT - 2048 - fold) // stage) * stage + fold


CASES = [(kind, e, n, k) for kind in ("int8", "w4a8") for e, n, k in SHAPES
         if kind == "int8" or e == 1]


def _once(extent, tile, blocks):
    """Blocks of ``tile`` along an axis of ``extent`` cover each index once."""
    covered = np.zeros(blocks * tile, dtype=np.int64)
    for b in range(blocks):
        covered[b * tile:(b + 1) * tile] += 1
    return (covered[:extent] == 1).all() and (blocks - 1) * tile < extent


@pytest.mark.parametrize("kind,e,n,k", CASES)
def test_every_output_element_is_covered_once(kind, e, n, k):
    """The grid is (column blocks, row blocks, batches), a product: each
    output element is covered once when each axis is."""
    for m in ROWS:
        p = _plan(kind, e, m, n, k)
        gx, gy, gz = p["grid"]          # row blocks first
        assert gz == e
        assert _once(m, p["bm"], gx) and _once(n, p["bn"], gy)


@pytest.mark.parametrize("kind,e,n,k", CASES)
def test_instantiation_and_shared_memory_are_the_compiled_kernels(kind, e, n, k):
    for m in ROWS:
        p = _plan(kind, e, m, n, k)
        assert (p["bm"], p["bn"]) in COMPILED[kind]
        # 64 x rows per consumer warpgroup (int8), 64 output columns (w4a8)
        assert p["consumers"] == (p["bm"] if kind == "int8" else p["bn"]) // 64
        assert p["threads"] == 128 * p["consumers"] + 32
        assert 0 < p["smem"] == _smem(kind, p["bm"], p["bn"]) <= SMEM_LIMIT
        assert p["smem"] == (1024 + p["stages"] * p["stage_bytes"]
                             + (0 if kind == "int8" else 6 * p["bm"] * p["bn"]))
        assert 3 <= p["stages"] <= 8
        # each stage starts on a 1024-byte swizzle atom
        assert p["stage_bytes"] % 1024 == 0 and (p["bm"] * 128) % 1024 == 0
        if m <= 64:            # x rows a block takes: no 128-row tile for 64 rows
            assert p["bm"] == 64


@pytest.mark.parametrize("kind,e,n,k", CASES)
def test_k_steps_are_128_codes_and_w4a8_groups_stay_in_their_slab(kind, e, n, k):
    for m in (17, 512):
        p = _plan(kind, e, m, n, k)
        kk = -(-k // 16) * 16 if kind == "int8" else _kp(k)
        assert p["k_steps"] == -(-kk // 128)
        assert p["tma"]["x"]["box"][0] == 128
        if kind == "w4a8":
            # a stage is one scale group; one block walks groups 0 .. ng - 1
            # in order, so every slab's groups are folded together, in order
            bk = w4a8_slab(kk)
            assert bk % GROUP == 0 and p["k_steps"] == kk // GROUP
            assert p["tma"]["w"]["box"][0] == GROUP // 2
            slabs = [g * GROUP // bk for g in range(p["k_steps"])]
            assert slabs == sorted(slabs)


@pytest.mark.parametrize("kind,e,n,k", CASES)
def test_tma_boxes_and_pitches(kind, e, n, k):
    """Box sides at most 256 elements; the inner side at most the swizzle's
    width (128 bytes for the codes, 64 for W4A8's packed weights); global
    pitches (row, batch) multiples of 16 bytes."""
    for m in ROWS:
        p = _plan(kind, e, m, n, k)
        for op, swizzle in (("x", 128), ("w", 128 if kind == "int8" else 64)):
            inner, rows = p["tma"][op]["box"]
            assert inner <= swizzle and rows <= 256 and inner % 16 == 0
            assert all(pitch % 16 == 0 for pitch in p["tma"][op]["pitch"])
        assert p["tma"]["x"]["box"][1] == p["bm"] and p["tma"]["w"]["box"][1] == p["bn"]


@pytest.mark.parametrize("kind,k,n", [("int8", 4096, 4096), ("int8", 16384, 4096),
                                      ("w4a8", 4096, 16384), ("w4a8", 4096, 50272)])
def test_prefill_buckets_fill_the_card(kind, k, n):
    """At the prefill buckets from 128 rows on, the grid gives every SM a
    block or comes within 4 of it (128 blocks: 4 x 32 of 128 x 128)."""
    for m in (128, 256, 512, 2048):
        gx, gy, gz = _plan(kind, 1, m, n, k)["grid"]
        assert gx * gy * gz >= SMS - 4


def test_pinned_plans():
    pick = lambda *a: (lambda p: (p["bm"], p["bn"]))(tile_plan(*a))
    # GPT_6_7B at m 512: QKV/W_O and FFN down 128 x 128 (128 blocks), FFN up
    # and lm_head 128 x 256
    assert [pick("int8", 1, 512, n, k) for n, k in
            ((4096, 4096), (16384, 4096), (4096, 16384), (50272, 4096))] == [
        (128, 128), (128, 256), (128, 128), (128, 256)]
    # the smaller buckets trade tile size for blocks
    assert pick("int8", 1, 256, 4096, 4096) == (64, 128)
    assert pick("int8", 1, 128, 4096, 4096) == (64, 64)
    assert pick("int8", 1, 32, 4096, 4096) == (64, 32)
    assert pick("int8", 1, 2048, 2048, 2048) == (128, 256)
    # ragged rows: the fewest stage bytes per wave wins over less padding
    assert pick("int8", 1, 300, 4100, 4096) == (128, 128)
    assert pick("int8", 8, 168, 4096, 2048) == (128, 256)
    assert pick("w4a8", 1, 512, 4096, 4096, 4096, 2048) == (128, 128)
    assert pick("w4a8", 1, 256, 4096, 4096, 4096, 2048) == (64, 128)
    assert pick("w4a8", 1, 128, 4096, 4096, 4096, 2048) == (64, 64)
    p = tile_plan("int8", 1, 512, 4096, 4096)
    assert (p["stages"], p["smem"], p["grid"], p["threads"]) == (7, 230400, (4, 32, 1), 288)
    p = tile_plan("w4a8", 1, 512, 4096, 4096, 4096, 2048)
    assert (p["stages"], p["smem"], p["grid"], p["threads"]) == (5, 222208, (4, 32, 1), 288)


def test_tile_args_are_the_plans_and_zero_at_16_rows_and_fewer():
    p = tile_plan("int8", 8, 168, 4096, 2048)
    assert tile_args("int8", 8, 168, 4096, 2048) == (p["bm"], p["bn"], p["smem"])
    p = tile_plan("w4a8", 1, 300, 4100, 4096, 4096, 2048)
    assert tile_args("w4a8", 1, 300, 4100, 4096, 4096, 2048) == (p["bm"], p["bn"], p["smem"])
    assert tile_args("int8", 1, 16, 4096, 4096) == (0, 0, 0)
    assert tile_args("w4a8", 1, 1, 4096, 4096, 4096, 2048) == (0, 0, 0)


@pytest.mark.parametrize("args,match", [
    (("int4", 1, 32, 64, 64), "kind"),
    (("int8", 1, 16, 64, 64), "more than 16 rows"),
    (("int8", 1, 0, 64, 64), "more than 16 rows"),
    (("int8", 0, 32, 64, 64), "batches"),
    (("int8", -1, 32, 64, 64), "batches"),
    (("int8", 1, 32, 0, 64), "positive"),
    (("int8", 1, 32, 64, 24), "multiple of 16"),
    (("int8", 1, 32, 64, 64, 128, 128), "kp and bk are for w4a8"),
    (("w4a8", 1, 32, 64, 64), "needs kp and bk"),
    (("w4a8", 8, 32, 64, 128, 128, 128), "one matrix"),
    (("w4a8", 1, 32, 64, 200, 128, 128), "rounded up"),
    (("w4a8", 1, 32, 64, 200, 384, 256), "rounded up"),
    (("w4a8", 1, 32, 64, 4096, 4096, 0), "bk must be"),
    (("w4a8", 1, 32, 64, 200, 256, 192), "bk must be"),
])
def test_plan_refuses_what_the_kernels_cannot_take(args, match):
    with pytest.raises(ValueError, match=match):
        tile_plan(*args)


@pytest.mark.parametrize("batches", [65535, 65536, 65600, 200000])
def test_past_65535_batches_the_entry_launches_per_65535(batches):
    """K8's experts past a grid z's 65,535: a launch takes at most 65,535
    of them (its grid within CUDA's limits) and the C entry launches
    ``launches`` times, each with tensor maps of its chunk's experts."""
    p = tile_plan("int8", batches, 32, 16, 64)
    assert p["grid"][2] == min(batches, 65535) and all(g <= 65535 for g in p["grid"][1:])
    assert p["launches"] == -(-batches // 65535)


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("m,k,n", [(17, 4096, 40), (65, 784, 33), (40, 17, 24), (300, 16384, 8)])
def test_int8_k_steps_give_the_plain_bits(m, k, n):
    """The tile kernel's exact int32 sum over the plan's K steps of 128
    codes (the last one ragged, zeros past k), then K1's epilogue: bit-equal
    to the plain version in the kernels' epilogue order (K8's plain
    version, one expert)."""
    x = torch.from_numpy(_rng(1).standard_normal((m, k)).astype(np.float32))
    wq = quantize_weights(torch.from_numpy(_rng(2).standard_normal((k, n)).astype(np.float32)))
    kp = -(-k // 16) * 16
    plan = tile_plan("int8", 1, m, n, kp)
    xq, cx = absmax_quantize(torch.nn.functional.pad(x, (0, kp - k)), axis=-1)
    wt = torch.nn.functional.pad(wq.qt, (0, kp - k))
    acc = sum(int8_matmul(xq[:, s * 128:(s + 1) * 128], wt[:, s * 128:(s + 1) * 128].t())
              for s in range(plan["k_steps"]))
    got = (acc.to(torch.float32) * (cx * (1.0 / (QRANGE * QRANGE)))) * wq.c
    ref = grouped_quantized_matmul_plain(x[None], wq.qt[None], wq.c[None])[0]
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("m,k,n", [(17, 4500, 40), (64, 4096, 32), (65, 16384, 16), (40, 3, 17),
                                   (300, 784, 20)])
def test_w4a8_fold_of_16_times_codes_gives_the_plain_bits(m, k, n):
    """K4's tile kernel: the weights' nibbles sit in the high half of their
    bytes (16 times the code), so each group's exact int32 sum is 16 isum;
    per group, in the plan's K order, f32(16 isum) * cw is added to the
    slab's sum; at each slab's end the sum times ds / 16 (ds = cx / 889) is
    added to the total: bit-equal to ``w4a8_matmul_plain``."""
    x = torch.from_numpy(_rng(3).standard_normal((m, k)).astype(np.float32))
    x[:, : min(k, 2048)] *= 8.0
    wq4 = quantize_weights_int4(
        torch.from_numpy(_rng(4).standard_normal((k, n)).astype(np.float32) * 0.02))
    kp = 2 * wq4.qpt.shape[1]
    bk = w4a8_slab(kp)
    plan = tile_plan("w4a8", 1, m, n, k, kp, bk)
    # the packed bytes' nibbles moved to the high half: byte & 0xF0 as int8
    packed = wq4.qpt.to(torch.int32) & 0xFF                      # [n, kp / 2]
    lo16 = ((packed << 4) & 0xF0).to(torch.uint8).view(torch.int8)  # k 0..63 of each group
    hi16 = (packed & 0xF0).to(torch.uint8).view(torch.int8)        # k 64..127
    ng = kp // GROUP
    w16 = torch.stack([lo16.reshape(n, ng, 64), hi16.reshape(n, ng, 64)], dim=2)
    w16 = w16.reshape(n, kp).t().to(torch.int32)                  # [kp, n]
    assert torch.equal(w16, 16 * unpack_int4(wq4.qp).to(torch.int32))
    xf = torch.nn.functional.pad(x, (0, kp - k))
    codes, ds = [], []
    for s0 in range(0, kp, bk):
        q, c = absmax_quantize(xf[:, s0:s0 + bk], axis=-1)
        codes.append(q)
        ds.append(_div(QRANGE * W4RANGE, c) * 0.0625)
    xq = torch.cat(codes, dim=1).to(torch.int32)
    gps = bk // GROUP
    sacc = torch.zeros((m, n), dtype=torch.float32)
    tot = torch.zeros((m, n), dtype=torch.float32)
    for gi in range(plan["k_steps"]):             # one group a stage, in order
        sl = slice(gi * GROUP, (gi + 1) * GROUP)
        isum16 = xq[:, sl] @ w16[sl]
        sacc = sacc + isum16.to(torch.float32) * wq4.c[gi]
        if (gi + 1) % gps == 0 or gi + 1 == ng:
            tot = tot + sacc * ds[gi // gps]
            sacc = torch.zeros_like(sacc)
    ref = w4a8_matmul_plain(x, wq4)
    assert torch.equal(tot.view(torch.int32), ref.view(torch.int32))
