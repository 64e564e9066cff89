"""Launch plan of the decode GEMVs of kernels K1, K4 and K8 (``gemv_plan``
in qgemm_tpu_torch/ops/cuda/gemv_plan.py): the compiled instantiations it
picks, the shared memory it asks for, the coverage of every output column
and every K element by the blocks and warps, the alignment of the warps'
K slices, the refusals, and, on the plain versions' own int32 sums, that
the kernels' split and order of K reproduce the plain results bit for bit.
The plan is pure Python, so these run without a card; the C entries refuse
a plan whose shared memory differs from their compiled kernels'."""

import numpy as np
import pytest
import torch

from qgemm_tpu_torch.ops.cuda.expert_matmul import grouped_quantized_matmul_plain
from qgemm_tpu_torch.ops.cuda.gemv_plan import gemv_args, gemv_plan
from qgemm_tpu_torch.ops.quantize import (GROUP, QRANGE, W4RANGE, _div, absmax_quantize,
                                          int8_matmul, quantize_weights,
                                          quantize_weights_int4, unpack_int4, w4a8_matmul_plain,
                                          w4a8_slab)
from qgemm_tpu_torch.utils.testing import use_test_threads

use_test_threads()

SMEM_LIMIT = 232448        # the dynamic shared memory one H100 block may use
SMS = 132                  # the H100's streaming multiprocessors
CT_COMPILED = {"int8": (1,), "w4a8": (1, 2, 4)}   # compiled column tiles per block
# (batches, n, k): GPT_6_7B's decode GEMMs (QKV / W_O, FFN up, FFN down,
# lm_head), the MoE model's expert products (E 8) and its dense ones (d_model
# 2048: attention, lm_head), and the shape_limits phase's n 96 at k 3, 17, 784
GPT_SHAPES = [(1, 4096, 4096), (1, 16384, 4096), (1, 4096, 16384), (1, 50272, 4096)]
MOE_SHAPES = [(8, 4096, 2048), (8, 2048, 4096), (1, 2048, 2048), (1, 50272, 2048),
              (1, 4096, 2048), (1, 2048, 4096)]
LIMIT_SHAPES = [(1, 96, 3), (1, 96, 17), (1, 96, 784), (8, 48, 17)]
SHAPES = GPT_SHAPES + MOE_SHAPES + LIMIT_SHAPES
ROWS = tuple(range(1, 17))


def _int8_plan(e, m, n, k):
    return gemv_plan("int8", e, m, n, -(-k // 16) * 16)


def _w4_plan(e, m, n, k):
    kp = -(-k // GROUP) * GROUP
    return gemv_plan("w4a8", e, m, n, k, kp, w4a8_slab(kp))


def _smem(plan):
    """The shared memory of the compiled kernels, as the .cu files compute it:
    int32 partials [warps][16 ct][8 nr] (int8); f32 group products [warps
    gs][16 ct][8 nr] and the fold state [2][16 ct][8 nr] (w4a8)."""
    cols, rows = 16 * plan["tiles_per_block"], 8 * plan["nr"]
    if plan["kind"] == "int8":
        return 4 * plan["warps"] * cols * rows
    return 4 * (plan["warps"] * plan["groups_per_warp"] + 2) * cols * rows


def _k_slices(plan, extent):
    """Each warp's [begin, end) of the ``extent`` K codes (int8) or groups
    (w4a8), every round, as the kernels walk them."""
    if plan["kind"] == "int8":
        ks = plan["k_slice"]
        return [(w * ks, min(extent, (w + 1) * ks)) for w in range(plan["warps"])]
    gs, rg = plan["groups_per_warp"], plan["warps"] * plan["groups_per_warp"]
    return [(r + w * gs, min(extent, r + (w + 1) * gs)) for r in range(0, extent, rg)
            for w in range(plan["warps"])]


@pytest.mark.parametrize("e,n,k", SHAPES)
@pytest.mark.parametrize("kind", ["int8", "w4a8"])
def test_every_column_and_k_element_is_covered_once(kind, e, n, k):
    for m in ROWS:
        plan = _int8_plan(e, m, n, k) if kind == "int8" else _w4_plan(e, m, n, k)
        cols = 16 * plan["tiles_per_block"]
        assert plan["grid"] == (-(-n // cols), e)
        assert (plan["grid"][0] - 1) * cols < n <= plan["grid"][0] * cols
        extent = -(-k // 16) * 16 if kind == "int8" else -(-k // GROUP)
        covered = np.zeros(extent, dtype=np.int64)
        for b, end in _k_slices(plan, extent):
            covered[b:end] += 1
        assert (covered == 1).all()
        # no warp of the first round idles
        assert all(b < end for b, end in _k_slices(plan, extent)[:plan["warps"]])


@pytest.mark.parametrize("e,n,k", SHAPES)
@pytest.mark.parametrize("kind", ["int8", "w4a8"])
def test_instantiation_and_shared_memory_are_the_compiled_kernels(kind, e, n, k):
    for m in ROWS:
        plan = _int8_plan(e, m, n, k) if kind == "int8" else _w4_plan(e, m, n, k)
        assert plan["nr"] == (1 if m <= 8 else 2)
        assert plan["tiles_per_block"] in CT_COMPILED[kind]
        assert 1 <= plan["warps"] <= 8 and plan["threads"] == 32 * plan["warps"]
        assert 0 < plan["smem"] == _smem(plan) <= SMEM_LIMIT


@pytest.mark.parametrize("e,n,k", SHAPES)
def test_int8_slices_are_whole_k32_steps(e, n, k):
    for m in ROWS:
        plan = _int8_plan(e, m, n, k)
        assert plan["k_slice"] % 64 == 0   # two k32 products per lane step
        assert all(b % 32 == 0 for b, _ in _k_slices(plan, -(-k // 16) * 16))


@pytest.mark.parametrize("e,n,k", SHAPES)
def test_w4a8_slices_are_whole_groups_inside_one_slab(e, n, k):
    kp = -(-k // GROUP) * GROUP
    slab = w4a8_slab(kp) // GROUP
    for m in ROWS:
        plan = _w4_plan(e, m, n, k)
        gs = plan["groups_per_warp"]
        assert gs & (gs - 1) == 0 and plan["k_slice"] == gs * GROUP
        for b, end in _k_slices(plan, kp // GROUP):
            if b < end:
                assert b // slab == (end - 1) // slab


@pytest.mark.parametrize("bk", [128, 384, 1024, 2048, 4096, 16384])
def test_w4a8_slices_stay_inside_slabs_of_any_width(bk):
    """The plan follows the slab width it is given (``w4a8_slab`` today):
    no warp's groups cross a slab bound, and every group is covered once."""
    kp = 16384
    for m in (1, 16):
        plan = gemv_plan("w4a8", 1, m, 4096, kp, kp, bk)
        gs, slab = plan["groups_per_warp"], bk // GROUP
        assert gs <= 16 and (slab >= kp // GROUP or slab % gs == 0)
        slices = _k_slices(plan, kp // GROUP)
        assert sorted(g for b, e in slices for g in range(b, e)) == list(range(kp // GROUP))
        assert all(b // slab == (e - 1) // slab for b, e in slices if b < e)


@pytest.mark.parametrize("kind", ["int8", "w4a8"])
@pytest.mark.parametrize("k,n", [(4096, 4096), (16384, 4096)])
def test_the_square_and_the_tall_decode_shapes_fill_the_card(kind, k, n):
    for m in ROWS:
        plan = _int8_plan(1, m, n, k) if kind == "int8" else _w4_plan(1, m, n, k)
        assert plan["grid"][0] * plan["grid"][1] >= SMS
        assert plan["warps"] == 8


def test_pinned_plans():
    assert gemv_plan("int8", 1, 8, 4096, 4096) == {
        "kind": "int8", "nr": 1, "warps": 8, "threads": 256, "k_slice": 512,
        "tiles_per_block": 1, "grid": (256, 1), "smem": 4096, "launches": 1}
    assert gemv_plan("int8", 1, 16, 50272, 4096)["grid"] == (3142, 1)
    assert gemv_plan("int8", 8, 8, 4096, 2048)["grid"] == (256, 8)
    assert [gemv_plan("w4a8", 1, 8, n, 4096, 4096, 2048)["tiles_per_block"]
            for n in (4096, 16384, 50272)] == [1, 4, 4]
    w4 = gemv_plan("w4a8", 1, 16, 4096, 16384, 16384, 2048)
    assert (w4["groups_per_warp"], w4["rounds"], w4["smem"]) == (16, 1, 133120)
    # a K whose products do not fit in one round walks it in rounds
    long = gemv_plan("w4a8", 1, 16, 64, 65536, 65536, 2048)
    assert (long["warps"], long["groups_per_warp"], long["rounds"]) == (8, 16, 4)


def test_gemv_args_are_the_plans_and_zero_past_16_rows():
    p = gemv_plan("int8", 1, 8, 4096, 16384)
    assert gemv_args("int8", 1, 8, 4096, 16384) == (p["warps"], p["k_slice"], p["smem"])
    p = gemv_plan("w4a8", 1, 9, 4096, 4000, 4096, 2048)
    assert gemv_args("w4a8", 1, 9, 4096, 4000, 4096, 2048) == (
        p["warps"], p["groups_per_warp"], p["tiles_per_block"], p["smem"])
    assert gemv_args("int8", 1, 17, 4096, 4096) == (0, 0, 0)
    assert gemv_args("w4a8", 1, 512, 4096, 4096, 4096, 2048) == (0, 0, 0, 0)


@pytest.mark.parametrize("args,match", [
    (("int4", 1, 8, 64, 64), "kind"),
    (("int8", 1, 0, 64, 64), "1 to 16 rows"),
    (("int8", 1, 17, 64, 64), "1 to 16 rows"),
    (("int8", 0, 8, 64, 64), "batches"),
    (("int8", -1, 8, 64, 64), "batches"),
    (("int8", 1, 8, 0, 64), "positive"),
    (("int8", 1, 8, 64, 24), "multiple of 16"),
    (("int8", 1, 8, 64, 64, 128, 128), "kp and bk are for w4a8"),
    (("w4a8", 1, 8, 64, 64), "needs kp and bk"),
    (("w4a8", 1, 8, 64, 200, 128, 128), "rounded up"),
    (("w4a8", 1, 8, 64, 200, 384, 256), "rounded up"),
    (("w4a8", 1, 8, 64, 4096, 4096, 0), "bk must be"),
    (("w4a8", 1, 8, 64, 200, 256, 192), "bk must be"),
])
def test_plan_refuses_what_the_kernels_cannot_take(args, match):
    with pytest.raises(ValueError, match=match):
        gemv_plan(*args)


@pytest.mark.parametrize("batches", [65535, 65536, 65600, 200000])
def test_past_65535_batches_the_entry_launches_per_65535(batches):
    """K8's experts past a grid y's 65,535: a launch takes at most 65,535
    of them (its grid within CUDA's limits) and the C entry launches
    ``launches`` times, advancing the operands to each chunk's expert."""
    p = gemv_plan("int8", batches, 8, 16, 64)
    assert p["grid"] == (1, min(batches, 65535)) and p["grid"][1] <= 65535
    assert p["launches"] == -(-batches // 65535)
    assert (p["launches"] - 1) * 65535 < batches <= p["launches"] * 65535


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("m,k,n", [(1, 4096, 48), (8, 784, 40), (16, 16384, 24), (5, 17, 33)])
def test_int8_warp_split_gives_the_plain_bits(m, k, n):
    """The warps' exact int32 partials over their K slices, summed, then K1's
    epilogue: bit-equal to the plain version in the kernels' epilogue order
    (K8's plain version, one expert) and, up to that order, K1's."""
    x = torch.from_numpy(_rng(1).standard_normal((m, k)).astype(np.float32))
    wq = quantize_weights(torch.from_numpy(_rng(2).standard_normal((k, n)).astype(np.float32)))
    kp = -(-k // 16) * 16
    plan = gemv_plan("int8", 1, m, n, kp)
    xq, cx = absmax_quantize(torch.nn.functional.pad(x, (0, kp - k)), axis=-1)
    wt = torch.nn.functional.pad(wq.qt, (0, kp - k))
    acc = sum(int8_matmul(xq[:, b:e], wt[:, b:e].t()) for b, e in _k_slices(plan, kp))
    got = (acc.to(torch.float32) * (cx * (1.0 / (QRANGE * QRANGE)))) * wq.c
    ref = grouped_quantized_matmul_plain(x[None], wq.qt[None], wq.c[None])[0]
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("m,k,n", [(3, 4500, 40), (8, 4096, 32), (16, 65536, 16), (1, 3, 17),
                                   (9, 784, 20)])
def test_w4a8_group_fold_in_the_plans_rounds_gives_the_plain_bits(m, k, n):
    """K4's GEMV: per group the exact int32 sum over the plan's warp slices,
    its product with the group's scale, then, round by round, one fold per
    (row, column) in group order, the slab's sum times cx / 889 at each
    slab's end, slabs in order: bit-equal to ``w4a8_matmul_plain``. The
    65536-row K takes four rounds."""
    x = torch.from_numpy(_rng(3).standard_normal((m, k)).astype(np.float32))
    x[:, : min(k, 2048)] *= 8.0
    wq4 = quantize_weights_int4(
        torch.from_numpy(_rng(4).standard_normal((k, n)).astype(np.float32) * 0.02))
    kp = 2 * wq4.qpt.shape[1]
    bk = w4a8_slab(kp)
    plan = gemv_plan("w4a8", 1, m, n, k, kp, bk)
    if k == 65536:
        assert plan["rounds"] == 4
    w = unpack_int4(wq4.qp).to(torch.int32)
    xf = torch.nn.functional.pad(x, (0, kp - k))
    codes, ds = [], []
    for s0 in range(0, kp, bk):
        q, c = absmax_quantize(xf[:, s0:s0 + bk], axis=-1)
        codes.append(q)
        ds.append(_div(QRANGE * W4RANGE, c))
    xq = torch.cat(codes, dim=1).to(torch.int32)
    ng, gps = kp // GROUP, bk // GROUP
    prod = {}
    for b, e in _k_slices(plan, ng):           # each warp's groups
        for gi in range(b, e):
            sl = slice(gi * GROUP, (gi + 1) * GROUP)
            prod[gi] = (xq[:, sl] @ w[sl]).to(torch.float32) * wq4.c[gi]
    rg = plan["warps"] * plan["groups_per_warp"]
    sacc = torch.zeros((m, n), dtype=torch.float32)
    tot = torch.zeros((m, n), dtype=torch.float32)
    for r0 in range(0, ng, rg):                 # the fold, round by round
        for gi in range(r0, min(ng, r0 + rg)):
            sacc = sacc + prod[gi]
            if (gi + 1) % gps == 0 or gi + 1 == ng:
                tot = tot + sacc * ds[gi // gps]
                sacc = torch.zeros_like(sacc)
    ref = w4a8_matmul_plain(x, wq4)
    assert torch.equal(tot.view(torch.int32), ref.view(torch.int32))
