"""Launch plan of kernel K2's int8 route (qgemm_tpu_torch/ops/cuda/decode_plan.py):
its 128-position splits (64 at D 1024) cover each live position of a slot once and
nothing past its length; their count follows the cache extent, not the
lengths; they are K5's splits at pages of at most 128 (so that the two
kernels, one split body, give equal bits); the shared memory fits the H100
and holds what the kernel stages; the plan's constants are the compiled
ones; the plan refuses what the kernel refuses. One more test runs the
plain math split by split and merges the partial states in split order, as
K2's last block does, against the plain version and the JAX kernel. The
plan is pure Python, so these run without a card; ``k2_split_range`` is
this test's oracle of the positions a block attends, and the card holds
the kernel to it through chip_smoke.py's parity checks."""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgemm_tpu.ops.pallas.decode_attention import decode_attention as j_decode
from qgemm_tpu_torch.ops.cuda import _build
from qgemm_tpu_torch.ops.cuda import decode_plan as dp
from qgemm_tpu_torch.ops.cuda import paged_plan as pp
from qgemm_tpu_torch.ops.cuda.decode_attention import decode_attention_plain
from qgemm_tpu_torch.utils.testing import assert_allclose, use_test_threads

use_test_threads()

CSRC = Path(dp.__file__).resolve().parents[2] / "csrc"
SMEM_LIMIT = 232448        # the dynamic shared memory one H100 block may use
EXTENTS = (1, 127, 128, 129, 300, 385, 1024, 1025)
COMPILED = [(D, G) for D in (32, 64, 128, 256, 512, 1024) for G in (1, 2, 4, 8)]
# GQA groups that are no compiled row tile (passes of 8 rows), or wider
GROUPS = (3, 7, 16, 32, 71)


def _lengths(S: int) -> list:
    """Slot lengths at the split edges, 0, 1, S and past S."""
    return sorted({n for n in (0, 1, 127, 128, 129, 255, 256, 257, S - 1, S, S + 50)
                   if n >= 0})


def k2_split_range(split: int, length: int, S: int, D: int = 128) -> tuple:
    """Positions [start, stop) that K2's block ``split`` attends for a slot
    of ``length`` positions (capped at the extent S): empty past the
    length, where the block exits. Splits hold 128 positions, 64 at D
    1024."""
    n = min(length, S)
    sp = dp.split_positions(D)
    start = split * sp
    return (start, max(start, min(start + sp, n)))


@pytest.mark.parametrize("S", EXTENTS)
@pytest.mark.parametrize("D,G", COMPILED)
def test_k2_splits_cover_each_live_position_once(D, G, S):
    plan = dp.k2_plan(D, D, G, S, 3, 2)
    assert plan["grid"] == (6, plan["nsplit"]) and plan["launches"] == 1
    assert plan["split_positions"] == dp.split_positions(D) == (128 if D <= 512 else 64)
    assert plan["scratch_floats"] == 6 * plan["nsplit"] * G * (D + 2)
    for n in _lengths(S):
        live = min(n, S)
        covered = np.zeros(S, dtype=np.int64)
        for s in range(plan["nsplit"]):
            a, z = k2_split_range(s, n, S, D)
            covered[a:z] += 1
            if a >= live:
                assert z == a
        assert (covered[:live] == 1).all() and (covered[live:] == 0).all()


@pytest.mark.parametrize("S", EXTENTS)
def test_split_count_follows_the_extent_not_the_lengths(S):
    """The grid comes from S (the host's), never from the lengths (the
    device's): every slot's blocks are launched, and those past its length
    exit. A slot's splits, and so its result, do not depend on S."""
    plan = dp.k2_plan(128, 128, 1, S, 8, 32)
    assert plan["nsplit"] == -(-S // 128)
    assert (plan["nsplit"] - 1) * 128 < S <= plan["nsplit"] * 128
    for n in _lengths(S):
        small = [k2_split_range(s, n, S) for s in range(plan["nsplit"])]
        big = [k2_split_range(s, n, S + 1000) for s in range(plan["nsplit"])]
        if n <= S:
            assert small == big


@pytest.mark.parametrize("page,D", [(16, 128), (32, 128), (64, 128), (128, 128), (1, 128),
                                    (3, 128), (12, 128), (272, 128), (512, 128), (8, 512),
                                    (512, 1024)])
def test_k2_splits_are_k5_splits_at_pages_up_to_128(page, D):
    """At int8 pages that divide the split, and at every int8 page the
    kernels did not take at first (K5's ``aligned`` splits: any page not
    a multiple of 8, past 256, or at D past 256), K5's split s holds the
    positions K2's split s holds: the two kernels run one body over the
    same positions, so the same int8 rows give the same bits."""
    sp = dp.split_positions(D)
    pps = -(-1024 // page)
    S = pps * page
    k5 = pp.k5_plan(8, D, D, 4, page, pps, 2, 8)
    k2 = dp.k2_plan(D, D, 4, S, 2, 8)
    assert (k5["nsplit"], k5["smem"], k5["threads"]) == (k2["nsplit"], k2["smem"],
                                                         k2["threads"])
    step = sp if k5["aligned"] else k5["split_pages"] * page
    assert step == sp
    for n in _lengths(S):
        for s in range(k2["nsplit"]):
            start = s * step
            k5_range = (start, max(start, min(start + step, n, S)))
            assert k2_split_range(s, n, S, D) == k5_range


@pytest.mark.parametrize("D,G", COMPILED)
def test_shared_memory_fits_and_holds_what_the_kernel_stages(D, G):
    """K2 stages a split's K and V code rows (SP x D bytes each, SP = 128,
    or 64 at D 1024) and their f32 scales, and keeps the G rows' scores, m
    and l and the P V partial sums: K5's layout at pages of one split. The
    C entry refuses any other size."""
    smem = dp.k2_plan(D, D, G, 1024, 1, 1)["smem"]
    sp, tile = dp.split_positions(D), dp.row_tile(G, D)
    staged = 2 * sp * D + 2 * sp * 4
    assert smem == pp.k5_smem(8, D, tile, sp)
    assert staged + tile * sp * 4 < smem <= SMEM_LIMIT
    assert smem % 16 == 0


def test_plan_constants_are_the_kernels():
    """The split size and block the plan assumes are the ones compiled: the
    split body's (split_decode.cuh), which K2's source includes and
    instantiates at int8 pages of one split."""
    body = (CSRC / "split_decode.cuh").read_text()
    k2 = (CSRC / "decode_attention.cu").read_text()
    const = lambda src, name: int(re.search(rf"{name} = (\d+);", src).group(1))
    assert re.search(r"return D <= 512 \? (\d+) : (\d+);", body).groups() == (
        str(dp.SPLIT_POSITIONS), str(dp.SPLIT_POSITIONS // 2))
    assert const(body, "kThreads") == dp.K2_THREADS
    assert '#include "split_decode.cuh"' in k2
    assert "sd::smem_bytes(8, D, G, sd::split_positions(D))" in k2
    assert "smem != sd::smem_bytes(8, D, sd::row_tile(G, D), split_positions)" in k2
    assert "if (tile != G) return QG_K2(8, true);" in k2
    assert "split_positions != sd::split_positions(D)" in k2
    assert "<<<dim3(B * hkv, min(sd::kMaxGridSplits, nsplit - s0)), sd::kThreads, smem, s>>>" \
        in k2 and dp.MAX_GRID_SPLITS == const(body, "kMaxGridSplits")


def test_build_keys_each_library_by_the_headers_it_includes():
    """A change to the split body rebuilds K2 and K5 (and a fault planted
    there reaches both), and leaves the other libraries as built."""
    names = {k: [p.name for p in _build.sources(k)] for k in _build.KERNELS}
    for k in ("decode_attention", "paged_decode_attention"):
        assert {"split_decode.cuh", "mma.cuh", "common.cuh", k + ".cu"} <= set(names[k])
    assert [k for k, v in names.items() if "split_decode.cuh" in v] == [
        "decode_attention", "paged_decode_attention"]
    assert all(f"{k}.cu" in v and "common.cuh" in v for k, v in names.items())
    assert "int8_gemm.cuh" in names["expert_matmul"] and "wgmma.cuh" in names["expert_matmul"]


@pytest.mark.parametrize("S", [200, 1025])
@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("D", [64, 256])
def test_k2_plan_takes_any_group_in_passes_of_8(D, g, S):
    """A group that is no row tile: the row tile 8's shared memory (K5's at
    int8 pages of 128, so the two stay one body), ceil(g / 8) passes, and a
    scratch state for every one of the g rows."""
    plan = dp.k2_plan(D, D, g, S, 3, 2)
    assert plan["row_tile"] == 8 and plan["passes"] == -(-g // 8)
    assert plan["smem"] == dp.k2_smem(D, 8) == pp.k5_plan(8, D, D, g, 128, 8, 3, 2)["smem"]
    assert plan["scratch_floats"] == 6 * plan["nsplit"] * g * (D + 2)
    assert plan["smem"] <= SMEM_LIMIT


@pytest.mark.parametrize("kw,match", [
    (dict(D=2048), "head widths"), (dict(D=48), "head widths"), (dict(d=129), "width d"),
    (dict(d=0), "width d"), (dict(G=0), "GQA group"), (dict(D=256, d=257), "width d"),
    (dict(S=0), "positive"), (dict(b=0), "positive"), (dict(hkv=0), "positive"),
    (dict(D=1024, d=1025), "width d"),
])
def test_k2_plan_refuses_what_the_kernel_refuses(kw, match):
    args = dict(D=128, d=128, G=1, S=1024, b=8, hkv=32)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        dp.k2_plan(**args)


@pytest.mark.parametrize("kw", [
    dict(D=512), dict(D=512, d=384, G=8), dict(D=1024, d=576, G=71), dict(D=1024, G=8),
    dict(S=65536 * 128), dict(b=65600, hkv=1, S=128),
])
def test_k2_plan_takes_the_shapes_it_refused_before(kw):
    """Widths past 256 and splits past 65,535: a plan whose shared memory
    fits and whose grid is one dimension within CUDA's limits."""
    args = dict(D=128, d=128, G=1, S=1024, b=8, hkv=32)
    args.update(kw)
    plan = dp.k2_plan(**args)
    assert plan["smem"] <= SMEM_LIMIT and plan["grid"][0] <= 2 ** 31 - 1
    assert plan["grid"] == (args["b"] * args["hkv"], min(plan["nsplit"], 65535))
    assert plan["launches"] == -(-plan["nsplit"] // 65535)


def test_plan_arguments_are_the_plans():
    p = dp.k2_plan(64, 48, 4, 385, 3, 8)
    assert dp.k2_args(64, 48, 4, 385, 3, 8) == (p["split_positions"], p["nsplit"], p["smem"],
                                                p["scratch_floats"])


def _split_merge(q, k, v, lengths, kc=None, vc=None):
    """K2's algorithm in torch, in f32 without its bf16 roundings: per split
    of ``k2_plan``, the partial state (m, l, O) of the positions
    ``k2_split_range`` gives (scores times kc/127 and p times vc/127 where
    scales are given); then the live splits merged in split order."""
    b, hq, _, d = q.shape
    hkv, S = k.shape[1], k.shape[2]
    g = hq // hkv
    plan = dp.k2_plan(128, d, g, S, b, hkv)
    out = torch.zeros((b, hq, 1, d))
    for s_ in range(b):
        n = int(lengths[s_])
        for h in range(hkv):
            qg_ = q[s_, h * g:(h + 1) * g, 0].float()                # [g, d]
            states = []
            for sp_ in range(plan["nsplit"]):
                a, z = k2_split_range(sp_, n, S)
                if z == a:
                    continue
                sc = (qg_ @ k[s_, h, a:z].float().T) * (1 / math.sqrt(d))
                pv = v[s_, h, a:z].float()
                if kc is not None:
                    sc = sc * (kc[s_, h, a:z, 0] / 127)
                    pv = pv * (vc[s_, h, a:z] / 127)
                m = sc.max(dim=1).values
                p = torch.exp(sc - m[:, None])
                states.append((m, p.sum(dim=1), p @ pv))
            if not states:
                continue                                         # length 0: zeros
            mx = torch.stack([m for m, _, _ in states]).max(dim=0).values
            l_tot = torch.zeros_like(mx)
            o_tot = torch.zeros((g, d))
            for m, l_, o in states:
                f = torch.exp(m - mx)
                l_tot = l_tot + l_ * f
                o_tot = o_tot + o * f[:, None]
            out[s_, h * g:(h + 1) * g, 0] = o_tot / torch.clamp_min(l_tot, 1e-30)[:, None]
    return out


@pytest.mark.parametrize("S,g,codes", [(300, 1, False), (385, 4, False), (129, 2, True),
                                       (385, 8, True), (257, 1, True), (300, 7, True),
                                       (385, 3, False), (257, 17, True)])
def test_split_partial_states_merged_in_order_match_plain_and_jax(S, g, codes):
    """The flash-decoding split changes only the order of f32 sums: the
    mirror against ``decode_attention_plain`` and the JAX kernel on a float32
    cache (no roundings on either side), rtol 1e-5 of the largest output.
    With ``codes``, the mirror runs int8 codes and per-position scales and
    the two references the dequantized float32 cache (codes * scale / 127),
    which differs from it only in f32 rounding."""
    hkv, d = 2, 32
    rng = np.random.default_rng(S + g)
    lengths = np.array([0, 1, 128, 129, min(S, 300), S], np.int32)
    b = len(lengths)
    q = rng.standard_normal((b, hkv * g, 1, d)).astype(np.float32)
    if codes:
        kq = rng.integers(-127, 128, size=(b, hkv, S, d)).astype(np.int8)
        vq = rng.integers(-127, 128, size=(b, hkv, S, d)).astype(np.int8)
        kc = (rng.random((b, hkv, S, 1)) * 0.05 + 0.01).astype(np.float32)
        vc = (rng.random((b, hkv, S, 1)) * 2 + 0.05).astype(np.float32)
        k, v = kq * kc / 127, vq * vc / 127
        got = _split_merge(torch.from_numpy(q), torch.from_numpy(kq), torch.from_numpy(vq),
                           lengths, torch.from_numpy(kc), torch.from_numpy(vc))
    else:
        k = rng.standard_normal((b, hkv, S, d)).astype(np.float32)
        v = rng.standard_normal((b, hkv, S, d)).astype(np.float32)
        got = _split_merge(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           lengths)
    k, v = k.astype(np.float32), v.astype(np.float32)
    plain = decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), torch.from_numpy(lengths))
    want = np.asarray(j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(lengths)))
    live = lengths > 0
    top = float(np.abs(want[live]).max())
    assert_allclose(got[live], plain[live], rtol=0, atol=1e-5 * top)
    assert_allclose(got[live], want[live], rtol=0, atol=1e-5 * top)
    assert not bool(got[~live].any())
