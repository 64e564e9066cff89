"""Launch plan of the int8 flash attention of row 12
(qgemm_tpu_torch/ops/cuda/int8_flash_plan.py): the main kernel's query
and key tiles cover every (query, key) pair that causal and full attention
need, once, and attend nothing past Sq or Sk; the mask may be skipped
exactly where a tile needs none; causal grids take their longest query
tiles first; the shared memory fits the H100; the plan's constants are the
compiled ones; the plan refuses what the C entries refuse. The P codes a
warpgroup packs from its S accumulator (the packing mirrored from the
kernel) sit at the A operand's positions whose keys V's transposed codes
hold there. The pre-pass's summation order (``prepass_mean``), run in
numpy, gives K codes within 1 of JAX's pre-pass, rarely off. Pure Python
and numpy, so these run without a card; chip_smoke.py holds the kernels to
the plain version and to the torch pre-pass on the card."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgemm_tpu_torch.ops.cuda import int8_flash_plan as fp
from qgemm_tpu_torch.ops.cuda.int8_flash_attention import (KERNEL_KEY_TILE, Int8FlashCodes,
                                                           inputs_from_codes,
                                                           int8_flash_prepass,
                                                           quantize_centered, vt_in_key_order)
from qgemm_tpu_torch.utils.testing import use_test_threads

use_test_threads()

CSRC = Path(fp.__file__).resolve().parents[2] / "csrc"
SMEM_LIMIT = 232448
SHAPES = [(2048, 2048), (100, 130), (130, 100), (1, 1), (63, 129), (96, 160), (40, 1100),
          (256, 256), (200, 300)]
# the share of K codes the pre-pass kernel's mean may flip against JAX's:
# chip_smoke.py's PREPASS_K_FLIP_SHARE against the torch pre-pass
K_FLIP_SHARE = 1e-4


def key_tiles(q0: int, sq: int, sk: int, causal: bool) -> int:
    """Key tiles the kernel's query tile at row ``q0`` walks: all of Sk,
    or, causal, up to the one holding its last row."""
    n = -(-sk // fp.KEY_TILE)
    if causal:
        n = min(n, (min(q0 + fp.QUERY_TILE, sq) - 1) // fp.KEY_TILE + 1)
    return n


def masked_tile(q0: int, k0: int, sk: int, causal: bool) -> bool:
    """Whether the kernel masks the tile at key ``k0`` for query tile ``q0``."""
    return k0 + fp.KEY_TILE > sk or (causal and k0 + fp.KEY_TILE - 1 > q0)


def query_tile_order(nq: int, causal: bool) -> list:
    """The query tile each block x takes: the longest first when causal."""
    return [nq - 1 - x for x in range(nq)] if causal else list(range(nq))


def prepass_mean(k: np.ndarray) -> np.ndarray:
    """The pre-pass kernel's per-channel mean of K [..., Sk, d] over Sk, in
    its order: f32 sums of each chunk of ``CHUNK_ROWS`` rows in row order
    from 0, the chunks' sums added in chunk order from 0, then divided by
    Sk (f32, correctly rounded). Returns [..., 1, d] f32."""
    k = np.asarray(k, np.float32)
    sk = k.shape[-2]
    total = np.zeros(k.shape[:-2] + (k.shape[-1],), np.float32)
    for c0 in range(0, sk, fp.CHUNK_ROWS):
        part = np.zeros_like(total)
        for r in range(c0, min(sk, c0 + fp.CHUNK_ROWS)):
            part = part + k[..., r, :]
        total = total + part
    return (total / np.float32(sk))[..., None, :]


def _attended(sq: int, sk: int, causal: bool) -> np.ndarray:
    """Pairs (query, key) each block attends, counted over the grid as the
    kernel walks it: key tiles up to ``key_tiles``, the mask only on
    ``masked_tile``s, rows past Sq computed but never stored."""
    plan = fp.flash_plan(1, sq, sk, 32, 32, causal, True)
    nq = plan["grid"][0]
    count = np.zeros((sq, sk), np.int64)
    for x in range(nq):
        q0 = query_tile_order(nq, causal)[x] * fp.QUERY_TILE
        rows = np.arange(q0, min(sq, q0 + fp.QUERY_TILE))
        for it in range(key_tiles(q0, sq, sk, causal)):
            k0 = it * fp.KEY_TILE
            keys = np.arange(k0, k0 + fp.KEY_TILE)
            ok = np.ones((len(rows), len(keys)), bool)
            if masked_tile(q0, k0, sk, causal):
                ok = (keys[None, :] < sk) & ((not causal) | (keys[None, :] <= rows[:, None]))
            else:   # no mask: every key of the tile must be live for every row
                assert keys[-1] < sk and (not causal or keys[-1] <= q0)
            for i, r in enumerate(rows):
                count[r, keys[ok[i]]] += 1
    return count


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", SHAPES)
def test_tiles_cover_each_needed_pair_once(sq, sk, causal):
    got = _attended(sq, sk, causal)
    want = np.ones((sq, sk), np.int64)
    if causal:
        want = np.tril(want)       # key j attends query i iff j <= i (top-left aligned)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sq", [1, 64, 65, 100, 2048])
def test_causal_grid_takes_the_longest_query_tiles_first(sq):
    nq = -(-sq // fp.QUERY_TILE)
    order = query_tile_order(nq, True)
    assert sorted(order) == list(range(nq)) and query_tile_order(nq, False) == list(range(nq))
    work = [key_tiles(t * fp.QUERY_TILE, sq, sq, True) for t in order]
    assert work == sorted(work, reverse=True)


@pytest.mark.parametrize("p_int8", [True, False])
@pytest.mark.parametrize("dv", [32, 64, 128])
def test_shared_memory_fits_and_holds_the_ring(dv, p_int8):
    plan = fp.flash_plan(32, 2048, 2048, 128, dv, True, p_int8)
    smem, st = plan["smem"], plan["stages"]
    # V: int8 codes DV x 128 keys; bf16 a 128-key x 64-channel box per 64 channels
    v_tile = dv * fp.KEY_TILE if p_int8 else -(-dv // 64) * fp.KEY_TILE * 64 * 2
    ring = st * (fp.KEY_TILE * fp.CODE_ROW + v_tile)
    scales = st * fp.KEY_TILE * 4                 # each stage's K row scales, after the ring
    assert smem == fp.ALIGN + fp.QUERY_TILE * fp.CODE_ROW + ring + scales <= SMEM_LIMIT
    assert (fp.QUERY_TILE * fp.CODE_ROW + ring) % 1024 == 0   # tiles start on swizzle atoms
    assert fp.BLOCKS_PER_SM * (smem + 1024) <= 228 * 1024     # two blocks share an SM


def test_plan_constants_are_the_kernels():
    src = (CSRC / "int8_flash_attention.cu").read_text()
    const = lambda name: int(re.search(rf"\b{name} = (\d+)[,;]", src).group(1))
    assert const("kBQ") == fp.QUERY_TILE and const("kBK") == fp.KEY_TILE == KERNEL_KEY_TILE
    assert const("kRow") == fp.CODE_ROW
    # two stages, one past code rows of 512 bytes (d 1024)
    assert "kStages = CR <= 512 ? 2 : 1;" in src and fp.STAGES == 2
    assert (fp.stages(512), fp.stages(1024)) == (2, 1)
    assert "inline int code_row_bytes(int d) { return d <= 128 ? 128 : d <= 256 ? 256 : " \
        "d <= 512 ? 512 : 1024; }" in src
    assert [fp.code_row(d) for d in (1, 128, 129, 256, 300, 1024)] == [
        128, 128, 256, 256, 512, 1024]
    assert const("kConsumers") + 32 == fp.THREADS
    assert const("kChunkRows") == fp.CHUNK_ROWS and const("kColThreads") == fp.PREPASS_COL_THREADS
    assert const("kRowsPerBlock") == fp.ROWS_PER_BLOCK
    assert const("kRowThreads") == fp.PREPASS_ROW_THREADS
    assert "if (smem != C::kSmem) return cudaErrorInvalidValue;" in src
    assert f"__launch_bounds__(kThreads, {fp.BLOCKS_PER_SM})" in src
    assert "nchunk != (sk + kChunkRows - 1) / kChunkRows" in src
    assert "return in_dtype == 1 && dv % 8 == 0 ? 0 : (dv + 7) / 8 * 8;" in src   # v_width
    assert "vw != v_width(in_dtype, d, dv, qk_only)" in src
    assert "if (!qk_only) return d <= 128 && dv <= 128 ? padded(dv) : (dv + 127) / 128 * 128;" \
        in src
    # S: d_pad / 32 k32 slices
    assert "launch_dv<T, P8, KS>" in src and "if (D == 32) QG_R12(1);" in src
    assert "if (D == 1024) QG_R12(32);" in src
    cu_key = re.search(r"int key_of_position\(int p\) \{\n\s+return (.*);", src).group(1)
    assert cu_key == ("16 * (p >> 4) + 8 * ((p & 3) >> 1) + 2 * ((p >> 2) & 3) + (p & 1)")


@pytest.mark.parametrize("kw,match", [
    (dict(bh=0), "batch\\*heads"), (dict(bh=-1), "batch\\*heads"), (dict(sq=0), "Sq, Sk"),
    (dict(sk=0), "Sq, Sk"), (dict(d=0), "head widths"), (dict(d=1025), "head widths"),
    (dict(dv=1025), "head widths"),
])
def test_plan_refuses_what_the_kernels_refuse(kw, match):
    args = dict(bh=32, sq=2048, sk=2048, d=128, dv=128)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        fp.flash_plan(**args, causal=True, p_int8=True)
    with pytest.raises(ValueError, match=match):
        fp.prepass_plan(**args, qk_only=False, f32=False)


@pytest.mark.parametrize("kw", [
    dict(bh=65536), dict(bh=65600, sq=16, sk=16), dict(d=129), dict(dv=129), dict(d=160, dv=160),
    dict(d=256, dv=256), dict(d=256, dv=96), dict(d=576, dv=512), dict(d=1024, dv=1024),
    dict(d=64, dv=300),
])
@pytest.mark.parametrize("p_int8", [True, False])
def test_plan_takes_what_it_refused_before(kw, p_int8):
    """Batch*heads past 65,535 and head widths past 128: code rows of the
    padded width, V in chunks of 128 channels (a block each), shared
    memory under the limit and grids one dimension within CUDA's."""
    args = dict(bh=32, sq=2048, sk=2048, d=128, dv=128)
    args.update(kw)
    m = fp.flash_plan(**args, causal=True, p_int8=p_int8)
    pre = fp.prepass_plan(**args, qk_only=not p_int8, f32=False)
    assert m["smem"] <= SMEM_LIMIT and m["smem"] == fp.flash_smem(m["dv_pad"], p_int8, args["d"])
    assert m["d_pad"] >= args["d"] and pre["code_row"] == max(128, m["d_pad"])
    assert m["dv_pad"] == (128 if max(args["d"], args["dv"]) > 128 else fp.padded_width(args["dv"]))
    assert m["v_chunks"] == -(-args["dv"] // m["dv_pad"])
    assert m["grid"] == (-(-args["sq"] // 64) * m["v_chunks"] * args["bh"],)
    assert len(m["grid"]) == 1 and 1 <= m["grid"][0] <= 2 ** 31 - 1
    for g in (pre["col_grid"], pre["row_grid"]):   # a launch's: y at most 65,535
        assert g[1] == min(args["bh"], 65535) and g[0] <= 2 ** 31 - 1
    assert pre["launches"] == 2 * -(-args["bh"] // 65535)
    if p_int8:
        assert pre["v_width"] % m["dv_pad"] == 0 and pre["v_width"] >= args["dv"]


def test_prepass_plan_numbers():
    p = fp.prepass_plan(32, 2048, 2048, 128, 128, False, False)
    assert p["col_grid"] == (32, 32) and p["skp"] == 2048 and p["dv_pad"] == 128
    assert p["row_grid"] == (64 + 64 + 16, 32) and p["v_width"] == 128
    assert p["launches"] == 2
    assert p["scratch_floats"] == 32 * 32 * 256
    o = fp.prepass_plan(32, 2048, 2048, 128, 128, True, False)   # qk_only reads bf16 V as it is
    assert o["row_grid"] == (64 + 64, 32) and o["nv_blocks"] == 0 and o["v_width"] == 0
    r = fp.prepass_plan(8, 100, 130, 32, 64, True, True)         # f32: a bf16 copy of V
    assert (r["skp"], r["dv_pad"], r["nchunk"], r["scratch_floats"]) == (256, 64, 3, 8 * 3 * 32)
    assert r["nv_blocks"] == 2 and r["v_width"] == 64
    m = fp.flash_plan(8, 100, 130, 32, 64, False, False)
    assert (m["grid"], m["d_pad"], m["dv_pad"], m["smem"]) == ((2 * 8,), 32, 64,
                                                               fp.flash_smem(64, False))


def _packed_positions(p_int8: bool) -> dict:
    """The kernel's packing of P (mirrored from int8_flash_wgmma_kernel):
    for lane t of a quad, the accumulator's entry (j, e) holds key 8j + 2t
    + (e & 1); returns, per (slice, register, byte or half), the key the
    kernel puts there."""
    out = {}
    for t in range(4):
        for j in range(fp.KEY_TILE // 8):
            keys = [8 * j + 2 * t + (e & 1) for e in range(4)]
            if p_int8:
                kk, jp = j // 4, j % 4
                sh = 2 * (jp & 1)                  # bytes: the high half-word for odd j'
                for row, (a, b) in enumerate(((keys[0], keys[1]), (keys[2], keys[3]))):
                    reg = 2 * (jp >> 1) + row
                    out[(t, kk, reg, sh)] = a
                    out[(t, kk, reg, sh + 1)] = b
            else:
                for row, (a, b) in enumerate(((keys[0], keys[1]), (keys[2], keys[3]))):
                    reg = 2 * (j & 1) + row
                    out[(t, j // 2, reg, 0)] = a
                    out[(t, j // 2, reg, 1)] = b
    return out


@pytest.mark.parametrize("p_int8", [True, False])
def test_p_fragments_sit_where_v_holds_their_keys(p_int8):
    """The A operand's register r of slice kk holds, in thread t, k
    positions 4t..4t+3 (r 0, 1) or 16+4t..19+4t (r 2, 3) of a k32 slice
    (int8), or 2t, 2t+1 (r 0, 1) and 8+2t, 9+2t (r 2, 3) of a k16 slice
    (bf16); r odd is row g + 8. The key the kernel packs there is the key
    V's transposed codes hold at that position: ``v_positions`` (int8), or
    the position itself (bf16: slice kk is V's key rows 16 kk.. of its
    MN-major tile, in key order)."""
    order = fp.v_positions(fp.KEY_TILE)
    for (t, kk, reg, b), key in _packed_positions(p_int8).items():
        if p_int8:
            pos = 32 * kk + 16 * (reg >> 1) + 4 * t + b
            assert order[pos] == key, (t, kk, reg, b)
        else:
            pos = 16 * kk + 8 * (reg >> 1) + 2 * t + b
            assert pos == key, (t, kk, reg, b)
    packed = _packed_positions(p_int8)
    for row in (0, 1):   # each row's 128 keys, once, over the quad's four threads
        keys = sorted(k for (t, kk, reg, b), k in packed.items() if reg & 1 == row)
        assert keys == list(range(fp.KEY_TILE))


def _kernel_layout(x, qk_only: bool, dtype: torch.dtype) -> Int8FlashCodes:
    """The pre-pass kernel's layout (``Int8FlashCodes``) of a torch
    pre-pass's output ``x``, built as the kernel writes it: code rows of
    ``CODE_ROW`` bytes, zero past d; int8 V transposed [B, H, DV, Skp] with
    position p of each row holding key ``v_positions(Skp)[p]``; qk_only's
    bf16 V in key order, ``v_width`` channels wide (zero past dv) or, where
    that is 0, as it is; K's scales zero past Sk."""
    b, h, sq_len, d = x.q8.shape
    sk_len, dv = x.v8.shape[2], x.v8.shape[3]
    pre = fp.prepass_plan(b * h, sq_len, sk_len, d, dv, qk_only, dtype == torch.float32)
    skp, pad = pre["skp"], torch.nn.functional.pad
    if qk_only:
        v = pad(x.v8, (0, pre["v_width"] - dv)) if pre["v_width"] else x.v8
    else:
        v = pad(x.v8, (0, pre["dv_pad"] - dv, 0, skp - sk_len)).transpose(-1, -2)
        v = v[..., torch.from_numpy(fp.v_positions(skp))]
    return Int8FlashCodes(pad(x.q8, (0, fp.CODE_ROW - d)), pad(x.k8, (0, fp.CODE_ROW - d)),
                          v.contiguous(), x.sq.reshape(b, h, sq_len),
                          pad(x.sk.reshape(b, h, sk_len), (0, skp - sk_len)),
                          None if x.vc is None else x.vc.reshape(b, h, dv), d, dv)


@pytest.mark.parametrize("dtype,dv", [(torch.float32, 48), (torch.bfloat16, 48),
                                      (torch.bfloat16, 20)])
def test_kernel_layout_holds_the_prepass_output(dtype, dv):
    """``inputs_from_codes`` takes the kernel's layout (``_kernel_layout``)
    back to the torch pre-pass's output, bit for bit, for int8 V and for
    qk_only's bf16 V read as it is (bf16, dv 48) or copied (f32, or dv 20);
    ``vt_in_key_order`` puts V's transposed codes back in key order."""
    g = torch.Generator().manual_seed(4)
    q, k = torch.randn(1, 2, 100, 32, generator=g), torch.randn(1, 2, 130, 32, generator=g)
    v = torch.randn(1, 2, 130, dv, generator=g)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    for qk_only in (False, True):
        x = int8_flash_prepass(q, k, v, qk_only)
        c = _kernel_layout(x, qk_only, dtype)
        back = inputs_from_codes(c)
        for a, b in zip(x, back):
            assert (a is None and b is None) or torch.equal(a, b)
        assert c.q8.shape == (1, 2, 100, 128)
        if qk_only:
            width = 0 if dtype == torch.bfloat16 and dv % 8 == 0 else -(-dv // 8) * 8
            assert c.v.shape == (1, 2, 130, width or dv) and c.v.dtype == torch.bfloat16
        else:
            dv_pad = fp.padded_width(dv)
            assert c.v.shape == (1, 2, dv_pad, 256)
            vpad = torch.nn.functional.pad(x.v8, (0, dv_pad - dv, 0, 126)).transpose(-1, -2)
            assert torch.equal(vt_in_key_order(c), vpad)


@pytest.mark.parametrize("dv,qk_only,f32,want", [
    (128, False, False, 128), (20, False, True, 32), (64, True, False, 0), (48, True, False, 0),
    (20, True, False, 24), (64, True, True, 64), (1, True, True, 8)])
def test_v_width_is_the_rows_the_prepass_writes(dv, qk_only, f32, want):
    """int8 V: DV rows of codes; qk_only: none where bf16 V has a multiple
    of 8 channels (the main kernel reads it as it is, its rows 16-byte
    multiples for TMA), else a bf16 copy of dv rounded up to 8; the V
    blocks run exactly where the pre-pass writes V."""
    assert fp.v_width(dv, qk_only, f32) == want
    plan = fp.prepass_plan(4, 70, 300, 32, dv, qk_only, f32)
    assert plan["v_width"] == want
    assert plan["nv_blocks"] == (3 if want else 0)


@jax.jit
def _jax_prepass(q, k, v):
    """qgemm_tpu's flash_attention_int8 pre-pass, line for line (int8 V)."""
    kf = k.astype(jnp.float32)
    kf = kf - jnp.mean(kf, axis=2, keepdims=True)
    qf, vf = q.astype(jnp.float32), v.astype(jnp.float32)
    sq_s = jnp.maximum(jnp.max(jnp.abs(qf), axis=-1, keepdims=True), 1e-6)
    sk_s = jnp.maximum(jnp.max(jnp.abs(kf), axis=-1, keepdims=True), 1e-6)
    vc = jnp.maximum(jnp.max(jnp.abs(vf), axis=2, keepdims=True), 1e-6)
    return (jnp.round(qf / sq_s * 127.0).astype(jnp.int8),
            jnp.round(kf / sk_s * 127.0).astype(jnp.int8),
            jnp.round(vf / vc * 127.0).astype(jnp.int8), sq_s / 127.0, sk_s / 127.0, vc)


@pytest.mark.parametrize("case,k_mean", [("gpt_heads", 0.0), ("heavy_k_mean", 8.0),
                                         ("ragged", 0.0), ("long", 3.0)])
def test_prepass_summation_order_against_jax(case, k_mean):
    """The pre-pass kernel's mean (chunk sums in row order, added in chunk
    order, / Sk), then torch's quantization of the centered K, against
    JAX's whole pre-pass: Q and V codes and their scales bit for bit, K
    codes within 1 and at most ``K_FLIP_SHARE`` of them off by 1, K's row
    scales within 1e-5."""
    shape = {"gpt_heads": (1, 4, 256, 256, 128), "heavy_k_mean": (1, 2, 256, 256, 64),
             "ragged": (2, 1, 100, 130, 32), "long": (1, 2, 64, 1100, 64)}[case]
    b, h, sq, sk, d = shape
    rng = np.random.default_rng(sk + d)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, h, sk, d)).astype(np.float32)
    if k_mean:
        k = k + (rng.standard_normal((1, 1, 1, d)) * k_mean).astype(np.float32)
    kc = (k - prepass_mean(k)).astype(np.float32)
    got = quantize_centered(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(v))
    want = [np.asarray(a) for a in _jax_prepass(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]
    for name in ("q8", "v8", "sq", "vc"):
        i = ("q8", "k8", "v8", "sq", "sk", "vc").index(name)
        np.testing.assert_array_equal(getattr(got, name).numpy(), want[i], err_msg=name)
    diff = np.abs(got.k8.numpy().astype(np.int32) - want[1].astype(np.int32))
    share = float((diff == 1).mean())
    assert diff.max() <= 1 and share <= K_FLIP_SHARE, (case, diff.max(), share)
    np.testing.assert_allclose(got.sk.numpy(), want[4], rtol=1e-5)


def test_prepass_mean_is_a_chunked_sequential_sum():
    """The mirror ``prepass_mean`` sums each chunk from 0 in row order and
    the chunks in order: on integers it is exact, and on a chunk-sized edge
    it equals a sequential f32 loop."""
    k = np.arange(3 * 130 * 2, dtype=np.float32).reshape(1, 3, 130, 2) % 7
    np.testing.assert_array_equal(prepass_mean(k), (k.sum(axis=2, keepdims=True) / 130)
                                  .astype(np.float32))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((fp.CHUNK_ROWS * 2 + 5, 3)).astype(np.float32)
    total = np.float32(0)
    for c0 in range(0, len(x), fp.CHUNK_ROWS):
        part = np.float32(0)
        for r in x[c0:c0 + fp.CHUNK_ROWS, 1]:
            part = np.float32(part + r)
        total = np.float32(total + part)
    assert prepass_mean(x)[0, 1] == np.float32(total / np.float32(len(x)))
