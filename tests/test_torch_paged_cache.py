"""Port parity for the paged KV cache (qgemm_tpu_torch/serving/paged_cache.py
and the int4 KV helpers of qgemm_tpu_torch/ops/kv_cache.py) against
qgemm_tpu/serving/paged_cache.py and qgemm_tpu/ops/kv_cache.py on the CPU.

The same numpy inputs go to both packages. Everything here is compared
EXACTLY: int4 codes, packing and scales, the three writers' pools and
scales byte for byte (the same f32 quantization ops on both sides), step
tables, gathered rows, and the allocator's whole state after every call of
one sequence of calls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgemm_tpu.ops import kv_cache as jkv
from qgemm_tpu.serving import paged_cache as jpc
from qgemm_tpu_torch.ops import kv_cache as tkv
from qgemm_tpu_torch.serving import paged_cache as tpc
from qgemm_tpu_torch.utils.interop import paged_cache_from_numpy
from qgemm_tpu_torch.utils.testing import use_test_threads

use_test_threads()

FIELDS = ("kq", "kc", "vq", "vc")


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def to_port(jc, device="cpu"):
    """The port's PagedKVCache holding a JAX PagedKVCache's state."""
    opt = lambda a: None if a is None else np.asarray(a)
    return paged_cache_from_numpy(*(np.asarray(getattr(jc, f)) for f in FIELDS),
                                  page_table=np.asarray(jc.page_table),
                                  step_slot=opt(jc.step_slot), step_page=opt(jc.step_page),
                                  page_size=jc.page_size, kv_bits=jc.kv_bits, device=device)


def assert_same_cache(tc, jc):
    for f in FIELDS:
        want = np.asarray(getattr(jc, f))
        got = getattr(tc, f).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8), err_msg=f)


def shuffled_tables(b, pps, n_pages, counts, seed):
    """A page table whose slots hold ``counts`` pages each, drawn from a
    shuffled physical order (page 0 stays the null page)."""
    perm = np.random.default_rng(seed).permutation(np.arange(1, n_pages))
    pt = np.zeros((b, pps), np.int32)
    k = 0
    for s, n in enumerate(counts):
        pt[s, :n] = perm[k:k + n]
        k += n
    return pt


def test_int4_quantize_pack_unpack_byte_equal():
    x = _normal((3, 16, 64), 0) * 3
    jv, jc = jkv.quantize_kv_int4(jnp.asarray(x))
    tv, tcs = tkv.quantize_kv_int4(torch.from_numpy(x))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tcs.numpy().view(np.uint32), np.asarray(jc).view(np.uint32))
    assert int(tv.abs().max()) <= 7
    for axis in (1, -2, 0):
        vals = tv if axis != 0 else tv[:2]
        jp = np.asarray(jkv.pack_int4_rows(jnp.asarray(vals.numpy()), axis=axis))
        tp = tkv.pack_int4_rows(vals, axis=axis)
        np.testing.assert_array_equal(tp.numpy(), jp)
        np.testing.assert_array_equal(tkv.unpack_int4_rows(tp, axis=axis).numpy(),
                                      np.asarray(jkv.unpack_int4_rows(jnp.asarray(jp), axis=axis)))
        np.testing.assert_array_equal(tkv.unpack_int4_rows(tp, axis=axis).numpy(), vals.numpy())
    # every byte value unpacks as JAX unpacks it
    every = np.arange(-128, 128, dtype=np.int8).reshape(1, 256, 1)
    np.testing.assert_array_equal(
        tkv.unpack_int4_rows(torch.from_numpy(every), axis=1).numpy(),
        np.asarray(jkv.unpack_int4_rows(jnp.asarray(every), axis=1)))


@pytest.mark.parametrize("counts,pps,bucket,per_step", [
    ([2, 0, 3], 4, 4, 1), ([2, 0, 3], 4, 4, 2), ([1, 5, 2, 8], 9, 16, 2),
    ([0, 0], 3, 16, 2), ([7], 8, 4, 3)])
def test_build_step_tables_equal(counts, pps, bucket, per_step):
    js, jp = jpc.build_step_tables(counts, pps, bucket=bucket, pages_per_step=per_step)
    ts, tp = tpc.build_step_tables(counts, pps, bucket=bucket, pages_per_step=per_step)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tp, jp)
    assert ts.dtype == tp.dtype == np.int32
    # the default schedule is JAX's ragged unroll
    np.testing.assert_array_equal(tpc.build_step_tables(counts, pps)[1],
                                  jpc.build_step_tables(counts, pps)[1])


def _allocator_state(a):
    return (list(a.free), [list(p) for p in a.slot_pages], dict(a.refs), dict(a.page_hash),
            dict(a.prefix_map), list(a.cached.keys()), a.prefix_hits, a.n_free)


def test_allocator_and_prefix_cache_match_jax():
    """One random sequence of calls on both allocators: equal results,
    equal exceptions and equal state after every call."""
    rng = np.random.default_rng(5)
    ja, ta = jpc.PageAllocator(12, 3, 4), tpc.PageAllocator(12, 3, 4)
    hashes = [bytes([i]) * 4 for i in range(6)]
    ops = 0
    for _ in range(400):
        kind = rng.choice(["grow", "release", "acquire", "publish", "peek", "take", "reset"],
                          p=[.3, .15, .15, .15, .15, .05, .05])
        slot = int(rng.integers(0, 3))
        if kind == "grow":
            call = lambda a: a.grow(slot, int(rng_tokens), 8)
            rng_tokens = rng.integers(0, 40)
        elif kind == "release":
            call = lambda a: a.release(slot)
        elif kind == "acquire":
            h = hashes[int(rng.integers(0, 6))]
            call = lambda a: a.acquire_shared(slot, h)
        elif kind == "publish":
            j, h = int(rng.integers(0, 4)), hashes[int(rng.integers(0, 6))]
            call = lambda a: a.publish(slot, j, h) if j < len(a.slot_pages[slot]) else None
        elif kind == "peek":
            chain = [hashes[int(i)] for i in rng.integers(0, 6, size=3)]
            n = int(rng.integers(0, 4))
            call = lambda a: (a.peek_prefix(chain),
                              a.peek_prefix_cached(chain, min(n, a.peek_prefix(chain))))
        elif kind == "take":
            call = lambda a: a._take_page()
        else:
            call = lambda a: a.reset_prefix_cache()
        res = []
        for a in (ja, ta):
            try:
                res.append(("ok", call(a)))
            except RuntimeError as e:
                res.append(("raised", str(e)))
        assert res[0] == res[1], (kind, res)
        assert _allocator_state(ja) == _allocator_state(ta), kind
        ops += res[0][0] == "ok"
    assert ops > 300 and ta.prefix_hits > 0


def _jax_cache(h, d, n_pages, b, pps, ps, kv_bits, counts, seed):
    jc = jpc.init_paged_cache(h, d, n_pages, b, pps, page_size=ps, kv_bits=kv_bits)
    pt = shuffled_tables(b, pps, n_pages, counts, seed)
    from dataclasses import replace
    return replace(jc, page_table=jnp.asarray(pt))


@pytest.mark.parametrize("kv_bits,ps", [(8, 8), (4, 16)])
def test_writes_byte_equal(kv_bits, ps):
    """paged_write_prompt (whole prompt and a suffix from a later page),
    paged_write_step (positions on both nibble halves, the null page for an
    unallocated slot) and paged_write_prompt_batch leave the port's pools
    and scales byte-equal to JAX's."""
    h, d, b, pps, n_pages = 2, 64, 3, 4, 14
    counts = [3, 1, 4]
    jc = _jax_cache(h, d, n_pages, b, pps, ps, kv_bits, counts, seed=ps + kv_bits)
    tc = to_port(jc)
    assert_same_cache(tc, jc)
    for slot, first, n_log, seed in ((0, 0, 3, 1), (2, 1, 3, 2), (1, 0, 1, 3)):
        k, v = _normal((h, n_log * ps, d), seed), _normal((h, n_log * ps, d), seed + 10)
        jc = jpc.paged_write_prompt(jc, slot, jnp.asarray(k), jnp.asarray(v), first_page=first)
        tpc.paged_write_prompt(tc, slot, torch.from_numpy(k), torch.from_numpy(v),
                               first_page=first)
        assert_same_cache(tc, jc)
    for step, pos in enumerate(([5, 1, 2 * ps + 3], [ps // 2, 2, ps - 1],
                                [2 * ps + 7, ps // 2 - 1, 3 * ps + ps // 2])):
        k, v = _normal((b, h, 1, d), 20 + step), _normal((b, h, 1, d), 30 + step)
        jpos = jnp.asarray(pos, jnp.int32)
        jc = jpc.paged_write_step(jc, jnp.asarray(k), jnp.asarray(v), jpos)
        tpc.paged_write_step(tc, torch.from_numpy(k), torch.from_numpy(v),
                             torch.tensor(pos))
        assert_same_cache(tc, jc)
    kb, vb = _normal((b, h, pps * ps, d), 40), _normal((b, h, pps * ps, d), 41)
    jc = jax.jit(jpc.paged_write_prompt_batch)(jc, jnp.asarray(kb), jnp.asarray(vb))
    tpc.paged_write_prompt_batch(tc, torch.from_numpy(kb), torch.from_numpy(vb))
    assert_same_cache(tc, jc)
    for got, want in zip(tpc.gather_slot_kv(tc), jpc.gather_slot_kv(jc)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(tpc.gather_slot_kv(tc, max_pages=2), jpc.gather_slot_kv(jc, 2)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_writes_past_the_table_never_wrap(kv_bits):
    """A decode row whose logical page lies past the table (the engine's
    parking column is inside it) writes the null page and nothing else; a
    prompt segment reaching past the table writes only its pages inside."""
    ps, h, d = 8, 2, 64
    tc = to_port(_jax_cache(h, d, 9, 2, 3, ps, kv_bits, [3, 2], seed=7))
    before = {f: getattr(tc, f).clone() for f in FIELDS}
    k = torch.from_numpy(_normal((2, h, 1, d), 1))
    tpc.paged_write_step(tc, k, k, torch.tensor([3 * ps + 2, 5 * ps]))
    for f in FIELDS:
        changed = (getattr(tc, f) != before[f]).flatten(1).any(dim=1).nonzero().flatten()
        assert changed.tolist() in ([], [0]), f
    seg = torch.from_numpy(_normal((h, 2 * ps, d), 2))
    tpc.paged_write_prompt(tc, 0, seg, seg, first_page=2)       # page 2 only
    pt = tc.page_table.numpy()
    for f in ("kq", "kc"):
        changed = set((getattr(tc, f) != before[f]).flatten(1).any(dim=1).nonzero()
                      .flatten().tolist()) - {0}
        assert changed == {int(pt[0, 2])}, f
    with pytest.raises(ValueError, match="whole number"):
        tpc.paged_write_prompt(tc, 0, seg[:, :ps - 1], seg[:, :ps - 1])


def test_init_and_interop_layout():
    tc = tpc.init_paged_cache(2, 64, 5, 3, 4, page_size=16, kv_bits=4, device="cpu")
    jc = jpc.init_paged_cache(2, 64, 5, 3, 4, page_size=16, kv_bits=4)
    assert_same_cache(tc, jc)
    assert tc.page_table.shape == (3, 4) and tc.page_table.dtype == torch.int32
    assert tc.n_pages == 5 and tc.kq.shape == (5, 2, 8, 64)
    jc = jpc.PagedKVCache(kq=jc.kq, kc=jc.kc, vq=jc.vq, vc=jc.vc, page_table=jc.page_table,
                          step_slot=jnp.asarray([0, 1, 2, 2], jnp.int32),
                          step_page=jnp.asarray([0, 0, 0, 4], jnp.int32),
                          page_size=16, kv_bits=4)
    pc = to_port(jc)
    assert pc.step_slot.tolist() == [0, 1, 2, 2] and pc.step_slot.device.type == "cpu"
    for bits, ps in ((4, 7), (3, 8)):
        with pytest.raises(ValueError, match="kv_bits"):
            tpc.init_paged_cache(2, 64, 5, 3, 4, page_size=ps, kv_bits=bits, device="cpu")
