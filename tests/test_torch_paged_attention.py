"""Port parity for the plain versions of kernels K5 and K6 (the CPU path of
qgemm_tpu_torch/ops/cuda/paged_decode_attention.py and
paged_context_attention.py) against the TPU kernels of
qgemm_tpu/ops/pallas/paged_attention.py, run in interpret mode on the CPU
as tests/test_paged_cache.py runs them, and against the gather oracles of
qgemm_tpu/serving/paged_cache.py where the TPU kernel has no counterpart
(GQA without step tables; int4 context chunks).

The same numpy inputs build both packages' caches (the JAX writers fill the
pools; the port gets them through utils/interop.paged_cache_from_numpy).
Tolerance: both sides compute in float32 (JAX's interpret mode and CPU
oracle use f32 products, as the port's CPU path does) and differ only in
summation order: rtol 1e-5 on every element, atol 1e-5 * max|ref|.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgemm_tpu.ops.pallas import paged_attention as jpa
from qgemm_tpu.serving import paged_cache as jpc
from qgemm_tpu_torch.ops import cuda as kernels
from qgemm_tpu_torch.ops.cuda.paged_context_attention import paged_context_attention
from qgemm_tpu_torch.ops.cuda.paged_decode_attention import (paged_decode_attention,
                                                             paged_decode_attention_ragged)
from qgemm_tpu_torch.serving.paged_cache import check_step_tables
from qgemm_tpu_torch.utils.testing import assert_allclose, use_test_threads
from test_torch_paged_cache import shuffled_tables, to_port

use_test_threads()

D = 64


def _close(got, want):
    want = np.asarray(want)
    assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


def filled_cache(hkv, lengths, ps, kv_bits, pps, seed, extra=()):
    """A JAX paged cache whose slots hold random K/V for ``lengths`` tokens
    in shuffled physical pages (``extra`` slots get one more allocated,
    unfilled page, as a worst-case reservation leaves), with step tables."""
    b = len(lengths)
    counts = [-(-ln // ps) + (s in extra) for s, ln in enumerate(lengths)]
    n_pages = 1 + sum(counts) + 2
    jc = jpc.init_paged_cache(hkv, D, n_pages, b, pps, page_size=ps, kv_bits=kv_bits)
    jc = replace(jc, page_table=jnp.asarray(shuffled_tables(b, pps, n_pages, counts, seed)))
    rng = np.random.default_rng(seed)
    for s, ln in enumerate(lengths):
        ext = -(-ln // ps) * ps
        k = rng.standard_normal((hkv, ext, D)).astype(np.float32)
        v = rng.standard_normal((hkv, ext, D)).astype(np.float32)
        jc = jpc.paged_write_prompt(jc, s, jnp.asarray(k), jnp.asarray(v))
    ss, sp = jpc.build_step_tables(counts, pps)
    return replace(jc, step_slot=jnp.asarray(ss), step_page=jnp.asarray(sp))


# (kv_bits, page, g): int8 and int4 pools, pages of 8 and 16 positions,
# MHA and GQA (g = 2)
CASES = [(8, 8, 2), (4, 16, 1), (4, 8, 2)]


@pytest.mark.parametrize("kv_bits,ps,g", CASES)
def test_decode_plain_matches_jax_kernels(kv_bits, ps, g):
    """Both K5 entries' plain path against the ragged TPU kernel (any g) and
    the rectangular one (MHA; with GQA, against the oracle JAX falls back
    to), mixed residencies incl. an exact page boundary and an allocated
    but unfilled page."""
    hkv = 2
    lengths = (3 * ps + 1, ps, 5, 2 * ps + ps // 2)
    jc = filled_cache(hkv, lengths, ps, kv_bits, pps=4, seed=ps + kv_bits + g, extra=(1,))
    tc = to_port(jc)
    q = np.random.default_rng(g).standard_normal((4, hkv * g, 1, D)).astype(np.float32)
    jl = jnp.asarray(lengths, jnp.int32)
    tl = torch.tensor(lengths, dtype=torch.int32)
    kernels.reset_launch_counts()
    got_r = paged_decode_attention_ragged(torch.from_numpy(q), tc, tl)
    _close(got_r, jpa.paged_decode_attention_ragged(jnp.asarray(q), jc, jl))
    got = paged_decode_attention(torch.from_numpy(q), tc, tl)
    if g == 1:
        want = jpa.paged_decode_attention(jnp.asarray(q), replace(jc, step_slot=None,
                                                                 step_page=None), jl)
    else:
        want = jpc.paged_attention_reference(jnp.asarray(q), jc, jl)
    _close(got, want)
    assert got.shape == (4, hkv * g, 1, D) and got.dtype == torch.float32
    assert sum(kernels.launch_counts().values()) == 0


@pytest.mark.parametrize("kv_bits,ps,g", CASES)
def test_context_plain_matches_jax(kv_bits, ps, g):
    """K6's plain path against the context TPU kernel (int8 pools; int4
    against the gather oracle, which is JAX's route for int4 chunks): chunks
    ending at each slot's tail at per-slot unaligned offsets, and the
    model's call shape (B = 1, a page-aligned int offset)."""
    hkv, c = 2, 12
    lengths = (3 * ps + 1, 2 * ps, c + 3)
    jc = replace(filled_cache(hkv, lengths, ps, kv_bits, pps=4, seed=ps * g + kv_bits),
                 step_slot=None, step_page=None)
    tc = to_port(jc)
    jl = jnp.asarray(lengths, jnp.int32)
    offs = np.asarray(lengths, np.int32) - c
    q = np.random.default_rng(ps + g).standard_normal((3, hkv * g, c, D)).astype(np.float32)
    oracle = jpa.paged_context_attention if kv_bits == 8 else \
        jpc.paged_context_attention_reference
    got = paged_context_attention(torch.from_numpy(q), tc,
                                  torch.tensor(lengths, dtype=torch.int32),
                                  torch.from_numpy(offs))
    _close(got, oracle(jnp.asarray(q), jc, jl, jnp.asarray(offs)))
    # B = 1, scalar page-aligned offset, the chunk two pages long
    c1, off = 2 * ps, ps
    q1 = np.random.default_rng(7).standard_normal((1, hkv * g, c1, D)).astype(np.float32)
    j1 = replace(jc, page_table=jc.page_table[0:1])
    t1 = replace(tc, page_table=tc.page_table[0:1])
    want = oracle(jnp.asarray(q1), j1, jnp.asarray([off + c1], jnp.int32), off)
    got = paged_context_attention(torch.from_numpy(q1), t1,
                                  torch.tensor([off + c1], dtype=torch.int32), off)
    _close(got, want)


def test_wrappers_reject_bad_arguments():
    jc = filled_cache(2, (9, 3), 8, 8, pps=3, seed=1)
    tc = to_port(jc)
    q = torch.zeros((2, 4, 1, D))
    lengths = torch.tensor([9, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="Sq == 1"):
        paged_decode_attention(torch.zeros((2, 4, 2, D)), tc, lengths)
    with pytest.raises(ValueError, match="incompatible"):
        paged_decode_attention(torch.zeros((2, 3, 1, D)), tc, lengths)
    with pytest.raises(ValueError, match="lengths"):
        paged_decode_attention(q, tc, lengths[:1])
    with pytest.raises(ValueError, match="step tables"):
        paged_decode_attention_ragged(q, replace(tc, step_slot=None, step_page=None), lengths)
    with pytest.raises(ValueError, match="step tables"):
        paged_decode_attention_ragged(q, replace(tc, step_slot=tc.step_slot[:-1]), lengths)
    # what the tables hold is checked where they are built, once per rebuild
    ss, sp = tc.step_slot.numpy(), tc.step_page.numpy()
    check_step_tables(ss, sp, 2, 3)
    with pytest.raises(ValueError, match="every slot"):
        check_step_tables(np.zeros_like(ss), sp, 2, 3)
    with pytest.raises(ValueError, match="logical pages"):
        check_step_tables(ss, sp + 4, 2, 3)
    with pytest.raises(ValueError, match="vq"):
        paged_decode_attention(q, replace(tc, vq=tc.vq.float()), lengths)
    with pytest.raises(ValueError, match="incompatible"):
        paged_context_attention(torch.zeros((1, 4, 8, D)), tc, lengths[:1], 0)
