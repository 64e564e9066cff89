"""The last shapes the JAX kernels take that the card once refused, on the
CPU: pages of any size (not multiples of 8, odd, past 256), head widths
past 256, and d != dv past 256. Per kernel module, its plain version (what
a CPU tensor runs) against the JAX kernel in interpret mode on the same
numpy inputs, as tests/test_torch_attn_geometries.py holds them at the
narrower shapes: K2 (int8 and float32 caches) at head_dim 384 and 576; K5's
ragged entry at pages 1, 3, 4, 12, 272 and 512 (int8; int4 at the even
ones) and at head_dim 384; K6 at pages 4, 12 and 272 and head_dim 384; K3
and K7 at (d, dv) = (576, 512). Then the slice as a whole: the paged engine
at pages of 12 and 272 (int8 pools) and 4 (int4) against JAX's engine,
greedy transcripts exactly. The card holds the kernels at these shapes
(chip_smoke.py ``shape_limits``, ``wide_pages``).

Tolerances are the narrower shapes' (test_torch_attn_geometries.py):
kernels rtol 0, atol 2e-5 (float32 sums in another order; int8 caches
5e-3, bf16 roundings of the scores), paged 1e-5 * max|ref| (1e-4 at the
widths past 256, whose longer dot products sum in another order), K7's
gradients rtol 1e-4, atol 1e-5 * max|g|; transcripts exactly.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgemm_tpu.ops.kv_cache import quantize_kv as j_quantize_kv
from qgemm_tpu.ops.pallas import paged_attention as jpa
from qgemm_tpu.ops.pallas.decode_attention import decode_attention as j_decode
from qgemm_tpu.ops.pallas.flash_attention import flash_attention as j_flash_attention
from qgemm_tpu.ops.pallas.flash_attention import _flash_attention_fwd_impl as j_flash
from qgemm_tpu.serving.engine import ContinuousBatchingEngine as JEngine
from qgemm_tpu.serving.engine import Request as JRequest
from qgemm_tpu_torch.ops import cuda as kernels
from qgemm_tpu_torch.ops.cuda.decode_attention import decode_attention
from qgemm_tpu_torch.ops.cuda.flash_attention import flash_attention, flash_attention_fwd
from qgemm_tpu_torch.ops.cuda.paged_context_attention import paged_context_attention
from qgemm_tpu_torch.ops.cuda.paged_decode_attention import paged_decode_attention_ragged
from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
from qgemm_tpu_torch.utils.testing import assert_allclose, use_test_threads
from test_torch_attn_geometries import _close, _filled_cache, _pair, _rand
from test_torch_paged_cache import to_port

use_test_threads()


# ---------------------------------------------------------------- kernels

@pytest.mark.parametrize("cache", ["int8", "float32"])
@pytest.mark.parametrize("d,g", [(384, 2), (576, 1), (1024, 3)])
def test_decode_plain_matches_jax_past_256(d, g, cache):
    """K2's plain version against JAX's decode kernel, which takes the whole
    head width in one block: widths 384, 576 and 1024, ragged lengths."""
    b, hkv, s = 2, 1, 70
    q, k, v = _rand((b, hkv * g, 1, d), 11), _rand((b, hkv, s, d), 12), _rand((b, hkv, s, d), 13)
    lengths = np.array([9, 70], np.int32)
    t = lambda a: torch.from_numpy(np.array(a))
    if cache == "int8":
        (kq, kc), (vq, vc) = j_quantize_kv(jnp.asarray(k)), j_quantize_kv(jnp.asarray(v))
        want = j_decode(jnp.asarray(q), kq, vq, jnp.asarray(lengths), kc=kc, vc=vc)
        got = decode_attention(t(q), t(kq), t(vq), t(lengths), kc=t(kc), vc=t(vc))
        atol = 5e-3
    else:
        want = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths))
        got = decode_attention(t(q), t(k), t(v), t(lengths))
        atol = 2e-5
    assert got.shape == (b, hkv * g, 1, d)
    assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("kv_bits,d,g,ps", [
    (8, 32, 2, 1), (8, 32, 2, 3), (8, 32, 2, 4), (8, 32, 2, 12), (8, 32, 2, 272),
    (8, 32, 3, 512), (4, 32, 2, 4), (4, 32, 2, 12), (4, 32, 2, 272), (4, 32, 1, 512),
    (8, 384, 2, 16), (4, 384, 2, 12),
])
def test_paged_decode_plain_matches_jax_at_any_page(kv_bits, d, g, ps):
    """K5's ragged entry against JAX's ragged kernel at pages that are not
    multiples of 8, odd (int8), larger than 256 (in-page splits on the
    card), and at head width 384."""
    hkv = 1
    lengths = (3 * ps + 1, ps, 5, 2 * ps + ps // 2)
    pps = max(-(-n // ps) for n in lengths)
    jc = _filled_cache(hkv, d, lengths, ps, kv_bits, pps=pps, seed=d + ps + g + kv_bits)
    q = _rand((4, hkv * g, 1, d), g + ps)
    got = paged_decode_attention_ragged(torch.from_numpy(q), to_port(jc),
                                        torch.tensor(lengths, dtype=torch.int32))
    _close(got, jpa.paged_decode_attention_ragged(jnp.asarray(q), jc,
                                                  jnp.asarray(lengths, jnp.int32)),
           1e-4 if d > 256 else 1e-5)


@pytest.mark.parametrize("d,g,ps", [(32, 2, 4), (32, 3, 12), (32, 2, 272), (384, 2, 16)])
def test_paged_context_plain_matches_jax_at_any_page(d, g, ps):
    """K6's plain version against JAX's context kernel (int8 pools) at
    pages 4, 12 and 272 and head width 384: chunks ending at each slot's
    tail at per-slot unaligned offsets."""
    hkv, c = 1, 12
    lengths = (3 * ps + 1 + c, 2 * ps + c, c + 3)   # every chunk after its slot's offset >= 0
    pps = max(-(-n // ps) for n in lengths)
    jc = replace(_filled_cache(hkv, d, lengths, ps, 8, pps=pps, seed=d * g + ps),
                 step_slot=None, step_page=None)
    offs = np.asarray(lengths, np.int32) - c
    q = _rand((3, hkv * g, c, d), ps + g)
    got = paged_context_attention(torch.from_numpy(q), to_port(jc),
                                  torch.tensor(lengths, dtype=torch.int32),
                                  torch.from_numpy(offs))
    _close(got, jpa.paged_context_attention(jnp.asarray(q), jc, jnp.asarray(lengths, jnp.int32),
                                            jnp.asarray(offs)),
           1e-4 if d > 256 else 1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_jax_at_576_512(causal):
    """K3's plain version and the differentiable flash_attention (K7's
    plain version behind it) against JAX's kernels at (d, dv) = (576, 512)
    (float32; JAX pads d and dv each to a multiple of 128)."""
    b, h, sq, sk, d, dv = 1, 2, 40, 50, 576, 512
    q, k = _rand((b, h, sq, d), 21), _rand((b, h, sk, d), 22)
    v, dout = _rand((b, h, sk, dv), 23), _rand((b, h, sq, dv), 24)
    jo, jl = j_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=causal)
    to, tl = flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    assert to.shape == (b, h, sq, dv)
    assert_allclose(to, np.asarray(jo), rtol=0, atol=2e-5)
    assert_allclose(tl, np.asarray(jl), rtol=0, atol=2e-5)
    jg = jax.grad(lambda a, b_, c: (j_flash_attention(a, b_, c, causal=causal)
                                    * jnp.asarray(dout)).sum(), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (flash_attention(tq, tk, tv, causal=causal) * torch.from_numpy(dout)).sum().backward()
    for name, got, want in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), jg):
        want = np.asarray(want)
        assert_allclose(got, want, rtol=1e-4, atol=1e-5 * float(np.abs(want).max()), msg=name)


# ------------------------------------------------------------- the slice

def _serve(engine_cls, req_cls, model, prompts, news, **kw):
    eng = engine_cls(model, max_slots=2, max_seq_len=96, **kw)
    reqs = [req_cls(prompt=p, max_new_tokens=n) for p, n in zip(prompts, news)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion(max_steps=500)
    assert all(r.done and r.error is None for r in reqs), [r.error for r in reqs]
    return [list(r.generated) for r in reqs], eng


@pytest.mark.parametrize("ps,kv_bits", [(12, 8), (272, 8), (4, 4)])
def test_paged_engine_transcripts_match_jax_engine_at_any_page(ps, kv_bits):
    """The paged engine (prefix cache, 16-row chunks) at pages of 12 and
    272 (int8 pools; one page holds a whole request) and 4 (int4) against
    JAX's engine on the same float32 weights: greedy transcripts exactly,
    every page returned."""
    jm, tm = _pair("d16_g7")
    rng = np.random.default_rng(ps + kv_bits)
    system = rng.integers(0, 61, 24).tolist()
    prompts = ([system + rng.integers(0, 61, n).tolist() for n in (3, 21)]
               + [rng.integers(0, 61, 30).tolist()])
    news = [6, 5, 7]
    kw = dict(paged=True, page_size=ps, chunked_prefill=16, kv_bits=kv_bits)
    want, _ = _serve(JEngine, JRequest, jm, prompts, news, scheduler="python", **kw)
    kernels.reset_launch_counts()
    got, te = _serve(ContinuousBatchingEngine, Request, tm, prompts, news, device="cpu", **kw)
    assert sum(kernels.launch_counts().values()) == 0      # the CPU runs the plain versions
    assert got == want
    assert te.stats["pages_in_use"] == 0
