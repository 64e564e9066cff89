"""The attention geometries the port's kernels take at head widths up to
256, at any GQA group and at pages of 8, on the CPU: the port against the
JAX package on the same numpy inputs and weights (``utils/interop.py``).

Per kernel module, its plain version (what a CPU tensor runs) against the
JAX kernel in interpret mode, as tests/test_torch_attention.py and
test_torch_paged_attention.py hold them at narrower shapes: K2 (int8 and
float32 caches) at head_dim 256 and 160 and groups 7, 16 and 71; K5's
ragged entry and K6 at pages of 8 and 16, head_dim 256 and group 7; K3
and K7 at head_dim 256. Then the slice as a whole, three tiny GPTs:
head_dim 256 (2 heads over 1 KV head), group 7 (7 heads over 1) and group
= n_heads (16 heads over 1): the forward's logits (float32 and int8
weights, the latter held code by code as test_torch_tp_model.py holds
its W4A8 model), greedy transcripts of the dense engine (int8 KV cache) and of
the paged engine at pages of 8 and 16 against JAX's engines, and at
head_dim 256 one training step's gradients. The card holds the kernels
at these shapes (chip_smoke.py ``shape_limits``, ``attn_geometries``).

Tolerances are those of the narrower shapes' tests: kernels rtol 0, atol
2e-5 (float32 sums in another order; int8 caches 5e-3, bf16 roundings of
the scores), paged 1e-5 * max|ref|; the model's float32 logits 2e-5, int8
logits atol 2e-3 (a one-code flip, test_torch_gpt.py); transcripts
exactly; step 1's gradients rtol 1e-4, atol 1e-5 * max|g| per leaf
(test_torch_training.py).
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgemm_tpu.models.gpt import GPT as JGPT
from qgemm_tpu.models import linear as j_linear
from qgemm_tpu.models.gpt import GPTConfig as JConfig
from qgemm_tpu.ops.kv_cache import quantize_kv as j_quantize_kv
from qgemm_tpu.ops.pallas import paged_attention as jpa
from qgemm_tpu.ops.pallas.decode_attention import decode_attention as j_decode
from qgemm_tpu.ops.pallas.flash_attention import flash_attention as j_flash_attention
from qgemm_tpu.ops.pallas.flash_attention import _flash_attention_fwd_impl as j_flash
from qgemm_tpu.serving import paged_cache as jpc
from qgemm_tpu.serving.engine import ContinuousBatchingEngine as JEngine
from qgemm_tpu.serving.engine import Request as JRequest
from qgemm_tpu_torch.examples.train_gpt_lm import loss_fn
from qgemm_tpu_torch.models import linear as t_linear
from qgemm_tpu_torch.models.gpt import GPTConfig
from qgemm_tpu_torch.ops import cuda as kernels
from qgemm_tpu_torch.ops.cuda.decode_attention import decode_attention
from qgemm_tpu_torch.ops.cuda.flash_attention import flash_attention, flash_attention_fwd
from qgemm_tpu_torch.ops.cuda.paged_context_attention import paged_context_attention
from qgemm_tpu_torch.ops.cuda.paged_decode_attention import paged_decode_attention_ragged
from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
from qgemm_tpu_torch.utils.interop import gpt_from_jax_params
from qgemm_tpu_torch.utils.testing import (activation_code_ties, activation_values,
                                           assert_allclose, use_test_threads)
from test_torch_gpt import jax_params
from test_torch_paged_cache import shuffled_tables, to_port
from test_torch_training import _jax_train_step, _leaves

use_test_threads()

# the three geometries: (head_dim 256, group 2), group 7, group = n_heads
GEOMETRIES = {
    "d256_g2": dict(d_model=512, n_heads=2, n_kv_heads=1),
    "d16_g7": dict(d_model=112, n_heads=7, n_kv_heads=1),
    "d8_g16": dict(d_model=128, n_heads=16, n_kv_heads=1),
}
TINY = dict(vocab_size=61, d_ff=128, n_layers=2, max_seq_len=128)
# an int8 activation code may differ between the packages only where both
# values before rounding lie within this many code steps of k + 1/2
INT8_TIE_EPS = 1e-3


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, scale=1e-5):
    want = np.asarray(want, np.float32)
    assert_allclose(got, want, rtol=scale, atol=scale * float(np.abs(want).max()))


# ---------------------------------------------------------------- kernels

@pytest.mark.parametrize("cache", ["int8", "float32"])
@pytest.mark.parametrize("d,g", [(256, 2), (160, 7), (64, 16), (8, 71)])
def test_decode_plain_matches_jax(d, g, cache):
    """K2's plain version against JAX's decode kernel: head widths 256 and
    160 (the compiled 256, read at the true width), groups 7, 16 and 71
    over one KV head, ragged lengths."""
    b, hkv, s = 3, 1, 100
    q, k, v = _rand((b, hkv * g, 1, d), 1), _rand((b, hkv, s, d), 2), _rand((b, hkv, s, d), 3)
    lengths = np.array([1, 57, 100], np.int32)
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


def _filled_cache(hkv, d, lengths, ps, kv_bits, pps, seed):
    """A JAX paged cache of head width ``d`` whose slots hold random K/V for
    ``lengths`` tokens in shuffled physical pages, with step tables."""
    b = len(lengths)
    counts = [-(-ln // ps) for ln in lengths]
    n_pages = 1 + sum(counts) + 2
    jc = jpc.init_paged_cache(hkv, d, n_pages, b, pps, page_size=ps, kv_bits=kv_bits)
    jc = replace(jc, page_table=jnp.asarray(shuffled_tables(b, pps, n_pages, counts, seed)))
    rng = np.random.default_rng(seed)
    for s, ln in enumerate(lengths):
        ext = -(-ln // ps) * ps
        k = rng.standard_normal((hkv, ext, d)).astype(np.float32)
        v = rng.standard_normal((hkv, ext, d)).astype(np.float32)
        jc = jpc.paged_write_prompt(jc, s, jnp.asarray(k), jnp.asarray(v))
    ss, sp = jpc.build_step_tables(counts, pps)
    return replace(jc, step_slot=jnp.asarray(ss), step_page=jnp.asarray(sp))


@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("d,g,ps", [(256, 2, 8), (256, 2, 16), (32, 7, 8)])
def test_paged_decode_plain_matches_jax_ragged_kernel(d, g, ps, kv_bits):
    """K5's ragged entry (the engine's) against JAX's ragged kernel at
    pages of 8 and 16, head width 256 and group 7."""
    hkv = 1
    lengths = (3 * ps + 1, ps, 5, 2 * ps + ps // 2)
    jc = _filled_cache(hkv, d, lengths, ps, kv_bits, pps=4, seed=d + ps + g + kv_bits)
    q = _rand((4, hkv * g, 1, d), g)
    got = paged_decode_attention_ragged(torch.from_numpy(q), to_port(jc),
                                        torch.tensor(lengths, dtype=torch.int32))
    _close(got, jpa.paged_decode_attention_ragged(jnp.asarray(q), jc,
                                                  jnp.asarray(lengths, jnp.int32)))


@pytest.mark.parametrize("d,g,ps", [(256, 2, 8), (256, 2, 16), (32, 7, 8)])
def test_paged_context_plain_matches_jax_kernel(d, g, ps):
    """K6's plain version against JAX's context kernel (int8 pools) at
    pages of 8 and 16: chunks ending at each slot's tail at per-slot
    unaligned offsets."""
    hkv, c = 1, 12
    lengths = (3 * ps + 1, 2 * ps, c + 3)
    jc = replace(_filled_cache(hkv, d, lengths, ps, 8, pps=4, seed=d * g + ps),
                 step_slot=None, step_page=None)
    offs = np.asarray(lengths, np.int32) - c
    q = _rand((3, hkv * g, c, d), ps + g)
    got = paged_context_attention(torch.from_numpy(q), to_port(jc),
                                  torch.tensor(lengths, dtype=torch.int32),
                                  torch.from_numpy(offs))
    _close(got, jpa.paged_context_attention(jnp.asarray(q), jc, jnp.asarray(lengths, jnp.int32),
                                            jnp.asarray(offs)))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_jax_at_head_dim_256(causal):
    """K3's plain version and the differentiable flash_attention (K7's
    plain version behind it) against JAX's kernels at head_dim 256
    (float32; JAX pads d to a multiple of 128)."""
    b, h, s, d = 1, 2, 70, 256
    q, k, v, dout = (_rand((b, h, s, d), i) for i in (4, 5, 6, 7))
    jo, jl = j_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=causal)
    to, tl = flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
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

def _pair(name: str, quantize: bool = False):
    sizes = {**TINY, **GEOMETRIES[name]}
    jm = JGPT.init(JConfig(**sizes), key=jax.random.PRNGKey(len(name)))
    if quantize:
        jm = jm.quantize()
    return jm, gpt_from_jax_params(jax_params(jm), GPTConfig(**sizes), device="cpu")


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_forward_matches_jax(name, quantize, monkeypatch):
    """The forward's logits. int8 weights: every quantized layer's
    activation codes against JAX's (``activation_code_ties``: equal but for
    ties within ``INT8_TIE_EPS`` of a rounding boundary), then the logits at
    test_torch_gpt.py's 2e-3 on the rows no tie reaches, at least half of
    them (a tie's one-code flip moves its rows by ~8e-3 at d_model 512:
    head_dim 256 at these inputs has one, batch 1, position 9)."""
    jm, tm = _pair(name, quantize)
    toks = np.random.default_rng(3).integers(0, TINY["vocab_size"], size=(2, 23))
    seen = {"port": [], "jax": []}

    def recorded(side, fn):
        def run(x, *args, **kw):
            seen[side].append([activation_values(np.asarray(x))])
            return fn(x, *args, **kw)
        return run

    monkeypatch.setattr(j_linear, "quantized_matmul_prequant",
                        recorded("jax", j_linear.quantized_matmul_prequant))
    monkeypatch.setattr(t_linear, "quantized_matmul_prequant",
                        recorded("port", t_linear.quantized_matmul_prequant))
    want = np.asarray(jm.forward(jnp.asarray(toks, jnp.int32)))
    with torch.no_grad():
        got = tm(torch.from_numpy(toks)).numpy()
    if not quantize:
        assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        return
    assert len(seen["port"]) == len(seen["jax"]) == 6 * TINY["n_layers"] + 1
    reached, _ = activation_code_ties(seen["port"], seen["jax"], toks.shape[1], INT8_TIE_EPS)
    keep = ~reached
    assert keep.sum() * 2 >= keep.size
    vocab = got.shape[-1]
    assert_allclose(got.reshape(-1, vocab)[keep], want.reshape(-1, vocab)[keep], rtol=2e-5,
                    atol=2e-3)


def _prompts(seed: int, ps: int):
    """Four requests: three share a two-page system prompt (one longer than
    two chunks of 16), one does not."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, TINY["vocab_size"], 2 * ps).tolist()
    return ([system + rng.integers(0, TINY["vocab_size"], n).tolist() for n in (3, 29, 11)]
            + [rng.integers(0, TINY["vocab_size"], 37).tolist()]), [6, 5, 7, 4]


def _serve(engine_cls, req_cls, model, prompts, news, **kw):
    eng = engine_cls(model, max_slots=2, max_seq_len=128, **kw)
    reqs = [req_cls(prompt=p, max_new_tokens=n) for p, n in zip(prompts, news)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion(max_steps=500)
    assert all(r.done and r.error is None for r in reqs), [r.error for r in reqs]
    return [list(r.generated) for r in reqs], eng


@pytest.mark.parametrize("tier", ["dense", "paged8", "paged16"])
@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_engine_transcripts_match_jax_engine(name, tier):
    """Greedy transcripts of the dense engine (int8 KV cache) and of the
    paged engine (int8 pools, prefix cache, 16-row chunks) at pages of 8
    and 16 against JAX's engines on the same float32 weights, exactly."""
    jm, tm = _pair(name)
    ps = 16 if tier == "paged16" else 8
    prompts, news = _prompts(11, ps)
    kw = (dict(quantized_cache=True) if tier == "dense"
          else dict(paged=True, page_size=ps, chunked_prefill=16))
    want, _ = _serve(JEngine, JRequest, jm, prompts, news, scheduler="python", **kw)
    kernels.reset_launch_counts()
    got, te = _serve(ContinuousBatchingEngine, Request, tm, prompts, news, device="cpu", **kw)
    assert sum(kernels.launch_counts().values()) == 0      # the CPU runs the plain versions
    assert got == want
    if tier != "dense":
        assert te.stats["prefix_hits"] > 0 and te.stats["pages_in_use"] == 0


def test_training_step_gradients_match_jax_at_head_dim_256():
    """One training step of the head_dim 256 GPT (float32): every leaf's
    gradient against JAX's jitted gradient of the same loss on the same
    batch (test_torch_training.py's tolerance)."""
    sizes = {**TINY, **GEOMETRIES["d256_g2"], "vocab_size": 32, "max_seq_len": 24}
    jcfg = JConfig(**sizes)
    jm = JGPT.init(jcfg, key=jax.random.PRNGKey(1))
    model = gpt_from_jax_params(_leaves(jm), GPTConfig(**sizes), device="cpu")
    seqs = np.random.default_rng(5).integers(0, 32, size=(4, 17)).astype(np.int32)
    want = _leaves(_jax_train_step(jcfg)[2](jm, jnp.asarray(seqs)))
    loss_fn(model, torch.from_numpy(seqs)).backward()
    for key, p in model.named_trainable():
        ref = want[key]
        assert_allclose(p.grad, ref, rtol=1e-4, atol=1e-5 * float(np.abs(ref).max()), msg=key)
