"""Port parity for the encoder-decoder model family
(qgemm_tpu_torch/models/transformer.py, the cross-attention branches of
models/attention.py, both beam searches, utils/interop.py's
transformer_from_jax_params) against qgemm_tpu on the CPU.

The models are the JAX package's, carried over leaf by leaf. Tolerances:
float32 logits agree to f32 rounding (the two sides sum in other orders):
rtol/atol 2e-5. Quantized models add int8 activation codes computed from
values that may differ in the last bit: a one-code flip moves an output by
about |x| * |w| / 127, and the decoder carries it through its later
layers: atol 2e-2 on logits of magnitude ~1.5. The int8 cross read is held
at atol 1e-5 (both sides take f32 products on the CPU). Beam scores agree
to 1e-4 (log-softmax sums in f32 over up to 12 steps); with the int8
self-cache to 5e-3, as decode_chunk's logits: JAX compiles its scanned step
(XLA fuses multiply-adds), and a K/V row equal to f32 rounding can
quantize one code apart. Greedy and beam transcripts are compared
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgemm_tpu.models.attention import Attention as JAttention
from qgemm_tpu.models.attention import _quantized_cross_attention as j_qcross
from qgemm_tpu.models.gpt import GPT as JGPT
from qgemm_tpu.models.gpt import GPTConfig as JGPTConfig
from qgemm_tpu.models.transformer import Transformer as JTransformer
from qgemm_tpu.models.transformer import TransformerConfig as JConfig
from qgemm_tpu.ops.kv_cache import quantize_kv as j_quantize_kv
from qgemm_tpu_torch.models.attention import Attention, _quantized_cross_attention
from qgemm_tpu_torch.models.gpt import GPTConfig
from qgemm_tpu_torch.models.transformer import Transformer, TransformerConfig
from qgemm_tpu_torch.ops.kv_cache import quantize_kv
from qgemm_tpu_torch.utils.interop import gpt_from_jax_params, transformer_from_jax_params
from qgemm_tpu_torch.utils.testing import assert_allclose, use_test_threads
from test_torch_gpt import jax_params

use_test_threads()

SIZES = dict(vocab_size=64, d_model=32, n_heads=4, d_ff=64, n_layers=2, max_seq_len=64)
RNG = np.random.default_rng(15)
SRC = np.array([[3, 14, 15, 9, 26, 5], [6, 5, 3, 58, 9, 7]])
TGT = np.array([[1, 2, 3, 4], [1, 7, 7, 9]])


def pair(seed: int, quantize=False, **overrides):
    """A JAX Transformer (quantized with ``quantize`` as options, or float)
    and the port's, carried over from its leaves."""
    sizes = dict(SIZES, **overrides)
    jm = JTransformer.init(JConfig(**sizes), key=jax.random.PRNGKey(seed))
    if quantize:
        jm = jm.quantize(**(quantize if isinstance(quantize, dict) else {}))
    return jm, transformer_from_jax_params(jax_params(jm), TransformerConfig(**sizes),
                                           device="cpu")


def t(x):
    return torch.as_tensor(np.array(x))


# --- Attention (the single-head reference-parity layer) ---------------------
X_GOLD = np.array([0.3374, -0.1778, -0.3035, -0.5880, 0.3486, 0.6603],
                  np.float32).reshape(2, 3)
WQ_GOLD = np.array([0.2482, 0.2993, 0.0759, 0.4924, 0.5452, 0.0620],
                   np.float32).reshape(3, 2)
WK_GOLD = np.array([0.8953, 0.6716, 0.7721, 0.8670, 0.0594, 0.7789],
                   np.float32).reshape(3, 2)
WV_GOLD = np.array([0.9583, 0.6320, 0.1432, 0.0040, 0.0569, 0.1546,
                    0.6056, 0.3590, 0.6802, 0.0089, 0.1739, 0.7423],
                   np.float32).reshape(3, 4)


def test_attention_golden_and_cross():
    """tests/test_modules.py's golden values (the reference's PyTorch
    oracle weights, an independent numpy softmax(QK^T/sqrt(d_k)) V), and
    the cross and causal calls against the JAX layer."""
    attn = Attention(t(WQ_GOLD), t(WK_GOLD), t(WV_GOLD))
    q, k, v = X_GOLD @ WQ_GOLD, X_GOLD @ WK_GOLD, X_GOLD @ WV_GOLD
    s = q @ k.T / np.sqrt(2)
    a = np.exp(s - s.max(-1, keepdims=True))
    assert_allclose(attn(t(X_GOLD)), (a / a.sum(-1, keepdims=True)) @ v, rtol=1e-5, atol=1e-6)
    ja = JAttention(w_q=jnp.asarray(WQ_GOLD), w_k=jnp.asarray(WK_GOLD), w_v=jnp.asarray(WV_GOLD))
    x_kv = RNG.normal(size=(5, 3)).astype(np.float32)
    assert_allclose(attn(t(X_GOLD), t(x_kv)), ja(jnp.asarray(X_GOLD), jnp.asarray(x_kv)),
                    rtol=1e-5, atol=1e-6)
    x = RNG.normal(size=(2, 4, 3)).astype(np.float32)
    assert_allclose(attn(t(x), causal=True), ja(jnp.asarray(x), causal=True),
                    rtol=1e-5, atol=1e-6)
    g = torch.Generator()
    g.manual_seed(0)
    w = Attention.init(g, 16, 8, 4)
    assert w.w_q.shape == (16, 8) and w.w_v.shape == (16, 4)
    assert float(w.w_k.detach().abs().max()) <= 1 / 8 ** 0.5


@pytest.mark.parametrize("n_kv_heads", [0, 2])
def test_cross_attention_float_int8_masked(n_kv_heads):
    """MultiHeadAttention's cross branches on one decoder layer's weights:
    the float (k, v) pair with and without a source mask, the int8
    4-tuple with and without, MHA and GQA."""
    jm, tm = pair(3, n_kv_heads=n_kv_heads)
    jx, tx = jm.dec_blocks[0].cross_attn, tm.dec_blocks[0].cross_attn
    xq = RNG.normal(size=(2, 3, 32)).astype(np.float32)
    enc = RNG.normal(size=(2, 7, 32)).astype(np.float32)
    mask = np.arange(7)[None, :] < np.array([[4], [7]])
    jkv = jx.precompute_kv(jnp.asarray(enc))
    tkv = tx.precompute_kv(t(enc))
    assert_allclose(tkv[0], jkv[0], rtol=2e-5, atol=2e-5)
    for m in (None, mask):
        jm_ = None if m is None else jnp.asarray(m)
        tm_ = None if m is None else t(m)
        assert_allclose(tx(t(xq), precomputed_kv=tkv, mask=tm_),
                        jx(jnp.asarray(xq), precomputed_kv=jkv, mask=jm_), rtol=2e-5, atol=2e-5)
        j8 = (*j_quantize_kv(jkv[0]), *j_quantize_kv(jkv[1]))
        t8 = (*quantize_kv(tkv[0]), *quantize_kv(tkv[1]))
        assert_allclose(tx(t(xq), precomputed_kv=t8, mask=tm_),
                        jx(jnp.asarray(xq), precomputed_kv=j8, mask=jm_), rtol=2e-5, atol=2e-5)
    # the int8 read itself, masked
    q = RNG.normal(size=(2, 4, 1, 32)).astype(np.float32)
    kv = [RNG.normal(size=(2, 2, 16, 32)).astype(np.float32) for _ in range(2)]
    m16 = np.arange(16)[None, :] < np.array([[9], [16]])
    j8 = (*j_quantize_kv(jnp.asarray(kv[0])), *j_quantize_kv(jnp.asarray(kv[1])))
    t8 = (*quantize_kv(t(kv[0])), *quantize_kv(t(kv[1])))
    assert_allclose(_quantized_cross_attention(t(q), *t8, mask=t(m16)),
                    j_qcross(jnp.asarray(q), *j8, mask=jnp.asarray(m16)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quantize", [False, True, {"bits": 4}], ids=["float", "int8", "int4"])
def test_encode_decode_forward_logits(quantize):
    jm, tm = pair(4, quantize)
    tol = dict(rtol=2e-5, atol=2e-5) if not quantize else dict(rtol=0.0, atol=2e-2)
    mask = np.arange(6)[None, :] < np.array([[4], [6]])
    assert_allclose(tm.encode(t(SRC)), jm.encode(jnp.asarray(SRC)), **tol)
    assert_allclose(tm.encode(t(SRC), mask=t(mask)),
                    jm.encode(jnp.asarray(SRC), mask=jnp.asarray(mask)), **tol)
    enc = jm.encode(jnp.asarray(SRC))
    assert_allclose(tm.decode_full(t(TGT), t(enc)), jm.decode_full(jnp.asarray(TGT), enc), **tol)
    logits = tm(t(SRC), t(TGT))
    assert logits.shape == (2, 4, SIZES["vocab_size"]) and bool(torch.isfinite(logits).all())
    assert_allclose(logits, jm.forward(jnp.asarray(SRC), jnp.asarray(TGT)), **tol)


def test_decoder_is_causal_and_quantized_close():
    _, tm = pair(5)
    l1 = tm(t(SRC[:1]), torch.tensor([[5, 7, 9, 11]]))
    l2 = tm(t(SRC[:1]), torch.tensor([[5, 7, 9, 60]]))
    assert_allclose(l1[:, :3], l2[:, :3], rtol=1e-5, atol=1e-6)
    lf = tm(t(SRC), t(TGT)).detach().numpy()
    lq = tm.quantize()(t(SRC), t(TGT)).detach().numpy()
    assert np.linalg.norm(lq - lf) / np.linalg.norm(lf) < 0.1


@pytest.mark.parametrize("quantized_cache", [False, True])
def test_decode_chunk_scalar_and_per_slot_offsets(quantized_cache):
    """decode_chunk's logits and cache writes at a scalar offset and at [B]
    per-slot offsets (the verify chunk), against JAX; the self-cache is
    float (f32 rounding) or int8 (bf16 products on both sides; a K/V row
    equal to f32 rounding can still quantize one code apart, which moves a
    logit by ~2e-3: atol 5e-3)."""
    jm, tm = pair(6)
    enc = jm.encode(jnp.asarray(SRC))
    jkv = [b.cross_attn.precompute_kv(enc) for b in jm.dec_blocks]
    tkv = tm.cross_kvs(tm.encode(t(SRC)))
    mask = np.arange(6)[None, :] < np.array([[5], [6]])
    jc = jm.init_cache(2, 12, quantized=quantized_cache)
    tc = tm.init_cache(2, 12, quantized=quantized_cache)
    tol = dict(rtol=2e-5, atol=5e-3 if quantized_cache else 2e-5)
    jl, jc = jm.decode_chunk(jnp.asarray(TGT), 0, jkv, jc, src_mask=jnp.asarray(mask))
    tl, tc = tm.decode_chunk(t(TGT), 0, tkv, tc, src_mask=t(mask))
    assert_allclose(tl, jl, **tol)
    off = np.array([4, 2])
    chunk = np.array([[9, 8, 7], [6, 5, 4]])
    jl, jc = jm.decode_chunk(jnp.asarray(chunk), jnp.asarray(off), jkv, jc,
                             src_mask=jnp.asarray(mask))
    tl, tc = tm.decode_chunk(t(chunk), t(off), tkv, tc, src_mask=t(mask))
    assert_allclose(tl, jl, **tol)
    for a, b in zip(tc[1], jc[1]):
        assert_allclose(a.float(), np.asarray(b, np.float32), rtol=2e-5,
                        atol=1.0 if quantized_cache else 2e-5)
    jt, _ = jm.decode_step(jnp.asarray(chunk[:, :1]), 7, jkv, jc, src_mask=jnp.asarray(mask))
    tt, _ = tm.decode_step(t(chunk[:, :1]), 7, tkv, tc, src_mask=t(mask))
    assert tt.tolist() == np.asarray(jt).tolist()


@pytest.mark.parametrize("quantized_cache", [False, True])
def test_generate_matches_jax_and_naive(quantized_cache):
    """Greedy transcripts equal JAX's, with and without EOS pinning, and
    (float cache) the naive re-decode of the whole prefix each step."""
    jm, tm = pair(3)
    want = np.asarray(jm.generate(jnp.asarray(SRC), 8, quantized_cache=quantized_cache))
    got = tm.generate(t(SRC), 8, quantized_cache=quantized_cache)
    assert got.tolist() == want.tolist()
    eos = int(want[0, 3])
    want = np.asarray(jm.generate(jnp.asarray(SRC), 8, eos_token=eos,
                                  quantized_cache=quantized_cache))
    got = tm.generate(t(SRC), 8, eos_token=eos, quantized_cache=quantized_cache)
    assert got.tolist() == want.tolist() and got[0, 4:].tolist() == [eos] * 4
    if not quantized_cache:
        enc = tm.encode(t(SRC))
        toks = torch.ones((2, 1), dtype=torch.int64)
        for _ in range(8):
            nxt = tm.decode_full(toks, enc)[:, -1].argmax(-1, keepdim=True)
            toks = torch.cat([toks, nxt], 1)
        assert toks[:, 1:].tolist() == tm.generate(t(SRC), 8).tolist()


@pytest.mark.parametrize("quantized_cache", [False, True])
def test_transformer_beam_search_matches_jax(quantized_cache):
    """Tokens equal JAX's, scores within 1e-4, with EOS (finished beams
    pinned) and without; beam 1 equals greedy generation with EOS."""
    jm, tm = pair(40, vocab_size=61)
    src = np.array([[5, 6, 7, 8], [9, 3, 2, 1]])
    greedy = tm.generate(t(src), 10, quantized_cache=quantized_cache)
    eos = int(greedy[0, 4])
    for kw in (dict(beam_size=3), dict(beam_size=4, eos_token=eos),
               dict(beam_size=2, eos_token=eos, length_penalty=0.0)):
        jt, js = jm.beam_search(jnp.asarray(src), 10, quantized_cache=quantized_cache, **kw)
        tt, ts = tm.beam_search(t(src), 10, quantized_cache=quantized_cache, **kw)
        assert tt.tolist() == np.asarray(jt).tolist(), kw
        assert_allclose(ts, js, rtol=1e-4, atol=5e-3 if quantized_cache else 1e-4)
    b1, _ = tm.beam_search(t(src), 10, beam_size=1, eos_token=eos,
                           quantized_cache=quantized_cache)
    g2 = tm.generate(t(src), 10, eos_token=eos, quantized_cache=quantized_cache)
    assert b1.tolist() == g2.tolist()


@pytest.mark.parametrize("quantized_cache", [False, True])
def test_gpt_beam_search_matches_jax(quantized_cache):
    sizes = dict(vocab_size=53, d_model=32, n_heads=4, d_ff=64, n_layers=2, max_seq_len=64)
    jm = JGPT.init(JGPTConfig(**sizes), key=jax.random.PRNGKey(44))
    tm = gpt_from_jax_params(jax_params(jm), GPTConfig(**sizes), device="cpu")
    prompt = np.array([[3, 1, 4, 1, 5], [2, 7, 1, 8, 2]])
    greedy = tm.generate(t(prompt), 8, quantized_cache=quantized_cache)
    eos = int(greedy[1, 3])
    for kw in (dict(beam_size=3), dict(beam_size=4, eos_token=eos)):
        jt, js = jm.beam_search(jnp.asarray(prompt), 8, quantized_cache=quantized_cache, **kw)
        tt, ts = tm.beam_search(t(prompt), 8, quantized_cache=quantized_cache, **kw)
        assert tt.tolist() == np.asarray(jt).tolist(), kw
        assert_allclose(ts, js, rtol=1e-4, atol=5e-3 if quantized_cache else 1e-4)
    b1, _ = tm.beam_search(t(prompt), 8, beam_size=1, quantized_cache=quantized_cache)
    assert b1.tolist() == greedy.tolist()


def test_training_step_and_init():
    """The float model trains through autograd (SGD on the cross-entropy,
    20 steps cut the loss 5x); ``init_quantized`` draws what ``init`` draws;
    the default device is the GPU, which raises here."""
    from qgemm_tpu_torch.models.optim import sgd_step
    from qgemm_tpu_torch.ops.cross_entropy import cross_entropy_loss
    _, tm = pair(5)
    params = [p for p in tm.parameters() if p.requires_grad]
    src, tin, tout = torch.tensor([[3, 1, 4, 1]]), torch.tensor([[1, 7, 7]]), \
        torch.tensor([[7, 7, 2]])
    losses = []
    for _ in range(20):
        for p in params:
            p.grad = None
        loss = cross_entropy_loss(tm(src, tin).reshape(-1, SIZES["vocab_size"]),
                                  tout.reshape(-1))
        loss.backward()
        sgd_step(params, [p.grad for p in params], 0.1)
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0] * 0.2
    cfg = TransformerConfig(**SIZES)
    a = Transformer.init(cfg, seed=3, device="cpu").quantize()
    b = Transformer.init_quantized(cfg, seed=3, device="cpu")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Transformer.init(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            transformer_from_jax_params(jax_params(pair(0)[0]), cfg)
