"""Port parity for the MoE GPT family (``GPTConfig(n_experts > 0)``:
qgemm_tpu_torch/models/gpt.py with models/moe.py blocks, utils/interop.py,
utils/checkpoint.py, serving/engine.py) against the JAX package on the CPU,
with the same weights in both (carried over by the interop loader).

Routing makes the tokens of one call compete for expert capacity, so these
tests hold the port to the JAX package's token order, padding and batching:
the engine's prompt buckets (over 8 here) and decode steps over every slot.

Tolerances: float32 logits to rtol/atol 2e-5 (sums in other orders);
int8 logits to atol 2e-3 (test_torch_gpt.py's reasoning: a rare flipped
activation code; the expert FFN also dequantizes in the TPU kernel's order
where JAX's model path uses its einsum's, a few f32 ulps); greedy
transcripts exactly. Training: JAX's ``value_and_grad`` loss to rtol 1e-5
and each leaf's gradient to rtol 1e-4 with atol 1e-5 * max|g| (f32 sums in
other orders, and the combine's FMA).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgemm_tpu.models.gpt import GPT as JGPT
from qgemm_tpu.models.gpt import GPTConfig as JConfig
from qgemm_tpu.ops.cross_entropy import cross_entropy_loss as j_ce
from qgemm_tpu.serving.engine import ContinuousBatchingEngine as JEngine
from qgemm_tpu.serving.engine import Request as JRequest
from qgemm_tpu.utils.checkpoint import load_checkpoint as j_load
from qgemm_tpu_torch.examples.train_gpt_lm import loss_fn, train_step
from qgemm_tpu_torch.models.gpt import GPT, GPTConfig
from qgemm_tpu_torch.models.linear import QuantizedLinear
from qgemm_tpu_torch.models.moe import MoEFeedForward
from qgemm_tpu_torch.models.optim import Adam
from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
from qgemm_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from qgemm_tpu_torch.utils.interop import gpt_from_jax_params, gpt_to_numpy_params
from qgemm_tpu_torch.utils.testing import assert_allclose, use_test_threads
from test_torch_gpt import jax_params

use_test_threads()

SIZES = dict(vocab_size=64, d_model=32, n_heads=4, d_ff=64, n_layers=2, max_seq_len=64,
             n_experts=4, moe_top_k=2)


def moe_pair(seed: int, quantize: bool, **overrides):
    sizes = {**SIZES, **overrides}
    jm = JGPT.init(JConfig(**sizes), key=jax.random.PRNGKey(seed))
    if quantize:
        jm = jm.quantize()
    return jm, gpt_from_jax_params(jax_params(jm), GPTConfig(**sizes), device="cpu")


@pytest.mark.parametrize("quantize", [False, True])
def test_moe_interop_leaves_both_ways(quantize):
    """Every JAX leaf lands in the port bit for bit and comes back out under
    the same key, in the same order; the expert codes are stored K-major."""
    jm, tm = moe_pair(0, quantize)
    jp = jax_params(jm)
    assert all(isinstance(b.ffn, MoEFeedForward) for b in tm.blocks)
    assert sum(1 for _ in tm.state_dict()) == len(jp)
    assert tm.num_params() == jm.num_params()
    back = gpt_to_numpy_params(tm)
    assert list(back) == list(jp)
    for key, ref in jp.items():
        np.testing.assert_array_equal(back[key], ref, err_msg=key)
    ffn = tm.blocks[1].ffn
    assert ffn.router_w.dtype == torch.float32
    if quantize:
        assert ffn.w_up_qt.shape == (4, 64, 32) and ffn.w_up_qt.is_contiguous()
        assert "blocks/1/ffn/w_down/q" in jp and "blocks/1/ffn/w_down/c" in jp
    else:
        assert [k for k, _ in tm.named_trainable()] == list(jp)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_forward_logits_match_jax(quantize, top_k):
    jm, tm = moe_pair(2 + top_k, quantize, moe_top_k=top_k)
    toks = np.random.default_rng(0).integers(0, 64, (2, 11))
    want = np.asarray(jax.jit(lambda m, t: m.forward(t))(jm, jnp.asarray(toks)))
    got = tm.forward(torch.from_numpy(toks))
    assert got.shape == (2, 11, 64)
    assert_allclose(got, want, rtol=2e-5, atol=2e-3 if quantize else 2e-5)


@pytest.mark.parametrize("quantized_cache", [False, True])
@pytest.mark.parametrize("quantize", [False, True])
def test_moe_generate_matches_jax(quantize, quantized_cache):
    jm, tm = moe_pair(5, quantize)
    prompt = np.array([[3, 1, 4, 1, 5, 9, 2, 6, 5, 3]])
    want = np.asarray(jax.jit(lambda m, p: m.generate(p, 8, quantized_cache=quantized_cache))(
        jm, jnp.asarray(prompt)))
    got = tm.generate(torch.from_numpy(prompt), 8, quantized_cache=quantized_cache)
    assert got.tolist() == want.tolist()


def _prompts(seed):
    """Five prompts of 9-21 tokens (buckets of 16 and 32 over 8 tokens),
    five lengths of new tokens."""
    rng = np.random.default_rng(seed)
    return ([rng.integers(0, 64, int(n)).tolist() for n in (9, 14, 21, 11, 17)],
            [5, 7, 4, 6, 3])


def _serve(engine_cls, req_cls, model, prompts, news, **kw):
    eng = engine_cls(model, max_slots=2, max_seq_len=64, **kw)
    reqs = [req_cls(prompt=p, max_new_tokens=n) for p, n in zip(prompts, news)]
    for r in reqs[:3]:
        eng.submit(r)
    eng.step()
    for r in reqs[3:]:
        eng.submit(r)
    eng.run_to_completion(max_steps=400)
    assert all(r.done and r.error is None for r in reqs), [r.error for r in reqs]
    return [list(r.generated) for r in reqs]


@pytest.mark.parametrize("paged", [False, True])
def test_moe_engine_transcripts_match_jax_engine(paged):
    """The int8 MoE GPT through both engines on the float cache (the int8
    cache's jitted-vs-op-by-op flips are ROADMAP's note), two slots,
    staggered arrivals: dense, and paged with pages of 8."""
    jm, tm = moe_pair(7, quantize=True)
    prompts, news = _prompts(1)
    kw = dict(paged=True, page_size=8) if paged else {}
    want = _serve(JEngine, JRequest, jm, prompts, news, scheduler="python", **kw)
    got = _serve(ContinuousBatchingEngine, Request, tm, prompts, news, device="cpu", **kw)
    assert got == want


@pytest.mark.parametrize("quantize", [False, True])
def test_moe_checkpoint_loads_in_jax(quantize, tmp_path):
    """A port MoE model saved by the port loads through JAX's
    ``load_checkpoint`` and gives JAX's logits; it loads back into the port
    unchanged."""
    jm, tm = moe_pair(9, quantize)
    path = str(tmp_path / "moe.npz")
    save_checkpoint(path, tm)
    template = JGPT.init(JConfig(**SIZES), key=jax.random.PRNGKey(99))
    if quantize:
        template = template.quantize()
    restored = j_load(path, template)
    toks = jnp.asarray(np.random.default_rng(2).integers(0, 64, (1, 9)))
    forward = jax.jit(lambda m, t: m.forward(t))
    want = np.asarray(forward(restored, toks))
    np.testing.assert_array_equal(want, np.asarray(forward(jm, toks)))
    got = tm.forward(torch.from_numpy(np.asarray(toks)))
    assert_allclose(got, want, rtol=2e-5, atol=2e-3 if quantize else 2e-5)
    back = load_checkpoint(path, tm)
    for (ka, a), (kb, b) in zip(tm.state_dict().items(), back.state_dict().items()):
        assert ka == kb and torch.equal(a, b), ka


TRAIN = dict(vocab_size=67, d_model=32, n_heads=4, d_ff=64, n_layers=1, max_seq_len=32,
             n_experts=4)


def test_moe_training_loss_and_grads_match_jax():
    """``test_moe_gpt_trains``'s setup: gradients flow through the combine
    gates into ``router_w`` and through the experts; loss and every leaf's
    gradient equal JAX's ``value_and_grad``."""
    jm = JGPT.init(JConfig(**TRAIN), key=jax.random.PRNGKey(16))
    seqs = np.random.default_rng(17).integers(0, 67, (2, 9)).astype(np.int32)

    def j_loss(m):
        lg = m(jnp.asarray(seqs[:, :-1]))
        return j_ce(lg.reshape(-1, 67), jnp.asarray(seqs[:, 1:]).reshape(-1))

    jl, jg = jax.jit(jax.value_and_grad(j_loss))(jm)
    want = jax_params(jg)
    model = gpt_from_jax_params(jax_params(jm), GPTConfig(**TRAIN), device="cpu")
    named = model.named_trainable()
    assert [k for k, _ in named] == list(want)
    loss = loss_fn(model, torch.from_numpy(seqs.astype(np.int64)))
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    for key, p in named:
        ref = want[key]
        assert_allclose(p.grad, ref, rtol=1e-4, atol=1e-5 * float(np.abs(ref).max()),
                        msg=key)
    assert float(model.blocks[0].ffn.router_w.grad.abs().max()) > 0


def test_moe_adam_step_lowers_the_loss():
    model = GPT.init(GPTConfig(**TRAIN), seed=3, device="cpu")
    params = [p for _, p in model.named_trainable()]
    opt = Adam(lr=3e-3)
    state = opt.init(params)
    seqs = torch.from_numpy(np.random.default_rng(4).integers(0, 67, (4, 17)))
    losses = []
    for _ in range(4):
        state, loss = train_step(model, params, opt, state, seqs)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    assert all(p.grad is not None for p in params)


def test_moe_init_quantized_and_options():
    """``init_quantized`` and ``quantize`` build int8 experts whatever
    ``bits`` and outlier options the attention projections and ``lm_head``
    take (as JAX does); the quantized model generates on the CPU."""
    cfg = GPTConfig(**SIZES)
    for qkw in ({}, {"bits": 4}, {"outlier_threshold": 6.0}):
        for model in (GPT.init_quantized(cfg, seed=1, device="cpu", **qkw),
                      GPT.init(cfg, seed=1, device="cpu").quantize(**qkw)):
            ffn = model.blocks[0].ffn
            assert isinstance(ffn, MoEFeedForward) and ffn.is_quantized
            assert ffn.w_up_qt.dtype == torch.int8
            head = model.lm_head
            assert isinstance(head, QuantizedLinear)
            assert head.bits == qkw.get("bits", 8)
            assert head.outlier_threshold == qkw.get("outlier_threshold", 0.0)
            assert model.generate(torch.tensor([[1, 2, 3]]), 3).shape == (1, 3)
    a = GPT.init_quantized(cfg, seed=1, device="cpu")
    b = GPT.init(cfg, seed=1, device="cpu").quantize()
    for (ka, ta), (kb, tb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(ta, tb), ka


def test_moe_engine_differs_from_generate_as_jax_does():
    """Capacity follows a call's token count, bucket padding included, so
    a request served by the engine (prompt padded to its bucket) can get
    other transcripts than isolated ``generate`` (exact length). The port
    shows it for the same requests as the JAX package, and only those."""
    jm, tm = moe_pair(7, quantize=True, n_experts=8, max_seq_len=128)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 64, n).tolist() for n in (37, 45) * 4]   # bucket 64

    def same_as_generate(engine_cls, req_cls, model, generate, **kw):
        eng = engine_cls(model, max_slots=8, **kw)
        reqs = [req_cls(prompt=p, max_new_tokens=8) for p in prompts]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        return [list(r.generated) == generate(r.prompt) for r in reqs]

    jgen = jax.jit(lambda m, p: m.generate(p, 8))
    want = same_as_generate(JEngine, JRequest, jm,
                            lambda p: np.asarray(jgen(jm, jnp.asarray([p])))[0].tolist(),
                            scheduler="python")
    got = same_as_generate(ContinuousBatchingEngine, Request, tm,
                           lambda p: tm.generate(torch.tensor([p]), 8)[0].tolist(),
                           device="cpu")
    assert got == want
    assert not all(got)
