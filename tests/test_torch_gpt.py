"""Port parity for the GPT model (qgemm_tpu_torch/models/, utils/interop.py)
against qgemm_tpu/models/gpt.py on the CPU.

Weights cross over through the interop loader: the JAX model's leaves,
keyed by pytree path as qgemm_tpu/utils/checkpoint.py keys them, go in as
numpy arrays. Tolerances: float32 logits agree to f32 rounding (the two
sides sum in different orders): rtol/atol 2e-5. Quantized logits add the
int8 activation codes, which both sides compute with the same f32 ops but
from LayerNorm outputs that may differ in the last bit — a rare one-code
flip moves a logit by ~|x| * |w| / 127 ≈ 1e-3 at these widths: atol 2e-3.
Greedy transcripts are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgemm_tpu.models.gpt import GPT as JGPT
from qgemm_tpu.models.gpt import GPTConfig as JConfig
from qgemm_tpu.utils.checkpoint import _path_key, save_checkpoint
from qgemm_tpu_torch.models.gpt import GPT, GPTConfig
from qgemm_tpu_torch.models.linear import QuantizedLinear
from qgemm_tpu_torch.utils.interop import gpt_from_jax_params
from qgemm_tpu_torch.utils.testing import assert_allclose, use_test_threads

use_test_threads()

SIZES = dict(vocab_size=97, d_model=32, n_heads=4, d_ff=64, n_layers=2, max_seq_len=64)


def jax_params(model) -> dict:
    """The JAX model's leaves as numpy arrays, keyed by pytree path."""
    flat = jax.tree_util.tree_flatten_with_path(model)[0]
    return {_path_key(p): np.asarray(leaf) for p, leaf in flat}


def model_pair(seed: int, quantize: bool, **overrides):
    jm = JGPT.init(JConfig(**SIZES, **overrides), key=jax.random.PRNGKey(seed))
    if quantize:
        jm = jm.quantize()
    return jm, gpt_from_jax_params(jax_params(jm), GPTConfig(**SIZES, **overrides),
                                   device="cpu")


def plant_outlier_dims(jm, dims, gain: float = 20.0):
    """Set ln1/ln2 gamma to ``gain`` at feature ``dims`` in every block:
    systematic outlier features, as LLM.int8() reports for OPT-6.7B."""
    def plant(path, leaf):
        key = _path_key(path)
        if key.endswith("ln1/gamma") or key.endswith("ln2/gamma"):
            return leaf.at[jnp.asarray(dims)].set(gain)
        return leaf
    return jax.tree_util.tree_map_with_path(plant, jm)


def quantized_pair(seed: int, plant_dims=(), **qkw):
    """A JAX GPT quantized with ``qkw`` (bits, outlier options), outlier
    dims planted, and the port's GPT carried over from its leaves."""
    jm = JGPT.init(JConfig(**SIZES), key=jax.random.PRNGKey(seed)).quantize(**qkw)
    if plant_dims:
        jm = plant_outlier_dims(jm, plant_dims)
    outliers = {k: qkw[k] for k in ("outlier_threshold", "outlier_capacity") if k in qkw}
    return jm, gpt_from_jax_params(jax_params(jm), GPTConfig(**SIZES), device="cpu",
                                   **outliers)


def test_interop_weights_bit_exact():
    jm, tm = model_pair(0, quantize=True)
    jp = jax_params(jm)
    lin = tm.blocks[1].attn.wqkv_k
    assert isinstance(lin, QuantizedLinear)
    np.testing.assert_array_equal(lin.wq.q.numpy(), jp["blocks/1/attn/wqkv_k/wq/q"])
    np.testing.assert_array_equal(lin.c.numpy(), jp["blocks/1/attn/wqkv_k/wq/c"])
    np.testing.assert_array_equal(tm.blocks[0].ffn.up.b.numpy(), jp["blocks/0/ffn/up/b"])
    np.testing.assert_array_equal(tm.lm_head.wq.q.numpy(), jp["lm_head/wq/q"])
    np.testing.assert_array_equal(tm.embed.table.numpy(), jp["embed/table"])
    n_leaves = sum(1 for _ in tm.state_dict())
    assert n_leaves == len(jp)


def test_interop_checkpoint_bf16_leaves(tmp_path):
    """A bf16 model saved by the JAX checkpoint writer (uint16 bits + dtype
    tags) loads straight into the port, bit for bit."""
    jm = JGPT.init(JConfig(**SIZES, dtype="bfloat16"), key=jax.random.PRNGKey(1)).quantize()
    path = tmp_path / "gpt.npz"
    save_checkpoint(str(path), jm)
    with np.load(path) as data:
        assert "ln_f/gamma.__dtype__" in data.files
        tm = gpt_from_jax_params(data, GPTConfig(**SIZES, dtype="bfloat16"), device="cpu")
    want = np.asarray(jm.blocks[0].ffn.up.b).view(np.uint16)
    got = tm.blocks[0].ffn.up.b.view(torch.int16).numpy().view(np.uint16)
    assert tm.blocks[0].ffn.up.b.dtype == torch.bfloat16
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tm.blocks[1].ffn.down.wq.q.numpy(),
                                  np.asarray(jm.blocks[1].ffn.down.wq.q))


@pytest.mark.parametrize("quantize", [False, True])
def test_forward_logits_match_jax(quantize):
    jm, tm = model_pair(2, quantize)
    toks = np.random.default_rng(0).integers(0, 97, (2, 11))
    want = np.asarray(jm.forward(jnp.asarray(toks)))
    got = tm.forward(torch.from_numpy(toks))
    assert got.shape == (2, 11, 97)
    assert_allclose(got, want, rtol=2e-5, atol=2e-3 if quantize else 2e-5)


@pytest.mark.parametrize("quantized_cache", [False, True])
def test_prefill_matches_stepwise(quantized_cache):
    """Batched prefill == feeding the prompt token by token (port alone)."""
    _, tm = model_pair(3, quantize=True)
    prompt = torch.tensor([[11, 22, 33, 44, 5]])
    ca = tm.init_cache(1, 16, quantized=quantized_cache)
    la, ca = tm.prefill(prompt, ca)
    cb = tm.init_cache(1, 16, quantized=quantized_cache)
    for t in range(prompt.shape[1]):
        last, cb = tm.decode_step(prompt[:, t:t + 1], t, cb)
    atol = 2e-2 if quantized_cache else 1e-4   # bf16 score rounding vs f32
    assert_allclose(la[0, -1], last[0], rtol=1e-4, atol=atol)
    for xa, xb in zip(ca, cb):
        for ta, tb in zip(xa, xb):
            assert_allclose(ta[:, :, :5], tb[:, :, :5], rtol=1e-4, atol=1e-5)


def test_prefill_chunk_per_slot_offsets_match_scalar():
    """[B] per-slot offsets give each row what the scalar path gives it."""
    _, tm = model_pair(4, quantize=True)
    rng = np.random.default_rng(1)
    prompts = torch.from_numpy(rng.integers(0, 97, (2, 6)))
    caches = tm.init_cache(2, 16)
    tm.prefill(prompts, caches)
    chunk = torch.from_numpy(rng.integers(0, 97, (2, 3)))
    la, _ = tm.prefill_chunk(chunk, torch.tensor([6, 6]), caches)
    cs = tm.init_cache(2, 16)
    tm.prefill(prompts, cs)
    lb, _ = tm.prefill_chunk(chunk, 6, cs)
    assert_allclose(la, lb, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quantized_cache", [False, True])
@pytest.mark.parametrize("quantize,n_kv_heads", [(False, 0), (True, 0), (True, 2)])
def test_generate_matches_jax(quantize, n_kv_heads, quantized_cache):
    jm, tm = model_pair(5, quantize, n_kv_heads=n_kv_heads)
    prompt = np.array([[3, 1, 4, 1, 5, 9, 2]])
    want = np.asarray(jax.jit(lambda m, p: m.generate(p, 8, quantized_cache=quantized_cache))(
        jm, jnp.asarray(prompt)))
    got = tm.generate(torch.from_numpy(prompt), 8, quantized_cache=quantized_cache)
    assert got.tolist() == want.tolist()


def test_quantize_unported_options_raise():
    """Weights are int8 or int4 (both ported): any other width raises,
    before a layer is touched."""
    _, tm = model_pair(6, quantize=False)
    with pytest.raises(ValueError, match="bits=3"):
        tm.quantize(bits=3)
    with pytest.raises(ValueError, match="bits=16"):
        GPT.init_quantized(GPTConfig(**SIZES), device="cpu", bits=16)
