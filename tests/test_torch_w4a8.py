"""Port parity: int4 weights and kernel K4's plain path (W4A8,
qgemm_tpu_torch/ops/quantize.py) against qgemm_tpu/ops/quantize.py and
qgemm_tpu/ops/pallas/w4a8_matmul.py. The same numpy inputs go to both
packages; the JAX Pallas kernel runs in interpret mode, as
tests/test_w4a8.py runs it.

Tolerances: packing, codes, scales and dequantized rows are compared
EXACTLY (the same f32 operations on both sides). The W4A8 product has the
same int8 codes and int32 group sums on both sides; XLA's CPU compiler,
under the kernel's jit, contracts each multiply-add of the f32 fold into an
FMA and multiplies by 1/889 where the port divides by 889, so outputs
differ by a few f32 ulps of the partial sums: atol 1e-6 * max|ref| (the
observed worst is ~2e-7 * max|ref|). Greedy transcripts are compared
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgemm_tpu.models.linear import Linear as JLinear
from qgemm_tpu.ops import quantize as jq
from qgemm_tpu.ops.pallas import w4a8_matmul as jw
from qgemm_tpu.serving.engine import ContinuousBatchingEngine as JEngine
from qgemm_tpu.serving.engine import Request as JRequest
from qgemm_tpu.utils.checkpoint import save_checkpoint
from qgemm_tpu_torch.models.gpt import GPTConfig
from qgemm_tpu_torch.models.linear import Linear, QuantizedLinear
from qgemm_tpu_torch.ops import cuda as kernels
from qgemm_tpu_torch.ops import quantize as tq
from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
from qgemm_tpu_torch.utils.interop import gpt_from_jax_params
from qgemm_tpu_torch.utils.testing import assert_allclose, use_test_threads
from test_torch_engine import PROMPTS, N_NEW, _run
from test_torch_gpt import SIZES, quantized_pair

use_test_threads()


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _port_w4(jwq4) -> tq.QuantizedWeight4:
    return tq.QuantizedWeight4.from_kn(torch.from_numpy(np.array(jwq4.qp)),
                                       torch.from_numpy(np.array(jwq4.c)))


def _close_to_max(got, want, rel=1e-6):
    want = np.asarray(want)
    assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()))


def test_pack_unpack_int4_byte_equal():
    q = np.random.default_rng(0).integers(-7, 8, size=(3 * tq.GROUP, 40)).astype(np.int32)
    jp = np.asarray(jw.pack_int4(jnp.asarray(q)))
    tp = tq.pack_int4(torch.from_numpy(q))
    assert tp.dtype == torch.int8 and tuple(tp.shape) == (3 * tq.GROUP // 2, 40)
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(tq.unpack_int4(tp).numpy(), np.asarray(jw.unpack_int4(jp)))
    np.testing.assert_array_equal(tq.unpack_int4(tp).numpy(), q)
    with pytest.raises(ValueError):
        tq.pack_int4(torch.zeros((100, 4), dtype=torch.int32))


@pytest.mark.parametrize("k,n,dtype", [(300, 130, "float32"), (512, 96, "bfloat16")])
def test_quantize_weights_int4_matches_jax(k, n, dtype):
    """Codes and scales equal JAX's. The clip search's f32 squared-error
    sums could pick another alpha where two candidates tie to the last
    bit; any such group must be a tie within 1e-6 of its error."""
    w = _normal((k, n), seed=1, scale=k ** -0.5)
    jwq4 = jq.quantize_weights_int4(jnp.asarray(w).astype(dtype))
    twq4 = tq.quantize_weights_int4(torch.from_numpy(w).to(getattr(torch, dtype)))
    assert tuple(twq4.qpt.shape) == (n, -(-k // 128) * 64) and twq4.qpt.is_contiguous()
    jc, tc = np.asarray(jwq4.c), twq4.c.numpy()
    diff = jc != tc
    assert diff.mean() <= 0.01
    wd_j = np.asarray(jq.dequantize_weights_int4(jwq4)).reshape(-1, 128, n)
    wd_t = tq.dequantize_weights_int4(twq4).numpy().reshape(-1, 128, n)
    wp = np.pad(np.asarray(jnp.asarray(w).astype(dtype).astype(jnp.float32)),
                ((0, wd_j.shape[0] * 128 - k), (0, 0))).reshape(-1, 128, n)
    mse_j = ((wd_j - wp) ** 2).sum(axis=1)
    mse_t = ((wd_t - wp) ** 2).sum(axis=1)
    np.testing.assert_allclose(mse_t[diff], mse_j[diff], rtol=1e-6)
    same = np.repeat(~diff, 64, axis=0)
    np.testing.assert_array_equal(twq4.qp.numpy()[same], np.asarray(jwq4.qp)[same])


def test_dequantize_and_take_rows_w4_exact():
    k, n = 300, 72
    jwq4 = jq.quantize_weights_int4(jnp.asarray(_normal((k, n), seed=2)))
    twq4 = _port_w4(jwq4)
    np.testing.assert_array_equal(tq.dequantize_weights_int4(twq4, k=k).numpy(),
                                  np.asarray(jq.dequantize_weights_int4(jwq4, k=k)))
    idx = np.array([0, 63, 64, 127, 128, 200, 255, 299], np.int32)
    got = tq._take_rows_w4(twq4, torch.from_numpy(idx).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(jq._take_rows_w4(jwq4, jnp.asarray(idx))))
    np.testing.assert_array_equal(got.numpy(), tq.dequantize_weights_int4(twq4, k=k).numpy()[idx])


@pytest.mark.parametrize("m,k,n,dtype", [
    (1, 256, 128, "float32"), (33, 300, 130, "float32"),
    (8, 2048 + 256, 96, "float32"),          # two slabs, the second ragged
    (5, 4096 + 128, 40, "bfloat16")])        # three slabs, bf16 activations
def test_w4a8_plain_matches_pallas_interpret(m, k, n, dtype):
    x = _normal((m, k), seed=3, scale=2.0)
    jwq4 = jq.quantize_weights_int4(jnp.asarray(_normal((k, n), seed=4, scale=k ** -0.5)))
    want = np.asarray(jw.w4a8_matmul_pallas(jnp.asarray(x).astype(dtype), jwq4.qp, jwq4.c))
    got = tq.quantized_matmul_prequant_w4(torch.from_numpy(x).to(getattr(torch, dtype)),
                                          _port_w4(jwq4))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    _close_to_max(got, want)


def test_w4a8_per_slab_scales_and_row_independence():
    """Each 2048-wide K slab takes its own activation scale (a slab of
    large values does not coarsen another's grid), and a row's result does
    not depend on the rows beside it."""
    k, n = 4096, 24
    jwq4 = jq.quantize_weights_int4(jnp.asarray(_normal((k, n), seed=5, scale=0.02)))
    twq4 = _port_w4(jwq4)
    x = _normal((6, k), seed=6)
    x[:, 2048:] *= 100.0
    got = tq.quantized_matmul_prequant_w4(torch.from_numpy(x), twq4)
    first = tq.quantized_matmul_prequant_w4(torch.from_numpy(np.ascontiguousarray(x[:, :2048])),
                                            tq.QuantizedWeight4(twq4.qpt[:, :1024].contiguous(),
                                                                twq4.c[:16]))
    second = tq.quantized_matmul_prequant_w4(torch.from_numpy(np.ascontiguousarray(x[:, 2048:])),
                                             tq.QuantizedWeight4(twq4.qpt[:, 1024:].contiguous(),
                                                                 twq4.c[16:]))
    assert_allclose(got, first + second, rtol=0, atol=0)
    for r in range(6):
        alone = tq.quantized_matmul_prequant_w4(torch.from_numpy(x[r:r + 1]), twq4)
        assert torch.equal(alone[0], got[r])


def test_w4a8_wrapper_cpu_runs_plain_without_launch_and_checks():
    kernels.reset_launch_counts()
    x = torch.from_numpy(_normal((3, 200), seed=7))
    twq4 = tq.quantize_weights_int4(torch.from_numpy(_normal((200, 16), seed=8)))
    out = tq.quantized_matmul_prequant_w4(x, twq4)
    assert torch.equal(out, tq.w4a8_matmul_plain(x, twq4))
    assert kernels.launch_counts()["w4a8_matmul"] == 0
    with pytest.raises(ValueError):               # k=100 packs to 128 rows, not 256
        tq.quantized_matmul_prequant_w4(x[:, :100], twq4)
    with pytest.raises(ValueError):
        tq.quantized_matmul_prequant_w4(x, tq.QuantizedWeight4(twq4.qpt.to(torch.int32), twq4.c))
    with pytest.raises(ValueError):
        tq.quantized_matmul_prequant_w4(x, tq.QuantizedWeight4(twq4.qpt, twq4.c[:1]))


def test_quantized_linear_bits4_matches_jax():
    jlin = JLinear.init(jax.random.PRNGKey(0), 200, 72).quantize(bits=4)
    lin = QuantizedLinear(_port_w4(jlin.wq), torch.from_numpy(np.array(jlin.b)))
    assert lin.bits == 4 and lin.out_features == 72
    x = _normal((2, 5, 200), seed=9)
    _close_to_max(lin(torch.from_numpy(x)), jlin(jnp.asarray(x)))
    # and the port's own quantize(bits=4) builds the same layer from float weights
    flin = JLinear.init(jax.random.PRNGKey(0), 200, 72)
    own = Linear(torch.from_numpy(np.array(flin.w)), torch.from_numpy(np.array(flin.b))) \
        .quantize(bits=4)
    np.testing.assert_array_equal(own.qpt.numpy(), lin.qpt.numpy())
    np.testing.assert_array_equal(own.c.numpy(), lin.c.numpy())


def test_gpt_bits4_logits_and_generate_match_jax():
    quantized_cache = True
    jm, tm = quantized_pair(12, bits=4)
    assert isinstance(tm.lm_head, QuantizedLinear) and tm.lm_head.bits == 4
    toks = np.random.default_rng(2).integers(0, 97, (2, 9))
    _close_to_max(tm.forward(torch.from_numpy(toks)), jm.forward(jnp.asarray(toks)), rel=2e-6)
    prompt = np.array([[3, 1, 4, 1, 5, 9, 2]])
    want = np.asarray(jax.jit(lambda m, p: m.generate(p, 8, quantized_cache=quantized_cache))(
        jm, jnp.asarray(prompt)))
    got = tm.generate(torch.from_numpy(prompt), 8, quantized_cache=quantized_cache)
    assert got.tolist() == want.tolist()


def test_engine_bits4_matches_jax_engine():
    """Against the JAX engine with the float cache. With the int8 cache
    the JAX engine's jitted decode step can differ from the same step run
    op by op (XLA's CPU compiler contracts multiply-adds into FMAs, which
    can flip an int8 K/V code of the new row); the port follows the
    op-by-op result, so there the port's engine is held to its own
    isolated generation, which W4A8's independent rows (per-row, per-slab
    activation scales) make exact."""
    jm, tm = quantized_pair(13, bits=4)
    want, _ = _run(JEngine, JRequest, jm, scheduler="python", quantized_cache=False)
    got, _ = _run(ContinuousBatchingEngine, Request, tm, device="cpu", quantized_cache=False)
    assert got == want
    got, _ = _run(ContinuousBatchingEngine, Request, tm, device="cpu", quantized_cache=True)
    for p, n, g in zip(PROMPTS, N_NEW, got):
        assert tm.generate(torch.tensor([p]), n, quantized_cache=True)[0].tolist() == g


def test_interop_checkpoint_int4_outlier_leaves(tmp_path):
    """An int4, outlier-mode bf16 GPT saved by the JAX checkpoint writer
    loads into the port bit for bit; the outlier options, which the
    checkpoint does not hold, come in as arguments."""
    from qgemm_tpu.models.gpt import GPT as JGPT
    from qgemm_tpu.models.gpt import GPTConfig as JConfig
    jm = JGPT.init(JConfig(**SIZES, dtype="bfloat16"), key=jax.random.PRNGKey(14)) \
        .quantize(bits=4, outlier_threshold=6.0, outlier_capacity=4)
    path = tmp_path / "gpt_w4.npz"
    save_checkpoint(str(path), jm)
    with np.load(path) as data:
        assert "lm_head/wq/qp" in data.files and "lm_head/wq/q" not in data.files
        tm = gpt_from_jax_params(data, GPTConfig(**SIZES, dtype="bfloat16"), device="cpu",
                                 outlier_threshold=6.0, outlier_capacity=4)
    for jl, tl in ((jm.blocks[1].ffn.down, tm.blocks[1].ffn.down), (jm.lm_head, tm.lm_head)):
        assert tl.bits == 4 and tl.outlier_threshold == 6.0 and tl.outlier_capacity == 4
        np.testing.assert_array_equal(tl.wq.qp.numpy(), np.asarray(jl.wq.qp))
        np.testing.assert_array_equal(tl.c.numpy(), np.asarray(jl.wq.c))
    assert tm.blocks[0].ffn.up.b.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tm.blocks[0].ffn.up.b.view(torch.int16).numpy().view(np.uint16),
        np.asarray(jm.blocks[0].ffn.up.b).view(np.uint16))
