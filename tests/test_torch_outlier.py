"""Port parity: the LLM.int8() outlier split (qgemm_tpu_torch/ops/quantize.py
``quantized_matmul_prequant_outlier``, ``quantized_matmul_outlier``;
``QuantizedLinear(outlier_threshold > 0)``) against qgemm_tpu on the CPU,
with int8 and int4 weights and on planted-outlier data, as
tests/test_outlier_serving.py and tests/test_w4a8.py build it.

Tolerances: the selected dims, the zeroed inlier input and the quantized
product are the same on both sides (the quantized product as in
test_torch_quantize.py / test_torch_w4a8.py). The outlier product sums at
most ``capacity`` f32 terms in whatever order each package's top-k lists
the dims (ties may come out in another order), a few ulps of its largest
term: atol 1e-6 * max|ref|. Greedy transcripts are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgemm_tpu.models.linear import Linear as JLinear
from qgemm_tpu.ops import quantize as jq
from qgemm_tpu.serving.engine import ContinuousBatchingEngine as JEngine
from qgemm_tpu.serving.engine import Request as JRequest
from qgemm_tpu_torch.models.linear import QuantizedLinear
from qgemm_tpu_torch.ops import quantize as tq
from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
from qgemm_tpu_torch.utils.testing import assert_allclose, use_test_threads
from test_torch_engine import _run
from test_torch_gpt import quantized_pair

use_test_threads()

PLANTED = (3, 17, 29)   # systematic outlier feature dims of the small GPT (d_model 32)
OUTLIERS = dict(outlier_threshold=6.0, outlier_capacity=4)


def _outlier_data(m=32, k=256, n=64, mag=60.0, seed=0):
    """Activations with three planted outlier columns, weights ~ N(0, 1/k)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[:, [5, 40, 200]] *= mag
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    return x, w


def _close_to_max(got, want, rel=1e-6):
    want = np.asarray(want)
    assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()))


def _port_wq(jwq):
    if isinstance(jwq, jq.QuantizedWeight4):
        return tq.QuantizedWeight4.from_kn(torch.from_numpy(np.array(jwq.qp)),
                                           torch.from_numpy(np.array(jwq.c)))
    return tq.QuantizedWeight.from_kn(torch.from_numpy(np.array(jwq.q)),
                                      torch.from_numpy(np.array(jwq.c)))


@pytest.mark.parametrize("bits,backend", [(8, "xla"), (8, "pallas"), (4, None)])
def test_prequant_outlier_matches_jax(bits, backend):
    x, w = _outlier_data(m=33, k=300, n=72)
    jwq = jq.quantize_weights_int4(jnp.asarray(w)) if bits == 4 else jq.quantize_weights(jnp.asarray(w))
    kw = {} if backend is None else {"backend": backend}
    want = jq.quantized_matmul_prequant_outlier(jnp.asarray(x), jwq, threshold=6.0, capacity=8, **kw)
    got = tq.quantized_matmul_prequant_outlier(torch.from_numpy(x), _port_wq(jwq),
                                               threshold=6.0, capacity=8)
    assert got.dtype == torch.float32
    _close_to_max(got, want)


def test_dynamic_outlier_matches_jax():
    x, w = _outlier_data(m=16, k=512, n=40, seed=1)
    want = jq.quantized_matmul_outlier(jnp.asarray(x), jnp.asarray(w), threshold=6.0,
                                       backend="xla")
    got = tq.quantized_matmul_outlier(torch.from_numpy(x), torch.from_numpy(w), threshold=6.0)
    _close_to_max(got, want)


@pytest.mark.parametrize("bits", [8, 4])
def test_outlier_split_beats_plain_quantization(bits):
    """Decomposed error against the exact product is under half of the
    plain quantized product's, for int8 and int4 weights (the port alone,
    as chip_smoke.py checks it on the card)."""
    x, w = _outlier_data(seed=2)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    if bits == 4:
        wq = tq.quantize_weights_int4(tw)
        exact = tx @ tq.dequantize_weights_int4(wq, k=w.shape[0])
        plain = tq.quantized_matmul_prequant_w4(tx, wq)
    else:
        wq = tq.quantize_weights(tw)
        exact = tx @ tw
        plain = tq.quantized_matmul_prequant(tx, wq)
    dec = tq.quantized_matmul_prequant_outlier(tx, wq, threshold=6.0, capacity=8)
    err = lambda y: float((y - exact).norm() / exact.norm())
    assert err(dec) < err(plain) / 2, (err(dec), err(plain))


def test_outlier_selection_threshold_and_capacity():
    """No dim above the threshold: exactly the plain product. More dims
    above it than the capacity: the largest ``capacity`` are split out.
    A capacity above k is clamped to k."""
    x, w = _outlier_data(m=8, k=256, n=16, seed=3)
    tx, wq = torch.from_numpy(x), tq.quantize_weights(torch.from_numpy(w))
    calm = tx / 100.0
    assert torch.equal(tq.quantized_matmul_prequant_outlier(calm, wq, threshold=6.0, capacity=8),
                       tq.quantized_matmul_prequant(calm, wq))
    x_in, x_o, idx = tq._outlier_split(tx, 6.0, 2)
    assert sorted(idx.tolist()) == sorted(np.argsort(-np.abs(x).max(axis=0))[:2].tolist())
    kept = sorted({5, 40, 200} - set(idx.tolist()))
    assert len(kept) == 1 and torch.equal(x_in[:, kept], tx[:, kept])
    assert float(x_in[:, idx].abs().max()) == 0.0
    assert torch.equal(x_o, tx[:, idx])
    _, x_o, idx = tq._outlier_split(tx[:, :4], 6.0, 32)
    assert tuple(idx.shape) == (4,) and float(x_o.abs().max()) == 0.0


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_linear_outlier_mode_matches_jax(bits):
    jlin = JLinear.init(jax.random.PRNGKey(0), 256, 64).quantize(
        bits=bits, outlier_threshold=6.0, outlier_capacity=8)
    lin = QuantizedLinear(_port_wq(jlin.wq), torch.from_numpy(np.array(jlin.b)),
                          outlier_threshold=6.0, outlier_capacity=8)
    x, _ = _outlier_data(m=12, k=256, n=64, seed=4)
    x3 = x.reshape(3, 4, 256)
    _close_to_max(lin(torch.from_numpy(x3)), jlin(jnp.asarray(x3)))


@pytest.mark.parametrize("bits", [8, 4])
def test_gpt_outlier_logits_and_generate_match_jax(bits):
    """Planted outlier dims (ln1/ln2 gamma 20 at three dims) make every
    layer split out outlier columns; logits and greedy transcripts follow
    the JAX model's."""
    jm, tm = quantized_pair(15, PLANTED, bits=bits, **OUTLIERS)
    assert tm.blocks[0].ffn.up.outlier_threshold == 6.0 and tm.lm_head.outlier_capacity == 4
    assert float(tm.blocks[1].ln2.gamma[PLANTED[0]]) == 20.0
    toks = np.random.default_rng(3).integers(0, 97, (2, 9))
    _close_to_max(tm.forward(torch.from_numpy(toks)), jm.forward(jnp.asarray(toks)), rel=2e-6)
    prompt = np.array([[3, 1, 4, 1, 5, 9, 2]])
    want = np.asarray(jax.jit(lambda m, p: m.generate(p, 8, quantized_cache=True))(
        jm, jnp.asarray(prompt)))
    got = tm.generate(torch.from_numpy(prompt), 8, quantized_cache=True)
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("bits", [8, 4])
def test_engine_outlier_matches_jax_engine(bits):
    """Outlier selection runs over every row of a call (bucket padding,
    inactive slots), so the JAX engine is the reference here, not
    isolated generation. The float cache: with the int8 cache the JAX
    engine's jitted decode step can differ from the same step run op by op
    (XLA's CPU compiler contracts multiply-adds into FMAs, which can flip
    an int8 K/V code of the new row, and the planted outliers make a code
    large), and the port follows the op-by-op result."""
    jm, tm = quantized_pair(16, PLANTED, bits=bits, **OUTLIERS)
    want, _ = _run(JEngine, JRequest, jm, scheduler="python", quantized_cache=False)
    got, _ = _run(ContinuousBatchingEngine, Request, tm, device="cpu", quantized_cache=False)
    assert got == want
