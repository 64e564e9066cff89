"""Port parity: int8 quantization ops and kernel K1's plain path
(qgemm_tpu_torch/ops/quantize.py) against
qgemm_tpu/ops/quantize.py. The same numpy inputs go to both packages; the
JAX Pallas kernel runs in interpret mode, as the JAX tests run it.

Tolerances: int8 codes and scales are compared EXACTLY (same f32 ops,
round half to even on both sides). Matmul outputs differ only in how the
f32 epilogue associates acc * cx * cw / 127^2 (the int32 sums are exact on
both sides): rtol 1e-6 of the output plus atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgemm_tpu.ops import quantize as jq
from qgemm_tpu_torch.ops import quantize as tq
from qgemm_tpu_torch.ops.cuda.quantized_matmul import quantized_matmul_cuda
from qgemm_tpu_torch.utils.testing import assert_allclose, use_test_threads

use_test_threads()


def _x(shape, seed, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("rounding", ["nearest", "truncate"])
def test_absmax_quantize_codes_equal(axis, rounding):
    x = _x((37, 53), seed=1)
    jqv, jc = jq.absmax_quantize(jnp.asarray(x), axis=axis, rounding=rounding)
    tqv, tc = tq.absmax_quantize(torch.from_numpy(x), axis=axis, rounding=rounding)
    assert tqv.dtype == torch.int8
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_absmax_quantize_half_ties_round_to_even():
    # absmax 127 makes the scale exactly 1, so x*scale hits every .5 tie
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]], np.float32)
    jqv, _ = jq.absmax_quantize(jnp.asarray(x), axis=-1)
    tqv, _ = tq.absmax_quantize(torch.from_numpy(x), axis=-1)
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    assert tqv.numpy().tolist() == [[127, 0, 2, 2, 0, -2, -2, 126]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weights_equal(dtype):
    w = _x((64, 48), seed=2, scale=0.2)
    jw = jnp.asarray(w).astype(dtype)
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    jwq = jq.quantize_weights(jw)
    twq = tq.quantize_weights(tw)
    assert tuple(twq.qt.shape) == (48, 64) and twq.qt.is_contiguous()
    np.testing.assert_array_equal(twq.q.numpy(), np.asarray(jwq.q))
    np.testing.assert_array_equal(twq.c.numpy(), np.asarray(jwq.c))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("m,k,n", [(1, 64, 40), (7, 96, 130), (33, 128, 72)])
def test_quantized_matmul_prequant_matches_jax(backend, m, k, n):
    x, w = _x((m, k), seed=3), _x((k, n), seed=4, scale=0.1)
    jwq = jq.quantize_weights(jnp.asarray(w))
    want = np.asarray(jq.quantized_matmul_prequant(jnp.asarray(x), jwq, backend=backend))
    twq = tq.QuantizedWeight.from_kn(torch.from_numpy(np.array(jwq.q)),
                                     torch.from_numpy(np.array(jwq.c)))
    got = tq.quantized_matmul_prequant(torch.from_numpy(x), twq)
    assert got.dtype == torch.float32
    assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_plain_k1_int_products_exact_and_dynamic_path():
    """The plain K1 path sums int8 products exactly (no int8 wrap) and the
    dynamic quantized_matmul equals quantize_weights + prequant."""
    x, w = _x((5, 256), seed=5, scale=50.0), _x((256, 24), seed=6)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    wq = tq.quantize_weights(tw)
    xq, cx = tq.absmax_quantize(tx, axis=-1)
    acc = tq.int8_matmul(xq, wq.q)
    assert acc.dtype == torch.int32
    ref = xq.numpy().astype(np.int64) @ wq.q.numpy().astype(np.int64)
    np.testing.assert_array_equal(acc.numpy(), ref)
    assert_allclose(tq.quantized_matmul(tx, tw),
                    tq.quantized_matmul_plain(tx, wq), rtol=0, atol=0)
    want = np.asarray(jq.quantized_matmul(jnp.asarray(x), jnp.asarray(w), backend="xla"))
    assert_allclose(tq.quantized_matmul(tx, tw), want, rtol=1e-6, atol=1e-5)


def test_k1_wrapper_cpu_runs_plain_without_launch():
    x, w = _x((3, 32), seed=7), _x((32, 8), seed=8)
    wq = tq.quantize_weights(torch.from_numpy(w))
    before = quantized_matmul_cuda.launches
    out = tq.quantized_matmul_prequant(torch.from_numpy(x), wq)
    assert quantized_matmul_cuda.launches == before == 0
    assert_allclose(out, tq.quantized_matmul_plain(torch.from_numpy(x), wq),
                    rtol=0, atol=0)
    with pytest.raises(ValueError):
        tq.quantized_matmul_prequant(torch.from_numpy(x[:, :31]), wq)
