"""Port parity for the MoE layer (qgemm_tpu_torch/models/moe.py) and the
plain versions of its kernels K8 (ops/cuda/expert_matmul.py) and K9
(ops/cuda/col_quantize.py) against qgemm_tpu/models/moe.py and the Pallas
kernels they replace (qgemm_tpu/ops/pallas/expert_matmul.py, row 15;
quantized_matmul.py's col_quantize_pallas, row 4), run in interpret mode on
the CPU as the JAX package's own tests run them. Inputs come from numpy.

Tolerances and their reasons:
- routing: dispatch is compared exactly; the gates come from softmax,
  whose exp may differ in the last bit between XLA and torch: rtol 1e-6;
- K9's plain version and ``quantize_expert_weights``: bit-equal (the same
  f32 ops); K8's plain version: bit-equal to the Pallas kernel (the same
  codes, exact int32 sums and the same epilogue order);
- against JAX's model path ``quantized_expert_ffn``, whose einsum
  dequantizes as acc * (cx * cw) / 127^2 (K8: (acc * (cx / 127^2)) * cw):
  the two orders round differently, a few f32 ulps (the JAX package's
  own parity note for the two: 2e-7 relative); no code of the hidden
  activation's row quantization flips at these inputs (a flip would move
  an output by about max|h| * max|w| / 127): 1e-5 * max|ref|;
- the layer's float forward: f32 sums in other orders, atol 1e-5; int8:
  the expert FFN's tolerance above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgemm_tpu.models import moe as jmoe
from qgemm_tpu.ops.pallas.expert_matmul import (grouped_quantized_matmul_pallas,
                                                quantized_expert_ffn_pallas)
from qgemm_tpu.ops.pallas.quantized_matmul import col_quantize_pallas
from qgemm_tpu_torch.models import moe
from qgemm_tpu_torch.ops.cuda.col_quantize import col_quantize, col_quantize_plain
from qgemm_tpu_torch.ops.cuda.expert_matmul import (grouped_quantized_matmul,
                                                    grouped_quantized_matmul_plain)
from qgemm_tpu_torch.utils.testing import assert_allclose, use_test_threads

use_test_threads()


def _t(a):
    return torch.from_numpy(np.array(a))


def _jmoe(seed, d, f, e, top_k, cf, quantize=False):
    m = jmoe.MoEFeedForward.init(jax.random.PRNGKey(seed), d, f, n_experts=e, top_k=top_k,
                                 capacity_factor=cf)
    return m.quantize() if quantize else m


def _port(jm):
    if jm.is_quantized:
        up, down = (moe.QuantizedExpertWeight.from_kn(_t(w.q), _t(w.c))
                    for w in (jm.w_up, jm.w_down))
    else:
        up, down = _t(jm.w_up), _t(jm.w_down)
    return moe.MoEFeedForward(_t(jm.router_w), up, down, top_k=jm.top_k,
                              capacity_factor=jm.capacity_factor)


def test_capacity_matches_jax():
    for t in (1, 2, 7, 8, 9, 16, 33, 100, 256, 512, 1000, 1024):
        for e, k, cf in ((8, 2, 1.25), (4, 1, 1.25), (4, 2, 8.0), (1, 1, 0.01), (16, 2, 2.0)):
            got = moe._capacity(t, e, k, cf)
            assert got == jmoe._capacity(t, e, k, cf)
            assert got % 8 == 0 and got >= 8
    assert moe._capacity(8, 8, 2, 1.25) == 8       # a decode step of 8 slots
    assert moe._capacity(512, 8, 2, 1.25) == 168   # a 512-token prefill bucket


# (T, d, E, top_k, capacity): capacity generous; capacity binding (k-major);
# one expert at the floor capacity (test_capacity_drops_overflow_tokens)
ROUTES = [(24, 16, 4, 2, 16), (64, 16, 4, 2, 16), (64, 8, 1, 1, 8), (40, 16, 8, 1, 8)]


@pytest.mark.parametrize("t,d,e,top_k,cap", ROUTES)
def test_route_matches_jax(t, d, e, top_k, cap):
    rng = np.random.default_rng(t + e)
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = (rng.standard_normal((d, e)) * 0.5).astype(np.float32)
    jd, jc = jmoe.route(jnp.asarray(x), jnp.asarray(w), top_k, cap)
    dispatch, combine = moe.route(_t(x), _t(w), top_k, cap)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(jd))
    assert_allclose(combine, jc, rtol=1e-6, atol=1e-7)
    slot, gates = moe.route_slots(_t(x), _t(w), top_k, cap)
    kept = slot < e * cap
    assert int(kept.sum()) == int(np.asarray(jd).sum())
    if t * top_k > e * cap:                          # capacity binds
        first, second = kept[:t], kept[t:]
        assert not bool(first.all() and second.all())
        if top_k == 2:
            # k-major: an expert's first choices all keep their places
            # before any of its second choices is placed
            experts = torch.div(slot, cap, rounding_mode="floor")
            probs = torch.softmax(_t(x) @ _t(w), -1)
            top1 = probs.argmax(-1)
            for ex in range(e):
                n1 = int((top1 == ex).sum())
                n2_kept = int(((experts[t:] == ex) & second).sum())
                assert n2_kept == 0 or n1 <= cap
                assert int(((experts[:t] == ex) & first).sum()) == min(n1, cap)


def test_capacity_drops_overflow_tokens_like_jax():
    """One expert, capacity 8, 64 tokens: the first 8 get expert output, the
    rest zeros, and the layer equals JAX's."""
    jm = _jmoe(4, 8, 16, 1, 1, 0.01)
    x = np.random.default_rng(5).standard_normal((1, 64, 8)).astype(np.float32)
    out = _port(jm)(_t(x)).detach()
    assert float(out[0, :8].abs().max()) > 0 and float(out[0, 8:].abs().max()) == 0
    assert_allclose(out, jm(jnp.asarray(x)), rtol=1e-6, atol=1e-6)


def test_load_balancing_loss_and_grad_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((256, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 4)) * 0.1).astype(np.float32)
    want, jg = jax.value_and_grad(lambda w: jmoe.load_balancing_loss(jnp.asarray(x), w))(
        jnp.asarray(w))
    wt = _t(w).requires_grad_()
    got = moe.load_balancing_loss(_t(x), wt)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-6
    assert_allclose(wt.grad, jg, rtol=1e-6, atol=1e-6)
    collapsed = np.zeros((16, 4), np.float32)
    collapsed[0, 0] = 10.0
    xc = x.copy()
    xc[:, 0] = 5.0
    assert float(moe.load_balancing_loss(_t(xc), _t(collapsed))) > 3.5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_expert_weights_bit_equal_to_jax(dtype):
    w = np.random.default_rng(2).uniform(-1, 1, (3, 40, 24)).astype(np.float32)
    w[1, :, 5] = 0.0                                   # an all-zero column
    jw = jnp.asarray(w).astype(dtype)
    want = jmoe.quantize_expert_weights(jw)
    got = moe.quantize_expert_weights(_t(w).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.c.numpy(), np.asarray(want.c))
    assert got.qt.is_contiguous() and got.qt.shape == (3, 24, 40)


@pytest.mark.parametrize("rounding", ["nearest", "truncate"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n", [(64, 128), (37, 19), (130, 70)])
def test_col_quantize_plain_bit_equal_to_pallas(rounding, dtype, k, n):
    w = (np.random.default_rng(k * n).standard_normal((k, n)) * 0.05).astype(np.float32)
    jw = jnp.asarray(w).astype(dtype)
    wq, cw = col_quantize_pallas(jw, rounding=rounding)
    tw = _t(w).to(getattr(torch, dtype))
    qt, c = col_quantize_plain(tw, rounding)
    np.testing.assert_array_equal(qt.t().numpy(), np.asarray(wq))
    np.testing.assert_array_equal(c.numpy(), np.asarray(cw))
    # the wrapper takes the plain path for a CPU tensor; [E, k, n] per expert
    q3, c3 = col_quantize(torch.stack([tw, -tw]), rounding)
    assert torch.equal(q3[0], qt) and torch.equal(c3[1], c)


def _expert_case(seed, e, c, k, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, c, k)).astype(np.float32)
    x[:, c // 2:] = 0.0                                 # empty capacity rows
    w = jmoe.quantize_expert_weights(jnp.asarray(rng.uniform(-1, 1, (e, k, n)),
                                                 jnp.float32))
    return x, w


@pytest.mark.parametrize("c", [3, 8, 21])
def test_grouped_matmul_plain_bit_equal_to_pallas(c):
    x, w = _expert_case(c, 4, c, 64, 96)
    want = np.asarray(grouped_quantized_matmul_pallas(jnp.asarray(x), w.q, w.c))
    wt = _t(w.q).transpose(1, 2).contiguous()
    got = grouped_quantized_matmul(_t(x), wt, _t(w.c))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not bool(got[:, c // 2:].any())             # empty rows: exactly 0
    plain_bf16 = grouped_quantized_matmul_plain(_t(x).to(torch.bfloat16), wt, _t(w.c),
                                                relu=True)
    want_bf16 = np.asarray(grouped_quantized_matmul_pallas(
        jnp.asarray(x).astype(jnp.bfloat16), w.q, w.c))
    np.testing.assert_array_equal(plain_bf16.numpy(), np.maximum(want_bf16, 0.0))


@pytest.mark.parametrize("e,c,d,f", [(4, 8, 64, 128), (3, 5, 48, 96), (2, 24, 32, 64)])
def test_quantized_expert_ffn_matches_jax(e, c, d, f):
    rng = np.random.default_rng(e * c)
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    wu = jmoe.quantize_expert_weights(jnp.asarray(rng.uniform(-1, 1, (e, d, f)), jnp.float32))
    wd = jmoe.quantize_expert_weights(jnp.asarray(rng.uniform(-1, 1, (e, f, d)), jnp.float32))
    pu, pd = (moe.QuantizedExpertWeight.from_kn(_t(w.q), _t(w.c)) for w in (wu, wd))
    got = moe.quantized_expert_ffn(_t(x), pu, pd)
    kernel = np.asarray(quantized_expert_ffn_pallas(jnp.asarray(x), wu, wd))
    np.testing.assert_array_equal(got.numpy(), kernel)       # row 15's order
    model_path = np.asarray(jax.jit(jmoe.quantized_expert_ffn)(jnp.asarray(x), wu, wd))
    assert_allclose(got, model_path, rtol=0, atol=1e-5 * float(np.abs(model_path).max()))
    xq, cx = moe._row_quantize(_t(x))
    jq, jc = jmoe._row_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(cx.numpy(), np.asarray(jc))


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_layer_matches_jax(quantize, top_k):
    jm = _jmoe(6 + top_k, 32, 64, 4, top_k, 1.25, quantize)
    x = np.random.default_rng(7).standard_normal((2, 16, 32)).astype(np.float32)
    want = np.asarray(jax.jit(lambda m, x: m(x))(jm, jnp.asarray(x)))
    layer = _port(jm)
    assert layer.is_quantized == quantize
    got = layer(_t(x)).detach()
    assert got.shape == x.shape and got.dtype == torch.float32
    if quantize:
        assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))
    else:
        assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert abs(float(layer.aux_loss(_t(x)).detach()) - float(jm.aux_loss(jnp.asarray(x)))) \
        <= 1e-6


def test_moe_layer_bf16_matches_jax():
    """A bf16 layer (router in f32): the float expert FFN upcasts its
    operands and rounds the hidden activation to bf16 as JAX does; the
    output rounds to bf16 on both sides (2^-8 relative)."""
    jm = jmoe.MoEFeedForward.init(jax.random.PRNGKey(9), 32, 64, n_experts=4, top_k=2,
                                  dtype=jnp.bfloat16)
    x = np.random.default_rng(8).standard_normal((2, 12, 32)).astype(np.float32)
    want = np.asarray(jm(jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    layer = moe.MoEFeedForward(_t(jm.router_w),
                               *(_t(np.asarray(w.astype(jnp.float32))).to(torch.bfloat16)
                                 for w in (jm.w_up, jm.w_down)))
    assert layer.router_w.dtype == torch.float32
    got = layer(_t(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert_allclose(got.float(), want, rtol=2 ** -7, atol=1e-4)


def test_moe_quantize_ignores_bits_and_outliers():
    layer = _port(_jmoe(10, 16, 32, 4, 2, 1.25))
    for qkw in ({}, {"bits": 4}, {"outlier_threshold": 6.0, "outlier_capacity": 8}):
        q = layer.quantize(**qkw)
        assert q.is_quantized and q.w_up_qt.dtype == torch.int8
        assert not q.router_w.requires_grad and q.quantize() is q
        assert torch.equal(q.w_up_qt, layer.quantize().w_up_qt)
