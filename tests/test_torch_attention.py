"""Port parity: the plain versions of kernels K2 (decode attention) and K3
(flash forward) in qgemm_tpu_torch/ops/cuda/ against the JAX Pallas
kernels qgemm_tpu/ops/pallas/decode_attention.py and flash_attention.py,
run in interpret mode as the JAX tests run them. Inputs are made with
numpy and handed to both.

Tolerances (stated per test): float32 caches and inputs agree to f32
summation order (atol 2e-5). The int8 and bf16 variants round q, k and
the probabilities to bf16 on both sides; the two sides sum in different
orders, so a probability near a bf16 rounding boundary may land one ulp
(2^-8 relative) apart, which moves an output by at most ~4e-3 at the
magnitudes used here (atol 5e-3). bf16 outputs are compared after their
own bf16 rounding (atol 2e-2 for values of magnitude <= 2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgemm_tpu.ops.kv_cache import quantize_kv as j_quantize_kv
from qgemm_tpu.ops.pallas.decode_attention import decode_attention as j_decode
from qgemm_tpu.ops.pallas.flash_attention import _flash_attention_fwd_impl as j_flash
from qgemm_tpu_torch.ops.cuda.decode_attention import decode_attention
from qgemm_tpu_torch.ops.cuda.flash_attention import (flash_attention,
                                                      flash_attention_fwd)
from qgemm_tpu_torch.ops.kv_cache import dequantize_kv, quantize_kv
from qgemm_tpu_torch.utils.testing import assert_allclose, use_test_threads

use_test_threads()


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def test_quantize_kv_matches_jax():
    x = _rand((2, 3, 17, 64), seed=0, scale=2.0)
    jq, jc = j_quantize_kv(jnp.asarray(x))
    tq, tc = quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    back = dequantize_kv(tq, tc, torch.float32)
    assert_allclose(back, x, rtol=0, atol=float(np.abs(x).max()) / 127 * 0.5 + 1e-6)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("cache", ["int8", "float32"])
def test_decode_attention_plain_matches_jax(cache, groups):
    b, hkv, s, d = 3, 2, 200, 64
    hq = hkv * groups
    q = _rand((b, hq, 1, d), seed=1)
    k = _rand((b, hkv, s, d), seed=2)
    v = _rand((b, hkv, s, d), seed=3)
    lengths = np.array([1, 77, 200], np.int32)          # ragged, one full
    if cache == "int8":
        kq, kc = j_quantize_kv(jnp.asarray(k))
        vq, vc = j_quantize_kv(jnp.asarray(v))
        want = j_decode(jnp.asarray(q), kq, vq, jnp.asarray(lengths), kc=kc, vc=vc)
        t = lambda a: torch.from_numpy(np.array(a))
        got = decode_attention(t(q), t(kq), t(vq), t(lengths), kc=t(kc), vc=t(vc))
        atol = 5e-3
    else:
        want = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(lengths))
        got = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(lengths))
        atol = 2e-5
    assert got.shape == (b, hq, 1, d) and got.dtype == torch.float32
    assert_allclose(got, np.asarray(want), rtol=0, atol=atol)
    assert decode_attention.launches == 0


def test_decode_attention_rejects_bad_shapes():
    q = torch.zeros(2, 4, 2, 64)
    k = torch.zeros(2, 4, 16, 64)
    with pytest.raises(ValueError):
        decode_attention(q, k, k, torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError):   # int8 cache without scales
        decode_attention(q[:, :, :1], k.to(torch.int8), k.to(torch.int8),
                         torch.ones(2, dtype=torch.int32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_forward_plain_matches_jax(causal, dtype):
    b, h, s, d = 2, 3, 200, 64                             # 200: not a block multiple
    q, k, v = (_rand((b, h, s, d), seed=i) for i in (4, 5, 6))
    jargs = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    jo, jl = j_flash(*jargs, causal=causal)
    targs = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    to, tl = flash_attention_fwd(*targs, causal=causal)
    assert to.dtype == targs[0].dtype and tl.dtype == torch.float32
    assert_allclose(to, np.asarray(jo.astype(jnp.float32)), rtol=0,
                    atol=2e-5 if dtype == "float32" else 2e-2)
    assert_allclose(tl, np.asarray(jl), rtol=0,
                    atol=2e-5 if dtype == "float32" else 5e-3)
    assert_allclose(flash_attention(*targs, causal=causal), to, rtol=0, atol=0)
    assert flash_attention_fwd.launches == 0
