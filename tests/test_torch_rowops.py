"""Port parity: the row kernels' plain versions (ops/cuda/softmax.py,
ops/cuda/layernorm.py; rows 14 and 13 of the TPU kernel table) against the
JAX Pallas kernels ``softmax_pallas`` and ``layernorm_residual_pallas`` in
interpret mode, on the same numpy inputs.

Tolerances: f32 at the JAX tests' own (softmax rtol 1e-5 / atol 1e-6,
LayerNorm rtol 1e-4 / atol 1e-5: sums and exp associate differently); bf16
outputs within one bf16 ulp of JAX's (both round the same f32 math once).
The wrappers on CPU tensors run these plain versions and launch nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgemm_tpu.ops.pallas.layernorm import layernorm_residual_pallas
from qgemm_tpu.ops.pallas.softmax import softmax_pallas
from qgemm_tpu_torch.ops import cuda as kernels
from qgemm_tpu_torch.ops.cuda.layernorm import layernorm_residual, layernorm_residual_plain
from qgemm_tpu_torch.ops.cuda.softmax import softmax, softmax_plain
from qgemm_tpu_torch.utils.testing import assert_allclose, to_numpy, use_test_threads

use_test_threads()

SOFTMAX_SHAPES = [(8, 128), (33, 200), (2, 5, 96), (3, 130)]   # 130: not a multiple of 4
LN_SHAPES = [(16, 128), (7, 200), (9, 160), (5, 202)]           # 202: not a multiple of 4


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _within_one_bf16_ulp(got, want):
    g = np.asarray(to_numpy(got), np.float64)
    w = np.asarray(to_numpy(want), np.float64)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
    worst = np.max(np.abs(g - w) - ulp)
    assert worst <= 0, f"beyond one bf16 ulp by {worst}"


@pytest.mark.parametrize("shape", SOFTMAX_SHAPES)
def test_softmax_plain_matches_pallas_f32(shape):
    x = _x(shape, seed=len(shape) * 100 + shape[-1], scale=5.0)
    got = softmax_plain(torch.from_numpy(x))
    assert_allclose(got, softmax_pallas(jnp.asarray(x)), rtol=1e-5, atol=1e-6, msg=str(shape))
    assert_allclose(got.sum(-1), np.ones(shape[:-1]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SOFTMAX_SHAPES)
def test_softmax_plain_matches_pallas_bf16(shape):
    x = _x(shape, seed=shape[-1], scale=5.0)
    got = softmax_plain(torch.from_numpy(x).to(torch.bfloat16))
    want = softmax_pallas(jnp.asarray(x).astype(jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    _within_one_bf16_ulp(got, want)


@pytest.mark.parametrize("shape", LN_SHAPES)
def test_layernorm_plain_matches_pallas_f32(shape):
    x, r = _x(shape, seed=1 + shape[-1]), _x(shape, seed=2 + shape[-1])
    g, b = _x((shape[-1],), seed=3), _x((shape[-1],), seed=4)
    got = layernorm_residual_plain(*(torch.from_numpy(a) for a in (x, r, g, b)))
    want = layernorm_residual_pallas(*(jnp.asarray(a) for a in (x, r, g, b)))
    assert_allclose(got, want, rtol=1e-4, atol=1e-5, msg=str(shape))
    got = layernorm_residual_plain(torch.from_numpy(x))
    assert_allclose(got, layernorm_residual_pallas(jnp.asarray(x)), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [(16, 128), (5, 202), (2, 3, 96)])
def test_layernorm_plain_matches_pallas_bf16(shape):
    x, r = _x(shape, seed=5), _x(shape, seed=6)
    g, b = _x((shape[-1],), seed=7), _x((shape[-1],), seed=8)
    tx, tr = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, r))
    jx, jr = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, r))
    got = layernorm_residual_plain(tx, tr, torch.from_numpy(g), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    _within_one_bf16_ulp(got, layernorm_residual_pallas(jx, jr, jnp.asarray(g), jnp.asarray(b)))
    # an f32 residual under bf16 x: summed in f32 on both sides
    got = layernorm_residual_plain(tx, torch.from_numpy(r))
    _within_one_bf16_ulp(got, layernorm_residual_pallas(jx, jnp.asarray(r)))


def test_layernorm_plain_residual_only_and_gamma_only():
    x, r, g = _x((6, 72), seed=9), _x((6, 72), seed=10), _x((72,), seed=11)
    got = layernorm_residual_plain(torch.from_numpy(x), torch.from_numpy(r))
    assert_allclose(got, layernorm_residual_pallas(jnp.asarray(x), jnp.asarray(r)),
                    rtol=1e-4, atol=1e-5)
    got = layernorm_residual_plain(torch.from_numpy(x), gamma=torch.from_numpy(g), eps=1e-3)
    want = layernorm_residual_pallas(jnp.asarray(x), gamma=jnp.asarray(g), eps=1e-3)
    assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_row_wrappers_run_plain_on_cpu_and_launch_nothing():
    kernels.reset_launch_counts()
    x, r = torch.from_numpy(_x((4, 3, 50), seed=12)), torch.from_numpy(_x((4, 3, 50), seed=13))
    assert torch.equal(softmax(x), softmax_plain(x))
    assert torch.equal(layernorm_residual(x, r), layernorm_residual_plain(x, r))
    with pytest.raises(ValueError, match="residual"):
        layernorm_residual(x, r[:2])
    with pytest.raises(ValueError, match="gamma"):
        layernorm_residual(x, gamma=torch.ones(49))
    assert kernels.launch_counts()["softmax"] == kernels.launch_counts()["layernorm"] == 0
