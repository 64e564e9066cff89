"""Port parity: int8 flash attention (ops/cuda/int8_flash_attention.py, row
12 of the TPU kernel table) against qgemm_tpu's ``flash_attention_int8``
(its Pallas kernel in interpret mode) on the same numpy inputs.

* The pre-pass's codes and scales equal JAX's bit for bit given the same
  centered K. The centering itself is a mean over the sequence in f32, and
  XLA sums in an order torch does not reproduce, so the centered K is held
  within a few f32 ulps and the codes built on it may differ by 1 where a
  value sits on a rounding boundary.
* The plain version at its default key block (JAX's) within 2e-3 max abs
  of JAX's kernel: both quantize P against the same running max; the rest
  is exp and sum-order rounding, which can flip a P code.
* Both within 5e-2 max abs of f32 attention, as tests/test_pallas_kernels.py
  holds JAX's kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgemm_tpu.ops.pallas.flash_attention import _reference_attention
from qgemm_tpu.ops.pallas.int8_flash_attention import flash_attention_int8 as jax_int8
from qgemm_tpu_torch.ops import cuda as kernels
from qgemm_tpu_torch.ops.cuda.int8_flash_attention import (KERNEL_KEY_TILE, center_keys,
                                                           flash_attention_int8,
                                                           flash_attention_int8_plain,
                                                           int8_flash_prepass, jax_key_block,
                                                           quantize_centered)
from qgemm_tpu_torch.utils.testing import to_numpy, use_test_threads

use_test_threads()


@jax.jit
def _jax_centered(k):
    kf = k.astype(jnp.float32)
    return kf - jnp.mean(kf, axis=2, keepdims=True)


@jax.jit
def _jax_quantize(q, kf, v):
    """The pre-pass of qgemm_tpu's flash_attention_int8 after the centering,
    line for line (int8 V)."""
    qf, vf = q.astype(jnp.float32), v.astype(jnp.float32)
    sq_s = jnp.maximum(jnp.max(jnp.abs(qf), axis=-1, keepdims=True), 1e-6)
    sk_s = jnp.maximum(jnp.max(jnp.abs(kf), axis=-1, keepdims=True), 1e-6)
    q8 = jnp.round(qf / sq_s * 127.0).astype(jnp.int8)
    k8 = jnp.round(kf / sk_s * 127.0).astype(jnp.int8)
    vc = jnp.maximum(jnp.max(jnp.abs(vf), axis=2, keepdims=True), 1e-6)
    v8 = jnp.round(vf / vc * 127.0).astype(jnp.int8)
    return q8, k8, v8, sq_s / 127.0, sk_s / 127.0, vc


def _qkv(b, h, sq, sk, d, dv, seed, k_mean=0.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, h, sk, dv)).astype(np.float32)
    if k_mean:
        k = k + (rng.standard_normal((1, 1, 1, d)) * k_mean).astype(np.float32)
    return q, k, v


def _err(a, b):
    return float(np.max(np.abs(np.asarray(to_numpy(a), np.float64)
                               - np.asarray(to_numpy(b), np.float64))))


CASES = {  # b, h, sq, sk, d, dv, seed, k_mean
    "jax_1x2x256x64": (1, 2, 256, 256, 64, 64, 5, 0.0),
    "heavy_k_mean": (1, 2, 256, 256, 64, 64, 6, 8.0),
    "ragged_100_130": (2, 1, 100, 130, 32, 32, 7, 0.0),
    "d32_dv64": (1, 2, 96, 160, 32, 64, 8, 0.0),
    "two_key_blocks": (1, 1, 40, 1100, 32, 32, 9, 0.0),
    # head widths past 128: code rows of 256 (and, past 256, 512) bytes on
    # the card, V in chunks of 128 channels
    "d160": (1, 2, 64, 96, 160, 160, 10, 0.0),
    "d256": (1, 1, 70, 130, 256, 256, 11, 0.0),
    "d256_dv96": (1, 2, 50, 100, 256, 96, 12, 0.0),
}
# past 256: the plain version against JAX's kernel and pre-pass as above; no
# bound against f32 attention (both packages' int8 error grows with the
# width: 0.058 at this case, causal, past the 5e-2 of the narrower cases)
WIDE_CASES = {"d384_dv320": (1, 1, 40, 70, 384, 320, 13, 0.0)}


@pytest.mark.parametrize("case", list(CASES) + list(WIDE_CASES))
def test_prepass_codes_and_scales_equal_jax(case):
    b, h, sq, sk, d, dv, seed, k_mean = {**CASES, **WIDE_CASES}[case]
    q, k, v = _qkv(b, h, sq, sk, d, dv, seed, k_mean)
    jkc = np.array(_jax_centered(jnp.asarray(k)))
    tkc = center_keys(torch.from_numpy(k)).numpy()
    ulp = np.spacing(np.abs(k).max(axis=2, keepdims=True).astype(np.float32))
    assert np.all(np.abs(tkc - jkc) <= 4 * ulp)
    want = _jax_quantize(jnp.asarray(q), jnp.asarray(jkc), jnp.asarray(v))
    got = quantize_centered(torch.from_numpy(q), torch.from_numpy(jkc), torch.from_numpy(v))
    for name, g, w in zip(("q8", "k8", "v8", "sq", "sk", "vc"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    # the whole pre-pass: codes on torch's own centering differ by at most 1, rarely
    full = int8_flash_prepass(*(torch.from_numpy(a) for a in (q, k, v)))
    diff = np.abs(full.k8.numpy().astype(np.int32) - np.asarray(want[1]).astype(np.int32))
    assert diff.max() <= 1 and diff.mean() < 1e-3
    qk = int8_flash_prepass(*(torch.from_numpy(a) for a in (q, k, v)), qk_only=True)
    assert qk.v8.dtype == torch.bfloat16 and qk.vc is None


@pytest.mark.parametrize("qk_only", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_kernel_f32(case, causal, qk_only):
    b, h, sq, sk, d, dv, seed, k_mean = CASES[case]
    q, k, v = _qkv(b, h, sq, sk, d, dv, seed, k_mean)
    jq_, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = jax_int8(jq_, jk, jv, causal=causal, qk_only=qk_only)
    got = flash_attention_int8_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                     causal=causal, qk_only=qk_only)
    assert tuple(got.shape) == (b, h, sq, dv) and got.dtype == torch.float32
    assert _err(got, want) < 2e-3, (case, _err(got, want))
    ref = _reference_attention(jq_, jk, jv, causal)
    assert _err(got, ref) < 5e-2 and _err(want, ref) < 5e-2


@pytest.mark.parametrize("qk_only", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", list(WIDE_CASES))
def test_plain_matches_jax_kernel_f32_past_256(case, causal, qk_only):
    b, h, sq, sk, d, dv, seed, k_mean = WIDE_CASES[case]
    q, k, v = _qkv(b, h, sq, sk, d, dv, seed, k_mean)
    want = jax_int8(*(jnp.asarray(a) for a in (q, k, v)), causal=causal, qk_only=qk_only)
    got = flash_attention_int8_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                     causal=causal, qk_only=qk_only)
    assert tuple(got.shape) == (b, h, sq, dv) and got.dtype == torch.float32
    assert _err(got, want) < 2e-3, (case, _err(got, want))


@pytest.mark.parametrize("qk_only", [False, True])
@pytest.mark.parametrize("case", ["jax_1x2x256x64", "ragged_100_130"])
def test_plain_matches_jax_kernel_bf16(case, qk_only):
    b, h, sq, sk, d, dv, seed, k_mean = CASES[case]
    q, k, v = _qkv(b, h, sq, sk, d, dv, seed, k_mean)
    jq_, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = jax_int8(jq_, jk, jv, causal=True, qk_only=qk_only)
    tq_, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention_int8_plain(tq_, tk, tv, causal=True, qk_only=qk_only)
    assert got.dtype == torch.bfloat16
    # the kernel's bf16 output and the epilogue's second bf16 rounding: within
    # 2e-3 plus one bf16 ulp of the output on each rounding
    w = np.asarray(want.astype(jnp.float32), np.float64)
    tol = 2e-3 + 2 * np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
    assert np.all(np.abs(to_numpy(got) - w) <= tol)
    ref = _reference_attention(jq_, jk, jv, True)
    assert _err(got, ref) < 5e-2


def test_key_block_changes_p_codes_only_at_the_int8_level():
    """The kernel's 128-key tiles quantize P against a different running
    max than JAX's blocks: the two stay within int8 rounding of each
    other, and each within 5e-2 of f32 attention."""
    q, k, v = _qkv(1, 2, 200, 300, 64, 64, 10)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    assert jax_key_block(300) == 384 and KERNEL_KEY_TILE == 128
    wide = flash_attention_int8_plain(*t, causal=True)
    tiles = flash_attention_int8_plain(*t, causal=True, block_k=KERNEL_KEY_TILE)
    assert 0 < _err(wide, tiles) < 2e-2
    ref = _reference_attention(*(jnp.asarray(a) for a in (q, k, v)), True)
    assert _err(tiles, ref) < 5e-2


def test_wrapper_runs_plain_on_cpu_and_launches_nothing():
    kernels.reset_launch_counts()
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 30, 50, 32, 64, 11))
    for qk_only in (False, True):
        assert torch.equal(flash_attention_int8(q, k, v, True, qk_only),
                           flash_attention_int8_plain(q, k, v, True, qk_only))
    assert kernels.launch_counts()["int8_flash_attention"] == 0
