"""Port parity: the plain version of kernel K7 (the blockwise flash
backward, qgemm_tpu_torch/ops/cuda/flash_attention_bwd.py) against the JAX
Pallas backward, qgemm_tpu/ops/pallas/flash_attention.py's
``_flash_attention_bwd_impl``, run in interpret mode on the CPU as the JAX
tests run it; and the port's differentiable ``flash_attention`` (K3 + K7's
plain versions under a ``torch.autograd.Function``) against ``jax.grad``
of JAX's ``flash_attention``. Inputs are made with numpy and handed to
both; both backwards get the same O, lse and dO.

Tolerances: float32 agrees to f32 summation order (|err| <= 1e-5 *
max|ref| + 1e-6). bf16 rounds P and dS to bf16 at the same points on both
sides, and the outputs once each; a product summed in another order can
land a P or dS entry one bf16 ulp (2^-8 relative) apart, so bf16 outputs
are held to 2^-7 relative plus 1e-3 * max|ref| (measured: at most 6e-5 *
max|ref|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgemm_tpu.ops.pallas.flash_attention import (_flash_attention_bwd_impl,
                                                  _flash_attention_fwd_impl)
from qgemm_tpu.ops.pallas.flash_attention import flash_attention as j_flash_attention
from qgemm_tpu_torch.ops.cuda.flash_attention import flash_attention
from qgemm_tpu_torch.ops.cuda.flash_attention_bwd import (flash_attention_bwd,
                                                          flash_attention_bwd_plain)
from qgemm_tpu_torch.utils.testing import assert_allclose, to_numpy, use_test_threads

use_test_threads()

B, H, D = 1, 2, 64


def _inputs(sq, sk, dtype, seed):
    """q, k, v, dO as f32 numpy arrays holding values of ``dtype``."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, sq, D), (B, H, sk, D), (B, H, sk, D), (B, H, sq, D))]
    if dtype == "bfloat16":
        arrs = [torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in arrs]
    return arrs


def _held(got, ref, dtype):
    ref = to_numpy(ref).astype(np.float64)
    got = to_numpy(got).astype(np.float64)
    scale = float(np.abs(ref).max())
    if dtype == "float32":
        assert_allclose(got, ref, rtol=0, atol=1e-5 * scale + 1e-6)
    else:
        assert_allclose(got, ref, rtol=2 ** -7, atol=1e-3 * scale)


@pytest.mark.parametrize("sq,sk", [(40, 40), (72, 72), (40, 72)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_plain_matches_jax(causal, dtype, sq, sk):
    q, k, v, g = _inputs(sq, sk, dtype, seed=sq + 3 * sk)
    jd = getattr(jnp, dtype)
    jq, jk, jv, jg = (jnp.asarray(a).astype(jd) for a in (q, k, v, g))
    out, lse = _flash_attention_fwd_impl(jq, jk, jv, causal)
    want = _flash_attention_bwd_impl(jq, jk, jv, out, lse, jg, causal)
    td = getattr(torch, dtype)
    t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(td)
    got = flash_attention_bwd(t(q), t(k), t(v), t(out.astype(jnp.float32)),
                              torch.from_numpy(np.array(lse)), t(g), causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == td and tuple(a.shape) == tuple(b.shape), name
        _held(a, np.asarray(b.astype(jnp.float32)), dtype)
    assert flash_attention_bwd.launches == 0


def test_flash_backward_plain_masks_causal_keys_past_the_queries():
    """Causal with Sk > Sq: keys past the last query get no gradient, and
    the plain version agrees with torch autograd through the plain forward."""
    q, k, v, g = _inputs(40, 72, "float32", seed=11)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    from qgemm_tpu_torch.ops.cuda.flash_attention import flash_attention_plain
    out, lse = flash_attention_plain(tq, tk, tv, causal=True)
    ref = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    got = flash_attention_bwd_plain(*(a.detach() for a in (tq, tk, tv, out, lse)),
                                    torch.from_numpy(g), causal=True)
    for a, b in zip(got, ref):
        assert_allclose(a, b, rtol=0, atol=1e-5 * float(b.abs().max()) + 1e-6)
    assert not got[1][:, :, 40:].any() and not got[2][:, :, 40:].any()


@pytest.mark.parametrize("sq,sk", [(72, 72), (40, 72)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_autograd_matches_jax_grad(causal, sq, sk):
    """The port's differentiable flash_attention against jax.grad of JAX's
    custom_vjp flash_attention, with an upstream weight so dO is not 1."""
    q, k, v, w = _inputs(sq, sk, "float32", seed=5 + sq + sk)

    def j_loss(q, k, v):
        return jnp.sum(j_flash_attention(q, k, v, causal) * w)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    loss = (flash_attention(tq, tk, tv, causal) * torch.from_numpy(w)).sum()
    got = torch.autograd.grad(loss, (tq, tk, tv))
    for a, b in zip(got, want):
        _held(a, np.asarray(b), "float32")


def test_flash_backward_rejects_bad_arguments():
    q = torch.zeros(1, 2, 8, 64)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, q, q, q, lse.to(torch.bfloat16), q)
    with pytest.raises(ValueError, match="out"):
        flash_attention_bwd(q, q, q, q[:, :, :4], lse, q)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, q[:, :1], q, q, lse, q)
