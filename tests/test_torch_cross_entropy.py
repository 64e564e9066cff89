"""Port parity: qgemm_tpu_torch/ops/cross_entropy.py against
qgemm_tpu/ops/cross_entropy.py (the custom_vjp softmax cross-entropy) on
the same numpy logits and targets: the loss, its analytic gradient under
an upstream g of 1 and of 2.5, and the dual-return helper. float32 agrees
to f32 rounding (rtol 1e-6, atol 1e-7); bf16 logits compute in bf16 on
both sides (rtol 2^-7 for one bf16 rounding on each side, atol 1e-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgemm_tpu.ops.cross_entropy import cross_entropy_loss as j_ce
from qgemm_tpu.ops.cross_entropy import cross_entropy_loss_and_grad as j_ce_and_grad
from qgemm_tpu_torch.ops.cross_entropy import (cross_entropy_loss,
                                               cross_entropy_loss_and_grad)
from qgemm_tpu_torch.utils.testing import assert_allclose, use_test_threads

use_test_threads()


def _data(dtype, seed=0, b=24, c=37):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, c)) * 3).astype(np.float32)
    if dtype == "bfloat16":
        logits = torch.from_numpy(logits).to(torch.bfloat16).float().numpy()
    return logits, rng.integers(0, c, size=b).astype(np.int32)


@pytest.mark.parametrize("upstream", [1.0, 2.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_loss_and_gradient_match_jax(dtype, upstream):
    logits, targets = _data(dtype)
    jl = jnp.asarray(logits).astype(getattr(jnp, dtype))
    jt = jnp.asarray(targets)
    want_loss, vjp = jax.vjp(lambda x: j_ce(x, jt), jl)
    (want_grad,) = vjp(jnp.asarray(upstream, jl.dtype))
    tl = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_()
    loss = cross_entropy_loss(tl, torch.from_numpy(targets))
    (grad,) = torch.autograd.grad(loss, tl, torch.tensor(upstream, dtype=loss.dtype))
    assert loss.dtype == tl.dtype and grad.dtype == tl.dtype
    rtol, atol = (1e-6, 1e-7) if dtype == "float32" else (2 ** -7, 1e-3)
    assert_allclose(loss, np.asarray(want_loss.astype(jnp.float32)), rtol=rtol, atol=atol)
    assert_allclose(grad, np.asarray(want_grad.astype(jnp.float32)), rtol=rtol, atol=atol)


def test_cross_entropy_gradient_rows_sum_to_zero_and_match_autograd():
    """The analytic gradient equals torch autograd through the plain
    composition (log_softmax NLL), and each row sums to zero."""
    logits, targets = _data("float32", seed=1)
    tl = torch.from_numpy(logits).requires_grad_()
    (got,) = torch.autograd.grad(cross_entropy_loss(tl, torch.from_numpy(targets)), tl)
    ref_in = torch.from_numpy(logits).requires_grad_()
    ref_loss = torch.nn.functional.cross_entropy(ref_in, torch.from_numpy(targets).long())
    (ref,) = torch.autograd.grad(ref_loss, ref_in)
    assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
    assert_allclose(got.sum(dim=-1), np.zeros(len(targets)), rtol=0, atol=1e-7)


def test_cross_entropy_loss_and_grad_matches_jax():
    logits, targets = _data("float32", seed=2)
    want_loss, want_grad = j_ce_and_grad(jnp.asarray(logits), jnp.asarray(targets))
    loss, grad = cross_entropy_loss_and_grad(torch.from_numpy(logits),
                                             torch.from_numpy(targets))
    assert_allclose(loss, np.asarray(want_loss), rtol=1e-6, atol=1e-7)
    assert_allclose(grad, np.asarray(want_grad), rtol=1e-6, atol=1e-7)
    assert not grad.requires_grad
