"""Port parity: qgemm_tpu_torch/models/optim.py against
qgemm_tpu/models/optim.py on the same numpy parameters and gradients: SGD,
and 5 Adam steps with and without decoupled weight decay, over an f32 and a
bf16 parameter (f32 moments), an absent leaf (None) and a frozen int8 leaf
(no gradient: it passes through untouched).

Tolerances: f32 parameters agree to a few f32 ulps (rtol 1e-6, atol
1e-9), the moments too, with atol 1e-6 * max|m| where b1 * m and
(1 - b1) * g cancel (the two sides may fuse the multiply-add differently);
a bf16 parameter is rounded once per step on both sides
from steps that agree to f32 rounding, so within one bf16 ulp (rtol 2^-8).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgemm_tpu.models.optim import adam_init as j_adam_init
from qgemm_tpu.models.optim import adam_step as j_adam_step
from qgemm_tpu.models.optim import sgd_step as j_sgd_step
from qgemm_tpu_torch.models.optim import SGD, Adam, adam_init, adam_step, sgd_step
from qgemm_tpu_torch.utils.testing import assert_allclose, use_test_threads

use_test_threads()

SHAPES = {"w": (8, 5), "wb": (4, 6)}


def _arrays(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    out = {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}
    out["wb"] = torch.from_numpy(out["wb"]).to(torch.bfloat16).float().numpy()
    return out


def _jax_tree(arrs):
    return {"w": jnp.asarray(arrs["w"]), "wb": jnp.asarray(arrs["wb"]).astype(jnp.bfloat16),
            "b": None}


def _torch_list(arrs):
    return [torch.from_numpy(arrs["w"].copy()),
            torch.from_numpy(arrs["wb"]).to(torch.bfloat16)]


def _check_params(got, want):
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.bfloat16
    assert_allclose(got[0], np.asarray(want["w"]), rtol=1e-6, atol=1e-9)
    assert_allclose(got[1], np.asarray(want["wb"].astype(jnp.float32)), rtol=2 ** -8,
                    atol=0)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adam_five_steps_match_jax(weight_decay):
    p0 = _arrays(0)
    jp = _jax_tree(p0)
    jst = j_adam_init(jp)
    frozen = torch.arange(-6, 6, dtype=torch.int8).reshape(3, 4)
    tp = _torch_list(p0) + [None, frozen.clone()]
    st = adam_init(tp)
    assert st.m[0].dtype == st.m[1].dtype == torch.float32 and st.m[2] is None
    for step in range(5):
        g = _arrays(10 + step, scale=0.1 * (step + 1))
        jp, jst = j_adam_step(jp, _jax_tree(g), jst, lr=0.01, weight_decay=weight_decay)
        st = adam_step(tp, _torch_list(g) + [None, None], st, lr=0.01,
                       weight_decay=weight_decay)
    assert st.t == int(jst.t) == 5
    _check_params(tp, jp)
    for got, want in ((st.m, jst.m), (st.v, jst.v)):
        for t, key in zip(got, ("w", "wb")):
            ref = np.asarray(want[key])
            assert_allclose(t, ref, rtol=1e-6, atol=1e-6 * float(np.abs(ref).max()))
    assert tp[2] is None and torch.equal(tp[3], frozen)


def test_adam_class_matches_functions():
    p0, g = _arrays(1), _arrays(2)
    a, b = _torch_list(p0), _torch_list(p0)
    opt = Adam(lr=0.05, weight_decay=0.01)
    sa, sb = opt.init(a), adam_init(b)
    for _ in range(2):
        sa = opt.step(a, _torch_list(g), sa)
        sb = adam_step(b, _torch_list(g), sb, lr=0.05, weight_decay=0.01)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_sgd_matches_jax():
    p0, g = _arrays(3), _arrays(4)
    want = j_sgd_step(_jax_tree(p0), _jax_tree(g), lr=0.1)
    got = _torch_list(p0) + [None]
    sgd_step(got, _torch_list(g) + [None], lr=0.1)
    _check_params(got, want)
    again = _torch_list(p0)
    SGD(lr=0.1).step(again, _torch_list(g))
    assert all(torch.equal(x, y) for x, y in zip(again, got))


def test_optimizers_update_leaf_parameters_in_place():
    """Parameters that require grad (a model's) are updated in place,
    outside autograd, keeping their identity and dtype."""
    p = torch.nn.Parameter(torch.ones(3, 3, dtype=torch.bfloat16))
    g = torch.full((3, 3), 0.5, dtype=torch.bfloat16)
    st = adam_step([p], [g], adam_init([p]), lr=0.1)
    assert p.requires_grad and p.dtype == torch.bfloat16 and float(p.detach()[0, 0]) < 1.0
    assert st.t == 1 and st.m[0].dtype == torch.float32
    before = p.detach().clone()
    sgd_step([p], [g], lr=0.1)
    assert torch.all(p < before)
