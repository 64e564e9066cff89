"""Port parity for the MLP (qgemm_tpu_torch/models/mlp.py) against
qgemm_tpu/models/mlp.py on the CPU, the JAX weights carried over by
``mlp_from_jax_params``: forward and gradients (with and without remat;
f32, rtol 1e-5), 20 SGD steps on the checked-in MNIST fixture (losses to
rtol 1e-4), the int8 model's logits against JAX's (the JAX kernel in
interpret mode; K1's plain version; rtol 1e-5 + atol 1e-5: the int32 sums
are exact on both sides, the f32 epilogues associate differently) and its
argmax exactly, and the MNIST example's initial-weights fixture against a
fresh JAX init.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgemm_tpu.models.mlp import MLP as JMLP
from qgemm_tpu.models.optim import sgd_step as j_sgd_step
from qgemm_tpu.ops.cross_entropy import cross_entropy_loss as j_cross_entropy
from qgemm_tpu.utils.checkpoint import _path_key
from qgemm_tpu_torch.data.mnist import MNIST
from qgemm_tpu_torch.examples import train_mnist
from qgemm_tpu_torch.models.linear import QuantizedLinear
from qgemm_tpu_torch.models.mlp import MLP
from qgemm_tpu_torch.models.optim import sgd_step
from qgemm_tpu_torch.ops.cross_entropy import cross_entropy_loss
from qgemm_tpu_torch.ops import cuda as kernels
from qgemm_tpu_torch.utils.checkpoint import load_checkpoint
from qgemm_tpu_torch.utils.interop import mlp_from_jax_params, mlp_leaves
from qgemm_tpu_torch.utils.testing import assert_allclose, use_test_threads

use_test_threads()

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
DIMS = [784, 16, 10]
LR = 0.1


def _jax_leaves(tree) -> dict:
    return {_path_key(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pair(seed, dims=DIMS, remat=False):
    jm = JMLP.init(jax.random.PRNGKey(seed), dims, remat=remat)
    return jm, mlp_from_jax_params(_jax_leaves(jm), device="cpu", remat=remat)


def _data(n=64, seed=0):
    ds = MNIST.synthetic(n, seed=seed, noise=1.0)
    return ds.images, ds.targets


@pytest.mark.parametrize("remat", [False, True])
def test_forward_and_grads_equal_jax(remat):
    jm, tm = _pair(3, dims=[784, 32, 16, 10], remat=remat)
    assert tm.remat == remat and len(tm.layers) == 3
    x, y = _data()

    jloss, jgrads = jax.value_and_grad(
        lambda m: j_cross_entropy(m(jnp.asarray(x)), jnp.asarray(y)))(jm)
    assert_allclose(tm(torch.as_tensor(x)).detach(), np.asarray(jm(jnp.asarray(x))),
                    rtol=1e-5, atol=1e-6)
    params = [p for p in tm.parameters() if p.requires_grad]
    loss = cross_entropy_loss(tm(torch.as_tensor(x)), torch.as_tensor(y.astype(np.int64)))
    grads = torch.autograd.grad(loss, params)
    assert_allclose(loss.detach(), float(jloss), rtol=1e-5)
    want = _jax_leaves(jgrads)
    names = list(mlp_leaves(tm))
    assert names == list(want)
    for name, g in zip(names, grads):
        assert_allclose(g, want[name], rtol=1e-5, atol=1e-6, msg=name)


def test_remat_recomputes_and_keeps_no_graph_under_no_grad():
    _, tm = _pair(4, remat=True)
    x = torch.as_tensor(_data(8)[0])
    with torch.no_grad():
        out = tm(x)
    assert not out.requires_grad
    assert torch.equal(out, _pair(4)[1](x).detach())


def test_sgd_steps_track_jax_on_fixture():
    """20 SGD steps (lr 0.1, batch 32, in order) on the checked-in MNIST
    fixture: every step's loss equals JAX's to rtol 1e-4."""
    jm, tm = _pair(1)
    ds = MNIST.load(os.path.join(FIXTURES, "mnist_mini"), "train")
    params = [p for p in tm.parameters() if p.requires_grad]

    @jax.jit
    def j_step(m, x, y):
        loss, g = jax.value_and_grad(lambda m: j_cross_entropy(m(x), y))(m)
        return j_sgd_step(m, g, LR), loss

    got, want = [], []
    batches = list(ds.batches(32)) * 4
    for x, y in batches[:20]:
        jm, jl = j_step(jm, jnp.asarray(x), jnp.asarray(y))
        loss = cross_entropy_loss(tm(torch.as_tensor(x)), torch.as_tensor(y.astype(np.int64)))
        sgd_step(params, torch.autograd.grad(loss, params), LR)
        got.append(float(loss.detach()))
        want.append(float(jl))
    assert_allclose(np.array(got), np.array(want), rtol=1e-4)
    assert got[16] < got[8] < got[0]            # the first batch, on each pass


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_mlp_equals_jax(bits):
    jm, tm = _pair(5)
    x = _data(33, seed=2)[0]
    qt = tm.quantize(bits=bits)
    assert all(isinstance(l, QuantizedLinear) and l.bits == bits for l in qt.layers)
    assert not qt.remat
    kernels.reset_launch_counts()
    got = qt(torch.as_tensor(x))
    assert sum(kernels.launch_counts().values()) == 0        # the plain path on the CPU
    want = np.asarray(jm.quantize(bits=bits)(jnp.asarray(x)))
    assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert got.argmax(-1).tolist() == want.argmax(-1).tolist()
    # carried over quantized, the JAX int8 model gives the same logits
    qj = mlp_from_jax_params(_jax_leaves(jm.quantize(bits=bits)), device="cpu")
    assert_allclose(qj(torch.as_tensor(x)), want, rtol=1e-5, atol=1e-5)


def test_init_on_device_and_from_generator():
    g = torch.Generator().manual_seed(0)
    m = MLP.init(g, [5, 4, 3], bias=False, device="cpu")
    assert [tuple(l.w.shape) for l in m.layers] == [(5, 4), (4, 3)]
    assert all(l.b is None for l in m.layers) and m.device.type == "cpu"
    bound = 1 / 5 ** 0.5
    assert float(m.layers[0].w.detach().abs().max()) <= bound
    assert torch.equal(MLP.init(7, DIMS, device="cpu").layers[1].w,
                       MLP.init(7, DIMS, device="cpu").layers[1].w)
    assert m.quantize().device.type == "cpu"


def test_example_init_fixture_is_the_jax_init():
    """tests/fixtures/mnist_mlp_init_seed1.npz (written by
    scripts/mnist_init_fixture.py) holds JAX's MLP.init(PRNGKey(1),
    [784, 16, 10]) bit for bit, and the example starts from it."""
    jm = JMLP.init(jax.random.PRNGKey(1), DIMS)
    path = os.path.join(FIXTURES, "mnist_mlp_init_seed1.npz")
    tm = load_checkpoint(path, MLP.init(0, DIMS, device="cpu"))
    want = _jax_leaves(jm)
    for name, t in mlp_leaves(tm).items():
        np.testing.assert_array_equal(t.detach().numpy(), want[name], err_msg=name)
    train = MNIST.synthetic(64, seed=1, noise=2.0)
    model, records, _ = train_mnist.train_mlp(train, DIMS, 1, 32, 0.01, 1, "cpu",
                                              shuffle=False, init=path)
    assert len(records) == 1 and 0 <= records[0]["train_acc"] <= 1
    assert not torch.equal(model.layers[0].w, tm.layers[0].w)       # it trained
