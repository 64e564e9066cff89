"""Port parity: the op layer (qgemm_tpu_torch/ops: elemwise, reduction,
matmul, layernorm_reference_semantics, quantized_matmul_xla, and the
package's exports) against qgemm_tpu/ops on the same numpy inputs.

Tolerances: float results within 1e-6 (rtol and atol; sums may associate
differently); integer results, argmax indices and ``equal``'s 0/1 exactly.
Float-to-int8 casts are compared on values within [-128, 127]: outside it
XLA saturates and torch wraps (a deliberate difference, ROADMAP C).
"""

import ast
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qgemm_tpu.ops as jops
import qgemm_tpu_torch.ops as tops
from qgemm_tpu.ops import elemwise as je
from qgemm_tpu.ops import quantize as jq
from qgemm_tpu.ops import reduction as jr
from qgemm_tpu_torch.ops import elemwise as te
from qgemm_tpu_torch.ops import quantize as tq
from qgemm_tpu_torch.ops import reduction as tr
from qgemm_tpu_torch.utils.testing import assert_allclose, use_test_threads

use_test_threads()

# the packages export functions under these modules' names, so reach the
# modules through sys.modules
jln, jmm = (importlib.import_module(f"qgemm_tpu.ops.{m}") for m in ("layernorm", "matmul"))
tln, tmm = (importlib.import_module(f"qgemm_tpu_torch.ops.{m}") for m in ("layernorm", "matmul"))


def _x(shape, seed, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))


def _exact(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


UNARY = ["relu", "exp", "cast_int8_truncate", "round_int8"]


@pytest.mark.parametrize("name", UNARY)
def test_elemwise_unary(name):
    x = _x((7, 33), seed=1, scale=40.0 if "int8" in name else 2.0)
    jx, tx = _both(x)
    got, want = getattr(te, name)(tx), getattr(je, name)(jx)
    if "int8" in name:
        assert got.dtype == torch.int8
        _exact(got, want)
    else:
        assert_allclose(got, want, msg=name)


def test_elemwise_log_and_inv_divide():
    x = np.abs(_x((5, 17), seed=2)) + 0.1
    jx, tx = _both(x)
    assert_allclose(te.log(tx), je.log(jx))
    # 127 / absmax, a true division on both sides
    _exact(te.inv_divide(tx, 127.0), je.inv_divide(jx, 127.0))
    c = _x((5, 17), seed=3)
    _exact(te.inv_divide(tx, torch.from_numpy(c)), je.inv_divide(jx, jnp.asarray(c)))


@pytest.mark.parametrize("name", ["add", "subtract", "multiply", "equal"])
@pytest.mark.parametrize("bshape", [(6, 9), (1, 9), (6, 1)])
def test_elemwise_binary_broadcast(name, bshape):
    a = np.round(_x((6, 9), seed=4))
    b = np.round(_x(bshape, seed=5))
    (ja, ta), (jb, tb) = _both(a), _both(b)
    got, want = getattr(te, name)(ta, tb), getattr(je, name)(ja, jb)
    if name == "equal":
        assert got.dtype == torch.float32 and float(got.sum()) > 0
    _exact(got, want)


def test_elemwise_relu_back_sgd_dequantize_outlier_mask_const_init():
    x, dy = _x((8, 12), seed=6), _x((8, 12), seed=7)
    (jx, tx), (jdy, tdy) = _both(x), _both(dy)
    _exact(te.relu_back(tx, tdy), je.relu_back(jx, jdy))
    assert_allclose(te.sgd_update(tx, tdy, 0.01), je.sgd_update(jx, jdy, 0.01))
    acc = np.random.default_rng(8).integers(-50000, 50000, (8, 12)).astype(np.int32)
    scale = np.abs(_x((1, 12), seed=9)) * 1e-4
    (jacc, tacc), (js, ts) = _both(acc), _both(scale)
    _exact(te.dequantize(tacc, ts), je.dequantize(jacc, js))
    _exact(te.outlier_mask(tx, 3.0), je.outlier_mask(jx, 3.0))
    _exact(te.const_init((3, 4), 2.5, device="cpu"), je.const_init((3, 4), 2.5))
    _exact(te.const_init((2,), 7, dtype=torch.int32, device="cpu"),
           je.const_init((2,), 7, dtype=jnp.int32))


@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("keepdims", [True, False])
def test_reductions(axis, keepdims):
    x = _x((9, 14, 5), seed=10)
    x[2, 3, :] = x[2, 3, 0]          # ties: argmax takes the first
    jx, tx = _both(x)
    for name in ("reduce_sum", "reduce_max", "absmax"):
        assert_allclose(getattr(tr, name)(tx, axis, keepdims),
                        getattr(jr, name)(jx, axis, keepdims), msg=name)
    _exact(tr.argmax(tx, axis, keepdims), jr.argmax(jx, axis, keepdims))


def test_argmax_first_index_on_ties():
    x = np.array([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0]], np.float32)
    jx, tx = _both(x)
    _exact(tr.argmax(tx, -1, False), jr.argmax(jx, -1, False))
    assert tr.argmax(tx, -1, False).tolist() == [1, 0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_float(dtype):
    a, b = _x((6, 40), seed=11), _x((40, 7), seed=12)
    ja, jb = jnp.asarray(a).astype(dtype), jnp.asarray(b).astype(dtype)
    ta, tb = torch.from_numpy(a).to(getattr(torch, dtype)), torch.from_numpy(b).to(getattr(torch, dtype))
    got = tmm.matmul(ta, tb)
    assert got.dtype == torch.float32
    assert_allclose(got, jmm.matmul(ja, jb), rtol=1e-6, atol=1e-5)
    a3 = _x((2, 3, 40), seed=13)
    assert_allclose(tmm.matmul(torch.from_numpy(a3), torch.from_numpy(b)),
                    jmm.matmul(jnp.asarray(a3), jnp.asarray(b)), rtol=1e-6, atol=1e-5)


def test_matmul_int8_accumulates_without_wrapping():
    rng = np.random.default_rng(14)
    a = rng.integers(-127, 128, (5, 300)).astype(np.int8)
    b = rng.integers(-127, 128, (300, 6)).astype(np.int8)
    got = tmm.matmul(torch.from_numpy(a), torch.from_numpy(b), torch.int32)
    assert got.dtype == torch.int32 and int(got.abs().max()) > 127
    _exact(got, jmm.matmul(jnp.asarray(a), jnp.asarray(b), jnp.int32))
    assert tmm.matmul_flops(5, 6, 300) == jmm.matmul_flops(5, 6, 300) == 18000


@pytest.mark.parametrize("shape", [(8, 64), (3, 5, 33)])
def test_layernorm_reference_semantics(shape):
    x = _x(shape, seed=15, scale=1.0)
    jx, tx = _both(x)
    assert_allclose(tln.layernorm_reference_semantics(tx),
                    jln.layernorm_reference_semantics(jx), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rounding", ["nearest", "truncate"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_matmul_xla(rounding, dtype):
    x, w = _x((9, 48), seed=16), _x((48, 11), seed=17, scale=0.2)
    jx, jw = jnp.asarray(x).astype(dtype), jnp.asarray(w).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    got = tq.quantized_matmul_xla(tx, tw, rounding=rounding)
    want = jq.quantized_matmul_xla(jx, jw, rounding=rounding)
    assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _init_names(pkg) -> set:
    """The names a package's ``__init__`` imports (what it exports)."""
    tree = ast.parse(open(pkg.__file__).read())
    return {a.asname or a.name for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) for a in node.names}


def test_op_layer_exports_every_jax_name_and_agrees():
    """qgemm_tpu_torch.ops exports each name qgemm_tpu.ops exports (its
    ``__init__``'s), and each gives JAX's result on the same inputs."""
    names = _init_names(jops)
    assert names == _init_names(tops) and len(names) == 11, names
    for n in names:
        assert hasattr(tops, n), n
    for n in ("elemwise", "reduction"):
        jm, tm = getattr(jops, n), getattr(tops, n)
        jfns = {f for f in vars(jm) if not f.startswith("_") and callable(getattr(jm, f))
                and getattr(getattr(jm, f), "__module__", "") == jm.__name__}
        assert jfns <= set(vars(tm)), jfns - set(vars(tm))
    x, r = _x((6, 40), seed=18, scale=1.0), _x((6, 40), seed=19, scale=1.0)
    w = _x((40, 10), seed=20, scale=0.2)
    (jx, tx), (jr_, tr_), (jw, tw) = _both(x), _both(r), _both(w)
    assert_allclose(tops.softmax(tx), jops.softmax(jx), rtol=1e-6, atol=1e-6)
    assert_allclose(tops.layernorm(tx), jops.layernorm(jx), rtol=1e-5, atol=1e-5)
    assert_allclose(tops.layernorm_residual(tx, tr_), jops.layernorm_residual(jx, jr_),
                    rtol=1e-5, atol=1e-5)
    targets = np.random.default_rng(21).integers(0, 40, (6,))
    assert_allclose(tops.cross_entropy_loss(tx, torch.from_numpy(targets)),
                    jops.cross_entropy_loss(jx, jnp.asarray(targets)), rtol=1e-6, atol=1e-6)
    assert_allclose(tops.matmul(tx, tw), jops.matmul(jx, jw), rtol=1e-6, atol=1e-5)
    tq_, tc = tops.absmax_quantize(tx, axis=-1)
    jq_, jc = jops.absmax_quantize(jx, axis=-1)
    _exact(tq_, jq_)
    _exact(tc, jc)
    acc = np.random.default_rng(22).integers(-9000, 9000, (6, 10)).astype(np.int32)
    cw = np.abs(_x((1, 10), seed=23)) + 0.1
    _exact(tops.dequantize(torch.from_numpy(acc), tc, torch.from_numpy(cw)),
           jops.dequantize(jnp.asarray(acc), jc, jnp.asarray(cw)))
    assert_allclose(tops.quantized_matmul(tx, tw), jops.quantized_matmul(jx, jw),
                    rtol=1e-6, atol=1e-6)
    xo = x.copy()
    xo[:, 3] *= 40.0
    jxo, txo = _both(xo)
    assert_allclose(tops.quantized_matmul_outlier(txo, tw, threshold=6.0),
                    jops.quantized_matmul_outlier(jxo, jw, threshold=6.0),
                    rtol=1e-5, atol=1e-5)
