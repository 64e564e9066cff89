"""Sequence parallelism (qgemm_tpu_torch/parallel/ring_attention.py,
ulysses.py) in worlds of 2 and 4 over gloo, against the JAX package's ring
and Ulysses attention on make_mesh((p,), ("seq",)) on the same numpy
inputs. Ports the intent of tests/test_ring_attention.py.

Each rank holds its shard of the sequence (``shard_sequence``); its loss
is sum(out^2) over its shard, so the ranks' losses add to the global one
and each rank's dq, dk, dv must be its shard of JAX's gradients.
Tolerances: the ring's output 2e-5 and its gradients 1e-4 (JAX's ring
tests: blocks merged by logsumexp in f32), Ulysses' output 1e-5 and its
gradients rtol 1e-4, atol 1e-5 (JAX's: the same full-sequence attention
per head group). A sequence that does not divide the axis raises, and so
do heads that do not divide it (Ulysses). At p = 2 two planted faults
must fail: a future block treated as visible (the causal output), and
the backward run against each block's own logsumexp (the gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qgemm_tpu.parallel.mesh import make_mesh as j_make_mesh
from qgemm_tpu.parallel.ring_attention import ring_attention as j_ring
from qgemm_tpu.parallel.ulysses import ulysses_attention as j_ulysses
from qgemm_tpu_torch.utils.testing import assert_allclose, run_world, use_test_threads
from torch_parallel_workers import seq_worker
from torch_tp_workers import results

use_test_threads()

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

RNG = np.random.default_rng(23)
RING = tuple(RNG.normal(size=(2, 2, 32, 8)).astype(np.float32) for _ in range(3))
ULYSSES = tuple(RNG.normal(size=(1, 4, 32, 16)).astype(np.float32) for _ in range(3))
ODD_S, ODD_H = 33, 3
FAULTS = ("ring_future_visible", "ring_block_local_lse")

_RUNS = {}


def _run(p, tmp_path_factory):
    if p not in _RUNS:
        d = str(tmp_path_factory.mktemp(f"seq{p}"))
        run_world(seq_worker, p, d, d, {"ring": RING, "ulysses": ULYSSES, "odd_s": ODD_S,
                                        "odd_h": ODD_H})
        _RUNS[p] = results(d, "seq", p)
    return p, _RUNS[p]


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory):
    return _run(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _run(2, tmp_path_factory)


_REFS = {}


def _jax(fn_name, p, causal):
    """JAX's output and gradients of sum(out^2) on the whole sequence."""
    key = (fn_name, p, causal)
    if key not in _REFS:
        mesh = j_make_mesh((p,), ("seq",))
        fn = {"ring": j_ring, "ulysses": j_ulysses}[fn_name]
        inputs = RING if fn_name == "ring" else ULYSSES
        f = lambda q, k, v: fn(q, k, v, mesh=mesh, causal=causal)
        loss = lambda q, k, v: jnp.sum(f(q, k, v) ** 2)
        args = tuple(jnp.asarray(a) for a in inputs)
        out = jax.jit(f)(*args)
        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)
        _REFS[key] = [np.asarray(out)] + [np.asarray(g) for g in grads]
    return _REFS[key]


def _gather(ranks, key, i):
    """The ranks' shards of item i of ``key``, joined on the sequence."""
    return np.concatenate([res[key][i] for res in ranks], axis=2)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_jax_ring(world, causal):
    p, ranks = world
    want = _jax("ring", p, causal)
    assert_allclose(_gather(ranks, f"ring_{causal}", 0), want[0], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_gradients_match_jax(world, causal):
    p, ranks = world
    want = _jax("ring", p, causal)
    for i, name in enumerate(("dq", "dk", "dv"), start=1):
        assert_allclose(_gather(ranks, f"ring_{causal}", i), want[i], rtol=1e-4, atol=1e-4,
                        msg=f"{name} p={p} causal={causal}")


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax(world, causal):
    p, ranks = world
    want = _jax("ulysses", p, causal)
    key = f"ulysses_{causal}"
    assert_allclose(_gather(ranks, key, 0), want[0], rtol=1e-5, atol=1e-5)
    for i in (1, 2, 3):
        assert_allclose(_gather(ranks, key, i), want[i], rtol=1e-4, atol=1e-5)


def test_ring_shift_moves_forward_and_its_gradient_back(world):
    """``collectives.ring_shift`` (ppermute r -> r + 1): rank r receives
    rank r - 1's tensor, and the gradient of rank r's tensor is the weight
    rank r + 1 put on it."""
    p, ranks = world
    for r, res in enumerate(ranks):
        y, g = res["ring_shift"]
        np.testing.assert_array_equal(y, np.full(3, (r - 1) % p, np.float32))
        np.testing.assert_array_equal(g, np.full(3, 10.0 + (r + 1) % p, np.float32))


def test_indivisible_sequence_and_heads_raise(world):
    p, ranks = world
    for res in ranks:
        assert f"seq len {ODD_S}" in res["indivisible_raises"]
        assert "n_heads" in res["odd_heads_raises"]


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_ring_faults_are_caught(world2, fault):
    """The future block visible moves the causal output; the block-local
    logsumexp the gradients (each far past the tolerances above)."""
    _, ranks = world2
    want = _jax("ring", 2, True)
    items = (0,) if fault == "ring_future_visible" else (1, 2, 3)
    worst = max(np.abs(_gather(ranks, fault, i) - want[i]).max() for i in items)
    assert worst > 1e-2, worst
