"""GPipe (qgemm_tpu_torch/parallel/pipeline.py) in worlds of 2 and 4 over
gloo, against the JAX package's sequential forward and gradients on the
same weights and inputs. Ports the intent of tests/test_pipeline.py.

(stages, microbatches) in {(2, 4), (4, 4), (4, 8)}: the logits within
2e-5 of JAX's ``model.forward`` (JAX's own tolerance); the gradients of
sum(y^2) through ``pipeline_apply`` on each rank's blocks within 1e-4 of
JAX's sequential gradients of those blocks (JAX's); the int8 GPT over
four stages within 2e-4 of JAX's jitted int8 forward (JAX's). At p = 2 a
planted fault (the last stage collecting one tick early) must fail.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qgemm_tpu.models.gpt import GPT as JGPT
from qgemm_tpu.models.gpt import GPTConfig as JConfig
from qgemm_tpu_torch.utils.testing import assert_allclose, run_world, use_test_threads
from test_torch_gpt import jax_params
from torch_parallel_workers import pipe_worker
from torch_tp_workers import results

use_test_threads()

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

CFG = dict(vocab_size=61, d_model=16, n_heads=2, d_ff=32, n_layers=4, max_seq_len=16)
Q_CFG = dict(vocab_size=64, d_model=32, n_heads=4, d_ff=64, n_layers=4, max_seq_len=32)
RNG = np.random.default_rng(1)
TOKENS = RNG.integers(0, CFG["vocab_size"], (8, 12))
Q_TOKENS = RNG.integers(0, 64, (8, 8))
X = RNG.normal(size=(8, 6, CFG["d_model"])).astype(np.float32)
MICRO = {2: (4,), 4: (4, 8)}


def _jmodel():
    return JGPT.init(JConfig(**CFG), key=jax.random.PRNGKey(0))


def _jq():
    return JGPT.init(JConfig(**Q_CFG), key=jax.random.PRNGKey(11)).quantize()


_RUNS = {}


def _run(p, tmp_path_factory):
    if p not in _RUNS:
        d = str(tmp_path_factory.mktemp(f"pipe{p}"))
        run_world(pipe_worker, p, d, d, {
            "cfg": CFG, "params": jax_params(_jmodel()), "tokens": TOKENS, "micro": MICRO[p],
            "q_cfg": Q_CFG, "q_params": jax_params(_jq()), "q_tokens": Q_TOKENS, "x": X})
        _RUNS[p] = results(d, "pipe", p)
    return p, _RUNS[p]


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory):
    return _run(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def jax_refs():
    jm = _jmodel()
    logits = np.asarray(jax.jit(lambda m, t: m.forward(t))(jm, jnp.asarray(TOKENS, jnp.int32)))

    def loss(blocks):
        h = jnp.asarray(X)
        for b in blocks:
            h = b(h)
        return jnp.sum(h ** 2)
    grads = jax.jit(jax.grad(loss))(jm.blocks)
    g = {f"blocks/{k}": v for k, v in jax_params(grads).items()}
    q = np.asarray(jax.jit(lambda m, t: m.forward(t))(_jq(), jnp.asarray(Q_TOKENS, jnp.int32)))
    return logits, g, q


@pytest.mark.parametrize("stages,micro", [(2, 4), (4, 4), (4, 8)])
def test_pipeline_matches_sequential(tmp_path_factory, jax_refs, stages, micro):
    _, ranks = _run(stages, tmp_path_factory)
    for res in ranks:
        assert_allclose(res[f"logits_{micro}"], jax_refs[0], rtol=2e-5, atol=2e-5,
                        msg=f"{stages} stages, {micro} microbatches")


def test_pipeline_gradients_match_sequential(world, jax_refs):
    """Every rank's blocks get JAX's sequential gradients; the ranks hold
    disjoint blocks that cover the model."""
    p, ranks = world
    seen = set()
    for res in ranks:
        for name, g in res["grads"].items():
            assert_allclose(g, jax_refs[1][name], rtol=1e-4, atol=1e-4, msg=f"{name} p={p}")
            seen.add(name.split("/")[1])
        np.testing.assert_array_equal(res["y"], ranks[0]["y"])
    assert seen == {str(i) for i in range(CFG["n_layers"])}


def test_pipeline_int8_gpt_matches_single_device(world, jax_refs):
    p, ranks = world
    for res in ranks:
        assert_allclose(res["int8"], jax_refs[2], rtol=2e-4, atol=2e-4, msg=f"p={p}")


def test_planted_tick_fault_is_caught(tmp_path_factory, jax_refs):
    _, ranks = _run(2, tmp_path_factory)
    for res in ranks:
        assert np.abs(res["fault_tick"] - jax_refs[0]).max() > 1e-2
