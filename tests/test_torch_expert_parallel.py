"""Expert parallelism (qgemm_tpu_torch/parallel/expert.py) and the
expert-sharded MoE GPT under a mesh, in worlds of 2 and 4 over gloo,
against the JAX package on the same numpy-seeded weights and inputs
(the JAX references run once, in this process, on the 8 virtual devices).
Ports the intent of tests/test_moe.py:75-108, :196-262.

Tolerances and their reasons:
- ``ep_moe_forward``, float and int8, against the whole layer and JAX's
  EP: atol 1e-5 (the layer's own parity tolerance, test_torch_moe.py);
  against the port's whole layer bit for bit (the same index dispatch,
  the other ranks' slots dropped; a SUM of one nonzero partial per
  choice);
- ``ep_moe_forward_a2a`` against JAX's a2a: 2e-4 float, 2e-2 int8 (JAX's
  own a2a test), at capacity 8.0 and at a binding capacity, where the
  choices dropped per source rank equal JAX's;
- the EP training step's gradients against JAX's whole layer's: rtol
  1e-4 (f32 sums in other orders; the partial router gradients summed
  across ranks);
- the MoE GPT's engines under the mesh, dense and paged: transcripts
  equal the unsharded engine's exactly (as test_moe.py:226 asserts).
A planted fault (the experts' slots taken at the neighbour rank's offset)
must fail the forward check at p = 2. At p = 2 the expert-sharded GPT's
sharded checkpoint round-trips and its ranks' files hold JAX's
``save_checkpoint_sharded`` keys and bytes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qgemm_tpu.models import moe as jmoe
from qgemm_tpu.models.gpt import GPT as JGPT
from qgemm_tpu.models.gpt import GPTConfig as JConfig
from qgemm_tpu.parallel.expert import ep_moe_forward as j_ep
from qgemm_tpu.parallel.expert import ep_moe_forward_a2a as j_a2a
from qgemm_tpu.parallel.expert import shard_moe as j_shard_moe
from qgemm_tpu.parallel.mesh import make_mesh as j_make_mesh
from qgemm_tpu.parallel.sharding import shard_quantized_model as j_shard
from qgemm_tpu.utils.checkpoint import save_checkpoint_sharded as j_save_sharded
from qgemm_tpu_torch.utils.testing import assert_allclose, run_world, use_test_threads
from test_torch_gpt import jax_params
from torch_parallel_workers import ep_worker
from torch_tp_workers import results

use_test_threads()

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

D, F, E = 32, 64, 8
RNG = np.random.default_rng(17)
X = RNG.normal(size=(24, D)).astype(np.float32)
X_A2A = RNG.normal(size=(64, D)).astype(np.float32)
A2A_CFS = {"roomy": 8.0, "binding": 0.5}
GPT_CFG = dict(vocab_size=64, d_model=32, n_heads=4, d_ff=64, n_layers=2, max_seq_len=128,
               n_experts=4, moe_top_k=2)
PROMPTS, N_NEW = [[1 + i, 2, 3] for i in range(3)], [5, 5, 5]


def _jmoe(cf=1.25, quantize=False):
    m = jmoe.MoEFeedForward.init(jax.random.PRNGKey(0), D, F, n_experts=E, top_k=2,
                                 capacity_factor=cf)
    return m.quantize() if quantize else m


def _jgpt():
    return JGPT.init(JConfig(**GPT_CFG), key=jax.random.PRNGKey(30)).quantize()


def _inputs():
    return {"x": X, "x_a2a": X_A2A, "a2a_cfs": A2A_CFS,
            "moe_float": jax_params(_jmoe()), "moe_int8": jax_params(_jmoe(quantize=True)),
            "gpt": jax_params(_jgpt()), "gpt_cfg": GPT_CFG, "prompts": PROMPTS,
            "n_new": N_NEW}


_RUNS = {}


def _run(p, tmp_path_factory):
    """(workdir, the ranks' results) of the world of p, spawned once."""
    if p not in _RUNS:
        d = tmp_path_factory.mktemp(f"ep{p}")
        run_world(ep_worker, p, str(d), str(d), _inputs())
        _RUNS[p] = (d, results(str(d), "ep", p))
    return (p,) + _RUNS[p]


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory):
    return _run(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The world of 2: the checks made at p = 2 only."""
    return _run(2, tmp_path_factory)


def _mesh(p):
    return j_make_mesh((p,), ("expert",))


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_ep_forward_matches_whole_layer_and_jax_ep(world, kind):
    p, _, ranks = world
    jm = _jmoe(quantize=kind == "int8")
    mesh = _mesh(p)
    whole = np.asarray(jax.jit(lambda m, x: m(x))(jm, jnp.asarray(X)))
    jep = np.asarray(jax.jit(lambda m, x: j_ep(x, m, mesh))(jm, jnp.asarray(X)))
    for res in ranks:
        assert res[f"n_local_{kind}"] == E // p
        got = res[f"dense_{kind}"]
        assert_allclose(got, whole, rtol=0, atol=1e-5, msg=f"{kind} p={p} vs whole")
        assert_allclose(got, jep, rtol=0, atol=1e-5, msg=f"{kind} p={p} vs JAX EP")
        # a whole layer passed in runs the rank's slice of it: the same bits
        np.testing.assert_array_equal(res[f"dense_{kind}_whole_arg"], got)
        np.testing.assert_array_equal(got, ranks[0][f"dense_{kind}"])


def _jax_source_drops(jm, p):
    """JAX's choices dropped per source rank: each source routes its T/p
    tokens at the capacity of T/p tokens."""
    t = X_A2A.shape[0] // p
    cap = jmoe._capacity(t, E, jm.top_k, jm.capacity_factor)
    out = []
    for r in range(p):
        dispatch, _ = jmoe.route(jnp.asarray(X_A2A[r * t:(r + 1) * t]), jm.router_w,
                                 jm.top_k, cap)
        out.append(t * jm.top_k - int(np.asarray(dispatch).sum()))
    return out


@pytest.mark.parametrize("cf_name", sorted(A2A_CFS))
@pytest.mark.parametrize("kind", ["float", "int8"])
def test_ep_a2a_matches_jax_a2a(world, cf_name, kind):
    p, _, ranks = world
    mesh = _mesh(p)
    jm = _jmoe(A2A_CFS[cf_name], quantize=kind == "int8")
    want = np.asarray(jax.jit(lambda m, x: j_a2a(x, m, mesh))(j_shard_moe(jm, mesh),
                                                             jnp.asarray(X_A2A)))
    tol = 2e-4 if kind == "float" else 2e-2
    got = np.concatenate([res[f"a2a_{cf_name}_{kind}"] for res in ranks])
    assert_allclose(got, want, rtol=tol, atol=tol, msg=f"{cf_name} {kind} p={p}")
    drops = [res[f"a2a_{cf_name}_drops"] for res in ranks]
    assert drops == _jax_source_drops(jm, p)
    if cf_name == "binding":
        assert sum(drops) > 0          # the capacity really binds
    else:
        assert sum(drops) == 0


def test_ep_training_gradients_match_whole_layer(world):
    """Every rank's gradients (router whole, its experts' block of w_up and
    w_down) equal its slice of JAX's whole-layer gradients of mean(out^2);
    the backward SUMs the router's and the tokens' partial gradients."""
    p, _, ranks = world
    jm = _jmoe()
    loss, grads = jax.jit(jax.value_and_grad(lambda m: jnp.mean(m(jnp.asarray(X)) ** 2)))(jm)
    n = E // p
    for r, res in enumerate(ranks):
        assert_allclose(res["loss"], float(loss), rtol=1e-5, atol=0)
        g = res["grads"]
        assert_allclose(g["router_w"], np.asarray(grads.router_w), rtol=1e-4, atol=1e-7)
        for name in ("w_up", "w_down"):
            want = np.asarray(getattr(grads, name))[r * n:(r + 1) * n]
            assert_allclose(g[name], want, rtol=1e-4, atol=1e-7, msg=f"{name} rank {r}")
        # the partials' SUM (g) forward, the router's partial gradients'
        # SUM (f) backward; the tokens here need no gradient
        assert res["train_collectives"]["all_reduce_sum"] == 2


def test_planted_expert_offset_is_caught(world2):
    _, _, ranks = world2
    whole = np.asarray(jax.jit(lambda m, x: m(x))(_jmoe(), jnp.asarray(X)))
    for res in ranks:
        err = np.abs(res["fault_expert_offset"] - whole).max()
        assert err > 1e-2, err


def test_moe_gpt_engine_under_mesh_matches_unsharded(world):
    """The MoE GPT served under make_mesh((1, p)) with each block holding
    its 4/p experts: dense and paged transcripts equal the unsharded
    engine's; a decode step runs a MAX and a SUM after W_O, the experts'
    SUM, in each of 2 layers, and the head's gather."""
    p, _, ranks = world
    for res in ranks:
        assert res["gpt_ffn_mode"] == "expert"
        assert res["gpt_local_experts"] == [4 // p] * 2
        for name in ("dense", "paged"):
            assert res[f"engine_{name}"] == res[f"engine_{name}_want"], name
            assert all(len(t) == n for t, n in zip(res[f"engine_{name}"], N_NEW))
        c = res["step_collectives"]
        assert (c["all_reduce_max"], c["all_reduce_sum"], c["all_gather"]) == (2, 4, 1), c


def _union(d, name, p):
    out = {}
    for r in range(p):
        with np.load(d / name / f"proc{r}.npz") as f:
            for k in f.files:
                if k in out:
                    assert np.array_equal(out[k], f[k]), k
                out[k] = f[k]
    return out


def test_expert_sharded_checkpoint_matches_jax(world2):
    _, d, ranks = world2
    assert all(res["ckpt"]["exact"] for res in ranks)
    jdir = d / "jax_ckpt"
    j_save_sharded(str(jdir), j_shard(_jgpt(), j_make_mesh((1, 2), ("data", "model"))))
    got = _union(d, "ckpt", 2)
    with np.load(jdir / "proc0.npz") as f:
        want = {k: f[k] for k in f.files}
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert "blocks/0/ffn/w_up/q@2:4,0:32,0:64" in got       # rank 1's experts
    assert "blocks/0/ffn/router_w@0:32,0:4" in got

