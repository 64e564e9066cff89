"""Data x model training (qgemm_tpu_torch/parallel/sharding.py's
``shard_model``, ``shard_batch``; the differentiable collectives of
parallel/collectives.py) in a world of 4 over gloo, on make_mesh((2, 2))
and ((1, 4)), against the JAX package's unsharded ``value_and_grad`` on the
same weights and batch (JAX's test_sharded_training_step_matches_unsharded
holds its GSPMD-sharded step to the same). Ports the intent of
tests/test_parallel.py:49-96.

Each rank trains its local model on its ``shard_batch`` slice; its loss is
the mean over its rows, the global loss the mean of the ranks'
(``data_mean``). After ``loss.backward()`` every parameter's ``.grad``
must be the rank's slice of JAX's gradient (rtol 1e-4, atol 1e-5: JAX's
test), the loss JAX's (rtol 1e-5), and after one SGD step (lr 0.01) the
parameters JAX's ``sgd_step`` result (rtol 1e-5, atol 1e-6: the gradient's
difference times the rate). A planted fault (the gradient hooks of the
data axis doing nothing) must fail the gradient check on (2, 2).

Also: ``model_sharding_spec`` gives JAX's specs for a float Transformer's
leaves and a float MoE GPT's (experts on E); the sharded checkpoints of a
float GPT and Transformer on (2, 2) round-trip and hold the keys and bytes
of JAX's ``save_checkpoint_sharded`` of its ``shard_model``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from qgemm_tpu.models.gpt import GPT as JGPT
from qgemm_tpu.models.gpt import GPTConfig as JConfig
from qgemm_tpu.models.optim import sgd_step as j_sgd
from qgemm_tpu.models.transformer import Transformer as JTransformer
from qgemm_tpu.models.transformer import TransformerConfig as JTConfig
from qgemm_tpu.ops.cross_entropy import cross_entropy_loss as j_ce
from qgemm_tpu.parallel.mesh import make_mesh as j_make_mesh
from qgemm_tpu.parallel.sharding import model_sharding_spec as j_spec
from qgemm_tpu.parallel.sharding import shard_model as j_shard_model
from qgemm_tpu.utils.checkpoint import _path_key
from qgemm_tpu.utils.checkpoint import save_checkpoint_sharded as j_save_sharded
from qgemm_tpu_torch.models.gpt import GPTConfig
from qgemm_tpu_torch.models.transformer import TransformerConfig
from qgemm_tpu_torch.parallel.sharding import model_sharding_spec
from qgemm_tpu_torch.utils.interop import gpt_from_jax_params, transformer_from_jax_params
from qgemm_tpu_torch.utils.testing import assert_allclose, run_world, use_test_threads
from test_torch_gpt import jax_params
from torch_parallel_workers import _slice_like, train_worker
from torch_tp_workers import results

use_test_threads()

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

CFG = dict(vocab_size=64, d_model=16, n_heads=4, d_ff=32, n_layers=1, max_seq_len=16)
GPT_CFG = dict(vocab_size=64, d_model=32, n_heads=4, d_ff=64, n_layers=2, max_seq_len=32)
MESHES = [(2, 2), (1, 4)]
LR = 0.01
RNG = np.random.default_rng(5)
BATCH = {"src": RNG.integers(0, 64, (4, 6)), "tgt_in": RNG.integers(0, 64, (4, 5)),
         "tgt_out": RNG.integers(0, 64, (4, 5))}
SB_X = np.arange(24, dtype=np.float32).reshape(8, 3)
SB_Y = np.arange(8, dtype=np.int64)


def _jmodel():
    return JTransformer.init(JTConfig(**CFG), key=jax.random.PRNGKey(0))


def _jgpt():
    return JGPT.init(JConfig(**GPT_CFG), key=jax.random.PRNGKey(9))


@pytest.fixture(scope="module")
def jax_step():
    """JAX's unsharded loss, gradients and SGD step, path-keyed numpy."""
    jm = _jmodel()
    b = {k: jnp.asarray(v, jnp.int32) for k, v in BATCH.items()}

    def loss_fn(m):
        logits = m.forward(b["src"], b["tgt_in"])
        return j_ce(logits.reshape(-1, CFG["vocab_size"]), b["tgt_out"].reshape(-1))
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jm)
    return float(loss), jax_params(grads), jax_params(j_sgd(jm, grads, LR))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_training")
    inp = {"params": jax_params(_jmodel()), "cfg": CFG, "batch": BATCH, "meshes": MESHES,
           "lr": LR, "sb_x": SB_X, "sb_y": SB_Y, "gpt": jax_params(_jgpt()),
           "gpt_cfg": GPT_CFG}
    run_world(train_worker, 4, str(d), str(d), inp)
    return d, results(str(d), "train", 4)


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_training_step_matches_jax(ranks, jax_step, shape):
    loss, grads, updated = jax_step
    for r, res in enumerate(ranks[1]):
        out = res[shape]
        assert_allclose(out["loss"], loss, rtol=1e-5, atol=1e-6, msg=f"{shape} rank {r}")
        assert set(out["grads"]) == set(grads)
        mr = out["model_rank"]
        for name, g in out["grads"].items():
            want = _slice_like(grads[name], g, mr)
            assert_allclose(g, want, rtol=1e-4, atol=1e-5, msg=f"{shape} rank {r} {name}")
            assert_allclose(out["updated"][name], _slice_like(updated[name], g, mr),
                            rtol=1e-5, atol=1e-6, msg=f"{shape} rank {r} {name} after SGD")


@pytest.mark.parametrize("shape", MESHES)
def test_layers_really_sharded(ranks, shape):
    """The QKV, FFN-up and head weights hold 1/p of the columns, W_O and
    FFN-down 1/p of the rows (p the model axis), LayerNorms whole."""
    p = shape[1]
    s = ranks[1][0][shape]["local_shapes"]
    assert s["enc_blocks/0/attn/wqkv_q/w"] == (16, 16 // p)
    assert s["enc_blocks/0/attn/w_o/w"] == (16 // p, 16)
    assert s["dec_blocks/0/ffn/up/w"] == (16, 32 // p)
    assert s["dec_blocks/0/ffn/up/b"] == (32 // p,)
    assert s["dec_blocks/0/ffn/down/w"] == (32 // p, 16)
    assert s["lm_head/w"] == (16, 64 // p)
    assert s["ln_dec/gamma"] == (16,)


def test_planted_data_grad_skip_is_caught(ranks, jax_step):
    _, grads, _ = jax_step
    for res in ranks[1]:
        mr = res[(2, 2)]["model_rank"]
        worst = max(np.abs(g - _slice_like(grads[n], g, mr)).max()
                    for n, g in res["fault_data_grad"].items())
        assert worst > 1e-3, worst


def test_shard_batch_gives_the_data_rows(ranks):
    """On (2, 2) ranks 0, 1 hold rows 0-3, ranks 2, 3 rows 4-7 (the data
    axis leads); a batch of 3 rows raises."""
    for r, res in enumerate(ranks[1]):
        rows = slice(4 * (r // 2), 4 * (r // 2) + 4)
        np.testing.assert_array_equal(res["shard_batch"]["x"], SB_X[rows])
        np.testing.assert_array_equal(res["shard_batch"]["y"], SB_Y[rows])
        assert res["shard_batch_indivisible_raises"]


def _jax_spec(jm):
    return {_path_key(p): tuple(s) for p, s in jax.tree_util.tree_flatten_with_path(
        j_spec(jm), is_leaf=lambda x: isinstance(x, P))[0]}


@pytest.mark.parametrize("kind", ["transformer", "gpt", "moe_gpt"])
def test_float_sharding_spec_matches_jax(kind):
    if kind == "transformer":
        jm = _jmodel()
        model = transformer_from_jax_params(jax_params(jm), TransformerConfig(**CFG),
                                            device="cpu")
    else:
        cfg = dict(GPT_CFG, **({"n_experts": 4} if kind == "moe_gpt" else {}))
        jm = JGPT.init(JConfig(**cfg), key=jax.random.PRNGKey(9))
        model = gpt_from_jax_params(jax_params(jm), GPTConfig(**cfg), device="cpu")
    spec, jspec = model_sharding_spec(model), _jax_spec(jm)
    assert spec == jspec
    if kind == "moe_gpt":
        assert spec["blocks/0/ffn/w_up"] == spec["blocks/0/ffn/w_down"] == ("model", None, None)
        assert spec["blocks/0/ffn/router_w"] == ()
    else:
        assert spec["lm_head/w"] == (None, "model")


def _union(d, name):
    out = {}
    for r in range(4):
        with np.load(d / name / f"proc{r}.npz") as f:
            for k in f.files:
                if k in out:
                    assert np.array_equal(out[k], f[k]), k
                out[k] = f[k]
    return out


@pytest.mark.parametrize("kind", ["transformer", "gpt"])
def test_float_sharded_checkpoints_match_jax(ranks, kind):
    d, res = ranks
    assert all(r[f"ckpt_{kind}"]["exact"] for r in res)
    jm = _jmodel() if kind == "transformer" else _jgpt()
    jdir = d / f"jax_{kind}"
    j_save_sharded(str(jdir), j_shard_model(jm, j_make_mesh((2, 2), ("data", "model"))))
    got = _union(d, f"ckpt_{kind}")
    with np.load(jdir / "proc0.npz") as f:
        want = {k: f[k] for k in f.files}
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
