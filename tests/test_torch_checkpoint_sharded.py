"""Sharded checkpoints (qgemm_tpu_torch/utils/checkpoint.py,
``save_checkpoint_sharded``/``load_checkpoint_sharded``): in a world of 2
over gloo each rank writes its local model's shards to ``proc{r}.npz``. The
union of the ranks' files holds the keys and bytes of JAX's
``save_checkpoint_sharded`` of the same int8 model on make_mesh((1, 2)); a
round trip is exact; a template of another topology raises ``KeyError``
with JAX's message. Also ``shard_kv_caches``: each rank's heads."""

import jax
import numpy as np
import pytest

from qgemm_tpu.models.gpt import GPT as JGPT
from qgemm_tpu.models.gpt import GPTConfig as JConfig
from qgemm_tpu.parallel.mesh import make_mesh as j_make_mesh
from qgemm_tpu.parallel.sharding import shard_quantized_model as j_shard
from qgemm_tpu.utils.checkpoint import save_checkpoint_sharded as j_save_sharded
from qgemm_tpu_torch.utils.testing import run_world, use_test_threads
from test_torch_gpt import jax_params
from torch_tp_workers import checkpoint_worker, kv_cache_worker, results

use_test_threads()

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

CFG = dict(vocab_size=96, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, n_layers=2,
           max_seq_len=32, dtype="bfloat16")


def _tagged(params):
    """bf16 leaves as their uint16 bits beside a dtype tag, as a checkpoint
    stores them (torch reads no numpy bfloat16)."""
    out = {}
    for k, v in params.items():
        if v.dtype.kind == "V":
            out[k + ".__dtype__"] = np.array(str(v.dtype))
            v = v.view(np.uint16)
        out[k] = v
    return out


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    jm = JGPT.init(JConfig(**CFG), key=jax.random.PRNGKey(21)).quantize()
    d = tmp_path_factory.mktemp("ckpt_sharded")
    run_world(checkpoint_worker, 2, str(d), str(d), _tagged(jax_params(jm)), CFG)
    jdir = d / "jax"
    j_save_sharded(str(jdir), j_shard(jm, j_make_mesh((1, 2), ("data", "model"))))
    return d, jdir, results(str(d), "ckpt", 2)


def _union(d):
    out = {}
    for r in range(2):
        with np.load(d / "ckpt" / f"proc{r}.npz") as f:
            for k in f.files:
                v = f[k]
                if k in out:   # a replicated leaf: the same bytes on every rank
                    assert np.array_equal(out[k], v), k
                out[k] = v
    return out


def test_union_of_ranks_equals_jax_sharded_checkpoint(saved):
    d, jdir, _ = saved
    got = _union(d)
    with np.load(jdir / "proc0.npz") as f:
        want = {k: f[k] for k in f.files}
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    # sharded leaves really are split: rank 0 holds the first half of the columns
    assert "blocks/0/attn/wqkv_q/wq/q@0:32,0:16" in got
    assert "blocks/0/attn/w_o/wq/q@16:32,0:32" in got


def test_sharded_round_trip_is_exact(saved):
    for res in saved[2]:
        assert res["exact"] and res["same_logits"]


def test_other_topology_raises_key_error(saved):
    for res in saved[2]:
        assert "checkpoint topology differs from template" in res["mismatch"]


def test_shard_kv_caches_keeps_each_ranks_heads(tmp_path):
    """Dense caches [B, H, S, D] split on H; a head count that does not
    divide the axis stays whole."""
    rng = np.random.default_rng(0)
    caches = [(rng.normal(size=(2, 4, 5, 3)).astype(np.float32),
               rng.normal(size=(2, 3, 5, 3)).astype(np.float32))]
    run_world(kv_cache_worker, 2, str(tmp_path), str(tmp_path), caches)
    for r, local in enumerate(results(str(tmp_path), "kv", 2)):
        np.testing.assert_array_equal(local[0][0], caches[0][0][:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(local[0][1], caches[0][1])
