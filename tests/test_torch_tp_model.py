"""The tensor-parallel models (``with_tp`` of qgemm_tpu_torch/models/linear.py,
attention.py, gpt.py): this rank's GPT, run in worlds of 2 and 4 over gloo,
against the unsharded port (1e-4: the SUM adds the ranks' f32 partials in
another order) and against JAX's tensor-sharded GPT on make_mesh((1, p))
(2e-3, test_torch_gpt.py's quantized tolerance: the two packages' LayerNorm
outputs may differ in the last bit and flip an activation code). Ports the
intent of tests/test_parallel.py:99-172 and test_gqa.py:162-181,
test_moe.py:226-260.

Row-parallel W4A8 is no function of the unsharded layer at these widths:
K4 quantizes the activation per K slab of min(2048, K) columns, and a
rank's K/p columns are a narrower slab than the whole layer's (JAX's
tp_w4a8_matmul_row has the same grid). The W4A8 model is held to JAX's
tensor-sharded model instead, and to the unsharded one only where no row
layer is sharded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qgemm_tpu.models.gpt import GPT as JGPT
from qgemm_tpu.models.gpt import GPTConfig as JConfig
from qgemm_tpu.parallel.mesh import make_mesh as j_make_mesh
from qgemm_tpu.parallel.sharding import shard_quantized_model as j_shard
from qgemm_tpu_torch.parallel.sharding import model_sharding_spec
from qgemm_tpu_torch.utils.interop import gpt_from_jax_params
from qgemm_tpu_torch.models.gpt import GPTConfig
from qgemm_tpu_torch.utils.testing import assert_allclose, run_world, use_test_threads
from test_torch_gpt import jax_params
from torch_tp_workers import model_worker, results

use_test_threads()

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

BASE = dict(vocab_size=96, d_model=32, n_heads=4, d_ff=64, n_layers=2, max_seq_len=64)
# name -> (config overrides, quantize options)
CASES = {
    "int8": ({}, {}),
    "gqa": ({"n_kv_heads": 2}, {}),
    "outlier": ({}, {"outlier_threshold": 1.0, "outlier_capacity": 4}),
    "w4a8": ({"d_model": 256, "d_ff": 512}, {"bits": 4}),
    "moe": ({"n_experts": 4}, {}),
    "odd_vocab": ({"vocab_size": 97}, {}),
}
TOKS = np.random.default_rng(11).integers(0, 96, size=(2, 7)).astype(np.int64)


def _jax_model(name):
    over, qkw = CASES[name]
    cfg = dict(BASE, **over)
    return JGPT.init(JConfig(**cfg), key=jax.random.PRNGKey(3)).quantize(**qkw), cfg, qkw


def _cases():
    out = {}
    for name in CASES:
        jm, cfg, qkw = _jax_model(name)
        outliers = {k: v for k, v in qkw.items() if k.startswith("outlier")}
        out[name] = (jax_params(jm), cfg, outliers, TOKS)
    return out


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory):
    p = request.param
    d = str(tmp_path_factory.mktemp(f"tp_model{p}"))
    run_world(model_worker, p, d, d, _cases())
    return p, results(d, "model", p)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tp_forward_matches_unsharded_port(world, name):
    """Every rank's logits equal the unsharded model's to 1e-4 (W4A8: see
    the module note), and equal each other's bit for bit (the gathered
    head: the same full logits)."""
    p, ranks = world
    attn, ffn, _, _ = _expected(name, p)
    for res in ranks:
        if not (name == "w4a8" and (attn or ffn)):
            assert_allclose(res[name]["got"], res[name]["want"], rtol=1e-4, atol=1e-4,
                            msg=f"{name} p={p}")
        np.testing.assert_array_equal(res[name]["got"], ranks[0][name]["got"])


def _expected(name, p):
    """(sharded attention?, sharded FFN?, sharded head?) at p, and the
    collectives of one forward."""
    over, qkw = CASES[name]
    cfg = dict(BASE, **over)
    hkv = cfg.get("n_kv_heads") or cfg["n_heads"]
    attn = cfg["n_heads"] % p == 0 and hkv % p == 0
    ffn = "n_experts" not in cfg
    if qkw.get("bits") == 4:   # row shards need whole 128-row groups per rank
        attn = attn and (cfg["d_model"] // 128) % p == 0
        ffn = ffn and (cfg["d_ff"] // 128) % p == 0
    head = cfg["vocab_size"] % p == 0
    rows = cfg["n_layers"] * (attn + ffn)
    # an MoE block's experts sharded over the axis: one SUM of the partials
    experts = cfg["n_layers"] * int(cfg.get("n_experts", 1) % p == 0 and not ffn)
    int8 = qkw.get("bits", 8) == 8 or "outlier_threshold" in qkw
    return attn, ffn, head, dict(all_reduce_max=rows if int8 else 0,
                                 all_reduce_sum=rows + experts,
                                 all_gather=int(head) + ("outlier_threshold" in qkw) * rows)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tp_layers_sharded_and_collectives_counted(world, name):
    """Megatron's pairing where the shapes divide p, whole layers where
    they do not; 4 all-reduces a dense block (a MAX and a SUM after W_O and
    after FFN-down), 3 an MoE block (a MAX and a SUM after W_O, the
    experts' SUM: the experts sharded), one gather a forward
    (the head), plus one gather of column maxima a row layer with
    outliers."""
    p, ranks = world
    attn, ffn, head, counts = _expected(name, p)
    for res in ranks:
        modes, c = res[name]["modes"], res[name]["counts"]
        assert modes["q"] == ("column" if attn else "none")
        assert modes["o"] == ("row" if attn else "none")
        assert modes["up"] == ("moe" if "n_experts" in CASES[name][0]
                               else "column" if ffn else "none")
        assert modes["head"] == ("column" if head else "none")
        cfg = dict(BASE, **CASES[name][0])
        assert modes["heads"] == cfg["n_heads"] // (p if attn else 1)
        for kind, n in counts.items():
            assert c[kind] == n, (name, p, c)


@pytest.mark.parametrize("name", ["int8", "gqa", "moe", "w4a8"])
def test_tp_forward_matches_jax_tp_forward(world, name):
    """The port's local GPT against JAX's shard_quantized_model on
    make_mesh((1, p)) on the same int8 weights."""
    p, ranks = world
    jm = _jax_model(name)[0]
    jms = j_shard(jm, j_make_mesh((1, p), ("data", "model")))
    want = np.asarray(jax.jit(lambda m, t: m.forward(t))(jms, jnp.asarray(TOKS, jnp.int32)))
    assert_allclose(ranks[0][name]["got"], want, rtol=2e-3, atol=2e-3)


def test_sharding_spec_matches_jax_rules():
    """model_sharding_spec, read from the containers' TP_PLAN and each
    mode's leaf specs (those the sharded checkpoints key by), gives JAX's
    PartitionSpecs (as tuples) for every leaf of a dense int8, a W4A8 (row
    layers' group scales sharded), a GQA and an MoE GPT (the expert leaves
    sharded on E, the router replicated)."""
    from jax.sharding import PartitionSpec as P

    from qgemm_tpu.parallel.sharding import model_sharding_spec as j_spec
    from qgemm_tpu.utils.checkpoint import _path_key
    for name in ("int8", "w4a8", "gqa", "moe"):
        jm, cfg, _ = _jax_model(name)
        jspec = {_path_key(p): s for p, s in jax.tree_util.tree_flatten_with_path(
            j_spec(jm), is_leaf=lambda x: isinstance(x, P))[0]}
        spec = model_sharding_spec(gpt_from_jax_params(jax_params(jm), GPTConfig(**cfg),
                                                       device="cpu"))
        assert set(spec) == set(jspec), name
        for k, s in spec.items():
            assert s == tuple(jspec[k]), (name, k)
        if name == "moe":
            assert spec["blocks/0/ffn/w_up/q"] == ("model", None, None)
            assert spec["blocks/0/ffn/router_w"] == ()
            assert spec["blocks/0/attn/wqkv_q/wq/q"] == (None, "model")
        elif name != "w4a8":   # int8 row layers' scales stay whole
            assert spec["blocks/0/attn/w_o/wq/c"] == ()


class _Mesh:
    """The two DeviceMesh reads of ``with_tp`` (its axis size and this
    rank's coordinate), for slicing checks without a process group."""
    mesh_dim_names = ("data", "model")

    def __init__(self, p, r):
        self.p, self.r = p, r

    def size(self, dim):
        return (1, self.p)[dim]

    def get_local_rank(self, axis):
        return self.r


def test_with_tp_slices_each_ranks_shard_and_refuses_float():
    """Rank r's layers hold block r of the columns (QKV, FFN-up, the head:
    codes, scales and the bias kept sharded) or of K (W_O, FFN-down: whole
    scales and bias); a W4A8 row layer whose true K is unknown stays whole.
    A float model, refused before float sharding was ported, is sliced the
    same way (its weights and the kept-sharded bias) for training."""
    import torch

    from qgemm_tpu_torch.models.gpt import GPT
    from qgemm_tpu_torch.models.linear import Linear
    cfg = GPTConfig(**BASE)
    fl = GPT.init(cfg, device="cpu")
    for r in range(2):
        local = fl.with_tp(_Mesh(2, r))
        a, fa = local.blocks[0].attn, fl.blocks[0].attn
        assert (a.wqkv_q.tp_mode, a.w_o.tp_mode) == ("column", "row")
        assert torch.equal(a.wqkv_q.w, fa.wqkv_q.w[:, 16 * r:16 * (r + 1)])
        assert torch.equal(a.w_o.w, fa.w_o.w[16 * r:16 * (r + 1)])
        f, ff = local.blocks[0].ffn, fl.blocks[0].ffn
        assert torch.equal(f.up.b, ff.up.b[32 * r:32 * (r + 1)])
        assert torch.equal(f.down.b, ff.down.b)
        assert local.lm_head.w.shape == (32, 48) and local.lm_head.gather_output
        assert all(p.requires_grad for p in local.parameters())
    full = GPT.init(cfg, device="cpu").quantize()
    for r in range(2):
        local = full.with_tp(_Mesh(2, r))
        a, fa = local.blocks[0].attn, full.blocks[0].attn
        assert (a.n_heads, a.kv_heads) == (2, 2)
        assert torch.equal(a.wqkv_q.qt, fa.wqkv_q.qt[16 * r:16 * (r + 1)])
        assert torch.equal(a.wqkv_q.c, fa.wqkv_q.c[:, 16 * r:16 * (r + 1)])
        assert torch.equal(a.w_o.qt, fa.w_o.qt[:, 16 * r:16 * (r + 1)])
        assert torch.equal(a.w_o.c, fa.w_o.c) and a.w_o.in_features == 16
        f, ff = local.blocks[0].ffn, full.blocks[0].ffn
        assert torch.equal(f.up.b, ff.up.b[32 * r:32 * (r + 1)])
        assert torch.equal(f.down.b, ff.down.b)
        assert local.lm_head.out_features == 96 and local.lm_head.qt.shape[0] == 48
    lin = Linear.init(torch.Generator().manual_seed(0), 256, 8).quantize(bits=4)
    assert lin.tp_shardable("row", 2)
    lin.in_features = 0
    assert not lin.tp_shardable("row", 2) and lin.with_tp("row", _Mesh(2, 1)) is lin
