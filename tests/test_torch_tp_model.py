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
layer is sharded. Against JAX it is held code by code: each row layer's
activation codes on each rank must equal JAX's, but for codes whose value
before rounding lies, in both packages, within ``W4A8_TIE_EPS`` of a
rounding boundary (k + 1/2). At p 2 one such tie exists on these inputs:
block 0's W_O row layer, rank 0, batch 1, position 4, column 102, where
the port's value is 33.5000000 (rounded to 34, half to even) and JAX's
33.4999962 (rounded to 33); every other value of that layer agrees to
3.8e-5. A flipped code moves its row, and, through the next blocks'
attention, the later positions of its sequence, by ~1e-2 at d_model 256:
the logits are compared at 2e-3 on the rows no differing code reaches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qgemm_tpu.models.gpt import GPT as JGPT
from qgemm_tpu.models.gpt import GPTConfig as JConfig
from qgemm_tpu.parallel import tp_ops as j_tp_ops
from qgemm_tpu.parallel.mesh import make_mesh as j_make_mesh
from qgemm_tpu.parallel.sharding import shard_quantized_model as j_shard
from qgemm_tpu_torch.ops.quantize import GROUP, w4a8_slab
from qgemm_tpu_torch.parallel.sharding import model_sharding_spec
from qgemm_tpu_torch.utils.interop import gpt_from_jax_params
from qgemm_tpu_torch.models.gpt import GPTConfig
from qgemm_tpu_torch.utils.testing import (activation_code_ties, activation_values,
                                           assert_allclose, run_world, use_test_threads)
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


# a W4A8 activation code may differ between the packages only where both
# values before rounding lie within this many code steps of k + 1/2 (the
# values that round alike agree to 3.8e-5 on these inputs)
W4A8_TIE_EPS = 1e-3


def _jax_forward(name, p, record=None):
    """JAX's shard_quantized_model on make_mesh((1, p)), its forward jitted
    over TOKS. With ``record`` (a list), the global input of each
    row-parallel W4A8 layer, in call order, is appended to it."""
    jm = _jax_model(name)[0]
    jms = j_shard(jm, j_make_mesh((1, p), ("data", "model")))
    orig, seen = j_tp_ops.tp_w4a8_matmul_row, {}

    def recorded(x, *args, **kw):
        i = len(seen)   # the layer's place in the trace
        seen[i] = None
        jax.debug.callback(lambda v, i=i: seen.__setitem__(i, np.asarray(v, np.float32)), x)
        return orig(x, *args, **kw)

    if record is not None:
        j_tp_ops.tp_w4a8_matmul_row = recorded
    try:
        want = np.asarray(jax.jit(lambda m, t: m.forward(t))(jms, jnp.asarray(TOKS, jnp.int32)))
        jax.effects_barrier()
    finally:
        j_tp_ops.tp_w4a8_matmul_row = orig
    if record is not None:
        record += [seen[i] for i in sorted(seen)]
    return want


@pytest.fixture(scope="module")
def jax_w4a8(world):
    """JAX's W4A8 logits and its row layers' global inputs, at the world's p."""
    rows = []
    return _jax_forward("w4a8", world[0], rows), rows


def _slab(x: np.ndarray) -> int:
    """K4's activation slab for a (local) input of x's width: all of K up
    to 2048 (``w4a8_slab``)."""
    return w4a8_slab(-(-x.shape[1] // GROUP) * GROUP)


def _w4a8_values(ranks, jax_rows, p: int, global_grid: bool = False):
    """Both packages' row-layer values, [layer][rank]; ``global_grid``
    computes the port's on each row's whole-K absmax instead of its
    slab's (a wrong grid, planted)."""
    port, jax_ = [], []
    for li, xj in enumerate(jax_rows):
        xs = [ranks[r]["w4a8"]["w4a8_row_x"][li] for r in range(p)]
        kl = xs[0].shape[1]
        if global_grid:
            c = np.maximum(np.abs(np.concatenate(xs, axis=1)).max(axis=1, keepdims=True),
                           np.float32(1e-12))
            port.append([x * (np.float32(127) / c) for x in xs])
        else:
            port.append([activation_values(x, _slab(x)) for x in xs])
        xj = xj.reshape(-1, xj.shape[-1])
        jax_.append([activation_values(xj[:, r * kl:(r + 1) * kl], _slab(xs[0]))
                     for r in range(p)])
    return port, jax_


@pytest.mark.parametrize("name", ["int8", "gqa", "moe", "w4a8"])
def test_tp_forward_matches_jax_tp_forward(world, name, request):
    """The port's local GPT against JAX's shard_quantized_model on
    make_mesh((1, p)) on the same int8 weights. W4A8: its row layers'
    activation codes against JAX's (``activation_code_ties``: equal but
    for ties within ``W4A8_TIE_EPS``), then the logits on the rows that no
    tie reaches, at least half of them."""
    p, ranks = world
    got = ranks[0][name]["got"]
    if name != "w4a8":
        assert_allclose(got, _jax_forward(name, p), rtol=2e-3, atol=2e-3)
        return
    want, jax_rows = request.getfixturevalue("jax_w4a8")
    assert len(jax_rows) == len(ranks[0][name]["w4a8_row_x"]) > 0
    reached, _ = activation_code_ties(*_w4a8_values(ranks, jax_rows, p), TOKS.shape[1],
                                      W4A8_TIE_EPS)
    keep = ~reached
    assert keep.sum() * 2 >= keep.size, (p, keep)
    vocab = got.shape[-1]
    assert_allclose(got.reshape(-1, vocab)[keep], want.reshape(-1, vocab)[keep], rtol=2e-3,
                    atol=2e-3)


def test_w4a8_code_check_catches_a_wrong_slab_grid(world, jax_w4a8):
    """The code check fails when the port's row layers quantize on each
    row's whole-K grid (the int8 row layers' global grid) instead of their
    slab's: the fault the W4A8 row path must not have."""
    p, ranks = world
    port, jax_ = _w4a8_values(ranks, jax_w4a8[1], p, global_grid=True)
    with pytest.raises(AssertionError, match="not at a rounding tie"):
        activation_code_ties(port, jax_, TOKS.shape[1], W4A8_TIE_EPS)


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
