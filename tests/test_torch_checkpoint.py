"""Port parity: qgemm_tpu_torch/utils/checkpoint.py writes and reads the
``.npz`` of qgemm_tpu/utils/checkpoint.py (save_checkpoint /
load_checkpoint): a checkpoint the port saves loads into the JAX package
bit for bit, and the reverse, for float32, bf16, int8 and int4 models. The
two packages' files for one model hold the same keys, dtypes and bytes."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from qgemm_tpu.models.gpt import GPT as JGPT
from qgemm_tpu.models.gpt import GPTConfig as JConfig
from qgemm_tpu.utils.checkpoint import _path_key
from qgemm_tpu.utils.checkpoint import load_checkpoint as j_load
from qgemm_tpu.utils.checkpoint import save_checkpoint as j_save
from qgemm_tpu_torch.models.gpt import GPT, GPTConfig
from qgemm_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from qgemm_tpu_torch.utils.interop import gpt_from_jax_params, gpt_leaves
from qgemm_tpu_torch.utils.testing import use_test_threads

use_test_threads()

CFG = dict(vocab_size=40, d_model=32, n_heads=4, d_ff=64, n_layers=2, max_seq_len=16)
KINDS = ["float32", "bfloat16", "int8", "int4"]


def _jax_model(kind):
    dtype = "bfloat16" if kind == "bfloat16" else "float32"
    cfg = JConfig(**CFG, dtype=dtype)
    m = JGPT.init(cfg, key=jax.random.PRNGKey(3))
    if kind == "int8":
        m = m.quantize()
    elif kind == "int4":
        m = m.quantize(bits=4)
    return m, GPTConfig(**CFG, dtype=dtype)


def _jax_leaves(m):
    return {_path_key(p): np.asarray(jax.device_get(leaf))
            for p, leaf in jax.tree_util.tree_flatten_with_path(m)[0]}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.dtype(f"u{a.dtype.itemsize}")) if a.dtype.kind in "fV" else a


@pytest.mark.parametrize("kind", KINDS)
def test_port_checkpoint_loads_in_jax_bit_for_bit(kind, tmp_path):
    jm, cfg = _jax_model(kind)
    j_save(str(tmp_path / "jax.npz"), jm)
    with np.load(tmp_path / "jax.npz") as f:
        model = gpt_from_jax_params(dict(f), cfg, device="cpu")
    save_checkpoint(str(tmp_path / "port.npz"), model)
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    back = j_load(str(tmp_path / "port.npz"), jm)
    want, got = _jax_leaves(jm), _jax_leaves(back)
    assert list(want) == list(got)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(_bits(got[key]), _bits(want[key]), err_msg=key)


@pytest.mark.parametrize("kind", KINDS)
def test_jax_checkpoint_loads_in_port_bit_for_bit(kind, tmp_path):
    jm, cfg = _jax_model(kind)
    j_save(str(tmp_path / "jax.npz"), jm)
    template = GPT.init(dataclasses.replace(cfg, dtype="float32"), seed=9, device="cpu")
    if kind in ("int8", "int4"):
        template = template.quantize(bits=4 if kind == "int4" else 8)
    model = load_checkpoint(str(tmp_path / "jax.npz"), template)
    assert isinstance(model, GPT) and model.device.type == "cpu"
    want = _jax_leaves(jm)
    got = gpt_leaves(model)
    assert list(got) == list(want)
    for key, t in got.items():
        t = t.detach()
        a = (t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16
             else t.numpy())
        np.testing.assert_array_equal(_bits(a), _bits(want[key]), err_msg=key)
    tokens = np.arange(12, dtype=np.int32).reshape(2, 6) % CFG["vocab_size"]
    j_logits = np.asarray(jm.forward(tokens).astype(np.float32))
    with torch.no_grad():
        t_logits = model.forward(torch.from_numpy(tokens)).float().numpy()
    np.testing.assert_allclose(t_logits, j_logits, rtol=2e-2 if kind == "bfloat16" else 1e-4,
                               atol=2e-2 if kind == "bfloat16" else 1e-5)


def test_load_checkpoint_checks_leaves(tmp_path):
    model = GPT.init(GPTConfig(**CFG), seed=0, device="cpu")
    path = str(tmp_path / "m.npz")
    save_checkpoint(path, model)
    other = GPT.init(GPTConfig(**dict(CFG, n_layers=1)), seed=0, device="cpu")
    with pytest.raises(ValueError, match="extra leaves"):
        load_checkpoint(path, other)
    with pytest.raises(KeyError, match="missing leaf"):
        load_checkpoint(path, GPT.init(GPTConfig(**dict(CFG, n_layers=3)), seed=0,
                                       device="cpu"))
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, GPT.init(GPTConfig(**dict(CFG, d_ff=32)), seed=0,
                                       device="cpu"))


# ------------------------------------------------- every tree: MLP, Transformer
MLP_DIMS = [24, 16, 10]
S2S = dict(vocab_size=40, d_model=32, n_heads=4, d_ff=64, n_layers=2, max_seq_len=16)
TREE_KINDS = ["float32", "int8", "int4"]


def _quantized(m, kind):
    return m.quantize(bits=4) if kind == "int4" else m.quantize() if kind == "int8" else m


def _jax_tree(tree, kind):
    """A JAX MLP or Transformer of ``kind`` and a port template of the same
    structure (other weights)."""
    if tree == "mlp":
        from qgemm_tpu.models.mlp import MLP as JMLP
        from qgemm_tpu_torch.models.mlp import MLP
        jm = JMLP.init(jax.random.PRNGKey(5), MLP_DIMS)
        template = MLP.init(9, MLP_DIMS, device="cpu")
    else:
        from qgemm_tpu.models.transformer import Transformer as JTransformer
        from qgemm_tpu.models.transformer import TransformerConfig as JS2S
        from qgemm_tpu_torch.models.transformer import Transformer, TransformerConfig
        jm = JTransformer.init(JS2S(**S2S), key=jax.random.PRNGKey(5))
        template = Transformer.init(TransformerConfig(**S2S), seed=9, device="cpu")
    return _quantized(jm, kind), _quantized(template, kind)


def _port_leaves(model):
    from qgemm_tpu_torch.utils.interop import mlp_leaves, transformer_leaves
    from qgemm_tpu_torch.models.mlp import MLP
    leaves = mlp_leaves(model) if isinstance(model, MLP) else transformer_leaves(model)
    return {k: v.detach().numpy() for k, v in leaves.items()}


@pytest.mark.parametrize("kind", TREE_KINDS)
@pytest.mark.parametrize("tree", ["mlp", "transformer"])
def test_any_tree_round_trips_across_packages(tree, kind, tmp_path):
    """A JAX checkpoint loads into the port bit for bit; the port's file of
    that model holds the JAX file's keys, dtypes and bytes and loads back
    into the JAX package; the port's own round trip keeps every leaf."""
    jm, template = _jax_tree(tree, kind)
    j_save(str(tmp_path / "jax.npz"), jm)
    model = load_checkpoint(str(tmp_path / "jax.npz"), template)
    assert type(model) is type(template) and model.device.type == "cpu"
    want = _jax_leaves(jm)
    got = _port_leaves(model)
    assert list(got) == list(want)
    for key, a in got.items():
        np.testing.assert_array_equal(_bits(a), _bits(want[key]), err_msg=key)
    save_checkpoint(str(tmp_path / "port.npz"), model)
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    back = _jax_leaves(j_load(str(tmp_path / "port.npz"), jm))
    for key in want:
        np.testing.assert_array_equal(_bits(back[key]), _bits(want[key]), err_msg=key)
    again = _port_leaves(load_checkpoint(str(tmp_path / "port.npz"), template))
    for key in got:
        np.testing.assert_array_equal(again[key], got[key], err_msg=key)


def test_mlp_checkpoint_keeps_template_meta_and_checks_leaves(tmp_path):
    from qgemm_tpu_torch.models.mlp import MLP
    model = MLP.init(1, MLP_DIMS, remat=True, device="cpu")
    path = str(tmp_path / "m.npz")
    save_checkpoint(path, model)
    back = load_checkpoint(path, MLP.init(2, MLP_DIMS, remat=True, device="cpu"))
    assert back.remat and torch.equal(back.layers[1].w, model.layers[1].w)
    q = model.quantize(outlier_threshold=6.0)
    save_checkpoint(path, q)
    back = load_checkpoint(path, MLP.init(2, MLP_DIMS, device="cpu").quantize(
        outlier_threshold=6.0))
    assert all(l.outlier_threshold == 6.0 for l in back.layers)
    with pytest.raises(KeyError, match="missing leaf"):
        load_checkpoint(path, MLP.init(2, MLP_DIMS + [3], device="cpu").quantize())
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, MLP.init(2, [24, 8, 10], device="cpu").quantize())


def test_unknown_tree_raises(tmp_path):
    path = str(tmp_path / "m.npz")
    with pytest.raises(TypeError, match="no checkpoint layout for Linear"):
        save_checkpoint(path, torch.nn.Linear(3, 2))
    save_checkpoint(path, GPT.init(GPTConfig(**CFG), seed=0, device="cpu"))
    with pytest.raises(TypeError, match="no checkpoint layout"):
        load_checkpoint(path, {"embed/table": torch.zeros(1)})
