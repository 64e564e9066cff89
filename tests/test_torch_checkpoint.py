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
