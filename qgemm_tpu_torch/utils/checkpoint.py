"""Checkpoint / resume (port of the single-file flavor of
``qgemm_tpu/utils/checkpoint.py``).

A checkpoint is one ``.npz`` keyed by JAX pytree path (``embed/table``,
``blocks/0/attn/wqkv_q/w``, ``lm_head/wq/q``, ``layers/0/b``), bf16 leaves
stored as uint16 bits beside a ``<key>.__dtype__`` tag: the file the JAX
package's ``save_checkpoint`` writes for the same model, so each package
loads the other's. The tree is any of the port's models — ``GPT``,
``Transformer`` or ``MLP``, float, int8 or int4; another tree raises
``TypeError``. The sharded flavor waits for the parallel slice.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, NamedTuple, Union

import numpy as np
import torch
from torch import nn

from qgemm_tpu_torch.models.gpt import GPT
from qgemm_tpu_torch.models.linear import QuantizedLinear
from qgemm_tpu_torch.models.mlp import MLP
from qgemm_tpu_torch.models.transformer import Transformer
from qgemm_tpu_torch.utils.interop import (DTYPE_TAG, gpt_from_jax_params, gpt_leaves,
                                           mlp_from_jax_params, mlp_leaves,
                                           to_numpy_leaves, transformer_from_jax_params,
                                           transformer_leaves)

Model = Union[GPT, Transformer, MLP]


class _Tree(NamedTuple):
    leaves: Callable[[nn.Module], Dict[str, torch.Tensor]]
    # (path-keyed numpy leaves, template) -> a new model of the template's
    # structure on its device
    build: Callable[[Dict[str, np.ndarray], nn.Module], nn.Module]


def _outliers(template: nn.Module) -> dict:
    """The outlier options of the template's quantized linears (meta
    fields, which a checkpoint does not hold)."""
    quantized = [m for m in template.modules() if isinstance(m, QuantizedLinear)]
    return ({} if not quantized else
            dict(outlier_threshold=quantized[0].outlier_threshold,
                 outlier_capacity=quantized[0].outlier_capacity))


_TREES = {
    GPT: _Tree(gpt_leaves, lambda p, t: gpt_from_jax_params(p, t.cfg, device=t.device,
                                                            **_outliers(t))),
    Transformer: _Tree(transformer_leaves,
                       lambda p, t: transformer_from_jax_params(p, t.cfg, device=t.device)),
    MLP: _Tree(mlp_leaves, lambda p, t: mlp_from_jax_params(p, device=t.device,
                                                            remat=t.remat, **_outliers(t))),
}


def _tree(model) -> _Tree:
    tree = _TREES.get(type(model))
    if tree is None:
        raise TypeError(f"no checkpoint layout for {type(model).__name__}: expected one of "
                        f"{', '.join(t.__name__ for t in _TREES)}")
    return tree


def save_checkpoint(path: str, model: Model) -> None:
    """Write every leaf of ``model`` into one .npz keyed by its path.
    Atomic (tmp + rename)."""
    arrays: Dict[str, np.ndarray] = {}
    for key, t in _tree(model).leaves(model).items():
        arrays.update(to_numpy_leaves(key, t))
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str, template: Model) -> Model:
    """Restore into the structure of ``template``: every leaf of the
    template must be in the file with the template's shape, and the file
    may hold no other leaf. Returns a new model of the template's type and
    config on its device (quantized linears keep the template's outlier
    options, an MLP its ``remat``), with the file's dtypes."""
    tree = _tree(template)
    want = tree.leaves(template)
    with np.load(path) as data:
        files = set(data.files)
        for key, t in want.items():
            if key not in files:
                raise KeyError(f"checkpoint {path} missing leaf {key}")
            if tuple(data[key].shape) != tuple(t.shape):
                raise ValueError(f"{key}: checkpoint shape {tuple(data[key].shape)} "
                                 f"!= model {tuple(t.shape)}")
        extra = {f for f in files - set(want)
                 if not (f.endswith(DTYPE_TAG) and f[:-len(DTYPE_TAG)] in want)}
        if extra:
            raise ValueError(f"checkpoint has extra leaves: {sorted(extra)[:5]}")
        params = {f: data[f] for f in files}
    return tree.build(params, template)
