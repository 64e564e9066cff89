"""Checkpoint / resume (port of the single-file flavor of
``qgemm_tpu/utils/checkpoint.py``).

A checkpoint is one ``.npz`` keyed by JAX pytree path (``embed/table``,
``blocks/0/attn/wqkv_q/w``, ``lm_head/wq/q``, ``layers/0/b``), bf16 leaves
stored as uint16 bits beside a ``<key>.__dtype__`` tag: the file the JAX
package's ``save_checkpoint`` writes for the same model, so each package
loads the other's. The tree is any of the port's models — ``GPT``,
``Transformer`` or ``MLP``, float, int8 or int4; another tree raises
``TypeError``.

The sharded flavor (``save_checkpoint_sharded``/``load_checkpoint_sharded``)
serves tensor-parallel models: rank r writes ``proc{r}.npz`` holding its
shards of its local model (``parallel.sharding.shard_quantized_model``, or
``shard_model`` for a float one; an MoE FFN's experts by their block),
keyed as JAX keys a shard, by the global path and its global ``start:stop``
span per dimension (``blocks/0/attn/wqkv_q/wq/q@0:64,32:64``); replicated
leaves go under their whole span on every rank. The union of the ranks'
files holds the keys and bytes of JAX's ``save_checkpoint_sharded`` on the
same mesh, and loading needs the saving topology.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, NamedTuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from qgemm_tpu_torch.models.gpt import GPT
from qgemm_tpu_torch.models.linear import QuantizedLinear
from qgemm_tpu_torch.models.mlp import MLP
from qgemm_tpu_torch.models.transformer import Transformer
from qgemm_tpu_torch.utils.interop import (DTYPE_TAG, gpt_from_jax_params, gpt_leaves,
                                           mlp_from_jax_params, mlp_leaves, to_numpy_leaves,
                                           to_tensor, transformer_from_jax_params,
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


def tree_leaves(model: Model) -> Dict[str, torch.Tensor]:
    """Every leaf of ``model`` keyed by its JAX pytree path, as tensors."""
    return _tree(model).leaves(model)


def _shard_key(path: str, t: torch.Tensor, layer, leaf: str) -> str:
    """JAX's shard key: the path and the leaf's global span per dimension.
    A leaf of a sharded layer spans rank r's block along the dimension the
    layer's mode shards (``tp_leaf_specs``, an MoE layer's expert
    dimension); any other leaf spans its whole shape."""
    from qgemm_tpu_torch.parallel.mesh import axis_rank
    shape = tuple(t.shape)
    spec = layer.leaf_specs.get(leaf, ()) if layer is not None else ()
    r = axis_rank(layer.mesh, layer.tp_axis) if spec else 0
    spans = []
    for d, n in enumerate(shape):
        start = r * n if d < len(spec) and spec[d] is not None else 0
        spans.append(f"{start}:{start + n}")
    return f"{path}@{','.join(spans)}"


def _shard_keys(model: Model) -> Dict[str, str]:
    """Leaf path -> shard key for every leaf of a local model: each leaf's
    span from the layer that owns it (a linear layer, float or quantized,
    or an MoE FFN), by the layer's mode."""
    from qgemm_tpu_torch.parallel.sharding import _owner
    layers = {name.replace(".", "/"): m for name, m in model.named_modules()
              if hasattr(m, "leaf_specs")}
    return {path: _shard_key(path, t, *_owner(path, layers))
            for path, t in tree_leaves(model).items()}


def _process_file(dirpath: str) -> str:
    rank = dist.get_rank() if dist.is_initialized() else 0
    return os.path.join(dirpath, f"proc{rank}.npz")


def save_checkpoint_sharded(dirpath: str, model: Model) -> None:
    """Rank r writes its local model's shards to ``dirpath/proc{r}.npz``
    (r the rank in the default process group, 0 without one), each under
    its shard key. Atomic (tmp + rename)."""
    os.makedirs(dirpath, exist_ok=True)
    leaves = tree_leaves(model)
    arrays: Dict[str, np.ndarray] = {}
    for path, key in _shard_keys(model).items():
        arrays.update(to_numpy_leaves(key, leaves[path]))
    path = _process_file(dirpath)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_checkpoint_sharded(dirpath: str, template: Model) -> Model:
    """Read this rank's ``proc{r}.npz`` into ``template``, a local model of
    the saving topology (``shard_quantized_model`` of a fresh model):
    every leaf's values are copied into the template's tensors in place,
    and the template is returned. A shard the file lacks (another
    topology) raises ``KeyError``."""
    leaves = tree_leaves(template)
    with np.load(_process_file(dirpath)) as data:
        files = set(data.files)
        for path, key in _shard_keys(template).items():
            if key not in files:
                raise KeyError(f"{dirpath}: no shard {key} — checkpoint topology differs "
                               "from template; reshard via load_checkpoint")
            t = leaves[path]
            with torch.no_grad():
                t.copy_(to_tensor(data, key, t.device))
    return template
