"""Sharding rules (port of ``qgemm_tpu/parallel/sharding.py``).

Megatron tensor parallelism over the ``model`` axis. Each container of
linear layers states its pairing as ``TP_PLAN`` (``models/linear.py``):
  * QKV projections: column-sharded (the heads split across ranks);
  * output projection W_O: row-sharded (one SUM after its partial);
  * FFN up: column-sharded; FFN down: row-sharded;
  * lm_head: column-sharded over the vocabulary, output gathered;
  * MoE experts: the expert dimension sharded (``parallel/expert.py``),
    the router replicated;
  * embeddings, LayerNorms, row layers' biases and per-column scales:
    replicated. A column layer's scales follow its columns.
Activations are batch-sharded over ``data`` (``shard_batch``).
A spec is a tuple with ``"model"`` at the sharded dimension (``()`` =
replicated), JAX's ``PartitionSpec`` as a tuple; a layer's leaves get
theirs from its mode (``tp_leaf_specs``, the MoE layer's ``leaf_specs``),
which the sharded checkpoints read too.

JAX places every leaf of a model by these rules and lets GSPMD insert the
collectives; the port has no global array, so each rank holds its local
model, each layer sliced by ``with_tp`` (Megatron's pairing, with its
divisibility rules: a layer whose dimension does not divide stays whole
and replicated, as JAX replicates such a leaf):
  * ``shard_quantized_model`` — serving: the explicit collectives of
    ``tp_ops.py`` around the int8 and W4A8 kernels;
  * ``shard_model`` — training a float model on a ``("data", "model")``
    mesh: a copy of the model sharded the same way, its layers running
    the differentiable collectives of ``collectives.py`` (Megatron's f and
    g), and on every trainable parameter a gradient hook that averages the
    gradient over the ``data`` axis. The contract is GSPMD's: with each
    rank's loss the mean over its ``shard_batch`` slice, after
    ``loss.backward()`` every parameter's ``.grad`` is the rank's slice of
    the gradient of the global-batch loss (the mean of the ranks' losses,
    ``data_mean``), so ``models/optim.py``'s steps run unchanged.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
from qgemm_tpu_torch.models.linear import QuantizedLinear, tp_leaf_specs
from qgemm_tpu_torch.parallel.mesh import axis_rank, axis_size

Spec = Tuple


def _owner(path: str, owners: Dict[str, object]) -> Tuple[object, str]:
    """The longest prefix of ``path`` that names one of ``owners`` -> (that
    owner, the rest of the path: the leaf's name in it), or (None, path)."""
    parts = path.split("/")
    for i in range(len(parts) - 1, 0, -1):
        owner = owners.get("/".join(parts[:i]))
        if owner is not None:
            return owner, "/".join(parts[i:])
    return None, path


def model_sharding_spec(model) -> Dict[str, Spec]:
    """Path -> spec for every leaf of an (unsharded) GPT or Transformer,
    float or quantized: a layer its container's ``TP_PLAN`` names gets the
    specs of that mode, an MoE FFN's expert leaves their expert dimension
    (``expert_leaf_specs``), every other leaf (the router too) is
    replicated."""
    from qgemm_tpu_torch.models.moe import MoEFeedForward, expert_leaf_specs
    from qgemm_tpu_torch.utils.checkpoint import tree_leaves
    modules = dict(model.named_modules())
    planned = {}
    for name, mod in modules.items():
        if isinstance(mod, MoEFeedForward):
            planned[name.replace(".", "/")] = expert_leaf_specs(mod.is_quantized)
        for attr, (mode, gather) in getattr(mod, "TP_PLAN", {}).items():
            path = f"{name}.{attr}" if name else attr
            lin = modules[path]
            bits = lin.bits if isinstance(lin, QuantizedLinear) else None
            planned[path.replace(".", "/")] = tp_leaf_specs(mode, gather, bits)
    out = {}
    for path in tree_leaves(model):
        specs, leaf = _owner(path, planned)
        out[path] = (specs or {}).get(leaf, ())
    return out


def _data_grad_hook(mesh, axis: str = "data"):
    """The gradient hook of a parameter under ``shard_model``: the gradient
    averaged over ``axis`` (one SUM, then / dp)."""
    from qgemm_tpu_torch.parallel import tp_ops
    dp = axis_size(mesh, axis)

    def hook(g: torch.Tensor) -> torch.Tensor:
        return tp_ops.all_reduce_sum_(g.contiguous().clone(), mesh, axis).div_(dp)
    return hook


def shard_model(model, mesh):
    """This rank's model for data x model training on a ``("data",
    "model")`` mesh: a copy of ``model`` (float GPT or Transformer; the
    caller's model is left as it is), sharded over ``model`` by ``with_tp``
    (the layers' differentiable collectives), every trainable parameter
    with a hook that averages its gradient over ``data``. Train it on the
    rank's ``shard_batch`` slice; see the module note for the contract."""
    local = copy.deepcopy(model).with_tp(mesh, "model")
    for prm in local.parameters():
        if prm.requires_grad:
            prm.register_hook(_data_grad_hook(mesh))
    return local


def _rows(x, dp: int, r: int, axis: str):
    n = x.shape[0]
    if n % dp:
        raise ValueError(f"batch of {n} rows does not divide the {dp} ranks of {axis!r}")
    blk = n // dp
    if isinstance(x, torch.Tensor):
        return x.narrow(0, r * blk, blk)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)[r * blk:(r + 1) * blk]))


def shard_batch(batch, mesh, axis: str = "data"):
    """This rank's rows of every array of ``batch`` (a tensor or numpy
    array, or a dict, list or tuple of them): block r of the leading
    (batch) dimension, r the rank's coordinate on ``axis``; numpy arrays
    become tensors. A batch that does not divide the axis raises."""
    dp, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh, axis) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh, axis) for v in batch)
    return _rows(batch, dp, r, axis)


def data_mean(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """The mean of ``x`` over ``axis`` (no gradient): the global-batch loss
    from the ranks' losses on equal slices."""
    from qgemm_tpu_torch.parallel import tp_ops
    with torch.no_grad():
        return tp_ops.all_reduce_sum_(x.detach().clone(), mesh, axis) / axis_size(mesh, axis)


def shard_quantized_model(model, mesh, axis: str = "model"):
    """This rank's model of a quantized GPT or Transformer:
    ``model.with_tp(mesh, axis)``, every sharded layer holding only its
    shard (a layer whose dimension does not divide the axis stays whole;
    an MoE FFN holds the rank's experts). Serve it with the engines'
    ``mesh=mesh``."""
    return model.with_tp(mesh, axis)


def _heads(t: torch.Tensor, p: int, r: int) -> torch.Tensor:
    """Rank r's heads (dim 1) of a cache leaf, or the leaf whole where its
    head count does not divide the axis."""
    h = t.shape[1]
    if h % p:
        return t
    return t.narrow(1, r * (h // p), h // p).contiguous()


def shard_kv_caches(caches, mesh, axis: str = "model"):
    """Rank r's heads of every dense cache leaf [B, H, S, *] (float (k, v)
    pairs or ``QuantizedKVCache``s, and the cross K/V tuples): the heads
    its column-sharded K/V projections produce."""
    p, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    def one(c):
        leaves = [_heads(t, p, r) for t in c]
        return type(c)(*leaves) if hasattr(c, "_fields") else tuple(leaves)
    return [one(c) for c in caches]


def shard_paged_caches(caches, mesh, axis: str = "model"):
    """Rank r's heads of every paged pool [P, H, page, *]; page and step
    tables whole (paging is the same on every rank), ``kv_bits`` kept."""
    p, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    return [dataclasses.replace(c, kq=_heads(c.kq, p, r), kc=_heads(c.kc, p, r),
                                vq=_heads(c.vq, p, r), vc=_heads(c.vc, p, r))
            for c in caches]
