"""Sharding rules of the serving models (port of the serving part of
``qgemm_tpu/parallel/sharding.py``).

Megatron tensor parallelism over the ``model`` axis. Each container of
quantized layers states its pairing as ``TP_PLAN`` (``models/linear.py``):
  * QKV projections: column-sharded (the heads split across ranks);
  * output projection W_O: row-sharded (one SUM after its partial);
  * FFN up: column-sharded; FFN down: row-sharded;
  * lm_head: column-sharded over the vocabulary, output gathered;
  * embeddings, LayerNorms, row layers' biases and per-column scales:
    replicated. A column layer's scales follow its columns.
A spec is a tuple with ``"model"`` at the sharded dimension (``()`` =
replicated), JAX's ``PartitionSpec`` as a tuple; a layer's leaves get
theirs from its mode (``tp_leaf_specs``), which the sharded checkpoints
read too.

JAX places every leaf of a model by these rules; the port has no global
array, so ``shard_quantized_model`` returns this rank's local model, each
layer sliced by ``with_tp`` (Megatron's pairing, with its divisibility
rules). An MoE FFN keeps its experts whole on every rank (the
expert-sharded layout comes with expert parallelism); float sharding for
training (``shard_model``, ``shard_batch``) is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from qgemm_tpu_torch.models.linear import QuantizedLinear, layer_leaf, tp_leaf_specs
from qgemm_tpu_torch.parallel.mesh import axis_rank, axis_size

Spec = Tuple


def model_sharding_spec(model) -> Dict[str, Spec]:
    """Path -> spec for every leaf of an (unsharded) quantized GPT or
    Transformer: a layer its container's ``TP_PLAN`` names gets the specs
    of that mode, every other leaf (MoE experts too) is replicated."""
    from qgemm_tpu_torch.utils.checkpoint import tree_leaves
    modules = dict(model.named_modules())
    planned = {}
    for name, mod in modules.items():
        for attr, (mode, gather) in getattr(mod, "TP_PLAN", {}).items():
            path = f"{name}.{attr}" if name else attr
            if not isinstance(modules[path], QuantizedLinear):
                raise TypeError("model_sharding_spec covers quantized models (float "
                                "sharding for training is not ported)")
            planned[path.replace(".", "/")] = tp_leaf_specs(mode, gather, modules[path].bits)
    out = {}
    for path in tree_leaves(model):
        owner, leaf = layer_leaf(path)
        out[path] = planned.get(owner, {}).get(leaf, ())
    return out


def shard_quantized_model(model, mesh, axis: str = "model"):
    """This rank's model of a quantized GPT or Transformer:
    ``model.with_tp(mesh, axis)``, every sharded layer holding only its
    shard (a layer whose dimension does not divide the axis stays whole).
    Serve it with the engines' ``mesh=mesh``."""
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
