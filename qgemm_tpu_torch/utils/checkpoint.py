"""Checkpoint / resume (port of the single-file flavor of
``qgemm_tpu/utils/checkpoint.py``).

A checkpoint is one ``.npz`` keyed by JAX pytree path (``embed/table``,
``blocks/0/attn/wqkv_q/w``, ``lm_head/wq/q``), bf16 leaves stored as uint16
bits beside a ``<key>.__dtype__`` tag: the file the JAX package's
``save_checkpoint`` writes for the same model, so each package loads the
other's. The tree is the port's ``GPT`` (float, int8 or int4). The sharded
flavor waits for the parallel slice.
"""

from __future__ import annotations

import os

import numpy as np

from qgemm_tpu_torch.models.gpt import GPT
from qgemm_tpu_torch.models.linear import QuantizedLinear
from qgemm_tpu_torch.utils.interop import (DTYPE_TAG, gpt_from_jax_params, gpt_leaves,
                                           gpt_to_numpy_params)


def save_checkpoint(path: str, model: GPT) -> None:
    """Write every leaf of ``model`` into one .npz keyed by its path.
    Atomic (tmp + rename)."""
    arrays = gpt_to_numpy_params(model)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str, template: GPT) -> GPT:
    """Restore into the structure of ``template``: every leaf of the
    template must be in the file with the template's shape, and the file
    may hold no other leaf. Returns a new ``GPT`` of the template's config
    on its device (its quantized linears keep the template's outlier
    options), with the file's dtypes."""
    want = gpt_leaves(template)
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
    quantized = [m for m in template.modules() if isinstance(m, QuantizedLinear)]
    outliers = ({} if not quantized else
                dict(outlier_threshold=quantized[0].outlier_threshold,
                     outlier_capacity=quantized[0].outlier_capacity))
    return gpt_from_jax_params(params, template.cfg, device=template.device, **outliers)
