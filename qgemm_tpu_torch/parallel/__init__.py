"""Parallelism on ``torch.distributed`` (port of ``qgemm_tpu/parallel``),
SPMD: one process per device, each holding its own shards.

  * ``mesh.py`` — process groups and ``("data", "model")`` meshes;
  * ``tp_ops.py`` — the serving collectives around the int8 and W4A8
    kernels (tensor parallelism), and the per-process collective counts;
  * ``collectives.py`` — the differentiable collectives (Megatron's f and
    g, gather, ``ppermute``, ``all_to_all``);
  * ``sharding.py`` — the sharding rules: ``shard_quantized_model`` for
    serving, ``shard_model`` and ``shard_batch`` for data x model training;
  * ``expert.py`` — expert parallelism (``ep_moe_forward``,
    ``ep_moe_forward_a2a``, ``shard_moe``);
  * ``ring_attention.py``, ``ulysses.py`` — sequence parallelism;
  * ``pipeline.py`` — GPipe (``stack_stages``, ``pipeline_apply``,
    ``pipeline_gpt_forward``);
  * ``dryrun.py`` — ``run_dryrun``, every path above on the world's ranks.

The names JAX's package exports are attributes here, imported on first
use (the models and the engines import parts of this package)."""

from qgemm_tpu_torch import _lazy_exports
from qgemm_tpu_torch.parallel.mesh import initialize_distributed, make_mesh  # noqa: F401

_EXPORTS = {
    "ep_moe_forward": "expert", "ep_moe_forward_a2a": "expert", "shard_moe": "expert",
    "pipeline_apply": "pipeline", "pipeline_gpt_forward": "pipeline",
    "stack_stages": "pipeline",
    "ring_attention": "ring_attention", "shard_sequence": "ring_attention",
    "ulysses_attention": "ulysses",
    "model_sharding_spec": "sharding", "shard_batch": "sharding",
    "shard_kv_caches": "sharding", "shard_model": "sharding",
    "shard_quantized_model": "sharding",
    "run_dryrun": "dryrun",
}

__all__ = ["initialize_distributed", "make_mesh", *_EXPORTS]

__getattr__ = _lazy_exports(__name__, _EXPORTS)
