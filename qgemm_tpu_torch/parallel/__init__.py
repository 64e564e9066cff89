"""Tensor-parallel serving on ``torch.distributed`` (port of the serving
part of ``qgemm_tpu/parallel``): meshes (``mesh.py``), the explicit
collectives around the kernels (``tp_ops.py``) and the sharding rules
(``sharding.py``, which reaches the models: import it from its module)."""

from qgemm_tpu_torch.parallel.mesh import initialize_distributed, make_mesh  # noqa: F401
