"""Process groups and device meshes (port of ``qgemm_tpu/parallel/mesh.py``).

JAX drives a mesh of devices from one process; the port runs one process
per device (SPMD), each holding its own shards and running the same
program. A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
JAX's axis names, ``("data", "model")``; the collectives of tensor
parallelism run on its ``"model"`` group (``parallel/tp_ops.py``).

The device follows the port's rule: ``None`` means CUDA (rank r on
``cuda:(r % device_count)``, NCCL) and raises without a GPU; ``"cpu"``
means gloo. The backend follows the device the caller chose.
"""

from __future__ import annotations

import math
import os
from datetime import timedelta
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from qgemm_tpu_torch.device import DeviceLike, resolve_device

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def _device_type(device: DeviceLike) -> str:
    """"cuda" (checked: raises without a GPU) or "cpu"."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        resolve_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"no process-group backend for device {dev}")
    return dev.type


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None, rank: Optional[int] = None,
                           device: DeviceLike = None,
                           timeout: Optional[timedelta] = None) -> str:
    """Start this process's default process group and return its backend.

    Rank and world size come from the arguments, else from ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``, rendezvous at ``env://``).
    ``init_method`` names another store (``file:///path`` or
    ``tcp://localhost:port``). ``device=None`` is CUDA over NCCL, rank r on
    ``cuda:(LOCAL_RANK or r) % device_count``, and raises without a GPU;
    ``"cpu"`` is gloo. A group that is already up is kept, if its backend
    is the one asked for."""
    kind = _device_type(device)
    backend = _BACKEND[kind]
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"a {dist.get_backend()} process group is up; "
                               f"{kind} asks for {backend}")
        return backend
    rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
    world_size = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
                  else int(world_size))
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    if kind == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kw)
    return backend


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data", "model"),
              device: DeviceLike = None) -> DeviceMesh:
    """A mesh over every rank of the default process group
    (``initialize_distributed`` first). Default shape: every rank on
    ``model``, as JAX's. A shape whose product is not the world size
    raises ``ValueError``; a device whose backend is not the group's
    raises."""
    kind = _device_type(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call initialize_distributed first")
    if dist.get_backend() != _BACKEND[kind]:
        raise ValueError(f"make_mesh(device={kind!r}) needs the {_BACKEND[kind]} backend; "
                         f"the process group runs {dist.get_backend()}")
    n = dist.get_world_size()
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (1, n) if len(axis_names) == 2 else (n,)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axes {axis_names}")
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} ranks, have {n}")
    return init_device_mesh(kind, shape, mesh_dim_names=axis_names)


def axis_size(mesh: DeviceMesh, axis: str = "model") -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh: DeviceMesh, axis: str = "model") -> int:
    """This process's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)
