"""Device mesh utilities for data-parallel training (twin of
``viforsdes_tpu/parallel/mesh.py``).

PyTorch runs one process per device, so a mesh here is a 1-D
``torch.distributed.device_mesh.DeviceMesh`` over the ``"data"`` axis whose
entries are process ranks. The trainer (``inference/trainer.py``) keeps the
params, EMA and AdamW state replicated: every rank draws the step's global
Monte-Carlo batch from the same seed and keeps whole importance groups of
each microbatch, as evenly as they go (a microbatch need not divide over the
mesh, and a rank may hold no group), weights its microbatch gradients and
ELBO terms by its share of the groups, all-reduces them over the mesh's
group, and then runs the same update on the same numbers, so the replicas
stay bitwise equal by construction. The reference's DDP wrapper never
synchronized gradients (SURVEY §2.3).

Semantics, as in the JAX package: ``batch_size`` is the GLOBAL batch, sharded
over the mesh, and it must divide over the mesh. ``local_batch_size`` is
``batch_size / n``, as in JAX; what each rank actually holds of a microbatch
is ``inference/trainer.py``'s ``rank_groups`` (at batch 8 with ``iw_samples``
4 on 4 ranks: 4, 4, 0 and 0 paths).

Process group: ``make_data_mesh`` uses the default process group when one is
initialized; otherwise it initializes one from the ``torchrun`` environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``),
or else as a world of one process on an in-process store, which opens no
port. The backend is NCCL for ``"cuda"`` and gloo for ``"cpu"``.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DATA_AXIS = "data"


def make_data_mesh(n_devices: int | None = None, device_type: str = "cuda") -> DeviceMesh:
    """1-D data-parallel mesh over all (or the first ``n_devices``) ranks of
    the default process group, initializing the group if needed. Every rank
    of the default group must call it (the mesh's subgroup is created
    collectively)."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "make_data_mesh(device_type='cuda') but no CUDA device is available; "
            "pass device_type='cpu' to run on the CPU"
        )
    if device_type == "cuda" and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    if not dist.is_initialized():
        backend = "nccl" if device_type == "cuda" else "gloo"
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        raise ValueError(f"requested {n_devices} devices but only {world} available")
    return DeviceMesh(device_type, list(range(n_devices)), mesh_dim_names=(DATA_AXIS,))


def local_batch_size(global_batch: int, mesh: DeviceMesh) -> int:
    n = mesh.size()
    if global_batch % n != 0:
        raise ValueError(f"batch_size {global_batch} must be divisible by mesh size {n}")
    return global_batch // n


class DataGroup(NamedTuple):
    """This process's place in a data mesh: the mesh's process group, this
    rank's index on the data axis, the axis size, the global rank of the
    mesh's first rank (the source of broadcasts) and the device this rank
    trains on."""

    group: dist.ProcessGroup
    rank: int
    size: int
    root: int
    device: torch.device


def data_group(mesh: DeviceMesh) -> DataGroup:
    """This process's ``DataGroup`` in ``mesh``; a process outside the mesh
    raises."""
    if mesh.ndim != 1 or mesh.mesh_dim_names != (DATA_AXIS,):
        raise ValueError(f"expected a 1-D mesh over the {DATA_AXIS!r} axis (make_data_mesh)")
    if mesh.get_coordinate() is None:
        raise ValueError(
            f"rank {dist.get_rank()} is not in the data mesh {mesh.mesh.tolist()}; "
            "build the trainer only on the mesh's ranks"
        )
    group = mesh.get_group(DATA_AXIS)
    if mesh.device_type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device(mesh.device_type)
    return DataGroup(group, mesh.get_local_rank(DATA_AXIS), mesh.size(), dist.get_global_rank(group, 0), device)
