"""Meshes: the port of ``repro/launch/mesh.py``. Functions, not
module constants, so importing this module touches no device.

* :func:`make_production_mesh`: the reference's 16 x 16 ``("data",
  "model")`` mesh (256 chips) or 2 x 16 x 16 ``("pod", "data", "model")``
  (512), as a virtual mesh of ``meta`` devices: the dry-run traces one
  rank's step over it, and its collectives move nothing
  (``distributed/collectives.py``);
* :func:`make_train_mesh`: a ``("data", "model")`` (or ``("pod", "data",
  "model")``) mesh over the ranks of the running process group, one device a
  rank;
* :func:`make_host_mesh`: 1 x 1 over one device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..distributed.collectives import comm_for
from ..distributed.sharding import ShardMesh, group_world_size, rank_device

LM_AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


def virtual_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str] = LM_AXES) -> ShardMesh:
    """A mesh of ``meta`` devices of any shape: the step of one of its ranks
    traces on ``meta`` and its collectives are counted, not run."""
    n = 1
    for size in axis_sizes:
        n *= int(size)
    return ShardMesh((torch.device("meta"),) * n, axis_names=tuple(axis_names),
                     axis_sizes=tuple(int(s) for s in axis_sizes))


def make_production_mesh(*, multi_pod: bool = False) -> ShardMesh:
    """16x16 single-pod (256 chips) or 2x16x16 multi-pod (512 chips), of
    ``meta`` devices."""
    return virtual_mesh((2, 16, 16), POD_AXES) if multi_pod else virtual_mesh((16, 16), LM_AXES)


def make_train_mesh(data: int, model: int, pod: Optional[int] = None, device=None) -> ShardMesh:
    """A ``("data", "model")`` mesh (``("pod", "data", "model")`` with
    ``pod``) over the ranks of the running process group
    (``distributed.init_shard_group`` / ``spawn_ranks``), whose world size
    must be their product: rank ``r`` sits at the row-major coordinates of
    ``r``. Collective: every rank gathers every rank's device
    (``rank_device(device)``) and creates the sub-group of each set of axes
    (``collectives.comm_for``)."""
    if group_world_size() is None:
        raise ValueError(f"a {data} x {model} mesh needs a process group: start one with "
                         "distributed.init_shard_group or spawn_ranks")
    sizes = (int(data), int(model)) if pod is None else (int(pod), int(data), int(model))
    names = LM_AXES if pod is None else POD_AXES
    world = dist.get_world_size()
    n = 1
    for size in sizes:
        n *= size
    if n != world:
        raise ValueError(f"a mesh of {sizes} needs {n} ranks; the process group has {world}")
    seen = [None] * world
    dist.all_gather_object(seen, str(rank_device(device)))
    backend = dist.get_backend()
    devices = tuple(torch.device(d) for d in seen)
    if backend == "nccl" and len(set(devices)) < world:
        raise ValueError(f"nccl ranks share devices {seen}: NCCL needs one device a rank")
    mesh = ShardMesh(devices, axis_names=names, axis_sizes=sizes, rank=dist.get_rank(),
                     backend=backend)
    comm_for(mesh)  # every rank creates the sub-groups now, in the same order
    return mesh


def make_host_mesh(device=None) -> ShardMesh:
    """A 1 x 1 ``("data", "model")`` mesh over one device (the GPU when
    ``device`` is None)."""
    return ShardMesh((resolve_device(device),), axis_names=LM_AXES, axis_sizes=(1, 1))
