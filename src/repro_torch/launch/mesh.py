"""Meshes of ranks, as ``repro.launch.mesh`` makes them: a named
``torch.distributed`` ``DeviceMesh`` of a given shape over the first ranks
of the default process group.

The production meshes (256 and 512 devices) and the roofline constants of
the JAX package's module belong to the dry-run tooling (ROADMAP A6d).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with dim names ``axes`` over ranks
    0..prod(shape)-1 of the default group, row-major.  Every rank of the
    group calls it (the mesh's groups are built collectively); a rank
    outside the mesh gets no coordinate.  ``device_type`` is CUDA unless
    the caller asks for the CPU, and without CUDA asking for it raises."""
    from torch.distributed.device_mesh import DeviceMesh
    device_type = resolve_device(device_type).type
    n = math.prod(shape)
    if n > dist.get_world_size():
        raise ValueError(f"a mesh of {tuple(shape)} needs {n} ranks; the "
                         f"group has {dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_host_mesh(device_type: str = "cuda"):
    """A (1, 1) ``("data", "model")`` mesh over this process alone (the
    same dim names as the single-pod mesh).  Without a process group it
    starts a 1-rank gloo group on an in-memory store; a group of more
    ranks raises."""
    device_type = resolve_device(device_type).type
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != 1:
        raise ValueError("make_host_mesh is a mesh of one process; the "
                         f"group has {dist.get_world_size()} ranks")
    return make_mesh((1, 1), ("data", "model"), device_type)
