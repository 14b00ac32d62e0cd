"""Meshes of ranks, as ``repro.launch.mesh`` makes them: a named
``torch.distributed`` ``DeviceMesh`` of a given shape over the first ranks
of the default process group, the production meshes (16 x 16 and
2 x 16 x 16) among them, and the hardware constants of the roofline
(``launch.roofline``): one H100 SXM5 80 GB at its 700 W power limit.
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


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The single-pod (16, 16) ``("data", "model")`` mesh, or the multi-pod
    (2, 16, 16) ``("pod", "data", "model")`` one, over ranks 0..n-1 of the
    default group (256 or 512 ranks: the dry run's fake group,
    ``launch.dryrun``, or a real one)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


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


# Hardware constants of the roofline: one H100 SXM5 80 GB at its 700 W
# power limit.  Every axis of the production meshes (16, 16 and 2 ranks)
# spans nodes of 8 GPUs, so each collective is bound by the inter-node
# link, InfiniBand NDR at 400 Gb/s a GPU and direction, not by NVLink.
PEAK_FLOPS_BF16 = 989.4e12    # dense bf16 tensor-core FLOP/s per GPU
HBM_BW = 3.35e12              # HBM3 bytes/s per GPU
LINK_BW = 50e9                # bytes/s per GPU and direction (NDR 400 Gb/s)
CHIPS_PER_POD = 256
