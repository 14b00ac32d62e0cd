"""Elastic scaling: the best mesh for however many ranks survive, as
``repro.runtime.elastic`` chooses it.

Checkpoints are sharding-agnostic (``checkpoint/checkpointer.py``), so a
restart after losing ranks needs (1) a new mesh over the survivors, (2) new
shardings from the same logical-axis rules (``parallel/sharding.py``), and
(3) ``Checkpointer.restore(shardings=)``.  This module picks the mesh: keep
the model dim as close to the original TP degree as still fits (it must
divide the flattened weight dims), give the rest to data parallelism, and
drop stragglers to a power-of-two rank count.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch.distributed as dist

from repro_torch.launch.mesh import make_mesh


def largest_pow2_leq(n: int) -> int:
    return 1 << (n.bit_length() - 1)


def choose_mesh_shape(n_devices: int, preferred_model: int = 16,
                      min_model: int = 1) -> Tuple[int, int]:
    """(data, model) for n_devices (uses the largest power of two <= n)."""
    usable = largest_pow2_leq(max(n_devices, 1))
    model = min(preferred_model, usable)
    while model > min_model and usable % model:
        model //= 2
    return usable // model, model


def make_elastic_mesh(n_devices: Optional[int] = None,
                      preferred_model: int = 16, device_type: str = "cuda"):
    """A ``(data, model)`` ``DeviceMesh`` with dim names ``("data",
    "model")`` over the first data*model ranks of the default group (all
    of them unless ``n_devices`` says fewer survive).  Every rank of the
    group calls it.  CUDA unless the caller asks for the CPU."""
    n = n_devices if n_devices is not None else dist.get_world_size()
    data, model = choose_mesh_shape(n, preferred_model)
    return make_mesh((data, model), ("data", "model"), device_type)
