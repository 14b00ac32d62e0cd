"""The collectives of the mesh layer, over the dims of a
``torch.distributed`` ``DeviceMesh``.

Every collective of ``repro_torch.parallel``, ``optim.compression``, the
sequence-parallel attention and the compute on sharded weights goes
through this module, so the one rule about backends lives here: a
``gloo`` group runs ``all_reduce``, ``broadcast``, ``all_gather`` and
``reduce_scatter`` on CUDA tensors itself (``chip_smoke.gloo_probe``
checks the last on the card), but not ``send``/``recv``, whose CUDA
tensors are staged through host memory (:func:`_staged`).  The choice is
made from the group's backend before the call, never after a failure.
NCCL takes CUDA tensors for all of them; it runs one rank per GPU, so
several ranks sharing one card use gloo.

A collective over several mesh dims runs over each dim's own group in
turn: a sum or max of sums or maxes, a gather of gathers (the last dim
first, so the result is row-major over the dims, the first outermost) and
a scatter of scatters (the first dim first, its inverse).

Each call records what it moves, ``(op, result bytes, group size)`` by the
names of XLA's collectives, in every recording that
``launch.wire.count_collectives`` holds open; a group of one rank moves
nothing and records nothing.  Recording changes no result, on a real group
or on the dry run's fake one.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

#: the collectives a gloo group takes CUDA tensors for
_GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast", "all_gather"})
#: the open recordings (``launch.wire.count_collectives``)
_recordings: List[list] = []


def _record(op: str, t: torch.Tensor, group) -> None:
    """``op`` with result ``t`` over ``group``, in every open recording."""
    if not _recordings:
        return
    g = dist.get_world_size(group)
    if g > 1:
        for rec in _recordings:
            rec.append((op, t.numel() * t.element_size(), g))


def _size(mesh, dim: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(dim))


def group_rank(mesh, dims: Sequence[str]) -> int:
    """This rank's row-major index over its coordinates on ``dims``."""
    coord = mesh.get_coordinate()
    idx = 0
    for d in dims:
        idx = idx * _size(mesh, d) + coord[mesh.mesh_dim_names.index(d)]
    return idx


def group_size(mesh, dims: Sequence[str]) -> int:
    n = 1
    for d in dims:
        n *= _size(mesh, d)
    return n


def _staged(op: str, group, t: torch.Tensor) -> bool:
    """Whether ``op`` on ``t`` goes through a host copy: a CUDA tensor on a
    gloo group for a collective gloo does not run on CUDA."""
    return (t.is_cuda and op not in _GLOO_CUDA_OPS
            and dist.get_backend(group) == "gloo")


def all_reduce(t: torch.Tensor, mesh, dims: Sequence[str],
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over the ranks that share this rank's coordinates on
    every dim but ``dims``, in place; returns ``t``.  Exact for integer
    sums and for max."""
    for d in dims:
        group = mesh.get_group(d)
        _record("all-reduce", t, group)
        dist.all_reduce(t, op=op, group=group)
    return t


def all_reduce_many(ts: Sequence[torch.Tensor], mesh,
                    dims: Sequence[str]) -> List[torch.Tensor]:
    """The sums of the tensors ``ts`` over ``dims``, in float32, in one
    all-reduce of their flattened concatenation (one collective where
    each would take its own); new tensors, in ``ts``' shapes."""
    flat = all_reduce(torch.cat([t.float().reshape(-1) for t in ts]), mesh,
                      dims)
    return [part.view(t.shape) for part, t in
            zip(flat.split([t.numel() for t in ts]), ts)]


def all_gather_cat(t: torch.Tensor, mesh, dims: Sequence[str],
                   dim: int) -> torch.Tensor:
    """Every rank's ``t`` over ``dims``, concatenated along ``dim`` in
    row-major order of their coordinates (a tiled gather)."""
    for d in reversed(tuple(dims)):
        group = mesh.get_group(d)
        n = dist.get_world_size(group)
        if n == 1:
            continue
        src = t.contiguous()
        parts: List[torch.Tensor] = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        t = torch.cat(parts, dim=dim)
        _record("all-gather", t, group)
    return t


def reduce_scatter(t: torch.Tensor, mesh, dims: Sequence[str],
                   dim: int) -> torch.Tensor:
    """The sum of every rank's ``t`` over ``dims``, cut along ``dim`` into
    as many chunks as ranks; returns this rank's chunk (the one
    :func:`all_gather_cat` would put at its place), a new tensor."""
    for d in dims:
        group = mesh.get_group(d)
        n = dist.get_world_size(group)
        if n == 1:
            continue
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"into {n}")
        parts = [c.contiguous() for c in t.chunk(n, dim)]
        t = torch.empty_like(parts[0])
        dist.reduce_scatter(t, parts, group=group)
        _record("reduce-scatter", t, group)
    return t.contiguous()


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` from global rank ``src`` to every rank of ``group``, in
    place; returns ``t``."""
    _record("broadcast", t, group)
    dist.broadcast(t, src=src, group=group)
    return t


def send(t: torch.Tensor, dst: int, group) -> None:
    """``t`` to global rank ``dst`` (blocking)."""
    src = t.contiguous()
    _record("collective-permute", src, group)
    if _staged("send", group, src):
        src = src.cpu()
    dist.send(src, dst=dst, group=group)


def recv(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """Fills ``t`` (contiguous) from global rank ``src`` (blocking);
    returns ``t``."""
    _record("collective-permute", t, group)
    if _staged("recv", group, t):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        dist.recv(host, src=src, group=group)
        t.copy_(host)
    else:
        dist.recv(t, src=src, group=group)
    return t
