"""Compute on sharded weights: tensor parallelism over a mesh's ``model``
dim (Megatron's column- and row-parallel products), expert parallelism,
and fsdp's gathers over (pod, data), as GSPMD computes the JAX package's
``megatron`` and ``ep_seq`` layouts.

Each rank holds its ``local_slice`` of every leaf (``parallel.sharding``)
and works on local tensors; the collectives go through
``parallel.collectives``.  The autograd functions keep one convention:
an activation *replicated* over ``model`` carries the whole gradient on
every rank, and an activation *partitioned* over ``model`` (a rank's
columns, or a partial sum) carries its own part.

* :meth:`ModelGroup.copy`: identity forward, all-reduce backward, where a
  replicated tensor (or weight) enters rank-local compute;
* :meth:`ModelGroup.reduce`: all-reduce forward, identity backward, where
  partial sums leave it;
* :meth:`ModelGroup.gather` (:func:`gather` over any dims): all-gather
  forward, reduce-scatter backward, for a partitioned activation that
  each rank then slices for itself (a rank's heads, or both halves of its
  channels of a fused product; the batch rows or positions that a MoE
  layer's groups or a recurrent mixer span);
* :meth:`ModelGroup.full`: all-gather forward, this rank's chunk backward,
  for a split weight that replicated compute reads whole;
* :func:`gather_fsdp`: a layer's leaves split over (pod, data) gathered
  before the layer, their gradient reduce-scattered (each data rank's use
  is its batch rows' share, so the scatter sums the shares);
* :func:`share_of`: a loss whose value is the whole batch's and whose
  gradient is this rank's share of it;
* :class:`MomentSlice`: ZeRO-1, a leaf whose AdamW moments are split
  (``opt_pspecs``) otherwise than the leaf itself;
* :func:`flash_merge`: the attention of one decode query over keys that
  ranks hold in slices (flash-decoding's merge: a max, then the sums and
  the P.V products, spanning the ranks).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.common import (PyTree, tree_leaves,
                                       tree_unflatten_like)
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import NamedSharding, axis_members


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (collectives.all_reduce(g.contiguous().clone(), ctx.mesh,
                                       ctx.dims), None, None)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims):
        return collectives.all_reduce(x.contiguous().clone(), mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    """All-gather forward; reduce-scatter (``scatter``) or this rank's
    chunk of the gradient backward."""

    @staticmethod
    def forward(ctx, x, mesh, dims, dim, scatter):
        ctx.mesh, ctx.dims, ctx.dim, ctx.scatter = mesh, dims, dim, scatter
        ctx.size = x.shape[dim]
        return collectives.all_gather_cat(x, mesh, dims, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.scatter:
            g = collectives.reduce_scatter(g, ctx.mesh, ctx.dims, ctx.dim)
        else:
            start = collectives.group_rank(ctx.mesh, ctx.dims) * ctx.size
            g = g.narrow(ctx.dim, start, ctx.size)
        return g, None, None, None, None


def _dim(x: torch.Tensor, dim: int) -> int:
    return dim % x.ndim


def gather(x: torch.Tensor, mesh, dims: Sequence[str],
           dim: int) -> torch.Tensor:
    """Every rank's ``x`` over ``dims`` concatenated along ``dim``
    (``collectives.all_gather_cat``); the gradient is reduce-scattered
    back, so each rank's share of it is summed into its own chunk."""
    return _Gather.apply(x, mesh, tuple(dims), _dim(x, dim), True)


@dataclass(frozen=True)
class ModelGroup:
    """The ranks of a mesh that share this rank's coordinates on every dim
    but ``model``: the group a leaf split over ``model`` is spread
    across."""
    mesh: object
    dims: ClassVar[Tuple[str, ...]] = ("model",)

    @property
    def size(self) -> int:
        return collectives.group_size(self.mesh, self.dims)

    @property
    def rank(self) -> int:
        return collectives.group_rank(self.mesh, self.dims)

    def split(self, local: int, full: int) -> bool:
        """Whether a dim of ``full`` entries is held as this rank's
        ``local`` of them (an even, contiguous share)."""
        if local == full:
            return False
        if local * self.size != full:
            raise ValueError(f"{local} of {full} is no share of "
                             f"{self.size} ranks")
        return True

    def span(self, local: int, rank: Optional[int] = None) -> Tuple[int, int]:
        """The [start, stop) of rank ``rank``'s (this rank's) share of a
        dim split into ``local`` entries a rank."""
        r = self.rank if rank is None else rank
        return r * local, (r + 1) * local

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _Copy.apply(x, self.mesh, self.dims)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self.mesh, self.dims)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return gather(x, self.mesh, self.dims, dim)

    def full(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _Gather.apply(x, self.mesh, self.dims, _dim(x, dim), False)


def model_group(mesh) -> Optional[ModelGroup]:
    """The ``model`` group of ``mesh``, or None where the mesh has no
    ``model`` dim of more than one rank (nothing is split over it)."""
    if mesh is None or "model" not in tuple(mesh.mesh_dim_names):
        return None
    group = ModelGroup(mesh)
    return group if group.size > 1 else None


def head_span(start: int, stop: int, head_dim: int,
              group: int) -> Tuple[int, int]:
    """The KV heads [g0, g1) whose query groups (``group`` query heads on
    each KV head, ``head_dim`` columns a head) cover the flat query
    columns [start, stop): a rank's columns may end inside a head, and its
    heads inside a group; it computes whole groups."""
    h0, h1 = start // head_dim, -(-stop // head_dim)
    return h0 // group, -(-h1 // group)


def own_channels(t: torch.Tensor, tp: ModelGroup):
    """Both halves of this rank's channels of a fused (x, z) product:
    ``t`` (..., 2C / size) holds this rank's contiguous columns of the
    (..., 2C) product, which the split cuts across the halves; it is
    gathered over ``model`` and each half's share of this rank taken (the
    gather's backward scatters the gradient)."""
    full = tp.gather(t, -1)
    lo, hi = tp.span(full.shape[-1] // 2 // tp.size)
    return tuple(p[..., lo:hi] for p in full.chunk(2, dim=-1))


def share_of(share: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
    """``whole`` in value, with the gradient of ``share`` (a rank's part of
    a loss that ``whole`` sums over ranks or copies)."""
    return share + (whole - share).detach()


class MomentSlice:
    """A leaf held as this rank's slice by the PartitionSpec ``pspec``
    whose moments are its slice by ``ospec`` (ZeRO-1: under ``pure_dp``,
    ``seq_dp`` and ``ep_seq`` each moment is split over ``model`` on its
    largest dim).  :meth:`take` gives the parameter and its gradient at the
    moments' slice, :meth:`put` writes the stepped slice back: gathered
    over the moments' split, this rank's part of the leaf kept."""

    def __init__(self, mesh, pspec, ospec):
        self.mesh, self.pspec, self.ospec = mesh, pspec, ospec

    def _whole(self, t: torch.Tensor, spec) -> torch.Tensor:
        names = tuple(self.mesh.mesh_dim_names)
        for d, entry in enumerate(spec):
            dims = tuple(a for a in axis_members(entry) if a in names)
            if dims:
                t = collectives.all_gather_cat(t, self.mesh, dims, d)
        return t

    def take(self, p: torch.Tensor, g: torch.Tensor):
        cut = NamedSharding(self.mesh, self.ospec).local_slice
        return tuple(cut(self._whole(t, self.pspec)).clone()
                     for t in (p, g))

    def put(self, p: torch.Tensor, stepped: torch.Tensor) -> None:
        p.copy_(NamedSharding(self.mesh, self.pspec).local_slice(
            self._whole(stepped, self.ospec)))


def gather_fsdp(tree: PyTree, pspecs: PyTree, mesh,
                offset: int = 0) -> PyTree:
    """Each leaf of ``tree`` whose PartitionSpec in ``pspecs`` splits a dim
    over (pod, data), all-gathered along that dim (its gradient
    reduce-scattered); the rest as they are.  ``offset`` spec entries lead
    each leaf's (a stacked leaf's ``layers`` dim, taken off by
    ``unstack_layers``)."""
    leaves = tree_leaves(tree)
    specs = tree_leaves(pspecs)
    if len(leaves) != len(specs):
        raise ValueError(f"{len(leaves)} leaves against {len(specs)} specs")
    names = tuple(mesh.mesh_dim_names)
    out = []
    for t, spec in zip(leaves, specs):
        for d, entry in enumerate(tuple(spec)[offset:]):
            dims = tuple(a for a in axis_members(entry)
                         if a in ("pod", "data") and a in names)
            if dims:
                t = _Gather.apply(t, mesh, dims, d, True)
        out.append(t)
    return tree_unflatten_like(tree, out)


def split_dims(pspecs: PyTree, mesh) -> list:
    """For each leaf (in ``tree_leaves`` order), the mesh dims its
    PartitionSpec splits it over that ``mesh`` has, in mesh order."""
    names = tuple(mesh.mesh_dim_names)
    out = []
    for spec in tree_leaves(pspecs):
        used = {a for entry in spec for a in axis_members(entry)}
        out.append(tuple(a for a in names if a in used))
    return out


def replicas_of(dims: Sequence[str], mesh, among: Sequence[str]) -> tuple:
    """The dims of ``among`` that ``mesh`` has and ``dims`` do not name:
    those over which a leaf split over ``dims`` is replicated."""
    names = tuple(mesh.mesh_dim_names)
    return tuple(a for a in among if a in names and a not in dims)


def flash_merge(pieces, mesh) -> torch.Tensor:
    """Softmax attention of decode queries over keys that ranks hold in
    slices (flash-decoding's merge).  Each piece is (scores (..., n)
    float32, masked with a finite ``NEG_INF``; ``pv``, which takes weights
    of the scores' shape to their P.V product (..., d); the mesh dims the
    piece's keys are split over, () where each rank holds them all).

    The max m over every piece's keys on every rank is all-reduced first;
    then each piece's sum of exp(s - m) and its unnormalised P.V are
    summed over its dims in one all-reduce (float32), and the products'
    sum is divided by the sums'.  A rank whose keys are all masked holds
    ``NEG_INF`` scores that fall below the max another rank's key sets, so
    it adds exactly 0, not exp(0).  Where no piece is split, the weights
    are normalised before P.V, as one process's decode computes it, and
    the result keeps ``pv``'s dtype."""
    m = None
    for s, _, dims in pieces:
        top = s.amax(dim=-1, keepdim=True)
        if dims:
            collectives.all_reduce(top, mesh, dims, op=dist.ReduceOp.MAX)
        m = top if m is None else torch.maximum(m, top)
    ps = [torch.exp(s - m) for s, _, _ in pieces]
    if not any(dims for _, _, dims in pieces):
        total = sum(p.sum(dim=-1, keepdim=True) for p in ps)
        return sum(pv(p / total) for p, (_, pv, _) in zip(ps, pieces))
    out = total = 0
    for p, (_, pv, dims) in zip(ps, pieces):
        part, o = p.sum(dim=-1, keepdim=True), pv(p).float()
        if dims:
            part, o = collectives.all_reduce_many([part, o], mesh, dims)
        total, out = total + part, out + o
    return out / total
