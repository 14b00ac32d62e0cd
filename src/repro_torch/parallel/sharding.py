"""Logical-axis -> mesh-axis sharding rules (DP / TP / EP / SP / FSDP), as
``repro.parallel.sharding`` gives them.

Every ParamSpec carries logical axis names; these rules translate them into
:class:`PartitionSpec`s for a given config + role:

* TP: flattened head/ffn/expert/inner dims -> ``model``.
* EP: MoE expert dim -> ``model``.
* DP: batch -> ``("pod","data")`` (pod folds into data parallelism).
* FSDP: when ``cfg.fsdp`` (jamba-398B) or when serving a model whose
  model-sharded bf16 weights exceed the per-device budget, the ``embed``
  (d_model) dim additionally shards over ``data``.
* SP (decode): KV caches shard the *sequence* dim over ``model``; SSM and
  xLSTM state shards channels over ``model``.

The rules read only a mesh's dim names and sizes: of a ``DeviceMesh``,
or of a shape-only stand-in (``.shape`` a mapping of dim name to size,
``.axis_names``) of the 16x16 and 2x16x16 production meshes.  On a
``DeviceMesh``, :class:`NamedSharding`
turns a spec into DTensor placements: ``Shard(d)`` on each mesh dim that
the spec names for tensor dim d, ``Replicate()`` on the others.
:func:`shard_tree` builds each leaf's DTensor from this rank's own slice,
with no collective; :func:`cache_slices` gives each decode-cache leaf's
split and this rank's ranges, which the decode on a mesh reads.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (DTYPES, ParamSpec, PyTree, spec_map,
                                       tree_leaves_with_names, tree_map,
                                       tree_unflatten_like)
from repro_torch.parallel import collectives

#: the JAX package's per-device budget of serving weights
#: (:func:`serve_needs_fsdp`), kept so that the port places them as it does;
#: it is not what an H100 (80 GB) holds
HBM_BYTES_BUDGET = 12 * 2 ** 30


class PartitionSpec:
    """One entry per tensor dim: ``None`` (not split), a mesh dim name, or a
    tuple of names (split over their product, the first outermost); a
    tuple of one name is that name, and an empty one ``None``, as JAX
    normalises them.  It iterates, indexes and compares as the tuple of
    its entries (so equal to the JAX package's spec as tuples), and tree
    functions take it as one leaf."""
    __slots__ = ("axes",)

    def __init__(self, *axes):
        self.axes = tuple(_normalise(a) for a in axes)

    def __iter__(self):
        return iter(self.axes)

    def __len__(self):
        return len(self.axes)

    def __getitem__(self, i):
        return self.axes[i]

    def __eq__(self, other):
        if isinstance(other, PartitionSpec):
            return self.axes == other.axes
        return isinstance(other, tuple) and self.axes == other

    def __hash__(self):
        return hash(self.axes)

    def __repr__(self):
        return f"PartitionSpec{self.axes!r}"


P = PartitionSpec


def _normalise(entry):
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return None if not entry else entry[0] if len(entry) == 1 else entry
    return entry


def _shape_of(mesh) -> Dict[str, int]:
    """``{dim name: size}`` of a ``DeviceMesh`` or of a shape-only mesh
    (``.shape`` a mapping, ``.axis_names``)."""
    if hasattr(mesh, "mesh_dim_names"):
        return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}
    return dict(mesh.shape)


def _names_of(mesh) -> Tuple[str, ...]:
    if hasattr(mesh, "mesh_dim_names"):
        return tuple(mesh.mesh_dim_names)
    return tuple(mesh.axis_names)


def axis_rules(cfg: ModelConfig, mesh, fsdp: Optional[bool] = None
               ) -> Dict[Optional[str], Optional[str]]:
    use_fsdp = cfg.fsdp if fsdp is None else fsdp
    names = _names_of(mesh)
    if cfg.shard_strategy in ("pure_dp", "seq_dp", "ep_seq"):
        # weights replicated: all parallelism comes from the batch/sequence
        # dims; ep_seq keeps only the expert dim sharded (EP)
        rules = {k: None for k in ("vocab", "heads", "kv_heads", "mlp",
                                   "experts", "mamba_inner", "mlstm_inner",
                                   "mlstm_inner2", "embed", "layers", None)}
        if cfg.shard_strategy == "ep_seq":
            rules["experts"] = "model"
        return rules
    return {
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "experts": "model",
        "mamba_inner": "model",
        "mlstm_inner": "model",
        "mlstm_inner2": None,
        "embed": (tuple(a for a in ("pod", "data") if a in names)
                  if use_fsdp and "data" in names else None),
        "layers": None,
        None: None,
    }


def opt_pspecs(specs: PyTree, cfg: ModelConfig, mesh) -> PyTree:
    """Optimizer-moment shardings.  megatron: same as params.  pure_dp,
    seq_dp, ep_seq: ZeRO-1, each moment over 'model' on its largest
    divisible dim."""
    if cfg.shard_strategy not in ("pure_dp", "seq_dp", "ep_seq"):
        return param_pspecs(specs, cfg, mesh)
    m = _shape_of(mesh).get("model", 1)

    def one(s: ParamSpec) -> PartitionSpec:
        axes = [None] * len(s.shape)
        dims = sorted(range(len(s.shape)), key=lambda i: -s.shape[i])
        for i in dims:
            if s.shape[i] % m == 0 and s.shape[i] >= m:
                axes[i] = "model"
                break
        return P(*axes)

    return spec_map(one, specs)


def _axis_size(mesh, mesh_axis) -> int:
    shape = _shape_of(mesh)
    if isinstance(mesh_axis, tuple):
        n = 1
        for a in mesh_axis:
            n *= shape[a]
        return n
    return shape[mesh_axis]


def _pspec_for(spec: ParamSpec, rules, mesh) -> PartitionSpec:
    axes = []
    used = set()  # each mesh axis may appear at most once per spec
    for dim, logical in zip(spec.shape, spec.logical_axes):
        mesh_axis = rules.get(logical)
        members = (mesh_axis if isinstance(mesh_axis, tuple)
                   else (mesh_axis,)) if mesh_axis else ()
        if (mesh_axis is not None and not (set(members) & used)
                and dim % _axis_size(mesh, mesh_axis) == 0):
            axes.append(mesh_axis)
            used.update(members)
        else:
            axes.append(None)
    return P(*axes)


def param_pspecs(specs: PyTree, cfg: ModelConfig, mesh,
                 fsdp: Optional[bool] = None) -> PyTree:
    rules = axis_rules(cfg, mesh, fsdp)
    return spec_map(lambda s: _pspec_for(s, rules, mesh), specs)


def serve_needs_fsdp(cfg: ModelConfig, mesh) -> bool:
    """Shard serving weights over data too when model-only TP does not
    fit."""
    itemsize = torch.empty((), dtype=DTYPES[cfg.param_dtype]).element_size()
    bytes_per_dev = (cfg.param_count() * itemsize
                     / _shape_of(mesh).get("model", 1))
    return bytes_per_dev > HBM_BYTES_BUDGET


def batch_axes(mesh) -> Tuple[str, ...]:
    names = _names_of(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def batch_pspec(mesh, global_batch: int, extra_dims: int = 1,
                strategy: str = "megatron") -> PartitionSpec:
    shape = _shape_of(mesh)
    axes = batch_axes(mesh)
    if strategy == "pure_dp" and "model" in _names_of(mesh):
        wide = axes + ("model",)
        n = 1
        for a in wide:
            n *= shape[a]
        if global_batch % n == 0:
            return P(wide, *([None] * extra_dims))
        # fall through to the narrower batch axes
    n = 1
    for a in axes:
        n *= shape[a]
    if axes and global_batch % n == 0:
        return P(axes, *([None] * extra_dims))
    return P(*([None] * (1 + extra_dims)))


# ---------------------------------------------------------------------------
# Decode cache shardings (SP)
# ---------------------------------------------------------------------------

_CACHE_SEQ_FIELDS = {"k", "v", "cross_k", "cross_v"}  # (R, B, S, Hk, hd)


def cache_pspecs(cache_specs: PyTree, cfg: ModelConfig, mesh,
                 global_batch: int) -> PyTree:
    """Shard attention caches (R,B,S,Hk,hd): B over data, S over model; SSM
    and xLSTM channel states over model; long-context batch=1 shards S over
    both.  ``cache_specs`` is ``lm.cache_specs``' tree: a tuple of
    ``{name: (shape, dtype)}``."""
    shape_of = _shape_of(mesh)
    d_axes = batch_axes(mesh)
    dsize = 1
    for a in d_axes:
        dsize *= shape_of[a]
    b_ok = bool(d_axes) and global_batch % dsize == 0
    msize = shape_of.get("model", 1)

    def one(name: str, shape: Tuple[int, ...]) -> PartitionSpec:
        if name in ("ring_k", "ring_v"):
            # recent-token ring (two-tier decode): batch over data; head_dim
            # over model where divisible
            axes = [None] * len(shape)
            if b_ok:
                axes[1] = d_axes
            if shape[-1] % msize == 0:
                axes[-1] = "model"
            return P(*axes)
        if name in _CACHE_SEQ_FIELDS:
            seq = shape[2]
            if b_ok:
                seq_axis = "model" if seq % msize == 0 else None
                return P(None, d_axes, seq_axis, None, None)
            # batch=1 long-context: sequence over every axis we have
            all_ax = tuple(d_axes) + ("model",)
            if seq % (dsize * msize) == 0:
                return P(None, None, all_ax, None, None)
            return P(None, None, "model" if seq % msize == 0 else None,
                     None, None)
        # SSM / xLSTM states: channel dims over model where divisible
        axes = [None] * len(shape)
        if b_ok:
            axes[1] = d_axes
        for i in range(2, len(shape)):
            if shape[i] % msize == 0 and "model" not in axes:
                axes[i] = "model"
                break
        return P(*axes)

    return tuple({name: one(name, shape) for name, (shape, _) in
                  layer.items()} for layer in cache_specs)


# ---------------------------------------------------------------------------
# Placements on a DeviceMesh
# ---------------------------------------------------------------------------

def axis_members(entry) -> Tuple[str, ...]:
    """The mesh dim names of one :class:`PartitionSpec` entry."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclass(frozen=True)
class NamedSharding:
    """A :class:`PartitionSpec` on a ``DeviceMesh``."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        """One DTensor placement per mesh dim: ``Shard(d)`` where the spec
        splits tensor dim d over that mesh dim, ``Replicate()`` elsewhere.
        A dim split over several mesh dims names them in mesh order (the
        order in which DTensor nests its shards)."""
        from torch.distributed.tensor import Replicate, Shard
        names = tuple(self.mesh.mesh_dim_names)
        out = [Replicate() for _ in names]
        for d, entry in enumerate(self.spec):
            members = axis_members(entry)
            order = [names.index(a) for a in members]
            if order != sorted(order):
                raise ValueError(f"spec {self.spec} splits dim {d} over "
                                 f"{members}, not in mesh order {names}")
            for i in order:
                out[i] = Shard(d)
        return tuple(out)

    def local_ranges(self, shape, coord=None) -> Tuple[Tuple[int, int], ...]:
        """This rank's (or the rank at mesh coordinates ``coord``'s)
        [start, stop) along each dim of a full tensor of ``shape``: along
        each split dim, the chunk at its row-major index over the dim's
        mesh dims; the whole dim elsewhere."""
        names = tuple(self.mesh.mesh_dim_names)
        coord = self.mesh.get_coordinate() if coord is None else coord
        out = []
        for d, size_d in enumerate(shape):
            members = axis_members(self.spec[d]) if d < len(self.spec) else ()
            n, idx = 1, 0
            for a in members:
                size = self.mesh.size(names.index(a))
                idx = idx * size + coord[names.index(a)]
                n *= size
            if size_d % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not "
                                 f"split into {n}")
            step = size_d // n
            out.append((idx * step, (idx + 1) * step))
        return tuple(out)

    def local_slice(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of the full tensor ``t`` (a view), as
        :meth:`local_ranges` gives it."""
        out = t
        for d, (lo, hi) in enumerate(self.local_ranges(t.shape)):
            if hi - lo != t.shape[d]:
                out = out.narrow(d, lo, hi - lo)
        return out


def param_shardings(specs: PyTree, cfg: ModelConfig, mesh,
                    fsdp: Optional[bool] = None) -> PyTree:
    """:func:`param_pspecs` on the ``DeviceMesh`` ``mesh``, as
    :class:`NamedSharding` leaves."""
    return tree_map(lambda p: NamedSharding(mesh, p),
                    param_pspecs(specs, cfg, mesh, fsdp))


def cache_shardings(cache_specs: PyTree, cfg: ModelConfig, mesh,
                    global_batch: int) -> PyTree:
    """:func:`cache_pspecs` on the ``DeviceMesh`` ``mesh``, as
    :class:`NamedSharding` leaves."""
    return tree_map(lambda p: NamedSharding(mesh, p),
                    cache_pspecs(cache_specs, cfg, mesh, global_batch))


@dataclass(frozen=True)
class CacheSlice:
    """One layer's decode-cache leaf on a ``DeviceMesh``, by
    :func:`cache_pspecs` with the stacked layers dim taken off: for each
    dim, the mesh dims (of more than one rank) it is split over and this
    rank's [start, stop) along it."""
    mesh: object
    dims: Tuple[Tuple[str, ...], ...]
    ranges: Tuple[Tuple[int, int], ...]

    def start(self, d: int) -> int:
        return self.ranges[d][0]

    def whole(self, d: int) -> int:
        """The full length of dim ``d``."""
        lo, hi = self.ranges[d]
        return (hi - lo) * collectives.group_size(self.mesh, self.dims[d])


def cache_slices(cache_specs: PyTree, cfg: ModelConfig, mesh,
                 global_batch: int) -> PyTree:
    """:func:`cache_pspecs` on the ``DeviceMesh`` ``mesh`` as a
    :class:`CacheSlice` for each leaf of one layer (the leaves of
    ``cache_specs`` carry the stacked layers dim first, which no rule
    splits): a tuple over pattern positions of ``{name: CacheSlice}``."""
    names = tuple(mesh.mesh_dim_names)
    out = []
    for layer, specs in zip(cache_specs,
                            cache_pspecs(cache_specs, cfg, mesh,
                                         global_batch)):
        one = {}
        for name, (shape, _) in layer.items():
            spec = specs[name]
            ranges = NamedSharding(mesh, spec).local_ranges(shape)
            dims = tuple(tuple(a for a in axis_members(e)
                               if mesh.size(names.index(a)) > 1)
                         for e in spec)
            if dims[0]:
                raise ValueError(f"{name}: {spec} splits the layers dim")
            one[name] = CacheSlice(mesh, dims[1:], ranges[1:])
        out.append(one)
    return tuple(out)


def contiguous_strides(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``, allocating nothing
    (not even a meta tensor, which a dry run would count)."""
    strides, step = [], 1
    for n in reversed(tuple(shape)):
        strides.append(step)
        step *= max(n, 1)
    return tuple(reversed(strides))


def from_local(local: torch.Tensor, sharding: NamedSharding, shape):
    """A DTensor of the full ``shape`` whose slice on this rank (by
    ``sharding``) is ``local``: no collective."""
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=shape,
                              stride=contiguous_strides(shape))


def shard_tensor(t: torch.Tensor, sharding: NamedSharding):
    """A DTensor of the full tensor ``t`` (on every rank) from this rank's
    slice, on the mesh's device type: no collective."""
    return from_local(
        sharding.local_slice(t).to(sharding.mesh.device_type).contiguous(),
        sharding, t.shape)


def local_tree(tree: PyTree, pspecs: PyTree, mesh) -> PyTree:
    """Each leaf of ``tree`` (full tensors) cut to this rank's slice by its
    :class:`PartitionSpec` in ``pspecs``: a contiguous copy of its own on
    the mesh's device type, the tree the compute on sharded weights takes
    (``lm.lm_logits(..., mesh=)``, ``train.steps.make_train_step(...,
    mesh=)``)."""
    leaves = [t for _, t in tree_leaves_with_names(tree)]
    specs = [p for _, p in tree_leaves_with_names(pspecs)]
    if len(leaves) != len(specs):
        raise ValueError(f"{len(leaves)} leaves against {len(specs)} specs")
    return tree_unflatten_like(tree, [
        NamedSharding(mesh, p).local_slice(t).to(
            mesh.device_type).contiguous().clone()
        for t, p in zip(leaves, specs)])


def to_local(tree: PyTree) -> PyTree:
    """A tree whose DTensor leaves (``shard_tree``'s, or a sharded
    restore's) are their local tensors; other leaves as they are."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda t: t.to_local() if isinstance(t, DTensor) else t,
                    tree)


def shard_tree(tree: PyTree, pspecs: PyTree, mesh) -> PyTree:
    """Each leaf of ``tree`` (full tensors, the same on every rank) as a
    DTensor split by its :class:`PartitionSpec` in ``pspecs`` (a tree of
    the same layout) on the ``DeviceMesh`` ``mesh``."""
    leaves = [t for _, t in tree_leaves_with_names(tree)]
    specs = [p for _, p in tree_leaves_with_names(pspecs)]
    if len(leaves) != len(specs):
        raise ValueError(f"{len(leaves)} leaves against {len(specs)} specs")
    return tree_unflatten_like(tree, [
        shard_tensor(t, NamedSharding(mesh, p))
        for t, p in zip(leaves, specs)])


# ---------------------------------------------------------------------------
# Activations on a mesh
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BatchLayout:
    """How a (B, S, ...) activation is split on a ``DeviceMesh``: its batch
    over the mesh dims ``batch_dims`` (row-major, the first outermost), its
    sequence over ``seq_dims``; every other mesh dim holds a copy.  Each
    rank holds the slice at its coordinates."""
    mesh: object
    batch_dims: Tuple[str, ...] = ()
    seq_dims: Tuple[str, ...] = ()

    def spec(self, batch: bool = True) -> PartitionSpec:
        return P(self.batch_dims or None if batch else None,
                 self.seq_dims or None)

    def placements(self) -> tuple:
        return NamedSharding(self.mesh, self.spec()).placements

    def seq_start(self, seq: int) -> int:
        """The global index of this rank's first position of ``seq``."""
        if not self.seq_dims:
            return 0
        return (collectives.group_rank(self.mesh, self.seq_dims) * seq
                // collectives.group_size(self.mesh, self.seq_dims))

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's batch rows of ``t`` (B, ...), every position."""
        return NamedSharding(self.mesh, P(self.batch_dims or None)
                             ).local_slice(t)

    def local(self, t: torch.Tensor, batch: bool = True) -> torch.Tensor:
        """This rank's slice of the full ``t`` (B, S, ...); with ``batch``
        False, of the sequence only (for a tensor whose leading dim is not
        the batch, or that is already the rank's batch)."""
        return NamedSharding(self.mesh, self.spec(batch)).local_slice(t)

    def dtensor(self, local: torch.Tensor, full_shape,
                vocab_dims: Tuple[str, ...] = ()):
        """This rank's slice ``local`` as a DTensor of ``full_shape``; its
        last dim split over ``vocab_dims`` too (the logits under
        ``megatron``)."""
        from torch.distributed.tensor import DTensor
        spec = self.spec()
        if vocab_dims:
            spec = P(*spec, *([None] * (len(full_shape) - 3)),
                     vocab_dims)
        return DTensor.from_local(
            local, self.mesh, NamedSharding(self.mesh, spec).placements,
            run_check=False,
            shape=torch.Size(full_shape),
            stride=contiguous_strides(full_shape))
