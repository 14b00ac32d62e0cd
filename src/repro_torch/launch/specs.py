"""Abstract input specs per (arch x shape x mesh) cell, as the JAX package's
``launch/specs.py`` builds them.

Where the JAX package gives each argument as a ``ShapeDtypeStruct`` with a
``NamedSharding`` and lets the compiler partition the step, the port traces
one rank's step (``launch.dryrun``): each argument is a ``meta`` tensor
(shape and dtype, no storage) of the rank's local shape, its slice by the port's
:class:`~repro_torch.parallel.sharding.NamedSharding`, and beside it an
:class:`ArgSpec` holding the global shape, dtype and sharding.  Nothing is
allocated on any device, so a 398B-parameter training step traces on a
laptop.  Every rule splits a dim only where the split divides it (a split
that does not divide raises, here as in ``NamedSharding.shard_shape``): no
argument is padded.

The port's steps take the whole batch on every rank and cut their own rows
(``models.lm``).  A batch argument is therefore the rank's slice viewed at
the whole batch's shape with stride 0 over the batch (no copy): the step's
cut reads only the slice, and the slice is all that the rank holds.  The
decode position is a host integer in the port (the slot a step writes is
picked on the host); its argument is an int32 scalar, as the JAX cell's,
and the trace decodes at the cache's last position.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import blocks as blocks_lib
from repro_torch.models import lm
from repro_torch.models.common import (DTYPES, PyTree, stack_specs,
                                       take_layer, tree_leaves, tree_map,
                                       tree_unflatten_like)
from repro_torch.optim.adamw import OptimizerConfig, opt_state_specs
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor_parallel
from repro_torch.parallel.sharding import P
from repro_torch.train import steps as steps_lib


@dataclasses.dataclass(frozen=True)
class ArgSpec:
    """One argument leaf: its global ``shape`` and ``dtype`` and its
    ``sharding`` (a ``NamedSharding``: the mesh and the PartitionSpec)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    sharding: shd.NamedSharding

    @property
    def local_shape(self) -> Tuple[int, ...]:
        """This rank's slice's shape."""
        return tuple(hi - lo for lo, hi in
                     self.sharding.local_ranges(self.shape))

    @property
    def local_bytes(self) -> int:
        return (math.prod(self.local_shape)
                * torch.empty((), dtype=self.dtype).element_size())


def _spec_tree(specs: PyTree, pspecs: PyTree, mesh) -> PyTree:
    """ParamSpec tree and PartitionSpec tree -> ArgSpec tree."""
    return tree_unflatten_like(specs, [
        ArgSpec(tuple(s.shape), s.dtype, shd.NamedSharding(mesh, p))
        for s, p in zip(tree_leaves(specs), tree_leaves(pspecs))])


def _seq_split(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[int, int]:
    """(enc_len, dec_len): enc-dec archs split context 50/50 (DESIGN.md §6)."""
    if cfg.encoder_decoder:
        return shape.seq_len // 2, shape.seq_len // 2
    return 0, shape.seq_len


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> PyTree:
    """The ArgSpecs of a train/prefill cell's batch."""
    b = shape.global_batch
    enc_len, s = _seq_split(cfg, shape)
    bsh = shd.NamedSharding(mesh, shd.batch_pspec(
        mesh, b, extra_dims=1, strategy=cfg.shard_strategy))
    batch: Dict[str, Any] = {"tokens": ArgSpec((b, s), torch.int32, bsh)}
    if shape.kind == "train":
        batch["targets"] = ArgSpec((b, s), torch.int32, bsh)
    act = DTYPES[cfg.dtype]
    wide = shd.NamedSharding(mesh, shd.batch_pspec(mesh, b, extra_dims=2))
    if cfg.vision_tokens:
        batch["vision_embeds"] = ArgSpec((b, cfg.vision_tokens, cfg.d_model),
                                         act, wide)
    if cfg.encoder_decoder:
        batch["enc_embeds"] = ArgSpec((b, enc_len, cfg.d_model), act, wide)
    return batch


@dataclasses.dataclass
class Cell:
    """Everything needed to trace one (arch x shape x mesh) cell: ``fn``
    called on ``args`` (meta tensors, the rank's slices) runs the rank's
    step; ``specs`` holds an :class:`ArgSpec`
    beside each argument leaf; ``host`` names the arguments (top-level
    positions) that the step reads on the host rather than on the device."""
    fn: Callable
    args: Tuple[Any, ...]
    specs: Tuple[Any, ...]
    static: Dict[str, Any]
    host: Tuple[int, ...] = ()


def meta_slice(spec: ArgSpec) -> torch.Tensor:
    """A meta tensor of the rank's slice: the arguments of a trace."""
    return torch.empty(spec.local_shape, dtype=spec.dtype, device="meta")


def _arg(spec: ArgSpec, make, whole: bool = False) -> torch.Tensor:
    """``make``'s tensor of the rank's slice (``whole``: viewed at the
    global shape with stride 0 over dim 0, the batch)."""
    local = make(spec)
    if whole and local.shape != torch.Size(spec.shape):
        if tuple(local.shape[1:]) != tuple(spec.shape[1:]):
            raise ValueError(f"a batch split past dim 0: {spec}")
        local = local.as_strided(spec.shape, (0,) + local.stride()[1:])
    return local


def _args(specs: PyTree, make, whole: bool = False) -> PyTree:
    return tree_map(lambda s: _arg(s, make, whole), specs)


def _cache_specs(cspecs: PyTree, cfg: ModelConfig, mesh, batch: int) -> PyTree:
    """``lm.cache_specs``-style ``{name: (shape, dtype)}`` layers -> ArgSpec
    layers placed by ``cache_pspecs``."""
    return tuple({name: ArgSpec(shp, dt, shd.NamedSharding(mesh, ps[name]))
                  for name, (shp, dt) in layer.items()}
                 for layer, ps in zip(cspecs, shd.cache_pspecs(
                     cspecs, cfg, mesh, batch)))


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               opt: Optional[OptimizerConfig] = None,
               attn_impl: Optional[str] = None, make=meta_slice) -> Cell:
    """The cell of ``cfg`` x ``shape`` on the ``DeviceMesh`` ``mesh``:
    a train step (``steps.make_train_step(mesh=)``: the parameters, the
    AdamW state and the batch), a prefill (``make_prefill_step(mesh=)``:
    the serving parameters and the batch) or one decode step
    (``make_serve_step(mesh=)``: the serving parameters, the caches of a
    ``seq_len`` context as DTensors of the rank's ``cache_pspecs`` slices,
    the token batch and the position).  ``attn_impl`` defaults to each
    step's own (plain for training, the kernel for prefill).  ``make``
    gives the tensor of an :class:`ArgSpec`'s slice: a meta tensor, or real
    data to run the cell on a real group."""
    pspecs_all = lm.model_specs(cfg)
    impl = {} if attn_impl is None else {"attn_impl": attn_impl}
    if shape.kind == "train":
        opt = opt or OptimizerConfig(state_dtype=cfg.opt_state_dtype)
        pspec = shd.param_pspecs(pspecs_all, cfg, mesh)
        params = _spec_tree(pspecs_all, pspec, mesh)
        ospecs = opt_state_specs(pspecs_all, opt)
        ostate = {"mu": _spec_tree(ospecs["mu"], shd.opt_pspecs(
                      ospecs["mu"], cfg, mesh), mesh),
                  "nu": _spec_tree(ospecs["nu"], shd.opt_pspecs(
                      ospecs["nu"], cfg, mesh), mesh),
                  "step": ArgSpec((), torch.int32,
                                  shd.NamedSharding(mesh, P()))}
        batch = batch_specs(cfg, shape, mesh)
        step = steps_lib.make_train_step(cfg, opt, mesh=mesh, **impl)
        args = (_args(params, make),
                _args(ostate, make),
                _args(batch, make, whole=True))
        return Cell(step, args, (params, ostate, batch), {"kind": "train"})

    params = _spec_tree(pspecs_all, lm.serve_pspecs(cfg, mesh), mesh)

    if shape.kind == "prefill":
        batch = batch_specs(cfg, shape, mesh)
        step = steps_lib.make_prefill_step(cfg, mesh=mesh, **impl)
        args = (_args(params, make),
                _args(batch, make, whole=True))
        return Cell(step, args, (params, batch), {"kind": "prefill"})

    # decode: one new token over a seq_len cache
    b = shape.global_batch
    enc_len, s = _seq_split(cfg, shape)
    cspecs = lm.cache_specs(cfg, b, s, cross_len=enc_len)
    caches = _cache_specs(cspecs, cfg, mesh, b)
    tok = ArgSpec((b, 1), torch.int32, shd.NamedSharding(
        mesh, shd.batch_pspec(mesh, b, extra_dims=1)))
    pos = ArgSpec((), torch.int32, shd.NamedSharding(mesh, P()))
    serve = steps_lib.make_serve_step(cfg, mesh=mesh)

    def fn(p, c, token, _pos):
        return serve(p, c, token, s - 1)

    cache_args = tree_map(
        lambda a: shd.from_local(_arg(a, make), a.sharding, a.shape),
        caches)
    args = (_args(params, make), cache_args,
            _arg(tok, make, whole=True), _arg(pos, make))
    return Cell(fn, args, (params, caches, tok, pos), {"kind": "decode"},
                host=(3,))


# ---------------------------------------------------------------------------
# Block-level cells (one layer-block with the full cell's shardings)
# ---------------------------------------------------------------------------

def build_block_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     attn_impl: Optional[str] = None,
                     make=meta_slice) -> Cell:
    """One layer-block traced alone with identical shardings, on the rank's
    slice of the activations (``lm._constrain_batch``'s layout), without
    RoPE angles or encoder output (the JAX package's block cell passes
    neither).  The JAX package needs it to scale a scanned graph, whose
    body XLA counts once; the port's traces cover every layer
    (``launch.roofline``), and the block gives the per-block cost.

    A decode block's caches carry a leading dim of 1; a train block takes
    the gradient with respect to the activations only (the parameters'
    gradient and its reduction belong to the full step)."""
    impl = attn_impl or ("plain" if shape.kind == "train" else "kernel")
    b = shape.global_batch
    enc_len, s = _seq_split(cfg, shape)
    block_specs_tree = tuple(
        stack_specs(t, 1) for t in blocks_lib.block_specs(
            cfg, cross=cfg.encoder_decoder))
    serve_fsdp = (shape.kind != "train") and (cfg.fsdp or
                                              shd.serve_needs_fsdp(cfg, mesh))
    bpspecs = shd.param_pspecs(
        block_specs_tree, cfg, mesh,
        fsdp=cfg.fsdp if shape.kind == "train" else serve_fsdp)
    bparams = _spec_tree(block_specs_tree, bpspecs, mesh)
    act = DTYPES[cfg.dtype]

    def gathered(bp):
        return tensor_parallel.gather_fsdp(take_layer(bp, 0), bpspecs, mesh,
                                           offset=1)

    if shape.kind == "decode":
        # single-layer caches (leading dim 1)
        single = []
        for lspec in cfg.pattern:
            layer = blocks_lib.layer_cache_specs(
                cfg, lspec, b, s, enc_len if cfg.encoder_decoder else 0)
            single.append({name: ((1,) + shp, dt)
                           for name, (shp, dt) in layer.items()})
        cspecs = tuple(single)
        caches = _cache_specs(cspecs, cfg, mesh, b)
        layout = lm._serve_layout(mesh, b)
        h = ArgSpec((b, 1, cfg.d_model), act,
                    shd.NamedSharding(mesh, P(*layout.spec(), None)))
        pos = ArgSpec((), torch.int32, shd.NamedSharding(mesh, P()))
        tp = tensor_parallel.model_group(mesh)
        shards = tuple(blocks_lib.DecodeShards(layout, tp, sl) for sl in
                       shd.cache_slices(cspecs, cfg, mesh, b))

        @torch.no_grad()
        def fn(bp, c, hh, _pos):
            out, nc = blocks_lib.block_decode(
                gathered(bp), hh, take_layer(c, 0), s - 1, cfg, None, shards)
            return out, c

        args = (_args(bparams, make),
                _args(caches, make), _arg(h, make),
                _arg(pos, make))
        return Cell(fn, args, (bparams, caches, h, pos),
                    {"kind": "decode_block"}, host=(3,))

    layout = lm._constrain_batch(cfg, mesh, b, s)
    h = ArgSpec((b, s, cfg.d_model), act,
                shd.NamedSharding(mesh, P(*layout.spec(), None)))

    if shape.kind == "train":
        from torch.utils.checkpoint import checkpoint

        def fn(bp, hh):
            def loss(h_):
                out, aux = blocks_lib.block_fwd(gathered(bp), h_, cfg, None,
                                                True, attn_impl=impl,
                                                layout=layout)
                return torch.mean(out.float() ** 2) + aux

            hh = hh.detach().requires_grad_(True)
            with torch.enable_grad():
                value = (checkpoint(loss, hh, use_reentrant=False)
                         if cfg.remat == "full" else loss(hh))
                return torch.autograd.grad(value, hh)[0]

        args = (_args(bparams, make), _arg(h, make))
        return Cell(fn, args, (bparams, h), {"kind": "train_block"})

    @torch.no_grad()
    def fn(bp, hh):
        out, _ = blocks_lib.block_fwd(gathered(bp), hh, cfg, None, True,
                                      attn_impl=impl, layout=layout)
        return out

    args = (_args(bparams, make), _arg(h, make))
    return Cell(fn, args, (bparams, h), {"kind": "prefill_block"})
