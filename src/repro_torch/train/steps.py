"""Train / serve steps.

``make_train_step``: loss -> grads -> AdamW, with optional micro-batch
accumulation, on one device or on a mesh.  ``make_prefill_step`` and
``make_serve_step`` run without autograd.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.models.common import PyTree, tree_leaves
from repro_torch.optim.adamw import (OptimizerConfig, adamw_update,
                                    init_opt_state)
from repro_torch.parallel import collectives, tensor_parallel
from repro_torch.parallel import sharding as shd


def make_train_step(cfg: ModelConfig, opt: OptimizerConfig,
                    attn_impl: str = "plain", microbatches: int = 1,
                    mesh=None) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), updating ``params`` and ``opt_state`` in place.

    Attention takes the plain route, as the JAX package's step takes XLA
    attention: no kernel has a backward.  ``microbatches > 1`` accumulates
    gradients in float32 over sequential micro-batches (splitting the
    leading batch dim) before the optimizer update — the standard
    activation-memory lever.

    With ``mesh`` (a ``DeviceMesh``; any strategy, with or without fsdp,
    but not with the sequence split over ``model``, see ``lm.lm_loss``)
    every rank passes the whole batch, and ``params`` and
    ``opt_state`` hold its slices of the leaves as ``param_pspecs`` and
    ``opt_pspecs`` cut them (``parallel.sharding.local_tree``;
    :func:`init_train_state`): each rank computes its share of the
    gradient (``lm.lm_loss(..., mesh=)``), sums each leaf's over the batch
    dims it is not split on (fsdp's leaves were summed by their gathers'
    backward), and steps its slices, the clipping norm spanning the mesh;
    a leaf whose moments are sliced otherwise (ZeRO-1) steps on the
    moments' slice and is gathered back.  The metrics are the whole
    batch's on every rank."""
    split = zero = None
    if mesh is not None:
        specs = lm.model_specs(cfg)
        pspecs = tree_leaves(shd.param_pspecs(specs, cfg, mesh))
        split = tensor_parallel.split_dims(pspecs, mesh)
        zero = [None if p == o else tensor_parallel.MomentSlice(mesh, p, o)
                for p, o in zip(pspecs, tree_leaves(
                    shd.opt_pspecs(specs, cfg, mesh)))]

    def sum_shares(grads, batch):
        """Each leaf's gradient summed over the batch dims (pod, data) it
        is not split on, and over ``model`` where the batch is split over
        it (pure_dp) and the leaf is not."""
        layout = lm._constrain_batch(cfg, mesh, *batch["tokens"].shape)
        for g, dims in zip(grads, split):
            among = shd.batch_axes(mesh) + tuple(
                a for a in layout.batch_dims if a == "model")
            collectives.all_reduce(
                g, mesh, tensor_parallel.replicas_of(dims, mesh, among))

    def grads_of(leaves, params, batch):
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss, metrics = lm.lm_loss(params, batch, cfg,
                                       attn_impl=attn_impl, mesh=mesh)
            grads = list(torch.autograd.grad(loss, leaves))
        if mesh is not None:
            sum_shares(grads, batch)
        return loss.detach(), metrics, grads

    def accumulated(leaves, params, batch):
        def split(x):
            b = x.shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{microbatches} micro-batches")
            return x.reshape(microbatches, b // microbatches, *x.shape[1:])

        micro = {k: split(v) for k, v in batch.items()}
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        loss_sum = 0.0
        for i in range(microbatches):
            loss, _, grads = grads_of(leaves, params,
                                      {k: v[i] for k, v in micro.items()})
            for a, g in zip(acc, grads):
                a.add_(g)
            del grads
            loss_sum = loss_sum + loss
        for a in acc:
            a.div_(microbatches)
        loss = loss_sum / microbatches
        return loss, {"ce_loss": loss}, acc

    def train_step(params: PyTree, opt_state: PyTree,
                   batch: Dict[str, torch.Tensor]):
        leaves = tree_leaves(params)
        if microbatches > 1:
            loss, metrics, grads = accumulated(leaves, params, batch)
        else:
            loss, metrics, grads = grads_of(leaves, params, batch)
        params, opt_state, opt_metrics = adamw_update(params, grads,
                                                      opt_state, opt, mesh,
                                                      split, zero)
        del grads
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def init_train_state(params: PyTree, opt: OptimizerConfig,
                     cfg: ModelConfig, mesh=None) -> Dict:
    """``init_opt_state`` of ``params``; with ``mesh`` (``params`` this
    rank's slices), each moment at this rank's slice by ``opt_pspecs``:
    the leaves' own under ``megatron``, ZeRO-1's under ``pure_dp``,
    ``seq_dp`` and ``ep_seq``."""
    if mesh is None:
        return init_opt_state(params, opt)
    specs = tree_leaves(lm.model_specs(cfg))
    ospecs = tree_leaves(shd.opt_pspecs(lm.model_specs(cfg), cfg, mesh))
    return init_opt_state(params, opt, [
        tuple(hi - lo for lo, hi in shd.NamedSharding(mesh, o).local_ranges(
            s.shape)) for s, o in zip(specs, ospecs)])


def make_prefill_step(cfg: ModelConfig, attn_impl: str = "kernel",
                      mesh=None) -> Callable:
    """Forward-only logits over a full prompt (the inference-prefill cell);
    attention goes through the ``flash_attention`` kernel.  With ``mesh``
    (a ``DeviceMesh``) every rank passes the whole prompt and its serving
    slices of the parameters (``lm.serve_pspecs``, as for
    :func:`make_serve_step`) and gets a DTensor of its slice
    (``lm.lm_logits``)."""

    @torch.no_grad()
    def prefill_step(params: PyTree, batch: Dict[str, torch.Tensor]):
        return lm.lm_logits(params, batch, cfg, attn_impl=attn_impl,
                            mesh=mesh)

    return prefill_step


def make_serve_step(cfg: ModelConfig, mesh=None) -> Callable:
    """One-token decode: (params, caches, token, pos) -> (logits, caches).
    With ``mesh`` (a ``DeviceMesh``) every rank passes the whole token
    batch, its serving slices of the parameters (``lm.serve_pspecs``) and
    the caches of ``lm.init_cache(..., mesh=)`` (``lm.decode_step``); the
    step's placements (``lm.mesh_decoder``) are built once for each cache
    layout and batch it meets."""
    plans = {}

    @torch.no_grad()
    def serve_step(params: PyTree, caches: PyTree, token: torch.Tensor,
                   pos: int):
        plan = None
        if mesh is not None:
            key = (token.shape[0], tuple(
                (name, tuple(t.shape), t.dtype)
                for layer in caches for name, t in layer.items()))
            if key not in plans:
                plans[key] = lm.mesh_decoder(cfg, mesh, caches, key[0])
            plan = plans[key]
        return lm.decode_step(params, caches, token, pos, cfg, mesh=mesh,
                              plan=plan)

    return serve_step
