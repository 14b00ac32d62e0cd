"""Train / serve steps.

``make_train_step``: loss -> grads -> AdamW, with optional micro-batch
accumulation.  ``make_prefill_step`` and ``make_serve_step`` run without
autograd.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.models.common import PyTree, tree_leaves
from repro_torch.optim.adamw import OptimizerConfig, adamw_update


def make_train_step(cfg: ModelConfig, opt: OptimizerConfig,
                    attn_impl: str = "plain",
                    microbatches: int = 1) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), updating ``params`` and ``opt_state`` in place.

    Attention takes the plain route, as the JAX package's step takes XLA
    attention: no kernel has a backward.  ``microbatches > 1`` accumulates
    gradients in float32 over sequential micro-batches (splitting the
    leading batch dim) before the optimizer update — the standard
    activation-memory lever.
    """

    def grads_of(leaves, params, batch):
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss, metrics = lm.lm_loss(params, batch, cfg,
                                       attn_impl=attn_impl)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), metrics, list(grads)

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
                                                      opt_state, opt)
        del grads
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, attn_impl: str = "kernel",
                      mesh=None) -> Callable:
    """Forward-only logits over a full prompt (the inference-prefill cell);
    attention goes through the ``flash_attention`` kernel.  With ``mesh``
    (a ``DeviceMesh``) every rank passes the whole prompt and gets a
    DTensor of its slice (``lm.lm_logits``)."""

    @torch.no_grad()
    def prefill_step(params: PyTree, batch: Dict[str, torch.Tensor]):
        return lm.lm_logits(params, batch, cfg, attn_impl=attn_impl,
                            mesh=mesh)

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """One-token decode: (params, caches, token, pos) -> (logits, caches)."""

    @torch.no_grad()
    def serve_step(params: PyTree, caches: PyTree, token: torch.Tensor,
                   pos: int):
        return lm.decode_step(params, caches, token, pos, cfg)

    return serve_step
