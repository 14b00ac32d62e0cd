"""Serve steps: the prefill forward and the one-token decode.

``make_train_step`` (loss, grads, AdamW) waits for the training slice of the
port (ROADMAP A1).  Both steps run without autograd.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.models.common import PyTree


def make_prefill_step(cfg: ModelConfig, attn_impl: str = "kernel") -> Callable:
    """Forward-only logits over a full prompt (the inference-prefill cell);
    attention goes through the ``flash_attention`` kernel."""

    @torch.no_grad()
    def prefill_step(params: PyTree, batch: Dict[str, torch.Tensor]):
        return lm.lm_logits(params, batch, cfg, attn_impl=attn_impl)

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """One-token decode: (params, caches, token, pos) -> (logits, caches)."""

    @torch.no_grad()
    def serve_step(params: PyTree, caches: PyTree, token: torch.Tensor,
                   pos: int):
        return lm.decode_step(params, caches, token, pos, cfg)

    return serve_step
