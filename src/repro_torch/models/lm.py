"""Unified decoder-only LM built from ``repro_torch.models.blocks``.

Parameters have the JAX package's layout: per-position trees stacked over
``n_repeats`` on a leading axis; the port loops over the repeats in Python
(PyTorch runs eagerly; nothing needs ``lax.scan``).  No mesh constraints:
the port runs on one device.  Vision inputs (qwen2-vl, M-RoPE) and the
encoder-decoder stack (seamless) are not ported yet (ROADMAP A3) and raise.

All entry points are inference-only: call them under ``torch.no_grad()``
(or ``torch.inference_mode()``) when the parameters require grad.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import blocks, rope as rope_lib
from repro_torch.models.common import (DTYPES, ParamSpec, PyTree,
                                       init_params, params_from_jax, rmsnorm,
                                       rmsnorm_specs, stack_specs, take_layer)

__all__ = ["model_specs", "init_model", "params_from_jax", "forward_hidden",
           "lm_logits", "init_cache", "decode_step", "prefill"]


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder stack is not ported yet: "
            "ROADMAP A3")
    if cfg.vision_tokens or cfg.mrope_sections:
        raise NotImplementedError(
            f"{cfg.name}: vision inputs and M-RoPE are not ported yet: "
            "ROADMAP A3")


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def model_specs(cfg: ModelConfig) -> PyTree:
    _check_supported(cfg)
    d = cfg.d_model
    v = cfg.padded_vocab
    dt = DTYPES[cfg.param_dtype]
    specs: Dict[str, Any] = {
        "embed": ParamSpec((v, d), dt),
        "blocks": tuple(stack_specs(t, cfg.n_repeats)
                        for t in blocks.block_specs(cfg)),
        "final_norm": rmsnorm_specs(d, dt),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((d, v), dt)
    return specs


def init_model(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               device=None) -> PyTree:
    """Seeded parameters drawn as the JAX package's ``init_model`` draws
    them (normal / sqrt(fan_in)), on ``device`` (CUDA unless the caller asks
    for another); the streams differ between frameworks, so parity tests
    carry JAX weights across with :func:`params_from_jax`."""
    return init_params(model_specs(cfg), generator, device)


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------

def _embed_tokens(params: PyTree, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


def _angles_for(cfg: ModelConfig, seq: int, device,
                position: Optional[int] = None) -> torch.Tensor:
    """RoPE angles (1, S, hd//2) for positions 0..S-1, or (1, 1, hd//2) for
    the one decode ``position``."""
    pos = (torch.arange(seq, device=device) if position is None
           else torch.tensor([position], device=device))
    return rope_lib.rope_angles(pos[None], cfg.resolved_head_dim,
                                cfg.rope_theta)


def _run_blocks(params: PyTree, h: torch.Tensor, cfg: ModelConfig, angles,
                causal: bool, attn_impl: str = "kernel") -> torch.Tensor:
    for i in range(cfg.n_repeats):
        h = blocks.block_fwd(take_layer(params["blocks"], i), h, cfg, angles,
                             causal, attn_impl=attn_impl)
    return h


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def forward_hidden(params: PyTree, batch: Dict[str, torch.Tensor],
                   cfg: ModelConfig, attn_impl: str = "kernel"):
    """Returns (final hidden states (B,S,D), aux_loss).  ``aux_loss`` is 0:
    it comes from MoE routers, which are not ported."""
    _check_supported(cfg)
    if "vision_embeds" in batch or "enc_embeds" in batch:
        raise NotImplementedError(
            "vision and encoder inputs are not ported yet: ROADMAP A3")
    tokens = batch["tokens"]
    h = _embed_tokens(params, tokens)
    angles = _angles_for(cfg, tokens.shape[1], tokens.device)
    h = _run_blocks(params, h, cfg, angles, causal=True, attn_impl=attn_impl)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return rmsnorm(params["final_norm"], h, cfg.norm_eps), aux


def _unembed(params: PyTree, h: torch.Tensor, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return torch.matmul(h, params["embed"].t())
    return torch.matmul(h, params["unembed"])


def lm_logits(params: PyTree, batch: Dict[str, torch.Tensor],
              cfg: ModelConfig, attn_impl: str = "kernel") -> torch.Tensor:
    """Logits (B, S, padded_vocab) over a full prompt."""
    h, _ = forward_hidden(params, batch, cfg, attn_impl=attn_impl)
    return _unembed(params, h, cfg)


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq: int,
               device=None) -> PyTree:
    """Zeroed decode caches: a tuple over pattern positions, each a dict of
    tensors with a leading ``n_repeats`` axis, on ``device`` (CUDA unless
    the caller asks for another)."""
    _check_supported(cfg)
    device = resolve_device(device)
    out = []
    for spec in cfg.pattern:
        layer = blocks.layer_cache_specs(cfg, spec, batch, seq)
        out.append({name: torch.zeros((cfg.n_repeats,) + shape, dtype=dt,
                                      device=device)
                    for name, (shape, dt) in layer.items()})
    return tuple(out)


def decode_step(params: PyTree, caches: PyTree, token: torch.Tensor,
                pos: int, cfg: ModelConfig):
    """One decode step.  token (B,1) integer; pos the current length.

    Returns (logits (B,1,V), caches).  The caches are ring buffers updated
    in place (see ``attention.attention_decode``)."""
    h = _embed_tokens(params, token)
    angles = _angles_for(cfg, 1, token.device, position=int(pos))
    for i in range(cfg.n_repeats):
        layer_caches = take_layer(caches, i)
        h, _ = blocks.block_decode(take_layer(params["blocks"], i), h,
                                   layer_caches, int(pos), cfg, angles)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return _unembed(params, h, cfg), caches


def prefill(params: PyTree, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            cache_len: int):
    """Run the full prompt by replaying it one token at a time through
    :func:`decode_step` (exact), materializing decode caches of capacity
    ``cache_len``.  Returns (logits (B,S,V), caches)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    caches = init_cache(cfg, b, cache_len, device=tokens.device)
    logits = []
    for i in range(s):
        lg, caches = decode_step(params, caches, tokens[:, i:i + 1], i, cfg)
        logits.append(lg[:, 0])
    return torch.stack(logits, dim=1), caches
