"""Layer-block assembly: (norm -> mixer -> residual) + (norm -> mlp ->
residual) per :class:`repro_torch.configs.base.LayerSpec`, with decode
variants threading per-layer state.  One *block* = one period of the
config's repeating pattern; ``lm.py`` loops over ``n_repeats`` blocks with
stacked parameters.

Ported: mixer ``attn`` with mlp ``dense`` (or ``none``).  The ``mamba``,
``mlstm`` and ``slstm`` mixers and ``moe`` MLPs raise
``NotImplementedError`` (ROADMAP A3); cross-attention comes with the
encoder-decoder stack, which ``lm`` refuses.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention, mlp
from repro_torch.models.common import DTYPES, PyTree, rmsnorm, rmsnorm_specs


def _check_spec(spec: LayerSpec) -> None:
    if spec.mixer != "attn":
        raise NotImplementedError(
            f"mixer {spec.mixer!r} is not ported yet: ROADMAP A3")
    if spec.mlp not in ("dense", "none"):
        raise NotImplementedError(
            f"mlp {spec.mlp!r} is not ported yet: ROADMAP A3")


def layer_specs(cfg: ModelConfig, spec: LayerSpec) -> PyTree:
    _check_spec(spec)
    d = cfg.d_model
    dt = DTYPES[cfg.param_dtype]
    out: Dict[str, Any] = {"norm1": rmsnorm_specs(d, dt),
                           "attn": attention.attention_specs(cfg)}
    if spec.mlp == "dense":
        out["norm2"] = rmsnorm_specs(d, dt)
        out["mlp"] = mlp.mlp_specs(cfg)
    return out


def block_specs(cfg: ModelConfig) -> Tuple[PyTree, ...]:
    """One period: a tuple of per-position layer spec trees."""
    return tuple(layer_specs(cfg, s) for s in cfg.pattern)


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------

def layer_fwd(params: PyTree, h: torch.Tensor, cfg: ModelConfig,
              spec: LayerSpec, angles: Optional[torch.Tensor], causal: bool,
              attn_impl: str = "kernel") -> torch.Tensor:
    x = rmsnorm(params["norm1"], h, cfg.norm_eps)
    h = h + attention.attention_fwd(params["attn"], x, cfg, causal=causal,
                                    angles=angles, impl=attn_impl)
    if spec.mlp == "dense":
        x2 = rmsnorm(params["norm2"], h, cfg.norm_eps)
        h = h + mlp.mlp_fwd(params["mlp"], x2)
    return h


def block_fwd(params_tuple: Tuple[PyTree, ...], h: torch.Tensor,
              cfg: ModelConfig, angles: Optional[torch.Tensor], causal: bool,
              attn_impl: str = "kernel") -> torch.Tensor:
    for pos, spec in enumerate(cfg.pattern):
        h = layer_fwd(params_tuple[pos], h, cfg, spec, angles, causal,
                      attn_impl=attn_impl)
    return h


# ---------------------------------------------------------------------------
# Decode (one token, stateful)
# ---------------------------------------------------------------------------

def layer_cache_specs(cfg: ModelConfig, spec: LayerSpec, batch: int,
                      seq: int) -> Dict[str, Tuple[Tuple[int, ...],
                                                   torch.dtype]]:
    """Per-layer decode state as ``{name: (shape, dtype)}``."""
    _check_spec(spec)
    kv = ((batch, seq, cfg.n_kv_heads, cfg.resolved_head_dim),
          DTYPES[cfg.dtype])
    return {"k": kv, "v": kv}


def layer_decode(params: PyTree, h: torch.Tensor, cache: PyTree, pos: int,
                 cfg: ModelConfig, spec: LayerSpec,
                 angles: Optional[torch.Tensor]) -> Tuple[torch.Tensor,
                                                          PyTree]:
    new_cache = dict(cache)
    x = rmsnorm(params["norm1"], h, cfg.norm_eps)
    mixed, new_cache["k"], new_cache["v"] = attention.attention_decode(
        params["attn"], x, cache["k"], cache["v"], pos, cfg, angles=angles)
    h = h + mixed
    if spec.mlp == "dense":
        x2 = rmsnorm(params["norm2"], h, cfg.norm_eps)
        h = h + mlp.mlp_fwd(params["mlp"], x2)
    return h, new_cache


def block_decode(params_tuple: Tuple[PyTree, ...], h: torch.Tensor,
                 caches: Tuple[PyTree, ...], pos: int, cfg: ModelConfig,
                 angles: Optional[torch.Tensor]):
    new_caches = []
    for p, spec in enumerate(cfg.pattern):
        h, c = layer_decode(params_tuple[p], h, caches[p], pos, cfg, spec,
                            angles)
        new_caches.append(c)
    return h, tuple(new_caches)
