"""Grouped-query attention: full-sequence self- and cross-attention
(training / prefill) through the ``flash_attention`` kernel, and
single-token decode over a ring-buffer KV cache or, for cross-attention,
over the encoder's precomputed K/V.

The JAX package's XLA implementation of full-sequence attention
(``blocked_attention``) is not copied: it computes the same function as the
kernel's plain version, and the parity tests hold the port against it.  Not
ported yet, each raising ``NotImplementedError``: the sequence-parallel
``seq_dp`` paths (ROADMAP A6), and the ``dus`` cache update and the
two-tier decode cache (ROADMAP A5).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (NEG_INF,
                                                     flash_attention_ref)
from repro_torch.models import rope as rope_lib
from repro_torch.models.common import DTYPES, ParamSpec, PyTree, rmsnorm

#: ``attn_impl`` values: the kernel's wrapper (the plain version on CPU
#: tensors) or the plain version on any device
ATTN_IMPLS = ("kernel", "plain")


def attention_specs(cfg: ModelConfig, cross: bool = False) -> PyTree:
    """Projections (d, H*hd), (d, Hk*hd) x 2, (H*hd, d); with ``qk_norm``
    also q_norm and k_norm, except for cross-attention."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    qd = cfg.n_heads * hd
    kvd = cfg.n_kv_heads * hd
    dt = DTYPES[cfg.param_dtype]
    specs = {
        "wq": ParamSpec((d, qd), dt),
        "wk": ParamSpec((d, kvd), dt),
        "wv": ParamSpec((d, kvd), dt),
        "wo": ParamSpec((qd, d), dt),
    }
    if cfg.qk_norm and not cross:
        specs["q_norm"] = ParamSpec((hd,), dt, init="ones")
        specs["k_norm"] = ParamSpec((hd,), dt, init="ones")
    return specs


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.shard_strategy in ("seq_dp", "ep_seq"):
        raise NotImplementedError(
            f"shard_strategy={cfg.shard_strategy!r} (sequence-parallel "
            "attention) is not ported yet: ROADMAP A6")
    if cfg.decode_cache_update != "masked":
        raise NotImplementedError(
            f"decode_cache_update={cfg.decode_cache_update!r} is not ported "
            "yet: ROADMAP A5")
    if cfg.decode_ring:
        raise NotImplementedError(
            "the two-tier decode cache (decode_ring > 0) is not ported yet: "
            "ROADMAP A5")


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------

def _project_qkv(params: PyTree, x: torch.Tensor, cfg: ModelConfig,
                 kv_x: Optional[torch.Tensor] = None):
    """x (B,S,D) -> q (B,S,H,hd), k/v (B,Skv,Hk,hd), k and v from ``kv_x``
    (B,Skv,D) when given (cross-attention), else from x."""
    hd = cfg.resolved_head_dim
    kv_src = x if kv_x is None else kv_x
    q = torch.matmul(x, params["wq"]).reshape(*x.shape[:2], cfg.n_heads, hd)
    k = torch.matmul(kv_src, params["wk"]).reshape(*kv_src.shape[:2],
                                                   cfg.n_kv_heads, hd)
    v = torch.matmul(kv_src, params["wv"]).reshape(*kv_src.shape[:2],
                                                   cfg.n_kv_heads, hd)
    if "q_norm" in params:
        q = rmsnorm({"scale": params["q_norm"]}, q, cfg.norm_eps)
        k = rmsnorm({"scale": params["k_norm"]}, k, cfg.norm_eps)
    return q, k, v


def _out_proj(params: PyTree, o: torch.Tensor, cfg: ModelConfig):
    b, s = o.shape[:2]
    return torch.matmul(o.reshape(b, s, cfg.n_heads * cfg.resolved_head_dim),
                        params["wo"])


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def attention_fwd(params: PyTree, x: torch.Tensor, cfg: ModelConfig,
                  causal: bool = True, angles: Optional[torch.Tensor] = None,
                  kv_x: Optional[torch.Tensor] = None,
                  impl: str = "kernel") -> torch.Tensor:
    """Full-sequence attention (training / prefill), x (B,S,D).  With
    ``kv_x`` (B,Skv,D), cross-attention: keys and values from ``kv_x``, no
    RoPE, no window, not causal.

    ``impl="kernel"`` goes through ``ops.flash_attention`` (the CUDA kernel
    for CUDA tensors, its plain version for CPU tensors); ``"plain"`` takes
    the plain version on any device, as a reference."""
    _check_supported(cfg)
    q, k, v = _project_qkv(params, x, cfg, kv_x)
    cross = kv_x is not None
    if angles is not None and not cross:
        q = rope_lib.apply_rope(q, angles)
        k = rope_lib.apply_rope(k, angles)
    causal = causal and not cross
    window = 0 if cross else cfg.sliding_window
    if impl == "kernel":
        o = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    elif impl == "plain":
        o = flash_attention_ref(q, k, v, causal=causal, window=window)
    else:
        raise ValueError(f"attn impl {impl!r}; have {ATTN_IMPLS}")
    return _out_proj(params, o, cfg)


def attention_decode(params: PyTree, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: int, cfg: ModelConfig,
                     angles: Optional[torch.Tensor] = None,
                     cross: bool = False):
    """One-token decode.  x (B,1,D); cache_k/v (B,S,Hk,hd) ring buffers.

    Returns (out (B,1,D), cache_k, cache_v).  The new token's K/V go into
    slot ``pos % S`` in place (the JAX package rewrites the cache through a
    one-hot ``where``; the values are the same and the port saves the copy),
    so the returned caches are the ones passed in.  With ``cross`` the cache
    holds the encoder's precomputed K/V: no k/v projection, no write, every
    key attended."""
    _check_supported(cfg)
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    hk, h = cfg.n_kv_heads, cfg.n_heads
    g = h // hk
    q = torch.matmul(x, params["wq"]).reshape(b, 1, h, hd)
    if "q_norm" in params:
        q = rmsnorm({"scale": params["q_norm"]}, q, cfg.norm_eps)
    if angles is not None:
        q = rope_lib.apply_rope(q, angles)
    if not cross:
        k_new = torch.matmul(x, params["wk"]).reshape(b, 1, hk, hd)
        v_new = torch.matmul(x, params["wv"]).reshape(b, 1, hk, hd)
        if "k_norm" in params:
            k_new = rmsnorm({"scale": params["k_norm"]}, k_new, cfg.norm_eps)
        if angles is not None:
            k_new = rope_lib.apply_rope(k_new, angles)
        slot = pos % cache_k.shape[1]
        cache_k[:, slot] = k_new[:, 0].to(cache_k.dtype)
        cache_v[:, slot] = v_new[:, 0].to(cache_v.dtype)
    s = cache_k.shape[1]
    qg = q.reshape(b, 1, hk, g, hd)
    scores = (torch.einsum("bskgh,btkh->bkgst", qg, cache_k)
              / math.sqrt(hd)).float()
    if not cross:
        kpos = torch.arange(s, device=x.device)
        valid = kpos <= pos                   # causal within the cache
        if cfg.sliding_window:
            valid &= pos - kpos < cfg.sliding_window
        scores = scores.masked_fill(~valid, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)  # noqa: E741
    o = torch.einsum("bkgst,btkh->bskgh", (p / l).to(cache_v.dtype), cache_v)
    out = _out_proj(params, o.reshape(b, 1, h, hd), cfg)
    return out, cache_k, cache_v
