"""Grouped-query attention: full-sequence self- and cross-attention
(training / prefill) through the ``flash_attention`` kernel, and
single-token decode over a ring-buffer KV cache, over a read-only main
cache and a small ring of recent tokens (``decode_ring > 0``, the two-tier
cache), or, for cross-attention, over the encoder's precomputed K/V.

The JAX package's XLA implementation of full-sequence attention
(``blocked_attention``) is not copied: it computes the same function as the
kernel's plain version, and the parity tests hold the port against it.

Options of the config that mean nothing different on one device:

* ``shard_strategy`` ``seq_dp`` and ``ep_seq`` split the query positions of
  attention over a mesh's ``model`` axis.  Without a mesh the JAX package
  computes what ``megatron`` computes, and so does the port, which runs on
  one device.  The sequence-parallel form across devices waits for the
  port's mesh (ROADMAP A6c).
* ``decode_cache_update="dus"`` writes the new token's slot by
  ``dynamic_update_slice`` where ``"masked"`` rewrites the cache through a
  one-hot ``where``; both give the same values, and the port writes that
  one slot in place under either.
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
    one-hot ``where``, or under ``decode_cache_update="dus"`` updates that
    slot; the values are the same and the port saves the copy),
    so the returned caches are the ones passed in.  With ``cross`` the cache
    holds the encoder's precomputed K/V: no k/v projection, no write, every
    key attended."""
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


def attention_decode_two_tier(params: PyTree, x: torch.Tensor,
                              main_k: torch.Tensor, main_v: torch.Tensor,
                              ring_k: torch.Tensor, ring_v: torch.Tensor,
                              pos: int, cfg: ModelConfig,
                              angles: Optional[torch.Tensor] = None):
    """One-token decode over the two-tier cache.  x (B,1,D); main_k/v
    (B,S,Hk,hd) hold positions 0..S-1 and are read, never written; ring_k/v
    (B,W,Hk,hd) take the new token's K/V in slot ``(pos - S) % W``, in
    place, and their slot i counts as position S + i in the causal and
    window masks.  The two score pieces are merged flash-style (a shared
    max, one denominator, a P.V product each), not concatenated.

    Returns (out (B,1,D), ring_k, ring_v), the rings the ones passed in.

    The JAX package's arithmetic, kept as it is: the scale is multiplied
    before the float32 cast (``attention_decode`` divides), ``k_norm``
    applies when ``q_norm`` is in ``params``, and nothing merges the ring
    into the main cache, so from step S + W on each new token overwrites
    the slot of the token W before it, which is then attended no more."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    hk, h = cfg.n_kv_heads, cfg.n_heads
    g = h // hk
    s, w = main_k.shape[1], ring_k.shape[1]
    q = torch.matmul(x, params["wq"]).reshape(b, 1, h, hd)
    k_new = torch.matmul(x, params["wk"]).reshape(b, 1, hk, hd)
    v_new = torch.matmul(x, params["wv"]).reshape(b, 1, hk, hd)
    if "q_norm" in params:
        q = rmsnorm({"scale": params["q_norm"]}, q, cfg.norm_eps)
        k_new = rmsnorm({"scale": params["k_norm"]}, k_new, cfg.norm_eps)
    if angles is not None:
        q = rope_lib.apply_rope(q, angles)
        k_new = rope_lib.apply_rope(k_new, angles)
    slot = (pos - s) % w
    ring_k[:, slot] = k_new[:, 0].to(ring_k.dtype)
    ring_v[:, slot] = v_new[:, 0].to(ring_v.dtype)

    qg = q.reshape(b, 1, hk, g, hd)
    scale = 1.0 / math.sqrt(hd)
    s_main = (torch.einsum("bskgh,btkh->bkgst", qg, main_k) * scale).float()
    s_ring = (torch.einsum("bskgh,btkh->bkgst", qg, ring_k) * scale).float()
    kpos_main = torch.arange(s, device=x.device)
    kpos_ring = s + torch.arange(w, device=x.device)
    valid_main, valid_ring = kpos_main <= pos, kpos_ring <= pos
    if cfg.sliding_window:
        valid_main &= pos - kpos_main < cfg.sliding_window
        valid_ring &= pos - kpos_ring < cfg.sliding_window
    s_main = s_main.masked_fill(~valid_main, NEG_INF)
    s_ring = s_ring.masked_fill(~valid_ring, NEG_INF)
    m = torch.maximum(s_main.amax(dim=-1, keepdim=True),
                      s_ring.amax(dim=-1, keepdim=True))
    p_main = torch.exp(s_main - m)
    p_ring = torch.exp(s_ring - m)
    l = (p_main.sum(dim=-1, keepdim=True)  # noqa: E741
         + p_ring.sum(dim=-1, keepdim=True))
    o = (torch.einsum("bkgst,btkh->bskgh", (p_main / l).to(main_v.dtype),
                      main_v)
         + torch.einsum("bkgst,btkh->bskgh", (p_ring / l).to(ring_v.dtype),
                        ring_v))
    out = _out_proj(params, o.reshape(b, 1, h, hd), cfg)
    return out, ring_k, ring_v
