"""Layer-block assembly: (norm -> mixer -> residual) + (norm -> mlp ->
residual) per :class:`repro_torch.configs.base.LayerSpec`, with decode
variants threading per-layer state.  One *block* = one period of the
config's repeating pattern; ``lm.py`` loops over ``n_repeats`` blocks with
stacked parameters.

Mixers ``attn``, ``mamba``, ``mlstm`` and ``slstm``; MLPs ``dense``,
``moe`` and ``none``.  An encoder-decoder's decoder layers (``cross``) add
cross-attention to the encoder's output between the mixer and the MLP.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig, port_option
from repro_torch.models import attention, mamba, mlp, moe, xlstm
from repro_torch.models.common import DTYPES, PyTree, rmsnorm, rmsnorm_specs
from repro_torch.parallel import collectives, tensor_parallel

_MIXER_SPECS = {"attn": attention.attention_specs, "mamba": mamba.mamba_specs,
                "mlstm": xlstm.mlstm_specs, "slstm": xlstm.slstm_specs}


def layer_specs(cfg: ModelConfig, spec: LayerSpec,
                cross: bool = False) -> PyTree:
    if spec.mixer not in _MIXER_SPECS:
        raise ValueError(spec.mixer)
    d = cfg.d_model
    dt = DTYPES[cfg.param_dtype]
    out: Dict[str, Any] = {"norm1": rmsnorm_specs(d, dt),
                           spec.mixer: _MIXER_SPECS[spec.mixer](cfg)}
    if cross:
        out["norm_cross"] = rmsnorm_specs(d, dt)
        out["cross_attn"] = attention.attention_specs(cfg, cross=True)
    if spec.mlp == "dense":
        out["norm2"] = rmsnorm_specs(d, dt)
        out["mlp"] = mlp.mlp_specs(cfg)
    elif spec.mlp == "moe":
        out["norm2"] = rmsnorm_specs(d, dt)
        out["moe"] = moe.moe_specs(cfg)
    return out


def block_specs(cfg: ModelConfig, cross: bool = False) -> Tuple[PyTree, ...]:
    """One period: a tuple of per-position layer spec trees."""
    return tuple(layer_specs(cfg, s, cross=cross) for s in cfg.pattern)


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------

def _mlp_out(params: PyTree, h: torch.Tensor, cfg: ModelConfig,
             spec: LayerSpec, layout=None):
    """The residual branch of the layer's MLP and its aux loss (None
    without one).  On a mesh (``layout``, h this rank's slice) the MoE
    layer routes the whole batch's groups: where this rank's tokens are
    whole groups of it (``megatron``: its batch rows, every position) it
    routes them and the aux loss spans the ranks; otherwise (``ep_seq``,
    or rows shorter than a group) it gathers every token (the gradient
    scattered back) and keeps its slice of the output, and the aux loss's
    gradient is its batch rows' share.  Each rank runs its experts (split
    over ``model``); the dense MLP splits its width over ``model``.  The
    dropless MoE (``PortModelConfig.moe_dropless``) has no mesh path and
    raises there."""
    tp = tensor_parallel.model_group(None if layout is None
                                     else layout.mesh)
    if spec.mlp == "dense":
        return mlp.mlp_fwd(params["mlp"], rmsnorm(params["norm2"], h,
                                                  cfg.norm_eps),
                           tp, cfg.d_ff), None
    if spec.mlp == "moe":
        x = rmsnorm(params["norm2"], h, cfg.norm_eps)
        if layout is None:
            return moe.moe_fwd(params["moe"], x, cfg)
        if port_option(cfg, "moe_dropless"):
            raise NotImplementedError(
                f"{cfg.name}: the dropless MoE runs on one device; it has "
                "no mesh path")
        rows = collectives.group_size(layout.mesh, layout.batch_dims)
        tokens = x.shape[0] * rows * x.shape[1]
        group = min(cfg.moe_group_size, tokens)
        if not layout.seq_dims and (x.shape[0] * x.shape[1]) % group == 0:
            return moe.moe_fwd(params["moe"], x, cfg, tp, tokens=tokens,
                               batch=(layout.mesh, layout.batch_dims)
                               if rows > 1 else None)
        for dims, dim in ((layout.seq_dims, 1), (layout.batch_dims, 0)):
            if dims:
                x = tensor_parallel.gather(x, layout.mesh, dims, dim)
        out, aux = moe.moe_fwd(params["moe"], x, cfg, tp)
        return layout.local(out), tensor_parallel.share_of(aux / rows, aux)
    return None, None


def _recurrent(fn, x: torch.Tensor, layout):
    """A mixer that runs along the sequence (Mamba, mLSTM, sLSTM) on a
    mesh: each rank gathers its batch rows' whole sequence, runs it and
    keeps its positions."""
    if layout is None or not layout.seq_dims:
        return fn(x)
    return layout.local(fn(tensor_parallel.gather(
        x, layout.mesh, layout.seq_dims, 1)), batch=False)


def layer_fwd(params: PyTree, h: torch.Tensor, cfg: ModelConfig,
              spec: LayerSpec, angles: Optional[torch.Tensor], causal: bool,
              enc_out: Optional[torch.Tensor] = None,
              attn_impl: str = "kernel",
              layout=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (h, aux_loss).  A layer with cross-attention attends to
    ``enc_out`` (B, S_enc, D) after its mixer, when given.

    On a mesh, ``layout`` (a ``parallel.sharding.BatchLayout``) says how h
    is split, and h is this rank's slice: attention gathers K/V once when
    the sequence is split, a recurrent mixer and the MoE layer gather what
    they span (:func:`_recurrent`, :func:`_mlp_out`), and the norms are
    local.  Under ``megatron`` params hold this rank's slices, h is
    replicated over ``model``, and each mixer and MLP computes on its
    share of the heads, channels or experts (``tp``) and sums over
    ``model``."""
    tp = tensor_parallel.model_group(None if layout is None
                                     else layout.mesh)
    x = rmsnorm(params["norm1"], h, cfg.norm_eps)
    if spec.mixer == "attn":
        mixed = attention.attention_fwd(
            params["attn"], x, cfg, causal=causal, angles=angles,
            impl=attn_impl,
            mesh=layout.mesh if layout is not None and layout.seq_dims
            else None, tp=tp)
    elif spec.mixer == "mamba":
        mixed = _recurrent(lambda t: mamba.mamba_fwd(params["mamba"], t,
                                                     cfg, tp), x, layout)
    elif spec.mixer == "mlstm":
        mixed = _recurrent(lambda t: xlstm.mlstm_fwd(params["mlstm"], t,
                                                     cfg, tp), x, layout)
    elif spec.mixer == "slstm":
        mixed = _recurrent(lambda t: xlstm.slstm_fwd(params["slstm"], t,
                                                     cfg, tp), x, layout)
    else:
        raise ValueError(spec.mixer)
    h = h + mixed
    if "cross_attn" in params and enc_out is not None:
        xc = rmsnorm(params["norm_cross"], h, cfg.norm_eps)
        h = h + attention.attention_fwd(params["cross_attn"], xc, cfg,
                                        causal=False, kv_x=enc_out,
                                        impl=attn_impl, tp=tp)
    out, aux = _mlp_out(params, h, cfg, spec, layout)
    if out is not None:
        h = h + out
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h, aux


def block_fwd(params_tuple: Tuple[PyTree, ...], h: torch.Tensor,
              cfg: ModelConfig, angles: Optional[torch.Tensor], causal: bool,
              enc_out: Optional[torch.Tensor] = None,
              attn_impl: str = "kernel",
              layout=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (h, the aux losses of the period's layers summed)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for pos, spec in enumerate(cfg.pattern):
        h, a = layer_fwd(params_tuple[pos], h, cfg, spec, angles, causal,
                         enc_out=enc_out, attn_impl=attn_impl,
                         layout=layout)
        aux = aux + a
    return h, aux


# ---------------------------------------------------------------------------
# Decode (one token, stateful)
# ---------------------------------------------------------------------------

def layer_cache_specs(cfg: ModelConfig, spec: LayerSpec, batch: int,
                      seq: int, cross_len: int = 0
                      ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """Per-layer decode state as ``{name: (shape, dtype)}``: the reference's
    shapes and dtypes (the recurrent states float32, Mamba's conv window in
    the activations' dtype); with ``cfg.decode_ring``, attention's ring of
    recent tokens, ``ring_k`` and ``ring_v`` (B, decode_ring, Hk, hd),
    beside its main cache; with ``cross_len``, the encoder's K/V for
    cross-attention, ``cross_k`` and ``cross_v`` (B, cross_len, Hk, hd)."""
    if spec.mixer == "attn":
        kv = ((batch, seq, cfg.n_kv_heads, cfg.resolved_head_dim),
              DTYPES[cfg.dtype])
        out = {"k": kv, "v": kv}
        if cfg.decode_ring:
            ring = ((batch, cfg.decode_ring, cfg.n_kv_heads,
                     cfg.resolved_head_dim), DTYPES[cfg.dtype])
            out["ring_k"], out["ring_v"] = ring, ring
    elif spec.mixer == "mamba":
        out = mamba.mamba_cache_specs(cfg, batch)
    elif spec.mixer == "mlstm":
        hd = cfg.mlstm_inner // cfg.n_heads
        out = {"c": ((batch, cfg.n_heads, hd, hd), torch.float32),
               "n": ((batch, cfg.n_heads, hd), torch.float32)}
    elif spec.mixer == "slstm":
        out = {name: ((batch, cfg.d_model), torch.float32)
               for name in ("c", "n", "m", "h")}
    else:
        raise ValueError(spec.mixer)
    if cross_len:
        ckv = ((batch, cross_len, cfg.n_kv_heads, cfg.resolved_head_dim),
               DTYPES[cfg.dtype])
        out["cross_k"], out["cross_v"] = ckv, ckv
    return out


@dataclass(frozen=True)
class DecodeShards:
    """A layer's decode on a mesh: ``layout`` (a
    ``parallel.sharding.BatchLayout``) splits the token batch, ``tp`` is the
    mesh's ``model`` group (None where it has one rank) and ``caches`` maps
    each of the layer's cache leaves to its
    ``parallel.sharding.CacheSlice``."""
    layout: Any
    tp: Any
    caches: Dict[str, Any]


def layer_decode(params: PyTree, h: torch.Tensor, cache: PyTree, pos: int,
                 cfg: ModelConfig, spec: LayerSpec,
                 angles: Optional[torch.Tensor],
                 shards: Optional[DecodeShards] = None
                 ) -> Tuple[torch.Tensor, PyTree]:
    """One token through one layer.  The cache's tensors (views into the
    stacked caches of ``lm.init_cache``) are updated in place, and the
    returned cache is the one passed in.  With ``cfg.decode_ring``,
    attention writes only its ring and reads the main cache.

    On a mesh (``shards``) h holds this rank's batch rows, replicated over
    ``model``; params and the cache are this rank's slices: attention's
    slots split over the ranks, the recurrent states' channels over
    ``model`` (each mixer's decode says how it computes on them), and the
    MLP as the forward's (:func:`_mlp_out`)."""
    tp = None if shards is None else shards.tp
    slices = {} if shards is None else shards.caches
    x = rmsnorm(params["norm1"], h, cfg.norm_eps)
    if spec.mixer == "attn":
        if cfg.decode_ring:
            mixed, _, _ = attention.attention_decode_two_tier(
                params["attn"], x, cache["k"], cache["v"], cache["ring_k"],
                cache["ring_v"], pos, cfg, angles=angles, tp=tp,
                kv=slices.get("k"), ring=slices.get("ring_k"))
        else:
            mixed, _, _ = attention.attention_decode(
                params["attn"], x, cache["k"], cache["v"], pos, cfg,
                angles=angles, tp=tp, kv=slices.get("k"))
        new = {}
    elif spec.mixer == "mamba":
        mixed, conv, hst = mamba.mamba_decode(params["mamba"], x,
                                              cache["conv"], cache["h"], cfg,
                                              tp)
        new = {"conv": conv, "h": hst}
    elif spec.mixer == "mlstm":
        mixed, c, n = xlstm.mlstm_decode(params["mlstm"], x, cache["c"],
                                         cache["n"], cfg, tp)
        new = {"c": c, "n": n}
    elif spec.mixer == "slstm":
        names = ("c", "n", "m", "h")
        mixed, state = xlstm.slstm_decode(
            params["slstm"], x, tuple(cache[k] for k in names), cfg, tp)
        new = dict(zip(names, state))
    else:
        raise ValueError(spec.mixer)
    for name, value in new.items():
        cache[name].copy_(value)
    h = h + mixed
    if "cross_attn" in params:
        xc = rmsnorm(params["norm_cross"], h, cfg.norm_eps)
        mixed, _, _ = attention.attention_decode(
            params["cross_attn"], xc, cache["cross_k"], cache["cross_v"],
            pos, cfg, cross=True, tp=tp, kv=slices.get("cross_k"))
        h = h + mixed
    out, _ = _mlp_out(params, h, cfg, spec,
                      None if shards is None else shards.layout)
    if out is not None:
        h = h + out
    return h, cache


def block_decode(params_tuple: Tuple[PyTree, ...], h: torch.Tensor,
                 caches: Tuple[PyTree, ...], pos: int, cfg: ModelConfig,
                 angles: Optional[torch.Tensor],
                 shards: Optional[Tuple[DecodeShards, ...]] = None):
    """One token through one period; ``shards`` (on a mesh) one
    :class:`DecodeShards` a pattern position."""
    new_caches = []
    for p, spec in enumerate(cfg.pattern):
        h, c = layer_decode(params_tuple[p], h, caches[p], pos, cfg, spec,
                            angles, None if shards is None else shards[p])
        new_caches.append(c)
    return h, tuple(new_caches)
