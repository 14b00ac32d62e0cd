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
  self-attention over a mesh's ``model`` dim (ROADMAP A6c):
  :func:`attention_fwd` with ``mesh`` (a ``DeviceMesh``) takes this rank's
  contiguous share of the positions, gathers K and V once, and walks the
  key blocks it needs (:func:`_seq_dp_attention`).  Without a mesh, or
  where :func:`seq_parallel` says no, it computes what ``megatron``
  computes, as the JAX package does without a mesh.
* ``shard_strategy="megatron"`` on a mesh whose ``model`` dim has more
  than one rank splits the flat head dims of ``wq``, ``wk``, ``wv`` and
  ``wo`` over it, where they divide, as the rule's contiguous slices,
  which may end inside a head: :func:`attention_fwd` with ``tp`` (a
  ``parallel.tensor_parallel.ModelGroup``) computes the heads of its
  query columns, widened to whole GQA groups, and sums the ranks' row
  blocks of ``wo`` (:func:`_tp_attention`).
* Decode on a mesh (:func:`attention_decode` and
  :func:`attention_decode_two_tier` with ``kv``, the cache's
  ``parallel.sharding.CacheSlice``): each rank holds ``cache_pspecs``'
  slice of the slots (over ``model``, or over (data, model) at batch 1)
  under every strategy, scores them at their global positions and merges
  its softmax with the other ranks' (flash-decoding); under ``megatron``
  the token's q/k/v are gathered over ``model`` first and ``wo`` is
  row-parallel.
* ``decode_cache_update="dus"`` writes the new token's slot by
  ``dynamic_update_slice`` where ``"masked"`` rewrites the cache through a
  one-hot ``where``; both give the same values, and the port writes that
  one slot in place under either.

``q_norm`` and ``k_norm`` normalise each head's head_dim by default (the
JAX package's qk-norm); under ``PortModelConfig.qk_norm_whole`` (the
published OLMoE's) they normalise the whole q and k projections, scales of
n_heads x head_dim and n_kv_heads x head_dim, before the split into heads
(:func:`_qk_norm`), in prefill and both decode paths.  The
tensor-parallel path, whose ranks hold parts of the projection, raises
for it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, port_option
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (NEG_INF,
                                                     flash_attention_ref)
from repro_torch.models import rope as rope_lib
from repro_torch.models.common import DTYPES, ParamSpec, PyTree, rmsnorm
from repro_torch.parallel import collectives, tensor_parallel

#: ``attn_impl`` values: the kernel's wrapper (the plain version on CPU
#: tensors) or the plain version on any device
ATTN_IMPLS = ("kernel", "plain")

#: strategies under which self-attention is sequence-parallel on a mesh
SEQ_STRATEGIES = ("seq_dp", "ep_seq")


def attention_specs(cfg: ModelConfig, cross: bool = False) -> PyTree:
    """Projections (d, H*hd), (d, Hk*hd) x 2, (H*hd, d); with ``qk_norm``
    also q_norm and k_norm, (hd,) each, or (H*hd,) and (Hk*hd,) under
    ``qk_norm_whole``, except for cross-attention."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    qd = cfg.n_heads * hd
    kvd = cfg.n_kv_heads * hd
    dt = DTYPES[cfg.param_dtype]
    specs = {
        "wq": ParamSpec((d, qd), dt, logical_axes=("embed", "heads")),
        "wk": ParamSpec((d, kvd), dt, logical_axes=("embed", "kv_heads")),
        "wv": ParamSpec((d, kvd), dt, logical_axes=("embed", "kv_heads")),
        "wo": ParamSpec((qd, d), dt, logical_axes=("heads", "embed")),
    }
    if cfg.qk_norm and not cross:
        whole = port_option(cfg, "qk_norm_whole")
        specs["q_norm"] = ParamSpec((qd if whole else hd,), dt, init="ones")
        specs["k_norm"] = ParamSpec((kvd if whole else hd,), dt,
                                    init="ones")
    return specs


def _qk_norm(params: PyTree, name: str, t: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    """t (..., heads, hd) through the norm ``name`` (``q_norm`` or
    ``k_norm``): over each head, or over all heads at once under
    ``qk_norm_whole``."""
    scale = {"scale": params[name]}
    if not port_option(cfg, "qk_norm_whole"):
        return rmsnorm(scale, t, cfg.norm_eps)
    return rmsnorm(scale, t.flatten(-2), cfg.norm_eps).view(t.shape)


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
        q = _qk_norm(params, "q_norm", q, cfg)
        k = _qk_norm(params, "k_norm", k, cfg)
    return q, k, v


def _out_proj(params: PyTree, o: torch.Tensor, cfg: ModelConfig):
    b, s = o.shape[:2]
    return torch.matmul(o.reshape(b, s, cfg.n_heads * cfg.resolved_head_dim),
                        params["wo"])


# ---------------------------------------------------------------------------
# Sequence-parallel attention (seq_dp, ep_seq)
# ---------------------------------------------------------------------------

def _block_attend(qg, k_blk, v_blk, q_positions, kv_start: int,
                  scale: float, causal: bool, window: int):
    """One (queries, key block) tile: qg (B,Sq,Hk,G,hd) at positions
    ``q_positions`` against k/v (B,Bk,Hk,hd) at kv_start..; returns the
    unnormalised o (B,Sq,Hk,G,hd) in v's dtype, the row max m and sum l
    (B,Hk,G,Sq), float32.  Masked scores are NEG_INF (finite), so a row
    masked over the whole block sums every value until a later block's
    max wipes it, as in the JAX package."""
    bk = k_blk.shape[1]
    s = (torch.einsum("bskgh,btkh->bkgst", qg, k_blk) * scale).float()
    kpos = kv_start + torch.arange(bk, device=qg.device)
    mask = torch.ones((q_positions.shape[0], bk), dtype=torch.bool,
                      device=qg.device)
    if causal:
        mask &= q_positions[:, None] >= kpos[None, :]
    if window:
        mask &= q_positions[:, None] - kpos[None, :] < window
    s = torch.where(mask, s, torch.full((), NEG_INF, device=s.device))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)  # noqa: E741
    o = torch.einsum("bkgst,btkh->bskgh", p.to(v_blk.dtype), v_blk)
    return o, m, l


def _local_blocked_attention(q, k, v, cfg: ModelConfig, q_start: int,
                             causal: bool, window: int) -> torch.Tensor:
    """Blocked attention for a local query chunk q (B,Sq,H,hd) at positions
    q_start.. against the full k/v (B,Skv,Hk,hd), with the JAX package's
    arithmetic: key blocks of ``cfg.attn_block_k``, only those from the
    window's first (``lo``) to the causal last (``hi``), both set by the
    chunk's offset, and an online softmax in float32."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    hk = cfg.n_kv_heads
    g = h // hk
    scale = 1.0 / math.sqrt(hd)
    bk = min(cfg.attn_block_k, skv)
    if skv % bk:
        raise ValueError(f"{skv} keys do not split into blocks of {bk}")
    nk = skv // bk
    qg = q.reshape(b, sq, hk, g, hd)
    q_positions = q_start + torch.arange(sq, device=q.device)
    hi = (q_start + sq + bk - 1) // bk if causal else nk
    lo = max(0, (q_start - window + 1) // bk) if window else 0
    o_acc = torch.zeros((b, hk, g, sq, hd), dtype=torch.float32,
                        device=q.device)
    m_acc = torch.full((b, hk, g, sq), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_acc = torch.zeros((b, hk, g, sq), dtype=torch.float32, device=q.device)
    for j in range(lo, hi):
        o, m, l = _block_attend(qg, k[:, j * bk:(j + 1) * bk],  # noqa: E741
                                v[:, j * bk:(j + 1) * bk], q_positions,
                                j * bk, scale, causal, window)
        m_new = torch.maximum(m_acc, m)
        alpha = torch.exp(m_acc - m_new)
        beta = torch.exp(m - m_new)
        l_acc = l_acc * alpha + l * beta
        o_acc = (o_acc * alpha[..., None]
                 + o.permute(0, 2, 3, 1, 4).float() * beta[..., None])
        m_acc = m_new
    o_norm = o_acc / torch.clamp_min(l_acc, 1e-30)[..., None]
    return o_norm.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


def seq_parallel(cfg: ModelConfig, mesh, seq: int) -> bool:
    """Whether self-attention over ``seq`` positions runs sequence-parallel
    on ``mesh``: under ``seq_dp`` or ``ep_seq``, on a mesh with a
    ``model`` dim whose size divides ``seq``.  Otherwise the positions are
    not split, and the unsharded path computes the same values."""
    if mesh is None or cfg.shard_strategy not in SEQ_STRATEGIES:
        return False
    names = tuple(mesh.mesh_dim_names)
    return "model" in names and seq % mesh.size(names.index("model")) == 0


def _seq_dp_attention(q, k, v, cfg: ModelConfig, causal: bool, window: int,
                      mesh) -> torch.Tensor:
    """Sequence-parallel blockwise attention.  q/k/v hold this rank's
    S/n contiguous positions of the mesh's ``model`` dim (n ranks; rank r
    in ``model`` holds r*S/n..): K and V are gathered once (tiled along
    the sequence), and the rank's queries walk the key blocks they need.
    Returns this rank's positions (B,S/n,H,hd)."""
    kf = collectives.all_gather_cat(k, mesh, ("model",), 1)
    vf = collectives.all_gather_cat(v, mesh, ("model",), 1)
    q_start = collectives.group_rank(mesh, ("model",)) * q.shape[1]
    return _local_blocked_attention(q, kf, vf, cfg, q_start, causal, window)


# ---------------------------------------------------------------------------
# Tensor-parallel attention (megatron on a model dim)
# ---------------------------------------------------------------------------

def _tp_attention(params: PyTree, x: torch.Tensor, cfg: ModelConfig, tp,
                  kv_x: Optional[torch.Tensor], angles, causal: bool,
                  window: int, impl: str) -> torch.Tensor:
    """Attention on this rank's share of the heads: ``wq``'s columns
    [c0, c1) and ``wo``'s rows [c0, c1), possibly inside a head; ``wk``
    and ``wv`` split (or not) on their own columns.

    The rank computes the KV heads [g0, g1) whose query groups cover its
    columns (``tensor_parallel.head_span``), so the kernel gets whole
    groups in its ``h // G`` layout: q's columns of heads [g0 G, g1 G) and
    k/v's of heads [g0, g1), gathered over ``model`` wherever any rank's
    own columns are not exactly those (the decision is the same on every
    rank, so every rank takes part in the gather).  It keeps o's columns
    [c0, c1) and returns its partial product with ``wo``, summed over
    ``model``.  A norm over the whole projection (``qk_norm_whole``)
    would need a sum across the ranks: it raises."""
    if "q_norm" in params and port_option(cfg, "qk_norm_whole"):
        raise NotImplementedError(
            f"{cfg.name}: qk-norm over the whole projection has no "
            "tensor-parallel path")
    hd = cfg.resolved_head_dim
    g = cfg.n_heads // cfg.n_kv_heads
    lq, lk = params["wq"].shape[1], params["wk"].shape[1]
    k_split = tp.split(lk, cfg.n_kv_heads * hd)
    spans = [tensor_parallel.head_span(*tp.span(lq, r), hd, g)
             for r in range(tp.size)]
    g0, g1 = spans[tp.rank]
    gather_q = any((a * g * hd, b * g * hd) != tp.span(lq, r)
                   for r, (a, b) in enumerate(spans))
    gather_kv = k_split and any((a * hd, b * hd) != tp.span(lk, r)
                                for r, (a, b) in enumerate(spans))
    xs = tp.copy(x)
    kv_src = xs if kv_x is None else tp.copy(kv_x)

    def project(w, src, split, gather, lo, hi):
        y = torch.matmul(src, w if split else tp.copy(w))
        if gather:
            return tp.gather(y, -1)[..., lo:hi]
        return y if split else y[..., lo:hi]

    q = project(params["wq"], xs, True, gather_q, g0 * g * hd, g1 * g * hd)
    k = project(params["wk"], kv_src, k_split, gather_kv, g0 * hd, g1 * hd)
    v = project(params["wv"], kv_src, k_split, gather_kv, g0 * hd, g1 * hd)
    q = q.reshape(*q.shape[:2], -1, hd)
    k = k.reshape(*k.shape[:2], -1, hd)
    v = v.reshape(*v.shape[:2], -1, hd)
    if "q_norm" in params:
        q = rmsnorm({"scale": tp.copy(params["q_norm"])}, q, cfg.norm_eps)
        k = rmsnorm({"scale": tp.copy(params["k_norm"])}, k, cfg.norm_eps)
    if angles is not None and kv_x is None:
        q = rope_lib.apply_rope(q, angles)
        k = rope_lib.apply_rope(k, angles)
    o = _attend(q, k, v, causal, window, impl)
    c0, c1 = tp.span(lq)
    base = g0 * g * hd
    o = o.reshape(*o.shape[:2], -1)[..., c0 - base:c1 - base]
    return tp.reduce(torch.matmul(o, params["wo"]))


def _attend(q, k, v, causal: bool, window: int, impl: str) -> torch.Tensor:
    if impl == "kernel":
        return flash_ops.flash_attention(q, k, v, causal=causal,
                                         window=window)
    if impl == "plain":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    raise ValueError(f"attn impl {impl!r}; have {ATTN_IMPLS}")


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def attention_fwd(params: PyTree, x: torch.Tensor, cfg: ModelConfig,
                  causal: bool = True, angles: Optional[torch.Tensor] = None,
                  kv_x: Optional[torch.Tensor] = None,
                  impl: str = "kernel", mesh=None, tp=None) -> torch.Tensor:
    """Full-sequence attention (training / prefill), x (B,S,D).  With
    ``kv_x`` (B,Skv,D), cross-attention: keys and values from ``kv_x``, no
    RoPE, no window, not causal.

    ``impl="kernel"`` goes through ``ops.flash_attention`` (the CUDA kernel
    for CUDA tensors, its plain version for CPU tensors); ``"plain"`` takes
    the plain version on any device, as a reference.

    With ``mesh`` (a ``DeviceMesh`` with a ``model`` dim) under ``seq_dp``
    or ``ep_seq``, self-attention is sequence-parallel: x and ``angles``
    hold this rank's share of the positions (see :func:`seq_parallel`,
    which the caller asks before it splits them), and the result is that
    share, from :func:`_local_blocked_attention` on any ``impl``, as the
    JAX package's sharded path computes it.  Under other strategies, for
    cross-attention, or on a mesh without a ``model`` dim, ``mesh`` is not
    used.

    With ``tp`` (a ``parallel.tensor_parallel.ModelGroup``) and ``wq``
    split over it, params hold this rank's slices and x the rank's copy of
    the (replicated) activations: :func:`_tp_attention`."""
    cross = kv_x is not None
    causal = causal and not cross
    window = 0 if cross else cfg.sliding_window
    if tp is not None and tp.split(params["wq"].shape[1],
                                   cfg.n_heads * cfg.resolved_head_dim):
        return _tp_attention(params, x, cfg, tp, kv_x, angles, causal,
                             window, impl)
    q, k, v = _project_qkv(params, x, cfg, kv_x)
    if angles is not None and not cross:
        q = rope_lib.apply_rope(q, angles)
        k = rope_lib.apply_rope(k, angles)
    if (mesh is not None and not cross
            and cfg.shard_strategy in SEQ_STRATEGIES
            and "model" in tuple(mesh.mesh_dim_names)):
        return _out_proj(params, _seq_dp_attention(q, k, v, cfg, causal,
                                                   window, mesh), cfg)
    return _out_proj(params, _attend(q, k, v, causal, window, impl), cfg)


# ---------------------------------------------------------------------------
# Decode pieces (one device, or a rank's slices on a mesh)
# ---------------------------------------------------------------------------

def _decode_qkv(params: PyTree, x: torch.Tensor, cfg: ModelConfig, tp,
                cross: bool):
    """The token's q (B,1,H,hd) and, unless ``cross``, k and v (B,1,Hk,hd),
    whole on every rank: with ``tp`` and a projection's head columns split
    over it, each rank's columns are gathered over ``model`` (the split
    ones in one gather)."""
    b, hd = x.shape[0], cfg.resolved_head_dim
    names = ("wq",) if cross else ("wq", "wk", "wv")
    heads = dict(wq=cfg.n_heads, wk=cfg.n_kv_heads, wv=cfg.n_kv_heads)
    ys = {n: torch.matmul(x, params[n]) for n in names}
    split = [n for n in names if tp is not None
             and tp.split(params[n].shape[1], heads[n] * hd)]
    if split:
        got = collectives.all_gather_cat(
            torch.cat([ys[n] for n in split], dim=-1), tp.mesh, tp.dims, -1)
        pieces = got.reshape(b, 1, tp.size, -1).split(
            [ys[n].shape[-1] for n in split], dim=-1)
        for n, piece in zip(split, pieces):
            ys[n] = piece.reshape(b, 1, -1)
    return tuple(ys[n].reshape(b, 1, heads[n], hd) for n in names)


def _decode_out(params: PyTree, o: torch.Tensor, tp) -> torch.Tensor:
    """o (B,Hk,G,1,hd) through ``wo``; with its rows split over ``tp``,
    this rank's rows times its columns of o, summed over ``model``."""
    flat = o.permute(0, 3, 1, 2, 4).reshape(o.shape[0], 1, -1)
    wo = params["wo"]
    if tp is not None and tp.split(wo.shape[0], flat.shape[-1]):
        c0, c1 = tp.span(wo.shape[0])
        return tp.reduce(torch.matmul(flat[..., c0:c1], wo))
    return torch.matmul(flat, wo)


def _write_slot(cache: torch.Tensor, new: torch.Tensor, slot: int,
                start: int) -> None:
    """The token's ``new`` (B,1,...) into global slot ``slot`` of the cache
    whose slots ``start``.. this rank holds, in place, where it holds it."""
    if start <= slot < start + cache.shape[1]:
        cache[:, slot - start] = new[:, 0].to(cache.dtype)


def _pv(v: torch.Tensor, hd_dims=(), mesh=None):
    """The P.V product of weights (B,Hk,G,1,S) and the cache ``v``
    (B,S,Hk,hd), laid out (B,Hk,G,1,hd) and cast to v's dtype; with
    ``hd_dims``, v holds this rank's share of head_dim over them, and the
    shares are gathered."""
    def pv(w):
        o = torch.einsum("bkgst,btkh->bkgsh", w.to(v.dtype), v)
        if hd_dims:
            o = collectives.all_gather_cat(o, mesh, hd_dims, -1)
        return o
    return pv


def attention_decode(params: PyTree, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: int, cfg: ModelConfig,
                     angles: Optional[torch.Tensor] = None,
                     cross: bool = False, tp=None, kv=None):
    """One-token decode.  x (B,1,D); cache_k/v (B,S,Hk,hd) ring buffers.

    Returns (out (B,1,D), cache_k, cache_v).  The new token's K/V go into
    slot ``pos % S`` in place (the JAX package rewrites the cache through a
    one-hot ``where``, or under ``decode_cache_update="dus"`` updates that
    slot; the values are the same and the port saves the copy),
    so the returned caches are the ones passed in.  With ``cross`` the cache
    holds the encoder's precomputed K/V: no k/v projection, no write, every
    key attended.

    On a mesh the caches are this rank's slices and ``kv`` their
    ``parallel.sharding.CacheSlice``: the slots (global S) split over the
    dims ``kv.dims[1]``.  The token's q, k and v are whole on every rank
    (gathered over ``tp`` where the head columns are split), the rank that
    holds slot ``pos % S`` writes it, and each rank scores every head over
    its slots at their global positions; the softmax spans the ranks
    (``tensor_parallel.flash_merge``: the max, then the sums and the
    partial P.V products in one all-reduce).  ``wo`` takes this rank's rows under ``tp``."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    hk, h = cfg.n_kv_heads, cfg.n_heads
    g = h // hk
    proj = _decode_qkv(params, x, cfg, tp, cross)
    q = proj[0]
    if "q_norm" in params:
        q = _qk_norm(params, "q_norm", q, cfg)
    if angles is not None:
        q = rope_lib.apply_rope(q, angles)
    mesh, seq, start = (None, (), 0) if kv is None else (
        kv.mesh, kv.dims[1], kv.start(1))
    if not cross:
        k_new, v_new = proj[1:]
        if "k_norm" in params:
            k_new = _qk_norm(params, "k_norm", k_new, cfg)
        if angles is not None:
            k_new = rope_lib.apply_rope(k_new, angles)
        slot = pos % (cache_k.shape[1] if kv is None else kv.whole(1))
        _write_slot(cache_k, k_new, slot, start)
        _write_slot(cache_v, v_new, slot, start)
    s = cache_k.shape[1]
    qg = q.reshape(b, 1, hk, g, hd)
    scores = (torch.einsum("bskgh,btkh->bkgst", qg, cache_k)
              / math.sqrt(hd)).float()
    if not cross:
        kpos = start + torch.arange(s, device=x.device)
        valid = kpos <= pos                   # causal within the cache
        if cfg.sliding_window:
            valid &= pos - kpos < cfg.sliding_window
        scores = scores.masked_fill(~valid, NEG_INF)
    o = tensor_parallel.flash_merge([(scores, _pv(cache_v), seq)], mesh)
    return _decode_out(params, o.to(cache_v.dtype), tp), cache_k, cache_v


def attention_decode_two_tier(params: PyTree, x: torch.Tensor,
                              main_k: torch.Tensor, main_v: torch.Tensor,
                              ring_k: torch.Tensor, ring_v: torch.Tensor,
                              pos: int, cfg: ModelConfig,
                              angles: Optional[torch.Tensor] = None,
                              tp=None, kv=None, ring=None):
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
    the slot of the token W before it, which is then attended no more.

    On a mesh (``kv`` and ``ring`` the ``CacheSlice`` of the main cache and
    of the ring), the main cache is read as :func:`attention_decode` reads
    it, and the rings hold this rank's share of head_dim (``ring.dims[3]``):
    each rank writes its share of the new K/V, the ring's scores are its
    partial sums over head_dim summed over those dims, and its P.V gives
    this rank's share of o's head_dim, gathered."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    hk, h = cfg.n_kv_heads, cfg.n_heads
    g = h // hk
    q, k_new, v_new = _decode_qkv(params, x, cfg, tp, cross=False)
    if "q_norm" in params:
        q = _qk_norm(params, "q_norm", q, cfg)
        k_new = _qk_norm(params, "k_norm", k_new, cfg)
    if angles is not None:
        q = rope_lib.apply_rope(q, angles)
        k_new = rope_lib.apply_rope(k_new, angles)
    mesh, seq, start = (None, (), 0) if kv is None else (
        kv.mesh, kv.dims[1], kv.start(1))
    s = main_k.shape[1] if kv is None else kv.whole(1)
    w = ring_k.shape[1]
    d0, d1 = (0, hd) if ring is None else ring.ranges[3]
    hd_dims = () if ring is None else ring.dims[3]
    mesh = mesh if ring is None else ring.mesh
    slot = (pos - s) % w
    _write_slot(ring_k, k_new[..., d0:d1], slot, 0)
    _write_slot(ring_v, v_new[..., d0:d1], slot, 0)

    qg = q.reshape(b, 1, hk, g, hd)
    scale = 1.0 / math.sqrt(hd)
    s_main = (torch.einsum("bskgh,btkh->bkgst", qg, main_k) * scale).float()
    s_ring = (torch.einsum("bskgh,btkh->bkgst", qg[..., d0:d1], ring_k)
              * scale).float()
    if hd_dims:
        collectives.all_reduce(s_ring, mesh, hd_dims)
    kpos_main = start + torch.arange(main_k.shape[1], device=x.device)
    kpos_ring = s + torch.arange(w, device=x.device)
    valid_main, valid_ring = kpos_main <= pos, kpos_ring <= pos
    if cfg.sliding_window:
        valid_main &= pos - kpos_main < cfg.sliding_window
        valid_ring &= pos - kpos_ring < cfg.sliding_window
    s_main = s_main.masked_fill(~valid_main, NEG_INF)
    s_ring = s_ring.masked_fill(~valid_ring, NEG_INF)
    o = tensor_parallel.flash_merge(
        [(s_main, _pv(main_v), seq), (s_ring, _pv(ring_v, hd_dims, mesh), ())],
        mesh)
    return _decode_out(params, o.to(main_v.dtype), tp), ring_k, ring_v
