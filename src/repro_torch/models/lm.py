"""Unified LM built from ``repro_torch.models.blocks``: decoder-only (dense,
MoE, hybrid (Mamba + attention), xLSTM and vision-language (qwen2-vl: M-RoPE
and a prefix of precomputed patch embeddings)) and encoder-decoder
(seamless: a bidirectional encoder over precomputed frame embeddings, the
decoder's layers cross-attending to its output).

Parameters have the JAX package's layout: per-position trees stacked over
``n_repeats`` (the encoder's over ``n_encoder_layers``) on a leading axis;
the port loops over the stacked layers in Python (PyTorch runs eagerly;
nothing needs ``lax.scan``).

On a mesh (``forward_hidden``/``lm_logits`` with ``mesh=``, a
``DeviceMesh``), every rank takes the global batch and works on its own
slice, split as :func:`_constrain_batch` says, the counterpart of the JAX
package's activation constraint at block boundaries; the result is a
DTensor with that split.  ``lm_logits`` (the prefill cell) takes the
weights placed by :func:`serve_pspecs`, as the JAX package's prefill cell
places them; ``forward_hidden`` and ``lm_loss`` take them by
``param_pspecs`` with ``cfg.fsdp``, as its train cell does.

Decode and prefill on a mesh (``decode_step``, ``prefill`` and
``init_cache`` with ``mesh=``) follow the JAX package's decode cell: the
token batch over (pod, data), the weights by :func:`serve_pspecs`, each
cache leaf as this rank's ``cache_pspecs`` slice (a DTensor of its local
tensor); every rank computes on its slices with explicit collectives.

``lm_loss`` trains: with ``cfg.remat == "full"`` each block is
rematerialised in the backward pass (``torch.utils.checkpoint``, the JAX
package's ``jax.checkpoint``).  Its attention takes the plain route unless
asked otherwise, as the JAX package trains through XLA attention: no kernel
of the port has a backward, and a kernel wrapper refuses an input that
requires grad.  The serving entry points run under ``torch.no_grad()``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention, blocks, rope as rope_lib
from repro_torch.models.common import (DTYPES, ParamSpec, PyTree,
                                       init_params, params_from_jax, rmsnorm,
                                       rmsnorm_specs, stack_specs, take_layer,
                                       tree_leaves, unstack_layers)
from repro_torch.obs import trace
from repro_torch.parallel import collectives, tensor_parallel
from repro_torch.parallel import sharding as shd

__all__ = ["model_specs", "init_model", "params_from_jax", "encode",
           "forward_hidden", "lm_loss", "lm_logits", "cache_specs",
           "serve_pspecs", "init_cache", "fill_cross_caches", "decode_step",
           "prefill"]


# ---------------------------------------------------------------------------
# Activations on a mesh
# ---------------------------------------------------------------------------

def _constrain_batch(cfg: ModelConfig, mesh, batch: int,
                     seq: int) -> "shd.BatchLayout":
    """How a (batch, seq, ...) activation is split on ``mesh``, by the JAX
    package's rules at block boundaries:

    * ``pure_dp``: the batch over (pod, data, model), or over (pod, data)
      where it does not divide, or not at all;
    * ``seq_dp``, ``ep_seq``: the batch over (pod, data) where it divides,
      and the sequence over ``model`` where
      ``attention.seq_parallel`` allows (each attention layer then gathers
      K/V once); ``ep_seq``'s experts are split over ``model``, and each
      rank runs its own on every token;
    * ``megatron``: the batch over (pod, data), replicated over ``model``,
      over which the weights are split: each layer computes on this rank's
      heads, channels or experts and sums over ``model``
      (``parallel.tensor_parallel``).

    Under ``pure_dp`` and ``seq_dp`` the weights are replicated, so the
    norms and a dense MLP need no collective."""
    strategy = cfg.shard_strategy
    bspec = shd.batch_pspec(mesh, batch, strategy=(
        "pure_dp" if strategy == "pure_dp" else "megatron"))
    batch_dims = shd.axis_members(bspec[0])
    seq_dims = (("model",) if strategy in attention.SEQ_STRATEGIES
                and attention.seq_parallel(cfg, mesh, seq) else ())
    return shd.BatchLayout(mesh, batch_dims, seq_dims)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def model_specs(cfg: ModelConfig) -> PyTree:
    d = cfg.d_model
    v = cfg.padded_vocab
    dt = DTYPES[cfg.param_dtype]
    specs: Dict[str, Any] = {
        "embed": ParamSpec((v, d), dt, logical_axes=("vocab", "embed")),
        "blocks": tuple(stack_specs(t, cfg.n_repeats) for t in
                        blocks.block_specs(cfg, cross=cfg.encoder_decoder)),
        "final_norm": rmsnorm_specs(d, dt),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((d, v), dt,
                                     logical_axes=("embed", "vocab"))
    if cfg.encoder_decoder:
        enc_layer = blocks.layer_specs(cfg, LayerSpec("attn", "dense"))
        specs["encoder"] = {
            "blocks": (stack_specs(enc_layer, cfg.n_encoder_layers),),
            "final_norm": rmsnorm_specs(d, dt),
        }
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

class _EmbedLookup(torch.autograd.Function):
    """``table[tokens]`` whose backward sums each token's contributions in
    float32 and casts the table's gradient once.  Indexing's own backward
    (``index_put_`` with accumulate) sums in the table's dtype: in bfloat16
    a frequent token's running sum stalls once it outgrows each addend.

    With ``start`` (a vocab-parallel table: this rank's rows start..),
    tokens outside the rows give zeros and no gradient."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, tokens: torch.Tensor,
                start: Optional[int] = None):
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        if start is None:
            ctx.save_for_backward(tokens, None)
            return table[tokens]
        rows = tokens - start
        inside = (rows >= 0) & (rows < table.shape[0])
        rows = torch.where(inside, rows, 0)
        ctx.save_for_backward(rows, inside)
        return table[rows] * inside[..., None].to(table.dtype)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        tokens, inside = ctx.saved_tensors
        acc = torch.zeros(ctx.table_shape, dtype=torch.float32,
                          device=grad.device)
        grad = grad.float()
        if inside is not None:
            grad = grad * inside[..., None]
        acc.index_add_(0, tokens.reshape(-1),
                       grad.reshape(-1, ctx.table_shape[-1]))
        return acc.to(ctx.table_dtype), None, None


def _embed_tokens(params: PyTree, tokens: torch.Tensor, cfg=None,
                  tp=None) -> torch.Tensor:
    """The tokens' rows of ``embed``; with ``tp`` and the vocabulary split
    over it, each rank looks up its rows and the lookups are summed over
    ``model``."""
    table = params["embed"]
    if tp is None or not tp.split(table.shape[0], cfg.padded_vocab):
        return _EmbedLookup.apply(table, tokens)
    start = tp.span(table.shape[0])[0]
    return tp.reduce(_EmbedLookup.apply(table, tokens, start))


def _angles_for(cfg: ModelConfig, batch: int, seq: int, device,
                position: Optional[int] = None) -> torch.Tensor:
    """RoPE angles for positions 0..S-1, or for the one decode ``position``
    (S = 1): (1, S, hd//2), and with M-RoPE (B, S, hd//2).

    M-RoPE, as the JAX package: the parallel forward puts the first
    ``vision_tokens`` positions on the vision grid whether or not vision
    embeddings are given; decode gives a token p = position - V + 1 on all
    three axes, negative for a position inside the vision prefix."""
    hd = cfg.resolved_head_dim
    if cfg.mrope_sections:
        if position is None:
            pos3 = rope_lib.mrope_positions(batch, seq, cfg.vision_tokens,
                                            cfg.vision_grid, device=device)
        else:
            p = torch.tensor([position - cfg.vision_tokens + 1],
                             device=device)
            pos3 = p.reshape(1, 1, 1).expand(3, batch, 1)
        return rope_lib.mrope_angles(pos3, hd, cfg.rope_theta,
                                     cfg.mrope_sections)
    pos = (torch.arange(seq, device=device) if position is None
           else torch.tensor([position], device=device))
    return rope_lib.rope_angles(pos[None], hd, cfg.rope_theta)


def _run_blocks(params: PyTree, h: torch.Tensor, cfg: ModelConfig, angles,
                causal: bool, enc_out: Optional[torch.Tensor] = None,
                attn_impl: str = "kernel", layout=None, pspecs=None):
    """Loop over the stacked blocks of ``params["blocks"]`` (the decoder's
    n_repeats, the encoder's n_encoder_layers: the leaves' leading axis,
    which the JAX package's ``lax.scan`` walks); returns (h, aux_loss), the
    aux loss summed over blocks.  On a mesh h is this rank's slice as
    ``layout`` splits it, and each layer's leaves that ``pspecs`` (the
    blocks' PartitionSpecs) split over (pod, data) are gathered before it
    (fsdp; inside the rematerialised block, so the backward gathers them
    again)."""
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    n = tree_leaves(params["blocks"])[0].shape[0]

    def run(layer, h):
        if pspecs is not None:
            layer = tensor_parallel.gather_fsdp(layer, pspecs["blocks"],
                                                layout.mesh, offset=1)
        return blocks.block_fwd(layer, h, cfg, angles, causal,
                                enc_out=enc_out, attn_impl=attn_impl,
                                layout=layout)

    for layer in unstack_layers(params["blocks"], n):
        if remat:
            h, aux = checkpoint(run, layer, h, use_reentrant=False)
        else:
            h, aux = run(layer, h)
        aux_total = aux_total + aux
    return h, aux_total


def _merge_vision(cfg: ModelConfig, h: torch.Tensor,
                  vision_embeds: Optional[torch.Tensor],
                  start: int = 0) -> torch.Tensor:
    """Positions [0, V) of h take ``vision_embeds`` (B, V, D), cast to h's
    dtype; the token ids there are ignored, and their embedding rows get
    no gradient from them (a ``where``, as in the JAX package).  h holds
    positions ``start``.. (a rank's share of the sequence on a mesh)."""
    if not cfg.vision_tokens or vision_embeds is None:
        return h
    vt = cfg.vision_tokens
    s = h.shape[1]
    vis = torch.nn.functional.pad(vision_embeds.to(h.dtype),
                                  (0, 0, 0, max(0, start + s - vt)))
    vis = vis[:, start:start + s]
    mask = (start + torch.arange(s, device=h.device) < vt)[None, :, None]
    return torch.where(mask, vis, h)


def encode(params: PyTree, enc_embeds: torch.Tensor, cfg: ModelConfig,
           attn_impl: str = "kernel", layout=None,
           pspecs=None) -> torch.Tensor:
    """Encoder stack (seamless): frame embeddings (B, S_enc, D), cast to
    ``cfg.dtype``, through the encoder's layers (RoPE over positions
    0..S_enc-1, bidirectional attention) and its final norm.  On a mesh
    (``layout``, enc_embeds this rank's batch rows) the frames are not
    split: each rank encodes all of them, which every decoder position's
    cross-attention reads; under ``megatron`` on the rank's heads and
    width, as the decoder (``pspecs``: the model's PartitionSpecs, for
    fsdp)."""
    b, s = enc_embeds.shape[:2]
    if layout is not None:
        layout = shd.BatchLayout(layout.mesh, layout.batch_dims)
    enc = params["encoder"]
    final = enc["final_norm"]
    if pspecs is not None:
        final = tensor_parallel.gather_fsdp(final,
                                            pspecs["encoder"]["final_norm"],
                                            layout.mesh)
    h, _ = _run_blocks(enc, enc_embeds.to(DTYPES[cfg.dtype]),
                       cfg, _angles_for(cfg, b, s, enc_embeds.device),
                       causal=False, attn_impl=attn_impl, layout=layout,
                       pspecs=None if pspecs is None else pspecs["encoder"])
    return rmsnorm(final, h, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

#: the leaves outside the blocks that the forward reads whole on a rank
_TOP = ("embed", "unembed", "final_norm")


def _forward(params: PyTree, batch: Dict[str, torch.Tensor],
             cfg: ModelConfig, attn_impl: str, mesh, serve: bool = False):
    """(final hidden states, aux loss, layout, top): on a mesh the hidden
    states are this rank's slice as ``layout`` splits them, without one
    the whole batch (layout None); ``top`` holds the leaves of
    :data:`_TOP`, gathered over (pod, data) where fsdp splits them.

    On a mesh ``params`` are this rank's slices of the leaves (local
    tensors, or the DTensors of ``shard_tree`` and
    ``Checkpointer.restore(shardings=)``), as
    ``parallel.sharding.param_pspecs`` gives them with ``cfg.fsdp`` or,
    with ``serve``, as :func:`serve_pspecs` gives them (fsdp also where
    ``serve_needs_fsdp`` asks for it); what that placement splits over
    (pod, data) is gathered before each block, the encoder's blocks and
    the leaves of :data:`_TOP` alike."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    with trace.span("lm.forward", tokens=b * s, layers=cfg.n_layers):
        vision = batch.get("vision_embeds")
        angles = _angles_for(cfg, b, s, tokens.device)
        layout, start, tp, pspecs = None, 0, None, None
        if mesh is not None:
            layout = _constrain_batch(cfg, mesh, b, s)
            start = layout.seq_start(s)
            tokens = layout.local(tokens)
            vision = None if vision is None else layout.rows(vision)
            angles = layout.local(angles, batch=angles.shape[0] == b)
            params = shd.to_local(params)
            tp = tensor_parallel.model_group(mesh)
            pspecs = (serve_pspecs(cfg, mesh) if serve
                      else shd.param_pspecs(model_specs(cfg), cfg, mesh))
        top = {k: params[k] for k in _TOP if k in params}
        if pspecs is not None:
            top = tensor_parallel.gather_fsdp(
                top, {k: pspecs[k] for k in top}, mesh)
        h = (_embed_tokens(top, tokens) if tp is None
             else _embed_tokens(top, tokens, cfg, tp))
        h = _merge_vision(cfg, h, vision, start)
        enc_out = None
        if cfg.encoder_decoder:
            enc = batch["enc_embeds"]
            enc_out = encode(params,
                             enc if layout is None else layout.rows(enc),
                             cfg, attn_impl=attn_impl, layout=layout,
                             pspecs=pspecs)
        h, aux = _run_blocks(params, h, cfg, angles, causal=True,
                             enc_out=enc_out, attn_impl=attn_impl,
                             layout=layout, pspecs=pspecs)
        return rmsnorm(top["final_norm"], h, cfg.norm_eps), aux, layout, top


def forward_hidden(params: PyTree, batch: Dict[str, torch.Tensor],
                   cfg: ModelConfig, attn_impl: str = "kernel", mesh=None):
    """Returns (final hidden states (B,S,D), aux_loss): the MoE routers'
    load-balancing loss summed over layers, 0 without MoE.  batch: tokens
    (B, S); for a vision model optionally vision_embeds (B, V, D), which
    replace the first V positions' token embeddings; for an
    encoder-decoder enc_embeds (B, S_enc, D), the encoder's input, which
    it needs (a ``KeyError`` without them, as in the JAX package).

    With ``mesh`` (a ``DeviceMesh``) every rank passes the whole batch and
    its slices of the parameters (see :func:`_forward`), and computes its
    slice of the activations as :func:`_constrain_batch` splits them: the
    embedding of its tokens, RoPE at its positions' global indices, the
    blocks (attention gathering K/V once a layer when the sequence is
    split; under ``megatron`` each layer on the rank's share of the
    weights), the final norm.  The hidden states are then a DTensor with
    that split; the aux loss spans the whole batch on every rank."""
    h, aux, layout, _ = _forward(params, batch, cfg, attn_impl, mesh)
    if layout is None:
        return h, aux
    return layout.dtensor(h, tuple(batch["tokens"].shape) + h.shape[2:]), aux


def _vocab_split(top: PyTree, cfg: ModelConfig, tp) -> bool:
    """Whether the logits' vocabulary is split over ``tp`` (the table's
    rows, tied, or the unembedding's columns)."""
    if tp is None:
        return False
    v = (top["embed"].shape[0] if cfg.tie_embeddings
         else top["unembed"].shape[1])
    return tp.split(v, cfg.padded_vocab)


def _unembed(params: PyTree, h: torch.Tensor, cfg: ModelConfig, tp=None):
    """Logits (B,S,V); with the vocabulary split over ``tp``, this rank's
    columns of them (h the rank's replicated copy)."""
    if _vocab_split(params, cfg, tp):
        h = tp.copy(h)
    if cfg.tie_embeddings:
        return torch.matmul(h, params["embed"].t())
    return torch.matmul(h, params["unembed"])


class _VocabParallelCE(torch.autograd.Function):
    """Cross-entropy over logits split on the vocabulary over a group:
    logits (..., V/n) float32 are this rank's columns from ``start``; the
    max and the sum of exponentials are reduced over the group, and the
    target's logit comes from the rank that holds it.  Returns the
    per-token ``logsumexp - target logit``, the same on every rank; the
    gradient is this rank's columns of ``softmax - onehot``."""

    @staticmethod
    def forward(ctx, logits, targets, start, mesh, dims):
        n = logits.shape[-1]
        m = logits.amax(dim=-1, keepdim=True)
        collectives.all_reduce(m, mesh, dims, op=dist.ReduceOp.MAX)
        e = torch.exp(logits - m)
        se = collectives.all_reduce(e.sum(dim=-1, keepdim=True), mesh, dims)
        rows = targets.long() - start
        inside = (rows >= 0) & (rows < n)
        rows = torch.where(inside, rows, 0)
        true = torch.gather(logits, -1, rows[..., None])[..., 0]
        true = collectives.all_reduce(torch.where(inside, true, 0.0), mesh,
                                      dims)
        ctx.save_for_backward(e.div_(se), rows, inside)
        return m[..., 0] + torch.log(se[..., 0]) - true

    @staticmethod
    def backward(ctx, g):
        p, rows, inside = ctx.saved_tensors
        grad = p.scatter_add(-1, rows[..., None],
                             -inside[..., None].to(p.dtype))
        return grad * g[..., None], None, None, None, None


def lm_loss(params: PyTree, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig, attn_impl: str = "plain", mesh=None):
    """Cross-entropy over the real vocabulary (padded columns masked), mean
    over the tokens whose target is >= 0.  batch: tokens, targets (B, S).
    Returns (loss + aux_loss, {"ce_loss", "aux_loss", "tokens"}).

    With ``mesh`` (the sequence not split over ``model``: under
    ``seq_dp`` and ``ep_seq`` where ``attention.seq_parallel`` says no),
    every rank passes the whole batch and its slices of the parameters;
    the values are the whole batch's on every rank, and the gradient of
    the returned loss is this rank's share: its tokens' (a batch
    replicated over (pod, data) divides it by the copies), summed over
    the ranks by ``train.steps``.  Under
    ``megatron`` the cross-entropy is vocab-parallel (the JAX package
    constrains the logits to the vocabulary over ``model``)."""
    h, aux, layout, top = _forward(params, batch, cfg, attn_impl, mesh)
    if layout is not None and layout.seq_dims and torch.is_grad_enabled():
        raise NotImplementedError(
            "lm_loss's gradient with the sequence split over 'model' "
            f"({cfg.shard_strategy!r}): the JAX package's sequence-parallel "
            "attention walks its keys in a fori_loop of dynamic bounds, "
            "which jax.grad refuses, so it has no such train step")
    tp = None if mesh is None else tensor_parallel.model_group(mesh)
    split = _vocab_split(top, cfg, tp)
    logits = _unembed(top, h, cfg, tp).float()
    start = tp.span(logits.shape[-1])[0] if split else 0
    if cfg.padded_vocab > cfg.vocab_size:
        pad = start + torch.arange(logits.shape[-1], device=logits.device) \
            >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    targets = batch["targets"]
    if layout is not None:
        targets = layout.local(targets)
    if split:
        nll = _VocabParallelCE.apply(logits, targets, start, mesh,
                                     tp.dims)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        true_logit = torch.gather(
            logits, -1, targets.clamp_min(0)[..., None].long())[..., 0]
        nll = lse - true_logit
    token_mask = (targets >= 0).float()
    nll = nll * token_mask
    n_tokens = torch.sum(token_mask)
    if layout is None:
        loss = torch.sum(nll) / torch.clamp_min(n_tokens, 1.0)
    else:
        dims = layout.batch_dims + layout.seq_dims
        n_tokens = collectives.all_reduce(n_tokens, mesh, dims)
        share = torch.sum(nll) / torch.clamp_min(n_tokens, 1.0)
        loss = tensor_parallel.share_of(share, collectives.all_reduce(
            share.detach().clone(), mesh, dims))
    metrics = {"ce_loss": loss, "aux_loss": aux, "tokens": n_tokens}
    total = loss + aux
    copies = 1 if layout is None else collectives.group_size(
        mesh, tensor_parallel.replicas_of(layout.batch_dims, mesh,
                                          shd.batch_axes(mesh)))
    if copies > 1:
        total = tensor_parallel.share_of(total / copies, total)
    return total, metrics


def lm_logits(params: PyTree, batch: Dict[str, torch.Tensor],
              cfg: ModelConfig, attn_impl: str = "kernel",
              mesh=None) -> torch.Tensor:
    """Logits (B, S, padded_vocab) over a full prompt; with ``mesh``, a
    DTensor split as :func:`forward_hidden`'s hidden states are, and under
    ``megatron`` its vocabulary over ``model`` (each rank computes its
    columns, as the JAX package constrains them).  On a mesh ``params``
    are this rank's serving slices (:func:`serve_pspecs`), the placement
    :func:`decode_step` and :func:`prefill` take."""
    h, _, layout, top = _forward(params, batch, cfg, attn_impl, mesh,
                                 serve=True)
    tp = None if mesh is None else tensor_parallel.model_group(mesh)
    logits = _unembed(top, h, cfg, tp)
    if layout is None:
        return logits
    return layout.dtensor(logits, tuple(batch["tokens"].shape)
                          + (cfg.padded_vocab,),
                          vocab_dims=tp.dims if _vocab_split(top, cfg, tp)
                          else ())


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode
# ---------------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, batch: int, seq: int,
                cross_len: int = 0) -> PyTree:
    """Stacked decode caches as ``{name: (shape, dtype)}``: a tuple over
    pattern positions, each shape with a leading ``n_repeats`` axis; an
    encoder-decoder's layers also hold ``cross_len`` encoder positions of
    cross-attention K/V."""
    out = []
    for spec in cfg.pattern:
        layer = blocks.layer_cache_specs(
            cfg, spec, batch, seq, cross_len if cfg.encoder_decoder else 0)
        out.append({name: ((cfg.n_repeats,) + shape, dt)
                    for name, (shape, dt) in layer.items()})
    return tuple(out)


def serve_pspecs(cfg: ModelConfig, mesh) -> PyTree:
    """The serving weights' PartitionSpecs on ``mesh``: ``param_pspecs``
    with fsdp where ``cfg.fsdp`` or ``serve_needs_fsdp`` asks for it, as
    the JAX package's decode and prefill cells place them."""
    return shd.param_pspecs(model_specs(cfg), cfg, mesh,
                            fsdp=cfg.fsdp or shd.serve_needs_fsdp(cfg, mesh))


def init_cache(cfg: ModelConfig, batch: int, seq: int, cross_len: int = 0,
               device=None, mesh=None) -> PyTree:
    """Zeroed decode caches of :func:`cache_specs`: a tuple over pattern
    positions, each a dict of tensors with a leading ``n_repeats`` axis
    (attention K/V ring buffers of ``seq`` slots and, with
    ``cfg.decode_ring``, the two-tier cache's ring of recent tokens; Mamba,
    mLSTM and sLSTM states; cross-attention K/V), on ``device`` (CUDA
    unless the caller asks for another).

    With ``mesh`` (a ``DeviceMesh``) each leaf is a DTensor of the whole
    cache whose local tensor is this rank's slice by ``cache_pspecs``
    (``batch`` the global batch), on the mesh's device type: no rank
    allocates more than its slices."""
    specs = cache_specs(cfg, batch, seq, cross_len)
    if mesh is None:
        device = resolve_device(device)
        return tuple({name: torch.zeros(shape, dtype=dt, device=device)
                      for name, (shape, dt) in layer.items()}
                     for layer in specs)
    out = []
    for layer, shardings in zip(specs, shd.cache_shardings(specs, cfg, mesh,
                                                           batch)):
        one = {}
        for name, (shape, dt) in layer.items():
            local = tuple(hi - lo for lo, hi in
                          shardings[name].local_ranges(shape))
            one[name] = shd.from_local(
                torch.zeros(local, dtype=dt, device=mesh.device_type),
                shardings[name], shape)
        out.append(one)
    return tuple(out)


def _global_cache_specs(caches: PyTree) -> PyTree:
    """``{name: (shape, dtype)}`` of the whole caches whose DTensor leaves
    (:func:`init_cache` with a mesh) are this rank's slices."""
    from torch.distributed.tensor import DTensor
    out = []
    for layer in caches:
        for name, t in layer.items():
            if not isinstance(t, DTensor):
                raise TypeError(f"cache leaf {name!r} on a mesh is no "
                                "DTensor: pass init_cache(..., mesh=)'s")
        out.append({name: (tuple(t.shape), t.dtype)
                    for name, t in layer.items()})
    return tuple(out)


def fill_cross_caches(params: PyTree, caches: PyTree, enc_out: torch.Tensor,
                      cfg: Optional[ModelConfig] = None, mesh=None) -> None:
    """Writes every decoder layer's cross-attention K/V, the encoder's
    output ``enc_out`` (B, S_enc, D) projected by the layers' stacked
    ``wk`` and ``wv`` at once, into the caches of :func:`init_cache` (with
    ``cross_len`` S_enc), as the JAX package's ``prefill`` computes them.

    With ``mesh`` (and ``cfg``), params are this rank's slices, caches
    :func:`init_cache`'s DTensors and enc_out this rank's batch rows: each
    rank projects the frames of its slice of S_enc (``cache_pspecs``) by
    ``wk``/``wv`` gathered whole (over (pod, data) where fsdp splits them,
    over ``model`` where their head columns are split: a layer's weights
    are smaller than its frames' K/V), so that its slice holds every
    head."""
    if mesh is None:
        for layer, cache in zip(params["blocks"], caches):
            for w, name in (("wk", "cross_k"), ("wv", "cross_v")):
                kv = torch.einsum("bsd,rde->rbse", enc_out,
                                  layer["cross_attn"][w])
                cache[name].copy_(kv.reshape(cache[name].shape))
        return
    specs = _global_cache_specs(caches)
    slices = shd.cache_slices(specs, cfg, mesh, specs[0]["cross_k"][0][1])
    pspecs = serve_pspecs(cfg, mesh)["blocks"]
    tp = tensor_parallel.model_group(mesh)
    params, caches = shd.to_local(params), shd.to_local(caches)
    kvd = cfg.n_kv_heads * cfg.resolved_head_dim
    for layer, spec, cache, sl in zip(params["blocks"], pspecs, caches,
                                      slices):
        lo, hi = sl["cross_k"].ranges[1]
        frames = enc_out[:, lo:hi]
        ws = tensor_parallel.gather_fsdp(
            {w: layer["cross_attn"][w] for w in ("wk", "wv")},
            {w: spec["cross_attn"][w] for w in ("wk", "wv")}, mesh)
        for w, name in (("wk", "cross_k"), ("wv", "cross_v")):
            if tp is not None and tp.split(ws[w].shape[-1], kvd):
                ws[w] = collectives.all_gather_cat(ws[w], mesh, tp.dims, -1)
            kv = torch.einsum("bsd,rde->rbse", frames, ws[w])
            cache[name].copy_(kv.reshape(cache[name].shape))


def _serve_layout(mesh, batch: int) -> "shd.BatchLayout":
    """The token batch's split in decode and prefill on ``mesh``: over
    (pod, data) by ``batch_pspec``'s default rule, whatever the strategy
    (the JAX package's decode cell puts no token over ``model``)."""
    return shd.BatchLayout(mesh, shd.axis_members(
        shd.batch_pspec(mesh, batch, extra_dims=1)[0]))


class _MeshDecode:
    """Decode on a ``DeviceMesh``, as the JAX package's decode cell places
    it: the token batch over (pod, data) by ``batch_pspec`` (whatever the
    strategy), the weights by :func:`serve_pspecs`, the caches by
    ``cache_pspecs`` (``cache_specs`` the whole caches' shapes).  Each rank
    computes on its slices with explicit collectives (no DTensor
    dispatch): each layer gathers its leaves that fsdp splits, then decodes
    (``blocks.layer_decode`` with its ``DecodeShards``)."""

    def __init__(self, cfg: ModelConfig, mesh, cache_specs: PyTree,
                 batch: int):
        self.cfg, self.mesh, self.batch = cfg, mesh, batch
        self.layout = _serve_layout(mesh, batch)
        self.tp = tensor_parallel.model_group(mesh)
        self.pspecs = serve_pspecs(cfg, mesh)
        vocab = (self.pspecs["embed"][0] if cfg.tie_embeddings
                 else self.pspecs["unembed"][1])
        self.vocab_dims = (self.tp.dims if self.tp is not None and "model"
                           in shd.axis_members(vocab) else ())
        self.shards = tuple(
            blocks.DecodeShards(self.layout, self.tp, sl)
            for sl in shd.cache_slices(cache_specs, cfg, mesh, batch))

    def step(self, params: PyTree, caches: PyTree, token: torch.Tensor,
             pos: int) -> torch.Tensor:
        """This rank's logits (its batch rows; its vocabulary columns where
        they are split) of one step; params and caches local tensors."""
        cfg, mesh = self.cfg, self.mesh
        top = tensor_parallel.gather_fsdp(
            {k: params[k] for k in _TOP if k in params},
            {k: self.pspecs[k] for k in _TOP if k in params}, mesh)
        tokens = self.layout.rows(token)
        h = _embed_tokens(top, tokens, cfg, self.tp)
        angles = _angles_for(cfg, tokens.shape[0], 1, token.device,
                             position=pos)
        for i in range(cfg.n_repeats):
            layer = tensor_parallel.gather_fsdp(
                take_layer(params["blocks"], i), self.pspecs["blocks"], mesh,
                offset=1)
            h, _ = blocks.block_decode(layer, h, take_layer(caches, i), pos,
                                       cfg, angles, self.shards)
        h = rmsnorm(top["final_norm"], h, cfg.norm_eps)
        return _unembed(top, h, cfg, self.tp)

    def dtensor(self, logits: torch.Tensor, seq: int = 1):
        """This rank's logits (B, seq, V) as a DTensor of the whole."""
        return self.layout.dtensor(
            logits, (self.batch, seq, self.cfg.padded_vocab),
            vocab_dims=self.vocab_dims)


def mesh_decoder(cfg: ModelConfig, mesh, caches: PyTree,
                 batch: int) -> _MeshDecode:
    """The placements of :func:`decode_step` with ``mesh`` for caches of
    :func:`init_cache` with that mesh and a token batch of ``batch``: built
    once, it serves every step on such caches (``decode_step(...,
    plan=)``)."""
    return _MeshDecode(cfg, mesh, _global_cache_specs(caches), batch)


def decode_step(params: PyTree, caches: PyTree, token: torch.Tensor,
                pos: int, cfg: ModelConfig, mesh=None, plan=None):
    """One decode step.  token (B,1) integer; pos the current length.

    Returns (logits (B,1,V), caches).  The caches are updated in place
    (attention's ring buffers, see ``attention.attention_decode``, and the
    recurrent states), and the returned caches are the ones passed in.

    With ``mesh`` (a ``DeviceMesh``) every rank passes the whole token
    batch, its slices of the parameters (:func:`serve_pspecs`: local
    tensors or DTensors) and the caches of :func:`init_cache` with that
    mesh (DTensors, each rank's slice updated in place); the logits are a
    DTensor split over the token batch's dims and, where the vocabulary
    is split, over ``model``.  ``plan`` is :func:`mesh_decoder`'s for
    these caches and batch (built here when it is not given)."""
    if mesh is not None:
        run = plan or mesh_decoder(cfg, mesh, caches, token.shape[0])
        logits = run.step(shd.to_local(params), shd.to_local(caches), token,
                          int(pos))
        return run.dtensor(logits), caches
    h = _embed_tokens(params, token)
    angles = _angles_for(cfg, token.shape[0], 1, token.device,
                         position=int(pos))
    for i in range(cfg.n_repeats):
        layer_caches = take_layer(caches, i)
        h, _ = blocks.block_decode(take_layer(params["blocks"], i), h,
                                   layer_caches, int(pos), cfg, angles)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return _unembed(params, h, cfg), caches


def prefill(params: PyTree, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            cache_len: int, mesh=None):
    """Run the full prompt by replaying it one token at a time through
    :func:`decode_step` (exact), materializing decode caches of capacity
    ``cache_len``.  Returns (logits (B,S,V), caches).  Under
    ``cfg.decode_ring`` the replay, as the JAX package's, writes only the
    rings, and attention reads a main cache that stays zero.

    An encoder-decoder first encodes ``batch["enc_embeds"]`` and fills every decoder layer's cross-attention
    K/V from the encoder's output.  Only ``batch["tokens"]`` is replayed,
    as in the JAX package: a vision model's ``vision_embeds`` are ignored
    and its prefix positions take the decode positions (negative below
    V - 1), not the vision grid.

    With ``mesh`` every rank passes the whole batch and its slices of the
    parameters (:func:`serve_pspecs`); the encoder runs on the mesh as
    ``encode`` does (the rank's batch rows, under ``megatron`` its heads),
    the cross caches are filled as :func:`fill_cross_caches` says, and the
    replay goes through the sharded decode step.  The logits are a DTensor
    as :func:`decode_step`'s, the caches :func:`init_cache`'s DTensors."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    if mesh is not None:
        params = shd.to_local(params)
    enc_out = None
    if cfg.encoder_decoder:
        enc = batch["enc_embeds"]
        if mesh is None:
            enc_out = encode(params, enc, cfg)
        else:
            layout = _serve_layout(mesh, b)
            enc_out = encode(params, layout.rows(enc), cfg, layout=layout,
                             pspecs=serve_pspecs(cfg, mesh))
    cross_len = 0 if enc_out is None else enc_out.shape[1]
    caches = init_cache(cfg, b, cache_len, cross_len, device=tokens.device,
                        mesh=mesh)
    if enc_out is not None:
        fill_cross_caches(params, caches, enc_out, cfg, mesh)
    if mesh is not None:
        run = _MeshDecode(cfg, mesh, cache_specs(cfg, b, cache_len,
                                                 cross_len), b)
        local = shd.to_local(caches)
        logits = [run.step(params, local, tokens[:, i:i + 1], i)[:, 0]
                  for i in range(s)]
        return run.dtensor(torch.stack(logits, dim=1), s), caches
    logits = []
    for i in range(s):
        lg, caches = decode_step(params, caches, tokens[:, i:i + 1], i, cfg)
        logits.append(lg[:, 0])
    return torch.stack(logits, dim=1), caches
