"""Mixture-of-Experts layer: top-k routing and GShard-style grouped dense
dispatch with a capacity factor, as ``repro.models.moe``.

The dispatch one-hot has shape (groups, group_tokens, experts, capacity)
with capacity = group_tokens * top_k * cf / experts, so its memory and its
einsum FLOPs grow with tokens x group_tokens x top_k x cf, whatever the
expert count.  The casts are the reference's: router logits a ``dot`` in
the activations' dtype cast to float32, the top-k softmax in float32,
dispatch and combine tensors in the activations' dtype.

On a mesh (``moe_fwd`` with ``tp``) the router is replicated and every
rank routes the same tokens in the same groups, so routing, capacities
and drops are the one-process layer's; each rank runs only its experts
(the ``experts`` dim split over ``model``, under ``megatron`` and
``ep_seq``), or, where the expert count does not split, its share of every
expert's hidden width, and the partial outputs are summed over ``model``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import DTYPES, ParamSpec, PyTree
from repro_torch.parallel import collectives, tensor_parallel


def moe_specs(cfg: ModelConfig) -> PyTree:
    d = cfg.d_model
    f = cfg.moe_d_ff or cfg.d_ff
    e = cfg.n_experts
    dt = DTYPES[cfg.param_dtype]
    return {
        "router": ParamSpec((d, e), dt, init_scale=0.1,
                            logical_axes=("embed", None)),
        "wi_gate": ParamSpec((e, d, f), dt,
                             logical_axes=("experts", "embed", "mlp")),
        "wi_up": ParamSpec((e, d, f), dt,
                           logical_axes=("experts", "embed", "mlp")),
        "wo": ParamSpec((e, f, d), dt,
                        logical_axes=("experts", "mlp", "embed")),
    }


def _top_k_gating(logits: torch.Tensor,
                  k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (..., E) -> (weights (..., k), indices (..., k)); softmax over
    the top k.  The indices are ``jax.lax.top_k``'s, in its order: largest
    first, ties lowest index first (a stable descending sort; ``topk``
    promises no order among ties, and bf16 router logits tie often)."""
    top_idx = torch.sort(logits, dim=-1, descending=True,
                         stable=True).indices[..., :k]
    top_vals = torch.gather(logits, -1, top_idx)
    return torch.softmax(top_vals.float(), dim=-1), top_idx


def _capacity(cfg: ModelConfig, tokens: int) -> Tuple[int, int]:
    """(group size, capacity) for ``tokens`` tokens."""
    gt = min(cfg.moe_group_size, tokens)
    assert tokens % gt == 0, (tokens, gt)
    if gt <= 64:
        # decode / tiny-batch regime: dropless (cap covers the worst case)
        # so serving logits are independent of batch grouping
        return gt, gt
    return gt, max(1, int(round(gt * cfg.top_k * cfg.capacity_factor
                                / cfg.n_experts)))


def _aux_loss(density: torch.Tensor, probs_mean: torch.Tensor, e: int,
              batch=None) -> torch.Tensor:
    """``e * sum(density * mean prob)``.  With ``batch`` (mesh, dims), the
    tokens are this rank's share of a batch split over ``dims`` (in whole
    groups): both means span every rank's groups, and the gradient is this
    rank's share (the value is the whole loss, the gradient that of
    ``e * sum(density * local mean prob) / ranks``)."""
    if batch is None:
        return e * torch.sum(density * probs_mean)
    mesh, dims = batch
    n = collectives.group_size(mesh, dims)
    density = collectives.all_reduce(density.detach().clone(), mesh,
                                     dims) / n
    share = e * torch.sum(density * probs_mean) / n
    return tensor_parallel.share_of(share, collectives.all_reduce(
        share.detach().clone(), mesh, dims))


def _route(params: PyTree, xg: torch.Tensor, cfg: ModelConfig, cap: int,
           batch=None):
    """Tokens xg (g, gt, D) -> (dispatch, combine) (g, gt, E, cap) in xg's
    dtype and the aux loss (unweighted; with ``batch``, see
    :func:`_aux_loss`).  A choice past its expert's capacity is dropped:
    its rows are zero."""
    e, k = cfg.n_experts, cfg.top_k
    g, gt, _ = xg.shape
    dt = xg.dtype
    logits = torch.matmul(xg, params["router"]).float()       # (g, gt, E)
    weights, top_idx = _top_k_gating(logits, k)                # (g, gt, k)

    # load-balancing auxiliary loss (Switch-style): mean prob x token share
    probs = torch.softmax(logits, dim=-1)
    density = F.one_hot(top_idx[..., 0], e).float().mean(dim=(0, 1))
    aux = _aux_loss(density, probs.mean(dim=(0, 1)), e, batch)

    # position of each (token, choice) within its expert's capacity buffer,
    # counted over the flattened (token, choice) order
    onehot = F.one_hot(top_idx, e).float()                     # (g, gt, k, E)
    flat = onehot.reshape(g, gt * k, e)
    pos_in_expert = (torch.cumsum(flat, dim=1) - flat).reshape(g, gt, k, e)
    pos = torch.gather(pos_in_expert, -1, top_idx[..., None])[..., 0]
    keep = pos < cap                                           # capacity drop
    weights = weights * keep.to(weights.dtype)

    pos_oh = F.one_hot(pos.long().clamp(max=cap - 1), cap).to(dt) \
        * keep[..., None].to(dt)
    onehot_x = onehot.to(dt)
    dispatch = torch.einsum("gtke,gtkc->gtec", onehot_x, pos_oh)
    combine = torch.einsum("gtke,gtkc->gtec",
                           onehot_x * weights.to(dt)[..., None], pos_oh)
    return dispatch, combine, aux


def _experts(params: PyTree, xe: torch.Tensor) -> torch.Tensor:
    """The SwiGLU expert FFN batched over experts: (g, E, cap, D) ->
    (g, E, cap, D)."""
    gate = torch.einsum("gecd,edf->gecf", xe, params["wi_gate"])
    up = torch.einsum("gecd,edf->gecf", xe, params["wi_up"])
    return torch.einsum("gecf,efd->gecd", F.silu(gate) * up, params["wo"])


def moe_fwd(params: PyTree, x: torch.Tensor, cfg: ModelConfig, tp=None,
            tokens: int = 0, batch=None):
    """x (B, S, D) -> (out (B, S, D), aux_loss scalar float32).

    With ``tp`` (a ``parallel.tensor_parallel.ModelGroup``) the expert
    leaves hold this rank's experts (or its share of each expert's hidden
    width), x is the rank's copy of the tokens it routes, and the output
    is summed over ``model``.  ``tokens`` (default x's) sets the group size
    and capacity: the whole batch's count where x holds a rank's rows of
    it in whole groups, whose aux loss then spans ``batch`` (mesh, dims;
    see :func:`_aux_loss`)."""
    b, s, d = x.shape
    gt, cap = _capacity(cfg, tokens or b * s)
    xg = x.reshape(-1, gt, d)
    dispatch, combine, aux = (_route(params, xg, cfg, cap) if batch is None
                              else _route(params, xg, cfg, cap, batch))
    e_local, _, f_local = params["wi_gate"].shape
    experts = tp is not None and tp.split(e_local, cfg.n_experts)
    split = experts or (tp is not None and tp.split(
        f_local, cfg.moe_d_ff or cfg.d_ff))
    if split:
        xg, combine = tp.copy(xg), tp.copy(combine)
    if experts:
        lo, hi = tp.span(e_local)
        dispatch, combine = dispatch[:, :, lo:hi], combine[:, :, lo:hi]
    # tokens -> expert buffers (g, E, cap, D), experts, back to token order
    xe = torch.einsum("gtd,gtec->gecd", xg, dispatch)
    out = torch.einsum("gecd,gtec->gtd", _experts(params, xe), combine)
    if split:
        out = tp.reduce(out)
    return out.reshape(b, s, d), aux * cfg.router_aux_weight
