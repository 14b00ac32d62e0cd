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

Dropless dispatch (``PortModelConfig.moe_dropless``, the published
OLMoE's): no groups and no capacity.  The router's weights are the softmax
over all experts, of which the top k are kept, renormalised or not
(``router_renormalize``); the T k (token, choice) pairs are sorted by
expert (a stable sort, so that each expert's rows keep token order), the
per-expert offsets found on the device, the rows gathered into expert
order, the SwiGLU expert run as grouped products over the experts' jagged
row counts (``torch._grouped_mm``, with no read-back to the host), and
each token's results scaled by their weights and summed in float32, cast
once (``kernels.moe_combine``: on CUDA one hand-written pass that reads
each row once, on the CPU the plain scatter-add).  Every choice is
computed.  It runs on one device, forward only: the mesh paths and
training raise.

Every ``moe_fwd`` is a span ``moe.forward`` of ``obs.trace`` (one flag
check with tracing off), with ``tokens``, ``experts`` and ``d2h_bytes``,
what the layer read back to the host (0 on either path); the dropless
path adds ``choices`` (T k, every one computed) and ``combine``, the
version of the combine taken (``"kernel"`` or ``"plain"``).  Inside
:func:`recorded_routing` each layer also hands over its experts' indices,
for a check that replays the program's routing.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, port_option
from repro_torch.kernels.moe_combine.ops import VERSIONS, moe_combine_route
from repro_torch.models.common import DTYPES, ParamSpec, PyTree
from repro_torch.obs import trace
from repro_torch.parallel import collectives, tensor_parallel


#: the list that :func:`recorded_routing` fills, or None
_routing: Optional[List[torch.Tensor]] = None


@contextmanager
def recorded_routing():
    """While inside, every MoE layer appends the experts it chose, (tokens,
    k) indices in token order, to the list this yields: the program's
    routing, for a reference that replays it.  No copy and no sync."""
    global _routing
    outer, _routing = _routing, []
    try:
        yield _routing
    finally:
        _routing = outer


def _record(top_idx: torch.Tensor) -> None:
    if _routing is not None:
        _routing.append(top_idx.reshape(-1, top_idx.shape[-1]))


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
    _record(top_idx)

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


def _softmax_top_k(logits: torch.Tensor, k: int,
                   renormalize: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (..., E) float32 -> (weights (..., k), indices (..., k)) in
    :func:`_top_k_gating`'s order; without ``renormalize`` the weights are
    the softmax over all E experts at the top k, summing to less than
    one."""
    if renormalize:
        return _top_k_gating(logits, k)
    top_idx = torch.sort(logits, dim=-1, descending=True,
                         stable=True).indices[..., :k]
    return torch.softmax(logits, dim=-1).gather(-1, top_idx), top_idx


def _grouped_swiglu(params: PyTree, xs: torch.Tensor,
                    ends: torch.Tensor) -> torch.Tensor:
    """The SwiGLU expert FFN on rows xs (N, D) in expert order, expert j's
    rows ending at ``ends[j]`` (int32, on xs's device) -> (N, D): three
    ``torch._grouped_mm`` calls, which read the offsets where they lie, on
    the CPU as on CUDA, and raise for a dtype or a layout they do not
    take."""
    gate = torch._grouped_mm(xs, params["wi_gate"], offs=ends)
    up = torch._grouped_mm(xs, params["wi_up"], offs=ends)
    return torch._grouped_mm(F.silu(gate) * up, params["wo"], offs=ends)


def _dropless(params: PyTree, x: torch.Tensor, cfg: ModelConfig,
              sp) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D): every (token, choice) through its expert
    (the module's docstring); the combine's version is set on ``sp``."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    logits = torch.matmul(xt, params["router"]).float()        # (T, E)
    weights, top_idx = _softmax_top_k(
        logits, cfg.top_k, port_option(cfg, "router_renormalize"))
    _record(top_idx)
    experts, order = torch.sort(top_idx.reshape(-1), stable=True)
    ends = torch.searchsorted(experts, torch.arange(
        cfg.n_experts, device=x.device), right=True).int()
    y = _grouped_swiglu(params, xt.index_select(0, order // cfg.top_k),
                        ends)
    route = moe_combine_route(y, order, weights)
    sp.set(combine=route)
    return VERSIONS[route](y, order, weights).reshape(b, s, d)


def moe_fwd(params: PyTree, x: torch.Tensor, cfg: ModelConfig, tp=None,
            tokens: int = 0, batch=None):
    """x (B, S, D) -> (out (B, S, D), aux_loss scalar float32), inside a
    span ``moe.forward``: the dropless dispatch under ``moe_dropless``
    (one device, forward only, so ``tp``, ``tokens`` and ``batch`` unused,
    which ``blocks`` enforces; its aux loss 0), else :func:`_moe`."""
    b, s, _ = x.shape
    if not port_option(cfg, "moe_dropless"):
        with trace.span("moe.forward", tokens=b * s, experts=cfg.n_experts,
                        d2h_bytes=0):
            return _moe(params, x, cfg, tp, tokens, batch)
    with trace.span("moe.forward", tokens=b * s, choices=b * s * cfg.top_k,
                    experts=cfg.n_experts, d2h_bytes=0) as sp:
        if torch.is_grad_enabled() and (x.requires_grad or any(
                p.requires_grad for p in params.values())):
            raise NotImplementedError(
                f"{cfg.name}: the dropless MoE has no training path")
        return _dropless(params, x, cfg, sp), torch.zeros(
            (), dtype=torch.float32, device=x.device)


def _moe(params: PyTree, x: torch.Tensor, cfg: ModelConfig, tp=None,
         tokens: int = 0, batch=None):
    """The GShard dispatch: (out (B, S, D), aux_loss scalar float32).

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
