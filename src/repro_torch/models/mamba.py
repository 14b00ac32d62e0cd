"""Mamba (selective SSM) mixer, as ``repro.models.mamba``.

The recurrence h_t = a_t h_{t-1} + bx_t (diagonal A, state (B, d_inner,
N) in float32) runs as a loop over time steps inside each chunk of
``ssm_chunk`` tokens, and each chunk's states are contracted with C before
the next chunk starts, so no (B, S, d_inner, N) state tensor is held.  The
reference scans a chunk with ``jax.lax.associative_scan``; PyTorch has no
stable associative scan, and a cumulative product of the decays in log
space loses the state once the decay underflows across a chunk.  The loop
is the exact recurrence (the one ``mamba_decode`` takes a step of), at one
fused multiply-add launch per token.

On a mesh under ``megatron`` the inner channels are split over ``model``:
``conv_w``, ``conv_b``, ``dt_proj``, ``dt_bias``, ``A_log``, ``D`` and
``out_proj`` per channel, ``x_proj`` on its rows (a contraction over the
channels: partial sums, summed over ``model``), and ``in_proj`` on its
fused (x, z) columns, which the contiguous slice cuts across the halves;
its product is gathered over ``model`` and each rank takes both halves of
its own channels (``tensor_parallel.own_channels``).  Each rank scans its
channels.  In decode on a mesh the states hold the rank's channels
under every strategy (``cache_pspecs``), and whole weights are cut to them
(:func:`mamba_decode`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import DTYPES, ParamSpec, PyTree
from repro_torch.parallel import tensor_parallel


def mamba_specs(cfg: ModelConfig) -> PyTree:
    d, di, n, r, w = (cfg.d_model, cfg.d_inner, cfg.ssm_state_dim,
                      cfg.dt_rank, cfg.ssm_conv_width)
    dt = DTYPES[cfg.param_dtype]
    return {
        "in_proj": ParamSpec((d, 2 * di), dt,
                             logical_axes=("embed", "mamba_inner")),
        "conv_w": ParamSpec((w, di), dt, init_scale=0.5,
                            logical_axes=(None, "mamba_inner")),
        "conv_b": ParamSpec((di,), dt, init="zeros",
                            logical_axes=("mamba_inner",)),
        "x_proj": ParamSpec((di, r + 2 * n), dt,
                            logical_axes=("mamba_inner", None)),
        "dt_proj": ParamSpec((r, di), dt,
                             logical_axes=(None, "mamba_inner")),
        "dt_bias": ParamSpec((di,), dt, init="zeros",
                             logical_axes=("mamba_inner",)),
        "A_log": ParamSpec((di, n), torch.float32, init="ones",
                           logical_axes=("mamba_inner", None)),
        "D": ParamSpec((di,), torch.float32, init="ones",
                       logical_axes=("mamba_inner",)),
        "out_proj": ParamSpec((di, d), dt,
                              logical_axes=("mamba_inner", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 init_state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv. x (B,S,di), w (W,di). init_state (B,W-1,di).
    Summed tap by tap in x's dtype, in the reference's order."""
    width, s = w.shape[0], x.shape[1]
    if init_state is None:
        pad = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    else:
        pad = init_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = xp[:, 0:s] * w[0]
    for i in range(1, width):
        out = out + xp[:, i:i + s] * w[i]
    return out + b


def _ssm_inputs(params: PyTree, x_conv: torch.Tensor, cfg: ModelConfig,
                tp=None):
    """x_conv (B,S,di) -> decay a (B,S,di,N), input bx (B,S,di,N) and C
    (B,S,N), float32.  With ``tp``, x_conv holds this rank's channels and
    ``x_proj`` its rows: the projection is summed over ``model``."""
    n, r = cfg.ssm_state_dim, cfg.dt_rank
    proj = torch.matmul(x_conv, params["x_proj"])  # (B,S,r+2N)
    if tp is not None:
        proj = tp.copy(tp.reduce(proj))
    dt_in, b_in, c_in = torch.split(proj, [r, n, n], dim=-1)
    dt = F.softplus(torch.matmul(dt_in, params["dt_proj"])
                    + params["dt_bias"]).float()
    a_mat = -torch.exp(params["A_log"])  # (di, N), negative
    a = torch.exp(dt[..., None] * a_mat)  # decay in (0, 1]
    bx = (dt * x_conv.float())[..., None] * b_in.float()[:, :, None, :]
    return a, bx, c_in.float()


def _gated_out(params: PyTree, y: torch.Tensor, x_conv: torch.Tensor,
               z: torch.Tensor, dtype) -> torch.Tensor:
    y = y + params["D"] * x_conv.float()
    return torch.matmul(y.to(dtype) * F.silu(z), params["out_proj"])


def mamba_fwd(params: PyTree, x: torch.Tensor, cfg: ModelConfig,
              tp=None) -> torch.Tensor:
    """x (B,S,D) -> (B,S,D).  Chunked selective scan.  With ``tp`` (a
    ``parallel.tensor_parallel.ModelGroup``) and the inner channels split
    over it, params hold this rank's slices (see the module's note)."""
    b, s, _ = x.shape
    di = params["conv_b"].shape[0]
    if tp is not None and not tp.split(di, cfg.d_inner):
        tp = None
    if tp is None:
        xu, z = torch.matmul(x, params["in_proj"]).chunk(2, dim=-1)
    else:
        xu, z = tensor_parallel.own_channels(
            torch.matmul(tp.copy(x), params["in_proj"]), tp)
    x_conv = F.silu(_causal_conv(xu, params["conv_w"], params["conv_b"]))
    a, bx, c = _ssm_inputs(params, x_conv, cfg, tp)
    chunk = min(cfg.ssm_chunk, s)
    assert s % chunk == 0, (s, chunk)
    h = x.new_zeros((b, di, cfg.ssm_state_dim), dtype=torch.float32)
    ys = []
    for c0 in range(0, s, chunk):
        hs = []
        for t in range(c0, c0 + chunk):
            h = torch.addcmul(bx[:, t], a[:, t], h)
            hs.append(h)
        ys.append(torch.einsum("btdn,btn->btd", torch.stack(hs, 1),
                               c[:, c0:c0 + chunk]))
    out = _gated_out(params, torch.cat(ys, 1), x_conv, z, x.dtype)
    return out if tp is None else tp.reduce(out)


def _channel_params(params: PyTree, c0: int, c1: int, di: int) -> PyTree:
    """Whole Mamba weights cut to the inner channels [c0, c1): both halves
    of ``in_proj``'s fused columns, and every per-channel leaf."""
    out = {k: params[k].narrow(d, c0, c1 - c0) for k, d in (
        ("conv_w", 1), ("conv_b", 0), ("x_proj", 0), ("dt_proj", 1),
        ("dt_bias", 0), ("A_log", 0), ("D", 0), ("out_proj", 0))}
    w = params["in_proj"]
    out["in_proj"] = torch.cat([w[:, c0:c1], w[:, di + c0:di + c1]], dim=-1)
    return out


def mamba_decode(params: PyTree, x: torch.Tensor, conv_state: torch.Tensor,
                 h_state: torch.Tensor, cfg: ModelConfig, tp=None):
    """One-token decode.  x (B,1,D); conv_state (B,W-1,di); h_state
    (B,di,N).  Returns (out (B,1,D), conv_state, h_state), new tensors.

    On a mesh (``tp``) the states may hold this rank's share of the inner
    channels (``cache_pspecs`` splits d_inner over ``model``): the rank
    steps those channels only.  Under ``megatron`` its weights are the same
    channels' (the module's note); otherwise they are whole and cut to
    them.  ``x_proj``'s and ``out_proj``'s contractions over the channels
    are summed over ``model``."""
    di = cfg.d_inner
    split = tp is not None and tp.split(h_state.shape[1], di)
    if split and tp.split(params["conv_b"].shape[0], di):
        xu, z = tensor_parallel.own_channels(
            torch.matmul(x, params["in_proj"]), tp)
    else:
        if split:
            params = _channel_params(params, *tp.span(h_state.shape[1]), di)
        xu, z = torch.matmul(x, params["in_proj"]).chunk(2, dim=-1)
    tp = tp if split else None
    x_conv = F.silu(_causal_conv(xu, params["conv_w"], params["conv_b"],
                                 init_state=conv_state))
    new_conv_state = torch.cat([conv_state[:, 1:], xu.to(conv_state.dtype)],
                               dim=1)
    a, bx, c = _ssm_inputs(params, x_conv, cfg, tp)
    h = torch.addcmul(bx[:, 0], a[:, 0], h_state)  # (B,di,N)
    y = torch.einsum("bdn,bn->bd", h, c[:, 0])[:, None, :]
    out = _gated_out(params, y, x_conv, z, x.dtype)
    return (out if tp is None else tp.reduce(out)), new_conv_state, h


def mamba_cache_specs(cfg: ModelConfig, batch: int):
    """Decode-state shapes and dtypes of one mamba layer."""
    return {
        "conv": ((batch, cfg.ssm_conv_width - 1, cfg.d_inner),
                 DTYPES[cfg.dtype]),
        "h": ((batch, cfg.d_inner, cfg.ssm_state_dim), torch.float32),
    }
