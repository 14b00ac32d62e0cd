"""xLSTM blocks, as ``repro.models.xlstm``: mLSTM (matrix memory,
chunkwise-parallel) and sLSTM (scalar memory with exponential gating,
strictly sequential).

* mLSTM: a loop over chunks of ``ssm_chunk`` tokens carrying the (B, H, hd,
  hd) matrix memory and the (B, H, hd) normaliser; within a chunk, (T x T)
  decay-weighted products.  The exponential input gate is bounded by a
  softcap (``_IGATE_CAP``) instead of carrying a max-stabiliser through the
  chunks; the forget gate is a sigmoid <= 1, so products only decay.  The
  casts in the chunk body are the reference's, so bf16 rounds where it
  rounds there.
* sLSTM: its gates read h_{t-1} through block-diagonal recurrent weights,
  so it has no parallel form; the port loops over time steps in Python, a
  few small launches per token, with the m-stabilised update.

On a mesh under ``megatron`` (``tp``), mLSTM's inner channels are split
over ``model``: ``up`` on its fused (u, z) columns (gathered, and both
halves of a rank's channels taken, as Mamba's ``in_proj``), ``wq``,
``wk``, ``wv`` and ``w_gates`` on their rows (partial sums, summed over
``model``), ``down`` on its rows; the cell runs on every rank on the
whole heads.  sLSTM's recurrence is replicated; its ``up``/``down`` split
on the projection width where it divides, ``up`` as a fused pair.

In decode on a mesh the states are split as ``cache_pspecs`` splits them
(mLSTM's by head, or on the key dim where the heads do not divide;
sLSTM's by channel), whatever the strategy: each rank steps its share
(:func:`mlstm_decode`, :func:`slstm_decode`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import DTYPES, ParamSpec, PyTree, softcap
from repro_torch.parallel import collectives, tensor_parallel

_IGATE_CAP = 10.0


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_specs(cfg: ModelConfig) -> PyTree:
    d, di = cfg.d_model, cfg.mlstm_inner
    dt = DTYPES[cfg.param_dtype]
    return {
        "up": ParamSpec((d, 2 * di), dt,
                        logical_axes=("embed", "mlstm_inner")),
        "wq": ParamSpec((di, di), dt,
                        logical_axes=("mlstm_inner", "mlstm_inner2")),
        "wk": ParamSpec((di, di), dt,
                        logical_axes=("mlstm_inner", "mlstm_inner2")),
        "wv": ParamSpec((di, di), dt,
                        logical_axes=("mlstm_inner", "mlstm_inner2")),
        "w_gates": ParamSpec((di, 2 * cfg.n_heads), dt, init_scale=0.1,
                             logical_axes=("mlstm_inner", None)),
        "b_gates": ParamSpec((2 * cfg.n_heads,), torch.float32,
                             init="zeros"),
        "down": ParamSpec((di, d), dt,
                          logical_axes=("mlstm_inner", "embed")),
    }


def _mlstm_qkv_gates(params: PyTree, x: torch.Tensor, cfg: ModelConfig,
                     tp=None):
    """q, k, v (B,S,H,hd), the log gates (B,S,H) float32 and z; with
    ``tp`` z is this rank's channels and the rest whole (summed over
    ``model``)."""
    di, h = cfg.mlstm_inner, cfg.n_heads
    hd = di // h
    if tp is None:
        u, z = torch.matmul(x, params["up"]).chunk(2, dim=-1)
    else:
        u, z = tensor_parallel.own_channels(
            torch.matmul(tp.copy(x), params["up"]), tp)
    b, s = u.shape[:2]
    ys = [torch.matmul(u, params[w]) for w in ("wq", "wk", "wv", "w_gates")]
    if tp is not None:   # the four partial sums in one all-reduce
        ys = tp.reduce(torch.cat(ys, dim=-1)).split(
            [y.shape[-1] for y in ys], dim=-1)
    q = ys[0].reshape(b, s, h, hd)
    k = ys[1].reshape(b, s, h, hd) / math.sqrt(hd)
    v = ys[2].reshape(b, s, h, hd)
    gates = ys[3].float() + params["b_gates"]
    log_i = softcap(gates[..., :h], _IGATE_CAP)          # (B,S,H)
    log_f = F.logsigmoid(gates[..., h:])                 # (B,S,H) <= 0
    return q, k, v, log_i, log_f, z


def _mlstm_chunk(qi, ki, vi, li, lf, c_state, n_state, out_dtype):
    """One chunk: q/k/v (B,T,H,hd), gates (B,T,H) float32, carried c
    (B,H,hd,hd) and n (B,H,hd) float32 -> (h (B,T,H,hd), c, n)."""
    t = qi.shape[1]
    fcum = torch.cumsum(lf, dim=1)  # (B,T,H) inclusive
    ftot = fcum[:, -1]
    # intra-chunk: weight_ts = exp(fcum_t - fcum_s + li_s) q_t.k_s, s <= t
    rel = fcum[:, :, None, :] - fcum[:, None, :, :] + li[:, None, :, :]
    mask = torch.ones((t, t), dtype=torch.bool, device=qi.device).tril()
    decay = torch.exp(rel.masked_fill(~mask[None, :, :, None],
                                      float("-inf")))  # (B,T,T,H)
    scores = torch.einsum("bthd,bshd->btsh", qi, ki).float() * decay
    h_intra = torch.einsum("btsh,bshd->bthd", scores.to(vi.dtype), vi)
    n_intra = torch.einsum("btsh,bshd->bthd", decay.to(ki.dtype), ki)
    # inter-chunk, from the carried state
    qf = qi * torch.exp(fcum).to(qi.dtype)[..., None]
    h_inter = torch.einsum("bthd,bhde->bthe", qf, c_state.to(qi.dtype))
    n_inter = torch.einsum("bthd,bhd->bth", qf, n_state.to(qi.dtype))
    # normaliser max(|n.q|, 1), n_t the intra sum plus the decayed carry
    n_dot_q = (torch.einsum("bthd,bthd->bth", n_intra.float(), qi.float())
               + n_inter.float())
    denom = torch.clamp_min(n_dot_q.abs(), 1.0)[..., None]
    h_out = (h_intra.float() + h_inter.float()) / denom
    # the state at the chunk's end
    wk = torch.exp(ftot[:, None, :] - fcum + li).to(ki.dtype)  # (B,T,H)
    kw = ki * wk[..., None]
    decay_all = torch.exp(ftot)
    c_new = (c_state * decay_all[..., None, None]
             + torch.einsum("bthd,bthe->bhde", kw, vi).float())
    n_new = n_state * decay_all[..., None] + kw.sum(dim=1).float()
    return h_out.to(out_dtype), c_new, n_new


def mlstm_fwd(params: PyTree, x: torch.Tensor, cfg: ModelConfig,
              tp=None) -> torch.Tensor:
    """x (B,S,D) -> (B,S,D), chunkwise-parallel mLSTM.  With ``tp`` (a
    ``parallel.tensor_parallel.ModelGroup``) and the inner channels split
    over it, params hold this rank's slices (see the module's note)."""
    b, s, _ = x.shape
    h_heads = cfg.n_heads
    di = cfg.mlstm_inner
    hd = di // h_heads
    if tp is not None and not tp.split(params["down"].shape[0], di):
        tp = None
    q, k, v, log_i, log_f, z = _mlstm_qkv_gates(params, x, cfg, tp)
    chunk = min(cfg.ssm_chunk, s)
    assert s % chunk == 0, (s, chunk)
    c_state = x.new_zeros((b, h_heads, hd, hd), dtype=torch.float32)
    n_state = x.new_zeros((b, h_heads, hd), dtype=torch.float32)
    hs = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        h_c, c_state, n_state = _mlstm_chunk(
            q[:, sl], k[:, sl], v[:, sl], log_i[:, sl], log_f[:, sl],
            c_state, n_state, x.dtype)
        hs.append(h_c)
    out = torch.cat(hs, dim=1).reshape(b, s, di)
    if tp is None:
        return torch.matmul(out * F.silu(z), params["down"])
    lo, hi = tp.span(z.shape[-1])
    out = tp.copy(out)[..., lo:hi] * F.silu(z)
    return tp.reduce(torch.matmul(out, params["down"]))


def mlstm_decode(params: PyTree, x: torch.Tensor, c_state: torch.Tensor,
                 n_state: torch.Tensor, cfg: ModelConfig, tp=None):
    """One-token mLSTM step. c (B,H,hd,hd), n (B,H,hd) float32.  Returns
    (out (B,1,D), c, n), new tensors.

    On a mesh (``tp``) the states may hold this rank's share over
    ``model`` (``cache_pspecs``: the heads where they divide, else the key
    dim of c and n).  q, k, v and the gates are whole on every rank (summed
    over ``model`` where ``wq``, ``wk``, ``wv`` and ``w_gates`` are split
    on their rows); a rank steps its heads' states and its channels of the
    output, or, holding a share of the key dim, its part of the memory,
    whose contractions with q are summed over ``model``.  ``down`` takes
    this rank's channels (its rows under ``megatron``, a cut of the whole
    leaf otherwise), summed over ``model``."""
    b = x.shape[0]
    di, heads = cfg.mlstm_inner, cfg.n_heads
    hd = di // heads
    w_split = tp is not None and tp.split(params["down"].shape[0], di)
    q, k, v, log_i, log_f, z = _mlstm_qkv_gates(params, x, cfg,
                                                tp if w_split else None)
    by_head = tp is not None and tp.split(c_state.shape[1], heads)
    by_key = tp is not None and tp.split(c_state.shape[2], hd)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]
    log_i, log_f = log_i[:, 0], log_f[:, 0]
    if by_head:
        h0, h1 = tp.span(c_state.shape[1])
        q, k, v, log_i, log_f = (t[:, h0:h1] for t in (q, k, v, log_i,
                                                       log_f))
    i_g = torch.exp(log_i)[..., None]  # (B,H,1)
    f_g = torch.exp(log_f)[..., None]
    ki = k * i_g.to(k.dtype)
    qf = q.float()
    if by_key:
        d0, d1 = tp.span(c_state.shape[2])
        ki, qf = ki[..., d0:d1], qf[..., d0:d1]
    c_new = (c_state * f_g[..., None]
             + torch.einsum("bhd,bhe->bhde", ki, v).float())
    n_new = n_state * f_g + ki.float()
    h_num = torch.einsum("bhd,bhde->bhe", qf, c_new)
    n_dot_q = torch.einsum("bhd,bhd->bh", n_new, qf)
    if by_key:
        h_num, n_dot_q = (tp.reduce(t.contiguous()) for t in (h_num,
                                                              n_dot_q))
    denom = torch.clamp_min(n_dot_q.abs(), 1.0)
    h_out = (h_num / denom[..., None]).reshape(b, 1, -1).to(x.dtype)
    if tp is None or not (w_split or by_head):
        return torch.matmul(h_out * F.silu(z), params["down"]), c_new, n_new
    c0, c1 = tp.span(di // tp.size)
    if not by_head:
        h_out = h_out[..., c0:c1]
    down = params["down"]
    if not w_split:
        z, down = z[..., c0:c1], down[c0:c1]
    return tp.reduce(torch.matmul(h_out * F.silu(z), down)), c_new, n_new


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_specs(cfg: ModelConfig) -> PyTree:
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    p = int(d * cfg.xlstm_slstm_proj)
    dt = DTYPES[cfg.param_dtype]
    return {
        "w_in": ParamSpec((d, 4 * d), dt, logical_axes=("embed", None)),           # z, i, f, o inputs
        "r": ParamSpec((4, h, hd, hd), dt, init_scale=0.5),  # block-diag
        "bias": ParamSpec((4 * d,), torch.float32, init="zeros"),
        "up": ParamSpec((d, 2 * p), dt, logical_axes=("embed", "mlp")),
        "down": ParamSpec((p, d), dt, logical_axes=("mlp", "embed")),
    }


def _slstm_step(params: PyTree, cfg: ModelConfig, carry, x_t,
                span=None):
    """carry: (c, n, m, h) each (B,D) float32; x_t: W_in x (B,4D) float32.
    With ``span`` (c0, c1), c, n and m hold the channels [c0, c1) and h is
    whole: the step gives those channels' states (the recurrent product is
    taken whole, then cut)."""
    c, n, m, h = carry
    d = cfg.d_model
    hh = cfg.n_heads
    b = c.shape[0]
    hr = h.reshape(b, hh, d // hh)
    rec = torch.einsum("bhd,ghde->bghe", hr.to(params["r"].dtype),
                       params["r"]).reshape(b, 4 * d)
    pre = x_t + rec.float() + params["bias"]
    if span is not None:
        pre = pre.reshape(b, 4, d)[..., span[0]:span[1]].reshape(b, -1)
    z_pre, i_pre, f_pre, o_pre = pre.chunk(4, dim=-1)
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    log_i = softcap(i_pre, _IGATE_CAP)
    log_f = F.logsigmoid(f_pre)
    m_new = torch.maximum(log_f + m, log_i)
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(log_f + m - m_new)
    c_new = f_s * c + i_s * z
    n_new = f_s * n + i_s
    h_new = o * c_new / torch.clamp_min(n_new, 1e-6)
    return (c_new, n_new, m_new, h_new), h_new


def _slstm_out(params: PyTree, h: torch.Tensor, tp=None,
               width: int = 0) -> torch.Tensor:
    """The up/down projection of h; with ``tp`` and its ``width`` (the
    projection's) split over it, params hold this rank's slices: a
    split ``up`` (its fused (u, g) pair) and ``down`` give partial sums;
    a split ``up`` beside an unsplit ``down`` is read whole."""
    up, down = params["up"], params["down"]
    if tp is not None and tp.split(down.shape[0], width):
        u, g = tensor_parallel.own_channels(torch.matmul(tp.copy(h), up), tp)
        return tp.reduce(torch.matmul(u * F.gelu(g, approximate="tanh"),
                                      down))
    if tp is not None and tp.split(up.shape[-1], 2 * width):
        up = tp.full(up, -1)
    u, g = torch.matmul(h, up).chunk(2, dim=-1)
    return torch.matmul(u * F.gelu(g, approximate="tanh"), down)


def slstm_fwd(params: PyTree, x: torch.Tensor, cfg: ModelConfig,
              tp=None) -> torch.Tensor:
    """x (B,S,D) -> (B,S,D): a loop over time steps, then the up/down
    projection (GELU, tanh form: ``jax.nn.gelu``'s default).  With ``tp``
    (a ``parallel.tensor_parallel.ModelGroup``) params hold this rank's
    slices (see the module's note)."""
    b, s, d = x.shape
    x_in = torch.matmul(x, params["w_in"]).float()  # (B,S,4D)
    carry = tuple(x.new_zeros((b, d), dtype=torch.float32) for _ in range(4))
    hs = []
    for t in range(s):
        carry, h_t = _slstm_step(params, cfg, carry, x_in[:, t])
        hs.append(h_t)
    return _slstm_out(params, torch.stack(hs, dim=1).to(x.dtype), tp,
                      int(d * cfg.xlstm_slstm_proj))


def slstm_decode(params: PyTree, x: torch.Tensor, state, cfg: ModelConfig,
                 tp=None):
    """One-token sLSTM step; state = (c, n, m, h) each (B,D) float32.
    Returns (out (B,1,D), state), new tensors.

    On a mesh (``tp``) the states may hold this rank's channels of d over
    ``model`` (``cache_pspecs``), which may end inside a head: h is
    gathered, the rank steps its channels, and the new h is gathered again
    for the up/down projection (split on its width under ``megatron``)."""
    d = cfg.d_model
    x_in = torch.matmul(x[:, 0], params["w_in"]).float()
    if tp is None or not tp.split(state[0].shape[-1], d):
        state, h = _slstm_step(params, cfg, state, x_in)
    else:
        def gather(t):
            return collectives.all_gather_cat(t, tp.mesh, tp.dims, -1)

        c, n, m, h = state
        state, h = _slstm_step(params, cfg, (c, n, m, gather(h)), x_in,
                               span=tp.span(c.shape[-1]))
        h = gather(h)
    return _slstm_out(params, h[:, None, :].to(x.dtype), tp,
                      int(d * cfg.xlstm_slstm_proj)), state
