"""Analytic op-level cost model per (arch x shape): FLOPs and first-order
HBM bytes, the JAX package's ``launch/analytic.py`` with its import
rewritten and its behaviour unchanged.

It enumerates every matmul of the model (the einsums the code executes),
so the compute term is exact; bytes use the one-pass GEMM model (read the
operands, write the result; x4 for a train step's forward, backward and
remat), plus parameter, optimizer-state and KV-cache traffic.  Decode
counts the whole cache read once a step and, per step, the cache rewrite
of the masked update or, under ``decode_ring``, only the ring's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.configs.base import LayerSpec, ModelConfig, ShapeConfig


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, o: "Cost") -> "Cost":
        return Cost(self.flops + o.flops, self.bytes + o.bytes)

    def __mul__(self, k: float) -> "Cost":
        return Cost(self.flops * k, self.bytes * k)

    __rmul__ = __mul__


def _gemm(m: float, k: float, n: float, dt: int = 2) -> Cost:
    """C[m,n] = A[m,k] @ B[k,n]: 2mkn flops; read A,B write C."""
    return Cost(2.0 * m * k * n, dt * (m * k + k * n + m * n))


def _ew(elems: float, flops_per: float = 1.0, dt: int = 2) -> Cost:
    return Cost(flops_per * elems, 2 * dt * elems)


def _attention(cfg: ModelConfig, tokens: float, s_kv_eff: float,
               cross_kv_tokens: float = 0.0) -> Cost:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    qd, kvd = cfg.n_heads * hd, cfg.n_kv_heads * hd
    c = _gemm(tokens, d, qd)                      # q proj
    kv_tokens = cross_kv_tokens or tokens
    c += _gemm(kv_tokens, d, kvd) * 2             # k, v proj
    c += _gemm(tokens, qd, d)                     # out proj
    # scores + pv: per token 2*s_kv*H*hd each
    c += Cost(4.0 * tokens * s_kv_eff * qd,
              2 * 2 * tokens * s_kv_eff * cfg.n_heads)  # score tensor rw (bf16-ish)
    if cfg.qk_norm:
        c += _ew(tokens * qd, 6) + _ew(kv_tokens * kvd, 6)
    return c


def _dense_mlp(cfg: ModelConfig, tokens: float) -> Cost:
    d, f = cfg.d_model, cfg.d_ff
    return _gemm(tokens, d, f) * 2 + _gemm(tokens, f, d) + _ew(tokens * f, 4)


def _moe(cfg: ModelConfig, tokens: float) -> Cost:
    d = cfg.d_model
    f = cfg.moe_d_ff or cfg.d_ff
    e, k = cfg.n_experts, cfg.top_k
    gt = cfg.moe_group_size
    cap_per_tok = (gt if gt <= 64 else gt * k * cfg.capacity_factor / e) * e / gt
    c = _gemm(tokens, d, e)                                    # router
    c += Cost(4.0 * tokens * cap_per_tok * d, 0)               # dispatch+combine
    c += (_gemm(tokens * k, d, f) * 2 + _gemm(tokens * k, f, d))  # experts
    # expert weights traffic: each expert's weights stream once per group set
    c += Cost(0, 3 * e * d * f * 2)
    c += _ew(tokens * k * f, 4)
    return c


def _mamba(cfg: ModelConfig, tokens: float) -> Cost:
    d, di, n, r = cfg.d_model, cfg.d_inner, cfg.ssm_state_dim, cfg.dt_rank
    w = cfg.ssm_conv_width
    c = _gemm(tokens, d, 2 * di)                 # in_proj
    c += _ew(tokens * di, 2 * w)                 # causal conv
    c += _gemm(tokens, di, r + 2 * n)            # x_proj
    c += _gemm(tokens, r, di)                    # dt_proj
    levels = max(1, math.ceil(math.log2(max(cfg.ssm_chunk, 2))))
    c += Cost(3.0 * tokens * di * n * levels,
              4 * 4 * tokens * di * n)           # assoc scan (f32 state)
    c += Cost(2.0 * tokens * di * n, 4 * tokens * di * n)  # y = C.h
    c += _ew(tokens * di, 6)                     # D skip + gate
    c += _gemm(tokens, di, d)                    # out_proj
    return c


def _mlstm(cfg: ModelConfig, tokens: float) -> Cost:
    d, di = cfg.d_model, cfg.mlstm_inner
    h = cfg.n_heads
    hd = di // h
    tc = min(cfg.ssm_chunk, 128)
    c = _gemm(tokens, d, 2 * di)
    c += _gemm(tokens, di, di) * 3               # q,k,v
    c += _gemm(tokens, di, 2 * h)                # gates
    # intra-chunk quadratic: scores, h_intra, n_intra ~ 6*Tc*di per token
    c += Cost(6.0 * tokens * tc * di, 4 * tokens * tc * h)
    # inter-chunk: q@C and state update ~ 4*di*hd per token
    c += Cost(4.0 * tokens * di * hd, 4 * tokens * di / tc * hd * 2)
    c += _gemm(tokens, di, d)
    return c


def _slstm(cfg: ModelConfig, tokens: float) -> Cost:
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    p = int(d * cfg.xlstm_slstm_proj)
    c = _gemm(tokens, d, 4 * d)                  # input proj
    c += Cost(2.0 * tokens * 4 * d * hd, 4 * 4 * tokens * d)  # recurrent (seq)
    c += _ew(tokens * 4 * d, 8, dt=4)
    c += _gemm(tokens, d, 2 * p) + _gemm(tokens, p, d)
    return c


def _layer(cfg: ModelConfig, spec: LayerSpec, tokens: float, s_kv: float,
           cross_kv: float = 0.0) -> Cost:
    c = _ew(tokens * cfg.d_model, 6, dt=2)  # norms + residuals
    if spec.mixer == "attn":
        c += _attention(cfg, tokens, s_kv)
    elif spec.mixer == "mamba":
        c += _mamba(cfg, tokens)
    elif spec.mixer == "mlstm":
        c += _mlstm(cfg, tokens)
    elif spec.mixer == "slstm":
        c += _slstm(cfg, tokens)
    if cross_kv:
        c += _attention(cfg, tokens, cross_kv, cross_kv_tokens=cross_kv)
    if spec.mlp == "dense":
        c += _dense_mlp(cfg, tokens)
    elif spec.mlp == "moe":
        c += _moe(cfg, tokens)
    return c


def keys_per_query(skv: float, causal: bool = True, window=0) -> float:
    """The keys the model counts for each query over ``skv`` keys: half of
    them (plus one half) when causal, all otherwise, at most ``window``."""
    eff = (skv + 1) / 2 if causal else skv
    if window:
        eff = min(eff, window)
    return eff


def attention_pairs(s: float, skv: float, causal: bool = True,
                    window=0) -> float:
    """(query, key) pairs of one (batch, head) as the model counts them:
    ``s`` queries times :func:`keys_per_query`.  A kernel's work on q
    (B, S, H, hd) is ``4 * B * H * hd * attention_pairs(S, Skv, ...)``
    flops, the scores and P.V terms of :func:`_attention`."""
    return s * keys_per_query(skv, causal, window)


def _s_kv_eff(cfg: ModelConfig, s: float, causal: bool = True) -> float:
    return keys_per_query(s, causal, cfg.sliding_window)


def forward_cost(cfg: ModelConfig, batch: int, seq: int) -> Cost:
    tokens = float(batch * seq)
    if cfg.encoder_decoder:
        enc_tok = dec_tok = tokens / 2  # 50/50 split (DESIGN.md §6)
        enc_seq = dec_seq = seq / 2
        c = Cost()
        enc_spec = LayerSpec("attn", "dense")
        c += cfg.n_encoder_layers * _layer(
            cfg, enc_spec, enc_tok, _s_kv_eff(cfg, enc_seq, causal=False))
        for spec in cfg.pattern:
            c += cfg.n_repeats * _layer(cfg, spec, dec_tok,
                                        _s_kv_eff(cfg, dec_seq),
                                        cross_kv=enc_seq)
        c += _gemm(dec_tok, cfg.d_model, cfg.padded_vocab)  # unembed
        return c
    c = Cost(0, tokens * cfg.d_model * 2)  # embedding gather traffic
    s_kv = _s_kv_eff(cfg, seq)
    for spec in cfg.pattern:
        c += cfg.n_repeats * _layer(cfg, spec, tokens, s_kv)
    c += _gemm(tokens, cfg.d_model, cfg.padded_vocab)
    return c


def _param_bytes(cfg: ModelConfig) -> float:
    return cfg.param_count() * 2.0  # bf16


def train_cost(cfg: ModelConfig, shape: ShapeConfig) -> Cost:
    fwd = forward_cost(cfg, shape.global_batch, shape.seq_len)
    mult = 3.0 + (1.0 if cfg.remat == "full" else 0.0)  # fwd+bwd(2x)+remat
    c = Cost(fwd.flops * mult, fwd.bytes * mult)
    p = _param_bytes(cfg)
    opt_b = 2.0 if cfg.opt_state_dtype == "bfloat16" else 4.0
    # grads write+read, two moments read+write, params read(+w in fwd counted)
    c += Cost(2.0 * cfg.param_count(), p * 2 + 2 * p / 2 * opt_b * 2 + p)
    return c


def prefill_cost(cfg: ModelConfig, shape: ShapeConfig) -> Cost:
    return forward_cost(cfg, shape.global_batch, shape.seq_len)


def decode_cost(cfg: ModelConfig, shape: ShapeConfig) -> Cost:
    b = float(shape.global_batch)
    s = float(shape.seq_len)
    hd = cfg.resolved_head_dim
    c = Cost()
    if cfg.encoder_decoder:
        s = s / 2  # self cache + cross cache, each seq/2
    for spec in cfg.pattern:
        tokens = b  # one token per sequence
        cc = _ew(tokens * cfg.d_model, 6)
        if spec.mixer == "attn":
            cc += _attention(cfg, tokens, 1.0)  # projections (s_kv 1: proj only)
            s_eff = min(s, cfg.sliding_window) if cfg.sliding_window else s
            cache_tensor = b * s * cfg.n_kv_heads * hd * 2  # bytes, one of k/v
            # K and V each read once for scores / pv
            cc += Cost(4.0 * tokens * s_eff * cfg.n_heads * hd,
                       2.0 * cache_tensor)
            if cfg.decode_ring:
                # two-tier: per-step writes touch only the ring (§Perf decode)
                ring_tensor = b * cfg.decode_ring * cfg.n_kv_heads * hd * 2
                cc += Cost(0, 2.0 * 2.0 * ring_tensor)
            else:
                # masked ring-buffer update rewrites both cache tensors
                cc += Cost(0, 2.0 * 2.0 * cache_tensor)
        elif spec.mixer == "mamba":
            cc += _mamba(cfg, tokens)
            cc += Cost(0, b * cfg.d_inner * cfg.ssm_state_dim * 4 * 2)
        elif spec.mixer == "mlstm":
            cc += _mlstm(cfg, tokens)
            h = cfg.n_heads
            hdm = cfg.mlstm_inner // h
            cc += Cost(0, b * h * hdm * hdm * 4 * 2)
        elif spec.mixer == "slstm":
            cc += _slstm(cfg, tokens)
        if cfg.encoder_decoder:
            cc += _attention(cfg, tokens, s, cross_kv_tokens=0.0001)
            cc += Cost(0, 2.0 * b * s * cfg.n_kv_heads * hd * 2 * 2)
        if spec.mlp == "dense":
            cc += _dense_mlp(cfg, tokens)
        elif spec.mlp == "moe":
            cc += _moe(cfg, tokens)
        c += cfg.n_repeats * cc
    c += _gemm(b, cfg.d_model, cfg.padded_vocab)
    # every (active-ish) weight is read once per step regardless of batch
    c += Cost(0, _param_bytes(cfg))
    return c


def cell_cost(cfg: ModelConfig, shape: ShapeConfig) -> Cost:
    if shape.kind == "train":
        return train_cost(cfg, shape)
    if shape.kind == "prefill":
        return prefill_cost(cfg, shape)
    return decode_cost(cfg, shape)
