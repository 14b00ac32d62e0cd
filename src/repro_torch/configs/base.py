"""Model / shape / mesh configuration dataclasses.

The port's own copy of the JAX package's configs (the same fields and
values).  Every assigned architecture is expressed as a :class:`ModelConfig`;
the unified model in ``repro_torch.models.lm`` consumes these directly.  Fields
that only the JAX package's sharding, remat and dry-run tooling reads are kept
so that a config means the same thing in both packages.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class LayerSpec:
    """One position inside the repeating block pattern.

    mixer: "attn" | "mamba" | "mlstm" | "slstm"
    mlp:   "dense" | "moe" | "none"
    """

    mixer: str = "attn"
    mlp: str = "dense"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- repeating layer pattern (len(pattern) divides n_layers) ---
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0  # per-expert hidden size (0 -> d_ff)
    capacity_factor: float = 1.25
    moe_group_size: int = 256  # tokens per dispatch group (GShard-style)
    router_aux_weight: float = 0.01

    # --- attention ---
    rope_theta: float = 10000.0
    qk_norm: bool = False
    sliding_window: int = 0  # 0 = full attention
    mrope_sections: Tuple[int, int, int] = ()  # M-RoPE (qwen2-vl); empty = off
    attn_block_q: int = 512  # blocked-attention tile sizes (XLA path)
    attn_block_k: int = 512

    # --- encoder-decoder (seamless) ---
    encoder_decoder: bool = False
    n_encoder_layers: int = 0

    # --- SSM (mamba) ---
    ssm_state_dim: int = 16
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_dt_rank: int = 0  # 0 -> ceil(d_model / 16)

    # --- xLSTM ---
    xlstm_mlstm_expand: int = 2
    xlstm_slstm_proj: float = 4.0 / 3.0

    # --- modality frontend stubs ---
    vision_tokens: int = 0  # qwen2-vl: number of precomputed patch embeddings
    vision_grid: Tuple[int, int] = (16, 16)
    audio_frontend: bool = False  # seamless: encoder input = frame embeddings

    # --- numerics / training ---
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    tie_embeddings: bool = False
    vocab_pad_multiple: int = 256
    remat: str = "full"  # none | full (per-block rematerialisation)
    opt_state_dtype: str = "float32"
    fsdp: bool = False  # additionally shard params/opt-state over data axis
    # parallelism strategy (see parallel/sharding.py):
    #   megatron: TP over 'model' (baseline);
    #   pure_dp:  batch over (data x model), weights replicated, ZeRO-1 opt;
    #   seq_dp:   batch over data + sequence over 'model', weights replicated
    shard_strategy: str = "megatron"
    unroll_layers: bool = False  # validation: Python-loop layers (no scan)
    decode_cache_update: str = "masked"  # masked (ring where) | dus
    # two-tier decode cache: >0 = frozen main cache + ring of this many recent
    # tokens; per-step writes touch only the ring (decode hillclimb, §Perf)
    decode_ring: int = 0
    logit_softcap: float = 0.0

    # ---- derived ----
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_multiple)

    @property
    def n_repeats(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"pattern period {len(self.pattern)}")
        return self.n_layers // len(self.pattern)

    @property
    def d_inner(self) -> int:  # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or max(1, math.ceil(self.d_model / 16))

    @property
    def mlstm_inner(self) -> int:
        return self.xlstm_mlstm_expand * self.d_model

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, hd = self.d_model, self.resolved_head_dim
        qd, kvd = self.n_heads * hd, self.n_kv_heads * hd
        total = self.padded_vocab * d  # embedding
        if not self.tie_embeddings:
            total += self.padded_vocab * d  # unembed

        def attn_params() -> int:
            return d * qd + 2 * d * kvd + qd * d

        def dense_mlp(dff: int) -> int:
            return 3 * d * dff

        def moe_mlp() -> int:
            dff = self.moe_d_ff or self.d_ff
            return self.n_experts * 3 * d * dff + d * self.n_experts

        def mamba_params() -> int:
            di, n, dtr = self.d_inner, self.ssm_state_dim, self.dt_rank
            return (d * 2 * di + di * self.ssm_conv_width
                    + di * (dtr + 2 * n) + dtr * di + di * n + di + di * d)

        def mlstm_params() -> int:
            di = self.mlstm_inner
            return (d * 2 * di + 3 * di * di // max(self.n_heads, 1) * 0
                    + 3 * di * di + di * d + 3 * di)

        def slstm_params() -> int:
            # block-diagonal (per-head) recurrent + input projections, 4 gates
            di = self.d_model
            hd_s = di // max(self.n_heads, 1)
            rec = 4 * self.n_heads * hd_s * hd_s
            inp = 4 * di * di
            up = int(di * di * self.xlstm_slstm_proj) * 2
            return rec + inp + up

        def layer_params(spec: LayerSpec) -> int:
            t = 0
            if spec.mixer == "attn":
                t += attn_params()
            elif spec.mixer == "mamba":
                t += mamba_params()
            elif spec.mixer == "mlstm":
                t += mlstm_params()
            elif spec.mixer == "slstm":
                t += slstm_params()
            if spec.mlp == "dense":
                t += dense_mlp(self.d_ff)
            elif spec.mlp == "moe":
                t += moe_mlp()
            t += 2 * d  # norms
            return t

        for spec in self.pattern:
            total += self.n_repeats * layer_params(spec)
        if self.encoder_decoder:
            enc = self.n_encoder_layers * (attn_params() + dense_mlp(self.d_ff) + 2 * d)
            cross = self.n_layers * attn_params()  # cross-attention in decoder
            total += enc + cross
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        dff = self.moe_d_ff or self.d_ff
        moe_layers = self.n_repeats * sum(1 for s in self.pattern if s.mlp == "moe")
        inactive = moe_layers * (self.n_experts - self.top_k) * 3 * self.d_model * dff
        return self.param_count() - inactive

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        period = len(self.pattern)
        hd = min(self.resolved_head_dim, 32)
        n_heads = min(self.n_heads, 4)
        n_kv = min(self.n_kv_heads, n_heads)
        updates = dict(
            name=self.name + "-smoke",
            n_layers=2 * period,
            d_model=64,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=hd,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab_size=512,
            moe_d_ff=64 if self.n_experts else 0,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.n_experts else 0,
            moe_group_size=32,
            n_encoder_layers=2 if self.encoder_decoder else 0,
            vision_tokens=16 if self.vision_tokens else 0,
            vision_grid=(4, 4) if self.vision_tokens else (16, 16),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            attn_block_q=32,
            attn_block_k=32,
            ssm_chunk=16,
            ssm_dt_rank=8,
            vocab_pad_multiple=16,
            mrope_sections=(8, 4, 4) if self.mrope_sections else (),
            dtype="float32",
            param_dtype="float32",
            opt_state_dtype="float32",
            remat="none",
        )
        return replace(self, **updates)


@dataclass(frozen=True)
class PortModelConfig(ModelConfig):
    """A configuration that only the port runs: :class:`ModelConfig`'s
    fields, which stay field for field the JAX package's, and three
    switches it lacks.  Each default is what a plain :class:`ModelConfig`
    does, and the layers read a switch through :func:`port_option`, so a
    plain config behaves as before."""

    #: route every (token, choice) to its expert: the choices sorted by
    #: expert, grouped products over the experts' jagged row counts, no
    #: capacity and nothing dropped (``models.moe``); False: GShard
    #: dispatch in groups with ``capacity_factor``
    moe_dropless: bool = False
    #: the top-k router weights renormalised to sum to one (a softmax over
    #: the top k logits); False: the softmax over all experts, of which
    #: the top k are taken as they are
    router_renormalize: bool = True
    #: ``q_norm``/``k_norm`` over the whole projection (n_heads x head_dim)
    #: before the split into heads; False: over each head's head_dim
    qk_norm_whole: bool = False


def port_option(cfg: ModelConfig, name: str):
    """``cfg``'s port-only switch ``name`` (a field of
    :class:`PortModelConfig`), or its default for a plain
    :class:`ModelConfig`."""
    return getattr(cfg, name,
                   PortModelConfig.__dataclass_fields__[name].default)


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (assignment: 4 per architecture)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}

# Architectures with sub-quadratic sequence mixing (SSM / hybrid / SWA) run
# long_500k; pure full-attention archs skip it.
SUBQUADRATIC_ARCHS = frozenset({"jamba-1.5-large-398b", "xlstm-350m", "h2o-danube-3-4b"})


def cell_is_runnable(arch: str, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return arch in SUBQUADRATIC_ARCHS
    return True
