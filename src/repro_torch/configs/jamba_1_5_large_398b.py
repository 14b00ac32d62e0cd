"""Jamba-1.5-Large (398B total / ~94B active)  [arXiv:2403.19887; hf].

Hybrid Mamba+attention 1:7 interleave (one attention layer per 8-layer block),
MoE (16 experts, top-2) every second layer.  72L, d=8192, 64H (GQA kv=8),
d_ff=24576, vocab=65536.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

_PERIOD = tuple(
    LayerSpec(mixer=("attn" if i == 3 else "mamba"),
              mlp=("moe" if i % 2 == 1 else "dense"))
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    pattern=_PERIOD,
    n_experts=16,
    top_k=2,
    moe_d_ff=24576,
    rope_theta=10000.0,
    ssm_state_dim=16,
    ssm_expand=2,
    ssm_chunk=256,
    # 398B params: bf16 optimizer moments + fsdp sharding over (pod,data) are
    # required to fit 16 GB/chip HBM (see EXPERIMENTS.md §Dry-run).
    fsdp=True,
    opt_state_dtype="bfloat16",
)
