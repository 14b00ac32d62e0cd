"""OLMoE-1B-7B  [arXiv:2409.02060; hf].

16L, d=2048, 16H (kv=16), vocab=50304; MoE every layer: 64 experts, top-8,
expert hidden 1024 (the listed d_ff is the per-expert width).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    pattern=(LayerSpec(mixer="attn", mlp="moe"),),
    n_experts=64,
    top_k=8,
    moe_d_ff=1024,
    rope_theta=10000.0,
    qk_norm=True,
)
