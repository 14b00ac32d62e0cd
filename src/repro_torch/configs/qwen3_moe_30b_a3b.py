"""Qwen3-30B-A3B  [hf:Qwen/Qwen3-30B-A3B].

48L, d=2048, 32H (GQA kv=4), vocab=151936; MoE every layer: 128 experts,
top-8, expert hidden 768; qk-norm, head_dim=128.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    pattern=(LayerSpec(mixer="attn", mlp="moe"),),
    n_experts=128,
    top_k=8,
    moe_d_ff=768,
    rope_theta=1000000.0,
    qk_norm=True,
)
