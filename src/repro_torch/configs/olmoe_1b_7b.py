"""OLMoE-1B-7B's sizes as the JAX package runs them  [arXiv:2409.02060].

16L, d=2048, 16H (kv=16), vocab=50304; MoE every layer: 64 experts, top-8,
expert hidden 1024 (the listed d_ff is the per-expert width).

This is the JAX package's stand-in, not the published model: GShard
dispatch in groups with a capacity factor (a choice past its expert's
capacity is dropped), the top 8 renormalised (a softmax over the top 8
logits), q_norm/k_norm over each head, and norm_eps 1e-6.  The parity
tests hold the port to the JAX package on it.  The published model, which
routes every choice and keeps the weights of the softmax over all 64
experts, is ``olmoe-1b-7b-0924`` (``configs/olmoe_1b_7b_0924.py``).
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
