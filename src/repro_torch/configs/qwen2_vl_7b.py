"""Qwen2-VL-7B backbone  [arXiv:2409.12191; hf].

28L, d=3584, 28H (GQA kv=4), d_ff=18944, vocab=152064, M-RoPE.  The vision
frontend is a stub per the assignment: ``input_specs`` provides 256 precomputed
patch embeddings on a 16x16 grid, merged into the first sequence positions.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    rope_theta=1000000.0,
    mrope_sections=(16, 24, 24),  # half-dim units, sum = head_dim//2
    vision_tokens=256,
    vision_grid=(16, 16),
)
