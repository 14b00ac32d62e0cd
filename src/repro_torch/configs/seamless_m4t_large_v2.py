"""SeamlessM4T-large-v2 backbone  [arXiv:2308.11596; hf].

Encoder-decoder, 24L each, d=1024, 16H (kv=16), d_ff=8192, vocab=256206.
Audio frontend is a stub per the assignment: the encoder consumes precomputed
frame embeddings.  Context shapes split enc/dec 50/50.
vocab 256206 is padded to 256256 (multiple of 256) for TP divisibility.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    encoder_decoder=True,
    n_encoder_layers=24,
    audio_frontend=True,
    rope_theta=10000.0,
)
