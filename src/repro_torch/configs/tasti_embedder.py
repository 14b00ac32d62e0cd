"""The paper's embedding DNN as a transformer backbone.

Stands in for ResNet-18 / BERT (paper §6.1): a small transformer encoder over
record features; ``repro_torch.core.embedder`` adds the projection head (embedding
size 128, paper default).  Runs at ~4000x fewer FLOPs per record than the
jamba-as-target-DNN, mirroring the paper's 3 fps vs 12,000 fps cost ratio.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tasti-embedder",
    family="dense",
    n_layers=4,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    head_dim=64,
    d_ff=1024,
    vocab_size=512,   # unused for continuous records; kept for LM pretraining
    rope_theta=10000.0,
    attn_block_q=128,
    attn_block_k=128,
    dtype="float32",
    param_dtype="float32",
    remat="none",
)
