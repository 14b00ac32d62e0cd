"""OLMoE-1B-7B-0924 as published  [arXiv:2409.02060;
huggingface.co/allenai/OLMoE-1B-7B-0924].

16L, d=2048, 16H (kv=16) of 128, vocab=50304, untied; MoE in every layer:
64 SwiGLU experts of width 1024, 8 a token, no shared expert.  What the
port's ``olmoe-1b-7b`` stand-in does otherwise, this one does as the
published model: dropless routing (every choice reaches its expert), the
router's softmax over all 64 experts with the top 8 not renormalised
(``norm_topk_prob: false``), and q_norm/k_norm over the whole q and k
projections; rms_norm_eps 1e-5.
"""
from repro_torch.configs.base import LayerSpec, PortModelConfig

CONFIG = PortModelConfig(
    name="olmoe-1b-7b-0924",
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
    norm_eps=1e-5,
    moe_dropless=True,
    router_renormalize=False,
    qk_norm_whole=True,
)
