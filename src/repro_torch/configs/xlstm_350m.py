"""xLSTM-350M  [arXiv:2405.04517].

24L, d=1024, 4 heads, vocab=50304, d_ff=0 (xLSTM blocks carry their own
projections).  7:1 mLSTM:sLSTM interleave per the paper's xLSTM[7:1] recipe.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

_PERIOD = tuple(
    LayerSpec(mixer=("slstm" if i == 7 else "mlstm"), mlp="none")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50304,
    pattern=_PERIOD,
    xlstm_mlstm_expand=2,
    ssm_chunk=128,
)
