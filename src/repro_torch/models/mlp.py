"""Dense SwiGLU MLP (llama-family).  On a mesh under ``megatron``,
``wi_gate``/``wi_up`` split on their columns and ``wo`` on its rows over
``model``: each rank's partial product is summed over the group."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import DTYPES, ParamSpec, PyTree


def mlp_specs(cfg: ModelConfig) -> PyTree:
    d, f = cfg.d_model, cfg.d_ff
    dt = DTYPES[cfg.param_dtype]
    return {
        "wi_gate": ParamSpec((d, f), dt, logical_axes=("embed", "mlp")),
        "wi_up": ParamSpec((d, f), dt, logical_axes=("embed", "mlp")),
        "wo": ParamSpec((f, d), dt, logical_axes=("mlp", "embed")),
    }


def mlp_fwd(params: PyTree, x: torch.Tensor, tp=None,
            d_ff: int = 0) -> torch.Tensor:
    """x (B,S,D) -> (B,S,D).  With ``tp`` (a
    ``parallel.tensor_parallel.ModelGroup``) and the hidden width
    ``d_ff`` split over it, params hold this rank's slices."""
    split = tp is not None and tp.split(params["wi_gate"].shape[-1], d_ff)
    if split:
        x = tp.copy(x)
    gate = torch.matmul(x, params["wi_gate"])
    up = torch.matmul(x, params["wi_up"])
    out = torch.matmul(F.silu(gate) * up, params["wo"])
    return tp.reduce(out) if split else out
