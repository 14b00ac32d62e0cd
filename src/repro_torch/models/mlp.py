"""Dense SwiGLU MLP (llama-family)."""
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


def mlp_fwd(params: PyTree, x: torch.Tensor) -> torch.Tensor:
    gate = torch.matmul(x, params["wi_gate"])
    up = torch.matmul(x, params["wi_up"])
    return torch.matmul(F.silu(gate) * up, params["wo"])
