"""Config registry: ``get_config(name)`` / ``list_archs()``.

One module per assigned architecture (exact published config) plus the paper's
own TASTI embedder backbone.  Smoke variants via ``get_config(name).smoke()``.
The registry also holds configurations that only the port runs (a
``PortModelConfig``, such as ``olmoe-1b-7b-0924``), which are not among the
assigned architectures that the dry-run tables and parity tests walk.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import (SHAPE_BY_NAME, SHAPES, LayerSpec, ModelConfig,
                                PortModelConfig, ShapeConfig, cell_is_runnable)
from repro_torch.configs.h2o_danube3_4b import CONFIG as _danube
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as _jamba
from repro_torch.configs.llama3_2_1b import CONFIG as _llama
from repro_torch.configs.olmoe_1b_7b import CONFIG as _olmoe
from repro_torch.configs.olmoe_1b_7b_0924 import CONFIG as _olmoe_0924
from repro_torch.configs.phi3_medium_14b import CONFIG as _phi3
from repro_torch.configs.qwen2_vl_7b import CONFIG as _qwen2vl
from repro_torch.configs.qwen3_1_7b import CONFIG as _qwen3
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as _qwen3moe
from repro_torch.configs.seamless_m4t_large_v2 import CONFIG as _seamless
from repro_torch.configs.tasti_embedder import CONFIG as _tasti_embedder
from repro_torch.configs.xlstm_350m import CONFIG as _xlstm

_REGISTRY: Dict[str, ModelConfig] = {c.name: c for c in [
    _jamba, _llama, _phi3, _qwen3, _danube, _qwen2vl, _xlstm, _seamless,
    _olmoe, _qwen3moe, _tasti_embedder, _olmoe_0924,
]}

ASSIGNED_ARCHS: List[str] = [
    "jamba-1.5-large-398b", "llama3.2-1b", "phi3-medium-14b", "qwen3-1.7b",
    "h2o-danube-3-4b", "qwen2-vl-7b", "xlstm-350m", "seamless-m4t-large-v2",
    "olmoe-1b-7b", "qwen3-moe-30b-a3b",
]


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> List[str]:
    return list(ASSIGNED_ARCHS)


__all__ = ["get_config", "list_archs", "ASSIGNED_ARCHS", "SHAPES",
           "SHAPE_BY_NAME", "ModelConfig", "PortModelConfig", "ShapeConfig",
           "LayerSpec", "cell_is_runnable"]
