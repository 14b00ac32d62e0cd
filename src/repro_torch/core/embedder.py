"""Embedding DNN: record features -> semantic embeddings.

The ``mlp`` backbone (the paper-scale reproduction's embedder; it stands in
for the ResNet-18 / BERT embedders — the paper's point is that the embedder
is orders of magnitude cheaper than the target DNN, not its architecture) as
an :class:`torch.nn.Module`.  Widths follow :class:`EmbedderConfig`
(64 -> 256 -> 256 -> 128 by default), with tanh-form GELU between layers as
``jax.nn.gelu`` computes by default.

The transformer backbones wait for the port of ``flash_attention`` and the
LM stack.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class EmbedderConfig:
    feature_dim: int = 64
    embed_dim: int = 128          # paper default embedding size
    hidden: int = 256
    n_layers: int = 3
    backbone: str = "mlp"         # only "mlp" is ported
    seq_tokens: int = 8           # transformer path: reshape features to tokens
    normalize: bool = False


class Embedder(nn.Module):
    """x (N, feature_dim) -> (N, embed_dim).  Weights are drawn like the
    JAX package's ``init_params`` (normal / sqrt(fan_in), zero biases) from
    ``generator``; :func:`params_from_jax` carries JAX weights across."""

    def __init__(self, cfg: EmbedderConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.backbone != "mlp":
            raise NotImplementedError(
                f"backbone {cfg.backbone!r}: the transformer embedder waits "
                "for the port of flash_attention and the LM stack")
        self.cfg = cfg
        dims = ([cfg.feature_dim] + [cfg.hidden] * (cfg.n_layers - 1)
                + [cfg.embed_dim])
        self.layers = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1]) for i in range(len(dims) - 1))
        with torch.no_grad():
            for lin in self.layers:
                fan_in = lin.in_features
                lin.weight.copy_(torch.randn(lin.weight.shape,
                                             generator=generator)
                                 / np.sqrt(max(fan_in, 1)))
                lin.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i, lin in enumerate(self.layers):
            h = lin(h)
            if i < len(self.layers) - 1:
                h = F.gelu(h, approximate="tanh")
        if self.cfg.normalize:
            h = h / torch.clamp_min(torch.linalg.norm(h, dim=-1, keepdim=True),
                                    1e-6)
        return h


def params_from_jax(params: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX package's MLP pytree ``{"w{i}": (in, out), "b{i}": (out,)}``
    as an :class:`Embedder` state dict (weights transposed to
    ``nn.Linear``'s (out, in))."""
    n = sum(1 for k in params if k.startswith("w"))
    state = {}
    for i in range(n):
        w = np.asarray(params[f"w{i}"], np.float32)
        state[f"layers.{i}.weight"] = torch.from_numpy(np.ascontiguousarray(w.T))
        state[f"layers.{i}.bias"] = torch.from_numpy(
            np.asarray(params[f"b{i}"], np.float32).copy())
    return state


@torch.no_grad()
def embed_all(model: Embedder, features: np.ndarray,
              batch: int = 4096) -> np.ndarray:
    """Embed every record in batches on the model's device (the N*c_E term
    of the paper's cost model); the features go up once, the embeddings come
    back once."""
    dev = next(model.parameters()).device
    x = torch.as_tensor(np.asarray(features, np.float32), device=dev)
    outs = [model(x[i:i + batch]) for i in range(0, len(x), batch)]
    if not outs:
        return np.zeros((0, model.cfg.embed_dim), np.float32)
    return torch.cat(outs).cpu().numpy()
