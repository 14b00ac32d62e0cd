"""Embedding DNN: record features -> semantic embeddings.

Two backbones, as in the JAX package:

* ``mlp`` (the paper-scale reproduction's embedder; it stands in for the
  ResNet-18 / BERT embedders -- the paper's point is that the embedder is
  orders of magnitude cheaper than the target DNN, not its architecture):
  widths from :class:`EmbedderConfig` (64 -> 256 -> 256 -> 128 by default),
  tanh-form GELU between layers as ``jax.nn.gelu`` computes by default;
* a registered transformer config (``backbone="tasti-embedder"``): features
  are split into ``seq_tokens`` tokens, projected to d_model, run through
  the backbone blocks bidirectionally without RoPE (attention through the
  ``flash_attention`` kernel), mean-pooled, and projected to the embedding
  size.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs import get_config
from repro_torch.models import blocks as blocks_lib
from repro_torch.models.common import (ParamSpec, ParamTree, PyTree,
                                       init_params, stack_specs, take_layer)
from repro_torch.models.common import params_from_jax as tree_from_jax
from repro_torch.obs import trace


@dataclass(frozen=True)
class EmbedderConfig:
    feature_dim: int = 64
    embed_dim: int = 128          # paper default embedding size
    hidden: int = 256
    n_layers: int = 3
    backbone: str = "mlp"         # "mlp" | config name from repro_torch.configs
    seq_tokens: int = 8           # transformer path: reshape features to tokens
    normalize: bool = False


def transformer_specs(cfg: EmbedderConfig) -> PyTree:
    """The transformer backbone's parameter specs, as
    ``repro.core.embedder.embedder_specs`` lays them out."""
    bb = get_config(cfg.backbone)
    if cfg.feature_dim % cfg.seq_tokens:
        raise ValueError(f"feature_dim {cfg.feature_dim} is not a multiple "
                         f"of seq_tokens {cfg.seq_tokens}")
    tok_dim = cfg.feature_dim // cfg.seq_tokens
    return {
        "proj_in": ParamSpec((tok_dim, bb.d_model), torch.float32,
                             logical_axes=("embed", "mlp")),
        "blocks": tuple(stack_specs(t, bb.n_repeats)
                        for t in blocks_lib.block_specs(bb)),
        "proj_out": ParamSpec((bb.d_model, cfg.embed_dim), torch.float32,
                              logical_axes=("embed", "mlp")),
    }


class Embedder(nn.Module):
    """x (N, feature_dim) -> (N, embed_dim).  Weights are drawn like the
    JAX package's ``init_params`` (normal / sqrt(fan_in), zero biases and
    unit norm scales) from ``generator``; :func:`params_from_jax` carries
    JAX weights across."""

    def __init__(self, cfg: EmbedderConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        if cfg.backbone != "mlp":
            self.backbone = get_config(cfg.backbone)
            self.params = ParamTree(init_params(transformer_specs(cfg),
                                                generator, device="cpu"))
            return
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

    def forward(self, x: torch.Tensor,
                attn_impl: str = "kernel") -> torch.Tensor:
        """``attn_impl`` ("kernel" or "plain", transformer backbones only)
        picks the attention route (``repro_torch.models.attention``)."""
        if self.cfg.backbone == "mlp":
            h = x
            for i, lin in enumerate(self.layers):
                h = lin(h)
                if i < len(self.layers) - 1:
                    h = F.gelu(h, approximate="tanh")
        else:
            p = self.params.tree()
            tok = x.reshape(x.shape[0], self.cfg.seq_tokens, -1)
            h = torch.matmul(tok, p["proj_in"])
            for i in range(self.backbone.n_repeats):
                h, _ = blocks_lib.block_fwd(take_layer(p["blocks"], i), h,
                                            self.backbone, angles=None,
                                            causal=False,
                                            attn_impl=attn_impl)
            h = torch.matmul(h.mean(dim=1), p["proj_out"])
        if self.cfg.normalize:
            h = h / torch.clamp_min(torch.linalg.norm(h, dim=-1, keepdim=True),
                                    1e-6)
        return h


def params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's embedder pytree as an :class:`Embedder` state dict:
    for the MLP ``{"w{i}": (in, out), "b{i}": (out,)}`` with the weights
    transposed to ``nn.Linear``'s (out, in); for a transformer backbone the
    same tree, leaf for leaf, under ``params.<path>``."""
    if "proj_in" in params:
        tree = ParamTree(tree_from_jax(params))
        return {f"params.{k}": v for k, v in tree.state_dict().items()}
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
    with trace.span("tasti.embed", records=len(features)):
        x = torch.as_tensor(np.asarray(features, np.float32), device=dev)
        trace.count("h2d_bytes", x.nbytes)
        outs = [model(x[i:i + batch]) for i in range(0, len(x), batch)]
        if not outs:
            return np.zeros((0, model.cfg.embed_dim), np.float32)
        out = torch.cat(outs).cpu().numpy()
        trace.count("d2h_bytes", out.nbytes)
    return out
