"""Baselines the paper compares against (§6.1):

* ``train_query_proxy``: BlazeIt/NoScope-style *per-query* proxy model — a
  small MLP trained on ``budget`` target-DNN-annotated records with an ad-hoc
  per-query loss (regression for counts, logistic for predicates).  This is
  the "TMAS + tiny ResNet" pipeline; its cost model charges the same
  target-DNN invocations the paper charges BlazeIt.
* TASTI-PT: the pre-trained-embedder variant — an embedder trained with a
  generic self-supervised objective (feature reconstruction), *not* the
  induced-schema triplet loss.  Built here so both TASTI variants share code.

Initial weights are drawn from ``torch.Generator`` s seeded as the JAX
package seeds its keys (encoder ``seed``, decoder ``seed + 1``, proxy
``cfg.seed``); the streams differ between frameworks, so each function also
takes initial weights, and :func:`proxy_from_jax` and
:func:`decoder_from_jax` carry the JAX package's across.  Mini-batches come
from numpy's ``default_rng`` exactly as there.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.embedder import Embedder, EmbedderConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim.adamw import OptimizerConfig, minimize


def _normal(shape, generator: Optional[torch.Generator]) -> torch.Tensor:
    """normal / sqrt(fan_in), fan_in = shape[-2] (``init_params``' rule)."""
    return torch.randn(shape, generator=generator) / np.sqrt(max(shape[-2], 1))


# ---------------------------------------------------------------------------
# Per-query proxy model (BlazeIt-style)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ProxyConfig:
    feature_dim: int = 64
    hidden: int = 32  # speed-class parity with the paper's tiny per-query proxies
    steps: int = 300
    lr: float = 3e-3
    batch: int = 128
    classify: bool = False
    seed: int = 0


class ProxyMLP(nn.Module):
    """feature_dim -> hidden -> hidden -> 1, tanh-form GELU between, with the
    JAX package's leaf names and (in, out) layout."""

    def __init__(self, cfg: ProxyConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = [(cfg.feature_dim, cfg.hidden), (cfg.hidden, cfg.hidden),
                (cfg.hidden, 1)]
        for i, shape in enumerate(dims):
            setattr(self, f"w{i}", nn.Parameter(_normal(shape, generator)))
        for i, (_, out) in enumerate(dims):
            setattr(self, f"b{i}", nn.Parameter(torch.zeros(out)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(x @ self.w0 + self.b0, approximate="tanh")
        h = F.gelu(h @ self.w1 + self.b1, approximate="tanh")
        return (h @ self.w2 + self.b2)[..., 0]


def proxy_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's proxy tree (``w0``..``b2``) as a
    :class:`ProxyMLP` state dict."""
    return {k: torch.from_numpy(np.asarray(v, np.float32).copy())
            for k, v in params.items()}


def train_query_proxy(features: np.ndarray, train_ids: np.ndarray,
                      train_targets: np.ndarray,
                      cfg: Optional[ProxyConfig] = None,
                      device: DeviceLike = None,
                      init: Optional[Dict[str, torch.Tensor]] = None
                      ) -> np.ndarray:
    """Train the per-query proxy on annotated ids; return proxy scores (N,).
    ``init`` (a :class:`ProxyMLP` state dict) replaces the seeded draw."""
    cfg = cfg or ProxyConfig(feature_dim=features.shape[1])
    dev = resolve_device(device)
    model = ProxyMLP(cfg, torch.Generator().manual_seed(cfg.seed))
    if init is not None:
        model.load_state_dict(init)
    model.to(dev)
    opt = OptimizerConfig(peak_lr=cfg.lr, min_lr=cfg.lr * 0.1, warmup_steps=10,
                          total_steps=cfg.steps, weight_decay=1e-4)
    x_all = torch.as_tensor(np.asarray(features[train_ids], np.float32),
                            device=dev)
    y_all = torch.as_tensor(train_targets.astype(np.float32), device=dev)

    def loss_fn(x, y):
        out = model(x)
        if cfg.classify:
            return torch.mean(torch.clamp_min(out, 0) - out * y
                              + torch.log1p(torch.exp(-torch.abs(out))))
        return torch.mean((out - y) ** 2)

    rng = np.random.default_rng(cfg.seed)

    def batches():
        for _ in range(cfg.steps):
            sel = torch.as_tensor(rng.integers(
                0, len(train_ids), size=min(cfg.batch, len(train_ids))),
                device=dev)
            yield x_all[sel], y_all[sel]

    minimize(list(model.parameters()), loss_fn, batches(), opt)
    with torch.no_grad():
        scores = model(torch.as_tensor(np.asarray(features, np.float32),
                                       device=dev)).cpu().numpy()
    if cfg.classify:
        scores = 1.0 / (1.0 + np.exp(-scores))
    return scores


# ---------------------------------------------------------------------------
# "Pre-trained" embedder (TASTI-PT)
# ---------------------------------------------------------------------------

def decoder_from_jax(dec: Dict[str, Any]) -> torch.Tensor:
    """The JAX package's decoder tree ``{"wd": (embed_dim, feature_dim)}``
    as the tensor :func:`pretrain_embedder` takes."""
    return torch.from_numpy(np.asarray(dec["wd"], np.float32).copy())


def pretrain_embedder(features: np.ndarray, ecfg: EmbedderConfig,
                      steps: int = 300, lr: float = 1e-3, seed: int = 0,
                      device: DeviceLike = None,
                      encoder_init: Optional[Dict[str, torch.Tensor]] = None,
                      decoder_init: Optional[torch.Tensor] = None) -> Embedder:
    """Generic self-supervised pre-training: embed -> linear decode ->
    reconstruct features.  Captures feature geometry without any access to
    the induced schema — the paper's ImageNet/BERT stand-in.  Returns the
    trained encoder on ``device``.  ``encoder_init`` (an :class:`Embedder`
    state dict) and ``decoder_init`` ((embed_dim, feature_dim)) replace the
    seeded draws."""
    dev = resolve_device(device)
    model = Embedder(ecfg, generator=torch.Generator().manual_seed(seed))
    if encoder_init is not None:
        model.load_state_dict(encoder_init)
    wd = (decoder_init.clone().float() if decoder_init is not None else
          _normal((ecfg.embed_dim, ecfg.feature_dim),
                  torch.Generator().manual_seed(seed + 1)))
    model.to(dev)
    wd = wd.to(dev).requires_grad_(True)
    opt = OptimizerConfig(peak_lr=lr, min_lr=lr * 0.1, warmup_steps=10,
                          total_steps=steps, weight_decay=0.0)
    feats = torch.as_tensor(np.asarray(features, np.float32), device=dev)

    def loss_fn(x):
        rec = model(x, attn_impl="plain") @ wd
        return torch.mean((rec - x) ** 2)

    rng = np.random.default_rng(seed)

    def batches():
        for _ in range(steps):
            sel = rng.integers(0, len(features), size=256)
            yield (feats[torch.as_tensor(sel, device=dev)],)

    minimize(list(model.parameters()) + [wd], loss_fn, batches(), opt)
    return model
