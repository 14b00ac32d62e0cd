"""Triplet-loss training of the embedding DNN (TASTI-T, paper §3.1).

* ``mine_triplets``: builds (anchor, positive, negative) index triples from
  target-DNN annotations of the FPF-mined training set, using the workload's
  ``IsClose`` heuristic — "close" under the induced schema.  Numpy and host
  Python, as in the JAX package: the same ids and generator give the same
  triples.
* ``triplet_loss``: the paper's margin hinge on ||phi(a)-phi(p)|| vs
  ||phi(a)-phi(n)||.
* ``train_embedder``: AdamW (``repro_torch.optim.adamw``) on mini-batches of
  triples, on the embedder's device.  Attention goes through the plain
  route: no kernel of the port has a backward.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Tuple

import numpy as np
import torch

from repro_torch.core.embedder import Embedder
from repro_torch.optim.adamw import OptimizerConfig, minimize


@dataclass(frozen=True)
class TripletConfig:
    margin: float = 1.0
    batch: int = 256
    steps: int = 400
    lr: float = 1e-3
    max_triplets: int = 200_000
    seed: int = 0


def triplet_loss(emb_a: torch.Tensor, emb_p: torch.Tensor,
                 emb_n: torch.Tensor, margin: float) -> torch.Tensor:
    """mean(max(0, margin + |a - p| - |a - n|)).  Where a and p coincide
    the gradient of the norm is 0 here; ``jnp.linalg.norm``'s is NaN, so
    such a triple (duplicate records) turns the JAX package's weights NaN
    and leaves the port's finite."""
    d_ap = torch.linalg.norm(emb_a - emb_p, dim=-1)
    d_an = torch.linalg.norm(emb_a - emb_n, dim=-1)
    return torch.mean(torch.clamp_min(margin + d_ap - d_an, 0.0))


def mine_triplets(train_ids: np.ndarray, is_close: Callable[[int, int], bool],
                  rng: np.random.Generator,
                  max_triplets: int = 200_000) -> np.ndarray:
    """Exhaustive close/far split over the annotated set -> (T, 3) indices."""
    n = len(train_ids)
    close_sets = [[] for _ in range(n)]
    far_sets = [[] for _ in range(n)]
    for i in range(n):
        for j in range(i + 1, n):
            if is_close(int(train_ids[i]), int(train_ids[j])):
                close_sets[i].append(j)
                close_sets[j].append(i)
            else:
                far_sets[i].append(j)
                far_sets[j].append(i)
    triples = []
    for i in range(n):
        if not close_sets[i] or not far_sets[i]:
            continue
        k = min(len(close_sets[i]), 32)
        pos = rng.choice(close_sets[i], size=k, replace=False)
        neg = rng.choice(far_sets[i], size=k, replace=True)
        for p, ng in zip(pos, neg):
            triples.append((i, int(p), int(ng)))
    rng.shuffle(triples)
    out = np.asarray(triples[:max_triplets], np.int32)
    if len(out) == 0:
        out = np.zeros((0, 3), np.int32)
    return out


def train_embedder(model: Embedder, features: np.ndarray,
                   triples: np.ndarray,
                   tcfg: TripletConfig) -> Tuple[Embedder, List[float]]:
    """Trains ``model`` in place on its device; returns (model, loss
    history).  ``features`` are the training records' raw features (indexed
    by the triples).  Batches are drawn from ``default_rng(tcfg.seed)`` as
    the JAX package draws them."""
    if len(triples) == 0:
        return model, []
    opt = OptimizerConfig(peak_lr=tcfg.lr, min_lr=tcfg.lr * 0.1,
                          warmup_steps=20, total_steps=tcfg.steps,
                          weight_decay=0.0, clip_norm=1.0)
    dev = next(model.parameters()).device
    feats = torch.as_tensor(np.asarray(features, np.float32), device=dev)
    trip = torch.as_tensor(np.asarray(triples, np.int64), device=dev)
    embed_dim = model.cfg.embed_dim

    def loss_fn(idx):
        e = model(feats[idx.reshape(-1)], attn_impl="plain")
        e = e.reshape(-1, 3, embed_dim)
        return triplet_loss(e[:, 0], e[:, 1], e[:, 2], tcfg.margin)

    rng = np.random.default_rng(tcfg.seed)

    def batches():
        for _ in range(tcfg.steps):
            sel = rng.integers(0, len(triples),
                               size=min(tcfg.batch, len(triples)))
            yield (trip[torch.as_tensor(sel, device=dev)],)

    return model, minimize(list(model.parameters()), loss_fn, batches(), opt)
