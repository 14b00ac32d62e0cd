"""Furthest-point-first (Gonzalez 1985): training-data mining and cluster-
representative selection (paper §3.1/§3.2).

FPF gives a 2-approximation to the optimal max intra-cluster distance — the
quantity the paper's Theorems 1/2 depend on.  Each step is one fused pass via
``repro_torch.kernels.fpf_update`` (distance to newest rep + running min +
argmax); a small random fraction is mixed in for average-case queries (§3.2).

The selection loop stays on the device: each step's argmax feeds the next
step's rep without a host round-trip, and the chosen ids come back once.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, as_device_tensor, resolve_device
from repro_torch.kernels.distance_topk.ops import distance_topk
from repro_torch.kernels.fpf_update.ops import fpf_update
from repro_torch.obs import trace


def _on_device(embeddings, device: DeviceLike) -> torch.Tensor:
    """Embeddings as a tensor: a tensor stays where it is unless ``device``
    names another; numpy goes to ``resolve_device(device)``."""
    if isinstance(embeddings, torch.Tensor) and device is None:
        return embeddings
    x = as_device_tensor(embeddings, resolve_device(device))
    if not isinstance(embeddings, torch.Tensor):
        trace.count("h2d_bytes", x.nbytes)
    return x


def fpf_select(embeddings, n_select: int, random_fraction: float = 0.1,
               seed: int = 0, start: Optional[int] = None,
               device: DeviceLike = None) -> np.ndarray:
    """Returns indices (n_select,) — FPF points + a random mix.

    ``embeddings`` is an (N, d) numpy array or tensor; the random mix uses
    numpy's generator with ``seed``, as the JAX package does.
    """
    with trace.span("tasti.fpf", records=len(embeddings)) as sp:
        x = _on_device(embeddings, device).to(torch.float32)
        n = len(x)
        n_select = min(n_select, n)
        rng = np.random.default_rng(seed)
        n_rand = int(round(n_select * random_fraction))
        n_fpf = n_select - n_rand
        sp.set(steps=max(n_fpf - 1, 0))

        chosen = torch.empty(n_fpf, dtype=torch.int64, device=x.device)
        chosen[0] = start if start is not None else int(rng.integers(n))
        min_d2 = torch.full((n,), float("inf"), dtype=torch.float32,
                            device=x.device)
        idx = chosen[:1]
        for t in range(1, n_fpf):
            min_d2, nxt, _ = fpf_update(x, x.index_select(0, idx)[0], min_d2)
            idx = nxt.reshape(1)
            chosen[t] = nxt
        chosen = chosen.cpu().numpy()
        trace.count("d2h_bytes", chosen.nbytes)
        # mix random clusters (dedup while keeping count)
        pool = np.setdiff1d(np.arange(n), chosen, assume_unique=False)
        if n_rand and len(pool):
            extra = rng.choice(pool, size=min(n_rand, len(pool)),
                               replace=False)
            out = np.concatenate([chosen, extra])
        else:
            out = chosen
        return out.astype(np.int64)


def max_intra_cluster_dist(embeddings, reps: np.ndarray,
                           device: DeviceLike = None) -> float:
    """max_x ||phi(x) - phi(c(x))|| — the density quantity in Thm 1/2."""
    x = _on_device(embeddings, device).to(torch.float32)
    r = x.index_select(0, torch.as_tensor(np.asarray(reps), dtype=torch.int64,
                                          device=x.device))
    d2, _ = distance_topk(x, r, 1)
    return float(torch.sqrt(torch.max(d2)))
