"""Plain PyTorch version of fused score propagation (paper §4.2): the CPU
path and the card's reference for ``csrc/propagate.cu``.

Mirrors the float64 host path in :mod:`repro_torch.core.propagation` in
float32: inverse-distance weights over the cached top-k representative
structures, with padded columns (squared distance at or above
:data:`~repro_torch.kernels.distance_topk.ops.PAD_DIST`) masked to zero.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.distance_topk.ops import PAD_DIST

MODES = ("numeric", "top1", "categorical")


def masked_weights(topk_d2: torch.Tensor, eps: float) -> torch.Tensor:
    """Inverse-distance weights (N,k) with padded columns zeroed."""
    d2 = topk_d2.to(torch.float32)
    w = 1.0 / (torch.sqrt(torch.clamp_min(d2, 0.0)) + eps)
    return torch.where(d2 >= PAD_DIST, torch.zeros_like(w), w)


def tie_break_prescale(rep_scores: torch.Tensor,
                       topk_d2: torch.Tensor) -> torch.Tensor:
    """Scalar multiplier for the top-1 distance nudge.

    ``eps / (1 + max distance)`` with ``eps`` strictly below the smallest
    nonzero gap between distinct rep scores (capped at 1e-6), so distance can
    only reorder records whose nearest reps score equal.  Over real rows
    only; stays on the device (no host sync).
    """
    scores = rep_scores.to(torch.float32)
    cap = torch.tensor(1e-6, dtype=torch.float32, device=scores.device)
    if scores.shape[0] >= 2:
        gaps = torch.diff(torch.sort(scores).values)
        min_gap = torch.where(gaps > 0, gaps,
                              torch.full_like(gaps, float("inf"))).min()
        eps = torch.minimum(cap, 0.5 * min_gap)
    else:
        eps = cap
    d0 = torch.sqrt(torch.clamp_min(topk_d2[:, 0].to(torch.float32), 0.0))
    return eps / (1.0 + d0.max())


def _gather(rep_scores: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return rep_scores.to(torch.float32)[ids.long()]


def propagate_numeric_ref(rep_scores, topk_ids, topk_d2, eps: float = 1e-6,
                          clip01: bool = False) -> torch.Tensor:
    """rep_scores (C,), topk_ids/(d2) (N,k) -> (N,) weighted-mean scores."""
    w = masked_weights(topk_d2, eps)
    out = (w * _gather(rep_scores, topk_ids)).sum(1) / w.sum(1)
    return torch.clamp(out, 0.0, 1.0) if clip01 else out


def propagate_categorical_ref(rep_scores, topk_ids, topk_d2, n_classes: int,
                              eps: float = 1e-6) -> torch.Tensor:
    """Distance-weighted vote -> (N,) class ids as float32 (first class on
    ties)."""
    w = masked_weights(topk_d2, eps)
    cls = _gather(rep_scores, topk_ids).to(torch.int32)
    classes = torch.arange(n_classes, dtype=torch.int32, device=cls.device)
    onehot = cls[:, :, None] == classes
    votes = (onehot * w[:, :, None]).sum(1)
    return torch.argmax(votes, dim=1).to(torch.float32)


def propagate_top1_ref(rep_scores, topk_ids, topk_d2,
                       clip01: bool = False) -> torch.Tensor:
    """k=1 propagation ranked (score desc, dist asc) — limit-query scoring."""
    base = _gather(rep_scores, topk_ids[:, 0])
    d = torch.sqrt(torch.clamp_min(topk_d2[:, 0].to(torch.float32), 0.0))
    out = base - tie_break_prescale(rep_scores, topk_d2) * d
    return torch.clamp(out, 0.0, 1.0) if clip01 else out


def propagate_ref(rep_scores, topk_ids, topk_d2, mode: str,
                  n_classes=None, clip01: bool = False,
                  eps: float = 1e-6) -> torch.Tensor:
    """The plain version of every mode, as the kernel computes it
    (``clip01`` clips every mode)."""
    if mode == "numeric":
        return propagate_numeric_ref(rep_scores, topk_ids, topk_d2, eps=eps,
                                     clip01=clip01)
    if mode == "top1":
        return propagate_top1_ref(rep_scores, topk_ids, topk_d2,
                                  clip01=clip01)
    if mode == "categorical":
        out = propagate_categorical_ref(rep_scores, topk_ids, topk_d2,
                                        n_classes, eps=eps)
        return torch.clamp(out, 0.0, 1.0) if clip01 else out
    raise ValueError(f"unknown propagation mode {mode!r}")
