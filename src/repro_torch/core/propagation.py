"""Score propagation (paper §4.2): representative scores -> all records.

Numeric scores: distance-weighted mean of the k nearest representatives.
Categorical: distance-weighted majority vote.  Distances are cached in the
index, so propagation is O(N*k) arithmetic — the paper's key query-time win.

This module is the host (numpy, float64) reference path.  The device-resident
serving hot path (:mod:`repro_torch.kernels.propagate` via
:class:`repro_torch.core.resident.ResidentIndexState`) must match it within float32
tolerance; its parity suite runs in tier-1 CI.

Top-k columns whose squared distance is at or above
:data:`~repro_torch.kernels.distance_topk.ops.PAD_DIST` are padding (an index with
fewer reps than k) and carry zero weight — tiling the worst real entry
instead would silently double-weight that rep.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.distance_topk.ops import PAD_DIST


def _weights(topk_d2: np.ndarray, eps: float) -> np.ndarray:
    """Inverse-distance weights with padded columns masked to zero."""
    w = 1.0 / (np.sqrt(np.maximum(topk_d2, 0.0)) + eps)  # (N,k)
    return np.where(topk_d2 >= PAD_DIST, 0.0, w)


def propagate_numeric(rep_scores: np.ndarray, topk_ids: np.ndarray,
                      topk_d2: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """rep_scores (C,), topk_ids/(d2) (N,k) -> (N,) weighted-mean scores."""
    w = _weights(topk_d2, eps)                            # (N,k)
    s = rep_scores[topk_ids]                              # (N,k)
    return (w * s).sum(1) / w.sum(1)


def propagate_categorical(rep_scores: np.ndarray, topk_ids: np.ndarray,
                          topk_d2: np.ndarray, n_classes: int,
                          eps: float = 1e-6) -> np.ndarray:
    """Distance-weighted vote -> (N,) class ids."""
    w = _weights(topk_d2, eps)
    cls = rep_scores[topk_ids].astype(np.int64)           # (N,k)
    n = len(topk_ids)
    # one scatter-add over the flattened (record, class) grid
    flat = np.arange(n, dtype=np.int64)[:, None] * n_classes + cls
    votes = np.bincount(flat.ravel(), weights=w.ravel(),
                        minlength=n * n_classes).reshape(n, n_classes)
    return votes.argmax(1)


def top1_tie_break_eps(rep_scores: np.ndarray) -> float:
    """Perturbation scale for :func:`propagate_top1`: strictly below the
    smallest nonzero gap between distinct rep scores, so the distance
    nudge can only ever reorder records whose nearest reps score *equal* —
    never flip two distinct score levels (gaps under 1e-6 are common for
    probability-valued scores).  Capped at 1e-6 so well-conditioned scores
    keep the historical output bit-for-bit."""
    levels = np.unique(rep_scores[np.isfinite(rep_scores)])
    gaps = np.diff(levels)
    min_gap = float(gaps.min()) if len(gaps) else np.inf
    return float(min(1e-6, 0.5 * min_gap))


def propagate_top1(rep_scores: np.ndarray, topk_ids: np.ndarray,
                   topk_d2: np.ndarray) -> np.ndarray:
    """k=1 propagation with distance tie-break ordering — the paper's limit-
    query scoring (§6.3): score of the nearest rep, ranked by (score, -dist).
    """
    base = rep_scores[topk_ids[:, 0]].astype(np.float64)
    if len(base) == 0:          # empty index: nothing to rank (and no d.max())
        return base
    d = np.sqrt(np.maximum(topk_d2[:, 0], 0.0))
    # strictly monotone in score: the normalized-distance nudge is scaled
    # strictly below the smallest score gap, so distance only breaks ties
    # within one score level
    return base - top1_tie_break_eps(rep_scores) * d / (1.0 + d.max())
