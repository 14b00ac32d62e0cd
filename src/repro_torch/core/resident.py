"""Device-resident index state for the serving hot path.

Proxy-score materialization is O(N*k) arithmetic over index structures that
only change on a crack, so off-host execution is bandwidth-bound on the rep
structures — re-shipping ``topk_ids``/``topk_d2`` (and the embeddings) to the
accelerator per query would cost more than the propagation itself.  The
index keeps them on its device (uploaded once per version), and a
:class:`ResidentIndexState`, owned by
:class:`repro_torch.core.engine.QueryEngine`, replays the fused propagate
kernel (:func:`repro_torch.kernels.propagate.ops.propagate`) against them;
only the small (C,) rep-score vector moves per call.

Staleness is handled with the index's existing ``version`` counter: every
upload is stamped with the version it saw, every :meth:`propagate` call
carries the version the caller's rep scores were computed against, and any
mismatch (a crack landed in between) returns ``None`` so the engine falls
back to the host path for that attempt and retries against the new index.

Enablement: on when the engine's device (its index's) is CUDA, off on the
CPU — the CPU serving path keeps the float64 numpy propagation.  Override
with ``REPRO_RESIDENT_SCORING=1`` (force on; the CPU then runs the plain
PyTorch version) or ``=0`` (force off).  A kernel error on the device raises:
there is no silent fallback to the host.
"""
from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.propagate.ops import propagate as _propagate

_TRUTHY = ("1", "true", "on", "force", "yes")
_FALSY = ("0", "false", "off", "no")

ENV_VAR = "REPRO_RESIDENT_SCORING"


def _default_enabled(device: torch.device) -> bool:
    env = os.environ.get(ENV_VAR, "").strip().lower()
    if env in _TRUTHY:
        return True
    if env in _FALSY:
        return False
    return device.type == "cuda"


class ResidentIndexState:
    """Serves one index's top-k rep structures from the device.

    The index owns the device copies (:meth:`TastiIndex.topk_device`,
    uploaded once per version; a crack leaves its merged structures there),
    so this state only stamps the version it serves and counts.  Thread-
    safe: the fused propagate call runs outside the lock, and propagations
    over different score functions overlap.
    """

    def __init__(self, index, enabled: Optional[bool] = None, obs=None):
        self.index = index
        self.enabled = (_default_enabled(index.device) if enabled is None
                        else bool(enabled))
        self._lock = threading.Lock()
        self._version: Optional[int] = None   # version being served
        self.stats = {
            "uploads": 0,        # rep-structure versions taken up
            "invalidations": 0,  # crack listeners dropping the version
            "fallbacks": 0,      # propagate() calls answered by the host path
            "computes": 0,       # propagate() calls answered on the device
        }
        self.set_obs(obs)

    def set_obs(self, obs) -> None:
        """Attach an :class:`~repro_torch.obs.ObsScope` (counters here stay in
        ``self.stats`` and are exported at scrape time; nothing to resolve
        eagerly — kept for interface symmetry with broker/pool)."""
        self._obs = obs

    # ------------------------------------------------------------------
    def invalidate(self) -> None:
        """Crack listener: forget the served version.  Correctness never
        depends on this — :meth:`propagate` version-checks every call."""
        with self._lock:
            if self._version is not None:
                self.stats["invalidations"] += 1
            self._version = None

    def _structures(self, version: int):
        """Device (topk_ids, topk_d2) for ``version``, or ``None`` if the
        index has moved past it."""
        got, ids, d2 = self.index.topk_device()
        if got != version:
            return None
        with self._lock:
            if self._version != version:
                self._version = version
                self.stats["uploads"] += 1
        return ids, d2

    # ------------------------------------------------------------------
    def propagate(self, rep_scores: np.ndarray, mode: str, *, version: int,
                  n_classes: Optional[int] = None,
                  clip01: bool = False) -> Optional[np.ndarray]:
        """Fused device propagation of ``rep_scores`` (computed against index
        ``version``) -> (N,) float64, or ``None`` to signal host fallback
        (disabled, or the version raced with a crack).  A device or kernel
        failure raises.
        """
        if not self.enabled:
            self.stats["fallbacks"] += 1
            return None
        if self.index.version != version:
            self.stats["fallbacks"] += 1
            return None          # crack landed since the caller snapshotted
        structures = self._structures(version)
        if structures is None:
            self.stats["fallbacks"] += 1
            return None
        ids, d2 = structures
        scores = torch.as_tensor(np.asarray(rep_scores, np.float32),
                                 device=ids.device)
        out = _propagate(scores, ids, d2, mode, n_classes=n_classes,
                         clip01=clip01)
        out = out.cpu().numpy().astype(np.float64)
        with self._lock:
            self.stats["computes"] += 1
        return out
