"""Wrapper of the fused ``propagate`` CUDA kernel: CPU tensors take the
plain version, CUDA tensors launch the kernel (or raise)."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.distance_topk.ops import PAD_DIST
from repro_torch.kernels.propagate.ref import (
    MODES,
    propagate_ref,
    tie_break_prescale,
)


#: Blocks of the top-1 statistics kernel (its partial max and min gap).
STATS_BLOCKS = 528
#: Largest C whose top-1 prescale the card computes pairwise (C^2 / 2
#: differences); above it the plain tie_break_prescale runs on the device.
PAIRWISE_MAX_C = 32768
_THREADS = 256   # csrc/propagate.cu's THREADS


def _launch(rep_scores, topk_ids, topk_d2, mode, n_classes, clip01, eps):
    _build.refuse_grad("propagate", rep_scores, topk_ids, topk_d2)
    n, k = topk_ids.shape
    if k == 0 or topk_d2.shape != (n, k) or rep_scores.ndim != 1:
        raise ValueError(f"shapes {tuple(rep_scores.shape)}, "
                         f"{tuple(topk_ids.shape)}, {tuple(topk_d2.shape)}")
    if n >= 2 ** 31:
        raise ValueError(f"{n} records exceed the kernel's int32 row count")
    dev = topk_ids.device
    scores = rep_scores.to(device=dev, dtype=torch.float32).contiguous()
    ids = _build.aligned16(topk_ids.to(torch.int32))
    d2 = _build.aligned16(topk_d2.to(torch.float32))
    c = scores.shape[0]
    prescale = stats = None
    if mode == "top1":
        if c <= PAIRWISE_MAX_C:
            stats = torch.empty((2 * STATS_BLOCKS,), dtype=torch.float32,
                                device=dev)
        else:
            prescale = tie_break_prescale(scores, d2).reshape(1)
            propagate.plain_prescales += 1
    strips = max(1, STATS_BLOCKS * _THREADS // max(c, 1))
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    fn = _build.bind("propagate", "propagate_launch",
                     [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p] + [ctypes.c_int] * 5
                     + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 2
                     + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)
    status = fn(_build.ptr(scores), c, _build.ptr(ids), _build.ptr(d2), n, k,
                MODES.index(mode), int(n_classes or 0), int(bool(clip01)),
                eps, PAD_DIST,
                None if prescale is None else _build.ptr(prescale),
                None if stats is None else _build.ptr(stats), STATS_BLOCKS,
                strips, _build.ptr(out), _build.stream_of(out))
    _build.check("propagate", status, f"propagate ({mode})")
    propagate.launches += 1
    propagate.launches_by_path[mode] += 1
    return out


def propagate(rep_scores: torch.Tensor, topk_ids: torch.Tensor,
              topk_d2: torch.Tensor, mode: str,
              n_classes: Optional[int] = None, clip01: bool = False,
              eps: float = 1e-6) -> torch.Tensor:
    """Fused propagation: rep_scores (C,) -> proxy scores (N,) float32 on
    the device of ``topk_ids``.

    ``mode`` is one of :data:`MODES`; ``n_classes`` is required for
    ``"categorical"``.  Padded top-k columns (squared distance at or above
    :data:`PAD_DIST`) carry zero weight, matching
    :mod:`repro_torch.core.propagation`.  ``clip01`` clips every mode to
    [0, 1].
    """
    if mode not in MODES:
        raise ValueError(f"unknown propagation mode {mode!r}")
    if mode == "categorical" and not n_classes:
        raise ValueError("categorical propagation needs n_classes")
    if topk_ids.shape[0] == 0:          # empty index
        return torch.zeros((0,), dtype=torch.float32, device=topk_ids.device)
    if topk_ids.device.type == "cpu":
        return propagate_ref(rep_scores.to("cpu"), topk_ids, topk_d2, mode,
                             n_classes=n_classes, clip01=clip01, eps=eps)
    if topk_ids.device.type == "cuda":
        return _launch(rep_scores, topk_ids, topk_d2, mode, n_classes, clip01,
                       eps)
    raise ValueError(f"no propagate for device {topk_ids.device}")


def reset_launches() -> None:
    """Set the launch counts (in all, per mode, top-1 prescales computed by
    the plain version) to 0."""
    propagate.launches = 0
    propagate.launches_by_path = dict.fromkeys(MODES, 0)
    propagate.plain_prescales = 0


#: wrapper calls that launched the kernel since the counts were last reset,
#: in all and per mode; top1 calls whose prescale the plain
#: tie_break_prescale computed (C above PAIRWISE_MAX_C)
propagate.launches = 0
propagate.launches_by_path = dict.fromkeys(MODES, 0)
propagate.plain_prescales = 0
