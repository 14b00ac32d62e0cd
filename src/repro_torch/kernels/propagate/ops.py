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


def _launch(rep_scores, topk_ids, topk_d2, mode, n_classes, clip01, eps):
    n, k = topk_ids.shape
    if k == 0 or topk_d2.shape != (n, k) or rep_scores.ndim != 1:
        raise ValueError(f"shapes {tuple(rep_scores.shape)}, "
                         f"{tuple(topk_ids.shape)}, {tuple(topk_d2.shape)}")
    if n >= 2 ** 31:
        raise ValueError(f"{n} records exceed the kernel's int32 row count")
    dev = topk_ids.device
    scores = rep_scores.to(device=dev, dtype=torch.float32).contiguous()
    ids = topk_ids.to(torch.int32).contiguous()
    d2 = topk_d2.to(torch.float32).contiguous()
    if mode == "top1":
        prescale = tie_break_prescale(scores, d2).reshape(1)
    else:
        prescale = torch.zeros((1,), dtype=torch.float32, device=dev)
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    lib = _build.load("propagate")
    fn = lib.propagate_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p] + [ctypes.c_int] * 5 + \
        [ctypes.c_float] * 2 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    status = fn(_build.ptr(scores), scores.shape[0], _build.ptr(ids),
                _build.ptr(d2), n, k, MODES.index(mode), int(n_classes or 0),
                int(bool(clip01)), eps, PAD_DIST, _build.ptr(prescale),
                _build.ptr(out), _build.stream_of(out))
    _build.check(lib, status, "propagate")
    propagate.launches += 1
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


#: kernel launches since the count was last reset
propagate.launches = 0
