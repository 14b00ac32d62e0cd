"""Wrapper of the ``distance_topk`` CUDA kernel: CPU tensors take the plain
version, CUDA tensors launch the kernel (or raise)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.distance_topk.ref import distance_topk_ref

#: Squared-distance sentinel marking padded top-k columns (k > n_reps).
#: Strictly larger than any real squared distance the kernels produce, and
#: finite in float32 so arithmetic on it stays NaN-free.  Consumers
#: (repro_torch.core.propagation, repro_torch.kernels.propagate) treat
#: columns at or above this value as absent: zero weight.
PAD_DIST = 2.9e38

#: Largest k the kernel keeps in registers.
MAX_K = 32

_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _launch(x: torch.Tensor, r: torch.Tensor, k: int):
    if x.dtype not in _DTYPES or r.dtype != x.dtype:
        raise TypeError(f"distance_topk kernel takes float32/float16/bfloat16 "
                        f"x and r of one dtype, got {x.dtype} and {r.dtype}")
    if x.ndim != 2 or r.ndim != 2 or x.shape[1] != r.shape[1]:
        raise ValueError(f"shapes {tuple(x.shape)} and {tuple(r.shape)}")
    if k > MAX_K:
        raise ValueError(f"distance_topk kernel keeps at most {MAX_K} "
                         f"neighbours, asked for {k}")
    n, d = x.shape
    c = r.shape[0]
    if max(n, c) >= 2 ** 31:
        raise ValueError(f"{n} records x {c} reps exceeds the kernel's int32 "
                         "row counts")
    x, r = x.contiguous(), r.contiguous()
    out_d = torch.empty((n, k), dtype=torch.float32, device=x.device)
    out_i = torch.empty((n, k), dtype=torch.int32, device=x.device)
    xsq = torch.empty((n,), dtype=torch.float32, device=x.device)
    rsq = torch.empty((c,), dtype=torch.float32, device=x.device)
    lib = _build.load("distance_topk")
    fn = lib.distance_topk_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    status = fn(_build.ptr(x), _build.ptr(r), _build.ptr(xsq), _build.ptr(rsq),
                n, c, d, k, _DTYPES[x.dtype], _build.ptr(out_d),
                _build.ptr(out_i), _build.stream_of(x))
    _build.check(lib, status, "distance_topk")
    distance_topk.launches += 1
    return out_d, out_i


def distance_topk(x: torch.Tensor, r: torch.Tensor, k: int):
    """x (N,D), r (C,D) -> (squared L2 dists (N,k) float32, rep ids (N,k)
    int32), ascending; on equal distances the lower id comes first.

    With fewer reps than k, the trailing ``k - n_reps`` columns are padding:
    their distance is the :data:`PAD_DIST` sentinel and their ids repeat the
    worst real entry (id 0 with no reps at all), so they stay in range.
    """
    if x.device != r.device:
        raise ValueError(f"x on {x.device} but r on {r.device}")
    k_eff = min(k, r.shape[0])
    n = x.shape[0]
    if n == 0 or k_eff == 0:
        d = torch.empty((n, k_eff), dtype=torch.float32, device=x.device)
        i = torch.empty((n, k_eff), dtype=torch.int32, device=x.device)
    elif x.device.type == "cpu":
        d, i = distance_topk_ref(x, r, k_eff)
    elif x.device.type == "cuda":
        d, i = _launch(x, r, k_eff)
    else:
        raise ValueError(f"no distance_topk for device {x.device}")
    if k_eff < k:  # fewer reps than k: sentinel distances, in-range ids
        pad = (n, k - k_eff)
        d = torch.cat([d, torch.full(pad, PAD_DIST, dtype=d.dtype,
                                     device=d.device)], 1)
        last = i[:, -1:] if k_eff else torch.zeros(
            (n, 1), dtype=i.dtype, device=i.device)   # repless: id 0
        i = torch.cat([i, last.expand(pad)], 1)
    return d, i


#: kernel launches since the count was last reset
distance_topk.launches = 0
