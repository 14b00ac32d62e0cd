"""Wrapper of the ``distance_topk`` CUDA kernel: CPU tensors take the plain
version, CUDA tensors launch the kernel (or raise).

The kernel has two routes (``csrc/distance_topk.cu``), picked here from
dtype and shape alone by :func:`distance_topk_route`:

- ``"tc"``: the products on the tensor cores (``wgmma``, rep tiles fed by
  TMA); 3xTF32 for float32 inputs, one pass for bfloat16/float16.  It takes
  D <= :data:`TC_MAX_D` with rows of a multiple of 16 bytes (TMA's row
  stride: D % 4 == 0 in float32, D % 8 == 0 in 16-bit) and k <=
  :data:`TC_MAX_K` (the lists each thread keeps in registers).  The main
  path's 128-d float32 embeddings at k 8 and 1 take it.
- ``"simt"``: everything else, exact float32 on the CUDA cores.
"""
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

#: The kernel's routes, as its ROUTE_* codes.
ROUTES = ("simt", "tc")
#: Largest k and depth of the tc route (its lists and its tiles).
TC_MAX_K = 8
TC_MAX_D = 128
#: Reps per tile of the tc route: its rep-norm scratch is padded to it.
TC_BLOCK_C = 64

_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def distance_topk_route(x: torch.Tensor, r: torch.Tensor, k: int) -> str:
    """The kernel route that x (N,D) against r (C,D) at k takes: ``"tc"``
    where D <= 128, D * itemsize % 16 == 0 and k <= 8, else ``"simt"``;
    from dtype and shape only."""
    d = x.shape[1]
    if d <= TC_MAX_D and d * x.element_size() % 16 == 0 and k <= TC_MAX_K:
        return "tc"
    return "simt"


def _launch(x: torch.Tensor, r: torch.Tensor, k: int, route: str):
    """The kernel on ``route`` for 1 <= k <= C (the card's tests and
    chip_smoke.py time both routes at one shape through it)."""
    _build.refuse_grad("distance_topk", x, r)
    if route not in ROUTES:
        raise ValueError(f"unknown distance_topk route {route!r}")
    if x.dtype not in _DTYPES or r.dtype != x.dtype:
        raise TypeError(f"distance_topk kernel takes float32/float16/bfloat16 "
                        f"x and r of one dtype, got {x.dtype} and {r.dtype}")
    if x.ndim != 2 or r.ndim != 2 or x.shape[1] != r.shape[1]:
        raise ValueError(f"shapes {tuple(x.shape)} and {tuple(r.shape)}")
    if k > MAX_K:
        raise ValueError(f"distance_topk kernel keeps at most {MAX_K} "
                         f"neighbours, asked for {k}")
    if route == "tc" and distance_topk_route(x, r, k) != "tc":
        raise ValueError(f"the tc route cannot take x {tuple(x.shape)} "
                         f"{x.dtype} at k {k}")
    n, d = x.shape
    c = r.shape[0]
    if max(n, c) >= 2 ** 31:
        raise ValueError(f"{n} records x {c} reps exceeds the kernel's int32 "
                         "row counts")
    x, r = _build.aligned16(x), _build.aligned16(r)
    dev = x.device
    out_d = torch.empty((n, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n, k), dtype=torch.int32, device=dev)
    xsq = torch.empty((n,), dtype=torch.float32, device=dev)
    c_pad = -(-c // TC_BLOCK_C) * TC_BLOCK_C
    rsq = torch.empty((c_pad,), dtype=torch.float32, device=dev)
    rsplit = (torch.empty((2, c, d), dtype=torch.float32, device=dev)
              if route == "tc" and x.dtype == torch.float32 else None)
    fn = _build.bind("distance_topk", "distance_topk_launch",
                     [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                     + [ctypes.c_void_p] * 3)
    status = fn(_build.ptr(x), _build.ptr(r), _build.ptr(xsq), _build.ptr(rsq),
                None if rsplit is None else _build.ptr(rsplit), n, c, d, k,
                _DTYPES[x.dtype], ROUTES.index(route), _build.ptr(out_d),
                _build.ptr(out_i), _build.stream_of(x))
    _build.check("distance_topk", status, f"distance_topk ({route})")
    distance_topk.launches += 1
    distance_topk.launches_by_path[route] += 1
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
        d, i = _launch(x, r, k_eff, distance_topk_route(x, r, k_eff))
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


def reset_launches() -> None:
    """Set the launch counts, total and per route, to 0."""
    distance_topk.launches = 0
    distance_topk.launches_by_path = dict.fromkeys(ROUTES, 0)


#: kernel launches since the count was last reset, in all and per route
distance_topk.launches = 0
distance_topk.launches_by_path = dict.fromkeys(ROUTES, 0)
