"""Wrapper of the ``flash_attention`` CUDA kernel: CPU tensors take the
plain version, CUDA tensors launch the kernel (or raise).

The public layout is the JAX wrapper's, q (B,S,H,hd) and k/v (B,Skv,Hk,hd);
the kernel reads it in place (no transpose), works at the logical head dim
(no padding to 128, no scale correction) and needs no sequence padding.

The kernel has three paths (``csrc/flash_attention.cu``), picked here from
shape and dtype alone by :func:`flash_route`:

- ``"short"``: S and Skv <= 32 (the transformer embedder): whole batch
  elements per block, a warp per (batch, head);
- ``"tc"``: bf16 with hd % 8 == 0 (the LM prefill): tensor cores (wgmma)
  fed by TMA;
- ``"simt"``: everything else (float32 included, which stays exact).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

#: the kernel's input types (the TPU kernel's: float32 and bfloat16), as
#: the dtype codes of ``csrc/common.cuh``
_DTYPES = {torch.float32: 0, torch.bfloat16: 2}
#: the kernel's paths, as its ROUTE_* codes
ROUTES = ("simt", "tc", "short")
#: largest head dim the kernel keeps in its tiles
MAX_HEAD_DIM = 128
#: query rows per block of the simt path; its grid.y counts q tiles
BLOCK_Q = 64
#: longest S and Skv of the short path
SHORT_MAX_LEN = 32
#: shared memory one batch element of the short path may take (q, k, v rows
#: at a pitch of an odd number of 16-byte chunks)
SHORT_BATCH_BYTES = 64 * 1024
# SHORT_MAX_LEN, SHORT_BATCH_BYTES and _short_batch_bytes restate the short
# path's layout in csrc/flash_attention.cu (shortseq::MAX_LEN, BLOCK_BYTES,
# pitch, batch_bytes), whose launch refuses any input outside it: change
# both sides together.


def _short_batch_bytes(s: int, skv: int, h: int, hk: int, hd: int,
                       item: int) -> int:
    pitch = ((hd * item // 16) | 1) * 16
    return (s * h + 2 * skv * hk) * pitch


def flash_route(q: torch.Tensor, k: torch.Tensor) -> str:
    """The kernel path that q (B,S,H,hd) against k (B,Skv,Hk,hd) takes:
    ``"short"``, ``"tc"`` or ``"simt"``, from shape and dtype only."""
    b, s, h, hd = q.shape
    skv, hk = k.shape[1], k.shape[2]
    item = q.element_size()
    if s <= SHORT_MAX_LEN and skv <= SHORT_MAX_LEN and \
            hd * item % 16 == 0 and \
            _short_batch_bytes(s, skv, h, hk, hd, item) <= SHORT_BATCH_BYTES:
        return "short"
    if q.dtype == torch.bfloat16 and hd % 8 == 0 and hd <= MAX_HEAD_DIM:
        return "tc"
    return "simt"


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int) -> torch.Tensor:
    _build.refuse_grad("flash_attention", q, k, v)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32/bfloat16 "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    b, s, h, hd = q.shape
    skv, hk = k.shape[1], k.shape[2]
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head dim <= "
                         f"{MAX_HEAD_DIM}, got {hd}")
    route = flash_route(q, k)
    if s == 0 or skv == 0 or b * h >= 2 ** 31 or (
            route == "simt" and (s + BLOCK_Q - 1) // BLOCK_Q > 65535):
        raise ValueError(f"flash_attention kernel cannot take q "
                         f"{tuple(q.shape)} against k {tuple(k.shape)}")
    q, k, v = (_build.aligned16(t) for t in (q, k, v))
    out = torch.empty_like(q)
    fn = _build.bind("flash_attention", "flash_attention_launch",
                     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                     + [ctypes.c_void_p])
    status = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
                b, s, skv, h, hk, hd, int(causal), int(window),
                _DTYPES[q.dtype], ROUTES.index(route), _build.stream_of(q))
    _build.check("flash_attention", status,
                 f"flash_attention ({route})")
    _build.count_launch(flash_attention, route)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,Skv,Hk,hd) -> (B,S,H,hd) in q's dtype: softmax
    attention with scale 1/sqrt(hd), query head h on kv head h // (H/Hk),
    keys masked to ``qpos >= kpos`` (causal) and ``qpos - kpos < window``
    (window > 0), positions from 0 on both sides; float32 softmax
    statistics."""
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4 or \
            k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] or \
            q.shape[2] % k.shape[2]:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, window)
    raise ValueError(f"no flash_attention for device {q.device}")


def reset_launches() -> None:
    """Set the launch counts, total and per path, to 0."""
    flash_attention.launches = 0
    flash_attention.launches_by_path = dict.fromkeys(ROUTES, 0)


#: kernel launches since the count was last reset, in all and per path
flash_attention.launches = 0
flash_attention.launches_by_path = dict.fromkeys(ROUTES, 0)
