"""Plain PyTorch version of flash attention (GQA, causal, sliding window):
the CPU path of the wrapper and the card's reference for
``csrc/flash_attention.cu``."""
from __future__ import annotations

import math

import torch

#: finite, so that a fully masked row averages every value instead of NaN
NEG_INF = -0.7 * torch.finfo(torch.float32).max


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,Skv,Hk,hd) -> (B,S,H,hd) in q's dtype.
    Full softmax in float32; query head h reads kv head h // (H/Hk);
    positions of q and k both start at 0."""
    b, s, h, hd = q.shape
    skv, hk = k.shape[1], k.shape[2]
    g = h // hk
    qg = q.reshape(b, s, hk, g, hd).float()
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) / math.sqrt(hd)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((s, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    scores.masked_fill_(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", p, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)
