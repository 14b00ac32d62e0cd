"""Plain PyTorch version of flash attention (GQA, causal, sliding window):
the CPU path of the wrapper and the card's reference for
``csrc/flash_attention.cu``, with the tolerance the kernel is held to."""
from __future__ import annotations

import math

import torch

#: finite, so that a fully masked row averages every value instead of NaN
NEG_INF = -0.7 * torch.finfo(torch.float32).max

#: the kernel against this plain version, per element: float32 at the JAX
#: package's kernel-test tolerance (2e-3, tests/test_kernels.py); bf16 at
#: bf16 rounding, not at the size of the values: both compute in float32 and
#: round once, so they differ by an ulp or two (2^-8 relative).  With q, k, v
#: ~ N(0, 1) an output over n keys is ~sqrt(e / n) (0.026 at n = 4,096), so
#: the JAX reference's 3e-2 would pass a kernel that dropped a key tile.
ATTN_TOL = {torch.float32: {"rtol": 2e-3, "atol": 2e-3},
            torch.bfloat16: {"rtol": 1.6e-2, "atol": 2e-3}}
#: a path that rounds P to bf16 before P.V (the kernel's tc path, as the JAX
#: package's XLA attention does) may move each element by up to WITNESS_P
#: times what that rounding moves it in the witness (``round_p=True``)
WITNESS_P = 2.0


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        round_p: bool = False) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,Skv,Hk,hd) -> (B,S,H,hd) in q's dtype.
    Full softmax in float32; query head h reads kv head h // (H/Hk);
    positions of q and k both start at 0.  ``round_p`` rounds P to v's
    dtype before P.V as the kernel's tc path holds it, exp(s - row max)
    before the division by the unrounded row sum: a witness of what that
    rounding alone moves."""
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
    if round_p and v.dtype != torch.float32:
        e = torch.exp(scores - scores.amax(-1, keepdim=True))
        p = e.to(v.dtype).float() / e.sum(-1, keepdim=True)
        del e
    else:
        p = torch.softmax(scores, dim=-1)
    del scores
    out = torch.einsum("bkgst,btkh->bskgh", p, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)


def allowed_error(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0,
                  round_p: bool = False):
    """(plain output, float32; the largest |kernel - plain| each element may
    show): ``ATTN_TOL`` of the plain output, plus, with ``round_p``,
    ``WITNESS_P`` times how far the witness lies from the plain output at
    that element.  A kernel passes if no element lies further out."""
    want = flash_attention_ref(q, k, v, causal, window).float()
    tol = ATTN_TOL[q.dtype]
    allowed = tol["atol"] + tol["rtol"] * want.abs()
    if round_p:
        wit = flash_attention_ref(q, k, v, causal, window, round_p=True)
        allowed += WITNESS_P * (wit.float() - want).abs()
    return want, allowed
