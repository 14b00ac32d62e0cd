"""Plain reference of a dense decoder's prefill, and the judge of its
logits.

The forward is written from the published description and the weights'
names alone: token embedding; per layer RMSNorm, grouped-query attention
with rotary positions (half-split, theta from the configuration) under a
causal mask, a residual, RMSNorm, a SwiGLU MLP and a residual; a final
RMSNorm and the unembedding.  It runs layer by layer in float32 (TF32 off)
with the attention in blocks of queries, so that it fits beside the
weights; ``precision="fp8"`` is the control: every matrix product on e4m3
inputs.  Nothing here imports the program.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.refs.precision import ein, exact_float32, mm

#: queries a block of the attention
Q_BLOCK = 1024
#: positions a block of the unembedding and of the judge
ROW_BLOCK = 2048


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, hd) float32 rotated at positions 0..S-1, halves paired."""
    s, _, hd = x.shape
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, precision: str) -> torch.Tensor:
    """Causal GQA: q (S, H, hd), k/v (S, Hk, hd) -> (S, H*hd), float32."""
    s, h, hd = q.shape
    hk = k.shape[1]
    g = h // hk
    out = torch.empty(s, h * hd, device=q.device)
    for a in range(0, s, Q_BLOCK):
        b = min(a + Q_BLOCK, s)
        qb = q[a:b].reshape(b - a, hk, g, hd)
        sc = ein("qkgd,tkd->kgqt", qb, k[:b], precision) / math.sqrt(hd)
        mask = (torch.arange(a, b, device=q.device)[:, None]
                >= torch.arange(b, device=q.device)[None, :])
        sc.masked_fill_(~mask, -math.inf)
        p = torch.softmax(sc, dim=-1)
        del sc
        if precision == "fp8":
            p = p.to(torch.bfloat16)
        o = ein("kgqt,tkd->qkgd", p, v[:b], precision)
        out[a:b] = o.reshape(b - a, h * hd)
    return out


@torch.no_grad()
def hidden(w: Dict[str, torch.Tensor], tokens: torch.Tensor, c: dict,
           precision: str = "float32") -> torch.Tensor:
    """The final normed hidden states (S, d), float32, of one prompt
    ``tokens`` (S,)."""
    eps, hd = c["rms_norm_eps"], c["head_dim"]
    h_n, hk_n = c["num_attention_heads"], c["num_key_value_heads"]
    b = "blocks/0/"
    with exact_float32():
        x = w["embed"][tokens.long()].float()
        s = x.shape[0]
        for layer in range(c["num_hidden_layers"]):
            def p(name):
                return w[b + name][layer]
            a = rmsnorm(x, p("norm1/scale"), eps)
            q = rope(mm(a, p("attn/wq"), precision).reshape(s, h_n, hd),
                     c["rope_theta"])
            k = rope(mm(a, p("attn/wk"), precision).reshape(s, hk_n, hd),
                     c["rope_theta"])
            v = mm(a, p("attn/wv"), precision).reshape(s, hk_n, hd)
            del a
            o = attention(q, k, v, precision)
            del q, k, v
            x += mm(o, p("attn/wo"), precision)
            del o
            a = rmsnorm(x, p("norm2/scale"), eps)
            gate = mm(a, p("mlp/wi_gate"), precision)
            gate = torch.nn.functional.silu(gate).mul_(
                mm(a, p("mlp/wi_up"), precision))
            del a
            x += mm(gate, p("mlp/wo"), precision)
            del gate
        return rmsnorm(x, w["final_norm/scale"], eps)


@torch.no_grad()
def judge(got: torch.Tensor, hid: torch.Tensor, unembed: torch.Tensor,
          vocab: int) -> Dict[str, float]:
    """The program's logits ``got`` (S, >= vocab) against the reference's
    (``hid`` @ ``unembed`` in float32), over the real vocabulary:
    ``rel_rms``, the root mean square of their difference over that of the
    reference's, and ``gap``, the widest gap by which the token the
    program puts first lies below the reference's first, in logits."""
    num = den = 0.0
    gap = 0.0
    wu = unembed[:, :vocab]
    with exact_float32():
        for a in range(0, hid.shape[0], ROW_BLOCK):
            ref = mm(hid[a:a + ROW_BLOCK], wu, "float32")
            g = got[a:a + ROW_BLOCK, :vocab].float()
            num += float(((g - ref) ** 2).sum())
            den += float((ref * ref).sum())
            top = torch.gather(ref, 1, g.argmax(1, keepdim=True))[:, 0]
            gap = max(gap, float((ref.amax(1) - top).max()))
    if not math.isfinite(num):
        return {"rel_rms": math.inf, "gap": math.inf}
    return {"rel_rms": math.sqrt(num / max(den, 1e-30)), "gap": gap}


@torch.no_grad()
def logits(w: Dict[str, torch.Tensor], tokens: torch.Tensor, c: dict,
           precision: str) -> torch.Tensor:
    """The reference in the program's place (the control): (S, vocab)
    logits at ``precision``, rounded to bfloat16 as the program's are."""
    hid = hidden(w, tokens, c, precision)
    out = torch.empty(hid.shape[0], c["vocab_size"], dtype=torch.bfloat16,
                      device=hid.device)
    with exact_float32():
        for a in range(0, hid.shape[0], ROW_BLOCK):
            out[a:a + ROW_BLOCK] = mm(hid[a:a + ROW_BLOCK],
                                      w["unembed"][:, :c["vocab_size"]],
                                      precision).to(torch.bfloat16)
    return out
