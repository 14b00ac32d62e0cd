"""Plain reference of OLMoE-1B-7B-0924's prefill (arXiv:2409.02060; the
published config, huggingface.co/allenai/OLMoE-1B-7B-0924), the weights'
layout it reads, and nothing of the program.

Written from the published description and the weights' names alone, in
plain ``torch`` float32 with TF32 off; it imports neither the program nor
JAX.  Token embedding; per layer RMSNorm, the q, k and v projections,
RMSNorm over the whole q projection and over the whole k projection (each
with its own scale), then the split into heads, rotary positions
(half-split), causal multi-head attention, the output projection and a
residual; RMSNorm, the router's softmax over all experts and its top k,
renormalised only where the configuration's ``norm_topk_prob`` says so,
each chosen (token, expert) pair through that expert's SwiGLU, scaled by
its weight and summed, in a loop over the experts, and a residual; a
final RMSNorm and the untied unembedding.  It runs one prompt at a time,
layer by layer, the attention in blocks of queries
(``dense_lm.attention``).  The router routes by itself, from its own
float32 hidden states, or replays a given routing (the program's), with
the weights of its own softmax at the given experts, and measures how far
that routing lies from its own choice (``moe``'s ``route``).
``precision="fp8"`` is the control: every matrix product, the router's
too, on e4m3 inputs.

Departures from the published model: the vocabulary's rows are padded
(the logits are judged over the published ones, ``dense_lm.judge``); and
two settings it does not have, for tests that hold the program's other
forms to their own reference: ``qk_norm: "head"`` normalises each head
(scales of head_dim) instead of the whole projection, and
``norm_topk_prob: true`` renormalises the top k weights to sum to one.
"""
from __future__ import annotations

from typing import Dict

import torch

from portbench.refs.dense_lm import ROW_BLOCK, attention, rmsnorm, rope
from portbench.refs.precision import exact_float32, mm
from portbench.weights import Layout, padded_vocab


def layout(c: dict) -> Layout:
    """The leaves of an OLMoE decoder (RMSNorm, attention with q and k
    norms over the projections, a router and SwiGLU experts, untied
    unembedding), flattened with ``/`` as the port's tree nests them."""
    d, L = c["hidden_size"], c["num_hidden_layers"]
    f, e, hd = c["intermediate_size"], c["num_experts"], c["head_dim"]
    q, kv = c["num_attention_heads"] * hd, c["num_key_value_heads"] * hd
    v = padded_vocab(c)
    b = "blocks/0/"
    return {
        "embed": ((v, d), "normal"),
        b + "norm1/scale": ((L, d), "scale"),
        b + "attn/wq": ((L, d, q), "normal"),
        b + "attn/wk": ((L, d, kv), "normal"),
        b + "attn/wv": ((L, d, kv), "normal"),
        b + "attn/wo": ((L, q, d), "normal"),
        b + "attn/q_norm": ((L, q), "scale"),
        b + "attn/k_norm": ((L, kv), "scale"),
        b + "norm2/scale": ((L, d), "scale"),
        b + "moe/router": ((L, d, e), "normal"),
        b + "moe/wi_gate": ((L, e, d, f), "normal"),
        b + "moe/wi_up": ((L, e, d, f), "normal"),
        b + "moe/wo": ((L, e, f, d), "normal"),
        "final_norm/scale": ((d,), "scale"),
        "unembed": ((d, v), "normal"),
    }


def moe(a: torch.Tensor, p, c: dict, precision: str,
        route=None) -> torch.Tensor:
    """The expert layer on rows a (S, d) float32; ``p(name)`` the layer's
    leaf ``moe/<name>``.  ``route`` (a dict), where given, holds the
    experts to use (``"idx"``, (S, k)) instead of the router's own top k,
    and takes the largest share by which a given expert's probability
    lies below the k-th largest (``"gap"``); or, without ``"idx"``,
    takes the router's own choice."""
    probs = torch.softmax(mm(a, p("moe/router"), precision), dim=-1)
    top_w, top_i = torch.topk(probs, c["num_experts_per_tok"], dim=-1)
    if route is not None and "idx" in route:
        kth = top_w[:, -1]
        top_i = route["idx"].to(a.device)
        top_w = probs.gather(-1, top_i)
        route["gap"] = float(((kth - top_w.amin(-1)) / kth).max())
    elif route is not None:
        route["idx"] = top_i
    if c["norm_topk_prob"]:
        top_w = top_w / top_w.sum(-1, keepdim=True)
    wg, wu, wo = p("moe/wi_gate"), p("moe/wi_up"), p("moe/wo")
    out = torch.zeros_like(a)
    for e in range(c["num_experts"]):
        tok, slot = (top_i == e).nonzero(as_tuple=True)
        if tok.numel():
            x = a[tok]
            h = torch.nn.functional.silu(mm(x, wg[e], precision))
            h.mul_(mm(x, wu[e], precision))
            out.index_add_(0, tok, mm(h, wo[e], precision)
                           * top_w[tok, slot, None])
    return out


@torch.no_grad()
def hidden(w: Dict[str, torch.Tensor], tokens: torch.Tensor, c: dict,
           precision: str = "float32", routes=None) -> torch.Tensor:
    """The final normed hidden states (S, d), float32, of one prompt
    ``tokens`` (S,); ``routes``, where given, one dict a layer for
    :func:`moe`."""
    eps, hd = c["rms_norm_eps"], c["head_dim"]
    h_n, hk_n = c["num_attention_heads"], c["num_key_value_heads"]
    per_head = c.get("qk_norm") == "head"
    with exact_float32():
        x = w["embed"][tokens.long()].float()
        s = x.shape[0]
        for layer in range(c["num_hidden_layers"]):
            def p(name):
                return w["blocks/0/" + name][layer]
            a = rmsnorm(x, p("norm1/scale"), eps)
            q = mm(a, p("attn/wq"), precision)
            k = mm(a, p("attn/wk"), precision)
            if per_head:
                q, k = q.reshape(s, h_n, hd), k.reshape(s, hk_n, hd)
            q = rmsnorm(q, p("attn/q_norm"), eps)
            k = rmsnorm(k, p("attn/k_norm"), eps)
            q = rope(q.reshape(s, h_n, hd), c["rope_theta"])
            k = rope(k.reshape(s, hk_n, hd), c["rope_theta"])
            v = mm(a, p("attn/wv"), precision).reshape(s, hk_n, hd)
            del a
            o = attention(q, k, v, precision)
            del q, k, v
            x += mm(o, p("attn/wo"), precision)
            del o
            x += moe(rmsnorm(x, p("norm2/scale"), eps), p, c, precision,
                     None if routes is None else routes[layer])
        return rmsnorm(x, w["final_norm/scale"], eps)


@torch.no_grad()
def logits(w: Dict[str, torch.Tensor], tokens: torch.Tensor, c: dict,
           precision: str, routes=None) -> torch.Tensor:
    """The reference in the program's place (the control): (S, vocab)
    logits at ``precision``, rounded to bfloat16 as the program's are."""
    hid = hidden(w, tokens, c, precision, routes)
    out = torch.empty(hid.shape[0], c["vocab_size"], dtype=torch.bfloat16,
                      device=hid.device)
    with exact_float32():
        for a in range(0, hid.shape[0], ROW_BLOCK):
            out[a:a + ROW_BLOCK] = mm(hid[a:a + ROW_BLOCK],
                                      w["unembed"][:, :c["vocab_size"]],
                                      precision).to(torch.bfloat16)
    return out
