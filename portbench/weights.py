"""Seeded weights and inputs, drawn on the device in the type they are
served in, one call a leaf.

Each leaf is normal / sqrt(fan_in), fan_in its second-to-last dim (a
stacked (layers, in, out) leaf scales by ``in``), as the port's
``init_params`` draws them; a norm's scale is 1 + 0.1 * normal, so that a
program that ignored it would not agree with the reference.  The layouts
are written out here, leaf by leaf, so that the reference reads the same
names without the program; the drivers check that the program's own specs
have the same shapes.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

#: salts that keep the streams of one seed apart
RECORDS, EMBEDDER, MODEL, TOKENS = 1, 2, 3, 4


def stream_seed(seed: int, salt: int, unit: int = 0) -> int:
    """A 63-bit generator seed for (run seed, stream, unit of work)."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, salt,
                                 int(unit) % 2 ** 64])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(device, seed: int, salt: int, unit: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, salt, unit))


Layout = Dict[str, Tuple[Tuple[int, ...], str]]


def embedder_layout(e: dict) -> Layout:
    """The transformer embedder's leaves under the port's state-dict names
    (``params.<path>``): (shape, "normal" | "scale")."""
    d, L, f = e["d_model"], e["n_layers"], e["d_ff"]
    q = e["n_heads"] * e["head_dim"]
    kv = e["n_kv_heads"] * e["head_dim"]
    tok = e["feature_dim"] // e["seq_tokens"]
    b = "params.blocks.0."
    return {
        "params.proj_in": ((tok, d), "normal"),
        b + "norm1.scale": ((L, d), "scale"),
        b + "attn.wq": ((L, d, q), "normal"),
        b + "attn.wk": ((L, d, kv), "normal"),
        b + "attn.wv": ((L, d, kv), "normal"),
        b + "attn.wo": ((L, q, d), "normal"),
        b + "norm2.scale": ((L, d), "scale"),
        b + "mlp.wi_gate": ((L, d, f), "normal"),
        b + "mlp.wi_up": ((L, d, f), "normal"),
        b + "mlp.wo": ((L, f, d), "normal"),
        "params.proj_out": ((d, e["embed_dim"]), "normal"),
    }


def padded_vocab(c: dict) -> int:
    m = c["vocab_pad_multiple"]
    return -(-c["vocab_size"] // m) * m


def dense_lm_layout(c: dict) -> Layout:
    """A dense decoder's leaves (RMSNorm, GQA attention, SwiGLU MLP,
    untied unembedding), flattened with ``/`` as the port's tree nests
    them."""
    d, L, f = c["hidden_size"], c["num_hidden_layers"], c["intermediate_size"]
    hd = c["head_dim"]
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
        b + "norm2/scale": ((L, d), "scale"),
        b + "mlp/wi_gate": ((L, d, f), "normal"),
        b + "mlp/wi_up": ((L, d, f), "normal"),
        b + "mlp/wo": ((L, f, d), "normal"),
        "final_norm/scale": ((d,), "scale"),
        "unembed": ((d, v), "normal"),
    }


def draw(layout: Layout, g: torch.Generator, dtype: torch.dtype,
         device) -> Dict[str, torch.Tensor]:
    """Every leaf of ``layout`` from ``g``, in layout order."""
    out = {}
    for name, (shape, kind) in layout.items():
        t = torch.randn(shape, generator=g, dtype=dtype, device=device)
        if kind == "scale":
            t.mul_(0.1).add_(1.0)
        else:
            t.mul_(1.0 / np.sqrt(max(shape[-2], 1)))
        out[name] = t
    return out


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """A flat ``a/b/c`` dict as the port's tree: dicts, with a numeric key
    making a tuple."""
    root: dict = {}
    for name, t in flat.items():
        node = root
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return tuple(fix(node[str(i)]) for i in range(len(node)))
        return {k: fix(v) for k, v in node.items()}

    return fix(root)
