"""Model FLOPs, frozen here so that ``mfu`` does not move when the
program does.

``dense_decoder_flops`` is a copy of the operation count of the port's
``launch/analytic.py`` ``forward_cost`` for a decoder of attention and
dense SwiGLU layers: every matrix product of the forward, the scores and
P.V at causal attention's (S + 1) / 2 keys a query, six operations an
element of a layer's norms and residuals and four an element of the MLP's
gating.  The unembedding is counted at the vocabulary it is given (the
published one, not the padded).  ``embedder_flops`` counts the
transformer embedder the same way."""
from __future__ import annotations


def dense_decoder_flops(c: dict, batch: int, seq: int, vocab: int) -> float:
    t = float(batch * seq)
    d, f = c["hidden_size"], c["intermediate_size"]
    hd = c["head_dim"]
    qd = c["num_attention_heads"] * hd
    kvd = c["num_key_value_heads"] * hd
    keys = (seq + 1) / 2
    layer = (6.0 * t * d                      # norms, residuals
             + 2.0 * t * d * qd               # q
             + 2.0 * 2.0 * t * d * kvd        # k, v
             + 2.0 * t * qd * d               # out
             + 4.0 * t * keys * qd            # scores, P.V
             + 2.0 * 2.0 * t * d * f          # gate, up
             + 2.0 * t * f * d                # down
             + 4.0 * t * f)                   # SiLU and the product
    return c["num_hidden_layers"] * layer + 2.0 * t * d * vocab


def embedder_flops(e: dict) -> float:
    """Model FLOPs of the transformer embedder on one record: the token
    projection, per layer and token the norms and residuals (6 d), q, k,
    v and out, the scores and P.V over all the record's tokens
    (bidirectional), the SwiGLU MLP, and the output projection."""
    s, d, f = e["seq_tokens"], e["d_model"], e["d_ff"]
    qd = e["n_heads"] * e["head_dim"]
    kvd = e["n_kv_heads"] * e["head_dim"]
    tok = e["feature_dim"] // s
    layer = (6.0 * d + 2.0 * d * qd + 4.0 * d * kvd + 2.0 * qd * d
             + 4.0 * s * qd + 6.0 * d * f + 4.0 * f)
    return (2.0 * s * tok * d + e["n_layers"] * s * layer
            + 2.0 * d * e["embed_dim"])
