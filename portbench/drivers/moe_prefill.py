"""Closed-loop prefills of a mixture-of-experts decoder (OLMoE): each unit
is one batch of seeded prompts through the port's
``repro_torch.train.steps.make_prefill_step``, the prompts of unit i drawn
from (seed, i); the prefill driver's contract (``drivers/prefill.py``)
with the MoE's weights, FLOPs and reference.  Set-up draws the model's
weights on the device from the seed in the type they are served in
(``refs.moe_lm.layout``), checks that the port's leaves have those
shapes, and warms up with a batch of its own prompts.

One unit of the window, drawn from the seed among the first ``min_units``,
keeps its logits and the program's routing (the experts each layer chose,
handed over by ``repro_torch.models.moe.recorded_routing``); once the
window has closed and the program's state is freed, the weights are drawn
again and the plain reference (``portbench.refs.moe_lm``) judges every
prompt of that unit.  The reference replays the program's routing, so
that the logits are held to what rounding alone moves, and judges the
routing itself (``route_gap``): where a token's bfloat16 router logits lie
within rounding of each other, the program and a float32 reference pick
different experts, and a free-routing comparison then reads such flips
as error larger than a missing expert's (PERF.md §6)."""
from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from portbench import weights as W
from portbench.drivers import prefill
from portbench.peaks import FLOPS
from portbench.refs import dense_lm
from portbench.refs import moe_lm as ref

#: the port's ModelConfig field of each key of the configuration file
FIELDS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
          "num_attention_heads": "n_heads",
          "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim",
          "intermediate_size": "moe_d_ff", "num_experts": "n_experts",
          "num_experts_per_tok": "top_k", "vocab_size": "vocab_size",
          "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
          "tie_word_embeddings": "tie_embeddings",
          "vocab_pad_multiple": "vocab_pad_multiple"}


def model_config(c: dict):
    """The port's config of configuration ``c``: its ``port.arch`` with
    every size as the file states it; it has to route as the file says
    (dropless, renormalised or not as ``norm_topk_prob``) and normalise q
    and k over the whole projections."""
    from repro_torch.configs import get_config
    base = get_config(c["port"]["arch"])
    cfg = dataclasses.replace(base, **{f: c[k] for k, f in FIELDS.items()})
    if cfg.dtype != c["torch_dtype"] or cfg.param_dtype != c["torch_dtype"]:
        raise ValueError(f"{cfg.name} runs {cfg.dtype}, the configuration "
                         f"says {c['torch_dtype']}")
    if (not getattr(cfg, "moe_dropless", False)
            or getattr(cfg, "router_renormalize", True) != c["norm_topk_prob"]
            or not cfg.qk_norm or not getattr(cfg, "qk_norm_whole", False)
            or cfg.sliding_window or cfg.encoder_decoder or cfg.mrope_sections
            or cfg.logit_softcap or len(cfg.pattern) != 1
            or cfg.pattern[0].mixer != "attn" or cfg.pattern[0].mlp != "moe"):
        raise ValueError(f"{cfg.name} is not an OLMoE decoder as published")
    return cfg


def moe_decoder_flops(c: dict, batch: int, seq: int, vocab: int) -> float:
    """Model FLOPs of a prefill of ``batch`` x ``seq`` tokens, counted as
    ``portbench.flops.dense_decoder_flops`` counts a dense decoder: each
    layer's norms and residuals (6 an element of the hidden states) and
    the q and k norms (2 an element), every matrix product of the
    attention, the scores and P.V at causal attention's (S + 1) / 2 keys a
    query, the router, and for each of the T k (token, choice) rows the
    expert's three products (6 d f), its gating (4 f) and its weighted
    sum (2 d); the unembedding at ``vocab``."""
    t = float(batch * seq)
    d, f, e = c["hidden_size"], c["intermediate_size"], c["num_experts"]
    hd, k = c["head_dim"], c["num_experts_per_tok"]
    qd = c["num_attention_heads"] * hd
    kvd = c["num_key_value_heads"] * hd
    keys = (seq + 1) / 2
    layer = (6.0 * t * d                      # norms, residuals
             + 2.0 * t * (qd + kvd)           # q and k norms
             + 2.0 * t * d * qd               # q
             + 2.0 * 2.0 * t * d * kvd        # k, v
             + 2.0 * t * qd * d               # out
             + 4.0 * t * keys * qd            # scores, P.V
             + 2.0 * t * d * e                # router
             + t * k * (6.0 * d * f           # gate, up, down
                        + 4.0 * f             # SiLU and the product
                        + 2.0 * d))           # weighted sum
    return c["num_hidden_layers"] * layer + 2.0 * t * d * vocab


class Driver(prefill.Driver):

    def _weights(self):
        return W.draw(ref.layout(self.c),
                      W.generator(self.dev, self.seed, W.MODEL),
                      getattr(torch, self.c["torch_dtype"]), self.dev)

    def setup(self) -> None:
        from repro_torch.models import lm, moe
        from repro_torch.models.common import tree_leaves_with_names
        from repro_torch.train.steps import make_prefill_step
        self.cfg = model_config(self.c)
        want = {k: tuple(s.shape) for k, s in
                tree_leaves_with_names(lm.model_specs(self.cfg))}
        have = {k: s for k, (s, _) in ref.layout(self.c).items()}
        if want != have:
            raise ValueError(f"the port's leaves {want} are not the "
                             f"benchmark's {have}")
        self.recorded_routing = moe.recorded_routing
        self.step = make_prefill_step(self.cfg)
        self.flat = self._weights()
        self.params = W.nest(self.flat)
        self.keep_at = int(np.random.default_rng(
            W.stream_seed(self.seed, prefill.CHECK)).integers(
                int(self.t["min_units"])))
        self.step(self.params, {"tokens": self._tokens(-1)})
        self._sync()

    def unit(self, i: int) -> float:
        tokens = self._tokens(i)
        keep = i == self.keep_at
        if self.precision is None:
            with (self.recorded_routing() if keep
                  else contextlib.nullcontext()) as routing:
                logits = self.step(self.params, {"tokens": tokens})
        else:
            routes = [[{} for _ in range(self.c["num_hidden_layers"])]
                      for _ in range(self.batch)]
            logits = torch.stack([ref.logits(self.flat, tokens[b], self.c,
                                             self.precision, routes[b])
                                  for b in range(self.batch)])
            routing = [torch.cat([r[layer]["idx"] for r in routes])
                       for layer in range(len(routes[0]))]
        self._sync()
        if keep:
            self.kept, self.kept_routing = logits, routing
        return float(self.batch * self.seq)

    def shape(self) -> dict:
        """The step's shapes, and the least seconds its model FLOPs (at
        the published vocabulary) take at the card's peak for its type."""
        c = self.c
        flops = moe_decoder_flops(c, self.batch, self.seq, c["vocab_size"])
        return {"batch": self.batch, "seq": self.seq,
                "heads": c["num_attention_heads"],
                "kv_heads": c["num_key_value_heads"],
                "head_dim": c["head_dim"], "hidden_size": c["hidden_size"],
                "n_experts": c["num_experts"],
                "top_k": c["num_experts_per_tok"],
                "moe_d_ff": c["intermediate_size"],
                "layers": c["num_hidden_layers"],
                "peak_seconds_per_unit": flops / FLOPS[c["torch_dtype"]]}

    def check(self, units: int) -> dict:
        """Every prompt of the kept unit against the reference replaying
        the program's routing: ``logits_rel_rms`` and ``argmax_gap``
        (``dense_lm.judge``), and ``route_gap``, the largest share by which
        an expert the program chose lies below the reference's k-th
        largest router probability."""
        b_n, s_n = self.batch, self.seq
        got, routing = self.kept, getattr(self, "kept_routing", None)
        shape = (b_n * s_n, self.c["num_experts_per_tok"])
        if (got is None or tuple(got.shape[:2]) != (b_n, s_n)
                or routing is None
                or len(routing) != self.c["num_hidden_layers"]
                or any(tuple(r.shape) != shape for r in routing)):
            return {"logits_rel_rms": math.inf, "argmax_gap": math.inf,
                    "route_gap": math.inf}
        w = self._weights()
        tokens = self._tokens(self.keep_at)
        out = {"logits_rel_rms": 0.0, "argmax_gap": 0.0, "route_gap": 0.0}
        for b in range(b_n):
            routes = [{"idx": r.view(b_n, s_n, -1)[b]} for r in routing]
            hid = ref.hidden(w, tokens[b], self.c, routes=routes)
            j = dense_lm.judge(got[b], hid, w["unembed"], self.c["vocab_size"])
            del hid
            out = {"logits_rel_rms": max(out["logits_rel_rms"], j["rel_rms"]),
                   "argmax_gap": max(out["argmax_gap"], j["gap"]),
                   "route_gap": max([out["route_gap"]]
                                    + [r["gap"] for r in routes])}
        return out
