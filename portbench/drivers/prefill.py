"""Closed-loop prefills: each unit is one batch of seeded prompts through
the port's ``repro_torch.train.steps.make_prefill_step``, the prompts of
unit i drawn from (seed, i).  Set-up draws the model's weights on the
device from the seed, in the type they are served in, and warms up with a
batch of its own prompts.

One unit of the window, drawn from the seed before it starts among the
first ``min_units`` (which every window runs), keeps its logits; once the
window has closed and the program's state is freed, the weights are drawn
again and the plain reference (``portbench.refs.dense_lm``) judges those
logits, every prompt of the batch."""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from portbench import weights as W
from portbench.flops import dense_decoder_flops
from portbench.peaks import FLOPS
from portbench.refs import dense_lm as ref

#: salt of this driver's own stream
CHECK = 21

#: the port's ModelConfig field of each key of the configuration file
FIELDS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
          "num_attention_heads": "n_heads",
          "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim",
          "intermediate_size": "d_ff", "vocab_size": "vocab_size",
          "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
          "tie_word_embeddings": "tie_embeddings",
          "vocab_pad_multiple": "vocab_pad_multiple",
          "torch_dtype": "dtype"}


def model_config(c: dict):
    """The port's ModelConfig of configuration ``c``: its ``port.arch``
    with every size as the file states it, and nothing else changed."""
    from repro_torch.configs import get_config
    base = get_config(c["port"]["arch"])
    new = {f: c[k] for k, f in FIELDS.items() if f != "dtype"}
    cfg = dataclasses.replace(base, **new)
    if cfg.dtype != c["torch_dtype"] or cfg.param_dtype != c["torch_dtype"]:
        raise ValueError(f"{cfg.name} runs {cfg.dtype}, the configuration "
                         f"says {c['torch_dtype']}")
    if (cfg.sliding_window or cfg.qk_norm or cfg.n_experts
            or cfg.encoder_decoder or cfg.mrope_sections
            or cfg.logit_softcap or len(cfg.pattern) != 1
            or cfg.pattern[0].mixer != "attn" or cfg.pattern[0].mlp != "dense"):
        raise ValueError(f"{cfg.name} is not a plain dense decoder")
    return cfg


class Driver:
    #: None to drive the program; a precision of ``refs.precision`` to put
    #: the reference in its place at that precision (the control)
    precision = None

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.c, self.t, self.seed, self.dev = config, traffic, seed, device
        self.batch, self.seq = int(traffic["batch"]), int(traffic["seq_len"])
        self.kept = None

    def stated_precision(self) -> str:
        return self.c["torch_dtype"]

    def _weights(self):
        return W.draw(W.dense_lm_layout(self.c),
                      W.generator(self.dev, self.seed, W.MODEL),
                      getattr(torch, self.c["torch_dtype"]), self.dev)

    def _tokens(self, unit: int) -> torch.Tensor:
        return torch.randint(
            0, self.c["vocab_size"], (self.batch, self.seq),
            generator=W.generator(self.dev, self.seed, W.TOKENS, unit),
            device=self.dev)

    def setup(self) -> None:
        from repro_torch.models import lm
        from repro_torch.models.common import tree_leaves_with_names
        from repro_torch.train.steps import make_prefill_step
        self.cfg = model_config(self.c)
        want = {k: tuple(s.shape) for k, s in
                tree_leaves_with_names(lm.model_specs(self.cfg))}
        have = {k: s for k, (s, _) in W.dense_lm_layout(self.c).items()}
        if want != have:
            raise ValueError(f"the port's leaves {want} are not the "
                             f"benchmark's {have}")
        self.step = make_prefill_step(self.cfg)
        self.flat = self._weights()
        self.params = W.nest(self.flat)
        self.keep_at = int(np.random.default_rng(
            W.stream_seed(self.seed, CHECK)).integers(
                int(self.t["min_units"])))
        self.step(self.params, {"tokens": self._tokens(-1)})
        self._sync()

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def unit(self, i: int) -> float:
        if self.precision is not None:
            tokens = self._tokens(i)
            logits = torch.stack([
                ref.logits(self.flat, tokens[b], self.c, self.precision)
                for b in range(self.batch)])
        else:
            logits = self.step(self.params, {"tokens": self._tokens(i)})
        self._sync()
        if i == self.keep_at:
            self.kept = logits
        return float(self.batch * self.seq)

    def shape(self) -> dict:
        """The step's shapes, and the least seconds its model FLOPs (at
        the published vocabulary) take at the card's peak for its type."""
        c = self.c
        flops = dense_decoder_flops(c, self.batch, self.seq, c["vocab_size"])
        return {"batch": self.batch, "seq": self.seq,
                "heads": c["num_attention_heads"],
                "kv_heads": c["num_key_value_heads"],
                "head_dim": c["head_dim"],
                "peak_seconds_per_unit": flops / FLOPS[c["torch_dtype"]]}

    def probes(self) -> dict:
        return {}

    def free(self) -> None:
        self.params = self.flat = self.step = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def checked_units(self, units: int) -> list:
        """The unit of the window whose logits the check reads."""
        return [self.keep_at]

    def check(self, units: int) -> dict:
        got = self.kept
        if got is None or tuple(got.shape[:2]) != (self.batch, self.seq):
            return {"logits_rel_rms": math.inf, "argmax_gap": math.inf}
        w = self._weights()
        tokens = self._tokens(self.keep_at)
        out = {"logits_rel_rms": 0.0, "argmax_gap": 0.0}
        for b in range(self.batch):
            hid = ref.hidden(w, tokens[b], self.c)
            j = ref.judge(got[b], hid, w["unembed"], self.c["vocab_size"])
            del hid
            out = {"logits_rel_rms": max(out["logits_rel_rms"], j["rel_rms"]),
                   "argmax_gap": max(out["argmax_gap"], j["gap"])}
        return out
