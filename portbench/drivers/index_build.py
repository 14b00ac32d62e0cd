"""Closed-loop index builds: each unit is one whole TASTI-PT build
(``repro_torch.core.pipeline.build_tasti``) over all the configuration's
records, with embedder weights drawn from (seed, unit), so that no build
can reuse another's result.  Set-up makes the records on the device and
warms up with a build of its own weights.

The check holds a sample of the window's builds, drawn from the seed, to
the plain reference (``portbench.refs.tasti``): the embeddings, each FPF
pick, the start and random picks, the annotations and each record's top-k
ids and squared distances."""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import weights as W
from portbench.flops import embedder_flops
from portbench.peaks import FLOPS
from portbench.records import Records
from portbench.refs import tasti as ref

#: salts of this driver's own streams
TASTI, CHECK = 11, 12


class Driver:
    #: None to drive the program; a precision of ``refs.precision`` to put
    #: the reference in its place at that precision (the control)
    precision = None

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.c, self.t, self.seed, self.dev = config, traffic, seed, device
        self.e = config["embedder"]
        self.x = config["tasti"]
        self.n = int(config["records"]["n_frames"])
        self.outputs = {}

    def stated_precision(self) -> str:
        return self.e["dtype"]

    # -- inputs -----------------------------------------------------------
    def _weights(self, unit: int):
        return W.draw(W.embedder_layout(self.e),
                      W.generator(self.dev, self.seed, W.EMBEDDER, unit),
                      torch.float32, self.dev)

    def _tasti_seed(self, unit: int) -> int:
        return W.stream_seed(self.seed, TASTI, unit) % 2 ** 32

    def _ecfg(self):
        from repro_torch.configs import get_config
        from repro_torch.core.embedder import EmbedderConfig
        e = self.e
        bb = get_config(e["backbone"])
        got = dict(n_layers=bb.n_layers, d_model=bb.d_model,
                   n_heads=bb.n_heads, n_kv_heads=bb.n_kv_heads,
                   head_dim=bb.resolved_head_dim, d_ff=bb.d_ff,
                   norm_eps=bb.norm_eps, dtype=bb.dtype)
        want = {k: e[k] for k in got}
        if got != want:
            raise ValueError(f"the port's {e['backbone']} is {got}, the "
                             f"configuration says {want}")
        return EmbedderConfig(feature_dim=e["feature_dim"],
                              embed_dim=e["embed_dim"],
                              backbone=e["backbone"],
                              seq_tokens=e["seq_tokens"])

    def setup(self) -> None:
        from repro_torch.core.embedder import Embedder
        self.ecfg = self._ecfg()
        want = {k: tuple(v.shape) for k, v in
                Embedder(self.ecfg).state_dict().items()}
        have = {k: s for k, (s, _) in W.embedder_layout(self.e).items()}
        if want != have:
            raise ValueError(f"the port's embedder leaves {want} are not "
                             f"the benchmark's {have}")
        self.records = Records(self.c["records"],
                               W.stream_seed(self.seed, W.RECORDS), self.dev)
        self._build(-1)
        self._sync()

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def _build(self, unit: int):
        from repro_torch.core.pipeline import TastiConfig, build_tasti
        x = self.x
        cfg = TastiConfig(n_reps=x["n_reps"], k=x["k"],
                          embed_dim=self.e["embed_dim"],
                          random_fraction=x["random_fraction"],
                          seed=self._tasti_seed(unit))
        return build_tasti(self.records, cfg, variant=x["variant"],
                           embed_params=self._weights(unit),
                           device=self.dev, embedder=self.ecfg)

    # -- the window -------------------------------------------------------
    def unit(self, i: int) -> float:
        if self.precision is not None:
            feats = torch.as_tensor(self.records.features, device=self.dev)
            emb, rep_ids, ids, d2 = ref.build(
                self._weights(i), feats, self.e, self.x, self._tasti_seed(i),
                self.precision)
            self.outputs[i] = (emb.cpu().numpy(), rep_ids,
                               self.records.target_dnn_batch(rep_ids), ids,
                               d2)
            return float(self.n)
        system = self._build(i)
        self._sync()
        ix = system.index
        self.outputs[i] = (ix.embeddings, np.asarray(ix.rep_ids),
                           list(ix.annotations), np.asarray(ix.topk_ids),
                           np.asarray(ix.topk_d2))
        return float(self.n)

    def shape(self) -> dict:
        """The build's shapes, and the least seconds its model FLOPs take
        at the card's peaks: the embedder's and FPF's float32 at float32's,
        the top-k distances' at TF32's (as ``distance_topk_roofline``)."""
        x, n, d = self.x, self.n, self.e["embed_dim"]
        fpf_steps = x["n_reps"] - int(round(x["n_reps"]
                                            * x["random_fraction"])) - 1
        f32 = n * embedder_flops(self.e) + fpf_steps * 3.0 * n * d
        tf32 = 2.0 * n * x["n_reps"] * d
        return {"records": n, "embed_dim": d, "reps": x["n_reps"],
                "k": x["k"], "fpf_steps": fpf_steps,
                "peak_seconds_per_unit": (f32 / FLOPS["float32"]
                                          + tf32 / FLOPS["tf32"])}

    def probes(self) -> dict:
        return {"embed_records_per_s": self._embed_alone}

    def _embed_alone(self) -> float:
        """Records per second of the port's ``embed_all`` over the cell's
        records with one build's weights, alone, by a synchronised host
        clock."""
        from repro_torch.core.embedder import Embedder, embed_all
        model = Embedder(self.ecfg)
        model.load_state_dict(self._weights(0))
        model.to(self.dev)
        self._sync()
        t0 = time.perf_counter()
        embed_all(model, self.records.features)
        self._sync()
        return self.n / (time.perf_counter() - t0)

    def free(self) -> None:
        self.records = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check --------------------------------------------------------
    def checked_units(self, units: int) -> list:
        """The builds of a window of ``units`` that the check reads: a
        sample drawn from the seed."""
        rng = np.random.default_rng(W.stream_seed(self.seed, CHECK))
        return sorted(int(s) for s in rng.choice(
            units, size=min(int(self.t["check_units"]), units),
            replace=False))

    def check(self, units: int) -> dict:
        x = self.x
        recs = Records(self.c["records"], W.stream_seed(self.seed, W.RECORDS),
                       self.dev)
        feats = torch.as_tensor(recs.features, device=self.dev)
        n_fpf = x["n_reps"] - int(round(x["n_reps"] * x["random_fraction"]))
        out = {}
        for i in self.checked_units(units):
            emb, rep_ids, annotations, ids, d2 = self.outputs[i]
            want = ref.embed(self._weights(i), feats, self.e)
            got = torch.as_tensor(np.asarray(emb), device=self.dev)
            rms = float(torch.sqrt((want * want).mean()))
            err = (float((got.float() - want).abs().max()) / rms
                   if got.shape == want.shape else math.inf)
            reading = {
                "embed_err": err,
                "fpf_gap": ref.fpf_gap(want, rep_ids[:n_fpf]),
                "random_picks": ref.random_picks(
                    rep_ids, self.n, x["n_reps"], x["random_fraction"],
                    self._tasti_seed(i)),
                "annotations": ref.annotations_wrong(
                    annotations, rep_ids,
                    recs.target_dnn_batch(np.clip(rep_ids, 0, self.n - 1))),
            }
            tk = ref.topk(want, rep_ids, ids, d2)
            reading["topk_rank"], reading["topk_d2"] = tk["rank"], tk["d2"]
            for k, v in reading.items():
                out[k] = max(out.get(k, -math.inf), float(v))
        return out
