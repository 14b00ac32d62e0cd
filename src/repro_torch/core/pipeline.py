"""End-to-end TASTI pipelines over a workload (the prototype system of §6).

``build_tasti(workload, variant=...)``:
  1. FPF-mine a training set over pre-trained embeddings (budget target-DNN
     annotations),
  2. train the embedding DNN with the induced-schema triplet loss (TASTI-T) or
     keep the pre-trained embedder (TASTI-PT),
  3. embed all records, FPF-select cluster representatives (+random mix),
     annotate them, cache top-k distances.

Returned ``TastiSystem`` exposes the paper's query API: proxy scores per
query-specific ``Score`` function, with propagation mode per score type.
Training runs on the build's device with the plain attention route; the
embedding passes, FPF and the index go through the kernels there.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.baselines import pretrain_embedder
from repro_torch.core.embedder import Embedder, EmbedderConfig, embed_all
from repro_torch.core.engine import QueryEngine, QueryResult, QuerySpec
from repro_torch.core.fpf import fpf_select
from repro_torch.core.index import IndexCost, TastiIndex
from repro_torch.core.session import QuerySession, SessionResult
from repro_torch.core.triplet import (TripletConfig, mine_triplets,
                                      train_embedder)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import trace


@dataclass
class TastiConfig:
    n_train: int = 3000            # paper: 3,000 training records (video)
    n_reps: int = 7000             # paper: 7,000 cluster representatives
    k: int = 8
    embed_dim: int = 128           # paper default
    random_fraction: float = 0.1
    triplet: TripletConfig = field(default_factory=TripletConfig)
    pretrain_steps: int = 200
    seed: int = 0


@dataclass
class TastiSystem:
    """Thin facade over :class:`~repro_torch.core.engine.QueryEngine`.

    The declarative path is ``system.execute(QuerySpec(...))``.
    ``proxy_scores`` and ``crack_with`` are shims that share the engine's
    caches (memoized propagation, crack invalidation).  ``oracle`` stays
    deliberately cache-free: its callers count every invocation for benchmark
    comparability — use ``execute`` to get the shared label cache.

    ``build_stats`` (the port's addition) holds, for TASTI-T, the number of
    triples and the triplet loss history.
    """
    index: TastiIndex
    workload: Any
    embed_params: Any
    ecfg: EmbedderConfig
    variant: str
    build_stats: Dict[str, Any] = dataclasses.field(default_factory=dict)
    _engine: Optional[QueryEngine] = dataclasses.field(default=None,
                                                       repr=False)

    @property
    def engine(self) -> QueryEngine:
        if self._engine is None:
            self._engine = QueryEngine(self.index, self.workload)
        return self._engine

    def execute(self, spec: QuerySpec) -> QueryResult:
        return self.engine.execute(spec)

    def session(self, specs=None, **kw) -> QuerySession:
        """A multi-query session over this system's engine: joint planning,
        broker-prefetched labels, combined budget (see
        :mod:`repro_torch.core.session`)."""
        return QuerySession(self.engine, specs, **kw)

    def execute_session(self, specs, **kw) -> SessionResult:
        return self.session(specs, **kw).execute()

    # -- paper §4: query-specific proxy scores (legacy shim) -------------
    def proxy_scores(self, score_fn: Callable[[Any], float],
                     mode: str = "numeric",
                     n_classes: Optional[int] = None) -> np.ndarray:
        """Propagated proxy scores, memoized by the engine.
        ``mode``: "numeric" | "top1" | "categorical" (needs ``n_classes``)."""
        return self.engine.proxy_scores(score_fn, mode=mode,
                                        n_classes=n_classes)

    def oracle(self, score_fn: Callable[[Any], float],
               counter: Optional[list] = None) -> Callable:
        wl = self.workload

        def call(ids: np.ndarray) -> np.ndarray:
            if counter is not None:
                counter.append(len(ids))
            return np.asarray([score_fn(s) for s in wl.target_dnn_batch(ids)])

        return call

    def crack_with(self, ids: np.ndarray) -> None:
        self.engine.crack_with(np.asarray(ids, np.int64))


def cli_tasti_config(quick: bool = False, n_train: int = 400,
                     n_reps: int = 800, k: int = 8,
                     triplet_steps: int = 400) -> TastiConfig:
    """The build budgets shared by the query/serving CLIs and the workload
    registry: one ``--quick`` smoke configuration (tiny budgets for CI),
    else the given knobs at their common CLI defaults."""
    if quick:
        return TastiConfig(n_train=100, n_reps=200, k=4,
                           triplet=TripletConfig(steps=60, batch=128),
                           pretrain_steps=40)
    return TastiConfig(n_train=n_train, n_reps=n_reps, k=k,
                       triplet=TripletConfig(steps=triplet_steps))


def build_tasti(workload, cfg: Optional[TastiConfig] = None,
                variant: str = "T",
                use_fpf_mining: bool = True,
                use_fpf_clustering: bool = True,
                embed_params: Optional[Dict[str, torch.Tensor]] = None,
                device: DeviceLike = None,
                embedder: Optional[EmbedderConfig] = None) -> TastiSystem:
    """variant: "T" (triplet-trained) | "PT" (pre-trained only).
    ``embed_params``, an :class:`~repro_torch.core.embedder.Embedder` state
    dict (see :func:`~repro_torch.core.embedder.params_from_jax`), skips
    pre-training.  ``embedder`` picks the embedder, e.g.
    ``EmbedderConfig(backbone="tasti-embedder")``; by default the MLP at the
    workload's feature width."""
    dev = resolve_device(device)
    cfg = cfg or TastiConfig()
    cost = IndexCost()
    feats = workload.features
    ecfg = embedder or EmbedderConfig(feature_dim=feats.shape[1],
                                      embed_dim=cfg.embed_dim)
    if ecfg.feature_dim != feats.shape[1] or ecfg.embed_dim != cfg.embed_dim:
        raise ValueError(f"embedder {ecfg} does not map the workload's "
                         f"{feats.shape[1]} features to {cfg.embed_dim}")
    stats: Dict[str, Any] = {}

    with trace.span("tasti.build", records=len(feats), variant=variant):
        # 1) pre-trained embeddings (generic self-supervision; no schema
        # access)
        if embed_params is None:
            model = pretrain_embedder(feats, ecfg, steps=cfg.pretrain_steps,
                                      seed=cfg.seed, device=dev)
        else:
            with trace.span("tasti.load"):
                model = Embedder(ecfg)
                # the given leaves that load_state_dict brings to the host
                trace.count("d2h_bytes", sum(v.nbytes for v in
                                             embed_params.values()
                                             if v.device.type != "cpu"))
                model.load_state_dict(embed_params)
                model.to(dev)
                trace.count("h2d_bytes", sum(v.nbytes for v in
                                             model.state_dict().values()))
        cost.embed_records += len(feats)
        embeddings = embed_all(model, feats)

        if variant == "T":
            # 2) FPF-mine the training set, annotate with the target DNN
            if use_fpf_mining:
                train_ids = fpf_select(embeddings, cfg.n_train,
                                       random_fraction=cfg.random_fraction,
                                       seed=cfg.seed, device=dev)
            else:
                rng = np.random.default_rng(cfg.seed)
                train_ids = rng.choice(len(feats),
                                       size=min(cfg.n_train, len(feats)),
                                       replace=False)
            # annotations for closeness
            cost.target_invocations += len(train_ids)
            rng = np.random.default_rng(cfg.seed + 1)
            triples = mine_triplets(train_ids, workload.is_close, rng,
                                    max_triplets=cfg.triplet.max_triplets)
            _, history = train_embedder(model, feats[train_ids], triples,
                                        cfg.triplet)
            cost.training_steps += cfg.triplet.steps
            stats.update(n_triples=len(triples), triplet_losses=history)
            # 3) embed all records with the trained embedder
            embeddings = embed_all(model, feats)
        # the PT branch keeps the pre-trained embeddings: the JAX package
        # embeds a second time with the same weights; the cost model counts
        # both passes
        cost.embed_records += len(feats)

        def annotate(ids):
            return workload.target_dnn_batch(np.asarray(ids, np.int64))

        index = TastiIndex.build(
            embeddings, cfg.n_reps, annotate, k=cfg.k,
            random_fraction=cfg.random_fraction, seed=cfg.seed, cost=cost,
            rep_selection="fpf" if use_fpf_clustering else "random",
            device=dev)
        params = (embed_params if embed_params is not None and variant != "T"
                  else {k: v.detach().cpu() for k, v in
                        model.state_dict().items()})
    return TastiSystem(index=index, workload=workload, embed_params=params,
                       ecfg=ecfg, variant=variant, build_stats=stats)
