"""End-to-end TASTI pipelines over a workload (the prototype system of §6).

``build_tasti(workload, variant="PT", embed_params=...)`` embeds every
record with the given embedder weights, FPF-selects cluster
representatives (+random mix), annotates them and caches top-k distances.
The returned ``TastiSystem`` exposes the paper's query API: proxy scores per
query-specific ``Score`` function, with propagation mode per score type.

The branches that train — ``variant="T"`` (triplet-trained embedder) and
``embed_params=None`` (pre-training) — wait for the training slice of the
port and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.embedder import Embedder, EmbedderConfig, embed_all
from repro_torch.core.engine import QueryEngine, QueryResult, QuerySpec
from repro_torch.core.index import IndexCost, TastiIndex
from repro_torch.core.session import QuerySession, SessionResult
from repro_torch.core.triplet import TripletConfig
from repro_torch.device import DeviceLike, resolve_device


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
    """
    index: TastiIndex
    workload: Any
    embed_params: Any
    ecfg: EmbedderConfig
    variant: str
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
    """variant: "PT" (pre-trained only) with ``embed_params``, an
    :class:`~repro_torch.core.embedder.Embedder` state dict (see
    :func:`~repro_torch.core.embedder.params_from_jax`).  ``embedder``
    picks the embedder, e.g. ``EmbedderConfig(backbone="tasti-embedder")``;
    by default the MLP at the workload's feature width."""
    if variant == "T":
        raise NotImplementedError(
            "variant='T' trains the embedder with the triplet loss; it waits "
            "for the training slice of the port (use variant='PT' with "
            "embed_params)")
    if embed_params is None:
        raise NotImplementedError(
            "embed_params=None pre-trains the embedder; it waits for the "
            "training slice of the port (pass embedder weights)")
    dev = resolve_device(device)
    cfg = cfg or TastiConfig()
    cost = IndexCost()
    feats = workload.features
    ecfg = embedder or EmbedderConfig(feature_dim=feats.shape[1],
                                      embed_dim=cfg.embed_dim)
    if ecfg.feature_dim != feats.shape[1] or ecfg.embed_dim != cfg.embed_dim:
        raise ValueError(f"embedder {ecfg} does not map the workload's "
                         f"{feats.shape[1]} features to {cfg.embed_dim}")
    model = Embedder(ecfg)
    model.load_state_dict(embed_params)
    model.to(dev)

    # the JAX package embeds twice on this branch (the pre-trained pass and
    # the final pass, with the same weights); the cost model counts both,
    # the port computes once
    embeddings = embed_all(model, feats)
    cost.embed_records += 2 * len(feats)

    def annotate(ids):
        return workload.target_dnn_batch(np.asarray(ids, np.int64))

    index = TastiIndex.build(
        embeddings, cfg.n_reps, annotate, k=cfg.k,
        random_fraction=cfg.random_fraction, seed=cfg.seed, cost=cost,
        rep_selection="fpf" if use_fpf_clustering else "random", device=dev)
    return TastiSystem(index=index, workload=workload,
                       embed_params=embed_params, ecfg=ecfg, variant=variant)
