"""Declarative query engine: ``QuerySpec`` -> ``QueryPlan`` -> ``QueryResult``.

The paper's core promise is one semantic index serving *many* query types
(aggregation §4.3, selection §4.3/SUPG, limit §4.3) without per-query proxies.
This module is the query layer that delivers that promise as an API: callers
describe the query declaratively and the engine owns everything they used to
hand-assemble —

* **memoized proxy scores**: propagation (§4.2) runs once per
  ``(score function, mode)`` across queries and is invalidated when the index
  is cracked;
* **automatic propagation choice** per query kind: numeric for aggregation,
  top-1 with distance tie-breaks for limit queries (§6.3), clipped-numeric
  for SUPG selection, with ``categorical`` available as an explicit mode;
* **a shared oracle-label cache**: records annotated by the target DNN for one
  query are free for every later query, whatever its score function;
* **an opt-in cracking feedback loop** (§3.3): every fresh target-DNN
  annotation a query makes can be folded straight back into the index.

Query kinds are pluggable through :mod:`repro_torch.core.queries.registry`; the
numerical kernels stay in ``repro_torch.core.queries.*`` and remain callable
directly (legacy shims).

    engine = QueryEngine(index, workload)
    res = engine.execute(QuerySpec(kind="aggregation", score="score_count",
                                   err=0.05))
    res.estimate, res.n_invocations, res.plan.trace
"""
from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

# importing repro_torch.core.queries registers the built-in executors
from repro_torch.core import propagation, queries as _queries, schema as schema_lib  # noqa: F401
from repro_torch.core.broker import OracleAccount, OracleBroker
from repro_torch.core.index import TastiIndex
from repro_torch.core.oracle_pool import OraclePool
from repro_torch.core.queries.registry import QueryExecutor, get_executor
from repro_torch.core.resident import ResidentIndexState
from repro_torch.obs import NULL_SCOPE
from repro_torch.obs.trace import span as trace_span

PROPAGATION_MODES = ("numeric", "top1", "categorical")


# ---------------------------------------------------------------------------
# Spec
# ---------------------------------------------------------------------------
@dataclass
class QuerySpec:
    """Declarative description of one query.

    ``score`` is either the name of a workload scoring method (portable,
    JSON-friendly) or any callable mapping a target-DNN output to a float.
    Unused knobs are ignored by kinds that don't need them.
    """

    kind: str                                   # "aggregation"|"selection"|"limit"|...
    score: Union[str, Callable, None] = None    # scoring fn (name or callable)
    proxy: Optional[np.ndarray] = None          # precomputed proxy override
    propagation: Optional[str] = None           # None -> kind default
    n_classes: Optional[int] = None             # required for "categorical"

    # statistical knobs
    err: float = 0.05                           # aggregation error bound
    delta: float = 0.05                         # confidence (all kinds)
    recall_target: float = 0.9                  # selection
    budget: Optional[int] = None                # selection oracle budget
    k_results: Optional[int] = None             # limit: K matches wanted
    batch: Optional[int] = None                 # oracle batch (kind default)
    min_samples: int = 64                       # aggregation
    max_samples: Optional[int] = None           # aggregation
    max_invocations: int = 0                    # limit (0 = no cap)
    use_cv: bool = True                         # aggregation control variates
    seed: int = 0

    # engine behaviour
    score_key: Optional[str] = None             # explicit proxy-cache key
    reuse_labels: bool = True                   # read the shared label cache
    crack: Optional[bool] = None                # None -> engine default

    # routing: which mounted workload a multi-workload server executes this
    # spec against (None -> the server's default; the engine itself ignores
    # it — score names already resolve against the engine's own workload)
    workload: Optional[str] = None

    # scheduling (serving layer only; the engine itself ignores both):
    # `priority` is the scheduling class (0 = most urgent; None -> the
    # server's default class), `deadline_ms` a soft latency target relative
    # to arrival that orders same-class work earliest-deadline-first
    priority: Optional[int] = None
    deadline_ms: Optional[float] = None

    _JSON_FIELDS = ("kind", "score", "propagation", "n_classes", "err",
                    "delta", "recall_target", "budget", "k_results", "batch",
                    "min_samples", "max_samples", "max_invocations", "use_cv",
                    "seed", "score_key", "reuse_labels", "crack", "workload",
                    "priority", "deadline_ms")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "QuerySpec":
        unknown = set(d) - set(cls._JSON_FIELDS)
        if unknown:
            raise ValueError(f"unknown QuerySpec fields: {sorted(unknown)}; "
                             f"allowed: {sorted(cls._JSON_FIELDS)}")
        if "kind" not in d:
            raise ValueError("QuerySpec requires 'kind'")
        return cls(**d)

    def to_dict(self) -> Dict[str, Any]:
        if self.score is not None and not isinstance(self.score, str):
            raise ValueError("only specs with string `score` serialize to JSON")
        if self.proxy is not None:
            raise ValueError("specs with an external `proxy` array do not "
                             "serialize to JSON")
        return {k: getattr(self, k) for k in self._JSON_FIELDS
                if getattr(self, k) != getattr(type(self), k, None)
                or k == "kind"}


# ---------------------------------------------------------------------------
# Plan / result
# ---------------------------------------------------------------------------
@dataclass
class QueryPlan:
    """Compiled, validated form of a spec: every choice the engine made."""
    spec: QuerySpec
    kind: str
    executor: QueryExecutor
    propagation: str                 # resolved mode ("external" if proxy given)
    clip01: bool
    score_key: Any                   # proxy/label cache key
    crack: bool
    trace: List[str] = field(default_factory=list)
    # session-injected sample order shared across specs over the same score
    # (any prefix is stratified over proxy-score strata); None = spec default
    shared_order: Optional[np.ndarray] = None


@dataclass
class QueryResult:
    """Uniform result envelope for every query kind."""
    kind: str
    estimate: Optional[float]        # aggregation estimate (else None)
    selected: Optional[np.ndarray]   # selection/limit record ids (else None)
    threshold: Optional[float]       # selection tau (else None)
    ci_half_width: Optional[float]   # aggregation CI (else None)
    n_invocations: int               # the paper's cost metric for this query
    n_oracle_fresh: int              # target-DNN calls actually made
    n_oracle_cached: int             # label-cache hits (free)
    n_cracked: int                   # reps folded back into the index
    cost: Dict[str, float]           # modeled query-time cost breakdown
    plan: QueryPlan
    raw: Any                         # kind-specific result (AggResult, ...)
    session: Optional[Dict[str, Any]] = None  # session-level accounting
                                              # (set by QuerySession)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------
class QueryEngine:
    """Executes :class:`QuerySpec` s against a :class:`TastiIndex`.

    Owns the per-session caches: memoized propagation per score function,
    shared oracle labels across queries, and the optional cracking feedback
    loop that folds every fresh annotation back into the index.
    """

    def __init__(self, index: TastiIndex, workload: Any = None,
                 crack: bool = False, max_oracle_batch: int = 64,
                 broker: Optional[OracleBroker] = None,
                 oracle_replicas: int = 1,
                 oracle_backend: str = "thread",
                 oracle_pool: Optional[OraclePool] = None,
                 resident: Optional[bool] = None,
                 obs=None):
        self.obs = obs if obs is not None else NULL_SCOPE
        self.index = index
        self.workload = workload
        self.crack_by_default = bool(crack)
        self.max_oracle_batch = int(max_oracle_batch)
        self._proxy_cache: Dict[Any, np.ndarray] = {}
        self._proxy_cache_version = index.version
        # in-flight propagations (single-flight): key -> Event set on finish
        self._proxy_flights: Dict[Any, threading.Event] = {}
        # device-resident rep structures for the fused scoring hot path;
        # `resident=None` enables it when the index lives on CUDA (see
        # repro_torch.core.resident for the policy and the env override)
        self.resident = ResidentIndexState(index, enabled=resident,
                                           obs=self.obs)
        self._broker = broker
        if broker is not None and obs is not None:
            broker.set_obs(self.obs)
        # oracle sharding: >1 replicas put an OraclePool behind the broker's
        # microbatcher; an externally-owned pool may be passed in instead.
        # `oracle_backend` picks thread replicas (GIL-releasing targets) or
        # forked process replicas (compute-bound targets)
        self.oracle_replicas = max(1, int(oracle_replicas))
        self.oracle_backend = str(oracle_backend)
        self._oracle_pool = oracle_pool
        self._owns_pool = False
        if broker is not None:
            # an injected broker skips the lazy construction below, so the
            # sharding knob must attach to it here (never silently ignored);
            # an existing pool on the shared broker wins
            if broker.pool is not None:
                self._oracle_pool = broker.pool
            elif self._oracle_pool is None and self.oracle_replicas > 1:
                self._oracle_pool = OraclePool(
                    self._annotate, n_replicas=self.oracle_replicas,
                    backend=self.oracle_backend, obs=self.obs)
                self._owns_pool = True
                broker.pool = self._oracle_pool
            elif self._oracle_pool is not None:
                broker.pool = self._oracle_pool
        # guards the proxy cache, stats counters, and index mutation
        # (crack_with) so concurrent sessions can share one engine; always
        # acquired before the broker's lock, never after
        self._lock = threading.RLock()
        self._on_crack: List[Callable[[int], None]] = []
        self.stats: Dict[str, int] = {
            "propagation_computes": 0,
            "proxy_cache_hits": 0,
            "proxy_device_computes": 0,
            "proxy_flight_waits": 0,
            "label_fresh": 0,
            "label_cache_hits": 0,
            "cracked_records": 0,
        }
        # eager device-memory release on crack; correctness relies only on
        # the per-call version check inside ResidentIndexState.propagate
        self._on_crack.append(lambda added: self.resident.invalidate())

    # -- oracle broker -------------------------------------------------------
    def _annotate(self, ids: np.ndarray):
        if self.workload is None:
            raise ValueError("labeling records requires a workload "
                             "(the target-DNN oracle)")
        return self.workload.target_dnn_batch(np.asarray(ids, np.int64))

    @property
    def broker(self) -> OracleBroker:
        """The batched, deduplicating seam to ``workload.target_dnn_batch``;
        its cache is the engine's shared oracle-label cache.  With
        ``oracle_replicas > 1`` the broker's flushes are sharded across an
        :class:`~repro_torch.core.oracle_pool.OraclePool` the engine owns."""
        with self._lock:
            if self._broker is None:
                if self._oracle_pool is None and self.oracle_replicas > 1:
                    self._oracle_pool = OraclePool(
                        self._annotate, n_replicas=self.oracle_replicas,
                        backend=self.oracle_backend, obs=self.obs)
                    self._owns_pool = True
                self._broker = OracleBroker(self._annotate,
                                            max_batch=self.max_oracle_batch,
                                            pool=self._oracle_pool,
                                            obs=self.obs)
            return self._broker

    @property
    def oracle_pool(self) -> Optional[OraclePool]:
        """The replica pool behind the broker, if sharding is on."""
        with self._lock:
            return self._oracle_pool

    def set_oracle_replicas(self, n: int,
                            backend: Optional[str] = None) -> None:
        """Resize the target-DNN replica pool (the ``oracle_replicas`` knob
        at run time; sessions with their own setting call this), optionally
        switching the replica backend at the same time.  Safe between
        flushes: an in-flight flush keeps the pool it started with
        (``broker._label`` reads ``broker.pool`` once)."""
        n = max(1, int(n))
        with self._lock:
            backend = self.oracle_backend if backend is None else str(backend)
            if (n == self.oracle_replicas and backend == self.oracle_backend
                    and (n == 1 or self._oracle_pool is not None)):
                return
            old = self._oracle_pool if self._owns_pool else None
            pool = (OraclePool(self._annotate, n_replicas=n, backend=backend,
                               obs=self.obs)
                    if n > 1 else None)
            self.oracle_replicas = n
            self.oracle_backend = backend
            self._oracle_pool = pool
            self._owns_pool = pool is not None
            if self._broker is not None:
                self._broker.pool = pool
        if old is not None:
            old.close()

    def close(self) -> None:
        """Detach and stop an engine-owned replica pool (idempotent).  The
        broker falls back to inline labeling, so the engine stays usable —
        the serving layer calls this on shutdown."""
        with self._lock:
            pool = self._oracle_pool if self._owns_pool else None
            self._oracle_pool = None
            self._owns_pool = False
            self.oracle_replicas = 1
            if self._broker is not None:
                self._broker.pool = None
        if pool is not None:
            pool.close()

    def set_obs(self, obs) -> None:
        """Adopt an :class:`~repro_torch.obs.ObsScope` after construction (the
        server wires a per-workload scope into engines registered before it
        existed) and push it into the broker/pool/resident the engine
        already built."""
        self.obs = obs if obs is not None else NULL_SCOPE
        with self._lock:
            broker, pool = self._broker, self._oracle_pool
        if broker is not None:
            broker.set_obs(self.obs)
        if pool is not None:
            pool.set_obs(self.obs)
        self.resident.set_obs(self.obs)

    def add_stats(self, **deltas: int) -> None:
        """Atomically bump engine counters (dict ``+=`` is not)."""
        with self._lock:
            for k, v in deltas.items():
                self.stats[k] += v

    def on_crack(self, callback: Callable[[int], None]) -> None:
        """Register a listener called with the number of new representatives
        after every index-mutating crack (a persistent label store re-stamps
        the index version it is cached against)."""
        with self._lock:
            self._on_crack.append(callback)

    @property
    def _label_cache(self) -> Dict[int, Any]:
        return self.broker.cache

    # -- proxy scores (memoized propagation) ---------------------------------
    def _score_fn(self, score: Union[str, Callable]) -> Callable:
        if isinstance(score, str):
            if self.workload is None:
                raise ValueError("string `score` needs a workload to resolve "
                                 f"{score!r} against")
            fn = getattr(self.workload, score, None)
            if fn is None or not callable(fn):
                raise ValueError(f"workload {getattr(self.workload, 'name', '?')} "
                                 f"has no scoring method {score!r}")
            return fn
        if callable(score):
            return score
        raise TypeError(f"score must be a str or callable, got {type(score)}")

    def _cache_key(self, score, score_key=None):
        # strings are stable across sessions; bound methods hash by
        # (__func__, __self__) so repeated getattr lookups hit the same entry;
        # lambdas memoize by identity (conservative but correct).
        return score_key if score_key is not None else score

    def proxy_scores(self, score: Union[str, Callable], mode: str = "numeric",
                     n_classes: Optional[int] = None,
                     score_key: Optional[str] = None) -> np.ndarray:
        """Propagated proxy scores for ``score``, memoized per (score, mode).

        The cache is invalidated whenever the index version changes (i.e.
        after cracking), so callers always see post-crack scores.

        Propagation is **single-flight**: the first caller of a key computes
        (outside the engine lock — on the device-resident fast path when the
        engine's :class:`~repro_torch.core.resident.ResidentIndexState` is enabled,
        else the float64 host path), concurrent callers of the *same* key
        park on its flight and reuse the result as a cache hit, and callers
        of *different* keys propagate in parallel instead of racing the
        lock.  A crack landing mid-compute discards the stale result and the
        owner recomputes against the new index.
        """
        if mode not in PROPAGATION_MODES:
            raise ValueError(f"unknown propagation mode {mode!r}; "
                             f"expected one of {PROPAGATION_MODES}")
        if mode == "categorical" and n_classes is None:
            raise ValueError("categorical propagation requires n_classes")
        fn = self._score_fn(score)  # resolve early: never strand waiters on
        key = (self._cache_key(score, score_key), mode, n_classes)  # bad specs
        while True:
            with self._lock:
                if self._proxy_cache_version != self.index.version:
                    self._proxy_cache.clear()
                    self._proxy_cache_version = self.index.version
                if key in self._proxy_cache:
                    self.stats["proxy_cache_hits"] += 1
                    return self._proxy_cache[key]
                flight = self._proxy_flights.get(key)
                if flight is None:
                    flight = threading.Event()
                    self._proxy_flights[key] = flight
                    owner = True
                    # crack replaces these wholesale (never in place), so the
                    # refs are a consistent snapshot for `version`
                    version = self.index.version
                    annotations = self.index.annotations
                    topk_ids, topk_d2 = self.index.topk_ids, self.index.topk_d2
                else:
                    owner = False
                    self.stats["proxy_flight_waits"] += 1
            if not owner:
                with trace_span("proxy.flight_wait", mode=mode):
                    flight.wait()
                continue      # cache hit, or recompute if the owner lost
            try:
                with trace_span("proxy.materialize", mode=mode) as sp:
                    rep_scores = np.asarray([fn(a) for a in annotations],
                                            np.float64)
                    out, source = self._propagate(
                        rep_scores, topk_ids, topk_d2, mode, n_classes,
                        version)
                    sp.set(source=source, n=len(out))
            except BaseException:
                with self._lock:
                    self._proxy_flights.pop(key, None)
                flight.set()  # waiters retry, become owner, re-raise
                raise
            with self._lock:
                self._proxy_flights.pop(key, None)
                flight.set()
                if self.index.version == version:
                    self.stats["propagation_computes"] += 1
                    self._proxy_cache[key] = out
                    return out
            # cracked mid-compute: result is stale, go around again

    def _propagate(self, rep_scores: np.ndarray, topk_ids: np.ndarray,
                   topk_d2: np.ndarray, mode: str, n_classes: Optional[int],
                   version: int):
        """One propagation over a snapshot: fused device call when resident
        scoring is on (falling back only on a mid-compute crack),
        float64 numpy otherwise.  Returns ``(scores, source)`` with source
        in {"device", "host"} for span attribution."""
        if self.resident.enabled:
            out = self.resident.propagate(rep_scores, mode, version=version,
                                          n_classes=n_classes)
            if out is not None:
                self.add_stats(proxy_device_computes=1)
                return out, "device"
        if mode == "numeric":
            return propagation.propagate_numeric(
                rep_scores, topk_ids, topk_d2), "host"
        if mode == "top1":
            return propagation.propagate_top1(
                rep_scores, topk_ids, topk_d2), "host"
        return propagation.propagate_categorical(
            rep_scores, topk_ids, topk_d2,
            n_classes=n_classes).astype(np.float64), "host"

    # -- oracle with the shared label cache ----------------------------------
    def _make_oracle(self, score_fn: Callable, reuse: bool,
                     account: OracleAccount,
                     checkpoint: Optional[Callable[[], None]] = None,
                     slice_size: Optional[int] = None
                     ) -> Callable[[np.ndarray], np.ndarray]:
        """Wrap the broker for one query: blocking calls return scores.
        Sessions enqueue ahead of execution through the broker's futures API
        (``request``/``prefetch``) against the same account.

        ``checkpoint`` is the scheduler's preemption hook: it is called at
        every oracle interaction and between ``slice_size``-id slices of
        large fetches, and may block (the serving scheduler parks a
        preempted query there while higher-priority work runs).  Slicing
        only inserts scheduling points — the same ids reach the broker in
        the same order against the same account, so fresh/cached accounting
        and labels are byte-identical to the unchunked path."""
        broker = self.broker
        step = int(slice_size) if slice_size else self.max_oracle_batch

        def call(ids) -> np.ndarray:
            ids = np.asarray(ids, np.int64).ravel()
            if checkpoint is None:
                anns: List[Any] = broker.fetch(ids, account=account,
                                               reuse=reuse)
            else:
                checkpoint()
                if len(ids) <= step:
                    anns = broker.fetch(ids, account=account, reuse=reuse)
                else:
                    anns = []
                    for k, start in enumerate(range(0, len(ids), step)):
                        if k:
                            checkpoint()
                        anns.extend(broker.fetch(ids[start:start + step],
                                                 account=account, reuse=reuse))
            return np.asarray([score_fn(a) for a in anns], np.float64)

        return call

    # -- plan ----------------------------------------------------------------
    def plan(self, spec: QuerySpec) -> QueryPlan:
        """Compile and validate a spec without spending any oracle budget."""
        executor = get_executor(spec.kind)
        executor.validate(spec)
        if isinstance(spec.score, str) and self.workload is not None:
            self._score_fn(spec.score)  # fail fast on unknown score names
        trace: List[str] = [f"kind={spec.kind}"]
        if spec.proxy is not None:
            mode = "external"
            trace.append("proxy=external (propagation skipped)")
        else:
            if spec.score is None:
                raise ValueError(f"{spec.kind} spec needs `score` or `proxy`")
            mode = spec.propagation or executor.default_propagation
            if mode not in PROPAGATION_MODES:
                raise ValueError(f"unknown propagation mode {mode!r}")
            if mode == "categorical" and spec.n_classes is None:
                raise ValueError("categorical propagation requires n_classes")
            chosen = "spec" if spec.propagation else "auto"
            trace.append(f"propagation={mode} ({chosen})")
        clip01 = executor.clip01
        if clip01:
            trace.append("proxy clipped to [0,1]")
        crack = self.crack_by_default if spec.crack is None else spec.crack
        trace.append(f"crack={'on' if crack else 'off'}, "
                     f"label_reuse={'on' if spec.reuse_labels else 'off'}")
        key = None if spec.score is None else \
            self._cache_key(spec.score, spec.score_key)
        return QueryPlan(spec=spec, kind=spec.kind, executor=executor,
                         propagation=mode, clip01=clip01, score_key=key,
                         crack=crack, trace=trace)

    # -- execute -------------------------------------------------------------
    def proxy_for(self, plan: QueryPlan) -> np.ndarray:
        """The proxy array ``plan`` will execute against (external override,
        or memoized propagation, clipped when the kind requires it)."""
        spec = plan.spec
        if spec.proxy is not None:
            proxy = np.asarray(spec.proxy, np.float64)
        else:
            proxy = self.proxy_scores(spec.score, plan.propagation,
                                      n_classes=spec.n_classes,
                                      score_key=spec.score_key)
        if plan.clip01:
            proxy = np.clip(proxy, 0.0, 1.0)
        return proxy

    def execute(self, spec_or_plan: Union[QuerySpec, QueryPlan],
                account: Optional[OracleAccount] = None,
                checkpoint: Optional[Callable[[], None]] = None,
                slice_size: Optional[int] = None) -> QueryResult:
        """Run one query.  ``account`` carries the oracle accounting; a
        session passes one per spec (pre-charged by its prefetch phase) so
        per-spec fresh/cached counts stay exact under cross-spec dedup.
        ``checkpoint``/``slice_size`` make execution preemptible at oracle-
        slice boundaries (see :meth:`_make_oracle`) without changing labels
        or accounting."""
        plan = (spec_or_plan if isinstance(spec_or_plan, QueryPlan)
                else self.plan(spec_or_plan))
        # each execution owns its trace: re-executing a caller-held plan must
        # not mutate it (or earlier results that share it)
        plan = dataclasses.replace(plan, trace=list(plan.trace))
        spec = plan.spec
        proxy = self.proxy_for(plan)

        if self.workload is None:
            raise ValueError("executing queries requires a workload "
                             "(the target-DNN oracle)")
        score_fn = (self._score_fn(spec.score) if spec.score is not None
                    else None)
        if score_fn is None:
            raise ValueError(f"{spec.kind} spec needs `score` to build the "
                             "target-DNN oracle")
        acct = account if account is not None else \
            self.broker.account(name=spec.kind)
        fresh0, cached0 = acct.fresh, acct.cached
        oracle = self._make_oracle(score_fn, spec.reuse_labels, acct,
                                   checkpoint=checkpoint,
                                   slice_size=slice_size)

        with trace_span("spec.execute", kind=plan.kind) as sp:
            raw = plan.executor.execute(plan, proxy, oracle)
            summary = plan.executor.summarize(raw)
            sp.set(fresh=acct.fresh - fresh0, cached=acct.cached - cached0)

        n_cracked = 0
        if plan.crack and acct.labeled:
            with trace_span("engine.crack") as sp:
                n_cracked = self.crack_with(acct.labeled)
                sp.set(added=n_cracked)
            plan.trace.append(f"cracked {n_cracked} new reps into the index")

        # session-prefetched labels were already folded into engine.stats by
        # the session; only the execution delta lands here
        self.add_stats(label_fresh=acct.fresh - fresh0,
                       label_cache_hits=acct.cached - cached0)
        cost = {
            "target_dnn_s": acct.fresh * schema_lib.TARGET_DNN_COST_S,
            "crack_distance_s": (n_cracked * self.index.n_records
                                 * schema_lib.DIST_COST_S),
        }
        return QueryResult(
            kind=plan.kind,
            estimate=summary.get("estimate"),
            selected=summary.get("selected"),
            threshold=summary.get("threshold"),
            ci_half_width=summary.get("ci_half_width"),
            n_invocations=int(summary["n_invocations"]),
            n_oracle_fresh=acct.fresh,
            n_oracle_cached=acct.cached,
            n_cracked=n_cracked,
            cost=cost,
            plan=plan,
            raw=raw,
        )

    # -- cracking feedback loop ----------------------------------------------
    def crack_with(self, ids) -> int:
        """Fold target-DNN annotations for ``ids`` into the index (§3.3),
        reusing cached labels where available.  Returns the number of *new*
        representatives added; the proxy cache invalidates automatically via
        the index version."""
        ids = np.unique(np.asarray(list(ids), np.int64))
        if len(ids) == 0:
            return 0
        # one crack at a time: index mutation and the proxy-cache version
        # check must not interleave with a concurrent session's propagation
        with self._lock:
            missing = np.asarray(
                [i for i in ids if int(i) not in self._label_cache], np.int64)
            if len(missing):
                # through the broker: microbatched and counted like every
                # other oracle call
                self.broker.fetch(missing)
                self.stats["label_fresh"] += len(missing)
            before = self.index.n_reps
            self.index.crack(ids, [self._label_cache[int(i)] for i in ids])
            added = self.index.n_reps - before
            self.stats["cracked_records"] += added
            callbacks = list(self._on_crack) if added else []
        # listeners run OUTSIDE the engine lock: a label store's re-stamp
        # compacts its whole snapshot, which must not stall every concurrent
        # session on self._lock (they only contend on the store's own lock)
        for cb in callbacks:
            cb(added)
        return added
