"""Multi-query sessions: plan a list of ``QuerySpec`` s jointly, execute them
against one engine, and account for the whole batch.

One semantic index answers many queries (paper §4); a *session* makes the
cross-query structure explicit instead of incidental:

* **grouping** — specs over the same score function are planned together:
  propagation runs once per (score, mode) and the group shares the engine's
  oracle-label cache;
* **shared stratified sample** — aggregation specs in a group walk one
  sample order whose every prefix is stratified over proxy-score strata, so
  their samples *nest*: the group's fresh-label cost is the max of its
  members, not the sum;
* **prefetch + combined flush** — each executor previews the ids it will
  certainly request first; the session enqueues all previews through the
  :class:`~repro_torch.core.broker.OracleBroker` and flushes once, so one
  ``target_dnn_batch`` microbatch sequence serves every spec;
* **combined invocation budget** — an optional session-wide cap on
  worst-case oracle demand, allocated proportionally across specs by
  clamping their knobs (selection ``budget``, aggregation ``max_samples``,
  limit ``max_invocations``) at plan time;
* **accounting** — per-spec fresh/cached counts stay exact under dedup (a
  record labeled for spec A is fresh for A, cached for B), and every
  :class:`QueryResult` carries a ``session`` snapshot of the batch totals.

Cracking composes: a spec with ``crack=True`` bumps the index version
mid-session, the engine's memoized propagation self-invalidates, and sibling
specs re-propagate against the improved index.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.broker import OracleAccount
from repro_torch.core.engine import QueryEngine, QueryPlan, QueryResult, QuerySpec
from repro_torch.obs.trace import span as trace_span


def stratified_order(proxy: np.ndarray, n_strata: int = 10,
                     seed: int = 0) -> np.ndarray:
    """A full permutation of record ids whose every prefix is (approximately)
    stratified over ``n_strata`` equal-frequency proxy-score strata.

    Records are ranked by proxy score, split into equal-sized strata,
    shuffled within each stratum, and interleaved round-robin — so any
    prefix covers the proxy range evenly.  Aggregation specs sharing this
    order draw nested, stratified samples."""
    n = len(proxy)
    n_strata = max(1, min(int(n_strata), n))
    rng = np.random.default_rng(seed)
    ranks = np.argsort(np.argsort(proxy, kind="stable"), kind="stable")
    strata = (ranks * n_strata) // n                  # (n,) stratum per record
    perm = rng.permutation(n)
    sp = strata[perm]
    within = np.empty(n, np.int64)
    for s in range(n_strata):
        members = np.where(sp == s)[0]
        within[members] = np.arange(len(members))
    round_pos = rng.permutation(n_strata)             # stratum order per round
    key = within * n_strata + round_pos[sp]
    return perm[np.argsort(key, kind="stable")]


def _oracle_demand(spec: QuerySpec, n: int) -> int:
    """Worst-case fresh-label demand of one spec (the combined-budget unit)."""
    if spec.kind == "selection":
        return min(int(spec.budget or n), n)
    if spec.kind == "aggregation":
        return min(int(spec.max_samples or n), n)
    if spec.kind == "limit":
        return min(int(spec.max_invocations or n), n)
    return n


def _clamp_spec(spec: QuerySpec, alloc: int) -> QuerySpec:
    """Rewrite one spec's knobs so its worst-case demand is ``alloc``."""
    if spec.kind == "selection":
        return dataclasses.replace(spec, budget=alloc)
    if spec.kind == "aggregation":
        return dataclasses.replace(spec, max_samples=alloc,
                                   min_samples=min(spec.min_samples, alloc))
    if spec.kind == "limit":
        return dataclasses.replace(spec, max_invocations=alloc)
    return spec


@dataclass
class SessionGroup:
    """Specs (by position) sharing one score function."""
    score_key: Any
    spec_indices: List[int]
    modes: List[str]
    shared_order: bool = False       # aggregation members share a sample order


@dataclass
class SessionPlan:
    plans: List[QueryPlan]
    groups: List[SessionGroup]
    budget: Optional[int]
    allocations: Optional[List[int]]  # per-spec demand after clamping
    trace: List[str] = field(default_factory=list)


@dataclass
class SessionResult:
    """All per-spec results plus batch-level accounting."""
    results: List[QueryResult]
    stats: Dict[str, Any]
    plan: SessionPlan


class QuerySession:
    """Plans and executes a batch of specs against one :class:`QueryEngine`.

        session = QuerySession(engine, specs, budget=2000)
        out = session.execute()
        out.results[0].session["session_fresh"], out.stats["oracle_batches"]

    ``budget`` caps the batch's worst-case fresh-label demand; ``prefetch``
    disables the preview/flush phase (labels are then fetched on demand,
    still deduped); ``n_strata`` controls the shared stratified sample;
    ``oracle_replicas`` (None = leave the engine's setting alone) resizes
    the target-DNN replica pool behind the broker before execution, and
    ``oracle_backend`` ("thread" | "process", None = keep the engine's)
    picks its replica kind — results and accounting are identical at any
    replica count and on either backend, only flush latency changes.

    ``checkpoint`` makes the session preemptible: it is called between
    ``slice_size``-id slices of every oracle interaction (prefetch flush and
    execution alike) and may block — the serving scheduler parks a preempted
    session there while higher-priority work runs.  Slicing never changes
    which ids are requested, in what order, or on which account, so results
    and fresh/cached accounting are byte-identical to an uncheckpointed run.
    ``slice_size`` defaults to the engine's oracle microbatch size.
    """

    def __init__(self, engine: QueryEngine,
                 specs: Optional[Sequence[QuerySpec]] = None,
                 budget: Optional[int] = None, prefetch: bool = True,
                 n_strata: int = 10, seed: int = 0,
                 oracle_replicas: Optional[int] = None,
                 oracle_backend: Optional[str] = None,
                 checkpoint: Optional[Any] = None,
                 slice_size: Optional[int] = None):
        self.engine = engine
        self.specs: List[QuerySpec] = list(specs or [])
        self.budget = budget
        self.prefetch = bool(prefetch)
        self.n_strata = int(n_strata)
        self.seed = int(seed)
        self.oracle_replicas = oracle_replicas
        self.oracle_backend = oracle_backend
        self.checkpoint = checkpoint
        self.slice_size = (int(slice_size) if slice_size
                           else engine.max_oracle_batch)

    def add(self, spec: QuerySpec) -> "QuerySession":
        self.specs.append(spec)
        return self

    # -- joint planning ------------------------------------------------------
    def plan(self) -> SessionPlan:
        """Compile the batch: allocate the combined budget, group specs by
        score, build shared stratified sample orders.  Spends no oracle
        budget (propagation is free arithmetic)."""
        if not self.specs:
            raise ValueError("session has no specs; pass them to the "
                             "constructor or add() them")
        engine = self.engine
        n = engine.index.n_records
        trace: List[str] = [f"session of {len(self.specs)} specs over "
                            f"{n} records"]

        specs = list(self.specs)
        allocations: Optional[List[int]] = None
        if self.budget is not None:
            if self.budget < len(specs):
                raise ValueError(
                    f"session budget {self.budget} cannot cover "
                    f"{len(specs)} specs (every spec needs >= 1 label)")
            demands = [_oracle_demand(s, n) for s in specs]
            total = sum(demands)
            if total > self.budget:
                allocations = [max(1, (self.budget * d) // total)
                               for d in demands]
                # flooring at 1 can overshoot the cap: shave the largest
                # allocations until the worst-case sum fits again
                while sum(allocations) > self.budget:
                    big = int(np.argmax(allocations))
                    allocations[big] -= 1
                specs = [_clamp_spec(s, a) for s, a in zip(specs, allocations)]
                trace.append(
                    f"combined budget {self.budget} < worst-case demand "
                    f"{total}: allocations {allocations}")
            else:
                allocations = demands
                trace.append(f"combined budget {self.budget} covers "
                             f"worst-case demand {total}")

        plans = [engine.plan(s) for s in specs]

        # group by score cache key (external-proxy specs stay ungrouped)
        keyed: Dict[Any, List[int]] = {}
        for i, plan in enumerate(plans):
            if plan.score_key is None or plan.spec.proxy is not None:
                continue
            keyed.setdefault(plan.score_key, []).append(i)
        groups: List[SessionGroup] = []
        for key, idxs in keyed.items():
            modes = sorted({plans[i].propagation for i in idxs})
            group = SessionGroup(score_key=key, spec_indices=idxs,
                                 modes=modes)
            agg = [i for i in idxs if plans[i].kind == "aggregation"]
            if agg:
                # one stratified order per score group: aggregation members
                # draw nested samples off the numeric proxy
                proxy = engine.proxy_for(plans[agg[0]])
                order = stratified_order(proxy, self.n_strata, self.seed)
                for i in agg:
                    plans[i].shared_order = order
                group.shared_order = True
            label = key if isinstance(key, str) else getattr(
                key, "__name__", repr(key))
            trace.append(
                f"group score={label}: specs {idxs}, propagation once per "
                f"mode {modes}"
                + (f", shared stratified sample ({self.n_strata} strata) "
                   f"across {len(agg)} aggregation spec(s)" if agg else ""))
            groups.append(group)
        if sum(len(g.spec_indices) for g in groups) < len(plans):
            trace.append("ungrouped specs execute with the shared label "
                         "cache only")
        return SessionPlan(plans=plans, groups=groups, budget=self.budget,
                           allocations=allocations, trace=trace)

    # -- execution -----------------------------------------------------------
    def execute(self) -> SessionResult:
        """Prefetch every spec's certain first requests, flush once, then
        execute the specs in order against the shared engine.

        Thread-safe over a shared engine: many sessions may execute
        concurrently from a worker pool (the serving layer does) — per-spec
        accounts keep fresh/cached exact under cross-session dedup, and
        answers match isolated runs because labels and propagation are
        deterministic per record.  Only ``stats["oracle_batches"]`` is a
        broker-level delta and may include a concurrent session's batches.
        """
        sp = self.plan()
        engine = self.engine
        if self.oracle_replicas is not None:
            engine.set_oracle_replicas(self.oracle_replicas,
                                       backend=self.oracle_backend)
        broker = engine.broker
        accounts: List[OracleAccount] = [
            broker.account(name=f"spec{i}:{p.kind}")
            for i, p in enumerate(sp.plans)]
        batches0 = broker.stats["batches"]
        version0 = engine.index.version

        prefetch_fresh = 0
        if self.prefetch and engine.workload is not None:
            with trace_span("session.prefetch") as psp:
                enqueued = 0
                for i, plan in enumerate(sp.plans):
                    if plan.spec.reuse_labels:
                        # cache-bypassing specs pay full freight (no prefetch)
                        ids = plan.executor.preview(plan,
                                                    engine.proxy_for(plan))
                        enqueued += broker.prefetch(ids, accounts[i])
                    if plan.crack:
                        # a crack re-propagates every later spec's proxy, so
                        # their previews would prefetch stale ids — let them
                        # fetch on demand (still deduped and microbatched)
                        sp.trace.append(
                            f"spec {i} cracks: later specs fetch on demand")
                        break
                # account-based delta, not a broker.stats delta: a concurrent
                # session's flush in this window must not inflate our count
                fresh0 = sum(a.fresh for a in accounts)
                if self.checkpoint is None:
                    broker.flush()
                else:
                    # preemptible prefetch: flush in slice-sized steps so the
                    # scheduler can run higher-priority work between them
                    # (per-id charging makes the step sequence byte-identical
                    # to a drain)
                    self.checkpoint()
                    while broker.flush(limit=self.slice_size):
                        self.checkpoint()
                prefetch_fresh = sum(a.fresh for a in accounts) - fresh0
                psp.set(enqueued=enqueued, fresh=prefetch_fresh)
            # execute() only folds post-entry deltas into engine.stats, so
            # the prefetch phase records its labels here
            engine.add_stats(label_fresh=prefetch_fresh)
            sp.trace.append(
                f"prefetched {enqueued} ids -> {prefetch_fresh} fresh labels "
                f"in {broker.stats['batches'] - batches0} microbatch(es)")

        results: List[QueryResult] = []
        for i, plan in enumerate(sp.plans):
            results.append(engine.execute(plan, account=accounts[i],
                                          checkpoint=self.checkpoint,
                                          slice_size=self.slice_size))
        if engine.index.version != version0:
            sp.trace.append(
                f"index version {version0} -> {engine.index.version} "
                "(cracked mid-session; memoized propagation re-ran for "
                "later specs)")

        prefetch_unused = sum(len(a._credit) for a in accounts)
        stats: Dict[str, Any] = {
            "n_specs": len(sp.plans),
            "n_groups": len(sp.groups),
            "fresh_total": sum(a.fresh for a in accounts),
            "cached_total": sum(a.cached for a in accounts),
            "prefetch_labels": prefetch_fresh,
            "prefetch_unused": prefetch_unused,
            "oracle_batches": broker.stats["batches"] - batches0,
            "n_cracked": sum(r.n_cracked for r in results),
            "budget": self.budget,
            "index_version_start": version0,
            "index_version_end": engine.index.version,
        }
        snapshot = {f"session_{k}": v for k, v in stats.items()
                    if k in ("fresh_total", "cached_total", "n_specs",
                             "oracle_batches")}
        for i, res in enumerate(results):
            res.session = {"spec_index": i, **snapshot}
        return SessionResult(results=results, stats=stats, plan=sp)
