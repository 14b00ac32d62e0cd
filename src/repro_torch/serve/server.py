"""``QueryServer``: concurrent query sessions over many workloads, via HTTP.

The system's first long-lived, multi-client layer.  Clients POST JSON
``QuerySpec`` lists (the same schema as ``repro_torch.launch.query``); the server

* **routes** — a :class:`~repro_torch.serve.registry.WorkloadRegistry` mounts N
  workloads, each with its own :class:`~repro_torch.core.index.TastiIndex`,
  :class:`~repro_torch.core.engine.QueryEngine`, label store, and oracle replica
  pool; specs carry an optional ``workload`` field (or the request body a
  ``workload`` key) and default to the registry's default workload, so a
  single-workload server keeps today's API unchanged;
* **schedules** — every submission becomes a task in the
  :class:`~repro_torch.serve.scheduler.QueryScheduler`'s waiting queue, ordered
  by priority class (``priority`` on specs or the request body, 0 = most
  urgent) and earliest deadline first within a class (``deadline_ms``),
  with per-workload weighted ``shares`` and hard ``caps`` on concurrent
  slots.  Long scans execute in oracle-slice-sized chunks, so a
  higher-class arrival preempts a running scan at its next slice boundary
  — labels and accounting stay byte-identical to unscheduled runs;
* **coalesces per workload** — with ``admission_window > 0``, unbudgeted
  requests arriving within the window are merged into a single shared
  :class:`~repro_torch.core.session.QuerySession` at grant time, so strangers'
  queries share joint planning, the stratified sample, and one combined
  oracle flush (the whole point of sessions, paper §4/§5);
* **persists per workload** — with a :class:`~repro_torch.serve.store.LabelStore`
  attached, every flush is written through to disk, so a restarted server
  answers repeats on *every* mounted workload with zero fresh target-DNN
  invocations.

Endpoints (all JSON):

* ``POST /query`` — body is either a list of spec dicts or
  ``{"specs": [...], "budget": int, "workload": str, "priority": int,
  "deadline_ms": float}``; responds with per-spec result rows plus
  session- and request-level label accounting;
* ``GET /stats`` — global server counters, a ``scheduler`` section
  (queues, slices, preemptions), plus a per-workload ``workloads`` map
  (engine/broker stats, queue depth and wait-time counters, store and
  index info); the default workload's sections are mirrored at top level
  for single-workload compatibility;
* ``GET /workloads`` — what is mounted: per workload name, default flag,
  loaded state, records/reps, store size, request count;
* ``GET /healthz`` — readiness probe (with per-workload loaded flags);
* ``GET /metrics`` — Prometheus text exposition: real counters/histograms
  (flush latency/size, queue wait, sub-batch latency, request latency,
  grants by reason) plus scrape-time samples derived from every layer's
  plain-dict counters (broker, engine, pool, resident, store, scheduler);
* ``GET /debug/traces`` — the flight recorder: recent trace summaries;
  ``?id=<trace_id>`` for one full trace, ``&format=chrome`` for a
  ``chrome://tracing`` / Perfetto-loadable document;
* ``POST /shutdown`` — clean stop (also available as ``server.shutdown()``).

Observability is ON by default (its disabled form is a set of no-op
objects; pass ``obs=False`` to measure the difference — the
``obs_overhead`` benchmark leg gates it at <= 5%).  Every request gets a
trace id (client-chosen via a body ``trace_id`` or ``X-Trace-Id`` header,
else generated) whose span tree runs admission -> scheduler queue ->
session plan/execute -> broker flush -> per-replica oracle sub-batches,
so each fresh label is attributable to exactly one span chain.
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple, Union
from urllib.parse import parse_qs, urlparse

from repro_torch.core.codec import result_row
from repro_torch.core.engine import QueryEngine, QuerySpec
from repro_torch.core.session import QuerySession
from repro_torch.obs import Observability, Sample
from repro_torch.obs.trace import activate, chrome_trace
from repro_torch.obs.trace import span as trace_span
from repro_torch.serve.registry import (DEFAULT_WORKLOAD, WorkloadEntry,
                                        WorkloadRegistry)
from repro_torch.serve.scheduler import (DEFAULT_PRIORITY, QueryScheduler,
                                         ScheduledTask)

_WL_COUNTERS = ("requests", "specs", "sessions", "coalesced", "errors")


class UnknownWorkload(ValueError):
    """A submission named a workload the registry has not mounted."""


@dataclass
class _Submission:
    """One client request, from admission to response."""
    specs: List[QuerySpec]
    budget: Optional[int]
    workload: str = DEFAULT_WORKLOAD
    done: threading.Event = field(default_factory=threading.Event)
    rows: Optional[List[dict]] = None
    session: Optional[Dict[str, Any]] = None
    error: Optional[str] = None
    status: int = 200
    trace: Any = None        # obs Trace (NULL_TRACE when tracing is off)
    queue_span: Any = None   # admission -> grant span, ended at grant
    created_at: float = 0.0  # monotonic admission time (latency histogram)


class QueryServer:
    """Serves ``QuerySpec`` lists over HTTP against mounted workloads.

        server = QueryServer(registry, admission_window=0.05)
        server.start()           # returns once the port is bound
        print(server.url)        # http://127.0.0.1:<port>
        ...
        server.shutdown()

    The first argument is either a :class:`WorkloadRegistry` (multi-workload)
    or a bare :class:`QueryEngine` — the legacy single-engine form, wrapped
    into a one-entry registry under the default workload name (``store``
    may only be passed in that form; registry entries carry their own).

    ``admission_window`` (seconds) is how long an unbudgeted request stays
    queued before it can run, during which co-travelers *on the same
    workload and priority class* merge into its session; 0 disables
    sharing.  ``max_workers`` caps concurrently executing sessions across
    all workloads.  Submissions carrying their own ``budget`` are never
    coalesced (a combined budget across strangers has no owner to answer
    to).

    Scheduling knobs: ``shares`` maps workload names to weighted-fair-share
    weights (default 1.0 each), ``workload_caps`` to hard per-workload
    concurrency caps; ``preempt`` lets strictly higher-class arrivals pause
    running scans at oracle-slice boundaries (``preempt_slice`` ids per
    slice, default: the workload engine's oracle microbatch size);
    ``default_priority`` is the class assigned to requests that set none.
    """

    def __init__(self, source: Union[QueryEngine, WorkloadRegistry],
                 host: str = "127.0.0.1",
                 port: int = 0, admission_window: float = 0.05,
                 max_workers: int = 4, store=None,
                 request_timeout: float = 600.0,
                 session_kw: Optional[dict] = None,
                 shares: Optional[Dict[str, float]] = None,
                 workload_caps: Optional[Dict[str, int]] = None,
                 preempt: bool = True,
                 preempt_slice: Optional[int] = None,
                 default_priority: int = DEFAULT_PRIORITY,
                 obs: Union[Observability, bool, None] = None):
        if isinstance(source, WorkloadRegistry):
            if store is not None:
                raise ValueError("store= only applies to the single-engine "
                                 "form; registry entries carry their own "
                                 "stores")
            self.registry = source
        else:
            self.registry = WorkloadRegistry()
            self.registry.register(DEFAULT_WORKLOAD, source, store=store)
        if not self.registry.names():
            raise ValueError("registry has no workloads mounted")
        self.host = host
        self.port = int(port)          # 0 = ephemeral; real port set by start()
        self.admission_window = float(admission_window)
        self.max_workers = int(max_workers)
        self.request_timeout = float(request_timeout)
        self.session_kw = dict(session_kw or {})
        self.shares = dict(shares or {})
        self.workload_caps = dict(workload_caps or {})
        self.preempt = bool(preempt)
        self.preempt_slice = preempt_slice
        self.default_priority = int(default_priority)
        self.stats: Dict[str, int] = {
            "requests": 0,     # POST /query submissions admitted
            "specs": 0,        # specs across all submissions
            "sessions": 0,     # QuerySessions executed
            "coalesced": 0,    # submissions that shared another's session
            "errors": 0,       # sessions that raised
        }
        self._stats_lock = threading.Lock()
        self._wl_stats: Dict[str, Dict[str, int]] = {}
        # observability: ON by default (None/True); obs=False serves with
        # the all-no-op bundle; an Observability instance is adopted as-is
        # (shared recorder/registry across servers, custom trace_buffer)
        if obs is None or obs is True:
            obs = Observability(enabled=True)
        elif obs is False:
            obs = Observability(enabled=False)
        self.obs: Observability = obs
        self.registry.set_obs(obs)
        obs.metrics.add_collector(self._collect_derived)
        self._h_latency: Dict[str, Any] = {}  # per-workload request latency
        self._scheduler: Optional[QueryScheduler] = None
        self._http: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self._started = False
        self._done = threading.Event()

    # -- single-workload conveniences (legacy API; tests and benchmarks) -----
    @property
    def engine(self) -> QueryEngine:
        """The default workload's engine (loads it if still lazy)."""
        return self.registry.get().engine

    @property
    def store(self):
        """The default workload's label store (loads it if still lazy)."""
        return self.registry.get().store

    @property
    def scheduler(self) -> Optional[QueryScheduler]:
        """The live scheduler (None before :meth:`start`)."""
        return self._scheduler

    # -- lifecycle -----------------------------------------------------------
    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "QueryServer":
        if self._started:
            raise RuntimeError("server already started")
        self._started = True
        self._done.clear()   # a restarted server's wait() must block again
        self._scheduler = QueryScheduler(
            load=self._load_entry, run=self._run_batch, fail=self._fail_task,
            max_workers=self.max_workers, shares=self.shares,
            caps=self.workload_caps, admission_window=self.admission_window,
            preempt=self.preempt, preempt_slice=self.preempt_slice,
            obs=self.obs)
        server = self

        class Handler(_Handler):
            owner = server

        self._http = ThreadingHTTPServer((self.host, self.port), Handler)
        self._http.daemon_threads = True
        self.port = self._http.server_address[1]
        self._http_thread = threading.Thread(
            target=self._http.serve_forever, name="query-http", daemon=True)
        self._http_thread.start()
        return self

    def shutdown(self) -> None:
        """Stop accepting, shed the waiting queue (503), drain running and
        paused sessions, stop every engine's replica pool, persist every
        store."""
        with self._stats_lock:
            if not self._started:
                return
            self._started = False
            scheduler = self._scheduler
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
        if self._http_thread is not None:
            self._http_thread.join(timeout=30.0)
        # the scheduler fails every waiting task fast and drains running and
        # paused sessions to completion before the registry sweep below
        if scheduler is not None:
            scheduler.shutdown(wait=True)
        # sessions are drained: per workload, stop the engine's target-DNN
        # replica pool and save the label store
        self.registry.close()
        self._done.set()

    def wait(self) -> None:
        """Block (interruptibly) until :meth:`shutdown` has fully finished —
        including the final store saves.  The serving CLI parks on this."""
        while not self._done.wait(timeout=0.5):
            pass

    # -- admission -----------------------------------------------------------
    def _resolve_workload(self, specs: List[QuerySpec],
                          workload: Optional[str]) -> str:
        """One submission routes to one workload: the request-level name
        (which covers every spec), else the specs' unanimous ``workload``
        fields, else the default.  Partial spec-level routing without a
        request-level name is rejected — silently dragging an unrouted
        spec onto its neighbor's index would answer it from the wrong
        workload."""
        explicit = {s.workload for s in specs if s.workload is not None}
        if len(explicit) > 1:
            raise ValueError(
                f"one request routes to one workload, got "
                f"{sorted(explicit)}; split the request per workload")
        if workload is not None:
            name = workload
            if explicit and explicit != {workload}:
                raise ValueError(
                    f"request routes to {workload!r} but a spec names "
                    f"{explicit.pop()!r}")
        elif explicit:
            name = explicit.pop()
            if any(s.workload is None for s in specs):
                raise ValueError(
                    "some specs carry a workload and others none; set the "
                    "request-level 'workload' or stamp every spec")
        else:
            name = self.registry.default
        if name not in self.registry:
            raise UnknownWorkload(
                f"unknown workload {name!r}; mounted: "
                f"{sorted(self.registry.names())}")
        return name

    def _resolve_priority(self, specs: List[QuerySpec],
                          priority: Optional[int]) -> int:
        """The submission's class: the most urgent (minimum) of the
        request-level value and any spec-level values; the server default
        when none is set."""
        values = []
        for v in [priority] + [s.priority for s in specs]:
            if v is None:
                continue
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                raise ValueError(f"priority must be a non-negative integer, "
                                 f"got {v!r}")
            values.append(v)
        return min(values) if values else self.default_priority

    @staticmethod
    def _resolve_deadline(specs: List[QuerySpec],
                          deadline_ms: Optional[float]) -> Optional[float]:
        """The submission's EDF key: the tightest deadline named by the
        request or any spec, in milliseconds relative to arrival."""
        values = []
        for v in [deadline_ms] + [s.deadline_ms for s in specs]:
            if v is None:
                continue
            v = float(v)
            if v <= 0:
                raise ValueError(f"deadline_ms must be > 0, got {v}")
            values.append(v)
        return min(values) if values else None

    def submit(self, specs: List[QuerySpec], budget: Optional[int] = None,
               workload: Optional[str] = None,
               priority: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               trace_id: Optional[str] = None) -> _Submission:
        """Enqueue one submission with the scheduler (HTTP-free entry point;
        the handler and in-process tests both use it).  Raises
        :class:`UnknownWorkload` for unmounted names, ``ValueError`` for
        bad priority/deadline values, and ``RuntimeError`` once shutdown
        has begun — callers must not be left waiting on a submission no
        scheduler will ever pick up."""
        name = self._resolve_workload(specs, workload)
        prio = self._resolve_priority(specs, priority)
        deadline_rel = self._resolve_deadline(specs, deadline_ms)
        sub = _Submission(specs=specs, budget=budget, workload=name)
        sub.created_at = time.monotonic()
        # the root of this request's span tree; the queue span runs from
        # admission until _run_batch/_fail_batch closes it at grant/failure
        sub.trace = self.obs.tracer.start(
            "request", trace_id=trace_id, workload=name, priority=prio,
            n_specs=len(specs))
        sub.queue_span = sub.trace.new_span("sched.queue")
        task = ScheduledTask(workload=name, submissions=[sub], priority=prio,
                             budget=budget)
        with self._stats_lock:
            if not self._started:
                raise RuntimeError("server is shutting down")
            self.stats["requests"] += 1
            self.stats["specs"] += len(specs)
            ws = self._wl_stats.setdefault(name,
                                           dict.fromkeys(_WL_COUNTERS, 0))
            ws["requests"] += 1
            ws["specs"] += len(specs)
            scheduler = self._scheduler
        # the relative deadline becomes absolute against the same monotonic
        # clock the scheduler orders by
        if deadline_rel is not None:
            task.deadline = time.monotonic() + deadline_rel / 1e3
        scheduler.submit(task)
        return sub

    # -- scheduler callbacks -------------------------------------------------
    def _load_entry(self, task: ScheduledTask) -> WorkloadEntry:
        return self.registry.get(task.workload)

    def _fail_task(self, task: ScheduledTask, e: Exception,
                   status: int) -> None:
        self._fail_batch(task.workload, task.submissions, e, status)

    # -- execution -----------------------------------------------------------
    def _bump(self, workload: str, **deltas: int) -> None:
        with self._stats_lock:
            ws = self._wl_stats.setdefault(workload,
                                           dict.fromkeys(_WL_COUNTERS, 0))
            for k, v in deltas.items():
                self.stats[k] += v
                ws[k] += v

    def _finish_trace(self, sub: _Submission, **attrs: Any) -> None:
        """Close a submission's trace into the flight recorder (no-op for
        trace-free submissions and disabled observability)."""
        trace = sub.trace
        if trace is None:
            return
        if sub.queue_span is not None:
            sub.queue_span.end()
        trace.set(**attrs)
        self.obs.tracer.finish(trace)

    def _fail_batch(self, workload: str, batch: List[_Submission],
                    e: Exception, status: int) -> None:
        self._bump(workload, errors=1)
        for sub in batch:
            sub.error = f"{type(e).__name__}: {e}"
            sub.status = status
            self._finish_trace(sub, error=sub.error, status=status)
            sub.done.set()

    def _run_batch(self, task: ScheduledTask, entry: WorkloadEntry) -> None:
        workload, batch = task.workload, task.submissions
        specs = [s for sub in batch for s in sub.specs]
        budget = batch[0].budget if len(batch) == 1 else None
        # the merged batch executes under the FIRST submission's trace;
        # absorbed co-travelers close their queue span here and their root
        # points at the primary trace that answered them
        primary_trace = batch[0].trace
        for sub in batch:
            if sub.queue_span is not None:
                sub.queue_span.end()
        if primary_trace is not None:
            for sub in batch[1:]:
                if sub.trace is not None:
                    sub.trace.set(coalesced_into=primary_trace.trace_id)
        scheduler = self._scheduler
        kw = dict(self.session_kw)
        if scheduler is not None:
            # the preemption contract: the session yields to the scheduler
            # between oracle slices; the scheduler may park it there
            kw.setdefault("checkpoint", lambda: scheduler.checkpoint(task))
            if scheduler.preempt_slice is not None:
                kw.setdefault("slice_size", scheduler.preempt_slice)
        # activate: every span opened below this thread (session prefetch,
        # broker flush, oracle sub-batches, preempt pauses) lands on the
        # primary trace without any layer holding a trace object
        with activate(primary_trace):
            session = QuerySession(entry.engine, specs, budget=budget, **kw)
            try:
                # plan separately first: it spends no oracle budget, and its
                # failures (malformed knobs, bad score names, impossible
                # budgets) are the CLIENT's — 400
                with trace_span("session.plan", n_specs=len(specs)):
                    session.plan()
            except Exception as e:  # noqa: BLE001 - fault barrier per batch
                self._fail_batch(workload, batch, e, 400)
                return
            try:
                with trace_span("session.execute") as esp:
                    out = session.execute()
            except Exception as e:  # noqa: BLE001 - execution faults are OURS
                self._fail_batch(workload, batch, e, 500)
                return
        rows = [result_row(r, workload=workload) for r in out.results]
        esp.set(fresh=out.stats.get("n_oracle_fresh"),
                cached=out.stats.get("n_oracle_cached"))
        session = {**out.stats,
                   "workload": workload,
                   "priority": task.priority,
                   "queue_wait_s": round(
                       (task.first_grant_at or task.enqueued_at)
                       - task.enqueued_at, 6),
                   "preemptions": task.preemptions,
                   "coalesced_requests": len(batch),
                   "coalesced_specs": len(specs)}
        now = time.monotonic()
        pos = 0
        for sub in batch:
            sub.rows = rows[pos:pos + len(sub.specs)]
            pos += len(sub.specs)
            sub.session = session
            self._finish_trace(
                sub, status=200,
                fresh=sum(r["n_oracle_fresh"] for r in sub.rows),
                cached=sum(r["n_oracle_cached"] for r in sub.rows),
                preemptions=task.preemptions,
                coalesced_requests=len(batch))
            self._latency_hist(workload).observe(
                now - (sub.created_at or task.enqueued_at))
            sub.done.set()
        self._bump(workload, sessions=1, coalesced=len(batch) - 1)

    # -- observability -------------------------------------------------------
    def _latency_hist(self, workload: str):
        """The per-workload request-latency histogram, resolved once.  A
        racing double-create is benign: the registry's family child() is
        get-or-create, both racers receive the same instrument."""
        h = self._h_latency.get(workload)
        if h is None:
            h = self.obs.histogram(
                "request_latency_seconds",
                help="submission admission-to-response latency",
                workload=workload)
            self._h_latency[workload] = h
        return h

    def _collect_derived(self) -> List[Sample]:
        """Scrape-time collector: every layer keeps plain-dict counters
        (zero registry traffic on its hot path); one pass here turns
        consistent snapshots of them (broker counters+accounts under one
        lock, scheduler under its condition) into Prometheus samples."""
        out: List[Sample] = []

        def c(name: str, value, help: str = "", **labels) -> None:
            out.append(Sample(name, float(value), "counter",
                              labels or None, help))

        def g(name: str, value, help: str = "", **labels) -> None:
            out.append(Sample(name, float(value), "gauge",
                              labels or None, help))

        with self._stats_lock:
            wl_stats = {k: dict(v) for k, v in self._wl_stats.items()}
            scheduler = self._scheduler
        for name, ws in wl_stats.items():
            for key, v in ws.items():
                c(f"server_{key}_total", v, workload=name)
        if scheduler is not None:
            snap = scheduler.snapshot()
            per_wl = snap.pop("workloads", {})
            c("sched_submitted_total", snap["submitted"])
            c("sched_slices_total", snap["slices"])
            c("sched_shed_total", snap["shed"])
            g("sched_active", snap["active"])
            g("sched_waiting", snap["waiting"])
            g("sched_paused", snap["paused"])
            for name, ws in per_wl.items():
                g("sched_queue_depth", ws["depth"], workload=name)
                c("sched_admitted_total", ws["admitted"], workload=name)
                c("sched_merged_total", ws["merged"], workload=name)
                c("sched_preempted_total", ws["preempted"], workload=name)
                g("sched_wait_max_seconds", ws["wait_max_s"], workload=name)
        for entry in self.registry.entries():
            if not entry.loaded:  # scraping must never trigger a lazy load
                continue
            name = entry.name
            engine = entry.engine
            broker_gauges = {"cache_size", "n_pending", "n_inflight",
                             "max_pending"}
            for key, v in engine.broker.observe(
                    recent_accounts=1)["stats"].items():
                if key in broker_gauges:
                    g(f"oracle_{key}", v, workload=name)
                else:
                    c(f"oracle_{key}_total", v, workload=name)
            for key, v in engine.stats.items():
                c(f"engine_{key}_total", v, workload=name)
            pool = engine.oracle_pool
            if pool is not None:
                ps = pool.snapshot()
                for key in ("flushes", "dispatched", "batches", "retries",
                            "failures", "steals"):
                    c(f"oracle_pool_{key}_total", ps[key], workload=name)
                for i, v in enumerate(ps["per_replica"]):
                    c("oracle_pool_replica_batches_total", v,
                      workload=name, replica=i)
                for i, v in enumerate(ps["per_replica_latency_ewma_s"]):
                    g("oracle_pool_replica_latency_ewma_seconds", v,
                      workload=name, replica=i)
                for i, v in enumerate(ps["per_replica_rate_ewma"]):
                    g("oracle_pool_replica_rate_ewma_labels_per_second", v,
                      workload=name, replica=i)
                for i, alive in enumerate(ps["per_replica_alive"]):
                    g("oracle_pool_replica_alive", 1 if alive else 0,
                      workload=name, replica=i)
            resident = getattr(engine, "resident", None)
            if resident is not None:
                for key, v in resident.stats.items():
                    c(f"resident_{key}_total", v, workload=name)
                g("resident_enabled", 1 if resident.enabled else 0,
                  workload=name)
            if entry.store is not None:
                tiers = entry.store.observe()
                g("label_store_labels", tiers["n_labels"], workload=name)
                g("label_store_tier_bytes", tiers["hot"]["bytes"],
                  "resident bytes per store tier",
                  workload=name, tier="hot")
                g("label_store_tier_bytes", tiers["warm"]["bytes"],
                  workload=name, tier="warm")
                g("label_store_tier_bytes", tiers["journal"]["bytes"],
                  workload=name, tier="journal")
                g("label_store_tier_entries", tiers["hot"]["entries"],
                  workload=name, tier="hot")
                g("label_store_tier_entries", tiers["warm"]["entries"],
                  workload=name, tier="warm")
                if tiers["hot"]["budget"] is not None:
                    g("label_store_hot_budget_bytes",
                      tiers["hot"]["budget"], workload=name)
                g("label_store_hot_pinned", tiers["hot"]["pinned"],
                  "hot entries not yet evictable (dirty or journal-only)",
                  workload=name)
                c("label_store_hits_total", tiers["hits"]["hot"],
                  "broker cache hits answered per store tier",
                  workload=name, tier="hot")
                c("label_store_hits_total", tiers["hits"]["warm"],
                  workload=name, tier="warm")
                g("label_store_warm_segments",
                  tiers["warm"]["segments"], workload=name)
                g("label_store_journal_segments",
                  tiers["journal"]["segments"], workload=name)
                g("label_store_journal_oldest_age_seconds",
                  tiers["journal"]["oldest_age_s"],
                  "age of the oldest un-compacted journal byte",
                  workload=name)
                for key, v in tiers["counters"].items():
                    if key.startswith("hits_"):
                        continue  # exported above, tier-labeled
                    c(f"label_store_{key}_total", v, workload=name)
            g("index_records", engine.index.n_records, workload=name)
            g("index_reps", engine.index.n_reps, workload=name)
            g("index_version", engine.index.version, workload=name)
        recorder = self.obs.recorder
        if recorder is not None:
            c("traces_recorded_total", recorder.recorded)
            g("traces_buffered", len(recorder))
        return out

    def metrics_payload(self) -> str:
        """The Prometheus text exposition (``GET /metrics`` body)."""
        return self.obs.metrics.render()

    def traces_payload(self, trace_id: Optional[str] = None,
                       fmt: Optional[str] = None,
                       limit: int = 32) -> Tuple[Dict[str, Any], int]:
        """(payload, status) for ``GET /debug/traces``: recent trace
        summaries, one full trace by id, or its Chrome-trace export."""
        recorder = self.obs.recorder
        if recorder is None:
            return {"error": "observability is disabled"}, 404
        if trace_id is None:
            summaries = recorder.summaries()
            if limit > 0:
                summaries = summaries[-limit:]
            return {"recorded": recorder.recorded,
                    "buffered": len(recorder),
                    "traces": summaries}, 200
        trace = recorder.find(trace_id)
        if trace is None:
            return {"error": f"trace {trace_id!r} is not in the flight "
                             f"recorder (capacity {recorder.capacity})"}, 404
        if fmt == "chrome":
            return chrome_trace(trace), 200
        return trace.to_dict(), 200

    # -- introspection -------------------------------------------------------
    @staticmethod
    def _entry_payload(entry: WorkloadEntry) -> Dict[str, Any]:
        """Engine/broker/accounts/index/store/pool sections for one loaded
        workload (the pre-registry /stats body, now per workload)."""
        engine = entry.engine
        broker = engine.broker
        # counters AND account rows under one broker lock pass: a scrape
        # racing a flush can never pair totals and accounts from different
        # instants (the flush publish phase bumps both atomically)
        observed = broker.observe(recent_accounts=32)
        snapshot = observed["stats"]
        payload: Dict[str, Any] = {
            "engine": dict(engine.stats),
            "broker": snapshot,
            "accounts": {
                # all-time totals come from the broker (the per-account ring
                # is bounded); "recent" is the last few specs' accounts
                "fresh_total": snapshot["fresh"],
                "cached_total": snapshot["cached"],
                "recent": observed["accounts"],
            },
            "index": {"records": engine.index.n_records,
                      "reps": engine.index.n_reps,
                      "version": engine.index.version},
        }
        pool = engine.oracle_pool
        if pool is not None:
            payload["oracle_pool"] = pool.snapshot()
        if entry.store is not None:
            tiers = entry.store.observe()
            payload["store"] = {"path": str(entry.store.path),
                                "n_labels": tiers["n_labels"],
                                "index_version": entry.store.index_version,
                                "tiers": tiers}
        return payload

    def stats_payload(self) -> Dict[str, Any]:
        default = self.registry.default
        with self._stats_lock:
            server_stats = dict(self.stats)
            wl_stats = {k: dict(v) for k, v in self._wl_stats.items()}
            scheduler = self._scheduler
        sched_snap = scheduler.snapshot() if scheduler is not None else {}
        sched_wl = sched_snap.pop("workloads", {})
        recorder = self.obs.recorder
        payload: Dict[str, Any] = {
            "server": {**server_stats,
                       "admission_window_s": self.admission_window,
                       "max_workers": self.max_workers,
                       "default_workload": default,
                       "scheduler": sched_snap,
                       "observability": {
                           "enabled": self.obs.enabled,
                           "traces_recorded": (recorder.recorded
                                               if recorder else 0),
                           "traces_buffered": (len(recorder)
                                               if recorder else 0)}},
            "workloads": {},
        }
        for entry in self.registry.entries():
            wp: Dict[str, Any] = {"loaded": entry.loaded}
            if entry.loaded:
                wp.update(self._entry_payload(entry))
            wp["server"] = wl_stats.get(entry.name,
                                        dict.fromkeys(_WL_COUNTERS, 0))
            # per-workload queue observability: depth + wait-time counters
            wp["queue"] = sched_wl.get(entry.name, {
                "depth": 0, "active": 0, "share": 1.0, "cap": None,
                "admitted": 0, "merged": 0, "preempted": 0,
                "wait_mean_s": 0.0, "wait_max_s": 0.0})
            payload["workloads"][entry.name] = wp
        # single-workload compatibility: the default workload's sections are
        # mirrored at top level (exactly the pre-registry payload shape) —
        # the SAME dict objects, one broker snapshot, so the mirror can
        # never disagree with the per-workload section within one response
        mirror = payload["workloads"].get(default)
        if mirror is not None and mirror["loaded"]:
            payload.update({k: v for k, v in mirror.items()
                            if k not in ("loaded", "server", "queue")})
        return payload

    def workloads_payload(self) -> Dict[str, Any]:
        with self._stats_lock:
            wl_stats = {k: dict(v) for k, v in self._wl_stats.items()}
        rows = self.registry.describe()
        for row in rows:
            row["requests"] = wl_stats.get(row["name"], {}).get("requests", 0)
        return {"default": self.registry.default, "workloads": rows}

    def health_payload(self) -> Dict[str, Any]:
        workloads = {}
        for e in self.registry.entries():
            w: Dict[str, Any] = {"loaded": e.loaded}
            if e.load_error is not None:
                w["error"] = str(e.load_error)
            workloads[e.name] = w
        # ok means the server itself is serving; a dead mount is visible
        # per workload (its requests fail fast with the memoized error)
        return {"ok": True, "workloads": workloads}


class _Handler(BaseHTTPRequestHandler):
    owner: QueryServer = None  # bound per-server by QueryServer.start()

    def log_message(self, *args) -> None:  # quiet: stats are at /stats
        pass

    def _reply(self, status: int, payload: Dict[str, Any]) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_text(self, status: int, text: str) -> None:
        body = text.encode()
        self.send_response(status)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:
        parsed = urlparse(self.path)
        path = parsed.path
        if path == "/healthz":
            self._reply(200, self.owner.health_payload())
        elif path == "/stats":
            self._reply(200, self.owner.stats_payload())
        elif path == "/workloads":
            self._reply(200, self.owner.workloads_payload())
        elif path == "/metrics":
            self._reply_text(200, self.owner.metrics_payload())
        elif path == "/debug/traces":
            q = parse_qs(parsed.query)
            try:
                limit = int(q.get("limit", ["32"])[0])
            except ValueError:
                self._reply(400, {"error": "limit must be an integer"})
                return
            payload, status = self.owner.traces_payload(
                trace_id=q.get("id", [None])[0],
                fmt=q.get("format", [None])[0],
                limit=limit)
            self._reply(status, payload)
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self) -> None:
        if self.path == "/shutdown":
            self._reply(200, {"ok": True, "shutting_down": True})
            # a fresh NON-daemon thread: shutdown() joins the serving threads
            # and must survive the main thread exiting (its final store save
            # must not be killed mid-write)
            threading.Thread(target=self.owner.shutdown).start()
            return
        if self.path != "/query":
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"null")
            workload = priority = deadline_ms = None
            trace_id = self.headers.get("X-Trace-Id")
            if isinstance(body, list):
                raw_specs, budget = body, None
            elif isinstance(body, dict):
                raw_specs = body.get("specs")
                budget = body.get("budget")
                workload = body.get("workload")
                priority = body.get("priority")
                deadline_ms = body.get("deadline_ms")
                trace_id = body.get("trace_id", trace_id)
            else:
                raise ValueError(
                    "body must be a JSON list of specs or {'specs': [...], "
                    "'budget': int, 'workload': str, 'priority': int, "
                    "'deadline_ms': float}")
            if not raw_specs:
                raise ValueError("no specs in request")
            specs = [QuerySpec.from_dict(d) for d in raw_specs]
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            return
        try:
            sub = self.owner.submit(specs, budget=budget, workload=workload,
                                    priority=priority,
                                    deadline_ms=deadline_ms,
                                    trace_id=trace_id)
        except ValueError as e:  # unknown workload / bad priority or deadline
            self._reply(400, {"error": str(e)})
            return
        except RuntimeError as e:
            self._reply(503, {"error": str(e)})
            return
        if not sub.done.wait(timeout=self.owner.request_timeout):
            self._reply(504, {"error": "query timed out in the session pool"})
            return
        if sub.error is not None:
            self._reply(sub.status, {"error": sub.error})
            return
        self._reply(200, {
            "results": sub.rows,
            "session": sub.session,
            "request": {
                "workload": sub.workload,
                "n_specs": len(sub.rows),
                "fresh": sum(r["n_oracle_fresh"] for r in sub.rows),
                "cached": sum(r["n_oracle_cached"] for r in sub.rows),
                # "" when tracing is off (NULL_TRACE) -> omit as None
                "trace_id": getattr(sub.trace, "trace_id", None) or None,
            },
        })
