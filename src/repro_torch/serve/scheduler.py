"""SLO-aware query scheduler: the layer between admission and execution.

The pre-scheduler server admitted work through per-workload lanes with a
fixed coalescing delay and handed batches to an unordered thread pool — so
under mixed traffic one 10k-budget limit scan could hold a worker for
seconds while a stream of cheap aggregations queued behind it.
:class:`QueryScheduler` replaces those lanes with iteration-level
scheduling in the style of Sarathi-Serve:

* **waiting / running queues** — every admitted request becomes a
  :class:`ScheduledTask` in the waiting queue; ``max_workers`` *logical
  slots* bound how many tasks execute concurrently.  Each task runs on its
  own thread (threads are cheap and plentiful — the HTTP front end already
  spawns one per connection); the slots, not the threads, are the scarce
  resource, which is what makes preemption possible: a paused task blocks
  on its checkpoint *without* holding a slot;
* **priority classes + EDF** — tasks are ordered by ``(priority class,
  deadline)``: strictly by class first (0 = most urgent), then earliest
  deadline first within a class (``deadline_ms`` on the spec or request,
  relative to arrival); tasks without a deadline sort after those with one
  and fall back to weighted fair sharing, then arrival order;
* **weighted shares + per-workload caps** — among equally urgent work,
  the workload with the smallest ``active_slots / share`` ratio is served
  next, and a workload at its ``cap`` cannot take another slot no matter
  how urgent its queue is (a noisy tenant cannot monopolize the pool);
* **preemption at slice boundaries** — every session executes with a
  *checkpoint* callback that the engine invokes between oracle-microbatch-
  sized slices of every scan (see ``QueryEngine._make_oracle``).  When a
  strictly higher-class task is waiting and no slot is free, the scheduler
  flags the worst running task; at its next checkpoint that task releases
  its slot, re-enters the waiting queue (keeping its class, deadline, and
  arrival order), and blocks until re-granted.  Slicing never changes
  which ids are requested, in what order, or on which account — labels
  and :class:`~repro_torch.core.broker.OracleAccount` fresh/cached charges are
  byte-identical to unscheduled execution;
* **coalescing preserved** — with ``admission_window > 0``, an unbudgeted
  task becomes runnable only ``admission_window`` seconds after arrival,
  and when granted it absorbs every waiting same-workload, same-class,
  unbudgeted task into its shared session (the paper's cross-query
  amortization).  ``admission_window=0`` disables sharing entirely, same
  as the pre-scheduler lanes.

The scheduler is deliberately mechanism, not policy host: it knows nothing
about HTTP or sessions.  The server injects three callbacks — ``load``
(resolve the workload entry, possibly paying a lazy index build), ``run``
(execute the task's merged submissions), and ``fail`` (error out every
submission) — and the scheduler owns ordering, slots, merging, preemption,
and the queue-wait accounting surfaced at ``/stats``.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.obs import NULL_SCOPE
from repro_torch.obs.trace import add_timed_span

#: Scheduling class for specs/requests that do not set one.  Lower is more
#: urgent; 0 is the conventional interactive class, leaving room on both
#: sides of the default.
DEFAULT_PRIORITY = 1

_WL_KEYS = ("admitted", "merged", "preempted", "waits",
            "wait_total_s", "wait_max_s")


@dataclass(eq=False)  # identity semantics: tasks live in queues and sets
class ScheduledTask:
    """One admitted request (or several, once merged) moving through the
    waiting -> running (-> paused -> running)* -> done lifecycle."""

    workload: str
    submissions: List[Any]            # server-side _Submission objects
    priority: int = DEFAULT_PRIORITY
    deadline: Optional[float] = None  # absolute time.monotonic() seconds
    budget: Optional[int] = None      # budgeted tasks are never merged
    enqueued_at: float = 0.0
    ready_at: float = 0.0             # arrival + admission window (coalescible)
    seq: int = 0                      # admission order (final tie-break)
    # scheduler-managed state, guarded by the scheduler's condition lock
    state: str = "waiting"            # waiting|running|paused|done
    started: bool = False             # first slot grant happened
    absorbed: bool = False            # merged into another task's session
    pause_requested: bool = False
    preemptions: int = 0
    first_grant_at: Optional[float] = None

    def sort_key(self, active_per_share: float):
        """(class, EDF, weighted-fair underservice, arrival order)."""
        return (self.priority,
                self.deadline if self.deadline is not None else float("inf"),
                active_per_share,
                self.seq)


@dataclass
class _WorkloadSched:
    """Per-workload scheduling config + counters."""
    share: float = 1.0
    cap: Optional[int] = None
    active: int = 0
    stats: Dict[str, float] = field(
        default_factory=lambda: dict.fromkeys(_WL_KEYS, 0))
    h_wait: Any = None  # sched_queue_wait_seconds{workload=...} histogram


class QueryScheduler:
    """Waiting/running queues with shares, caps, EDF, and preemption.

        sched = QueryScheduler(load, run, fail, max_workers=4,
                               shares={"video": 3.0}, caps={"text": 1},
                               admission_window=0.05, preempt=True)
        sched.submit(task)          # returns immediately; task runs async
        ...
        sched.shutdown()            # drain running, shed waiting (503)

    ``preempt_slice`` sets the ids-per-slice granularity of the checkpoint
    contract (None = each workload engine's oracle microbatch size, which
    keeps broker batch counts identical to unscheduled runs).
    """

    def __init__(self,
                 load: Callable[[ScheduledTask], Any],
                 run: Callable[[ScheduledTask, Any], None],
                 fail: Callable[[ScheduledTask, Exception, int], None],
                 max_workers: int = 4,
                 shares: Optional[Dict[str, float]] = None,
                 caps: Optional[Dict[str, int]] = None,
                 admission_window: float = 0.0,
                 preempt: bool = True,
                 preempt_slice: Optional[int] = None,
                 obs=None):
        if max_workers < 1:
            raise ValueError(f"max_workers must be >= 1, got {max_workers}")
        self._load = load
        self._run = run
        self._fail = fail
        self._obs = obs if obs is not None else NULL_SCOPE
        # one counter child per grant reason, resolved once (lock-cheap inc
        # is the only hot-path cost; disabled obs makes these no-ops)
        self._c_grants = {
            reason: self._obs.counter(
                "sched_grants_total",
                help="slot grants by reason (first|resume|drain)",
                reason=reason)
            for reason in ("first", "resume", "drain")}
        self.max_workers = int(max_workers)
        self.admission_window = float(admission_window)
        self.preempt = bool(preempt)
        self.preempt_slice = preempt_slice
        self._cond = threading.Condition()
        self._waiting: List[ScheduledTask] = []
        self._running_tasks: set = set()  # tasks currently holding a slot
        self._wl: Dict[str, _WorkloadSched] = {}
        for name, share in (shares or {}).items():
            if share <= 0:
                raise ValueError(f"share for {name!r} must be > 0, "
                                 f"got {share}")
            self._wl_state(name).share = float(share)
        for name, cap in (caps or {}).items():
            if cap < 1:
                raise ValueError(f"cap for {name!r} must be >= 1, got {cap}")
            self._wl_state(name).cap = int(cap)
        self._n_active = 0
        self._n_paused = 0
        self._seq = 0
        self._closed = False
        self._draining = False
        self._threads: Dict[int, threading.Thread] = {}
        self.stats: Dict[str, int] = {
            "submitted": 0,    # tasks entering the waiting queue
            "granted": 0,      # first slot grants (excludes resumes)
            "merged": 0,       # tasks absorbed into another's session
            "preemptions": 0,  # pause-at-checkpoint events
            "slices": 0,       # checkpoint calls (execution progress beats)
            "shed": 0,         # waiting tasks failed by shutdown
        }

    # -- helpers (call with self._cond held) ---------------------------------
    def _wl_state(self, name: str) -> _WorkloadSched:
        ws = self._wl.get(name)
        if ws is None:
            ws = self._wl[name] = _WorkloadSched()
            ws.h_wait = self._obs.histogram(
                "sched_queue_wait_seconds",
                help="enqueue-to-first-grant wait per workload",
                workload=name)
        return ws

    def _best(self, now: float) -> Optional[ScheduledTask]:
        """The waiting task that should run next: min over eligible tasks of
        (priority, deadline, active/share, seq).  A workload at its cap has
        no eligible tasks regardless of urgency."""
        best: Optional[ScheduledTask] = None
        best_key = None
        for t in self._waiting:
            if t.absorbed or now < t.ready_at:
                continue
            ws = self._wl_state(t.workload)
            if ws.cap is not None and ws.active >= ws.cap:
                continue
            key = t.sort_key(ws.active / ws.share)
            if best_key is None or key < best_key:
                best, best_key = t, key
        return best

    def _request_preemption(self, task: ScheduledTask) -> None:
        """Flag the worst strictly-lower-class running task to pause at its
        next checkpoint (idempotent; the victim may finish first, which
        frees the slot just the same)."""
        victim: Optional[ScheduledTask] = None
        victim_key = None
        for t in self._running_tasks:
            if t.priority <= task.priority:
                continue
            key = (t.priority,
                   t.deadline if t.deadline is not None else float("inf"),
                   t.seq)
            if victim_key is None or key > victim_key:
                victim, victim_key = t, key
        if victim is not None:
            victim.pause_requested = True

    def _grant(self, task: ScheduledTask, now: float) -> None:
        self._waiting.remove(task)
        ws = self._wl_state(task.workload)
        ws.active += 1
        self._n_active += 1
        self._running_tasks.add(task)
        if task.state == "paused":
            self._n_paused -= 1
        task.state = "running"
        reason = ("drain" if self._draining
                  else "resume" if task.started else "first")
        self._c_grants[reason].inc()
        if not task.started:
            task.started = True
            task.first_grant_at = now
            self.stats["granted"] += 1
            self._record_wait(ws, now - task.enqueued_at)
            # coalesce at grant: absorb every waiting same-workload,
            # same-class, unbudgeted stranger into this task's session —
            # admission_window=0 disables sharing, same as the old lanes
            if self.admission_window > 0 and task.budget is None:
                for t in list(self._waiting):
                    if (t.workload == task.workload and not t.started
                            and not t.absorbed and t.budget is None
                            and t.priority == task.priority):
                        t.absorbed = True
                        self._waiting.remove(t)
                        task.submissions.extend(t.submissions)
                        if t.deadline is not None:
                            task.deadline = (t.deadline if task.deadline is None
                                             else min(task.deadline, t.deadline))
                        self.stats["merged"] += 1
                        ws.stats["merged"] += 1
                        self._record_wait(ws, now - t.enqueued_at)
        ws.stats["admitted"] += 1
        self._cond.notify_all()

    @staticmethod
    def _record_wait(ws: _WorkloadSched, wait: float) -> None:
        ws.stats["waits"] += 1
        ws.stats["wait_total_s"] += wait
        ws.stats["wait_max_s"] = max(ws.stats["wait_max_s"], wait)
        if ws.h_wait is not None:
            ws.h_wait.observe(wait)

    # -- task lifecycle ------------------------------------------------------
    def submit(self, task: ScheduledTask) -> ScheduledTask:
        """Enqueue a task and start its thread.  Non-blocking; after
        shutdown the task fails 503 on its own thread (never stranded)."""
        now = time.monotonic()
        task.enqueued_at = now
        if task.budget is None and self.admission_window > 0:
            task.ready_at = now + self.admission_window
        else:
            task.ready_at = now
        with self._cond:
            self._seq += 1
            task.seq = self._seq
            self.stats["submitted"] += 1
            self._wl_state(task.workload)  # materialize stats row
            self._waiting.append(task)
            thread = threading.Thread(target=self._task_main, args=(task,),
                                      name=f"query-sched-{task.seq}",
                                      daemon=True)
            self._threads[task.seq] = thread
            self._cond.notify_all()
        thread.start()
        return task

    def _task_main(self, task: ScheduledTask) -> None:
        try:
            try:
                # lazy workloads pay their index build/load HERE, before the
                # task competes for a slot: a cold build never occupies a
                # slot another workload's sessions need (and a memoized
                # failed load fails every later task fast)
                entry = self._load(task)
            except Exception as e:  # noqa: BLE001 - mount faults
                self._discard(task)
                self._fail(task, e, 500)
                return
            verdict = self._acquire(task)
            if verdict == "absorbed":
                return  # another task's session answers our submissions
            if verdict == "shutdown":
                self._fail(task, RuntimeError("server is shutting down"), 503)
                return
            try:
                self._run(task, entry)
            finally:
                self._release(task)
        except BaseException as e:  # noqa: BLE001 - never strand a client
            undone = [s for s in task.submissions if not s.done.is_set()]
            if undone:
                self._fail(task, e if isinstance(e, Exception)
                           else RuntimeError(repr(e)), 500)
        finally:
            with self._cond:
                self._threads.pop(task.seq, None)

    def _discard(self, task: ScheduledTask) -> None:
        with self._cond:
            if task in self._waiting:
                self._waiting.remove(task)
            self._cond.notify_all()

    def _acquire(self, task: ScheduledTask) -> str:
        """Block until this task is granted a slot ("granted"), merged into
        another task's session ("absorbed"), or shed by shutdown
        ("shutdown").  Also the re-entry point for preempted tasks."""
        with self._cond:
            while True:
                if task.absorbed:
                    return "absorbed"
                if self._closed and not task.started:
                    if task in self._waiting:
                        self._waiting.remove(task)
                    self.stats["shed"] += 1
                    self._cond.notify_all()
                    return "shutdown"
                now = time.monotonic()
                if self._draining and task.started:
                    # shutdown drain: paused sessions finish unconditionally
                    self._grant(task, now)
                    return "granted"
                best = self._best(now)
                if best is task:
                    if self._n_active < self.max_workers:
                        self._grant(task, now)
                        return "granted"
                    if self.preempt:
                        self._request_preemption(task)
                timeout = 0.25
                if now < task.ready_at:
                    timeout = min(timeout, task.ready_at - now)
                self._cond.wait(timeout)

    def _release(self, task: ScheduledTask) -> None:
        with self._cond:
            task.state = "done"
            task.pause_requested = False
            self._running_tasks.discard(task)
            self._wl_state(task.workload).active -= 1
            self._n_active -= 1
            self._cond.notify_all()

    def checkpoint(self, task: ScheduledTask) -> None:
        """The preemption slice boundary: sessions call this between
        oracle-slice fetches.  Returns immediately unless this task was
        flagged for preemption, in which case it releases its slot, rejoins
        the waiting queue with its original class/deadline/arrival order,
        and blocks here until re-granted."""
        with self._cond:
            self.stats["slices"] += 1
            if (not task.pause_requested or self._draining
                    or task.state != "running"):
                task.pause_requested = False
                return
            task.pause_requested = False
            task.state = "paused"
            task.preemptions += 1
            self.stats["preemptions"] += 1
            ws = self._wl_state(task.workload)
            ws.stats["preempted"] += 1
            ws.active -= 1
            self._n_active -= 1
            self._n_paused += 1
            self._running_tasks.discard(task)
            self._waiting.append(task)
            self._cond.notify_all()
        t0 = time.perf_counter()
        self._acquire(task)  # started tasks always resume (never shed)
        add_timed_span("sched.preempt_pause", t0, time.perf_counter(),
                       workload=task.workload, preemption=task.preemptions)

    # -- lifecycle -----------------------------------------------------------
    def shutdown(self, wait: bool = True, timeout: float = 30.0) -> None:
        """Stop granting to new tasks (their threads shed them with a 503),
        let running and paused sessions drain, and join task threads."""
        with self._cond:
            self._closed = True
            self._draining = True
            self._cond.notify_all()
            threads = list(self._threads.values())
        if wait:
            deadline = time.monotonic() + timeout
            for t in threads:
                t.join(timeout=max(0.1, deadline - time.monotonic()))

    # -- introspection -------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Global counters + per-workload queue depth / wait-time stats
        (the ``/stats`` scheduler section)."""
        with self._cond:
            depth: Dict[str, int] = {}
            for t in self._waiting:
                if not t.absorbed:
                    depth[t.workload] = depth.get(t.workload, 0) + 1
            per_wl: Dict[str, Dict[str, Any]] = {}
            for name, ws in self._wl.items():
                waits = ws.stats["waits"]
                per_wl[name] = {
                    "depth": depth.get(name, 0),
                    "active": ws.active,
                    "share": ws.share,
                    "cap": ws.cap,
                    "admitted": int(ws.stats["admitted"]),
                    "merged": int(ws.stats["merged"]),
                    "preempted": int(ws.stats["preempted"]),
                    "wait_mean_s": (ws.stats["wait_total_s"] / waits
                                    if waits else 0.0),
                    "wait_max_s": ws.stats["wait_max_s"],
                }
            return {
                **self.stats,
                "max_workers": self.max_workers,
                "preempt": self.preempt,
                "waiting": sum(depth.values()),
                "active": self._n_active,
                "paused": self._n_paused,
                "workloads": per_wl,
            }

    def workload_snapshot(self, name: str) -> Dict[str, Any]:
        """One workload's queue section (depth + wait counters)."""
        return self.snapshot()["workloads"].get(name, {
            "depth": 0, "active": 0, "share": 1.0, "cap": None,
            "admitted": 0, "merged": 0, "preempted": 0,
            "wait_mean_s": 0.0, "wait_max_s": 0.0})
