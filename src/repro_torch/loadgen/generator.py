"""The open-loop firing engine and its latency report.

:class:`OpenLoopGenerator` materializes an arrival schedule
(:class:`~repro_torch.loadgen.arrivals.ArrivalProcess`), samples a request per
arrival (:class:`~repro_torch.loadgen.mix.SpecMix`), and a single pacer walks the
schedule, firing each request on its own worker thread at its scheduled
time — *never* waiting for earlier requests to finish.  If the server falls
behind, requests pile up in its queues (that is the point); the generator's
own firing jitter is recorded separately so a slow harness cannot
masquerade as a slow server.

Outstanding worker threads are capped by ``max_inflight`` (default:
unlimited).  Against a stalled server an unbounded open loop accumulates
one parked thread per arrival, and past a few thousand the spawn cost
itself distorts fire-lag percentiles — the harness's health metric — so a
bounded run sheds load instead: an arrival that finds ``max_inflight``
requests still outstanding is recorded as *dropped*
(``error_kind="dropped"``), excluded from error counts and latency
percentiles, and tallied in ``LoadReport.dropped`` (total and per class).

``post`` is any callable ``(specs, budget, priority, deadline_ms, name) ->
object``; an exception marks the request failed and its message is kept.
Errors are classified by kind — ``connect`` (``OSError``: refused,
reset, timeout — the client never got an answer), ``http_4xx``/``http_5xx``
(an exception carrying an integer ``status`` attribute, e.g.
:class:`repro_torch.serve.client.ServerError`), ``other`` — so server-side faults
are not hidden behind client connectivity noise.  A ``post`` that accepts a
``trace_id`` keyword gets one per request (stamped on the outcome too), tying
every fired request to its server-side span tree in the flight recorder.
The report aggregates per class: counts, error counts by kind, p50/p90/p99
latency.
"""
from __future__ import annotations

import inspect
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.loadgen.arrivals import ArrivalProcess
from repro_torch.loadgen.mix import SpecMix
from repro_torch.obs.trace import new_trace_id

PostFn = Callable[..., Any]


def _accepts_kwarg(fn: Callable, name: str) -> bool:
    """Does ``fn`` accept ``name`` as a keyword (directly or via **kw)?
    Inspected once at construction so old post callables keep working."""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):  # builtins / C callables: don't risk it
        return False
    return name in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


@dataclass
class RequestOutcome:
    """One fired request, from schedule to completion."""
    name: str                       # SpecClass name
    scheduled_s: float              # offset in the arrival schedule
    fired_s: float = 0.0            # when the thread actually posted
    done_s: float = 0.0             # when the response (or error) landed
    ok: bool = False
    error: Optional[str] = None
    # connect | http_4xx | http_5xx | other | dropped (never fired: the
    # max_inflight cap was full at its scheduled time)
    error_kind: Optional[str] = None
    trace_id: Optional[str] = None    # stamped when post accepts trace_id
    response: Any = None

    @property
    def latency_s(self) -> float:
        """Client-observed latency (post to response)."""
        return self.done_s - self.fired_s

    @property
    def fire_lag_s(self) -> float:
        """Harness jitter: how late the thread fired vs the schedule."""
        return self.fired_s - self.scheduled_s


def _classify_error(e: Exception) -> str:
    """connect (no answer) vs http_4xx/http_5xx (the server answered with a
    failure status, exposed via an integer ``status`` attr) vs other.
    ``status`` is checked first: an HTTP-status-carrying error that happens
    to subclass OSError is still a *server* answer, not connectivity."""
    status = getattr(e, "status", None)
    if isinstance(status, int) and not isinstance(status, bool):
        return "http_4xx" if 400 <= status < 500 else "http_5xx"
    if isinstance(e, OSError):
        return "connect"
    return "other"


def _percentiles(values_ms: List[float]) -> Dict[str, float]:
    if not values_ms:
        return {"p50_ms": 0.0, "p90_ms": 0.0, "p99_ms": 0.0}
    arr = np.asarray(values_ms, np.float64)
    p50, p90, p99 = np.percentile(arr, [50, 90, 99])
    return {"p50_ms": round(float(p50), 3), "p90_ms": round(float(p90), 3),
            "p99_ms": round(float(p99), 3)}


@dataclass
class LoadReport:
    """Everything one open-loop run observed."""
    duration_s: float
    offered: int                              # scheduled arrivals
    completed: int
    errors: int                               # fired and failed (by kind)
    connect_errors: int                       # never reached the server
    http_errors: int                          # server answered 4xx/5xx
    dropped: int                              # never fired: inflight cap full
    max_fire_lag_ms: float                    # harness health, not server's
    classes: Dict[str, Dict[str, float]]      # per-class n/ok/errors/pXX_ms
    outcomes: List[RequestOutcome] = field(repr=False, default_factory=list)


class OpenLoopGenerator:
    """Fire a :class:`SpecMix` at an :class:`ArrivalProcess` schedule.

        gen = OpenLoopGenerator(post, mix, process, duration_s=3.0)
        report = gen.run()

    ``run`` blocks until every fired request has completed or errored (the
    *firing* is open-loop; the run still ends cleanly).  Pre-sampling the
    whole schedule before the first shot keeps sampling cost off the firing
    path and makes the request train a pure function of the seeds.

    ``max_inflight`` bounds outstanding worker threads; an arrival landing
    while the cap is full is *dropped*, not delayed — delaying it would
    close the loop and understate offered load.  ``None`` (the default)
    keeps the historic unbounded behavior.
    """

    def __init__(self, post: PostFn, mix: SpecMix, process: ArrivalProcess,
                 duration_s: float, max_inflight: Optional[int] = None):
        if duration_s <= 0:
            raise ValueError(f"duration_s must be > 0, got {duration_s}")
        if max_inflight is not None and max_inflight <= 0:
            raise ValueError(
                f"max_inflight must be > 0 or None, got {max_inflight}")
        self.post = post
        self.mix = mix
        self.process = process
        self.duration_s = float(duration_s)
        self.max_inflight = max_inflight
        self._post_takes_trace = _accepts_kwarg(post, "trace_id")

    def run(self) -> LoadReport:
        offsets = self.process.times(self.duration_s)
        plan = []
        for off in offsets:
            cls, specs, budget = self.mix.sample()
            plan.append((off, cls, specs, budget))
        outcomes = [RequestOutcome(name=cls.name, scheduled_s=off)
                    for off, cls, _, _ in plan]
        slots = (threading.Semaphore(self.max_inflight)
                 if self.max_inflight is not None else None)
        threads: List[threading.Thread] = []
        t0 = time.monotonic()

        def fire(i: int) -> None:
            _, cls, specs, budget = plan[i]
            out = outcomes[i]
            out.fired_s = time.monotonic() - t0
            kwargs = dict(budget=budget, priority=cls.priority,
                          deadline_ms=cls.deadline_ms, name=cls.name)
            if self._post_takes_trace:
                out.trace_id = new_trace_id()
                kwargs["trace_id"] = out.trace_id
            try:
                out.response = self.post(specs, **kwargs)
                out.ok = True
            except Exception as e:  # noqa: BLE001 - outcome, not crash
                out.error = f"{type(e).__name__}: {e}"
                out.error_kind = _classify_error(e)
            finally:
                out.done_s = time.monotonic() - t0
                if slots is not None:
                    slots.release()

        # one pacer walks the schedule: sleep to each arrival, then hand it
        # to a fresh worker thread (or shed it when the cap is full)
        for i, (off, _, _, _) in enumerate(plan):
            delay = (t0 + off) - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            if slots is not None and not slots.acquire(blocking=False):
                out = outcomes[i]
                out.fired_s = out.done_s = time.monotonic() - t0
                out.error = (f"dropped: {self.max_inflight} requests "
                             "already in flight")
                out.error_kind = "dropped"
                continue
            t = threading.Thread(target=fire, args=(i,),
                                 name=f"loadgen-{i}", daemon=True)
            threads.append(t)
            t.start()
        for t in threads:
            t.join()

        def _kind_count(who: List[RequestOutcome], *kinds: str) -> int:
            return sum(o.error_kind in kinds for o in who if not o.ok)

        classes: Dict[str, Dict[str, float]] = {}
        for cls in self.mix.classes:
            mine = [o for o in outcomes if o.name == cls.name]
            ok = [o for o in mine if o.ok]
            dropped = _kind_count(mine, "dropped")
            classes[cls.name] = {
                "n": len(mine),
                "ok": len(ok),
                "errors": len(mine) - len(ok) - dropped,
                "connect_errors": _kind_count(mine, "connect"),
                "http_errors": _kind_count(mine, "http_4xx", "http_5xx"),
                "dropped": dropped,
                **_percentiles([o.latency_s * 1e3 for o in ok]),
            }
        dropped = _kind_count(outcomes, "dropped")
        return LoadReport(
            duration_s=self.duration_s,
            offered=len(plan),
            completed=sum(o.ok for o in outcomes),
            errors=sum(not o.ok for o in outcomes) - dropped,
            connect_errors=_kind_count(outcomes, "connect"),
            http_errors=_kind_count(outcomes, "http_4xx", "http_5xx"),
            dropped=dropped,
            max_fire_lag_ms=round(max(
                (o.fire_lag_s * 1e3 for o in outcomes), default=0.0), 3),
            classes=classes,
            outcomes=outcomes,
        )
