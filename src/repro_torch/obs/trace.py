"""Span-based request tracing with a bounded flight recorder.

One :class:`Trace` is born per server request (or per CLI query) and is
*activated* on whichever thread is currently doing that request's work.
Deep layers (session, engine, broker, oracle pool) never receive a trace
object — they call the module-level :func:`span` / :func:`start_span` /
:func:`add_timed_span` helpers, which consult a thread-local and become
no-ops when no trace is active.  That keeps the disabled path to a single
``getattr`` on a ``threading.local`` and lets the same engine serve traced
and untraced callers concurrently.

Completed traces land in a :class:`FlightRecorder` — a bounded ring buffer
(``collections.deque(maxlen=N)``) holding the last N requests for
postmortems — and can be exported as Chrome trace-event JSON
(``chrome://tracing`` / Perfetto) via :func:`chrome_trace`.

Span timestamps are ``time.perf_counter()`` values (monotonic, comparable
across threads on one host); each trace also records the wall-clock epoch
at which it started so exports can be anchored to real time.
"""
from __future__ import annotations

import itertools
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, Iterable, List, Optional

__all__ = [
    "Span", "Trace", "Tracer", "FlightRecorder", "NULL_SPAN", "NULL_TRACE",
    "new_trace_id", "span", "start_span", "add_timed_span", "activate",
    "active_trace", "chrome_trace",
]

_tls = threading.local()


def new_trace_id() -> str:
    """A fresh 16-hex-char trace id (short enough to grep, unique enough)."""
    return uuid.uuid4().hex[:16]


def active_trace() -> Optional["Trace"]:
    """The trace activated on this thread, or ``None``."""
    return getattr(_tls, "trace", None)


class Span:
    """One timed operation inside a trace.  Usable as a context manager or
    via explicit :meth:`end` when the operation doesn't nest lexically
    (e.g. the scheduler queue span, ended at grant on another thread)."""

    __slots__ = ("name", "span_id", "parent_id", "t0", "t1", "attrs", "thread")

    def __init__(self, name: str, span_id: int, parent_id: Optional[int],
                 t0: Optional[float] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = time.perf_counter() if t0 is None else t0
        self.t1: Optional[float] = None
        self.attrs: Dict[str, Any] = attrs or {}
        self.thread = threading.get_ident()

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def end(self, t1: Optional[float] = None) -> None:
        if self.t1 is None:
            self.t1 = time.perf_counter() if t1 is None else t1

    @property
    def duration_s(self) -> float:
        return ((self.t1 if self.t1 is not None else time.perf_counter())
                - self.t0)

    # context-manager protocol (manual __enter__/__exit__: cheaper than
    # @contextmanager and exception-safe)
    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None and "error" not in self.attrs:
            self.attrs["error"] = f"{type(exc).__name__}: {exc}"
        self.end()
        _pop_span(self)

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "span_id": self.span_id,
                "parent_id": self.parent_id, "t0": self.t0, "t1": self.t1,
                "thread": self.thread, "attrs": self.attrs}


class _NullSpan:
    """Shared no-op stand-in returned when tracing is off.  Supports the
    full Span surface so call sites never branch."""

    __slots__ = ()
    name = ""
    span_id = -1
    parent_id = None
    t0 = 0.0
    t1 = 0.0
    attrs: Dict[str, Any] = {}
    thread = 0
    duration_s = 0.0

    def set(self, **attrs: Any) -> "_NullSpan":
        return self

    def end(self, t1: Optional[float] = None) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass

    def to_dict(self) -> Dict[str, Any]:
        return {}


NULL_SPAN = _NullSpan()


class Trace:
    """A request's spans.  Threads append concurrently (the oracle pool
    records sub-batch spans from replica timings), so mutation is locked;
    reads for export happen after completion."""

    __slots__ = ("trace_id", "name", "attrs", "started_unix", "t0", "t1",
                 "spans", "root", "_lock", "_ids", "_finished")

    def __init__(self, name: str, trace_id: Optional[str] = None,
                 **attrs: Any):
        self.trace_id = trace_id or new_trace_id()
        self.name = name
        self.attrs: Dict[str, Any] = dict(attrs)
        self.started_unix = time.time()
        self.t0 = time.perf_counter()
        self.t1: Optional[float] = None
        self.spans: List[Span] = []
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._finished = False
        self.root = Span(name, 0, None, t0=self.t0, attrs=self.attrs)
        with self._lock:
            self.spans.append(self.root)

    @property
    def finished(self) -> bool:
        return self._finished

    def set(self, **attrs: Any) -> "Trace":
        self.attrs.update(attrs)
        return self

    def new_span(self, name: str, parent_id: Optional[int] = None,
                 t0: Optional[float] = None, **attrs: Any) -> Span:
        """Create + register a span.  Parent defaults to the root; use the
        module-level :func:`span` helper to nest under the thread's
        current span automatically."""
        with self._lock:
            sid = next(self._ids)
        s = Span(name, sid, 0 if parent_id is None else parent_id,
                 t0=t0, attrs=dict(attrs) if attrs else None)
        with self._lock:
            self.spans.append(s)
        return s

    def add_timed_span(self, name: str, t0: float, t1: float,
                       parent_id: Optional[int] = None, **attrs: Any) -> Span:
        """Record an already-completed interval (e.g. a replica sub-batch
        timed inside the pool worker, attached after the fact)."""
        s = self.new_span(name, parent_id=parent_id, t0=t0, **attrs)
        s.end(t1)
        return s

    def finish(self) -> None:
        if self._finished:
            return
        self._finished = True
        self.t1 = time.perf_counter()
        self.root.end(self.t1)
        with self._lock:
            for s in self.spans:
                s.end(self.t1)      # clamp any span leaked open

    @property
    def duration_s(self) -> float:
        return (self.t1 if self.t1 is not None else time.perf_counter()) \
            - self.t0

    def find_spans(self, name: str) -> List[Span]:
        with self._lock:
            return [s for s in self.spans if s.name == name]

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            spans = [s.to_dict() for s in self.spans]
        return {"trace_id": self.trace_id, "name": self.name,
                "attrs": self.attrs, "started_unix": self.started_unix,
                "duration_s": self.duration_s, "spans": spans}

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            n = len(self.spans)
        return {"trace_id": self.trace_id, "name": self.name,
                "attrs": self.attrs, "started_unix": self.started_unix,
                "duration_s": round(self.duration_s, 6), "n_spans": n}


class _NullTrace:
    """No-op trace handed out by a disabled tracer."""

    __slots__ = ()
    trace_id = ""
    name = ""
    attrs: Dict[str, Any] = {}
    spans: List[Span] = []
    root = NULL_SPAN
    finished = True
    duration_s = 0.0

    def set(self, **attrs: Any) -> "_NullTrace":
        return self

    def new_span(self, name: str, parent_id: Optional[int] = None,
                 t0: Optional[float] = None, **attrs: Any) -> _NullSpan:
        return NULL_SPAN

    def add_timed_span(self, name: str, t0: float, t1: float,
                       parent_id: Optional[int] = None,
                       **attrs: Any) -> _NullSpan:
        return NULL_SPAN

    def finish(self) -> None:
        pass

    def find_spans(self, name: str) -> List[Span]:
        return []

    def to_dict(self) -> Dict[str, Any]:
        return {}

    def summary(self) -> Dict[str, Any]:
        return {}


NULL_TRACE = _NullTrace()


# ---------------------------------------------------------------------------
# thread-local activation + in-context span helpers

class activate:
    """Context manager binding ``trace`` to the current thread so that
    :func:`span` calls anywhere down-stack attach to it.  ``NULL_TRACE``
    (or ``None``) deactivates, making the block trace-free."""

    __slots__ = ("_trace", "_prev_trace", "_prev_stack")

    def __init__(self, trace: Optional[Trace]):
        self._trace = None if trace is NULL_TRACE else trace

    def __enter__(self) -> Optional[Trace]:
        self._prev_trace = getattr(_tls, "trace", None)
        self._prev_stack = getattr(_tls, "stack", None)
        _tls.trace = self._trace
        _tls.stack = [] if self._trace is not None else None
        return self._trace

    def __exit__(self, exc_type, exc, tb) -> None:
        _tls.trace = self._prev_trace
        _tls.stack = self._prev_stack


def _pop_span(s: Span) -> None:
    stack = getattr(_tls, "stack", None)
    if stack and stack[-1] is s:
        stack.pop()


def span(name: str, **attrs: Any):
    """Start a nested span under the thread's active trace (no-op span if
    none).  Use as ``with span("broker.flush", n=5) as sp: ...``."""
    trace = getattr(_tls, "trace", None)
    if trace is None:
        return NULL_SPAN
    stack = getattr(_tls, "stack", None)
    parent = stack[-1].span_id if stack else 0
    s = trace.new_span(name, parent_id=parent, **attrs)
    if stack is not None:
        stack.append(s)
    return s


def start_span(name: str, **attrs: Any):
    """Like :func:`span` but NOT pushed on the nesting stack — for spans
    ended manually (possibly on another thread) via ``.end()``."""
    trace = getattr(_tls, "trace", None)
    if trace is None:
        return NULL_SPAN
    stack = getattr(_tls, "stack", None)
    parent = stack[-1].span_id if stack else 0
    return trace.new_span(name, parent_id=parent, **attrs)


def add_timed_span(name: str, t0: float, t1: float, **attrs: Any):
    """Attach an already-timed interval to the active trace (no-op if
    none).  Parent is the thread's current span."""
    trace = getattr(_tls, "trace", None)
    if trace is None:
        return NULL_SPAN
    stack = getattr(_tls, "stack", None)
    parent = stack[-1].span_id if stack else 0
    return trace.add_timed_span(name, t0, t1, parent_id=parent, **attrs)


# ---------------------------------------------------------------------------
# flight recorder + tracer

class FlightRecorder:
    """Bounded ring buffer of the last ``capacity`` completed traces.
    Appending is O(1) and drops the oldest trace beyond capacity — a
    crash/postmortem tool, not an archive."""

    def __init__(self, capacity: int = 256):
        self.capacity = int(capacity)
        self._traces: deque = deque(maxlen=max(1, self.capacity))
        self._lock = threading.Lock()
        self.recorded = 0

    def record(self, trace: Trace) -> None:
        if trace is NULL_TRACE:
            return
        with self._lock:
            self._traces.append(trace)
            self.recorded += 1

    def traces(self) -> List[Trace]:
        with self._lock:
            return list(self._traces)       # oldest -> newest

    def find(self, trace_id: str) -> Optional[Trace]:
        with self._lock:
            for t in reversed(self._traces):
                if t.trace_id == trace_id:
                    return t
        return None

    def summaries(self) -> List[Dict[str, Any]]:
        return [t.summary() for t in self.traces()]

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._traces)


class Tracer:
    """Trace factory.  Disabled tracers hand out ``NULL_TRACE`` so the
    whole span machinery short-circuits at the source."""

    def __init__(self, recorder: Optional[FlightRecorder] = None,
                 enabled: bool = True):
        self.recorder = recorder
        self.enabled = enabled

    def start(self, name: str, trace_id: Optional[str] = None,
              **attrs: Any) -> Trace:
        if not self.enabled:
            return NULL_TRACE
        return Trace(name, trace_id=trace_id, **attrs)

    def finish(self, trace: Trace) -> None:
        if trace is NULL_TRACE or not self.enabled:
            return
        trace.finish()
        if self.recorder is not None:
            self.recorder.record(trace)


# ---------------------------------------------------------------------------
# Chrome trace-event export

def chrome_trace(trace: Trace) -> Dict[str, Any]:
    """Export a finished trace as a Chrome trace-event JSON object
    (load in ``chrome://tracing`` or https://ui.perfetto.dev).  Uses "X"
    (complete) events with microsecond timestamps relative to trace
    start; span attrs land in ``args``."""
    events = []
    d = trace.to_dict()
    for s in d.get("spans", ()):
        t1 = s["t1"] if s["t1"] is not None else s["t0"]
        events.append({
            "name": s["name"],
            "ph": "X",
            "ts": round((s["t0"] - trace.t0) * 1e6, 1),
            "dur": round(max(0.0, t1 - s["t0"]) * 1e6, 1),
            "pid": 1,
            "tid": s["thread"],
            "args": dict(s["attrs"], span_id=s["span_id"],
                         parent_id=s["parent_id"]),
        })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "trace_id": trace.trace_id,
            "name": trace.name,
            "started_unix": trace.started_unix,
            "duration_s": trace.duration_s,
            **{f"attr_{k}": v for k, v in trace.attrs.items()},
        },
    }


def chrome_traces(traces: Iterable[Trace]) -> Dict[str, Any]:
    """Merge several traces into one Chrome trace document (one ``pid``
    per trace so they stack as separate process tracks)."""
    events: List[Dict[str, Any]] = []
    meta: List[Dict[str, Any]] = []
    for pid, t in enumerate(traces, start=1):
        doc = chrome_trace(t)
        for ev in doc["traceEvents"]:
            ev["pid"] = pid
        events.extend(doc["traceEvents"])
        meta.append(doc["otherData"])
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"traces": meta}}
