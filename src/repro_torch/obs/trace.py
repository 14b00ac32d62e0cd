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

While a torch profiler records and no request trace is active on the
thread, the same helpers record into one process-level trace of bounded
length instead (the index build's stages, the LM forward), read back by
:func:`profiled_spans` on the profiler's clock.  The spans stay out of the
profiler's own records.  :func:`count` adds a number (bytes moved between
host and device) to the thread's innermost open span.

Span timestamps are ``time.perf_counter()`` values (monotonic, comparable
across threads on one host); each trace also takes an anchor, the
wall-clock and ``perf_counter`` nanoseconds read back to back, which
places its spans in Unix time (:meth:`Trace.unix_ns`), the clock of the
profiler's records.
"""
from __future__ import annotations

import itertools
import sys
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = [
    "Span", "Trace", "Tracer", "FlightRecorder", "NULL_SPAN", "NULL_TRACE",
    "new_trace_id", "span", "start_span", "add_timed_span", "activate",
    "active_trace", "chrome_trace", "count", "profiled_spans",
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
    reads for export happen after completion.

    ``capacity`` bounds the spans kept (the oldest dropped first, counted
    in ``dropped``); None keeps them all."""

    __slots__ = ("trace_id", "name", "attrs", "anchor", "t0", "t1",
                 "spans", "root", "dropped", "_lock", "_ids", "_finished")

    def __init__(self, name: str, trace_id: Optional[str] = None,
                 capacity: Optional[int] = None, **attrs: Any):
        self.trace_id = trace_id or new_trace_id()
        self.name = name
        self.attrs: Dict[str, Any] = dict(attrs)
        #: (Unix ns, perf_counter ns), read back to back
        self.anchor = (time.time_ns(), time.perf_counter_ns())
        self.t0 = self.anchor[1] / 1e9
        self.t1: Optional[float] = None
        self.spans: deque = deque(maxlen=capacity)
        self.dropped = 0
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._finished = False
        self.root = Span(name, 0, None, t0=self.t0, attrs=self.attrs)
        with self._lock:
            self.spans.append(self.root)

    @property
    def started_unix(self) -> float:
        """The wall-clock second at which the trace started."""
        return self.anchor[0] / 1e9

    def unix_ns(self, t: float) -> int:
        """``perf_counter`` second ``t`` (a span's ``t0`` or ``t1``) as Unix
        nanoseconds, the clock of torch.profiler's ``start_ns``."""
        return self.anchor[0] + round(t * 1e9) - self.anchor[1]

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
            if len(self.spans) == self.spans.maxlen:
                self.dropped += 1
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
    for stack in (getattr(_tls, "stack", None), getattr(_tls, "pstack", None)):
        if stack and stack[-1] is s:
            stack.pop()
            return


#: spans the process-level trace keeps while a profiler records
PROFILED_CAPACITY = 4096
_profiled: Optional[Trace] = None
_profiled_lock = threading.Lock()


def _profiling() -> bool:
    """Whether a torch profiler records (torch's own flag; never imports
    torch: without it no profiler can run)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


def _profiled_trace() -> Trace:
    global _profiled
    if _profiled is None:
        with _profiled_lock:
            if _profiled is None:
                _profiled = Trace("profiled", capacity=PROFILED_CAPACITY)
    return _profiled


def _target():
    """(trace, nesting stack) that the thread's spans go to: the active
    request trace; else, while a profiler records, the process-level
    trace; else (None, None)."""
    trace = getattr(_tls, "trace", None)
    if trace is not None:
        return trace, getattr(_tls, "stack", None)
    if not _profiling():
        return None, None
    stack = getattr(_tls, "pstack", None)
    if stack is None:
        stack = _tls.pstack = []
    return _profiled_trace(), stack


def span(name: str, **attrs: Any):
    """Start a nested span under the thread's active trace, or under the
    process-level trace while a profiler records (no-op span if
    neither).  Use as ``with span("broker.flush", n=5) as sp: ...``."""
    trace, stack = _target()
    if trace is None:
        return NULL_SPAN
    parent = stack[-1].span_id if stack else 0
    s = trace.new_span(name, parent_id=parent, **attrs)
    if stack is not None:
        stack.append(s)
    return s


def start_span(name: str, **attrs: Any):
    """Like :func:`span` but NOT pushed on the nesting stack — for spans
    ended manually (possibly on another thread) via ``.end()``."""
    trace, stack = _target()
    if trace is None:
        return NULL_SPAN
    parent = stack[-1].span_id if stack else 0
    return trace.new_span(name, parent_id=parent, **attrs)


def add_timed_span(name: str, t0: float, t1: float, **attrs: Any):
    """Attach an already-timed interval to the thread's trace (no-op if
    none).  Parent is the thread's current span."""
    trace, stack = _target()
    if trace is None:
        return NULL_SPAN
    parent = stack[-1].span_id if stack else 0
    return trace.add_timed_span(name, t0, t1, parent_id=parent, **attrs)


def count(name: str, n: int) -> None:
    """Add ``n`` to attribute ``name`` of the thread's innermost open span
    (e.g. ``h2d_bytes``, from a tensor's ``nbytes``: no device sync); a
    no-op where no span is open."""
    _, stack = _target()
    if stack:
        attrs = stack[-1].attrs
        attrs[name] = attrs.get(name, 0) + n


def profiled_spans() -> List[Dict[str, Any]]:
    """The finished spans recorded while a profiler recorded and no
    request trace was active, oldest first, at most
    :data:`PROFILED_CAPACITY`: each span's ``to_dict()`` with
    ``start_ns`` and ``end_ns``, its interval in Unix nanoseconds (the
    clock of the profiler's records).  The buffer is not cleared."""
    trace = _profiled
    if trace is None:
        return []
    with trace._lock:
        spans = [s for s in trace.spans if s.span_id and s.t1 is not None]
    return [dict(s.to_dict(), start_ns=trace.unix_ns(s.t0),
                 end_ns=trace.unix_ns(s.t1)) for s in spans]


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

