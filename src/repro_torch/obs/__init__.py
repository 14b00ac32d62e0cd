"""End-to-end observability: request tracing, flight recorder, metrics.

:class:`Observability` bundles one :class:`~repro_torch.obs.metrics.MetricsRegistry`,
one :class:`~repro_torch.obs.trace.Tracer`, and one
:class:`~repro_torch.obs.trace.FlightRecorder` for a process (usually owned by
``QueryServer``).  Components receive an :class:`ObsScope` — the same
bundle with a preset label set (``workload="video"``) folded into every
instrument they create — via ``obs.scoped(workload=...)``.

Disabled observability is the same object graph built on no-op parts
(``NULL_REGISTRY``, a tracer handing out ``NULL_TRACE``), so call sites
never branch on an enabled flag.  ``NULL_SCOPE`` is the default for every
component's ``obs`` parameter.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

from repro_torch.obs import trace as trace_mod
from repro_torch.obs.metrics import (
    LATENCY_BUCKETS, NULL_REGISTRY, MetricsRegistry, Sample, SIZE_BUCKETS,
    parse_prometheus_text, series_key,
)
from repro_torch.obs.trace import (
    NULL_SPAN, NULL_TRACE, FlightRecorder, Span, Trace, Tracer, activate,
    active_trace, add_timed_span, chrome_trace, chrome_traces, new_trace_id,
    span, start_span,
)

__all__ = [
    "Observability", "ObsScope", "NULL_OBS", "NULL_SCOPE",
    "MetricsRegistry", "NULL_REGISTRY", "Sample", "parse_prometheus_text",
    "series_key", "LATENCY_BUCKETS", "SIZE_BUCKETS",
    "Tracer", "Trace", "Span", "FlightRecorder", "NULL_TRACE", "NULL_SPAN",
    "activate", "active_trace", "span", "start_span", "add_timed_span",
    "chrome_trace", "chrome_traces", "new_trace_id",
]


class Observability:
    """Process-wide observability bundle (metrics + tracer + recorder)."""

    def __init__(self, enabled: bool = True, trace_buffer: int = 256):
        self.enabled = bool(enabled)
        if self.enabled:
            self.metrics: Any = MetricsRegistry()
            self.recorder: Optional[FlightRecorder] = \
                FlightRecorder(trace_buffer)
            self.tracer = Tracer(self.recorder, enabled=True)
        else:
            self.metrics = NULL_REGISTRY
            self.recorder = None
            self.tracer = Tracer(None, enabled=False)

    def scoped(self, **labels: Any) -> "ObsScope":
        return ObsScope(self, labels)

    # conveniences so an Observability can be used where a scope is
    # expected (empty label set)
    def counter(self, name: str, help: str = "", **labels: Any):
        return self.metrics.counter(name, help, **labels)

    def gauge(self, name: str, help: str = "", **labels: Any):
        return self.metrics.gauge(name, help, **labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Iterable[float]] = None, **labels: Any):
        return self.metrics.histogram(name, help, buckets=buckets, **labels)


class ObsScope:
    """An :class:`Observability` view with preset labels.  This is the
    type every instrumented component takes as its ``obs`` parameter."""

    __slots__ = ("obs", "labels")

    def __init__(self, obs: Observability, labels: Dict[str, Any]):
        self.obs = obs
        self.labels = {str(k): str(v) for k, v in labels.items()}

    @property
    def enabled(self) -> bool:
        return self.obs.enabled

    @property
    def tracer(self) -> Tracer:
        return self.obs.tracer

    @property
    def recorder(self) -> Optional[FlightRecorder]:
        return self.obs.recorder

    @property
    def metrics(self):
        return self.obs.metrics

    def scoped(self, **labels: Any) -> "ObsScope":
        return ObsScope(self.obs, {**self.labels, **labels})

    def counter(self, name: str, help: str = "", **labels: Any):
        return self.obs.metrics.counter(name, help, **self.labels, **labels)

    def gauge(self, name: str, help: str = "", **labels: Any):
        return self.obs.metrics.gauge(name, help, **self.labels, **labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Iterable[float]] = None, **labels: Any):
        return self.obs.metrics.histogram(
            name, help, buckets=buckets, **self.labels, **labels)


NULL_OBS = Observability(enabled=False)
NULL_SCOPE = NULL_OBS.scoped()

# re-export the module for ``from repro import obs; obs.trace`` style use
trace = trace_mod
