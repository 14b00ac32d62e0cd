"""Low-overhead metrics registry with Prometheus text exposition.

Three instrument kinds — :class:`Counter`, :class:`Gauge`, and fixed-bucket
:class:`Histogram` — grouped into families keyed by metric name, with
per-child label sets (``oracle_fresh_total{workload="video"}``).  Hot-path
cost is one short ``with lock`` per observation; instrument handles are
meant to be resolved once and cached by the caller, not looked up per
event.

Most of the serving stack already keeps its own counters under its own
locks (broker/pool/scheduler stats dicts).  Rather than double-count on
the hot path, the registry supports *collectors*: callables run at scrape
time that yield derived samples straight from those stats snapshots.  The
hot path pays nothing; ``/metrics`` pays one snapshot pass.

A disabled registry is the :data:`NULL_REGISTRY` no-op object — same
surface, zero work — per the off-by-default-cheap rule.
"""
from __future__ import annotations

import threading
from bisect import bisect_right
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NULL_REGISTRY",
    "Sample", "LATENCY_BUCKETS", "SIZE_BUCKETS", "parse_prometheus_text",
]

# seconds; tuned for request/flush/sub-batch latencies in this stack
LATENCY_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0)
# items per batch/flush
SIZE_BUCKETS: Tuple[float, ...] = (
    1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096)

LabelItems = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> LabelItems:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    __slots__ = ("_lock", "value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Gauge:
    __slots__ = ("_lock", "value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Histogram:
    """Fixed-bucket histogram (cumulative on exposition, Prometheus
    style).  ``observe`` is a bisect + three adds under one lock."""

    __slots__ = ("_lock", "buckets", "counts", "sum", "count")

    def __init__(self, buckets: Iterable[float] = LATENCY_BUCKETS) -> None:
        self._lock = threading.Lock()
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.counts = [0] * (len(self.buckets) + 1)   # last = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        i = bisect_right(self.buckets, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"buckets": self.buckets, "counts": list(self.counts),
                    "sum": self.sum, "count": self.count}


class _NullInstrument:
    __slots__ = ()
    value = 0.0
    sum = 0.0
    count = 0
    buckets: Tuple[float, ...] = ()
    counts: List[int] = []

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def snapshot(self) -> Dict[str, Any]:
        return {}


_NULL_INSTRUMENT = _NullInstrument()


class Sample:
    """One derived sample emitted by a collector at scrape time."""

    __slots__ = ("name", "mtype", "value", "labels", "help")

    def __init__(self, name: str, value: float, mtype: str = "counter",
                 labels: Optional[Dict[str, Any]] = None, help: str = ""):
        self.name = name
        self.value = float(value)
        self.mtype = mtype
        self.labels = labels or {}
        self.help = help


class _Family:
    __slots__ = ("name", "mtype", "help", "buckets", "children", "_lock")

    def __init__(self, name: str, mtype: str, help: str,
                 buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.mtype = mtype
        self.help = help
        self.buckets = buckets
        self.children: Dict[LabelItems, Any] = {}
        self._lock = threading.Lock()

    def child(self, labels: Dict[str, Any]):
        key = _label_key(labels)
        inst = self.children.get(key)
        if inst is None:
            with self._lock:
                inst = self.children.get(key)
                if inst is None:
                    if self.mtype == "counter":
                        inst = Counter()
                    elif self.mtype == "gauge":
                        inst = Gauge()
                    else:
                        inst = Histogram(self.buckets or LATENCY_BUCKETS)
                    self.children[key] = inst
        return inst


def _fmt_labels(items: LabelItems, extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in items]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_value(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class MetricsRegistry:
    """Named families of instruments + scrape-time collectors, rendered
    as Prometheus text exposition format 0.0.4."""

    enabled = True

    def __init__(self) -> None:
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()
        self._collectors: List[Callable[[], Iterable[Sample]]] = []

    # -- instrument factories ------------------------------------------
    def _family(self, name: str, mtype: str, help: str,
                buckets: Optional[Iterable[float]] = None) -> _Family:
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = _Family(name, mtype, help,
                                  tuple(buckets) if buckets else None)
                    self._families[name] = fam
        if fam.mtype != mtype:
            raise ValueError(
                f"metric {name!r} already registered as {fam.mtype}")
        return fam

    def counter(self, name: str, help: str = "", **labels: Any) -> Counter:
        return self._family(name, "counter", help).child(labels)

    def gauge(self, name: str, help: str = "", **labels: Any) -> Gauge:
        return self._family(name, "gauge", help).child(labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Iterable[float]] = None,
                  **labels: Any) -> Histogram:
        return self._family(name, "histogram", help,
                            buckets=buckets).child(labels)

    # -- collectors ----------------------------------------------------
    def add_collector(self, fn: Callable[[], Iterable[Sample]]) -> None:
        """Register a scrape-time callable yielding :class:`Sample`s.
        Runs on every :meth:`render`; exceptions are swallowed into a
        ``metrics_collector_errors_total`` counter so one bad snapshot
        can't take down the whole exposition."""
        with self._lock:
            self._collectors.append(fn)

    # -- exposition ----------------------------------------------------
    def render(self) -> str:
        lines: List[str] = []
        with self._lock:
            families = list(self._families.items())
            collectors = list(self._collectors)

        for name, fam in sorted(families):
            self._render_family(lines, name, fam)

        collected: Dict[Tuple[str, str], List[Sample]] = {}
        errors = 0
        for fn in collectors:
            try:
                for s in fn():
                    collected.setdefault((s.name, s.mtype), []).append(s)
            except Exception:
                errors += 1
        for (name, mtype), samples in sorted(collected.items()):
            help = next((s.help for s in samples if s.help), "")
            if help:
                lines.append(f"# HELP {name} {help}")
            lines.append(f"# TYPE {name} {mtype}")
            for s in samples:
                lines.append(
                    f"{name}{_fmt_labels(_label_key(s.labels))}"
                    f" {_fmt_value(s.value)}")
        if errors:
            lines.append("# TYPE metrics_collector_errors_total counter")
            lines.append(f"metrics_collector_errors_total {errors}")
        return "\n".join(lines) + "\n"

    @staticmethod
    def _render_family(lines: List[str], name: str, fam: _Family) -> None:
        if fam.help:
            lines.append(f"# HELP {name} {fam.help}")
        lines.append(f"# TYPE {name} {fam.mtype}")
        children = sorted(fam.children.items())
        if fam.mtype in ("counter", "gauge"):
            for key, inst in children:
                lines.append(
                    f"{name}{_fmt_labels(key)} {_fmt_value(inst.value)}")
            return
        for key, inst in children:
            snap = inst.snapshot()
            cum = 0
            for b, c in zip(snap["buckets"], snap["counts"]):
                cum += c
                le = 'le="%g"' % b
                lines.append(f"{name}_bucket{_fmt_labels(key, le)} {cum}")
            cum += snap["counts"][-1]
            inf = 'le="+Inf"'
            lines.append(f"{name}_bucket{_fmt_labels(key, inf)} {cum}")
            lines.append(
                f"{name}_sum{_fmt_labels(key)} {_fmt_value(snap['sum'])}")
            lines.append(
                f"{name}_count{_fmt_labels(key)} {snap['count']}")


class _NullRegistry:
    """No-op registry: same factory surface, shared no-op instruments."""

    enabled = False

    def counter(self, name: str, help: str = "", **labels: Any):
        return _NULL_INSTRUMENT

    def gauge(self, name: str, help: str = "", **labels: Any):
        return _NULL_INSTRUMENT

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Iterable[float]] = None, **labels: Any):
        return _NULL_INSTRUMENT

    def add_collector(self, fn) -> None:
        pass

    def render(self) -> str:
        return "# observability disabled\n"


NULL_REGISTRY = _NullRegistry()


# ---------------------------------------------------------------------------

def parse_prometheus_text(text: str) -> Dict[str, float]:
    """Parse exposition text into ``{'name{a="b"}': value}`` with labels
    canonically sorted.  Supports what :meth:`MetricsRegistry.render`
    emits (no escapes inside label values); used by tests and the
    client's ``--check-metrics`` scrape assertion."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            series, value = line.rsplit(None, 1)
        except ValueError:
            continue
        if "{" in series:
            name, rest = series.split("{", 1)
            body = rest.rsplit("}", 1)[0]
            labels = {}
            for part in body.split(","):
                if not part:
                    continue
                k, _, v = part.partition("=")
                labels[k.strip()] = v.strip().strip('"')
            key = name + _fmt_labels(_label_key(labels))
        else:
            key = series
        try:
            out[key] = float(value)
        except ValueError:
            continue
    return out


def series_key(name: str, **labels: Any) -> str:
    """Canonical key for looking up a series in
    :func:`parse_prometheus_text` output."""
    return name + _fmt_labels(_label_key(labels))
