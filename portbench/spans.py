"""The program's own spans inside a traced window, for the per-layer
readers that read them.

While torch.profiler records, the port's ``repro_torch.obs.trace`` keeps
the spans of its stages (``tasti.build`` and its ``tasti.load``,
``tasti.embed``, ``tasti.fpf``, ``tasti.annotate``, ``tasti.topk``;
``lm.forward``) on the profiler's clock, Unix nanoseconds, with the bytes
each moved between host and device (``h2d_bytes``, ``d2h_bytes``).  They
are dicts with ``name``, ``start_ns``, ``end_ns`` and ``attrs``.  A
program that keeps no such spans gives the readers nothing to read.
"""
from __future__ import annotations

import bisect
from statistics import fmean
from typing import Callable, List, Optional, Tuple

#: the stages of a build that do its device work
STAGES = ("tasti.embed", "tasti.fpf", "tasti.topk")


def window_spans(r, spans: Optional[list] = None) -> Optional[list]:
    """The program's spans (``spans``, else the program's own) that
    overlap the traced window, or None where the run is untraced or the
    program keeps none.

    Overlap, not containment: ``Capture.window_ns`` may be the device's
    copy of the window's range, from its first device operation to its
    last, and the window's last unit ends on the host after that."""
    window = r.capture.window_ns
    if not r.traced or window is None:
        return None
    if spans is None:
        try:
            from repro_torch.obs import trace
        except ImportError:
            return None
        profiled = getattr(trace, "profiled_spans", None)
        if profiled is None:
            return None
        spans = profiled()
    lo, hi = window
    return [s for s in spans if s["start_ns"] < hi and s["end_ns"] > lo]


def named(spans: list, name: str) -> list:
    return [s for s in spans if s["name"] == name]


def seconds(spans: list) -> float:
    return sum(s["end_ns"] - s["start_ns"] for s in spans) / 1e9


def builds(r, spans: Optional[list] = None) -> List[Tuple[dict, list]]:
    """Each ``tasti.build`` span of the window with the spans inside it."""
    got = window_spans(r, spans) or []
    return [(b, [s for s in got if s is not b
                 and b["start_ns"] <= s["start_ns"]
                 and s["end_ns"] <= b["end_ns"]])
            for b in named(got, "tasti.build")]


def per_build(r, spans: Optional[list],
              value: Callable[[dict, list], Optional[float]]):
    """The mean over the window's builds of ``value(build, inner)``, over
    the builds where it is not None; None where there are none."""
    got = [v for v in (value(b, inner) for b, inner in builds(r, spans))
           if v is not None]
    return fmean(got) if got else None


def idle_share(r, name: str, spans: Optional[list] = None):
    """The mean over the window's builds of the share, in %, of their
    ``name`` spans' time in which no device operation ran."""
    busy = r.capture.busy_intervals() if r.traced else []
    starts = [a for a, _ in busy]

    def share(b, inner):
        stage = named(inner, name)
        total = sum(s["end_ns"] - s["start_ns"] for s in stage)
        if not total:
            return None
        idle = sum(idle_ns(busy, starts, s["start_ns"], s["end_ns"])
                   for s in stage)
        return 100.0 * idle / total

    return per_build(r, spans, share)


def idle_ns(busy: list, starts: list, a: int, b: int) -> int:
    """The part of [a, b] that the sorted, disjoint intervals ``busy``
    (their starts ``starts``) leave uncovered, in ns."""
    covered = 0
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    while i < len(busy) and busy[i][0] < b:
        covered += max(0, min(busy[i][1], b) - max(busy[i][0], a))
        i += 1
    return (b - a) - covered
