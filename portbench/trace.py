"""The traced window: torch.profiler over the window of a ``--trace 1``
run, reduced to what the per-layer readers and the result line's
``device`` and ``breakdown`` need.

Device operations are the profiler's kernel, copy and set records; the
device's busy time is the union of their intervals, so that work on two
streams at once counts once.  An idle gap (a stretch inside the window
where no device operation runs) is named by what the host was doing at
its middle: the innermost host operation open there, or the last one that
ended before it.
"""
from __future__ import annotations

import bisect
import re
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

WINDOW = "portbench.window"
#: gaps shorter than this are launch spacing, not idleness worth naming
GAP_MIN_NS = 2_000
#: entries of each list of the breakdown
TOP = 10


class Capture:
    """The profiler's records of one window, or nothing when not traced."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.device: List[Tuple[str, int, int, str]] = []  # name, t0, dur, kind
        self.host: List[Tuple[str, int, int]] = []         # name, t0, t1
        self.window_ns: Optional[Tuple[int, int]] = None

    @contextmanager
    def window(self):
        """Trace the body (the measured window) when enabled."""
        if not self.enabled:
            yield self
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        with self.prof:
            with torch.profiler.record_function(WINDOW):
                yield self
            torch.cuda.synchronize()
        self._read()

    def _read(self) -> None:
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            t0, dur = e.start_ns(), e.duration_ns()
            kind = e.activity_type() if hasattr(e, "activity_type") else ""
            kind = str(kind).lower()
            if name == WINDOW:
                self.window_ns = (t0, t0 + dur)
                continue
            if "cuda" in str(e.device_type()).lower() or kind in (
                    "kernel", "gpu_memcpy", "gpu_memset"):
                low = name.lower()
                what = ("copy" if "memcpy" in low or kind == "gpu_memcpy"
                        else "set" if "memset" in low or kind == "gpu_memset"
                        else "kernel")
                self.device.append((name, t0, dur, what))
            else:
                self.host.append((name, t0, t0 + dur))
        self.prof = None

    # -- reductions -----------------------------------------------------
    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device operations' intervals, sorted."""
        spans = sorted((t0, t0 + d) for _, t0, d, _ in self.device)
        out: List[List[int]] = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def seconds(self, pattern: str, what: str = "kernel") -> float:
        """Device seconds of the operations of kind ``what`` whose name
        matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(d for n, _, d, k in self.device
                   if k == what and rx.search(n)) / 1e9

    def count(self, pattern: str, what: str = "kernel") -> int:
        rx = re.compile(pattern)
        return sum(1 for n, _, _, k in self.device
                   if k == what and rx.search(n))

    def copy_seconds(self) -> float:
        return sum(d for _, _, d, k in self.device if k == "copy") / 1e9

    def breakdown(self) -> Dict[str, list]:
        by_op: Dict[str, float] = {}
        for n, _, d, _ in self.device:
            key = short_name(n)
            by_op[key] = by_op.get(key, 0.0) + d / 1e9
        return {"device_ops": _top(by_op), "idle_gaps": _top(self._gaps())}

    def _gaps(self) -> Dict[str, float]:
        if self.window_ns is None:
            return {}
        lo, hi = self.window_ns
        busy = [(max(a, lo), min(b, hi)) for a, b in self.busy_intervals()
                if b > lo and a < hi]
        edges = [lo] + [x for ab in busy for x in ab] + [hi]
        host = sorted(h for h in self.host if h[0] != WINDOW)
        starts = [h[1] for h in host]
        out: Dict[str, float] = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b - a < GAP_MIN_NS:
                continue
            key = _host_at((a + b) // 2, host, starts)
            out[key] = out.get(key, 0.0) + (b - a) / 1e9
        return out


def _host_at(t: int, host: list, starts: list) -> str:
    """The innermost host operation open at ``t`` (the latest started that
    has not ended), or the last one that ended before it."""
    i = bisect.bisect_right(starts, t) - 1
    ended = None
    for j in range(i, max(i - 64, -1), -1):
        name, t0, t1 = host[j]
        if t1 >= t:
            return short_name(name)
        if ended is None or t1 > ended[1]:
            ended = (name, t1)
    return "host after " + short_name(ended[0]) if ended else "host"


_KERNEL = re.compile(r"(\w+_kernel)")


def short_name(name: str) -> str:
    """A device operation's or host call's name, cut to its kernel or
    function and 80 characters."""
    m = _KERNEL.search(name)
    if m:
        return m.group(1)
    name = name.replace("void ", "")
    return name.split("<")[0].split("(")[0][:80] or name[:80]


def _top(d: Dict[str, float]) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
