"""The benchmark's harness: one run of one cell.

Everything a cell is made of is found by name (``cells.Cell``): its
configuration file, its traffic file (whose ``driver`` names the code in
``portbench/drivers/`` that drives the program), its per-layer metric
readers (``portbench/metrics/<metric>.py``) and the limits its outputs are
held to (``portbench/limits/<cell>.json``).  A run:

1. sets up (the driver makes its inputs from the seed on the device and
   warms up every shape the window uses): ``setup_s``, from the start of
   the process;
2. runs the window: whole units of work back to back until ``seconds``
   have passed (and at least the traffic's ``min_units``), traced by
   torch.profiler with ``--trace 1``;
3. reads the metrics: the rate (all the window's work over all its time)
   and ``setup_s``, or the per-layer readers' numbers;
4. reads the peak device memory, has the driver free the program's state,
   and holds a sample of the window's outputs, drawn from the seed, to the
   plain reference (``checks``).

``run.py`` then prints the result, unless JAX, the JAX package or the JAX
benchmarks were imported (``forbidden_modules``).
"""
from __future__ import annotations

import importlib
import json
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

#: top-level module names a run may not import: JAX, its libraries, the
#: JAX package of this repository and its benchmarks
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (sys.modules), each
    compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


@dataclass
class Check:
    """One number compared: its value and the largest it may take."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Window:
    """What the window did: units, their work and seconds."""
    units: int = 0
    work: float = 0.0
    seconds: float = 0.0
    unit_seconds: list = field(default_factory=list)


@dataclass
class Outcome:
    result: dict
    checks: list


def run_window(driver, seconds: float, min_units: int, capture) -> Window:
    w = Window()
    with capture.window():
        t0 = time.perf_counter()
        while True:
            u0 = time.perf_counter()
            w.work += driver.unit(w.units)
            w.units += 1
            w.unit_seconds.append(time.perf_counter() - u0)
            w.seconds = time.perf_counter() - t0
            if w.seconds >= seconds and w.units >= min_units:
                break
    return w


def make_driver(cell, seed: int, device: str, overrides=None):
    """(the cell's driver on ``seed``, the traffic it runs), with
    ``overrides`` merged into the configuration and the traffic."""
    import torch
    mod = importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")
    config = merge(cell.config, (overrides or {}).get("config", {}))
    traffic = merge(cell.traffic, (overrides or {}).get("traffic", {}))
    return mod.Driver(config, traffic, seed, torch.device(device)), traffic


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, overrides: Optional[dict] = None,
             wrap: Optional[Callable] = None) -> Outcome:
    """One run of ``cell`` (``cells.Cell``) on ``device``.  ``overrides``
    merges into the configuration and the traffic (the CPU tests' small
    sizes); ``wrap`` replaces the driver by ``wrap(driver)`` (the tests'
    planted faults)."""
    import torch

    from portbench.trace import Capture

    driver, traffic = make_driver(cell, seed, device, overrides)
    if wrap is not None:
        driver = wrap(driver)
    t_driver = time.perf_counter() - t_start
    driver.setup()
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    capture = Capture(trace and device != "cpu")
    w = run_window(driver, seconds, int(traffic.get("min_units", 1)), capture)
    metrics: Dict[str, dict] = {}
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device != "cpu"
                    else "cpu"),
           "count": 1,
           "memory_peak_bytes": (int(torch.cuda.max_memory_allocated())
                                 if device != "cpu" else 0)}
    breakdown = None
    if not trace:
        for m in cell.end_to_end:
            if m["name"] != "setup_s" and m["name"] != traffic["rate_metric"]:
                raise KeyError(f"the {cell.traffic['driver']} driver "
                               f"measures no {m['name']!r}")
        metrics[traffic["rate_metric"]] = {
            "value": w.work / w.seconds,
            "unit": cell.unit(traffic["rate_metric"])}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    else:
        reading = Reading(capture, w, driver)
        for m in cell.per_layer:
            value = cell.reader(m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        if capture.enabled:
            dev["busy_s"] = capture.busy_s()
            dev["window_s"] = w.seconds
            breakdown = capture.breakdown()
    print(f"window: {w.units} units in {w.seconds!r} s, each "
          f"{[round(x, 4) for x in w.unit_seconds]}; set-up {setup_s!r} s, "
          f"of which before the driver's {t_driver!r} s", file=sys.stderr)
    driver.free()
    readings = driver.check(w.units)
    limits = cell.limits
    checks = [Check(k, float(v), float(limits.get(k, -math.inf)))
              for k, v in readings.items()]
    missing = sorted(set(limits) - set(readings))
    checks += [Check(k, math.inf, float(limits[k])) for k in missing]
    result = {"correct": bool(checks) and all(c.ok for c in checks),
              "attempted": w.units, "failed": 0, "metrics": metrics,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {c.name: {"value": _num(c.value),
                                 "limit": _num(c.limit)} for c in checks}
    return Outcome(result, checks)


class Reading:
    """What a per-layer reader reads: the trace (``capture``, empty when
    untraced), the window (``window``), the cell's shapes (``shape``) and
    the driver's host-clock probes (``probe``)."""

    def __init__(self, capture, window: Window, driver):
        self.capture = capture
        self.window = window
        self.shape = driver.shape()
        self._probes = driver.probes()
        self._memo: Dict[str, Optional[float]] = {}

    @property
    def traced(self) -> bool:
        return self.capture.enabled and bool(self.capture.device)

    def probe(self, name: str) -> Optional[float]:
        if name not in self._probes:
            return None
        if name not in self._memo:
            self._memo[name] = self._probes[name]()
        return self._memo[name]


def _num(x: float):
    """x, or its name where JSON has no number for it."""
    return x if math.isfinite(x) else str(x)


def merge(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s keys put in, nested dicts merged."""
    out = json.loads(json.dumps(base))
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = v
    return out


def print_result(outcome: Outcome) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output."""
    for c in outcome.checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r})"
              f"{'' if c.ok else ' FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(outcome.result), flush=True)
