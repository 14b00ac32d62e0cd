"""Fault-tolerant training loop: checkpoint/restart, straggler detection,
preemption handling.

Single-host implementation of the control plane a 1000+-node deployment needs;
the failure channel is injectable so the whole machinery is unit-testable:

* ``run_resilient``: step loop that (a) periodically ``save_async``es,
  (b) catches step failures (injected or real), restores from the latest
  checkpoint and replays, (c) takes an *emergency* synchronous checkpoint on
  preemption signals, (d) gives up after ``max_restarts`` consecutive
  failures (crash-loop guard).
* ``StragglerMonitor``: per-step wall-time EWMA + deviation; flags steps
  slower than ``threshold`` x EWMA.  On real pods the flagged step triggers
  hot-spare swap / re-slice; here the decision log is the artifact.

Elastic re-meshing is ``runtime/elastic.py`` (a mesh over the ranks that
survive) with ``Checkpointer.restore(shardings=)`` (each rank keeps its
slice), ported with the mesh layer (ROADMAP A6c); the loop here restores
the whole state on one process.  A ``step_fn`` that updates the
state in place (the port's train step does) replays a failure before the
first checkpoint from the state as it then stands, not from the initial
one; ``repro_torch.launch.train`` saves a step-0 checkpoint first.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.checkpoint.checkpointer import Checkpointer


@dataclass
class StragglerMonitor:
    alpha: float = 0.2
    threshold: float = 2.0
    warmup: int = 3
    ewma: Optional[float] = None
    events: List[Dict] = field(default_factory=list)
    _n: int = 0

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step is flagged as a straggler."""
        self._n += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        flagged = self._n > self.warmup and dt > self.threshold * self.ewma
        if flagged:
            self.events.append({"step": step, "dt": dt, "ewma": self.ewma})
        # stragglers don't poison the baseline estimate
        if not flagged:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return flagged


class PreemptionSignal:
    """Injectable preemption flag (SIGTERM handler in deployment)."""

    def __init__(self):
        self._flag = False

    def set(self):
        self._flag = True

    def check_and_clear(self) -> bool:
        f = self._flag
        self._flag = False
        return f


@dataclass
class RunReport:
    steps_completed: int
    restarts: int
    straggler_events: List[Dict]
    emergency_checkpoints: int
    final_metrics: Optional[Dict] = None


def run_resilient(step_fn: Callable[[Any, int], Tuple[Any, Dict]],
                  init_state: Any,
                  n_steps: int,
                  ckpt: Checkpointer,
                  ckpt_every: int = 50,
                  max_restarts: int = 5,
                  preemption: Optional[PreemptionSignal] = None,
                  monitor: Optional[StragglerMonitor] = None,
                  time_fn: Callable[[], float] = time.monotonic) -> RunReport:
    """Run ``step_fn(state, step) -> (state, metrics)`` to ``n_steps`` with
    checkpoint/restart semantics.  ``step_fn`` may raise — each failure
    triggers restore-from-latest + replay."""
    monitor = monitor or StragglerMonitor()
    state = init_state
    step = 0
    restarts = 0
    consecutive_failures = 0
    emergencies = 0
    metrics: Dict = {}

    latest = ckpt.latest_step()
    if latest is not None:
        state, extra = ckpt.restore(latest, state)
        step = int(extra.get("next_step", latest))

    while step < n_steps:
        try:
            t0 = time_fn()
            state, metrics = step_fn(state, step)
            dt = time_fn() - t0
            monitor.observe(step, dt)
            consecutive_failures = 0
            step += 1
            if step % ckpt_every == 0:
                ckpt.save_async(step, state, extra={"next_step": step})
            if preemption is not None and preemption.check_and_clear():
                ckpt.wait()
                ckpt.save(step, state, extra={"next_step": step,
                                              "emergency": True})
                emergencies += 1
        except Exception:
            consecutive_failures += 1
            restarts += 1
            if consecutive_failures > max_restarts:
                raise
            ckpt.wait()
            latest = ckpt.latest_step()
            if latest is not None:
                state, extra = ckpt.restore(latest, state)
                step = int(extra.get("next_step", latest))
            else:
                state = init_state
                step = 0
    ckpt.wait()
    return RunReport(steps_completed=step, restarts=restarts,
                     straggler_events=monitor.events,
                     emergency_checkpoints=emergencies,
                     final_metrics=metrics)
