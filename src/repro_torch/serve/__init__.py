"""Query-serving subsystem: a long-lived HTTP endpoint over the query engine.

* :mod:`repro_torch.serve.store` — :class:`LabelStore`, the persistent oracle-label
  cache that lives next to a saved :class:`~repro_torch.core.index.TastiIndex` and
  survives process restarts;
* :mod:`repro_torch.serve.registry` — :class:`WorkloadRegistry` /
  :class:`WorkloadSpec`, the mounting table that puts many workloads (each
  its own index + engine + store + oracle pool) behind one server, loaded
  lazily from a manifest;
* :mod:`repro_torch.serve.scheduler` — :class:`QueryScheduler`, the SLO-aware
  waiting/running-queue scheduler (priority classes, EDF, weighted shares,
  per-workload caps, preemption at oracle-slice boundaries);
* :mod:`repro_torch.serve.server` — :class:`QueryServer`, a stdlib
  ``ThreadingHTTPServer`` that routes specs to workloads, schedules them
  through the :class:`QueryScheduler`, and coalesces concurrent requests
  per workload into shared :class:`~repro_torch.core.session.QuerySession` s;
* :mod:`repro_torch.serve.client` — :class:`QueryClient` plus a small CLI.

(The JSON wire form of a ``QueryResult`` is :mod:`repro_torch.core.codec` — shared
with the ``repro_torch.launch.query`` CLI.)
"""
__all__ = ["LabelStore", "QueryClient", "QueryScheduler", "QueryServer",
           "ScheduledTask", "WorkloadRegistry", "WorkloadSpec"]

_HOMES = {"LabelStore": "repro_torch.serve.store",
          "QueryClient": "repro_torch.serve.client",
          "QueryScheduler": "repro_torch.serve.scheduler",
          "QueryServer": "repro_torch.serve.server",
          "ScheduledTask": "repro_torch.serve.scheduler",
          "WorkloadRegistry": "repro_torch.serve.registry",
          "WorkloadSpec": "repro_torch.serve.registry"}


def __getattr__(name):
    # lazy (PEP 562) so `python -m repro_torch.serve.client` does not import the
    # client module twice (once via the package, once as __main__)
    if name in _HOMES:
        import importlib
        return getattr(importlib.import_module(_HOMES[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
