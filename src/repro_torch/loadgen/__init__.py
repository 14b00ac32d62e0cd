"""Open-loop load generation for the serving layer.

Closed-loop drivers (post, wait, post again) hide overload: when the server
slows down, the driver slows down with it, and measured latency stays
flattering.  An *open-loop* generator fires requests at their scheduled
arrival times regardless of how many are still in flight — the only way to
observe queueing, starvation, and SLO misses at a controlled offered load.

* :mod:`repro_torch.loadgen.arrivals` — :class:`ArrivalProcess`: Poisson or
  gamma-renewal arrival schedules with a controlled rate and burstiness;
* :mod:`repro_torch.loadgen.mix` — :class:`SpecClass` / :class:`SpecMix`: weighted
  sampling over request classes (spec template, priority, deadline, budget
  distribution);
* :mod:`repro_torch.loadgen.generator` — :class:`OpenLoopGenerator`: fires the
  schedule against any ``post`` callable (typically a
  :class:`~repro_torch.serve.client.QueryClient` wrapper) and reports per-class
  latency percentiles.

The package deliberately imports nothing from :mod:`repro_torch.serve`: it is a
pure harness, usable against any endpoint.
"""
__all__ = ["ArrivalProcess", "LoadReport", "OpenLoopGenerator",
           "RequestOutcome", "SpecClass", "SpecMix"]

_HOMES = {"ArrivalProcess": "repro_torch.loadgen.arrivals",
          "LoadReport": "repro_torch.loadgen.generator",
          "OpenLoopGenerator": "repro_torch.loadgen.generator",
          "RequestOutcome": "repro_torch.loadgen.generator",
          "SpecClass": "repro_torch.loadgen.mix",
          "SpecMix": "repro_torch.loadgen.mix"}


def __getattr__(name):
    if name in _HOMES:
        import importlib
        return getattr(importlib.import_module(_HOMES[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
