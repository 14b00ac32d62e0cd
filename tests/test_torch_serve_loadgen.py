"""The port's open-loop load generator (``repro_torch.loadgen``) against the
JAX package's on the CPU: the same seed gives the same arrival times and
the same spec draws (exact equality: both are numpy ``Generator`` s seeded
alike), and errors and dropped requests are classified the same way.

Generator runs use real time with generous bounds (the schedules last
about a second; a stalled server is released seconds after the last
arrival), never a sleep that has to win a race."""
import threading

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import loadgen as jax_loadgen  # noqa: E402
from repro.loadgen import generator as jax_generator  # noqa: E402
from repro.serve.client import ServerError as JaxServerError  # noqa: E402
from repro_torch import loadgen as pt_loadgen  # noqa: E402
from repro_torch.loadgen import generator as pt_generator  # noqa: E402
from repro_torch.serve.client import ServerError  # noqa: E402

pytestmark = pytest.mark.tier1

PACKAGES = (jax_loadgen, pt_loadgen)


@pytest.mark.parametrize("rate,cv,seed,duration", [
    (100.0, 1.0, 0, 20.0), (50.0, 0.2, 1, 20.0), (50.0, 3.0, 1, 20.0),
    (10.0, 1.0, 7, 5.0), (0.5, 1.0, 3, 100.0), (10.0, 1.0, 0, 0.0)])
def test_arrival_times_equal_the_jax_package(rate, cv, seed, duration):
    want = jax_loadgen.ArrivalProcess(rate=rate, cv=cv, seed=seed).times(
        duration)
    got = pt_loadgen.ArrivalProcess(rate=rate, cv=cv, seed=seed).times(
        duration)
    assert got == want
    assert got == sorted(got) and all(0 <= t < duration for t in got)


def test_arrivals_validated_alike():
    for lg in PACKAGES:
        with pytest.raises(ValueError, match="rate"):
            lg.ArrivalProcess(rate=0.0)
        with pytest.raises(ValueError, match="cv"):
            lg.ArrivalProcess(rate=1.0, cv=0.0)


def _classes(lg):
    def specs_fn(rng):
        return [{"kind": "aggregation", "score": "score_count",
                 "seed": int(rng.integers(0, 1000))}]
    return [
        lg.SpecClass("interactive", [{"kind": "aggregation",
                                      "score": "score_count", "err": 0.2}],
                     weight=6.0, priority=0, deadline_ms=250.0),
        lg.SpecClass("scan", [{"kind": "limit", "score": "score_rare",
                               "k_results": 5}], weight=1.0, budget=(10, 20)),
        lg.SpecClass("fixed", [{"kind": "selection",
                                "score": "score_has_object"}],
                     weight=2.0, budget=50),
        lg.SpecClass("drawn", specs_fn, weight=1.5,
                     budget=lambda rng: int(rng.integers(1, 3))),
    ]


@pytest.mark.parametrize("seed", [0, 1, 123])
def test_spec_draws_equal_the_jax_package(seed):
    jmix = jax_loadgen.SpecMix(_classes(jax_loadgen), seed=seed)
    pmix = pt_loadgen.SpecMix(_classes(pt_loadgen), seed=seed)
    for _ in range(500):
        (jc, js, jb), (pc, ps, pb) = jmix.sample(), pmix.sample()
        assert (pc.name, ps, pb) == (jc.name, js, jb)
        assert (pc.priority, pc.deadline_ms) == (jc.priority, jc.deadline_ms)


def test_mix_templates_copied_and_validated():
    cls = pt_loadgen.SpecClass("t", [{"kind": "a", "seed": 0}])
    mix = pt_loadgen.SpecMix([cls], seed=0)
    _, specs, _ = mix.sample()
    specs[0]["seed"] = 999
    assert mix.sample()[1][0]["seed"] == 0
    with pytest.raises(ValueError, match="weight"):
        pt_loadgen.SpecClass("bad", [{"kind": "a"}], weight=0.0)
    with pytest.raises(ValueError, match="duplicate"):
        pt_loadgen.SpecMix([pt_loadgen.SpecClass("x", [{"kind": "a"}]),
                            pt_loadgen.SpecClass("x", [{"kind": "b"}])])
    with pytest.raises(ValueError, match="at least one"):
        pt_loadgen.SpecMix([])


def test_error_kinds_classified_alike():
    class Status(Exception):
        def __init__(self, status):
            super().__init__(f"status {status}")
            self.status = status

    class StatusOSError(OSError):
        status = 503

    errors = [ServerError("bad", status=400), ServerError("boom", status=500),
              JaxServerError("bad", status=404), ServerError("?", status=None),
              ConnectionRefusedError("refused"), TimeoutError("slow"),
              OSError("reset"), StatusOSError("answered"), Status(True),
              Status(429), RuntimeError("other"), ValueError("x")]
    want = [jax_generator._classify_error(e) for e in errors]
    assert [pt_generator._classify_error(e) for e in errors] == want
    assert want == ["http_4xx", "http_5xx", "http_4xx", "other", "connect",
                    "connect", "connect", "http_5xx", "other", "http_4xx",
                    "other", "other"]


def _report_counts(report):
    """Everything in a report that does not depend on timing."""
    classes = {name: {k: v for k, v in c.items() if not k.endswith("_ms")}
               for name, c in report.classes.items()}
    return (report.offered, report.completed, report.errors,
            report.connect_errors, report.http_errors, report.dropped,
            classes, [(o.name, o.ok, o.error_kind) for o in report.outcomes])


def test_errors_counted_per_class_alike():
    def make_post(ServerErr):
        def post(specs, budget=None, priority=None, deadline_ms=None,
                 name=None):
            if name == "bad":
                raise ServerErr("rejected", status=400)
            if name == "down":
                raise ConnectionRefusedError("refused")
            return {"ok": True}
        return post

    reports = []
    for lg, err in ((jax_loadgen, JaxServerError), (pt_loadgen, ServerError)):
        mix = lg.SpecMix([lg.SpecClass(n, [{"kind": n}])
                          for n in ("good", "bad", "down")], seed=0)
        reports.append(_report_counts(lg.OpenLoopGenerator(
            make_post(err), mix, lg.ArrivalProcess(rate=40.0, seed=0),
            1.0).run()))
    assert reports[1] == reports[0]
    offered, completed, errors, connect, http, dropped, classes, _ = \
        reports[1]
    assert classes["good"]["errors"] == 0
    assert classes["bad"]["http_errors"] == classes["bad"]["n"] > 0
    assert classes["down"]["connect_errors"] == classes["down"]["n"] > 0
    assert errors == connect + http and dropped == 0
    assert completed + errors == offered


def test_max_inflight_drops_alike():
    """Against a stalled server a run capped at 3 in flight drops every
    later arrival, recorded as dropped (not an error) in both packages."""
    reports = []
    for lg in PACKAGES:
        gate = threading.Event()

        def post(specs, budget=None, priority=None, deadline_ms=None,
                 name=None, gate=gate):
            assert gate.wait(30.0)
            return {}

        mix = lg.SpecMix([lg.SpecClass("cls", [{"kind": "agg"}])], seed=0)
        gen = lg.OpenLoopGenerator(post, mix,
                                   lg.ArrivalProcess(rate=40.0, seed=0), 1.0,
                                   max_inflight=3)
        timer = threading.Timer(4.0, gate.set)     # 3 s after the last arrival
        timer.start()
        try:
            reports.append(gen.run())
        finally:
            timer.cancel()
            gate.set()
    assert _report_counts(reports[1]) == _report_counts(reports[0])
    r = reports[1]
    assert r.offered > 10 and r.completed == 3 and r.errors == 0
    assert r.dropped == r.offered - 3 == r.classes["cls"]["dropped"]
    assert all(not o.ok and "dropped" in o.error
               for o in r.outcomes if o.error_kind == "dropped")


def test_generator_passes_the_envelope_and_trace_ids():
    seen = []

    def post(specs, budget=None, priority=None, deadline_ms=None, name=None,
             trace_id=None):
        seen.append((specs, budget, priority, deadline_ms, name, trace_id))
        return {}

    mix = pt_loadgen.SpecMix([pt_loadgen.SpecClass(
        "c", [{"kind": "a"}], priority=0, deadline_ms=150.0,
        budget=(5, 9))], seed=0)
    report = pt_loadgen.OpenLoopGenerator(
        post, mix, pt_loadgen.ArrivalProcess(rate=30.0, seed=0), 0.5).run()
    assert len(seen) == report.offered > 0
    for specs, budget, priority, deadline_ms, name, trace_id in seen:
        assert specs == [{"kind": "a"}] and 5 <= budget <= 9
        assert (priority, deadline_ms, name) == (0, 150.0, "c")
        assert isinstance(trace_id, str) and trace_id
    assert sorted(o.trace_id for o in report.outcomes) == \
        sorted(s[-1] for s in seen)
    lat = report.classes["c"]
    assert 0.0 <= lat["p50_ms"] <= lat["p90_ms"] <= lat["p99_ms"]
    with pytest.raises(ValueError, match="max_inflight"):
        pt_loadgen.OpenLoopGenerator(post, mix, pt_loadgen.ArrivalProcess(
            rate=1.0), 1.0, max_inflight=0)


def test_percentiles_equal_the_jax_package():
    rng = np.random.default_rng(0)
    for values in ([], [3.0], list(rng.exponential(20.0, size=999))):
        assert pt_generator._percentiles(values) == \
            jax_generator._percentiles(values)
