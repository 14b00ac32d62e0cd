"""The port's oracle broker (``repro_torch.core.broker``), replica pool
(``repro_torch.core.oracle_pool``) and observability (``repro_torch.obs``)
against the JAX package's on the CPU.

The broker and the pool are held by scripted runs through both packages:
labels, their order, broker counters and per-account fresh/cached charges
must be equal, for thread and process replicas alike.  No assertion here
depends on which replica takes a slice (slice sizing follows each
replica's measured rate), only on what every replica count must give.
The metrics registry renders the same Prometheus text for the same
instruments, and spans, the flight recorder and the Chrome-trace export
behave as the reference's do.  Every comparison is exact."""
import os
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import obs as jax_obs  # noqa: E402
from repro.core import schema as jax_schema  # noqa: E402
from repro.core.broker import OracleBroker as JaxBroker  # noqa: E402
from repro.core.engine import QueryEngine as JaxEngine  # noqa: E402
from repro.core.engine import QuerySpec as JaxSpec  # noqa: E402
from repro.core.index import TastiIndex as JaxIndex  # noqa: E402
from repro.core.session import QuerySession as JaxSession  # noqa: E402
from repro.obs import trace as jax_trace  # noqa: E402
from repro_torch import obs as pt_obs  # noqa: E402
from repro_torch.core import schema as pt_schema  # noqa: E402
from repro_torch.core.broker import OracleBroker  # noqa: E402
from repro_torch.core.engine import QueryEngine, QuerySpec  # noqa: E402
from repro_torch.core.index import TastiIndex  # noqa: E402
from repro_torch.core.oracle_pool import (OraclePool,  # noqa: E402
                                          OraclePoolError)
from repro_torch.core.session import QuerySession  # noqa: E402
from repro_torch.obs import trace as pt_trace  # noqa: E402

pytestmark = pytest.mark.tier1


class SpyOracle:
    """annotate(ids) -> [2*i]; records the batches it was handed."""

    def __init__(self):
        self.batches = []

    def __call__(self, ids):
        ids = np.asarray(ids, np.int64)
        self.batches.append(ids.tolist())
        return [int(i) * 2 for i in ids]


def _scripted(broker):
    """Requests, prefetches, fetches, duplicate ids, cache hits, a
    reuse=False read: outputs, counters and accounts."""
    a, b, c = (broker.account(n) for n in "abc")
    broker.prefetch(np.arange(0, 40), account=a)
    broker.request(np.arange(30, 60), account=b)
    broker.flush()
    out = [broker.fetch(np.arange(0, 50), account=a),
           broker.fetch([5, 5, 70, 71], account=b),
           broker.request(np.arange(60, 80), account=b).result(),
           broker.fetch([1, 2, 3], account=c, reuse=False),
           broker.fetch(np.arange(75, 90), account=c)]
    fa = broker.request([100, 101, 102], account=a)
    fb = broker.request([101, 102, 103], account=b)     # rides a's ids
    broker.flush()
    out += [fa.result(), fb.result()]
    stats = {k: broker.stats[k] for k in
             ("requests", "fresh", "cached", "dedup_inflight", "flushes",
              "prefetched")}
    accounts = [(x.name, x.fresh, x.cached, list(x.labeled))
                for x in (a, b, c)]
    return out, stats, accounts


@pytest.mark.parametrize("max_batch", [1, 7, 16, 64])
def test_broker_matches_jax(max_batch):
    jspy, pspy = SpyOracle(), SpyOracle()
    want = _scripted(JaxBroker(jspy, max_batch=max_batch))
    got = _scripted(OracleBroker(pspy, max_batch=max_batch))
    assert got == want
    assert pspy.batches == jspy.batches          # the same microbatches
    assert max(len(b) for b in pspy.batches) <= max_batch


def test_broker_full_stats_match_jax():
    jb, pb = JaxBroker(SpyOracle(), max_batch=7), OracleBroker(
        SpyOracle(), max_batch=7)
    rng = np.random.default_rng(0)
    for t in range(12):
        ids = rng.integers(0, 40, size=rng.integers(1, 20))
        jb.fetch(ids, account=jb.account(str(t % 3)))
        pb.fetch(ids, account=pb.account(str(t % 3)))
    assert pb.stats == jb.stats
    assert pb.stats["fresh"] + pb.stats["cached"] == pb.stats["requests"]
    with pytest.raises(ValueError, match="max_batch"):
        OracleBroker(SpyOracle(), max_batch=0)


@pytest.mark.parametrize("backend,n", [("thread", 2), ("thread", 4),
                                       ("process", 2), ("process", 3)])
def test_pool_gives_the_single_oracle_result(backend, n):
    """Any replica count and backend: labels, their order, counters and
    accounts equal the JAX package's single-oracle broker's."""
    want = _scripted(JaxBroker(SpyOracle(), max_batch=16))
    with OraclePool(SpyOracle(), n_replicas=n, backend=backend) as pool:
        got = _scripted(OracleBroker(SpyOracle(), max_batch=16, pool=pool))
        snap = pool.snapshot()
    assert got == want
    assert sum(snap["per_replica_ids"]) == want[1]["fresh"]  # once each
    assert snap["failures"] == 0


def _kill_own_process(ids):
    os.kill(os.getpid(), 9)


def test_process_pool_survives_a_dead_replica_and_reaps_children():
    """A replica whose process dies has its slice retried on a survivor
    (labels exact), an all-dead pool fails its flush, and close() reaps
    every child and removes the spool directory."""
    with OraclePool(replicas=[_kill_own_process, SpyOracle()],
                    backend="process") as pool:
        broker = OracleBroker(SpyOracle(), max_batch=8, pool=pool)
        a = broker.account("a")
        broker.request(np.arange(32), account=a)
        assert broker.flush() == 32
        assert a.labeled == list(range(32)) and (a.fresh, a.cached) == (32, 0)
        assert broker.fetch(np.arange(32), account=a) == \
            [2 * i for i in range(32)]
    assert all(not r.proc.is_alive() for r in pool._replicas)
    assert not os.path.isdir(pool._spool)
    with OraclePool(replicas=[_kill_own_process, _kill_own_process],
                    backend="process") as pool:
        with pytest.raises(OraclePoolError, match="failed on all"):
            pool.run(np.arange(8), max_batch=4)
        with pytest.raises(OraclePoolError, match="dead"):
            pool.run(np.arange(8), max_batch=4)


def test_pool_rejects_bad_construction_alike():
    from repro.core.oracle_pool import OraclePool as JaxPool
    bad = [dict(n_replicas=0), dict(n_replicas=2, backend="greenlet"),
           dict(n_replicas=2, handoff="shm"),
           dict(n_replicas=2, max_batches=[4]),
           dict(n_replicas=2, max_batches=[4, 0])]
    for kw in bad:
        with pytest.raises(ValueError) as jerr:
            JaxPool(SpyOracle(), **kw)
        with pytest.raises(ValueError) as perr:
            OraclePool(SpyOracle(), **kw)
        assert str(perr.value) == str(jerr.value)
    pool = OraclePool(SpyOracle(), n_replicas=1)
    pool.close()
    pool.close()
    with pytest.raises(RuntimeError, match="closed"):
        pool.run([1], max_batch=4)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    jwl = jax_schema.make_workload("night-street", n_frames=400)
    idx = JaxIndex.build(jwl.features, 60, jwl.target_dnn_batch, k=4,
                         random_fraction=0.0, seed=0)
    stem = str(tmp_path_factory.mktemp("idx") / "ns")
    idx.save(stem)
    return stem, jwl, pt_schema.make_workload("night-street", n_frames=400)


ENGINE_SPECS = [
    {"kind": "aggregation", "score": "score_count", "err": 0.2},
    {"kind": "selection", "score": "score_has_object", "budget": 50},
    {"kind": "limit", "score": "score_has_object", "k_results": 3}]


def _rows(out):
    rows = [(r.kind, r.estimate,
             None if r.selected is None else [int(i) for i in r.selected],
             r.n_invocations, r.n_oracle_fresh, r.n_oracle_cached)
            for r in out.results]
    return rows, {k: out.stats[k] for k in
                  ("fresh_total", "cached_total", "prefetch_labels")}


@pytest.mark.parametrize("replicas,backend", [(1, "thread"), (3, "thread"),
                                              (2, "process")])
def test_engine_rows_through_replicas_match_jax(saved, replicas, backend):
    """The port's engine with a replica pool (threads, or forked processes
    that run the workload's numpy oracle) answers a session with the JAX
    engine's rows and accounting."""
    stem, jwl, pwl = saved
    jeng = JaxEngine(JaxIndex.load(stem), jwl, resident=False)
    want = _rows(JaxSession(jeng, [JaxSpec.from_dict(d)
                                   for d in ENGINE_SPECS]).execute())
    peng = QueryEngine(TastiIndex.load(stem, device="cpu"), pwl,
                       oracle_replicas=replicas, oracle_backend=backend)
    try:
        got = _rows(QuerySession(peng, [QuerySpec.from_dict(d)
                                        for d in ENGINE_SPECS]).execute())
        if replicas > 1:
            assert peng.oracle_pool.snapshot()["n_replicas"] == replicas
    finally:
        peng.close()
    assert got == want


# -- observability -------------------------------------------------------------
def _drive_metrics(obs_mod):
    reg = obs_mod.MetricsRegistry()
    reg.counter("oracle_fresh_total", help="fresh labels",
                workload="video").inc(7)
    reg.counter("oracle_fresh_total", workload="text").inc(3)
    reg.gauge("queue_depth", workload="video").set(5)
    h = reg.histogram("flush_seconds", buckets=(0.1, 1.0), workload="video")
    for v in (0.05, 0.5, 2.0):
        h.observe(v)
    reg.add_collector(lambda: [
        obs_mod.Sample("derived_total", 42, labels={"workload": "v"},
                       help="derived"),
        obs_mod.Sample("derived_depth", 3, mtype="gauge")])
    reg.add_collector(lambda: (_ for _ in ()).throw(RuntimeError("boom")))
    return reg.render()


def test_metrics_text_matches_jax():
    text = _drive_metrics(pt_obs)
    assert text == _drive_metrics(jax_obs)
    parsed = pt_obs.parse_prometheus_text(text)
    assert parsed == jax_obs.parse_prometheus_text(text)
    key = pt_obs.series_key
    assert key("flush_seconds_bucket", workload="video", le="+Inf") == \
        jax_obs.series_key("flush_seconds_bucket", workload="video",
                           le="+Inf")
    assert parsed[key("flush_seconds_bucket", workload="video",
                      le="1")] == 2
    assert parsed[key("oracle_fresh_total", workload="video")] == 7
    assert parsed["metrics_collector_errors_total"] == 1
    with pytest.raises(ValueError, match="already registered"):
        reg = pt_obs.MetricsRegistry()
        reg.counter("requests_total")
        reg.gauge("requests_total")


def _span_shape(tr):
    trace = tr.Trace("request", trace_id="a" * 16, workload="video")
    with tr.activate(trace):
        with tr.span("outer") as outer:
            with tr.span("inner", n=2) as inner:
                pass
            loose = tr.start_span("loose")
            loose.end()
        tr.span("sibling").end()
        tr.add_timed_span("timed", time.perf_counter(), time.perf_counter(),
                          fresh=5)
    trace.finish()
    doc = tr.chrome_trace(trace)
    return ((inner.parent_id == outer.span_id,
             loose.parent_id == outer.span_id, inner.attrs),
            sorted(ev["name"] for ev in doc["traceEvents"]),
            sorted(doc["otherData"]), {ev["ph"] for ev in doc["traceEvents"]})


def test_spans_and_chrome_trace_match_jax():
    assert _span_shape(pt_trace) == _span_shape(jax_trace)
    assert pt_trace.active_trace() is None


def test_flight_recorder_and_disabled_obs():
    rec = pt_trace.FlightRecorder(capacity=4)
    tracer = pt_trace.Tracer(rec)
    ids = []
    for _ in range(10):
        t = tracer.start("request")
        ids.append(t.trace_id)
        tracer.finish(t)
    assert len(rec) == 4 and rec.recorded == 10
    assert [t.trace_id for t in rec.traces()] == ids[-4:]
    assert rec.find(ids[0]) is None
    obs = pt_obs.Observability(enabled=False)
    t = obs.tracer.start("request", trace_id="c" * 16)
    assert t is pt_obs.NULL_TRACE and obs.recorder is None
    obs.counter("n_total").inc()
    assert obs.metrics.render() == \
        jax_obs.Observability(enabled=False).metrics.render()
    ids = {pt_trace.new_trace_id() for _ in range(100)}
    assert len(ids) == 100 and all(len(i) == 16 for i in ids)
