"""The port's query server (``repro_torch.serve``) against the JAX package's
on the CPU, both over the same saved indexes (built by the JAX package;
the port loads them with ``device="cpu"``).

The same spec lists, posted one at a time (admission window 0), give
identical result rows and per-spec fresh/cached counts; a warm restart
over each package's label store gives 0 fresh calls; multi-workload
routing and the ``/workloads``, ``/healthz``, ``/stats`` and ``/metrics``
surfaces match; malformed specs get the same status codes; coalesced
submissions give the same oracle accounting.  The registry's device
plumbing and the ``serve_queries`` CLI are held here too.

Every comparison is exact: on the CPU the port's engine takes the same
float64 host propagation as the JAX engine (resident scoring is off for
a CPU index), and the rest of the stack is host code."""
import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from repro.core import schema as jax_schema  # noqa: E402
from repro.core.engine import QueryEngine as JaxEngine  # noqa: E402
from repro.core.engine import QuerySpec as JaxSpec  # noqa: E402
from repro.core.index import TastiIndex as JaxIndex  # noqa: E402
from repro.serve import LabelStore as JaxStore  # noqa: E402
from repro.serve import QueryClient as JaxClient  # noqa: E402
from repro.serve import QueryServer as JaxServer  # noqa: E402
from repro.serve import WorkloadRegistry as JaxRegistry  # noqa: E402
from repro.serve import WorkloadSpec as JaxWorkloadSpec  # noqa: E402
from repro.serve.client import ServerError as JaxServerError  # noqa: E402
from repro_torch.core import schema as pt_schema  # noqa: E402
from repro_torch.core.engine import QueryEngine, QuerySpec  # noqa: E402
from repro_torch.core.index import TastiIndex  # noqa: E402
from repro_torch.obs import parse_prometheus_text  # noqa: E402
from repro_torch.serve import (LabelStore, QueryClient,  # noqa: E402
                               QueryServer, WorkloadRegistry, WorkloadSpec)
from repro_torch.serve.client import ServerError  # noqa: E402

pytestmark = pytest.mark.tier1

N_VIDEO, N_TEXT = 1200, 900
VIDEO_SPECS = [
    {"kind": "aggregation", "score": "score_count", "err": 0.2, "seed": 0},
    {"kind": "selection", "score": "score_has_object", "budget": 80,
     "seed": 0},
    {"kind": "limit", "score": "score_has_object", "k_results": 3}]
TEXT_SPECS = [
    {"kind": "aggregation", "score": "score_n_predicates", "err": 0.2,
     "seed": 0},
    {"kind": "selection", "score": "score_is_select", "budget": 60, "seed": 0},
    {"kind": "limit", "score": "score_is_select", "k_results": 3}]
#: spec lists posted in order: repeats, overlaps and a categorical mode
TRAIN = [VIDEO_SPECS,
         [{"kind": "aggregation", "score": "score_count", "err": 0.15,
           "seed": 1}],
         [VIDEO_SPECS[1]],
         [{"kind": "aggregation", "score": "score_count", "err": 0.2,
           "propagation": "categorical", "n_classes": 9}],
         VIDEO_SPECS]


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Both datasets' indexes built by the JAX package and saved, with both
    packages' workloads."""
    root = tmp_path_factory.mktemp("idx")
    out = {}
    for name, dataset, n, reps in (("video", "night-street", N_VIDEO, 120),
                                   ("text", "wikisql", N_TEXT, 90)):
        jwl = jax_schema.make_workload(dataset, n_records=n)
        idx = JaxIndex.build(jwl.features, reps, jwl.target_dnn_batch, k=4,
                             random_fraction=0.0, seed=0)
        stem = str(root / name)
        idx.save(stem)
        out[name] = {"dataset": dataset, "n": n, "stem": stem, "jwl": jwl,
                     "pwl": pt_schema.make_workload(dataset, n_records=n)}
    return out


def _engines(w, **kw):
    """(JAX engine, port engine) over fresh loads of the saved index."""
    return (JaxEngine(JaxIndex.load(w["stem"]), w["jwl"], resident=False,
                      **kw),
            QueryEngine(TastiIndex.load(w["stem"], device="cpu"), w["pwl"],
                        **kw))


def _stores(stem, jeng, peng):
    """Attach each package's label store (own files) to its engine."""
    js = JaxStore.for_index(stem + "-jax", jeng.index)
    js.attach(jeng.broker, jeng)
    ps = LabelStore.for_index(stem + "-torch", peng.index)
    ps.attach(peng.broker, peng)
    return js, ps


def _start(jsrc, psrc, stores=(None, None), **kw):
    js = JaxServer(jsrc, port=0, store=stores[0], **kw).start()
    ps = QueryServer(psrc, port=0, store=stores[1], **kw).start()
    jc, pc = JaxClient(js.url), QueryClient(ps.url)
    jc.wait_ready(30)
    pc.wait_ready(30)
    return js, ps, jc, pc


def _comparable(out, batches=True):
    """A response without its timing and trace id.  ``batches=False`` also
    drops the oracle batch counts, which a replica pool's slice sizing sets
    (it follows each replica's measured rate)."""
    def keep(k):
        return batches or "batches" not in k
    session = {k: v for k, v in out["session"].items()
               if k != "queue_wait_s" and keep(k)}
    request = {k: v for k, v in out["request"].items() if k != "trace_id"}
    rows = [{k: ({kk: vv for kk, vv in v.items() if keep(kk)}
                 if k == "session" else v) for k, v in r.items()}
            for r in out["results"]]
    return rows, session, request


def test_rows_and_accounts_identical_one_at_a_time(saved):
    jeng, peng = _engines(saved["video"])
    js, ps, jc, pc = _start(jeng, peng, admission_window=0.0)
    try:
        for specs in TRAIN:
            assert _comparable(pc.query(specs)) == \
                _comparable(jc.query(specs))
        jstats, pstats = jc.stats(), pc.stats()
        assert pstats["engine"] == jstats["engine"]
        assert pstats["broker"] == jstats["broker"]
        assert pstats["accounts"] == jstats["accounts"]
        assert pstats["index"] == jstats["index"]
        assert pstats["server"]["requests"] == len(TRAIN)
        assert pstats["server"]["errors"] == 0
    finally:
        js.shutdown()
        ps.shutdown()


@pytest.mark.parametrize("replicas", [1, 2])
def test_warm_restart_costs_zero_fresh_on_both(saved, tmp_path, replicas):
    """Each server writes through to its own label store; a restarted
    server (new engine, index loaded from the files, store reopened)
    answers the same requests with 0 fresh calls and the same rows.  With
    two thread replicas the pool must not break that."""
    w = saved["video"]
    stem = str(tmp_path / "store")
    first = {}
    for round_ in range(2):
        jeng, peng = _engines(w, oracle_replicas=replicas)
        js, ps, jc, pc = _start(jeng, peng, _stores(stem, jeng, peng),
                                admission_window=0.0)
        try:
            for i, specs in enumerate(TRAIN[:2]):
                jout, pout = jc.query(specs), pc.query(specs)
                assert _comparable(pout, replicas == 1) == \
                    _comparable(jout, replicas == 1)
                if round_ == 0:
                    assert pout["request"]["fresh"] > 0
                    first[i] = pout
                else:
                    assert pout["request"]["fresh"] == 0
                    assert jout["request"]["fresh"] == 0
                    for a, b in zip(first[i]["results"], pout["results"]):
                        assert a.get("estimate") == b.get("estimate")
                        assert a.get("selected_head") == \
                            b.get("selected_head")
                        assert a["n_invocations"] == b["n_invocations"]
            if replicas > 1:
                assert pc.stats()["oracle_pool"]["n_replicas"] == replicas
        finally:
            js.shutdown()
            ps.shutdown()
    assert len(LabelStore.for_index(stem + "-torch",
                                    TastiIndex.load(w["stem"],
                                                    device="cpu"))) > 0


def _registries(saved, tmp_path, lazy=False):
    """Two-workload registries (video default, text) in both packages,
    each workload with its own label store."""
    jreg, preg = JaxRegistry(), WorkloadRegistry()
    for name in ("video", "text"):
        w = saved[name]
        common = dict(name=name, dataset=w["dataset"], n_records=w["n"],
                      index=w["stem"])
        jreg.declare(JaxWorkloadSpec(
            store=str(tmp_path / f"jax-{name}"), **common))
        preg.declare(WorkloadSpec(
            store=str(tmp_path / f"torch-{name}"), device="cpu", **common))
    if not lazy:
        for name in ("video", "text"):
            jreg.get(name)
            preg.get(name)
    return jreg, preg


def test_multi_workload_routing_and_endpoints(saved, tmp_path):
    jreg, preg = _registries(saved, tmp_path, lazy=True)
    js, ps, jc, pc = _start(jreg, preg, admission_window=0.0)
    try:
        for c in (jc, pc):
            wl = {w["name"]: w for w in c.workloads()["workloads"]}
            assert not wl["video"]["loaded"] and not wl["text"]["loaded"]
        assert pc.workloads()["workloads"][0]["device"] == "cpu"
        for client in (jc, pc):
            client.query(TEXT_SPECS, workload="text")
            client.query([dict(TEXT_SPECS[0], workload="text")])
            client.query(VIDEO_SPECS[:1])               # default: video
        jw, pw = jc.workloads(), pc.workloads()
        assert pw["default"] == jw["default"] == "video"
        strip = lambda rows: [{k: v for k, v in r.items()  # noqa: E731
                               if k != "device"} for r in rows]
        assert strip(pw["workloads"]) == strip(jw["workloads"])
        assert {r["name"]: r["device"] for r in pw["workloads"]} == \
            {"video": "cpu", "text": "cpu"}
        assert pc.healthy() and jc.healthy()
        assert pc._call("/healthz") == jc._call("/healthz")
        jstats, pstats = jc.stats(), pc.stats()
        assert set(pstats) == set(jstats)
        assert set(pstats["workloads"]) == {"video", "text"}
        for name in ("video", "text"):
            jw_, pw_ = jstats["workloads"][name], pstats["workloads"][name]
            assert set(pw_) == set(jw_)
            for key in ("engine", "broker", "accounts", "index", "server"):
                assert pw_[key] == jw_[key], (name, key)
            assert pw_["store"]["n_labels"] == jw_["store"]["n_labels"]
        assert pstats["workloads"]["text"]["server"]["requests"] == 2
        # /metrics parses and carries the same series, the port's resident
        # state adding its count of device computes
        jm = parse_prometheus_text(jc.metrics())
        pm = parse_prometheus_text(pc.metrics())
        name_of = lambda k: k.split("{")[0]  # noqa: E731
        extra = {name_of(k) for k in pm} - {name_of(k) for k in jm}
        assert extra == {"resident_computes_total"}
        for key in pm:
            if key.startswith(("oracle_fresh_total", "oracle_cached_total",
                               "server_requests_total",
                               "label_store_labels")):
                assert pm[key] == jm[key], key
        assert pm['resident_enabled{workload="video"}'] == 0.0
        assert pm['engine_label_fresh_total{workload="text"}'] > 0
    finally:
        js.shutdown()
        ps.shutdown()


BAD = [
    ([{"kind": "aggregation", "bogus": 1}], {}),               # 400 parse
    ([], {}),                                                  # 400 empty
    ([{"kind": "selection", "score": "score_has_object"}], {}),  # 400 plan
    ([{"kind": "aggregation", "score": "score_count"}],
     {"workload": "speech"}),                                  # unknown
    ([{"kind": "aggregation", "score": "score_count"}],
     {"priority": -1}),
    ([{"kind": "aggregation", "score": "score_count"}],
     {"deadline_ms": 0}),
    ([{"kind": "aggregation", "score": "score_nope"}], {}),
]


def test_malformed_specs_get_the_same_status(saved):
    jeng, peng = _engines(saved["video"])
    js, ps, jc, pc = _start(jeng, peng, admission_window=0.0)
    try:
        for specs, kw in BAD:
            with pytest.raises(JaxServerError) as jerr:
                jc.query(specs, **kw)
            with pytest.raises(ServerError) as perr:
                pc.query(specs, **kw)
            assert perr.value.status == jerr.value.status, (specs, kw)
            assert perr.value.status in (400, 500)
        assert pc.stats()["server"]["errors"] == \
            jc.stats()["server"]["errors"]
    finally:
        js.shutdown()
        ps.shutdown()


@pytest.mark.parametrize("over_http", [False, True])
def test_coalesced_submissions_same_accounting(saved, over_http):
    """Requests arriving inside one admission window merge into one session
    (the first absorbs the rest, in arrival order) with the same rows and
    oracle accounting in both packages: submitted in-process, or posted
    over HTTP from concurrent clients, each post made once the server has
    admitted the one before (so the order is fixed; the 2 s window is a
    bound, not a race)."""
    jeng, peng = _engines(saved["video"])
    specs = (VIDEO_SPECS[0], VIDEO_SPECS[1], TRAIN[1][0])
    subs = {}
    for pkg, (Server, Client, Spec, eng) in {
            "jax": (JaxServer, JaxClient, JaxSpec, jeng),
            "torch": (QueryServer, QueryClient, QuerySpec, peng)}.items():
        srv = Server(eng, port=0, admission_window=2.0).start()
        try:
            if over_http:
                outs = [None] * len(specs)

                def post(i):
                    outs[i] = Client(srv.url).query([specs[i]])

                threads = []
                for i in range(len(specs)):
                    threads.append(threading.Thread(target=post, args=(i,)))
                    threads[-1].start()
                    deadline = time.monotonic() + 30
                    while (srv.stats_payload()["server"]["requests"] <= i
                           and time.monotonic() < deadline):
                        time.sleep(0.005)
                for t in threads:
                    t.join(120)
                assert all(o is not None for o in outs)
                rows = [o["results"] for o in outs]
                session = outs[0]["session"]
            else:
                batch = [srv.submit([Spec.from_dict(d)]) for d in specs]
                for sub in batch:
                    assert sub.done.wait(120)
                    assert sub.error is None, sub.error
                rows = [sub.rows for sub in batch]
                session = batch[0].session
            stats = srv.stats_payload()
            subs[pkg] = (rows, {k: v for k, v in session.items()
                                if k != "queue_wait_s"},
                         stats["server"]["sessions"],
                         stats["server"]["coalesced"],
                         stats["accounts"]["fresh_total"],
                         stats["accounts"]["cached_total"])
        finally:
            srv.shutdown()
    assert subs["torch"] == subs["jax"]
    assert subs["torch"][2:4] == (1, 2)


def test_concurrent_http_sessions_match_serial_labels(saved):
    """Eight clients posting at once through one port server (window 0, so
    eight sessions, four at a time over one engine): no errors, and every
    answer is the one a serial run gives, since answers do not depend on
    which session paid a label."""
    specs = [[dict(VIDEO_SPECS[0], seed=s)] for s in range(4)] + \
        [[VIDEO_SPECS[1]], [VIDEO_SPECS[2]], [TRAIN[1][0]], [TRAIN[3][0]]]
    _, serial_eng = _engines(saved["video"])
    srv = QueryServer(serial_eng, port=0, admission_window=0.0).start()
    try:
        c = QueryClient(srv.url)
        want = [c.query(s)["results"] for s in specs]
    finally:
        srv.shutdown()
    _, peng = _engines(saved["video"])
    srv = QueryServer(peng, port=0, admission_window=0.0,
                      max_workers=4).start()
    outs, errors = [None] * len(specs), []
    barrier = threading.Barrier(len(specs))

    def post(i):
        try:
            barrier.wait(timeout=30)
            outs[i] = QueryClient(srv.url).query(specs[i])
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(repr(e))

    try:
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(specs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors
        answer = ("kind", "estimate", "ci_half_width", "n_invocations",
                  "threshold", "selected_head", "n_selected")
        for got, exp in zip(outs, want):
            assert [{k: r.get(k) for k in answer} for r in got["results"]] \
                == [{k: r.get(k) for k in answer} for r in exp]
        stats = QueryClient(srv.url).stats()
        assert stats["server"]["errors"] == 0
        assert stats["broker"]["fresh"] == len(peng.broker.cache)
    finally:
        srv.shutdown()


# -- registry device plumbing ------------------------------------------------
def test_mount_without_cuda_fails_at_load_and_is_memoized(saved,
                                                         monkeypatch):
    """A spec with no device means CUDA: without a card its lazy mount
    fails at load (never lands on the CPU), the failure is memoized and
    shown by /healthz; device="cpu" mounts on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = saved["text"]
    reg = WorkloadRegistry()
    reg.declare(WorkloadSpec(name="gpu", dataset=w["dataset"],
                             n_records=w["n"], index=w["stem"]))
    reg.declare(WorkloadSpec(name="cpu", dataset=w["dataset"],
                             n_records=w["n"], index=w["stem"],
                             device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        reg.get("gpu")
    with pytest.raises(RuntimeError, match="failed to load previously"):
        reg.get("gpu")
    assert reg.get("cpu").engine.index.device.type == "cpu"
    srv = QueryServer(reg, port=0, admission_window=0.0).start()
    try:
        c = QueryClient(srv.url)
        health = c._call("/healthz")["workloads"]
        assert "CUDA is not available" in health["gpu"]["error"]
        with pytest.raises(ServerError) as err:
            c.query(TEXT_SPECS[:1], workload="gpu")
        assert err.value.status == 500
        assert c.query(TEXT_SPECS[:1], workload="cpu")["results"]
    finally:
        srv.shutdown()


def test_workload_spec_takes_device_from_a_manifest(tmp_path, saved):
    w = saved["text"]
    manifest = tmp_path / "m.json"
    manifest.write_text(json.dumps({"workloads": {"text": {
        "dataset": w["dataset"], "n_records": w["n"], "index": w["stem"],
        "device": "cpu"}}}))
    reg = WorkloadRegistry.from_manifest(str(manifest))
    entry = reg.get("text")
    assert entry.spec.device == "cpu"
    assert entry.describe()["device"] == "cpu"


# -- the serving CLI ---------------------------------------------------------
def test_serve_queries_cli_answers_then_shuts_down(tmp_path):
    """``python -m repro_torch.launch.serve_queries --device cpu --quick``
    on an ephemeral port prints its URL, answers a request, writes its
    label store through, and exits 0 after POST /shutdown."""
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = {**os.environ, "PYTHONPATH": str(src)}
    store = str(tmp_path / "store")
    err = open(tmp_path / "stderr.log", "w")       # never a full pipe
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve_queries",
         "--workload", "night-street", "--n-frames", "600", "--quick",
         "--device", "cpu", "--port", "0", "--admission-window", "0",
         "--store", store],
        env=env, stdout=subprocess.PIPE, stderr=err, text=True)
    try:
        line = proc.stdout.readline()
        assert line, (tmp_path / "stderr.log").read_text()
        head = json.loads(line)
        assert head["workloads"][0]["device"] == "cpu"
        c = QueryClient(head["serving"])
        c.wait_ready(30)
        out = c.query(VIDEO_SPECS[:1])
        assert out["request"]["fresh"] > 0
        assert out["results"][0]["estimate"] is not None
        c.shutdown()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err.close()
    assert pathlib.Path(store + ".labels.json").exists()
