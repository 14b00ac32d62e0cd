"""The port's spans outside a request trace: nothing recorded (and no
allocation or sync) without a profiler; under torch.profiler the spans
nest into one bounded process-level trace with the bytes counted on the
innermost span; an active request trace still takes them; and the spans'
Unix-ns interval holds the profiler's own host records, checked on a tiny
index build on the CPU, whose byte counts equal its arrays' sizes."""
from __future__ import annotations

import time
import tracemalloc
import uuid

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.obs import trace as T

pytestmark = pytest.mark.tier1


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _named(prefix):
    return [s for s in T.profiled_spans() if s["name"].startswith(prefix)]


def test_without_profiler_or_trace_a_span_is_null_and_free(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: synced.append(a))
    tag = f"off.{uuid.uuid4().hex}"
    assert T.active_trace() is None
    before = len(T.profiled_spans())
    T.count("h2d_bytes", 8)     # no span open: nothing happens
    tracemalloc.start()
    try:
        base, _ = tracemalloc.get_traced_memory()
        for _ in range(1000):
            with T.span(tag, n=1) as sp:
                T.count("h2d_bytes", 8)
            assert sp is T.NULL_SPAN
            assert T.start_span(tag) is T.NULL_SPAN
            assert T.add_timed_span(tag, 0.0, 1.0) is T.NULL_SPAN
        now, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    # nothing kept across 1,000 calls (the loop's own int aside)
    assert now - base < 64 and peak - base < 2048
    assert T.NULL_SPAN.attrs == {} and not synced
    assert len(T.profiled_spans()) == before and not _named(tag)


def test_profiler_spans_nest_with_self_time_and_counts():
    tag = f"prof.{uuid.uuid4().hex}"
    with _profiled() as prof:
        with T.span(f"{tag}.outer", k=1):
            with T.span(f"{tag}.inner") as inner:
                T.count("h2d_bytes", 10)
                T.count("h2d_bytes", 5)
                time.sleep(0.01)
            T.count("d2h_bytes", 7)
            time.sleep(0.005)
            free = T.start_span(f"{tag}.manual")
            t = time.perf_counter()
            T.add_timed_span(f"{tag}.timed", t - 0.002, t)
        free.end()
    got = {s["name"][len(tag) + 1:]: s for s in _named(tag)}
    assert set(got) == {"outer", "inner", "manual", "timed"}
    outer = got["outer"]
    assert got["inner"]["parent_id"] == outer["span_id"]
    assert got["timed"]["parent_id"] == outer["span_id"]
    assert got["manual"]["parent_id"] == outer["span_id"]
    assert got["inner"]["attrs"] == {"h2d_bytes": 15}
    assert outer["attrs"] == {"k": 1, "d2h_bytes": 7}
    assert inner.attrs == {"h2d_bytes": 15}
    # Unix ns, nested, and the outer span's own time outside the inner
    a, b = outer["start_ns"], outer["end_ns"]
    ia, ib = got["inner"]["start_ns"], got["inner"]["end_ns"]
    assert a <= ia < ib <= b
    assert (b - a) - (ib - ia) >= 5_000_000
    assert abs(a - time.time_ns()) < 60e9
    # the spans stay out of the profiler's records, and end with it
    assert not [e for e in prof.profiler.kineto_results.events()
                if e.name().startswith(tag)]
    assert T.span(f"{tag}.after") is T.NULL_SPAN


def test_an_active_request_trace_takes_the_spans():
    tag = f"req.{uuid.uuid4().hex}"
    req = T.Trace("request")
    with _profiled(), T.activate(req):
        with T.span(tag):
            T.count("h2d_bytes", 3)
    (s,) = req.find_spans(tag)
    assert s.attrs == {"h2d_bytes": 3} and s.parent_id == 0
    assert not _named(tag)


def test_the_process_level_buffer_is_bounded(monkeypatch):
    tag = f"ring.{uuid.uuid4().hex}"
    small = T.Trace("profiled", capacity=4)
    monkeypatch.setattr(T, "_profiled", small)
    with _profiled():
        for i in range(10):
            with T.span(f"{tag}.{i}"):
                pass
    names = [s["name"] for s in T.profiled_spans()]
    assert names == [f"{tag}.{i}" for i in range(6, 10)]
    assert small.dropped == 7       # the root and the first six spans
    assert len(T.profiled_spans()) == 4     # reading does not clear
    monkeypatch.undo()
    assert T._profiled_trace().spans.maxlen == T.PROFILED_CAPACITY
    assert T.Trace("unbounded").spans.maxlen is None


def test_a_trace_places_its_spans_in_unix_time():
    before = time.time_ns()
    tr = T.Trace("t")
    after = time.time_ns()
    assert before <= tr.unix_ns(tr.t0) <= after
    assert tr.started_unix == tr.anchor[0] / 1e9
    assert tr.unix_ns(tr.t0 + 1.5) - tr.unix_ns(tr.t0) == 1_500_000_000
    tr.finish()
    doc = T.chrome_trace(tr)
    assert doc["otherData"]["started_unix"] == tr.started_unix
    assert doc["traceEvents"][0]["ts"] == 0.0


def _events(prof, name):
    return [(e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events() if e.name() == name]


def test_a_tiny_build_on_the_profilers_clock():
    from repro_torch.core.embedder import Embedder, EmbedderConfig
    from repro_torch.core.pipeline import TastiConfig, build_tasti
    from repro_torch.core.schema import make_workload
    wl = make_workload("night-street", n_frames=300)
    ecfg = EmbedderConfig(feature_dim=wl.features.shape[1], embed_dim=32)
    params = Embedder(ecfg, generator=torch.Generator().manual_seed(0)
                      ).state_dict()
    since = len(T.profiled_spans())
    with _profiled() as prof:
        system = build_tasti(wl, TastiConfig(n_reps=30, k=4, embed_dim=32),
                             variant="PT", embed_params=params, device="cpu",
                             embedder=ecfg)
    spans = T.profiled_spans()[since:]
    names = [s["name"] for s in spans]
    assert names == ["tasti.build", "tasti.load", "tasti.embed", "tasti.fpf",
                     "tasti.annotate", "tasti.topk"]
    build, load, embed, fpf, annotate, topk = spans
    assert all(s["parent_id"] == build["span_id"] for s in spans[1:])
    for s in spans[1:]:
        assert build["start_ns"] <= s["start_ns"] <= s["end_ns"] \
            <= build["end_ns"]
    ix = system.index
    n, n_fpf = 300, 27
    # the FPF loop's steps: one index_select each, all inside tasti.fpf;
    # the top-k's one inside tasti.topk
    assert fpf["attrs"]["steps"] == n_fpf - 1
    sel = _events(prof, "aten::index_select")
    in_fpf = [e for e in sel if fpf["start_ns"] <= e[0] and
              e[1] <= fpf["end_ns"]]
    in_topk = [e for e in sel if topk["start_ns"] <= e[0] and
               e[1] <= topk["end_ns"]]
    assert len(in_fpf) == n_fpf - 1 and len(in_topk) == 1
    assert len(sel) == n_fpf
    # the bytes: the embeddings up (the build), the weights (load), the
    # features up and the embeddings down (embed), the ids down (fpf), the
    # representatives' ids up and the top-k lists down (topk)
    feats = np.asarray(wl.features, np.float32)
    assert build["attrs"] == {"records": n, "variant": "PT",
                              "h2d_bytes": ix.embeddings.nbytes}
    assert load["attrs"] == {"d2h_bytes": 0, "h2d_bytes": sum(
        v.nbytes for v in params.values())}
    assert embed["attrs"] == {"records": n, "h2d_bytes": feats.nbytes,
                              "d2h_bytes": ix.embeddings.nbytes}
    assert fpf["attrs"] == {"records": n, "steps": n_fpf - 1,
                            "d2h_bytes": 8 * n_fpf}
    assert annotate["attrs"] == {"n": 30}
    assert topk["attrs"] == {"pairs": n * 30, "h2d_bytes": 8 * 30,
                             "d2h_bytes": ix.topk_d2.nbytes
                             + ix.topk_ids.nbytes}


def test_the_lm_forward_has_one_span():
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config("llama3.2-1b").smoke()
    params = lm.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16))
    since = len(T.profiled_spans())
    with torch.no_grad():
        plain = lm.lm_logits(params, {"tokens": tokens}, cfg)
        assert len(T.profiled_spans()) == since
        with _profiled():
            got = lm.lm_logits(params, {"tokens": tokens}, cfg)
    (s,) = T.profiled_spans()[since:]
    assert s["name"] == "lm.forward"
    assert s["attrs"] == {"tokens": 32, "layers": cfg.n_layers}
    torch.testing.assert_close(got, plain)
