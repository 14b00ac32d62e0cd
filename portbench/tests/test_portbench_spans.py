"""The readers of the program's spans, against planted spans and a planted
capture: stage times and idle shares a build, the copy rate, the forward's
host time, spans outside the window left out, and nothing where the run is
untraced or the program keeps no spans."""
from __future__ import annotations

import json

import pytest

from portbench_tiny import ROOT

from portbench.cells import Cell
from portbench.harness import Reading, Window
from portbench.spans import idle_ns
from portbench.trace import Capture

INDEX = "index_build.tasti-night-street-1m"
PREFILL = "prefill_long.phi3-medium-14b"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
#: the metrics that read the program's spans, and their cells
SPAN_METRICS = {
    "embed_records_per_s.build": [INDEX], "embed_idle.build": [INDEX],
    "fpf_ms_per_build": [INDEX], "fpf_idle.build": [INDEX],
    "host_ms_per_build": [INDEX], "copy_gb_per_s.build": [INDEX],
    "forward_host_ms.prefill": [PREFILL],
}
MS = 1_000_000


def _reader(name):
    return Cell(SPAN_METRICS[name][0]).reader(name)


class _Driver:
    def shape(self):
        return {}

    def probes(self):
        return {}


def _reading(device, window_ns=(0, 100 * MS), traced=True, units=2):
    cap = Capture(traced)
    cap.device = device
    cap.window_ns = window_ns
    return Reading(cap, Window(units=units, seconds=0.1), _Driver())


def _span(name, a_ms, b_ms, **attrs):
    return {"name": name, "start_ns": int(a_ms * MS), "end_ns": int(b_ms * MS),
            "attrs": attrs}


def _build(at):
    """A build of 40 ms from ``at``: load 2, embed 10 (1,000 records), fpf
    8, annotate 1, topk 4, the rest host; with its bytes."""
    return [
        _span("tasti.build", at, at + 40, records=1000, variant="PT",
              h2d_bytes=4_000),
        _span("tasti.load", at + 1, at + 3, h2d_bytes=1_000, d2h_bytes=0),
        _span("tasti.embed", at + 5, at + 15, records=1000,
              h2d_bytes=2_000, d2h_bytes=4_000),
        _span("tasti.fpf", at + 20, at + 28, steps=9, records=1000,
              d2h_bytes=80),
        _span("tasti.annotate", at + 29, at + 30, n=10),
        _span("tasti.topk", at + 31, at + 35, pairs=10_000, h2d_bytes=80,
              d2h_bytes=640),
    ]


# two builds, 0-40 and 50-90 ms; the device busy through each embed span
# but its first 2 ms, and for 6 of each fpf span's 8 ms
DEVICE = [
    ("Memcpy HtoD (Pageable -> Device)", 7 * MS, 1 * MS, "copy"),
    ("void cutlass::Kernel2<...>", 8 * MS, 7 * MS, "kernel"),
    ("void fpf_update_kernel<float>(...)", 20 * MS, 3 * MS, "kernel"),
    ("void fpf_update_kernel<float>(...)", 24 * MS, 3 * MS, "kernel"),
    ("Memcpy DtoD (Device -> Device)", 30 * MS, 1 * MS, "copy"),
    ("Memcpy DtoH (Device -> Pageable)", 33 * MS, 1 * MS, "copy"),
    ("Memcpy HtoD (Pageable -> Device)", 57 * MS, 1 * MS, "copy"),
    ("void cutlass::Kernel2<...>", 58 * MS, 7 * MS, "kernel"),
    ("void fpf_update_kernel<float>(...)", 70 * MS, 6 * MS, "kernel"),
]
SPANS = _build(0) + _build(50)


def test_stage_times_and_idle_shares_a_build():
    r = _reading(DEVICE)
    # 1,000 records over each 10 ms embed span
    assert _reader("embed_records_per_s.build")(r, SPANS) == \
        pytest.approx(100_000.0)
    # each embed span is busy from 7 (or 57) ms to its end: 2 of 10 idle
    assert _reader("embed_idle.build")(r, SPANS) == pytest.approx(20.0)
    # fpf: 2 of 8 ms idle in both builds
    assert _reader("fpf_idle.build")(r, SPANS) == pytest.approx(25.0)
    assert _reader("fpf_ms_per_build")(r, SPANS) == pytest.approx(8.0)
    # 40 ms less embed 10, fpf 8 and topk 4
    assert _reader("host_ms_per_build")(r, SPANS) == pytest.approx(18.0)


def test_idle_is_what_the_union_of_device_intervals_leaves():
    busy = [(0, 10), (20, 30), (40, 50)]
    starts = [a for a, _ in busy]
    assert idle_ns(busy, starts, 0, 50) == 20
    assert idle_ns(busy, starts, 5, 25) == 10
    assert idle_ns(busy, starts, 12, 18) == 6
    assert idle_ns(busy, starts, 45, 70) == 20
    assert idle_ns([], [], 3, 9) == 6


def test_spans_outside_the_window_are_left_out():
    # the window (a device-side range, 45-89 ms) holds the second build,
    # whose host tail ends 1 ms after it; the first build lies before it
    r = _reading(DEVICE, window_ns=(45 * MS, 89 * MS))
    late = [dict(s, start_ns=s["start_ns"] + 200 * MS,
                 end_ns=s["end_ns"] + 200 * MS) for s in SPANS]
    spans = SPANS + late
    assert _reader("fpf_ms_per_build")(r, spans) == pytest.approx(8.0)
    assert _reader("embed_idle.build")(r, spans) == pytest.approx(20.0)
    # 2 of 8 fpf ms idle in the second build (busy 70-76 of 70-78)
    assert _reader("fpf_idle.build")(r, spans) == pytest.approx(25.0)
    # the second build's bytes alone over its copy, 1 ms of HtoD (a
    # capture holds only its window's records)
    r2 = _reading([d for d in DEVICE if d[1] >= 45 * MS],
                  window_ns=(45 * MS, 89 * MS))
    assert _reader("copy_gb_per_s.build")(r2, spans) == \
        pytest.approx(11_800 / 1e-3 / 1e9)
    # nothing of a window that holds no build
    r3 = _reading(DEVICE, window_ns=(41 * MS, 49 * MS))
    assert _reader("host_ms_per_build")(r3, spans) is None


def test_copy_rate_counts_host_device_copies_alone():
    r = _reading(DEVICE)
    # each build counts 4,000 + 1,000 + 6,000 + 80 + 720 bytes; the copies
    # between host and device take 3 ms (the DtoD is left out)
    assert _reader("copy_gb_per_s.build")(r, SPANS) == \
        pytest.approx(2 * 11_800 / 3e-3 / 1e9)
    # no counted bytes, or no copies: no rate
    bare = [dict(s, attrs={}) for s in SPANS]
    assert _reader("copy_gb_per_s.build")(r, bare) is None
    assert _reader("copy_gb_per_s.build")(
        _reading([d for d in DEVICE if d[3] != "copy"]), SPANS) is None


def test_forward_host_time():
    r = _reading([("void flash_tc_kernel<...>", 0, 90 * MS, "kernel")])
    spans = [_span("lm.forward", 1, 31, tokens=32768, layers=40),
             _span("lm.forward", 50, 60, tokens=32768, layers=40),
             _span("lm.forward", 105, 130, tokens=32768, layers=40)]
    assert _reader("forward_host_ms.prefill")(r, spans) == pytest.approx(20.0)
    assert _reader("forward_host_ms.prefill")(r, SPANS) is None


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_no_reading_where_untraced_or_without_spans(name, monkeypatch):
    read = _reader(name)
    assert read(_reading(DEVICE, traced=False), SPANS) is None
    assert read(_reading([]), SPANS) is None
    assert read(_reading(DEVICE, window_ns=None), SPANS) is None
    assert read(_reading(DEVICE), []) is None
    # a program that keeps no spans (an older version of the port)
    from repro_torch.obs import trace
    monkeypatch.delattr(trace, "profiled_spans")
    assert read(_reading(DEVICE)) is None


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_every_span_metric_resolves_to_a_reader(name):
    entry = {m["name"]: m for m in SPEC["per_layer"]}[name]
    assert entry["workloads"] == SPAN_METRICS[name]
    for cell in entry["workloads"]:
        assert callable(Cell(cell).reader(name))
        assert name in {m["name"] for m in Cell(cell).per_layer}
