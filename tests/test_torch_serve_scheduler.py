"""The port's query scheduler (``repro_torch.serve.scheduler``) against the
JAX package's on the CPU: priority classes, EDF within a class, weighted
shares, per-workload caps, grant-time coalescing, shutdown shedding and
preemption at slice boundaries, each scenario run through both packages'
schedulers with the same outcome, and sliced execution byte-identical to
unsliced in both engines.

No scenario depends on a sleep winning a race: tasks are ordered by
their submission (``submit`` assigns the sequence number before it
returns), the admission window runs on an injected clock that the test
advances once every task is queued, and waits are on events with
generous bounds."""
import threading
import time
import types

import pytest

pytest.importorskip("torch")

from repro.core import schema as jax_schema  # noqa: E402
from repro.core.engine import QueryEngine as JaxEngine  # noqa: E402
from repro.core.engine import QuerySpec as JaxSpec  # noqa: E402
from repro.core.index import TastiIndex as JaxIndex  # noqa: E402
from repro.core.session import QuerySession as JaxSession  # noqa: E402
from repro.serve import scheduler as jax_scheduler  # noqa: E402
from repro_torch.core import schema as pt_schema  # noqa: E402
from repro_torch.core.engine import QueryEngine, QuerySpec  # noqa: E402
from repro_torch.core.index import TastiIndex  # noqa: E402
from repro_torch.core.session import QuerySession  # noqa: E402
from repro_torch.serve import scheduler as pt_scheduler  # noqa: E402
from repro_torch.serve.registry import (WorkloadEntry,  # noqa: E402
                                        WorkloadRegistry)

pytestmark = pytest.mark.tier1

WAIT = 20.0            # seconds: a bound, never a race


class _Sub:
    def __init__(self, label):
        self.label = label
        self.done = threading.Event()


def _task(mod, label, workload="w", priority=1, deadline=None, budget=None):
    return mod.ScheduledTask(workload=workload, submissions=[_Sub(label)],
                             priority=priority, deadline=deadline,
                             budget=budget)


def _make(mod, run_fn, **kw):
    fails = []

    def done(task):
        for sub in task.submissions:
            sub.done.set()

    sched = mod.QueryScheduler(
        load=lambda t: "entry",
        run=lambda t, e: (run_fn(t), done(t)),
        fail=lambda t, e, status: (fails.append(status), done(t)), **kw)
    return sched, fails


def _wait_all(tasks):
    for t in tasks:
        for sub in t.submissions:
            assert sub.done.wait(WAIT), f"{sub.label} never completed"


def _blocked(mod, order, release, **kw):
    """A scheduler whose first task holds its slot until ``release``."""
    running = threading.Event()

    def run(task):
        label = task.submissions[0].label
        if label.startswith("blocker"):
            running.set()
            assert release.wait(WAIT)
        order.append(label)

    sched, fails = _make(mod, run, **kw)
    blocker = _task(mod, "blocker")
    sched.submit(blocker)
    assert running.wait(WAIT)
    return sched, fails, blocker


def _scenario_priority(mod):
    order, release = [], threading.Event()
    sched, fails, blocker = _blocked(mod, order, release, max_workers=1,
                                     preempt=False)
    low, high = _task(mod, "low", priority=2), _task(mod, "high", priority=0)
    sched.submit(low)                 # low first by sequence number
    sched.submit(high)
    release.set()
    _wait_all([blocker, low, high])
    sched.shutdown()
    return order, fails


def _scenario_edf(mod):
    order, release = [], threading.Event()
    sched, fails, blocker = _blocked(mod, order, release, max_workers=1,
                                     preempt=False)
    now = time.monotonic()
    tasks = [_task(mod, "no-deadline"), _task(mod, "late", deadline=now + 60),
             _task(mod, "soon", deadline=now + 1)]
    for t in tasks:
        sched.submit(t)
    release.set()
    _wait_all([blocker] + tasks)
    sched.shutdown()
    return order, fails


def _scenario_cap(mod):
    order, release = [], threading.Event()
    sched, fails, blocker = _blocked(mod, order, release, max_workers=2,
                                     preempt=False, caps={"w": 1})
    capped, other = _task(mod, "capped"), _task(mod, "other", workload="v")
    sched.submit(capped)              # w is at its cap: the blocker holds it
    sched.submit(other)
    _wait_all([other])                # runs on the free slot
    before = list(order)
    release.set()
    _wait_all([blocker, capped])
    sched.shutdown()
    return (before, order), fails


def _scenario_shares(mod, shares):
    order = []
    release_ab, release_c = threading.Event(), threading.Event()
    running = {w: threading.Event() for w in "abc"}

    def run(task):
        label = task.submissions[0].label
        if label.startswith("blocker"):
            running[task.workload].set()
            gate = release_c if task.workload == "c" else release_ab
            assert gate.wait(WAIT)
        order.append(label)

    sched, fails = _make(mod, run, max_workers=3, preempt=False,
                         shares=shares)
    blockers = [_task(mod, f"blocker-{w}", workload=w) for w in "abc"]
    for t in blockers:
        sched.submit(t)
    assert all(running[w].wait(WAIT) for w in "abc")
    a2, b2 = _task(mod, "a2", workload="a"), _task(mod, "b2", workload="b")
    sched.submit(a2)
    sched.submit(b2)
    release_c.set()                   # one slot frees: the winner takes it
    _wait_all([a2, b2])               # the loser waits for the winner's
    first = [x for x in order if not x.startswith("blocker")][:1]
    release_ab.set()
    _wait_all(blockers)
    sched.shutdown()
    return first, fails


def _scenario_preemption(mod):
    order, box = [], {}
    high_done, heavy_running = threading.Event(), threading.Event()

    def run(task):
        label = task.submissions[0].label
        if label == "heavy":
            heavy_running.set()
            deadline = time.monotonic() + WAIT
            while not high_done.is_set() and time.monotonic() < deadline:
                box["sched"].checkpoint(task)       # may park here
                time.sleep(0.001)
        else:
            high_done.set()
        order.append(label)

    sched, fails = _make(mod, run, max_workers=1, preempt=True)
    box["sched"] = sched
    heavy = _task(mod, "heavy", priority=2)
    sched.submit(heavy)
    assert heavy_running.wait(WAIT)
    high = _task(mod, "high", priority=0)
    sched.submit(high)
    _wait_all([heavy, high])
    out = (order, heavy.preemptions >= 1, sched.stats["preemptions"] >= 1)
    sched.shutdown()
    return out, fails


class _Clock:
    """A monotonic clock the test moves by hand."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


def _scenario_window(mod, monkeypatch, window):
    """Every task is queued before the window opens: which ones merge is
    then fixed by the rules alone."""
    clock = _Clock()
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(
        monotonic=clock.monotonic, perf_counter=time.perf_counter))
    runs = []
    sched, fails = _make(mod, lambda t: runs.append(
        sorted(s.label for s in t.submissions)), max_workers=1,
        admission_window=window)
    tasks = [_task(mod, "u1"), _task(mod, "u2"),
             _task(mod, "budgeted", budget=50),
             _task(mod, "urgent", priority=0), _task(mod, "u3")]
    for t in tasks:
        sched.submit(t)
    clock.now += window + 1.0         # the window elapses for everyone
    with sched._cond:
        sched._cond.notify_all()
    _wait_all(tasks)
    sched.shutdown()
    return (sorted(runs), sched.stats["merged"]), fails


def _scenario_shutdown(mod):
    order, release = [], threading.Event()
    sched, fails, blocker = _blocked(mod, order, release, max_workers=1,
                                     preempt=False)
    waiter = _task(mod, "waiter")
    sched.submit(waiter)
    done = threading.Event()
    threading.Thread(target=lambda: (sched.shutdown(), done.set()),
                     daemon=True).start()
    deadline = time.monotonic() + WAIT
    while not sched._closed and time.monotonic() < deadline:
        time.sleep(0.005)
    release.set()
    assert done.wait(WAIT)
    _wait_all([blocker, waiter])
    return (order, sched.stats["shed"]), fails


SCENARIOS = {
    "priority": (_scenario_priority, (["blocker", "high", "low"], [])),
    "edf": (_scenario_edf, (["blocker", "soon", "late", "no-deadline"], [])),
    "cap": (_scenario_cap, ((["other"], ["other", "blocker", "capped"]), [])),
    "shares_equal": (lambda mod: _scenario_shares(mod, None), (["a2"], [])),
    "shares_weighted": (lambda mod: _scenario_shares(mod, {"b": 8.0}),
                        (["b2"], [])),
    "preemption": (_scenario_preemption,
                   ((["high", "heavy"], True, True), [])),
    "shutdown": (_scenario_shutdown, ((["blocker"], 1), [503])),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scheduler_scenario_matches_jax(name):
    scenario, want = SCENARIOS[name]
    assert scenario(jax_scheduler) == want
    assert scenario(pt_scheduler) == want


@pytest.mark.parametrize("window,merged", [(0.15, 2), (0.0, 0)])
def test_admission_window_merges_only_unbudgeted_same_class(monkeypatch,
                                                            window, merged):
    """window > 0: the unbudgeted same-class strangers share one run; the
    budgeted task and the other class run alone.  window 0 never merges."""
    want = {0.15: [["budgeted"], ["u1", "u2", "u3"], ["urgent"]],
            0.0: [["budgeted"], ["u1"], ["u2"], ["u3"], ["urgent"]]}[window]
    for mod in (jax_scheduler, pt_scheduler):
        (runs, n_merged), fails = _scenario_window(mod, monkeypatch, window)
        assert runs == want and n_merged == merged and fails == []


# -- slicing in the engine ---------------------------------------------------
@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    jwl = jax_schema.make_workload("night-street", n_frames=1200)
    idx = JaxIndex.build(jwl.features, 120, jwl.target_dnn_batch, k=4,
                         random_fraction=0.0, seed=0)
    stem = str(tmp_path_factory.mktemp("idx") / "ns")
    idx.save(stem)
    pwl = pt_schema.make_workload("night-street", n_frames=1200)
    return (lambda: JaxEngine(JaxIndex.load(stem), jwl, resident=False),
            lambda: QueryEngine(TastiIndex.load(stem, device="cpu"), pwl))


SLICED = [{"kind": "aggregation", "score": "score_count", "err": 0.2},
          {"kind": "limit", "score": "score_has_object", "k_results": 4},
          {"kind": "selection", "score": "score_has_object", "budget": 80}]


def _signature(out, engine):
    return ([(r.estimate, r.n_invocations, r.n_oracle_fresh,
              r.n_oracle_cached,
              None if r.selected is None else [int(i) for i in r.selected])
             for r in out.results], engine.broker.snapshot()["fresh"])


@pytest.mark.parametrize("slice_size", [7, 64])
def test_sliced_execution_is_byte_identical(engines, slice_size):
    """checkpoint + slice_size chunks every fetch; ids, labels and
    fresh/cached accounting match unsliced execution, in both packages,
    and the two packages match each other."""
    make_jax, make_pt = engines
    sigs = []
    for make, Session, Spec in ((make_jax, JaxSession, JaxSpec),
                                (make_pt, QuerySession, QuerySpec)):
        specs = [Spec.from_dict(d) for d in SLICED]
        plain_eng, sliced_eng = make(), make()
        plain = Session(plain_eng, specs).execute()
        beats = []
        sliced = Session(sliced_eng, specs, checkpoint=lambda: beats.append(1),
                         slice_size=slice_size).execute()
        assert beats
        assert _signature(sliced, sliced_eng) == _signature(plain, plain_eng)
        sigs.append(_signature(sliced, sliced_eng))
    assert sigs[1] == sigs[0]


# -- registry close ------------------------------------------------------------
def test_registry_close_during_lazy_load_returns_promptly():
    """close() racing an in-flight lazy load skips it (the load is not
    awaited) and the load still completes."""
    entry = WorkloadEntry("slow")
    release, loaded, started = (threading.Event(), threading.Event(),
                                threading.Event())

    def slow_load():
        started.set()
        release.wait(WAIT)
        entry.engine = "engine"
        loaded.set()

    entry._load = slow_load
    registry = WorkloadRegistry()
    registry._add(entry)
    loader = threading.Thread(target=entry.ensure_loaded, daemon=True)
    loader.start()
    assert started.wait(WAIT)         # the loader holds the entry's lock
    t0 = time.monotonic()
    registry.close()
    assert time.monotonic() - t0 < 5.0
    assert not loaded.is_set()
    release.set()
    loader.join(WAIT)
    assert loaded.is_set() and entry.loaded
