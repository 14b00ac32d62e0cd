"""The port's tiered label store (``repro_torch.serve.store``) against the
JAX package's on the CPU: store files written by either package are read
by the other (format v2, the same lineage check over the same saved index
files), a v1 snapshot migrates, the journal survives a crash, warm reads
are byte-identical to hot ones, tier hits plus fresh calls account for
every request, and a reused stem for another dataset is refused.

Every comparison is exact: the store is host code, so labels, decoded
annotations and counters must be equal, not close."""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import schema as jax_schema  # noqa: E402
from repro.core.broker import OracleBroker as JaxBroker  # noqa: E402
from repro.core.engine import QueryEngine as JaxEngine  # noqa: E402
from repro.core.engine import QuerySpec as JaxSpec  # noqa: E402
from repro.core.index import TastiIndex as JaxIndex  # noqa: E402
from repro.core.index import _encode_annotation as jax_encode  # noqa: E402
from repro.core.session import QuerySession as JaxSession  # noqa: E402
from repro.serve.store import LabelStore as JaxStore  # noqa: E402
from repro.serve.store import index_fingerprint as jax_fingerprint  # noqa: E402
from repro_torch.core import schema as pt_schema  # noqa: E402
from repro_torch.core.broker import OracleBroker  # noqa: E402
from repro_torch.core.engine import QueryEngine, QuerySpec  # noqa: E402
from repro_torch.core.index import TastiIndex, _encode_annotation  # noqa: E402
from repro_torch.core.session import QuerySession  # noqa: E402
from repro_torch.serve.store import LabelStore, index_fingerprint  # noqa: E402
from repro_torch.serve.store import format as fmt  # noqa: E402
from repro_torch.serve.store.hot import CLEAN  # noqa: E402

pytestmark = pytest.mark.tier1

DATASETS = {"night-street": 1200, "wikisql": 900}
SPECS = {
    "night-street": [
        {"kind": "aggregation", "score": "score_count", "err": 0.2, "seed": 0},
        {"kind": "selection", "score": "score_has_object", "budget": 80,
         "seed": 0},
        {"kind": "limit", "score": "score_has_object", "k_results": 3}],
    "wikisql": [
        {"kind": "aggregation", "score": "score_n_predicates", "err": 0.2,
         "seed": 0},
        {"kind": "selection", "score": "score_is_select", "budget": 60,
         "seed": 0}],
}


@pytest.fixture(scope="module", params=sorted(DATASETS))
def saved(request, tmp_path_factory):
    """An index built by the JAX package and saved; both packages' workloads
    and each package's index loaded from the same files."""
    name = request.param
    n = DATASETS[name]
    jwl = jax_schema.make_workload(name, n_records=n)
    built = JaxIndex.build(jwl.features, 90, jwl.target_dnn_batch, k=4,
                           random_fraction=0.0, seed=0)
    stem = str(tmp_path_factory.mktemp("idx") / "idx")
    built.save(stem)
    return {"name": name, "stem": stem, "jwl": jwl,
            "pwl": pt_schema.make_workload(name, n_records=n),
            "jidx": JaxIndex.load(stem),
            "pidx": TastiIndex.load(stem, device="cpu")}


def _encoded(labels):
    """Labels in their on-disk JSON form: equal iff the decoded annotations
    are equal (Scene boxes, TextRecord fields, numbers, arrays).  Each
    package's schema records go through that package's encoder."""
    def enc(a):
        jax_record = type(a).__module__.startswith("repro.")
        return (jax_encode if jax_record else _encode_annotation)(a)
    return {int(i): json.dumps(enc(a), sort_keys=True)
            for i, a in labels.items()}


def _oracle(ids):
    return [float(i) * 0.5 for i in ids]


# -- cross-package files ---------------------------------------------------
def test_fingerprint_and_embeddings_match_across_packages(saved):
    """The lineage check hashes the host embeddings with their dtype: the
    port keeps them a host array of the npz's dtype, so both packages
    fingerprint the same index files alike."""
    pidx, jidx = saved["pidx"], saved["jidx"]
    assert isinstance(pidx.embeddings, np.ndarray)
    assert pidx.embeddings.dtype == np.asarray(jidx.embeddings).dtype
    assert index_fingerprint(pidx) == jax_fingerprint(jidx)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_store_written_by_one_package_is_read_by_the_other(saved, tmp_path,
                                                           writer):
    """A session's write-through (journal) and a saved v2 snapshot written
    by one package open in the other with the same labels; a warm repeat
    over the reader's engine then costs 0 fresh calls."""
    specs = SPECS[saved["name"]]
    for saved_snapshot in (False, True):
        stem = str(tmp_path / f"{writer}-{saved_snapshot}")
        if writer == "jax":
            store = JaxStore.for_index(stem, saved["jidx"])
            eng = JaxEngine(saved["jidx"], saved["jwl"], resident=False)
            store.attach(eng.broker, eng)
            JaxSession(eng, [JaxSpec.from_dict(d) for d in specs]).execute()
        else:
            store = LabelStore.for_index(stem, saved["pidx"])
            eng = QueryEngine(saved["pidx"], saved["pwl"])
            store.attach(eng.broker, eng)
            QuerySession(eng, [QuerySpec.from_dict(d) for d in specs]
                         ).execute()
        if saved_snapshot:
            store.save()
            manifest = fmt.manifest_path(pathlib.Path(stem))
            assert json.loads(manifest.read_text())["format_version"] == 2
        else:
            assert store.journal_path.exists()
        written = _encoded(store.labels)
        assert len(written) > 0
        if writer == "jax":
            reader = LabelStore.for_index(stem, saved["pidx"])
            eng2 = QueryEngine(saved["pidx"], saved["pwl"])
            assert reader.attach(eng2.broker, eng2) == len(written)
            out = QuerySession(eng2, [QuerySpec.from_dict(d)
                                      for d in specs]).execute()
        else:
            reader = JaxStore.for_index(stem, saved["jidx"])
            eng2 = JaxEngine(saved["jidx"], saved["jwl"], resident=False)
            assert reader.attach(eng2.broker, eng2) == len(written)
            out = JaxSession(eng2, [JaxSpec.from_dict(d)
                                    for d in specs]).execute()
        assert _encoded(reader.labels) == written
        assert out.stats["fresh_total"] == 0


def test_both_packages_write_the_same_labels(saved, tmp_path):
    """The same session through each package's engine and store leaves the
    same labels behind, and each store's manifest the same lineage."""
    specs = SPECS[saved["name"]]
    js = JaxStore.for_index(str(tmp_path / "j"), saved["jidx"])
    je = JaxEngine(saved["jidx"], saved["jwl"], resident=False)
    js.attach(je.broker, je)
    JaxSession(je, [JaxSpec.from_dict(d) for d in specs]).execute()
    ps = LabelStore.for_index(str(tmp_path / "p"), saved["pidx"])
    pe = QueryEngine(saved["pidx"], saved["pwl"])
    ps.attach(pe.broker, pe)
    QuerySession(pe, [QuerySpec.from_dict(d) for d in specs]).execute()
    assert _encoded(ps.labels) == _encoded(js.labels)
    js.save()
    ps.save()
    lineage = lambda stem: {k: v for k, v in json.loads(  # noqa: E731
        fmt.manifest_path(stem).read_text()).items()
        if k in ("format_version", "index_version", "fingerprint")}
    assert lineage(tmp_path / "p") == lineage(tmp_path / "j")


def test_v1_snapshot_migrates_in_the_port(tmp_path):
    """A version-1 snapshot (one inline annotation list) loads, and the
    next save writes format 2, which the JAX package reads back."""
    stem = tmp_path / "s"
    labels = {i: float(i) for i in range(20)}
    meta = {"format_version": 1, "index_version": 0, "fingerprint": None,
            "annotations": [_encode_annotation(a) for a in labels.values()]}
    fmt.manifest_path(stem).write_text(json.dumps(meta))
    np.savez(fmt.ids_path(stem), ids=np.asarray(sorted(labels), np.int64))
    store = LabelStore.open(str(stem), 0)
    assert store.labels == labels
    store.save()
    assert json.loads(fmt.manifest_path(stem).read_text())[
        "format_version"] == 2
    assert LabelStore.open(str(stem), 0).labels == labels
    assert JaxStore.open(str(stem), 0).labels == labels


def test_future_format_version_refused(tmp_path):
    stem = tmp_path / "s"
    fmt.manifest_path(stem).write_text(
        json.dumps({"format_version": 99, "index_version": 0}))
    with pytest.raises(ValueError, match="format_version 99"):
        LabelStore.open(str(stem), 0)


# -- journal, tiers, accounting (mirrors tests/test_label_store.py) --------
def test_journal_survives_a_crash_and_a_torn_tail(tmp_path):
    """Sealed journal segments and the active journal both replay without a
    save(); a half-written last line is skipped, the rest kept."""
    stem = str(tmp_path / "s")
    store = LabelStore(stem, journal_rotate_bytes=256, auto_compact=False)
    broker = OracleBroker(_oracle, max_batch=8)
    store.attach(broker)
    broker.fetch(list(range(40)))
    broker.fetch([40, 41, 42])
    assert store.stats["journal_rotations"] >= 1
    assert len(fmt.sealed_journals(store.path)) >= 1
    revived = LabelStore.open(stem, 0)
    assert sorted(revived.labels) == list(range(43))
    assert revived.labels[11] == 5.5
    assert JaxStore.open(stem, 0).labels == revived.labels
    with open(store.journal_path, "a") as f:
        f.write('{"ids": [99], "anno')
    survivor = LabelStore.open(stem, 0)
    assert sorted(survivor.labels) == list(range(43))
    survivor.save()
    assert not survivor.journal_path.exists()
    assert not fmt.sealed_journals(survivor.path)
    assert LabelStore.open(stem, 0).labels == survivor.labels


def test_eviction_never_loses_a_journaled_label(tmp_path):
    stem = str(tmp_path / "s")
    store = LabelStore(stem, hot_budget=2048, journal_rotate_bytes=256)
    broker = OracleBroker(_oracle, max_batch=8)
    store.attach(broker)
    for start in range(0, 300, 20):
        broker.fetch(list(range(start, start + 20)))
        assert store._hot.bytes <= 2048
    assert store.stats["evictions"] > 0
    got = store.get_many(range(300), promote=False)
    assert got == {i: i * 0.5 for i in range(300)}
    revived = LabelStore.open(stem, 0, hot_budget=2048)
    assert len(revived) == 300 and revived._hot.bytes <= 2048


def test_warm_reads_are_byte_identical_to_hot(tmp_path):
    stem = str(tmp_path / "s")
    labels = {
        0: np.arange(12, dtype=np.float32).reshape(3, 4),
        1: pt_schema.Scene(boxes=np.asarray([[0.25, 0.5], [0.75, 0.1]])),
        2: {"tag": "night", "scores": [1.0, 2.5], "n": 3},
        3: "a string annotation",
        4: None,
        5: 42,
        6: pt_schema.TextRecord(op=2, n_predicates=3),
    }
    store = LabelStore(stem, labels=dict(labels))
    hot = {i: store.broker_get(i) for i in labels}
    store.save()
    cold = LabelStore.open(stem, 0, hot_budget=1)        # nothing fits hot
    for i in labels:
        warm = cold.broker_get(i)
        if isinstance(labels[i], np.ndarray):
            assert warm.dtype == hot[i].dtype
            assert warm.tobytes() == hot[i].tobytes()
        elif isinstance(labels[i], pt_schema.Scene):
            assert warm.boxes.tobytes() == hot[i].boxes.tobytes()
        else:
            assert warm == hot[i]
    # and the JAX package's warm reads decode to the same annotations
    assert _encoded(JaxStore.open(stem, 0).labels) == _encoded(labels)


def test_warm_lookup_skips_non_member_segments(tmp_path):
    stem = str(tmp_path / "s")
    LabelStore(stem, labels={i: float(i) for i in range(100, 200)}).save()
    cold = LabelStore.open(stem, 0)
    assert cold._warm.get_many(range(0, 50)) == {}
    assert cold._warm.segments[0]._mmap is None
    assert 150 in cold and 50 not in cold


def test_tier_hits_plus_fresh_account_for_every_request(tmp_path):
    """hits_hot + hits_warm + dedup_inflight + fresh == requests, the same
    counts as the JAX store's, and a warm restart with a tiny hot tier
    costs 0 fresh calls."""
    counts = {}
    for pkg, Store, Broker in (("jax", JaxStore, JaxBroker),
                               ("torch", LabelStore, OracleBroker)):
        stem = str(tmp_path / pkg)
        store = Store(stem, hot_budget=4096)
        broker = Broker(_oracle, max_batch=16)
        store.attach(broker)
        broker.fetch(list(range(120)))
        broker.fetch(list(range(60, 180)))
        broker.fetch(list(range(0, 40)))
        s, b = store.stats, broker.stats
        assert (s["hits_hot"] + s["hits_warm"] + b["dedup_inflight"]
                + b["fresh"] == b["requests"])
        assert s["hits_hot"] + s["hits_warm"] == b["cached"]
        store.save()
        cold = Store.open(stem, 0, hot_budget=1024)
        broker2 = Broker(_oracle, max_batch=16)
        assert cold.attach(broker2) == 180
        broker2.fetch(list(range(180)))
        counts[pkg] = (dict(b), broker2.stats["fresh"],
                       cold.stats["hits_warm"] > 0)
    assert counts["torch"] == counts["jax"]
    assert counts["torch"][0]["fresh"] == 180
    assert counts["torch"][1] == 0 and counts["torch"][2]


def test_mid_serving_fetch_promotes_warm_without_fresh(tmp_path):
    stem = str(tmp_path / "s")
    LabelStore(stem, labels={i: float(i) for i in range(50)}).save()
    store = LabelStore.open(stem, 0, hot_budget=256)
    broker = OracleBroker(_oracle, max_batch=16)
    store.attach(broker)
    assert broker.fetch([7, 8, 9]) == [7.0, 8.0, 9.0]
    assert broker.stats["fresh"] == 0 and store.stats["hits_warm"] == 3
    assert store._hot.state(9) == CLEAN


def test_segment_count_stays_bounded(tmp_path):
    stem = str(tmp_path / "s")
    store = LabelStore(stem, max_segments=3)
    for round_ in range(8):
        store.update({round_ * 100 + i: float(i) for i in range(30)})
        store.save()
    assert len(store._warm.segments) <= 3 and len(store) == 240
    assert LabelStore.open(stem, 0).labels == store.labels


# -- lineage (mirrors the store half of tests/test_serve.py) ---------------
def test_reused_stem_for_another_dataset_is_refused(saved, tmp_path):
    """Same index version (0), different embeddings: the store comes back
    empty in the port, as in the JAX package."""
    stem = str(tmp_path / "s")
    store = LabelStore.for_index(stem, saved["pidx"])
    store.update({0: saved["pwl"].target_dnn(0)})
    store.save()
    assert len(LabelStore.for_index(stem, saved["pidx"])) == 1
    other = pt_schema.make_workload("taipei", n_frames=300)
    other_index = TastiIndex.build(other.features, 30,
                                   other.target_dnn_batch, k=2,
                                   random_fraction=0.0, seed=0, device="cpu")
    assert other_index.version == saved["pidx"].version == 0
    assert len(LabelStore.for_index(stem, other_index)) == 0


def test_crack_restamps_and_other_lineage_is_dropped(saved, tmp_path):
    """A cracking query bumps the index version; the attached store
    re-stamps on its next write-through and reloads against the cracked
    index, while the old version's open comes back empty."""
    pidx = TastiIndex.load(saved["stem"], device="cpu")
    stem = str(tmp_path / "s")
    store = LabelStore.for_index(stem, pidx)
    eng = QueryEngine(pidx, saved["pwl"])
    store.attach(eng.broker, eng)
    spec = dict(SPECS[saved["name"]][1], crack=True)
    res = eng.execute(QuerySpec.from_dict(spec))
    assert res.n_cracked > 0 and pidx.version > 0
    assert store.index_version == pidx.version
    assert len(LabelStore.for_index(stem, pidx)) == len(store) > 0
    assert len(LabelStore.open(stem, 0)) == 0


def test_store_save_is_atomic(tmp_path):
    store = LabelStore(str(tmp_path / "s"), index_version=0)
    store.update({1: 1.0})
    store.save()
    store.update({2: object()})
    with pytest.raises(TypeError):
        store.save()
    assert not list(tmp_path.glob("*.tmp"))
    assert len(LabelStore.open(str(tmp_path / "s"), 0)) == 1


# -- format helpers --------------------------------------------------------
def test_parse_bytes_and_bloom_match_the_jax_package():
    from repro.serve.store import format as jax_fmt
    for value in (None, 1024, "64k", "1.5m", "2g"):
        assert fmt.parse_bytes(value) == jax_fmt.parse_bytes(value)
    for bad in ("nope", 0, -5, "0k", True):
        with pytest.raises(ValueError):
            fmt.parse_bytes(bad)
    ids = np.unique(np.random.default_rng(0).integers(0, 1 << 40, size=500))
    bits = fmt.bloom_build(ids)
    np.testing.assert_array_equal(bits, jax_fmt.bloom_build(ids))
    assert fmt.bloom_maybe_contains(bits, ids).all()
