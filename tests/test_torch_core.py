"""Core parity for the PyTorch port on the CPU: workload rendering, FPF,
the TASTI index (build, crack, save/load across packages), host
propagation and the embedder, each fed the same seeded numpy inputs as
its counterpart in the JAX package."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import embedder as jax_embedder  # noqa: E402
from repro.core import propagation as jax_propagation  # noqa: E402
from repro.core import schema as jax_schema  # noqa: E402
from repro.core.fpf import fpf_select as jax_fpf_select  # noqa: E402
from repro.core.fpf import max_intra_cluster_dist as jax_micd  # noqa: E402
from repro.core.index import TastiIndex as JaxIndex  # noqa: E402
from repro_torch.core import embedder as pt_embedder  # noqa: E402
from repro_torch.core import propagation as pt_propagation  # noqa: E402
from repro_torch.core import schema as pt_schema  # noqa: E402
from repro_torch.core.fpf import fpf_select, max_intra_cluster_dist  # noqa: E402
from repro_torch.core.index import TastiIndex  # noqa: E402

pytestmark = pytest.mark.tier1


def _blobs(n=600, d=16, seed=0):
    rng = np.random.default_rng(seed)
    # norms stay small: float32 |x|^2+|r|^2-2x.r keeps 1e-4 absolute error
    centers = rng.normal(0, 1.5, size=(12, d))
    return (centers[rng.integers(0, 12, n)]
            + rng.normal(0, 0.5, size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("name", ["night-street", "taipei", "wikisql"])
def test_workload_features_match_reference(name, monkeypatch):
    """Chunked rendering (several chunks here) reproduces the reference."""
    monkeypatch.setattr(pt_schema, "_RENDER_CHUNK", 97)
    ref = jax_schema.make_workload(name, n_frames=700)
    got = pt_schema.make_workload(name, n_frames=700)
    np.testing.assert_allclose(got.features, ref.features, rtol=0, atol=1e-6)
    for i in range(0, 700, 50):
        assert repr(got.target_dnn(i)) == repr(ref.target_dnn(i))


@pytest.mark.parametrize("seed,frac", [(0, 0.1), (3, 0.0), (5, 0.3)])
def test_fpf_select_same_ids(seed, frac):
    x = _blobs(seed=seed)
    want = jax_fpf_select(x, 60, random_fraction=frac, seed=seed)
    got = fpf_select(x, 60, random_fraction=frac, seed=seed, device="cpu")
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    got_t = fpf_select(torch.from_numpy(x), 60, random_fraction=frac,
                       seed=seed, start=7)
    np.testing.assert_array_equal(
        got_t, jax_fpf_select(x, 60, random_fraction=frac, seed=seed, start=7))
    assert max_intra_cluster_dist(x, got, device="cpu") == pytest.approx(
        jax_micd(x, want), rel=1e-5)


def _annotate(ids):
    return [float(i % 7) for i in np.asarray(ids)]


def _build_pair(n=500, d=16, n_reps=40, k=5, seed=1):
    x = _blobs(n, d, seed)
    ref = JaxIndex.build(x, n_reps, _annotate, k=k, seed=seed)
    got = TastiIndex.build(x, n_reps, _annotate, k=k, seed=seed,
                           device="cpu")
    return x, ref, got


def test_index_build_matches_reference():
    _, ref, got = _build_pair()
    np.testing.assert_array_equal(got.rep_ids, ref.rep_ids)
    assert got.annotations == ref.annotations
    assert got.topk_ids.dtype == np.int32 and got.topk_d2.dtype == np.float32
    np.testing.assert_allclose(got.topk_d2, ref.topk_d2, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.topk_ids, ref.topk_ids)
    assert dataclasses.asdict(got.cost) == dataclasses.asdict(ref.cost)
    assert got.max_intra_cluster() == pytest.approx(ref.max_intra_cluster(),
                                                    rel=1e-5)


@pytest.mark.parametrize("n_reps,k", [(40, 5), (3, 8)])
def test_crack_matches_reference(n_reps, k):
    """Equal distances after cracking (ids may differ only on ties), the
    same reps, annotations and version, and device copies that track."""
    _, ref, got = _build_pair(n_reps=n_reps, k=k)
    rng = np.random.default_rng(9)
    for _ in range(2):
        new = rng.choice(500, size=25, replace=False)
        anns = _annotate(new)
        ref.crack(new, anns)
        got.crack(new, anns)
        np.testing.assert_allclose(got.topk_d2, ref.topk_d2, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(got.rep_ids, ref.rep_ids)
        assert got.version == ref.version and got.n_reps == ref.n_reps
    # the returned ids reproduce the returned distances
    x = got.embeddings
    d_from_ids = ((x[:, None, :] - x[got.rep_ids[got.topk_ids]]) ** 2).sum(-1)
    real = got.topk_d2 < 1e30
    np.testing.assert_allclose(d_from_ids[real], got.topk_d2[real],
                               rtol=1e-4, atol=1e-3)
    version, ids_dev, d2_dev = got.topk_device()
    assert version == got.version
    np.testing.assert_array_equal(ids_dev.numpy(), got.topk_ids)


def test_crack_dedupes_and_keeps_version():
    _, _, got = _build_pair()
    v = got.version
    got.crack(got.rep_ids[:5], _annotate(got.rep_ids[:5]))
    got.crack([], [])
    assert got.version == v


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_save_load_across_packages(tmp_path, direction):
    if direction == "jax_to_torch":
        wl = jax_schema.make_workload("night-street", n_frames=400)
        src_cls, kw = JaxIndex, {}
        dst = lambda p: TastiIndex.load(p, device="cpu")  # noqa: E731
    else:
        wl = pt_schema.make_workload("night-street", n_frames=400)
        src_cls, kw, dst = TastiIndex, {"device": "cpu"}, JaxIndex.load
    idx = src_cls.build(wl.features, 30, wl.target_dnn_batch, k=4, **kw)
    idx.crack([3, 4, 5], wl.target_dnn_batch([3, 4, 5]))
    idx.save(str(tmp_path / "ns"))
    back = dst(str(tmp_path / "ns"))
    for f in ("embeddings", "rep_ids", "topk_d2", "topk_ids"):
        np.testing.assert_array_equal(getattr(back, f), getattr(idx, f))
    assert back.k == idx.k and back.version == idx.version
    assert back.cost.distance_pairs == idx.cost.distance_pairs
    assert [a.count for a in back.annotations] == \
        [a.count for a in idx.annotations]
    np.testing.assert_array_equal(
        back.rep_scores(wl.score_count), idx.rep_scores(wl.score_count))


def test_host_propagation_matches_reference():
    rng = np.random.default_rng(2)
    scores = rng.integers(0, 4, size=30).astype(np.float64)
    ids = rng.integers(0, 30, size=(200, 6))
    d2 = np.sort(rng.uniform(0, 5, size=(200, 6)), axis=1)
    d2[:50, -2:] = pt_propagation.PAD_DIST
    for fn, kw in [("propagate_numeric", {}), ("propagate_top1", {}),
                   ("propagate_categorical", {"n_classes": 4})]:
        np.testing.assert_array_equal(
            getattr(pt_propagation, fn)(scores, ids, d2, **kw),
            getattr(jax_propagation, fn)(scores, ids, d2, **kw))


def test_embedder_from_jax_params_matches():
    cfg = jax_embedder.EmbedderConfig()
    params = jax_embedder.init_embedder(cfg, jax.random.PRNGKey(3))
    feats = np.random.default_rng(0).normal(size=(700, 64)).astype(np.float32)
    want = jax_embedder.embed_all(params, feats, cfg, batch=256)
    model = pt_embedder.Embedder(pt_embedder.EmbedderConfig())
    model.load_state_dict(pt_embedder.params_from_jax(
        {k: np.asarray(v) for k, v in params.items()}))
    got = pt_embedder.embed_all(model, feats, batch=256)
    assert got.shape == (700, 128) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_embedder_seeded_init_and_transformer_waits():
    cfg = pt_embedder.EmbedderConfig()
    a = pt_embedder.Embedder(cfg, generator=torch.Generator().manual_seed(1))
    b = pt_embedder.Embedder(cfg, generator=torch.Generator().manual_seed(1))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert float(a.layers[0].weight.detach().std()) == pytest.approx(1 / 8, rel=0.1)
    with pytest.raises(NotImplementedError, match="flash_attention"):
        pt_embedder.Embedder(pt_embedder.EmbedderConfig(
            backbone="tasti-embedder"))
