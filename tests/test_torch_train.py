"""The port's TASTI training slice against the JAX package on the CPU:
AdamW and its schedule, the triplet loss, triplet mining, embedder
training (MLP and the transformer backbone), pre-training, the per-query
proxy, ``build_tasti(variant="T")`` end to end, and both packages'
``build_index`` and query CLIs against each other.

Initial weights are drawn by the JAX package and carried across
(``params_from_jax``, ``decoder_from_jax``, ``proxy_from_jax``); batches
come from the same numpy generators.  Tolerances: AdamW and the schedule
1e-6 (the same float32 arithmetic); one training step 1e-5 on the weights;
N steps 1e-4 on weights and losses (float32 sums in another order, carried
through N Adam steps); mining and the data-dependent ids exactly."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import baselines as jax_baselines  # noqa: E402
from repro.core import embedder as jax_embedder  # noqa: E402
from repro.core import pipeline as jax_pipeline  # noqa: E402
from repro.core import schema as jax_schema  # noqa: E402
from repro.core import triplet as jax_triplet  # noqa: E402
from repro.launch import build_index as jax_build_cli  # noqa: E402
from repro.launch import query as jax_query_cli  # noqa: E402
from repro.models.common import ParamSpec as JaxSpec  # noqa: E402
from repro.models.common import init_params as jax_init_params  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch.core import baselines, pipeline, schema, triplet  # noqa: E402
from repro_torch.core.embedder import (Embedder, EmbedderConfig,  # noqa: E402
                                       params_from_jax)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.launch import build_index as pt_build_cli  # noqa: E402
from repro_torch.launch import query as pt_query_cli  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

pytestmark = pytest.mark.tier1

STEP_TOL = {"rtol": 1e-5, "atol": 1e-6}
RUN_TOL = {"rtol": 1e-4, "atol": 1e-5}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _state_np(model: Embedder):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


#: the MLP embedder's last bias: the triplet loss sees differences of
#: embeddings only, so its gradient is zero, float32 noise (~1e-9) that
#: Adam's normalised step turns into a move of up to lr a step, in either
#: package; it moves no distance
SHIFT = "layers.2.bias"


def _assert_weights_close(got, want, tol, noise_bound=None):
    """Every leaf of two state dicts within ``tol``; with ``noise_bound``,
    :data:`SHIFT` only within that of each other."""
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if noise_bound is not None and k == SHIFT:
            assert np.abs(g - w).max() <= noise_bound, k
            continue
        np.testing.assert_allclose(g, w, **tol, err_msg=k)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_and_schedule_match_reference(state_dtype, monkeypatch):
    """Five steps on the same gradients: parameters (float32 and bf16
    leaves), moments, lr and grad norm.  A chunk smaller than a leaf runs
    the chunked update across leaf boundaries."""
    monkeypatch.setattr(adamw, "CHUNK", 7)
    opt_kw = dict(peak_lr=0.05, min_lr=0.005, warmup_steps=2, total_steps=6,
                  weight_decay=0.1, clip_norm=1.0, state_dtype=state_dtype)
    rng = np.random.default_rng(0)
    shapes = {"w": (4, 5), "b": (5,), "h": (3, 2, 4)}
    init = {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}
    pj = {"w": jnp.asarray(init["w"]), "b": jnp.asarray(init["b"]),
          "h": jnp.asarray(init["h"]).astype(jnp.bfloat16)}
    pt = {"w": torch.from_numpy(init["w"].copy()),
          "b": torch.from_numpy(init["b"].copy()),
          "h": torch.from_numpy(init["h"]).bfloat16()}
    opt_j = jax_adamw.OptimizerConfig(**opt_kw)
    opt_t = adamw.OptimizerConfig(**opt_kw)
    sj, st = jax_adamw.init_opt_state(pj, opt_j), adamw.init_opt_state(pt, opt_t)
    assert st["mu"]["h"].dtype == getattr(torch, state_dtype)
    for _ in range(5):
        g = {k: rng.normal(scale=2.0, size=s).astype(np.float32)
             for k, s in shapes.items()}
        gj = {k: jnp.asarray(v).astype(pj[k].dtype) for k, v in g.items()}
        gt = {k: torch.from_numpy(v).to(pt[k].dtype) for k, v in g.items()}
        pj, sj, mj = jax_adamw.adamw_update(pj, gj, sj, opt_j)
        pt, st, mt = adamw.adamw_update(pt, gt, st, opt_t)
        for k in shapes:
            for a, b in ((pt[k], pj[k]), (st["mu"][k], sj["mu"][k]),
                         (st["nu"][k], sj["nu"][k])):
                np.testing.assert_allclose(a.float().numpy(),
                                           np.asarray(b, np.float32),
                                           rtol=1e-6, atol=1e-7)
        assert float(mt["lr"]) == pytest.approx(float(mj["lr"]), rel=1e-6)
        assert float(mt["grad_norm"]) == pytest.approx(
            float(mj["grad_norm"]), rel=1e-6)
    assert int(st["step"]) == int(sj["step"]) == 5
    for step in range(0, 12):
        assert float(adamw.schedule(opt_t, step)) == pytest.approx(
            float(jax_adamw.schedule(opt_j, jnp.int32(step))), rel=1e-6,
            abs=1e-9)


def test_adamw_takes_a_module_parameter_list():
    """A module's ``parameters()`` list is a tree of its own: moments of the
    same shapes, an in-place update, the loss falls."""
    lin = torch.nn.Linear(3, 2)
    params = list(lin.parameters())
    opt = adamw.OptimizerConfig(peak_lr=0.1, min_lr=0.01, warmup_steps=0,
                                total_steps=50, weight_decay=0.0)
    x = torch.randn(16, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        before = float((lin(x) ** 2).mean())
    losses = adamw.minimize(params, lambda: (lin(x) ** 2).mean(),
                            [()] * 30, opt)
    assert len(losses) == 30 and losses[0] == pytest.approx(before)
    with torch.no_grad():
        assert float((lin(x) ** 2).mean()) < 0.1 * before


# ---------------------------------------------------------------------------
# triplet loss and mining
# ---------------------------------------------------------------------------

def test_triplet_loss_and_gradient_match_reference():
    rng = np.random.default_rng(1)
    a, p, n = (rng.normal(size=(32, 16)).astype(np.float32) for _ in range(3))
    want, gj = jax.value_and_grad(
        lambda a, p, n: jax_triplet.triplet_loss(a, p, n, 1.0),
        argnums=(0, 1, 2))(jnp.asarray(a), jnp.asarray(p), jnp.asarray(n))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (a, p, n)]
    got = triplet.triplet_loss(*ts, 1.0)
    gt = torch.autograd.grad(got, ts)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    for x, y in zip(gt, gj):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5,
                                   atol=1e-7)


def test_triplet_loss_at_a_zero_distance():
    """Anchor and positive at one point (duplicate records): the JAX
    package's gradient is NaN, the port's finite, and one AdamW step keeps
    the port's weights finite while the reference's turn NaN."""
    a = np.ones((2, 4), np.float32)
    n = np.zeros((2, 4), np.float32)
    _, gj = jax.value_and_grad(
        lambda a: jax_triplet.triplet_loss(a, a * 1.0, jnp.asarray(n), 3.0))(
        jnp.asarray(a))
    assert np.isnan(np.asarray(gj)).all()
    ta = torch.from_numpy(a).requires_grad_(True)
    loss = triplet.triplet_loss(ta, ta * 1.0, torch.from_numpy(n), 3.0)
    (gt,) = torch.autograd.grad(loss, [ta])
    assert torch.isfinite(gt).all()
    # only the anchor-negative term moves it: d|a - n|/da = -(a - n)/|a - n|
    np.testing.assert_allclose(gt.numpy(), -np.full((2, 4), 0.25),
                               rtol=1e-6)
    opt_kw = dict(peak_lr=0.1, warmup_steps=0, total_steps=10)
    pj, _, _ = jax_adamw.adamw_update(
        {"w": jnp.asarray(a)}, {"w": gj}, jax_adamw.init_opt_state(
            {"w": jnp.asarray(a)}, jax_adamw.OptimizerConfig(**opt_kw)),
        jax_adamw.OptimizerConfig(**opt_kw))
    assert np.isnan(np.asarray(pj["w"])).all()
    pt = {"w": torch.from_numpy(a.copy())}
    adamw.adamw_update(pt, {"w": gt}, adamw.init_opt_state(
        pt, adamw.OptimizerConfig(**opt_kw)), adamw.OptimizerConfig(**opt_kw))
    assert torch.isfinite(pt["w"]).all()


@pytest.mark.parametrize("name,n_ids,seed", [("night-street", 150, 1),
                                              ("taipei", 120, 2),
                                              ("wikisql", 120, 3)])
def test_mine_triplets_identical(name, n_ids, seed):
    jwl = jax_schema.make_workload(name, n_records=600)
    pwl = schema.make_workload(name, n_records=600)
    ids = np.random.default_rng(seed).choice(600, size=n_ids, replace=False)
    want = jax_triplet.mine_triplets(ids, jwl.is_close,
                                     np.random.default_rng(seed + 1),
                                     max_triplets=2000)
    got = triplet.mine_triplets(ids, pwl.is_close,
                                np.random.default_rng(seed + 1),
                                max_triplets=2000)
    assert got.dtype == want.dtype == np.int32 and len(got) > 0
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# embedder training, pre-training, the per-query proxy
# ---------------------------------------------------------------------------

def _training_set(n=80, seed=0):
    wl = jax_schema.make_workload("night-street", n_frames=400)
    ids = np.random.default_rng(seed).choice(400, size=n, replace=False)
    triples = jax_triplet.mine_triplets(ids, wl.is_close,
                                        np.random.default_rng(seed + 1))
    return wl.features[ids], triples


@pytest.mark.parametrize("backbone,steps,batch", [
    ("mlp", 1, 64), ("mlp", 30, 64), ("tasti-embedder", 1, 16),
    ("tasti-embedder", 8, 16)])
def test_train_embedder_matches_reference(backbone, steps, batch):
    feats, triples = _training_set()
    jcfg = jax_embedder.EmbedderConfig(feature_dim=64, embed_dim=32,
                                       backbone=backbone)
    tcfg_kw = dict(steps=steps, batch=batch, lr=1e-3, seed=3)
    pj = jax_embedder.init_embedder(jcfg, jax.random.PRNGKey(0))
    want_p, want_h = jax_triplet.train_embedder(
        pj, feats, triples, jcfg, jax_triplet.TripletConfig(**tcfg_kw))
    model = Embedder(EmbedderConfig(feature_dim=64, embed_dim=32,
                                    backbone=backbone))
    model.load_state_dict(params_from_jax(_np(pj)))
    _, got_h = triplet.train_embedder(model, feats, triples,
                                      triplet.TripletConfig(**tcfg_kw))
    tol = STEP_TOL if steps == 1 else RUN_TOL
    if backbone != "mlp" and steps == 1:
        # a few of 262,144 attention weights have gradients near Adam's eps,
        # where the transformer's float32 noise (its forward agrees to 1e-4,
        # tests/test_torch_models.py) moves the normalised step: allow a
        # fifth of the first step's size, lr / 20 (warm-up) = 5e-5
        tol = {"rtol": 1e-5, "atol": 1e-5}
    np.testing.assert_allclose(got_h, want_h, **tol)
    _assert_weights_close(
        {k: v.numpy() for k, v in model.state_dict().items()},
        {k: v.numpy() for k, v in params_from_jax(_np(want_p)).items()},
        tol, noise_bound=2 * steps * tcfg_kw["lr"])


@pytest.mark.parametrize("backbone,steps", [("mlp", 1), ("mlp", 25),
                                            ("tasti-embedder", 3)])
def test_pretrain_embedder_matches_reference(backbone, steps):
    feats = np.random.default_rng(2).normal(size=(300, 64)).astype(np.float32)
    jcfg = jax_embedder.EmbedderConfig(feature_dim=64, embed_dim=32,
                                       backbone=backbone)
    want = jax_baselines.pretrain_embedder(feats, jcfg, steps=steps, seed=4)
    enc = jax_embedder.init_embedder(jcfg, jax.random.PRNGKey(4))
    dec = jax_init_params({"wd": JaxSpec((32, 64), ("embed", "mlp"),
                                         jnp.float32)}, jax.random.PRNGKey(5))
    model = baselines.pretrain_embedder(
        feats, EmbedderConfig(feature_dim=64, embed_dim=32,
                              backbone=backbone), steps=steps, seed=4,
        device="cpu", encoder_init=params_from_jax(_np(enc)),
        decoder_init=baselines.decoder_from_jax(_np(dec)))
    tol = STEP_TOL if steps == 1 else RUN_TOL
    want = params_from_jax(_np(want))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), **tol,
                                   err_msg=k)


@pytest.mark.parametrize("classify", [False, True])
def test_train_query_proxy_matches_reference(classify):
    wl = jax_schema.make_workload("night-street", n_frames=500)
    ids = np.random.default_rng(5).choice(500, size=120, replace=False)
    targets = np.asarray([float(wl.scenes[i].count > 0 if classify
                                else wl.scenes[i].count) for i in ids])
    jcfg = jax_baselines.ProxyConfig(steps=40, classify=classify, seed=6)
    want = jax_baselines.train_query_proxy(wl.features, ids, targets, jcfg)
    init = jax_init_params(jax_baselines._proxy_specs(jcfg),
                           jax.random.PRNGKey(6))
    got = baselines.train_query_proxy(
        wl.features, ids, targets,
        baselines.ProxyConfig(steps=40, classify=classify, seed=6),
        device="cpu", init=baselines.proxy_from_jax(_np(init)))
    assert got.shape == want.shape == (500,)
    np.testing.assert_allclose(got, want, **RUN_TOL)


def test_training_takes_the_plain_attention_route(monkeypatch):
    """Every training entry point asks for plain attention: with the
    kernel route made to raise, the transformer embedder still trains and
    pre-trains."""
    def refuse(*a, **k):
        raise AssertionError("a training step reached the kernel route")

    monkeypatch.setattr(flash_ops, "flash_attention", refuse)
    feats, triples = _training_set(n=40)
    cfg = EmbedderConfig(feature_dim=64, embed_dim=32,
                         backbone="tasti-embedder")
    model = Embedder(cfg, generator=torch.Generator().manual_seed(0))
    before = _state_np(model)
    _, hist = triplet.train_embedder(model, feats, triples,
                                     triplet.TripletConfig(steps=1, batch=8))
    assert len(hist) == 1 and np.isfinite(hist[0])
    assert any(not np.array_equal(v, before[k])
               for k, v in _state_np(model).items())
    baselines.pretrain_embedder(feats, cfg, steps=1, device="cpu")
    with pytest.raises(AssertionError, match="kernel route"):
        with torch.no_grad():
            model(torch.from_numpy(feats[:4]))


def test_kernel_guard_refuses_inputs_that_require_grad():
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward.*plain route"):
        _build.refuse_grad("flash_attention", torch.zeros(3), x)
    with torch.no_grad():
        _build.refuse_grad("flash_attention", x)
    _build.refuse_grad("flash_attention", x.detach(), None)


# ---------------------------------------------------------------------------
# build_tasti(variant="T") and the CLIs
# ---------------------------------------------------------------------------

N = 1500
BUILD = dict(n_train=90, n_reps=120, k=4, pretrain_steps=12, seed=0)
TRIPLET = dict(steps=10, batch=64)


def _jax_pretrain_init(ecfg, seed):
    enc = jax_embedder.init_embedder(ecfg, jax.random.PRNGKey(seed))
    dec = jax_init_params({"wd": JaxSpec((ecfg.embed_dim, ecfg.feature_dim),
                                         ("embed", "mlp"), jnp.float32)},
                          jax.random.PRNGKey(seed + 1))
    return params_from_jax(_np(enc)), baselines.decoder_from_jax(_np(dec))


@pytest.mark.parametrize("pretrained", [False, True])
def test_build_tasti_T_matches_reference(pretrained, monkeypatch):
    """The whole TASTI-T build from the same initial weights (given, or
    drawn by the JAX package for pre-training): the same training ids and
    triples, trained weights within tolerance, the same IndexCost, the same
    reps and top-k ids."""
    jwl = jax_schema.make_workload("night-street", n_frames=N)
    pwl = schema.make_workload("night-street", n_frames=N)
    jcfg = jax_pipeline.TastiConfig(
        **BUILD, triplet=jax_triplet.TripletConfig(**TRIPLET))
    pcfg = pipeline.TastiConfig(**BUILD,
                                triplet=triplet.TripletConfig(**TRIPLET))
    ecfg = jax_embedder.EmbedderConfig(feature_dim=64, embed_dim=128)
    kw_j, kw_t = {}, {}
    if not pretrained:
        pj = jax_embedder.init_embedder(ecfg, jax.random.PRNGKey(9))
        kw_j["embed_params"] = pj
        kw_t["embed_params"] = params_from_jax(_np(pj))
    else:
        enc, dec = _jax_pretrain_init(ecfg, BUILD["seed"])
        real = baselines.pretrain_embedder
        monkeypatch.setattr(pipeline, "pretrain_embedder",
                            lambda *a, **k: real(*a, **k, encoder_init=enc,
                                                 decoder_init=dec))
    mined = {}

    def spy(module, key):
        real = module.mine_triplets

        def mine(ids, *a, **k):
            mined[key] = (ids, real(ids, *a, **k))
            return mined[key][1]

        monkeypatch.setattr(module, "mine_triplets", mine)

    spy(jax_pipeline, "jax")
    spy(pipeline, "torch")
    js = jax_pipeline.build_tasti(jwl, jcfg, variant="T", **kw_j)
    ps = pipeline.build_tasti(pwl, pcfg, variant="T", device="cpu", **kw_t)
    ids, triples = mined["torch"]
    np.testing.assert_array_equal(ids, mined["jax"][0])
    np.testing.assert_array_equal(triples, mined["jax"][1])
    assert ps.build_stats["n_triples"] == len(triples) > 0
    assert len(ps.build_stats["triplet_losses"]) == TRIPLET["steps"]
    _assert_weights_close(
        {k: v.numpy() for k, v in ps.embed_params.items()},
        {k: v.numpy() for k, v in params_from_jax(_np(js.embed_params)).items()},
        RUN_TOL, noise_bound=2 * TRIPLET["steps"] * 1e-3)
    assert vars(ps.index.cost) == vars(js.index.cost)
    assert ps.index.cost.training_steps == TRIPLET["steps"]
    assert ps.index.cost.embed_records == 2 * N
    np.testing.assert_array_equal(ps.index.rep_ids, js.index.rep_ids)
    np.testing.assert_array_equal(ps.index.topk_ids, js.index.topk_ids)
    np.testing.assert_allclose(ps.index.topk_d2, js.index.topk_d2,
                               rtol=1e-3, atol=1e-3)


SPECS = [{"kind": "aggregation", "score": "score_count", "err": 0.1},
         {"kind": "selection", "score": "score_has_object", "budget": 150},
         {"kind": "limit", "score": "score_rare", "k_results": 3}]


def _cli_doc(main, argv, capsys):
    main(argv)
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("built_by", ["jax", "torch"])
def test_build_index_cli_queried_by_both_query_clis(built_by, tmp_path,
                                                    capsys):
    """An index saved by either package's build_index answers both query
    CLIs alike."""
    stem = str(tmp_path / "ns")
    argv = ["--workload", "night-street", "--n-frames", "1200", "--n-train",
            "60", "--n-reps", "90", "--k", "4", "--triplet-steps", "5",
            "--out", stem]
    if built_by == "jax":
        built = _cli_doc(_jax_build_main, argv, capsys)
    else:
        built = _cli_doc(pt_build_cli.main, argv + ["--device", "cpu"],
                         capsys)
    assert built["variant"] == "T" and built["reps"] == 90
    assert built["target_dnn_invocations"] == 60 + 90
    qargv = ["--workload", "night-street", "--n-frames", "1200", "--index",
             stem] + sum((["--spec", json.dumps(d)] for d in SPECS), [])
    want = _cli_doc(jax_query_cli.main, qargv, capsys)
    got = _cli_doc(pt_query_cli.main, qargv + ["--device", "cpu"], capsys)
    assert got == want
    assert got["results"][0]["estimate"] is not None


def _jax_build_main(argv):
    import sys
    old = sys.argv
    sys.argv = ["build_index"] + list(argv)
    try:
        jax_build_cli.main()
    finally:
        sys.argv = old


def test_query_cli_builds_in_process_with_quick(capsys):
    doc = _cli_doc(pt_query_cli.main,
                   ["--workload", "night-street", "--n-frames", "1000",
                    "--quick", "--crack", "--device", "cpu"]
                   + sum((["--spec", json.dumps(d)] for d in SPECS), []),
                   capsys)
    assert doc["records"] == 1000 and doc["reps"] >= 200   # + cracked
    agg = doc["results"][0]
    assert np.isfinite(agg["estimate"]) and agg["n_invocations"] > 0
    assert doc["results"][1]["n_selected"] > 0


# ---------------------------------------------------------------------------
# population_triplet_loss (the theory validators' estimate of Eq. 1)
# ---------------------------------------------------------------------------

def _coords_and_dist(seed=0, n=80):
    coords = np.random.default_rng(seed).uniform(0, 10, size=(n, 2))
    return coords, lambda i, j: float(np.linalg.norm(coords[i] - coords[j]))


@pytest.mark.parametrize("emb_kind,seed", [("scaled", 0), ("random", 0),
                                           ("random", 3)])
def test_population_triplet_loss_matches_jax(emb_kind, seed):
    """The same numpy inputs and seed draw the same triples: the estimate
    equals the JAX function's (rtol 1e-6; both sum float64 hinges)."""
    coords, dist_fn = _coords_and_dist(seed)
    emb = (coords * 10.0 if emb_kind == "scaled"
           else np.random.default_rng(seed).normal(size=(80, 8)))
    ids = np.arange(80)
    for n_samples, sample_seed in ((400, 0), (150, 5)):
        got = triplet.population_triplet_loss(
            emb, dist_fn, ids, m_radius=1.0, margin=1.0,
            n_samples=n_samples, seed=sample_seed)
        want = jax_triplet.population_triplet_loss(
            emb, dist_fn, ids, m_radius=1.0, margin=1.0,
            n_samples=n_samples, seed=sample_seed)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if emb_kind == "random":
        assert got > 0.2


def test_population_triplet_loss_zero_for_a_perfect_embedding():
    """Clusters of radius < 0.5 set 5 apart: close means the same cluster,
    and an embedding scaled by 10 separates clusters by more than the
    margin, so every sampled hinge is 0; the reference's own check (80
    uniform points, coords * 10) stays below 0.05."""
    rng = np.random.default_rng(0)
    centers = np.asarray([[0.0, 0.0], [5.0, 0.0], [0.0, 5.0], [5.0, 5.0]])
    coords = (centers[rng.integers(0, 4, size=60)]
              + rng.uniform(-0.2, 0.2, size=(60, 2)))
    dist_fn = lambda i, j: float(np.linalg.norm(  # noqa: E731
        coords[i] - coords[j]))
    ids = np.arange(60)
    assert triplet.population_triplet_loss(
        coords * 10.0, dist_fn, ids, m_radius=1.0, margin=1.0,
        n_samples=300) == 0.0
    coords, dist_fn = _coords_and_dist(0)
    assert triplet.population_triplet_loss(
        coords * 10.0, dist_fn, np.arange(80), m_radius=1.0, margin=1.0,
        n_samples=400) < 0.05
