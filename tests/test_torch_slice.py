"""The PyTorch port's serving slice against the JAX package on the CPU:
engine and session rows, oracle accounting, resident (kernel-path)
proxies, the whole build-then-query slice through both query CLIs, the
port's import hygiene (no jax, nothing of repro) and its device policy."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import embedder as jax_embedder  # noqa: E402
from repro.core import schema as jax_schema  # noqa: E402
from repro.core.codec import result_row as jax_row  # noqa: E402
from repro.core.engine import QueryEngine as JaxEngine  # noqa: E402
from repro.core.engine import QuerySpec as JaxSpec  # noqa: E402
from repro.core.index import TastiIndex as JaxIndex  # noqa: E402
from repro.core.pipeline import TastiConfig as JaxConfig  # noqa: E402
from repro.core.pipeline import build_tasti as jax_build  # noqa: E402
from repro.core.session import QuerySession as JaxSession  # noqa: E402
from repro.launch import query as jax_cli  # noqa: E402
from repro_torch import device as device_mod  # noqa: E402
from repro_torch.core import propagation as pt_propagation  # noqa: E402
from repro_torch.core import schema as pt_schema  # noqa: E402
from repro_torch.core.codec import result_row  # noqa: E402
from repro_torch.core.embedder import params_from_jax  # noqa: E402
from repro_torch.core.engine import QueryEngine, QuerySpec  # noqa: E402
from repro_torch.core.fpf import fpf_select  # noqa: E402
from repro_torch.core.index import TastiIndex  # noqa: E402
from repro_torch.core.pipeline import TastiConfig, build_tasti  # noqa: E402
from repro_torch.core.session import QuerySession  # noqa: E402
from repro_torch.core.baselines import (pretrain_embedder,  # noqa: E402
                                        train_query_proxy)
from repro_torch.core.embedder import EmbedderConfig  # noqa: E402
from repro_torch.launch import query as pt_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402

pytestmark = pytest.mark.tier1

N = 1200
SPECS = [
    {"kind": "aggregation", "score": "score_count", "err": 0.1},
    {"kind": "selection", "score": "score_has_object", "budget": 150},
    {"kind": "limit", "score": "score_rare", "k_results": 3},
    {"kind": "aggregation", "score": "score_count", "err": 0.2,
     "propagation": "categorical", "n_classes": 9},
]


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A JAX-built index over night-street, saved, plus both workloads."""
    jwl = jax_schema.make_workload("night-street", n_frames=N)
    idx = JaxIndex.build(jwl.features, 80, jwl.target_dnn_batch, k=4, seed=0)
    stem = str(tmp_path_factory.mktemp("idx") / "ns")
    idx.save(stem)
    return stem, jwl, pt_schema.make_workload("night-street", n_frames=N)


def _engines(saved, resident=False, crack=False):
    stem, jwl, pwl = saved
    je = JaxEngine(JaxIndex.load(stem), jwl, resident=False, crack=crack)
    pe = QueryEngine(TastiIndex.load(stem, device="cpu"), pwl,
                     resident=resident, crack=crack)
    return je, pe


def test_engine_rows_identical_host_path(saved):
    je, pe = _engines(saved)
    for d in SPECS:
        assert result_row(pe.execute(QuerySpec.from_dict(d))) == \
            jax_row(je.execute(JaxSpec.from_dict(d)))
    assert pe.stats == je.stats
    assert pe.broker.stats == je.broker.stats


def test_session_rows_and_accounts_identical(saved):
    je, pe = _engines(saved)
    for _ in range(2):                    # second pass: cached labels
        jr = JaxSession(je, [JaxSpec.from_dict(d) for d in SPECS]).execute()
        pr = QuerySession(pe, [QuerySpec.from_dict(d) for d in SPECS]).execute()
        assert [result_row(r) for r in pr.results] == \
            [jax_row(r) for r in jr.results]
        assert pr.stats == jr.stats
        assert [(r.n_oracle_fresh, r.n_oracle_cached) for r in pr.results] \
            == [(r.n_oracle_fresh, r.n_oracle_cached) for r in jr.results]


@pytest.mark.parametrize("mode,kw", [("numeric", {}), ("top1", {}),
                                     ("categorical", {"n_classes": 9})])
def test_resident_proxies_match_host(saved, mode, kw):
    je, pe = _engines(saved, resident=True)
    for score in ("score_count", "score_has_object"):
        got = pe.proxy_scores(score, mode=mode, **kw)
        want = je.proxy_scores(score, mode=mode, **kw)
        assert got.dtype == np.float64
        if mode == "categorical":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert pe.stats["proxy_device_computes"] == 2
    assert pe.resident.stats["uploads"] == 1


def test_crack_feedback_matches_reference(saved):
    """The same cracked ids give the same reps and (to float32 rounding)
    the same distances; the resident path re-propagates after the crack."""
    je, pe = _engines(saved, resident=True)
    ids = np.arange(0, N, 37)
    assert pe.crack_with(ids) == je.crack_with(ids)
    assert pe.index.version == je.index.version == 1
    np.testing.assert_array_equal(pe.index.rep_ids, je.index.rep_ids)
    np.testing.assert_allclose(pe.index.topk_d2, je.index.topk_d2,
                               rtol=1e-4, atol=1e-4)
    # records cracked in sit at d2 ~ 0, where float32 rounding of the
    # distance moves the weight; hold the device path to the host path
    # over the port's own cracked structures
    idx = pe.index
    want = pt_propagation.propagate_numeric(
        idx.rep_scores(pe.workload.score_count), idx.topk_ids, idx.topk_d2)
    np.testing.assert_allclose(pe.proxy_scores("score_count"), want,
                               rtol=1e-5, atol=1e-6)
    assert pe.stats["proxy_device_computes"] == 1
    assert pe.stats["cracked_records"] == je.stats["cracked_records"]


def _cli_doc(main, argv, capsys):
    main(argv)
    return json.loads(capsys.readouterr().out)


def test_whole_slice_build_then_query_cli(tmp_path, capsys, monkeypatch):
    """build_tasti PT from carried-across embedder weights picks the same
    reps; both query CLIs over the JAX-saved index print the same JSON."""
    monkeypatch.delenv("REPRO_RESIDENT_SCORING", raising=False)
    jwl = jax_schema.make_workload("night-street", n_frames=N)
    pwl = pt_schema.make_workload("night-street", n_frames=N)
    ecfg = jax_embedder.EmbedderConfig(feature_dim=64, embed_dim=128)
    params = jax_embedder.init_embedder(ecfg, jax.random.PRNGKey(0))
    js = jax_build(jwl, JaxConfig(n_reps=90, k=4), variant="PT",
                   embed_params=params)
    ps = build_tasti(pwl, TastiConfig(n_reps=90, k=4), variant="PT",
                     embed_params=params_from_jax(
                         {k: np.asarray(v) for k, v in params.items()}),
                     device="cpu")
    np.testing.assert_array_equal(ps.index.rep_ids, js.index.rep_ids)
    np.testing.assert_allclose(ps.index.embeddings, js.index.embeddings,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ps.index.topk_d2, js.index.topk_d2,
                               rtol=1e-4, atol=1e-4)
    assert vars(ps.index.cost) == vars(js.index.cost)
    stem = str(tmp_path / "pt")
    js.index.save(stem)
    argv = ["--workload", "night-street", "--n-frames", str(N),
            "--index", stem] + sum((["--spec", json.dumps(d)]
                                    for d in SPECS[:3]), [])
    want = _cli_doc(jax_cli.main, argv, capsys)
    got = _cli_doc(pt_cli.main, argv + ["--device", "cpu"], capsys)
    assert got == want
    # without --index the port builds in-process (pre-training, PT)
    doc = _cli_doc(pt_cli.main, argv[:4] + [
        "--variant", "PT", "--n-reps", "90", "--k", "4", "--device", "cpu",
        "--spec", json.dumps(SPECS[0])], capsys)
    assert doc["records"] == N and doc["reps"] == 90
    assert doc["results"][0]["estimate"] is not None


_NO_JAX = """
import sys
import numpy as np
from repro_torch.core.schema import make_workload
from repro_torch.core.embedder import Embedder, EmbedderConfig
from repro_torch.core.pipeline import TastiConfig, build_tasti
from repro_torch.core.engine import QuerySpec
import repro_torch.launch.query
import torch
wl = make_workload("night-street", n_frames=300)
params = Embedder(EmbedderConfig(),
                  generator=torch.Generator().manual_seed(0)).state_dict()
s = build_tasti(wl, TastiConfig(n_reps=30, k=4), variant="PT",
                embed_params=params, device="cpu")
res = s.execute_session([QuerySpec(kind="aggregation", score="score_count")])
assert res.results[0].estimate is not None
# the LM path: prefill forward through ops.flash_attention, replay decode,
# serve_lm, and the transformer embedder inside build_tasti
from repro_torch.configs import get_config
from repro_torch.launch import serve_lm
from repro_torch.models import lm
from repro_torch.train.steps import make_prefill_step
cfg = get_config("h2o-danube-3-4b").smoke()
p = lm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
toks = torch.randint(0, cfg.vocab_size, (1, 80))
assert make_prefill_step(cfg)(p, {"tokens": toks}).shape == (1, 80, 512)
out = serve_lm.serve(p, cfg, toks[:, :6], decode_steps=3)
assert out["generated"].shape == (1, 3)
serve_lm.main(["--arch", "llama3.2-1b", "--batch", "2", "--prompt-len", "4",
               "--decode-steps", "2", "--device", "cpu"])
tcfg = EmbedderConfig(backbone="tasti-embedder")
s = build_tasti(wl, TastiConfig(n_reps=30, k=4), variant="PT",
                embed_params=Embedder(tcfg).state_dict(), device="cpu",
                embedder=tcfg)
assert s.index.embeddings.shape == (300, 128)
# the training slice: TASTI-T with pre-training, the LM train step and
# its fault-tolerant launcher with checkpoints and the data pipeline
import tempfile
import repro_torch.launch.build_index
from repro_torch.core.baselines import train_query_proxy
from repro_torch.core.triplet import TripletConfig
from repro_torch.launch import train
s = build_tasti(wl, TastiConfig(n_train=40, n_reps=30, k=4, pretrain_steps=3,
                                triplet=TripletConfig(steps=3, batch=16)),
                variant="T", device="cpu")
assert s.build_stats["n_triples"] > 0
assert train_query_proxy(wl.features, np.arange(50), wl.counts[:50],
                         device="cpu").shape == (300,)
with tempfile.TemporaryDirectory() as d:
    train.main(["--preset", "ci", "--steps", "6", "--ckpt-every", "3",
                "--inject-failure-at", "4", "--ckpt-dir", d,
                "--device", "cpu"])
# the serving slice: label store, HTTP server and client, the load
# generator, the serving CLI's module, one request and a short open loop
import repro_torch.launch.serve_queries
from repro_torch.core.engine import QueryEngine
from repro_torch.core.triplet import population_triplet_loss
from repro_torch.loadgen import (ArrivalProcess, OpenLoopGenerator,
                                 SpecClass, SpecMix)
from repro_torch.serve import LabelStore, QueryClient, QueryServer
with tempfile.TemporaryDirectory() as d:
    store = LabelStore.for_index(d + "/s", s.index)
    eng = QueryEngine(s.index, wl)
    store.attach(eng.broker, eng)
    srv = QueryServer(eng, port=0, admission_window=0.0, store=store).start()
    c = QueryClient(srv.url)
    spec = {"kind": "aggregation", "score": "score_count"}
    assert c.query([spec])["request"]["fresh"] > 0
    report = OpenLoopGenerator(
        lambda specs, **kw: c.query(specs),
        SpecMix([SpecClass("agg", [spec])]), ArrivalProcess(rate=20.0),
        0.3).run()
    assert report.completed == report.offered and report.errors == 0
    srv.shutdown()
assert population_triplet_loss(np.eye(3), lambda i, j: float(i != j),
                               np.arange(3), 0.5, 1.0, n_samples=5) >= 0
# the MoE, Mamba and xLSTM models: prefill, replay decode, a train step
from repro_torch.models import mamba, moe, xlstm
from repro_torch.optim.adamw import OptimizerConfig, init_opt_state
from repro_torch.train.steps import make_train_step
for arch in ("olmoe-1b-7b", "xlstm-350m", "jamba-1.5-large-398b"):
    cfg = get_config(arch).smoke()
    p = lm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert make_prefill_step(cfg)(p, {"tokens": toks[:, :32]}).shape == \
        (1, 32, cfg.padded_vocab)
    assert serve_lm.serve(p, cfg, toks[:, :4], decode_steps=2)[
        "generated"].shape == (1, 2)
opt = OptimizerConfig(peak_lr=1e-3, warmup_steps=1, total_steps=2)
_, _, m = make_train_step(cfg, opt)(p, init_opt_state(p, opt), {
    "tokens": toks[:, :16], "targets": toks[:, 1:17]})
assert float(m["aux_loss"]) > 0
# the vision-language model: M-RoPE and a prefix of patch embeddings
cfg = get_config("qwen2-vl-7b").smoke()
p = lm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
vis = torch.randn(1, cfg.vision_tokens, cfg.d_model)
assert make_prefill_step(cfg)(p, {"tokens": toks[:, :32],
                                  "vision_embeds": vis}).shape == \
    (1, 32, cfg.padded_vocab)
assert serve_lm.serve(p, cfg, toks[:, :20], decode_steps=2)[
    "generated"].shape == (1, 2)
# the encoder-decoder: frame embeddings of another length than the prompt
cfg = get_config("seamless-m4t-large-v2").smoke()
p = lm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
batch = {"tokens": toks[:, :32], "enc_embeds": torch.randn(1, 24, cfg.d_model)}
par = make_prefill_step(cfg)(p, batch)
assert par.shape == (1, 32, cfg.padded_vocab)
with torch.no_grad():
    replay, caches = lm.prefill(p, batch, cfg, 34)
    lg, caches = lm.decode_step(p, caches, toks[:, 32:33], 32, cfg)
assert caches[0]["cross_k"].shape[2] == 24 and lg.shape == (1, 1, 512)
assert float((replay - par).abs().max()) < 2e-2
# the two-tier decode cache, and the analytic cost model of its cell
import dataclasses
from repro_torch.configs import SHAPE_BY_NAME
from repro_torch.launch import analytic
cfg = dataclasses.replace(get_config("phi3-medium-14b").smoke(), decode_ring=4)
p = lm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
caches = lm.init_cache(cfg, 1, 8, device="cpu")
with torch.no_grad():
    lg, caches = lm.decode_step(p, caches, toks[:, :1], 8, cfg)
assert lg.shape == (1, 1, 512) and caches[0]["ring_k"][:, :, 0].any()
assert analytic.cell_cost(cfg, SHAPE_BY_NAME["decode_32k"]).bytes > 0
# the mesh layer: sharding rules, the pipeline, compression, the elastic mesh
import repro_torch.parallel.pipeline
from repro_torch.optim.compression import compress_decompress
from repro_torch.parallel import sharding
from repro_torch.runtime.elastic import choose_mesh_shape
assert choose_mesh_shape(511, preferred_model=16) == (16, 16)
deq, err = compress_decompress(torch.linspace(-1.0, 1.0, 64))
assert deq.dtype == torch.float32 and float(err.abs().max()) <= 1.0 / 254
class _Mesh:  # the shape of the 16x16 production mesh, no devices
    shape, axis_names = {"data": 16, "model": 16}, ("data", "model")
assert sharding.batch_pspec(_Mesh, 256) == ("data", None)
# the dry-run and roofline tooling: one small cell traced on a fake group
import repro_torch.launch.run_all_dryruns
from repro_torch.launch import dryrun, mesh, roofline, specs, wire
assert mesh.PEAK_FLOPS_BF16 == 989.4e12 and wire.wire_bytes("all-reduce", 8, 2) == 8.0
r = dryrun.run_cell("llama3.2-1b", "decode_32k", "host", batch=1,
                    overrides={"n_layers": "1", "d_model": "64",
                               "n_heads": "2", "n_kv_heads": "1",
                               "d_ff": "128", "vocab_size": "256"})
assert r["status"] == "ok" and r["argument_bytes"] > 0, r
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(bad)
"""


def test_port_imports_no_jax_and_nothing_of_repro():
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = {**os.environ, "PYTHONPATH": str(src)}
    out = subprocess.run([sys.executable, "-c", _NO_JAX], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_entry_points_default_to_cuda_and_raise_without_it(saved,
                                                           monkeypatch):
    stem, _, pwl = saved
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = pwl.features[:50]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_mod.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fpf_select(x, 5)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TastiIndex.build(x, 5, pwl.target_dnn_batch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TastiIndex.load(stem)
    params = {k: v for k, v in params_from_jax({
        "w0": np.zeros((64, 8)), "b0": np.zeros(8)}).items()}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_tasti(pwl, variant="PT", embed_params=params)
    # the training branches: TASTI-T, pre-training, the proxy, the LM
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_tasti(pwl, variant="T")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_tasti(pwl, variant="PT")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pretrain_embedder(x, EmbedderConfig(), steps=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_query_proxy(x, np.arange(5), np.ones(5))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--steps", "1"])
    # a serving mount: the spec names no device, so CUDA, and it raises
    from repro_torch.serve import WorkloadRegistry, WorkloadSpec
    registry = WorkloadRegistry()
    registry.declare(WorkloadSpec(name="v", dataset="night-street",
                                  n_records=N, index=stem))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        registry.get("v")
    assert device_mod.resolve_device("cpu").type == "cpu"
