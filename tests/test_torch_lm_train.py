"""The port's LM training slice against the JAX package on the CPU:
``lm_loss`` and its gradients, ``make_train_step`` (with micro-batches,
with and without remat), the token data pipeline, the checkpointer (round
trip, async, garbage collection, atomicity, restores across packages),
the fault-tolerant loop and the ``launch.train`` launcher.

JAX weights are carried across with ``models.lm.params_from_jax``; smoke
configs in float32.  Tolerances: the loss 1e-5 and gradients 1e-4 relative
(float32 sums in another order through a few layers, as the logits in
tests/test_torch_models.py); three train steps 1e-4 on losses, and on the
weights all but the elements Adam's normalised step moves by noise
(``_assert_adam_close``); the data pipeline and float32 checkpoints
exactly."""
import dataclasses
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.data import pipeline as jax_data  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.train.steps import make_train_step as jax_train_step  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline as data  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_leaves_with_names  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime.fault_tolerance import (PreemptionSignal,  # noqa: E402
                                                 StragglerMonitor,
                                                 run_resilient)
from repro_torch.train.steps import make_train_step  # noqa: E402

pytestmark = pytest.mark.tier1


def _model(arch, seed=0, **over):
    cfg_j = jax_config(arch).smoke()
    cfg = get_config(arch).smoke()
    cfg_j, cfg = (dataclasses.replace(c, **over) for c in (cfg_j, cfg))
    pj = jax_lm.init_model(cfg_j, jax.random.PRNGKey(seed))
    return cfg_j, pj, cfg, lm.params_from_jax(jax.tree.map(np.asarray, pj))


def _batch(cfg, b, s, seed):
    """tokens and next-token targets, a few targets masked (-1)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1))
    tgt = toks[:, 1:].copy()
    tgt[0, :3] = -1
    return ({"tokens": jnp.asarray(toks[:, :-1]), "targets": jnp.asarray(tgt)},
            {"tokens": torch.from_numpy(toks[:, :-1]),
             "targets": torch.from_numpy(tgt)})


def _names_jax(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path) for path, _ in flat]


# ---------------------------------------------------------------------------
# loss, gradients, train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "llama3.2-1b",
                                  "qwen3-1.7b", "olmoe-1b-7b",
                                  "qwen2-vl-7b", "seamless-m4t-large-v2"])
def test_lm_loss_and_grads_match_jax(arch):
    """h2o-danube at S = 128 so that its smoke window of 64 bites; llama
    (tied embeddings) and qwen3 (qk-norm) for the other branches; olmoe for
    MoE: its routers' aux loss in the loss and in the metrics, and every
    leaf's gradient, the routers' included; qwen2-vl with vision
    embeddings over its first 16 positions, whose token ids (one id, used
    nowhere else) get an embedding gradient of exactly zero in both
    packages; seamless with 96 encoder frames against 128 tokens, the
    encoder's and the cross-attention's leaves among those held."""
    cfg_j, pj, cfg, pt = _model(arch)
    bj, bt = _batch(cfg, 2, 128, seed=1)
    if cfg.encoder_decoder:
        enc = np.random.default_rng(3).normal(
            size=(2, 96, cfg.d_model)).astype(np.float32)
        bj = dict(bj, enc_embeds=jnp.asarray(enc))
        bt = dict(bt, enc_embeds=torch.from_numpy(enc))
    prefix_id = cfg.vocab_size - 1
    if cfg.vision_tokens:
        vt = cfg.vision_tokens
        toks = np.asarray(bt["tokens"]) % prefix_id
        toks[:, :vt] = prefix_id
        vis = np.random.default_rng(2).normal(
            size=(2, vt, cfg.d_model)).astype(np.float32)
        bj = dict(bj, tokens=jnp.asarray(toks), vision_embeds=jnp.asarray(vis))
        bt = dict(bt, tokens=torch.from_numpy(toks),
                  vision_embeds=torch.from_numpy(vis))
    (want, mj), gj = jax.jit(jax.value_and_grad(
        lambda p: jax_lm.lm_loss(p, bj, cfg_j), has_aux=True))(pj)
    leaves = tree_leaves(pt)
    for p in leaves:
        p.requires_grad_(True)
    got, mt = lm.lm_loss(pt, bt, cfg)
    grads = torch.autograd.grad(got, leaves)
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    aux = float(mt["aux_loss"].detach())
    assert aux == pytest.approx(float(mj["aux_loss"]), rel=1e-5)
    assert (aux > 0) == (arch == "olmoe-1b-7b")
    assert float(mt["tokens"]) == float(mj["tokens"]) == 2 * 128 - 3
    names = [n for n, _ in tree_leaves_with_names(pt)]
    assert names == _names_jax(pj)
    for name, g, w in zip(names, grads, jax.tree.leaves(gj)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    if cfg.encoder_decoder:
        assert any(n.startswith("encoder/") for n in names)
        assert any("/cross_attn/" in n for n in names)
    if cfg.vision_tokens:
        g_embed = grads[names.index("embed")]
        assert not g_embed[prefix_id].any()
        assert not np.asarray(gj["embed"])[prefix_id].any()
        assert g_embed[:prefix_id].abs().sum() > 0


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(microbatches):
    cfg_j, pj, cfg, pt = _model("h2o-danube-3-4b", seed=2)
    opt_kw = dict(peak_lr=3e-3, min_lr=3e-4, warmup_steps=2, total_steps=5)
    opt_j, opt = jax_adamw.OptimizerConfig(**opt_kw), \
        adamw.OptimizerConfig(**opt_kw)
    sj, st = jax_adamw.init_opt_state(pj, opt_j), adamw.init_opt_state(pt, opt)
    step_j = jax.jit(jax_train_step(cfg_j, opt_j, microbatches=microbatches))
    step = make_train_step(cfg, opt, microbatches=microbatches)
    for i in range(3):
        bj, bt = _batch(cfg, 4, 64, seed=10 + i)
        pj, sj, mj = step_j(pj, sj, bj)
        pt, st, mt = step(pt, st, bt)
        assert float(mt["loss"]) == pytest.approx(float(mj["loss"]), rel=1e-4)
        assert float(mt["grad_norm"]) == pytest.approx(
            float(mj["grad_norm"]), rel=1e-4)
        assert float(mt["lr"]) == pytest.approx(float(mj["lr"]), rel=1e-6)
    lr_sum = sum(float(jax_adamw.schedule(opt_j, jnp.int32(i)))
                 for i in (1, 2, 3))
    for name, a, b in zip(_names_jax(pj), tree_leaves(pt),
                          jax.tree.leaves(pj)):
        _assert_adam_close(a.detach().numpy(), np.asarray(b), lr_sum, name)


def test_moe_train_step_matches_jax():
    """make_train_step on olmoe's smoke config against the JAX package's
    jitted step: loss (with the routers' aux loss), grad norm and lr each
    step, then every leaf; the routers move."""
    cfg_j, pj, cfg, pt = _model("olmoe-1b-7b", seed=6)
    router0 = [b["moe"]["router"].clone() for b in pt["blocks"]]
    opt_kw = dict(peak_lr=3e-3, min_lr=3e-4, warmup_steps=2, total_steps=5)
    opt_j, opt = jax_adamw.OptimizerConfig(**opt_kw), \
        adamw.OptimizerConfig(**opt_kw)
    sj, st = jax_adamw.init_opt_state(pj, opt_j), adamw.init_opt_state(pt, opt)
    step_j = jax.jit(jax_train_step(cfg_j, opt_j))
    step = make_train_step(cfg, opt)
    for i in range(3):
        bj, bt = _batch(cfg, 2, 64, seed=30 + i)
        pj, sj, mj = step_j(pj, sj, bj)
        pt, st, mt = step(pt, st, bt)
        assert float(mt["loss"]) == pytest.approx(float(mj["loss"]), rel=1e-4)
        assert float(mt["aux_loss"]) == pytest.approx(float(mj["aux_loss"]),
                                                      rel=1e-4)
        assert float(mt["aux_loss"]) > 0
        assert float(mt["grad_norm"]) == pytest.approx(
            float(mj["grad_norm"]), rel=1e-4)
    lr_sum = sum(float(jax_adamw.schedule(opt_j, jnp.int32(i)))
                 for i in (1, 2, 3))
    for name, a, b in zip(_names_jax(pj), tree_leaves(pt),
                          jax.tree.leaves(pj)):
        _assert_adam_close(a.detach().numpy(), np.asarray(b), lr_sum, name)
    for b, r0 in zip(pt["blocks"], router0):
        assert not torch.equal(b["moe"]["router"], r0)


def _assert_adam_close(got, want, lr_sum, name):
    """Weights after a few Adam steps: an element whose gradient lies
    within float32 noise of 0 takes a normalised step of up to lr either
    way in each package.  So every element within 2 x the summed lr, and
    all but 1 in 1,000 at rtol 1e-4, atol 1e-5."""
    diff = np.abs(got - want)
    assert diff.max() <= 2 * lr_sum, name
    outside = diff > 1e-5 + 1e-4 * np.abs(want)
    assert outside.mean() <= 1e-3, (name, int(outside.sum()), diff.max())


def test_remat_on_and_off_give_the_same_steps():
    """Rematerialised blocks recompute the same float32 arithmetic."""
    out = []
    for remat in ("full", "none"):
        _, _, cfg, pt = _model("llama3.2-1b", seed=3, remat=remat)
        opt = adamw.OptimizerConfig(peak_lr=3e-3, warmup_steps=1,
                                    total_steps=4)
        st = adamw.init_opt_state(pt, opt)
        step = make_train_step(cfg, opt)
        losses = []
        for i in range(2):
            _, bt = _batch(cfg, 2, 32, seed=20 + i)
            pt, st, m = step(pt, st, bt)
            losses.append(float(m["loss"]))
        out.append((losses, [p.detach().clone() for p in tree_leaves(pt)]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_train_step_takes_the_plain_attention_route(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a training step reached the kernel route")

    monkeypatch.setattr(flash_ops, "flash_attention", refuse)
    _, _, cfg, pt = _model("h2o-danube-3-4b", seed=4)
    opt = adamw.OptimizerConfig(peak_lr=3e-3, warmup_steps=1, total_steps=2)
    _, bt = _batch(cfg, 2, 16, seed=5)
    _, _, m = make_train_step(cfg, opt)(pt, adamw.init_opt_state(pt, opt), bt)
    assert np.isfinite(float(m["loss"]))
    with pytest.raises(AssertionError, match="kernel route"):
        lm.lm_loss(pt, bt, cfg, attn_impl="kernel")


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

def test_bfloat16_embedding_gradient_sums_in_float32():
    """The gradient of a bfloat16 embedding table sums a token's 4,096
    contributions in float32: within one bf16 rounding (2^-8 relative) of
    the exact sum, where indexing's own backward, summing in bfloat16,
    is ~5% off here."""
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(50, 8, generator=gen).bfloat16().requires_grad_()
    tokens = torch.randint(0, 3, (2, 2048), generator=gen)
    g_out = (torch.randn(2, 2048, 8, generator=gen) * 1e-3).bfloat16()
    exact = torch.zeros(50, 8, dtype=torch.float64).index_add_(
        0, tokens.reshape(-1), g_out.reshape(-1, 8).double())
    with torch.enable_grad():
        out = lm._embed_tokens({"embed": table}, tokens)
        (got,) = torch.autograd.grad(out, table, g_out)
    torch.testing.assert_close(out, table[tokens], rtol=0, atol=0)
    assert got.dtype == torch.bfloat16
    assert float((got.double() - exact).norm() / exact.norm()) <= 2 ** -8


def test_bfloat16_embedding_gradient_against_the_jax_package(monkeypatch):
    """The embedding gradient of a bf16 model in both packages on the same
    weights and tokens, each beside its own float32 gradient: h2o-danube's
    layout at d 256 and its vocabulary of 32,000, 256 tokens of which ~80%
    are token 1 (a frequent token's row sums hundreds of contributions, as
    token 1 does in the card's lm_train batch).  Each element's error is
    measured against its row's noise scale, sqrt(sum over the token's
    occurrences of the mean square of the float32 per-occurrence gradient).

    The JAX package's gather transposes to a bf16 scatter-add, whose
    running sum stalls: its relative L2 distance from float32 exceeds 2^-6
    and elements of large gradient (>= 0.1 of the table's RMS, the card
    check's rule) lie further than half their row's noise scale from
    float32.  The port sums in float32: under 2^-6 and no such element.
    Elements of the other sign occur in both packages (here 2 in the port
    and 1 in the JAX package), all at the rounding floor: |float32
    gradient| within 2^-4 of the row's noise scale, where the bf16 backward
    through the layers (~2^-8 of that scale per element) decides the
    sign."""
    over = dict(d_model=256, d_ff=512, vocab_size=32000, dtype="bfloat16",
                param_dtype="bfloat16")
    cfg_j, pj, cfg, pt = _model("h2o-danube-3-4b", seed=0, **over)
    f32 = dict(dtype="float32", param_dtype="float32")
    cfg_j32, cfg32 = (dataclasses.replace(c, **f32) for c in (cfg_j, cfg))
    rng = np.random.default_rng(0)
    toks = np.where(rng.random((1, 257)) < 0.8, 1,
                    rng.integers(2, 32000, (1, 257)))
    bj = {"tokens": jnp.asarray(toks[:, :-1]),
          "targets": jnp.asarray(toks[:, 1:])}
    bt = {k: torch.from_numpy(np.array(v)).long() for k, v in bj.items()}
    grad_j = jax.jit(jax.grad(lambda p, c: jax_lm.lm_loss(p, bj, c)[0]),
                     static_argnums=1)
    looked_up = {}
    embed_tokens = lm._embed_tokens

    def capture(params, tokens):
        looked_up["h"] = embed_tokens(params, tokens)
        return looked_up["h"]

    monkeypatch.setattr(lm, "_embed_tokens", capture)

    def grad_t(params, c):
        """(embedding gradient, per-occurrence gradient (S, D))."""
        for p in tree_leaves(params):
            p.requires_grad_(True)
        loss, _ = lm.lm_loss(params, bt, c)
        g, g_occ = torch.autograd.grad(loss, [params["embed"],
                                              looked_up["h"]])
        return g.float().numpy(), g_occ[0].float().numpy()

    g = {"jax": np.asarray(grad_j(pj, cfg_j)["embed"], np.float32),
         "port": grad_t(pt, cfg)[0]}
    g32_port, g_occ = grad_t(lm.params_from_jax(jax.tree.map(
        lambda a: np.asarray(a, np.float32), pj)), cfg32)
    g32 = {"jax": np.asarray(grad_j(jax.tree.map(
        lambda a: a.astype(jnp.float32), pj), cfg_j32)["embed"]),
        "port": g32_port}
    np.testing.assert_allclose(g32["port"], g32["jax"], rtol=1e-4, atol=1e-6)
    row_sq = np.zeros(cfg.padded_vocab)
    np.add.at(row_sq, toks[0, :-1], np.mean(g_occ.astype(np.float64) ** 2,
                                             axis=1))
    noise = np.sqrt(row_sq)[:, None]
    flips, far, rel = {}, {}, {}
    for pkg in g:
        a = np.abs(g32[pkg])
        large = a >= 0.1 * np.sqrt(np.mean(a * a))
        flip = large & (np.sign(g[pkg]) != np.sign(g32[pkg]))
        flips[pkg] = int(flip.sum())
        assert np.all(a[flip] <= 2 ** -4 * np.broadcast_to(noise, a.shape)[
            flip]), pkg
        far[pkg] = int((large & (np.abs(g[pkg] - g32[pkg])
                                 > 0.5 * noise)).sum())
        rel[pkg] = float(np.linalg.norm(g[pkg] - g32[pkg])
                         / np.linalg.norm(g32[pkg]))
    assert flips["port"] > 0 and flips["jax"] > 0, flips
    assert far["port"] == 0 and far["jax"] > 0, far
    assert rel["port"] < 2 ** -6 < rel["jax"], rel


def test_token_dataset_batches_identical():
    want_ds = jax_data.TokenDataset(vocab_size=512, n_docs=64, doc_len=128,
                                    seed=3)
    got_ds = data.TokenDataset(vocab_size=512, n_docs=64, doc_len=128, seed=3)
    np.testing.assert_array_equal(got_ds.tokens, want_ds.tokens)
    for epoch, offset in [(0, 0), (0, 5), (2, 17)]:
        want = want_ds.batch(epoch, offset, 8, 16)
        got = got_ds.batch(epoch, offset, 8, 16)
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(got[k], want[k])


def test_loader_determinism_resume_and_shards_match_reference():
    """The loader's stream, a resume from (0, 3) and two host shards, each
    against the JAX package's loader (tests/test_runtime.py)."""
    ds = data.TokenDataset(vocab_size=512, n_docs=64, doc_len=128, seed=0)
    jds = jax_data.TokenDataset(vocab_size=512, n_docs=64, doc_len=128, seed=0)
    l1 = data.ShardedLoader(ds, global_batch=8, seq_len=16)
    j1 = jax_data.ShardedLoader(jds, global_batch=8, seq_len=16)
    batches = [l1.next() for _ in range(5)]
    for b in batches:
        np.testing.assert_array_equal(b["tokens"], j1.next()["tokens"])
    assert l1.state == data.PipelineState(0, 5)
    l1.close()
    j1.close()
    l2 = data.ShardedLoader(ds, global_batch=8, seq_len=16,
                            state=data.PipelineState(0, 3))
    np.testing.assert_array_equal(l2.next()["tokens"], batches[3]["tokens"])
    l2.close()
    shards = [data.ShardedLoader(ds, global_batch=8, seq_len=16, host_id=h,
                                 n_hosts=2) for h in (0, 1)]
    got = np.concatenate([s.next()["tokens"] for s in shards])
    np.testing.assert_array_equal(got, jds.batch(0, 0, 8, 16)["tokens"])
    for s in shards:
        s.close()
    assert data.PipelineState.from_dict(
        data.PipelineState(2, 7).as_dict()) == data.PipelineState(2, 7)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _state():
    return {"w": torch.arange(12.0).reshape(3, 4),
            "step": torch.tensor(7, dtype=torch.int32),
            "nested": {"b": torch.linspace(-2, 3, 5).bfloat16()},
            "pair": (torch.ones(2), torch.zeros((), dtype=torch.int32))}


def test_checkpoint_roundtrip_keeps_bfloat16_bits(tmp_path):
    ck = Checkpointer(tmp_path)
    st = _state()
    ck.save(10, st, extra={"next_step": 10})
    target = {"w": torch.zeros(3, 4), "step": torch.tensor(0, dtype=torch.int32),
              "nested": {"b": torch.zeros(5, dtype=torch.bfloat16)},
              "pair": (torch.zeros(2), torch.ones((), dtype=torch.int32))}
    out, extra = ck.restore(10, target)
    assert extra == {"next_step": 10}
    torch.testing.assert_close(out["w"], st["w"], rtol=0, atol=0)
    assert out["step"].dtype == torch.int32 and int(out["step"]) == 7
    assert out["nested"]["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["nested"]["b"].view(torch.int16).numpy(),
                                  st["nested"]["b"].view(torch.int16).numpy())
    assert isinstance(out["pair"], tuple) and int(out["pair"][1]) == 0
    assert float(target["w"].sum()) == 0.0      # the target is not written
    manifest = (tmp_path / "step_00000010" / "manifest.json").read_text()
    assert '"names": ["nested/b", "pair/0", "pair/1", "step", "w"]' in manifest
    assert '"bfloat16"' in manifest
    with pytest.raises(ValueError, match="mismatch"):
        ck.restore(10, {"w": target["w"]})


def test_checkpoint_async_and_gc(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    st = _state()
    for s in (1, 2, 3, 4):
        ck.save_async(s, st)
    ck.wait()
    assert ck.all_steps() == [3, 4]
    assert ck.latest_step() == 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_async_snapshots_before_returning(tmp_path, dtype):
    """save_async copies every leaf before it returns: an in-place update of
    a CPU leaf after the call (the train step's own) does not reach the
    file, bfloat16 leaves (kept as float32) included."""
    ck = Checkpointer(tmp_path)
    st = {"w": torch.ones(4, dtype=dtype), "m": torch.zeros(3, 5, dtype=dtype)}
    ck.save_async(1, st)
    st["w"].add_(1.0)                   # an in-place step after the call
    st["m"].copy_(torch.full((3, 5), 2.0))
    ck.wait()
    out, _ = ck.restore(1, st)
    assert out["w"].dtype == dtype
    torch.testing.assert_close(out["w"], torch.ones(4, dtype=dtype),
                               rtol=0, atol=0)
    torch.testing.assert_close(out["m"], torch.zeros(3, 5, dtype=dtype),
                               rtol=0, atol=0)


def test_checkpoint_atomicity(tmp_path):
    ck = Checkpointer(tmp_path)
    # a stale tmp dir from a crashed writer must be invisible
    (tmp_path / "step_00000099.tmp").mkdir()
    assert ck.latest_step() is None
    ck.save(5, _state())
    assert ck.latest_step() == 5
    assert not (tmp_path / "step_00000005.tmp").exists()


def test_float32_checkpoints_restore_across_packages(tmp_path):
    """A float32 (and int32) tree written by either package restores leaf
    for leaf in the other."""
    rng = np.random.default_rng(0)
    arrays = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "z": {"b": rng.normal(size=(5,)).astype(np.float32),
                    "c": np.int32(9)}}
    jtree = jax.tree.map(jnp.asarray, arrays)
    ttree = {"a": torch.from_numpy(arrays["a"].copy()),
             "z": {"b": torch.from_numpy(arrays["z"]["b"].copy()),
                   "c": torch.tensor(9, dtype=torch.int32)}}
    JaxCheckpointer(tmp_path / "j").save(3, jtree, extra={"next_step": 3})
    got, extra = Checkpointer(tmp_path / "j").restore(
        3, {"a": torch.zeros(3, 4),
            "z": {"b": torch.zeros(5), "c": torch.tensor(0, dtype=torch.int32)}})
    assert extra == {"next_step": 3}
    np.testing.assert_array_equal(got["a"].numpy(), arrays["a"])
    np.testing.assert_array_equal(got["z"]["b"].numpy(), arrays["z"]["b"])
    assert got["z"]["c"].dtype == torch.int32 and int(got["z"]["c"]) == 9
    Checkpointer(tmp_path / "t").save(4, ttree, extra={"next_step": 4})
    back, extra = JaxCheckpointer(tmp_path / "t").restore(
        4, jax.tree.map(jnp.zeros_like, jtree))
    assert extra == {"next_step": 4}
    np.testing.assert_array_equal(np.asarray(back["a"]), arrays["a"])
    np.testing.assert_array_equal(np.asarray(back["z"]["b"]), arrays["z"]["b"])
    assert back["z"]["c"].dtype == jnp.int32 and int(back["z"]["c"]) == 9


def test_bfloat16_checkpoints_across_packages(tmp_path):
    """Both packages store a bf16 leaf as float32 under manifest dtype
    ``bfloat16``: each restores the other's file exactly, and the port
    still restores the raw uint16 bits its earlier versions wrote."""
    vals = np.array([1.5, -0.25, 3.0, 1e-3, -7.1e4, 2.0 ** -130], np.float32)
    want = torch.from_numpy(vals).bfloat16()
    JaxCheckpointer(tmp_path / "j").save(
        1, {"b": jnp.asarray(vals).astype(jnp.bfloat16)})
    got, _ = Checkpointer(tmp_path / "j").restore(
        1, {"b": torch.zeros(6, dtype=torch.bfloat16)})
    assert got["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["b"].view(torch.int16).numpy(),
                                  want.view(torch.int16).numpy())
    Checkpointer(tmp_path / "t").save(1, {"b": want})
    with np.load(tmp_path / "t" / "step_00000001" / "arrays.npz") as z:
        assert z["a0"].dtype == np.float32
    back, _ = JaxCheckpointer(tmp_path / "t").restore(
        1, {"b": jnp.zeros(6, jnp.bfloat16)})
    assert back["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(back["b"]).view(np.uint16),
        np.asarray(jnp.asarray(vals).astype(jnp.bfloat16)).view(np.uint16))
    # a file of the old format: the leaf's raw bits as uint16
    old = tmp_path / "old" / "step_00000001"
    old.mkdir(parents=True)
    np.savez(old / "arrays.npz",
             a0=want.view(torch.int16).numpy().view(np.uint16))
    (old / "manifest.json").write_text(json.dumps(
        {"step": 1, "names": ["b"], "shapes": [[6]], "dtypes": ["bfloat16"],
         "extra": {}, "time": 0.0}))
    got, _ = Checkpointer(tmp_path / "old").restore(
        1, {"b": torch.zeros(6, dtype=torch.bfloat16)})
    np.testing.assert_array_equal(got["b"].view(torch.int16).numpy(),
                                  want.view(torch.int16).numpy())


# ---------------------------------------------------------------------------
# fault tolerance (mirrors tests/test_runtime.py)
# ---------------------------------------------------------------------------

def test_run_resilient_recovers_from_failures(tmp_path):
    ck = Checkpointer(tmp_path)
    fail_at = {7, 13}

    def step_fn(state, step):
        if step in fail_at:
            fail_at.discard(step)
            raise RuntimeError("injected node failure")
        return {"x": state["x"] + 1.0}, {"loss": float(state["x"])}

    report = run_resilient(step_fn, {"x": torch.tensor(0.0)}, n_steps=20,
                           ckpt=ck, ckpt_every=5)
    assert report.steps_completed == 20
    assert report.restarts == 2
    assert report.final_metrics == {"loss": 19.0}


def test_run_resilient_crash_loop_guard(tmp_path):
    ck = Checkpointer(tmp_path)

    def always_fails(state, step):
        raise RuntimeError("hard failure")

    with pytest.raises(RuntimeError):
        run_resilient(always_fails, {"x": torch.tensor(0.0)}, n_steps=5,
                      ckpt=ck, max_restarts=3)


def test_preemption_takes_emergency_checkpoint(tmp_path):
    ck = Checkpointer(tmp_path)
    sig = PreemptionSignal()

    def step_fn(state, step):
        if step == 3:
            sig.set()
        return {"x": state["x"] + 1.0}, {}

    report = run_resilient(step_fn, {"x": torch.tensor(0.0)}, n_steps=6,
                           ckpt=ck, ckpt_every=100, preemption=sig)
    assert report.emergency_checkpoints == 1
    assert ck.latest_step() == 4


def test_straggler_monitor_flags_slow_steps():
    mon = StragglerMonitor(threshold=2.0, warmup=2)
    for s in range(10):
        mon.observe(s, 1.0)
    assert not mon.events
    assert mon.observe(10, 5.0)
    assert mon.events[0]["step"] == 10
    # baseline unpoisoned
    assert mon.ewma == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_train_cli_recovers_and_the_loss_falls(tmp_path, capsys):
    train_cli.main(["--preset", "ci", "--steps", "30", "--ckpt-every", "10",
                    "--inject-failure-at", "15", "--ckpt-dir",
                    str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[train] arch=llama3.2-1b-smoke params=")
    assert out[0].endswith("batch=8 seq=64 steps=30")
    done = re.match(r"\[train\] done: 30 steps in \d+s, restarts=1, "
                    r"first-loss=([\d.]+) last-loss=([\d.]+)", out[-1])
    assert done and float(done[2]) < float(done[1])
    assert Checkpointer(tmp_path).all_steps() == [10, 20, 30]
