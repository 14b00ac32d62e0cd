"""OLMoE-1B-7B-0924 as published (``configs/olmoe_1b_7b_0924.py``) against
its plain reference (the benchmark's ``portbench.refs.moe_lm``) on seeded
weights at a small size: 2 layers, d 128, 4 + 4 heads of 32, 8 experts of
width 64 with 2 a token, vocabulary 300, batch 2 x 64 tokens.  The
dropless MoE against the capacity path where capacity covers every
choice, the router's weights with and without renormalisation, qk-norm
over the projection against per head, prefill then cache decoding, and
the ``moe.forward`` span."""
from __future__ import annotations

import dataclasses
import pathlib
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.models import lm, moe
from repro_torch.models.common import tree_leaves_with_names
from repro_torch.obs import trace

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from portbench.refs import moe_lm as ref  # noqa: E402

VOCAB, BATCH, SEQ = 300, 2, 64
SMALL = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
             n_experts=8, top_k=2, moe_d_ff=64, d_ff=64, vocab_size=VOCAB,
             vocab_pad_multiple=16)
#: the published config's keys, as the reference reads them
SIZES = dict(num_hidden_layers=2, rms_norm_eps=1e-5, head_dim=32,
             num_attention_heads=4, num_key_value_heads=4, num_experts=8,
             num_experts_per_tok=2, norm_topk_prob=False, rope_theta=1e4)
#: float32: the port and the reference differ only in the order of sums
F32_TOL = 1e-5
#: bfloat16 activations round every product's inputs to 8 mantissa bits,
#: and where two of a token's router logits lie within that rounding the
#: port picks another expert than the float32 reference: 1-9% of the
#: tokens a layer over seeds 0-7, for a relative rms of 0.020-0.077;
#: renormalising the weights (a wrong path) reads 0.41-0.49
BF16_TOL = 0.15


def _cfg(dtype="float32", **kw):
    return dataclasses.replace(get_config("olmoe-1b-7b-0924"), **SMALL,
                               dtype=dtype, param_dtype=dtype, **kw)


def _seeded(cfg, seed=0):
    """(params, the same leaves by name, prompts): the port's draw with
    the router's logits spread as a trained router's (x 10 its init) and
    every norm's scale 1 + 0.1 normal, so that a scale matters."""
    g = torch.Generator().manual_seed(seed)
    params = lm.init_model(cfg, g, device="cpu")
    flat = dict(tree_leaves_with_names(params))
    for name, t in flat.items():
        if name.endswith("router"):
            t.mul_(10)
        elif "norm" in name:
            t.copy_(1 + 0.1 * torch.randn(t.shape, generator=g))
    return params, flat, torch.randint(0, VOCAB, (BATCH, SEQ), generator=g)


def _rel_rms(got, want):
    got, want = got[..., :VOCAB].float(), want[..., :VOCAB].float()
    return float((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())


def _ref_logits(flat, tokens, c=SIZES):
    """The reference's float32 logits (B, S, vocab rows), prompt by
    prompt."""
    hid = torch.stack([ref.hidden(flat, t, c) for t in tokens])
    return hid @ flat["unembed"].float()


def _logits(cfg, params, tokens):
    with torch.no_grad():
        return lm.lm_logits(params, {"tokens": tokens}, cfg)


@pytest.mark.parametrize("dtype, tol", [("float32", F32_TOL),
                                        ("bfloat16", BF16_TOL)])
def test_logits_match_the_reference(dtype, tol):
    cfg = _cfg(dtype)
    assert cfg.moe_dropless and cfg.qk_norm_whole
    assert not cfg.router_renormalize
    for seed in (0, 1):
        params, flat, tokens = _seeded(cfg, seed)
        got = _logits(cfg, params, tokens)
        assert _rel_rms(got, _ref_logits(flat, tokens)) < tol


def test_the_published_sizes():
    cfg = get_config("olmoe-1b-7b-0924")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.n_experts, cfg.top_k, cfg.moe_d_ff,
            cfg.vocab_size, cfg.norm_eps) == (16, 2048, 16, 16, 128, 64, 8,
                                              1024, 50304, 1e-5)
    # the experts' 6.44B of 6.92B parameters (the q/k norms' 4,096 a layer
    # are not in param_count)
    assert 6.91e9 < cfg.param_count() + 16 * 4096 < 6.93e9
    specs = dict(tree_leaves_with_names(lm.model_specs(cfg)))
    assert tuple(specs["blocks/0/attn/q_norm"].shape) == (16, 2048)
    assert tuple(specs["blocks/0/attn/k_norm"].shape) == (16, 2048)


def _moe_out(cfg, x, params):
    with torch.no_grad():
        return moe.moe_fwd(params, x, cfg)[0]


@pytest.mark.parametrize("capacity", [
    dict(moe_group_size=32),                           # groups of <= 64
    dict(moe_group_size=128, capacity_factor=4.0),     # cap = group
])
def test_dropless_equals_the_capacity_path_where_nothing_drops(capacity):
    """With renormalised weights (the capacity path's rule) and a
    capacity that holds every choice, both dispatches compute the same
    sums; at the default capacity factor the capacity path drops."""
    cfg = _cfg(router_renormalize=True, **capacity)
    params, _, _ = _seeded(cfg)
    layer = {k: v[0] for k, v in params["blocks"][0]["moe"].items()}
    x = torch.randn(BATCH, SEQ, cfg.d_model,
                    generator=torch.Generator().manual_seed(3))
    dropless = _moe_out(cfg, x, layer)
    gshard = _moe_out(dataclasses.replace(cfg, moe_dropless=False), x, layer)
    torch.testing.assert_close(dropless, gshard, rtol=1e-5, atol=1e-6)
    drops = dataclasses.replace(cfg, moe_dropless=False, moe_group_size=128,
                                capacity_factor=1.0)
    assert not torch.allclose(_moe_out(drops, x, layer), dropless,
                              rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("renormalize", [False, True])
def test_router_weights_softmax_then_top_k(renormalize):
    logits = torch.randn(50, 8, generator=torch.Generator().manual_seed(4))
    weights, idx = moe._softmax_top_k(logits, 2, renormalize)
    probs = torch.softmax(logits, dim=-1)
    top, want_idx = torch.topk(probs, 2, dim=-1)
    assert torch.equal(idx, want_idx)
    if renormalize:
        top = top / top.sum(-1, keepdim=True)
    else:
        assert float(weights.sum(-1).max()) < 1
    torch.testing.assert_close(weights, top)
    # the whole layer against the reference's, with the same rule
    cfg = _cfg(router_renormalize=renormalize)
    params, flat, _ = _seeded(cfg)
    x = torch.randn(BATCH * SEQ, cfg.d_model,
                    generator=torch.Generator().manual_seed(5))
    layer = {k: v[0] for k, v in params["blocks"][0]["moe"].items()}
    want = ref.moe(x, lambda n: flat[f"blocks/0/{n}"][0],
                   dict(SIZES, norm_topk_prob=renormalize), "float32")
    torch.testing.assert_close(_moe_out(cfg, x[None], layer)[0], want,
                               rtol=1e-5, atol=1e-6)


def test_qk_norm_over_the_projection_against_per_head():
    """Per head the scales are head_dim wide; over the projection the
    same values tiled over the heads, so only the norm's span differs:
    the two forms differ, and each matches its own reference."""
    whole = _cfg()
    per_head = _cfg(qk_norm_whole=False)
    params, flat, tokens = _seeded(per_head)
    attn = params["blocks"][0]["attn"]
    tiled = dict(params, blocks=(dict(params["blocks"][0], attn=dict(
        attn, q_norm=attn["q_norm"].repeat(1, 4),
        k_norm=attn["k_norm"].repeat(1, 4))),))
    got_head = _logits(per_head, params, tokens)
    got_whole = _logits(whole, tiled, tokens)
    assert _rel_rms(got_head, got_whole) > 1e-3
    assert _rel_rms(got_head, _ref_logits(flat, tokens, dict(
        SIZES, qk_norm="head"))) < F32_TOL
    assert _rel_rms(got_whole, _ref_logits(dict(tree_leaves_with_names(
        tiled)), tokens)) < F32_TOL


def test_prefill_then_cache_decoding_equals_the_full_forward():
    cfg = _cfg()
    params, flat, tokens = _seeded(cfg)
    first = SEQ - 16
    with torch.no_grad():
        logits, caches = lm.prefill(params, {"tokens": tokens[:, :first]},
                                    cfg, cache_len=SEQ)
        steps = [logits]
        for pos in range(first, SEQ):
            step, caches = lm.decode_step(params, caches,
                                          tokens[:, pos:pos + 1], pos, cfg)
            steps.append(step)
    got = torch.cat(steps, dim=1)
    assert _rel_rms(got, _ref_logits(flat, tokens)) < F32_TOL


def test_moe_forward_span_counts():
    cfg = _cfg()
    params, _, tokens = _seeded(cfg)
    since = len(trace.profiled_spans())
    _logits(cfg, params, tokens)
    assert len(trace.profiled_spans()) == since
    with profile(activities=[ProfilerActivity.CPU]):
        _logits(cfg, params, tokens)
    spans = trace.profiled_spans()[since:]
    assert [s["name"] for s in spans].count("lm.forward") == 1
    moes = [s for s in spans if s["name"] == "moe.forward"]
    assert len(moes) == cfg.n_layers
    for s in moes:
        assert s["attrs"] == {"tokens": BATCH * SEQ,
                              "choices": BATCH * SEQ * cfg.top_k,
                              "experts": cfg.n_experts, "d2h_bytes": 0,
                              "combine": "plain"}


def test_moe_forward_span_on_the_capacity_path_counts_no_choices():
    """The capacity path drops the choices past an expert's capacity, so
    its span gives no ``choices``."""
    cfg = _cfg(moe_dropless=False, moe_group_size=32)
    params, _, tokens = _seeded(cfg)
    since = len(trace.profiled_spans())
    with profile(activities=[ProfilerActivity.CPU]):
        _logits(cfg, params, tokens)
    moes = [s for s in trace.profiled_spans()[since:]
            if s["name"] == "moe.forward"]
    assert len(moes) == cfg.n_layers
    for s in moes:
        assert s["attrs"] == {"tokens": BATCH * SEQ,
                              "experts": cfg.n_experts, "d2h_bytes": 0}


def test_dropless_has_no_mesh_or_training_path():
    from types import SimpleNamespace

    from repro_torch.configs import LayerSpec
    from repro_torch.models import blocks
    cfg = _cfg()
    params, _, _ = _seeded(cfg)
    layer = {k: {n: t[0] for n, t in v.items()} for k, v in
             params["blocks"][0].items() if k in ("norm2", "moe")}
    x = torch.randn(1, 4, cfg.d_model)
    with pytest.raises(NotImplementedError, match="one device"):
        blocks._mlp_out(layer, x, cfg, LayerSpec("attn", "moe"),
                        SimpleNamespace(mesh=None))
    trained = {k: t.requires_grad_() for k, t in layer["moe"].items()}
    with pytest.raises(NotImplementedError, match="training"):
        moe.moe_fwd(trained, x, cfg)


@pytest.mark.parametrize("dropless", [True, False])
def test_recorded_routing_hands_over_each_layers_choice(dropless):
    cfg = _cfg(moe_dropless=dropless, moe_group_size=32)
    params, _, tokens = _seeded(cfg)
    with moe.recorded_routing() as routing:
        _logits(cfg, params, tokens)
    assert len(routing) == cfg.n_layers
    assert all(r.shape == (BATCH * SEQ, cfg.top_k) for r in routing)
    # the first layer's choice, from its input
    with torch.no_grad():
        x = lm._embed_tokens(params, tokens)
        layer = params["blocks"][0]
        h = x + lm.attention.attention_fwd(
            {k: v[0] for k, v in layer["attn"].items()},
            lm.rmsnorm({"scale": layer["norm1"]["scale"][0]}, x, cfg.norm_eps),
            cfg, angles=lm._angles_for(cfg, BATCH, SEQ, x.device))
        a = lm.rmsnorm({"scale": layer["norm2"]["scale"][0]}, h, cfg.norm_eps)
        logits = (a @ layer["moe"]["router"][0]).reshape(-1, cfg.n_experts)
    want = torch.sort(logits, dim=-1, descending=True,
                      stable=True).indices[:, :cfg.top_k]
    assert torch.equal(routing[0], want)
    assert moe._routing is None


def test_the_references_import_nothing_of_the_port_or_jax():
    """The benchmark's reference, which these tests hold the port to, and
    its driver load nothing of the port and no JAX."""
    import os
    import subprocess
    code = ("import sys\n"
            "import portbench.refs.moe_lm, portbench.drivers.moe_prefill\n"
            "print(' '.join(sorted(m for m in sys.modules if m.split('.')[0]"
            " in ('repro', 'repro_torch', 'jax', 'jaxlib', 'flax'))))")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT}"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert not out.stdout.split()
