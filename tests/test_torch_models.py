"""The port's LM slice against the JAX package on the CPU: flash attention's
plain version (the CPU path of ``ops.flash_attention``) against the JAX
reference and the Pallas kernel in interpret mode; the configs, parameter
layout and initialisation, RoPE and RMSNorm; ``lm_logits``, ``decode_step``
and replay ``prefill`` with JAX weights carried across by
``params_from_jax`` (the encoder-decoder with encoder inputs of another
length than the prompt); the attention options of the config (the ``dus``
cache update, ``seq_dp``/``ep_seq``/``pure_dp``, the two-tier decode
cache); the transformer embedder; ``serve_lm``; and the analytic cost
model.

Inputs come from seeded numpy.  Tolerances: attention 2e-3 float32 and
3e-2 bfloat16, as the JAX package's kernel test (tests/test_kernels.py);
whole-model float32 outputs 1e-4 (the same arithmetic, sums in another
order, through a few layers); decode replay against the parallel forward
2e-2, as tests/test_model_consistency.py holds the reference."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import _REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import embedder as jax_embedder  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models import rope as jax_rope  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.core import embedder as pt_embedder  # noqa: E402
from repro_torch.core.pipeline import TastiConfig, build_tasti  # noqa: E402
from repro_torch.core.schema import make_workload  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.launch import serve_lm  # noqa: E402
from repro_torch.models import attention, common, lm, rope  # noqa: E402
from repro_torch.train.steps import make_prefill_step, make_serve_step  # noqa: E402

pytestmark = pytest.mark.tier1

_JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a CPU tensor of ``dtype``."""
    a = a.astype(np.float32)
    return (jnp.asarray(a).astype(_JAX_DT[dtype]),
            torch.from_numpy(a).to(_TORCH_DT[dtype]))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

# tests/test_kernels.py's four shapes, h2o-danube's head dim 120 with a
# window that bites, the transformer embedder's bidirectional S = 8, and
# qwen2-vl-7b's 28 heads on 4 KV heads
FLASH_SHAPES = [
    (2, 128, 128, 8, 4, 64, True, 0),
    (1, 128, 128, 4, 4, 128, True, 64),
    (2, 96, 96, 8, 2, 80, True, 0),
    (1, 64, 192, 4, 2, 64, False, 0),
    (1, 128, 128, 8, 2, 120, True, 64),
    (3, 8, 8, 4, 4, 64, False, 0),
    (1, 128, 128, 28, 4, 128, True, 0),   # qwen2-vl-7b's heads: a group of 7
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,skv,h,hk,hd,causal,window", FLASH_SHAPES)
def test_flash_attention_matches_jax(b, s, skv, h, hk, hd, causal, window,
                                     dtype):
    rng = np.random.default_rng(s + h + hd)
    qj, qt = _pair(rng.normal(size=(b, s, h, hd)), dtype)
    kj, kt = _pair(rng.normal(size=(b, skv, hk, hd)), dtype)
    vj, vt = _pair(rng.normal(size=(b, skv, hk, hd)), dtype)
    got = flash_attention(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == _TORCH_DT[dtype] and got.shape == qt.shape
    want_ref = jax_flash_ref(qj, kj, vj, causal=causal, window=window)
    want_pallas = jax_flash(qj, kj, vj, causal=causal, window=window,
                            impl="pallas", interpret=True, block_q=64,
                            block_k=64)
    tol = 2e-3 if dtype == "float32" else 3e-2
    for want in (want_ref, want_pallas):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_flash_attention_rows_with_no_key_average_every_value():
    """Rows 79.. of q (200) see no key of k (50) within the window 30: the
    reference's finite NEG_INF gives them the plain mean of v, not NaN."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=sh).astype(np.float32) for sh in
               [(1, 200, 4, 32), (1, 50, 2, 32), (1, 50, 2, 32)])
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                          window=30).numpy()
    want = np.asarray(jax_flash_ref(*map(jnp.asarray, (q, k, v)),
                                    causal=True, window=30))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    mean_v = np.repeat(v.mean(1), 2, axis=1)           # kv head h // 2
    np.testing.assert_allclose(got[0, 100], mean_v[0], rtol=1e-5, atol=1e-5)


def test_flash_attention_rejects_bad_shapes():
    q = torch.zeros(1, 8, 6, 16)
    with pytest.raises(ValueError, match="shapes"):
        flash_attention(q, torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 4, 16))
    with pytest.raises(ValueError, match="shapes"):
        flash_attention(q, torch.zeros(1, 8, 3, 8), torch.zeros(1, 8, 3, 8))


# The kernel's path comes from shape and dtype alone (it runs here too):
# short up to S, Skv = 32 while one batch element's rows fit its block; tc
# for bf16 with hd % 8 == 0 and hd <= 128; simt for the rest, float32
# included.
@pytest.mark.parametrize("dtype,b,s,skv,h,hk,hd,path", [
    ("bfloat16", 1, 8192, 8192, 32, 8, 120, "tc"),     # danube prefill layer
    ("bfloat16", 2, 33, 33, 8, 2, 64, "tc"),           # just past short
    ("bfloat16", 2, 32, 33, 8, 2, 64, "tc"),
    ("bfloat16", 2, 32, 32, 8, 2, 64, "short"),        # at the limit
    ("bfloat16", 2, 31, 1, 8, 2, 64, "short"),
    ("bfloat16", 1, 512, 512, 4, 4, 60, "simt"),       # hd % 8 != 0
    ("bfloat16", 1, 512, 512, 4, 4, 136, "simt"),      # hd > 128
    ("bfloat16", 1, 32, 32, 32, 8, 128, "tc"),         # short rows too big
    ("float32", 65536, 8, 8, 4, 4, 64, "short"),       # the embedder
    ("float32", 1, 32, 32, 4, 2, 64, "simt"),          # 69,632 B > 64 KB
    ("float32", 1, 32, 32, 2, 1, 64, "short"),
    ("float32", 1, 8, 8, 4, 4, 62, "simt"),            # rows not 16-byte
    ("float32", 1, 8192, 8192, 32, 8, 120, "simt"),    # float32 stays exact
    ("float32", 1, 33, 8, 4, 4, 64, "simt"),
])
def test_flash_route_picks_the_path_by_shape_and_dtype(dtype, b, s, skv, h,
                                                       hk, hd, path):
    from repro_torch.kernels.flash_attention.ops import flash_route
    q = torch.empty(b, s, h, hd, dtype=_TORCH_DT[dtype])
    k = torch.empty(b, skv, hk, hd, dtype=_TORCH_DT[dtype])
    assert flash_route(q, k) == path


def test_flash_attention_witness_rounds_only_p():
    """``round_p`` changes nothing in float32 and, in bf16, stays within the
    JAX package's bf16 tolerance of its reference."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    rng = np.random.default_rng(9)
    shapes = [(1, 96, 4, 64), (1, 96, 2, 64), (1, 96, 2, 64)]
    q, k, v = (rng.normal(size=sh).astype(np.float32) for sh in shapes)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    assert torch.equal(flash_attention_ref(qt, kt, vt, window=40),
                       flash_attention_ref(qt, kt, vt, window=40,
                                           round_p=True))
    pairs = [_pair(a, "bfloat16") for a in (q, k, v)]
    got = flash_attention_ref(*(p[1] for p in pairs), window=40,
                              round_p=True)
    want = jax_flash_ref(*(p[0] for p in pairs), causal=True, window=40)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=3e-2, atol=3e-2)


def _tc_arithmetic(q, k, v, causal, window, bn=128):
    """The kernel's tc path in plain PyTorch: keys in tiles of ``bn``, a
    running row max, P = exp(s - max so far) rounded to bf16 before P.V,
    float32 sums and one division at the end."""
    from repro_torch.kernels.flash_attention.ref import NEG_INF
    b, s, h, hd = q.shape
    skv, hk = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, s, hk, h // hk, hd)
    m = torch.full((b, hk, h // hk, s), NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros(b, hk, h // hk, s, hd)
    qpos = torch.arange(s)[:, None]
    for k0 in range(0, skv, bn):
        sc = torch.einsum("bskgh,btkh->bkgst", qg,
                          k[:, k0:k0 + bn].float()) / np.sqrt(hd)
        kpos = torch.arange(k0, min(k0 + bn, skv))[None, :]
        keep = torch.ones(s, kpos.shape[1], dtype=torch.bool)
        if causal:
            keep &= qpos >= kpos
        if window:
            keep &= qpos - kpos < window
        sc.masked_fill_(~keep, NEG_INF)
        mn = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - mn)
        p = torch.exp(sc - mn[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgst,btkh->bkgsh", p.bfloat16().float(),
            v[:, k0:k0 + bn].float())
        m = mn
    out = (acc / l[..., None]).permute(0, 3, 1, 2, 4)
    return out.reshape(b, s, h, hd).bfloat16()


@pytest.mark.parametrize("s,hd,window", [(640, 120, 256), (400, 64, 0)])
def test_flash_attention_tolerance_takes_p_rounding_not_a_dropped_tile(
        s, hd, window):
    """``allowed_error`` with the witness passes the tc path's arithmetic
    (P rounded to bf16 against a running max) element by element, and
    rejects the same arithmetic with v zeroed over 128 keys at the window
    edge of the last 128 query rows, in those rows too."""
    from repro_torch.kernels.flash_attention.ref import allowed_error
    rng = np.random.default_rng(s)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, s, nh, hd)).astype(
        np.float32)).bfloat16() for nh in (8, 2, 2))
    want, allowed = allowed_error(q, k, v, True, window, round_p=True)
    got = _tc_arithmetic(q, k, v, True, window)
    assert int(((got.float() - want).abs() > allowed).sum()) == 0
    e0 = max(0, s - 128 - window + 1) // 128 * 128
    vz = v.clone()
    vz[:, e0:e0 + 128] = 0
    bad = (_tc_arithmetic(q, k, vz, True, window).float() - want).abs() > \
        allowed
    assert int(bad[:, -128:].sum()) > 0


# ---------------------------------------------------------------------------
# configs, parameters, layers
# ---------------------------------------------------------------------------

def test_configs_match_jax():
    assert sorted(JAX_REGISTRY) == sorted(
        get_config(n).name for n in JAX_REGISTRY)
    for name, want in JAX_REGISTRY.items():
        got = get_config(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        assert dataclasses.asdict(got.smoke()) == \
            dataclasses.asdict(want.smoke()), name
        assert got.param_count() == want.param_count(), name
    assert [dataclasses.asdict(s) for s in SHAPES] == \
        [dataclasses.asdict(s) for s in JAX_SHAPES]


def _flat_specs(tree, path=""):
    """[(path, shape, dtype name)] of a spec tree of either package."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in
                _flat_specs(tree[k], f"{path}/{k}")]
    if isinstance(tree, tuple):
        return [x for i, v in enumerate(tree) for x in
                _flat_specs(v, f"{path}/{i}")]
    dt = tree.dtype
    name = str(dt)[6:] if isinstance(dt, torch.dtype) else jnp.dtype(dt).name
    return [(path, tuple(tree.shape), name)]


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "llama3.2-1b",
                                  "qwen3-1.7b", "tasti-embedder",
                                  "olmoe-1b-7b", "qwen3-moe-30b-a3b",
                                  "xlstm-350m", "jamba-1.5-large-398b",
                                  "qwen2-vl-7b", "seamless-m4t-large-v2",
                                  "phi3-medium-14b"])
def test_parameter_layout_matches_jax(arch):
    """Full-width specs (no allocation): the same tree, shapes and dtypes."""
    assert _flat_specs(lm.model_specs(get_config(arch))) == \
        _flat_specs(jax_lm.model_specs(jax_config(arch)))


def test_init_draws_like_jax():
    """normal / sqrt(fan_in) with fan_in = shape[-2] (the stacked axis
    excluded), ones for norm scales; the same seed gives the same draw."""
    cfg = dataclasses.replace(get_config("h2o-danube-3-4b").smoke(),
                              d_model=256, d_ff=512)
    p = lm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    again = lm.init_model(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    blk = p["blocks"][0]
    assert blk["attn"]["wq"].shape == (cfg.n_repeats, 256, 4 * 32)
    for w, fan_in in [(blk["attn"]["wq"], 256), (blk["mlp"]["wo"], 512),
                      (p["embed"], cfg.padded_vocab), (p["unembed"], 256)]:
        assert abs(float(w.std()) * np.sqrt(fan_in) - 1) < 0.05
    assert torch.equal(blk["norm1"]["scale"], torch.ones(cfg.n_repeats, 256))
    assert torch.equal(p["embed"], again["embed"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_and_rmsnorm_match_jax(dtype):
    """apply_rope casts cos/sin to x's dtype before multiplying, so bf16
    rounds as in the reference: bit-equal here.  RMSNorm and LayerNorm
    (float32 statistics, population variance) at the same tolerance."""
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.normal(size=(2, 16, 4, 120)), dtype)
    pos = np.arange(16)[None]
    aj = jax_rope.rope_angles(jnp.asarray(pos), 120, 10000.0)
    at = rope.rope_angles(torch.from_numpy(pos), 120, 10000.0)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-6)
    got = _f32(rope.apply_rope(xt, at))
    want = _f32(jax_rope.apply_rope(xj, aj))
    tol = 1e-5 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    sj, st = _pair(rng.uniform(0.5, 1.5, size=(120,)), dtype)
    got = _f32(common.rmsnorm({"scale": st}, xt, 1e-6))
    want = _f32(jax_common.rmsnorm({"scale": sj}, xj, 1e-6))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    bj, bt = _pair(rng.normal(size=(120,)), dtype)
    xj, xt = _pair(rng.normal(3.0, 2.0, size=(2, 16, 4, 120)), dtype)
    got = common.layernorm({"scale": st, "bias": bt}, xt, 1e-5)
    want = jax_common.layernorm({"scale": sj, "bias": bj}, xj, 1e-5)
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    specs = common.layernorm_specs(120, _TORCH_DT[dtype])
    assert _flat_specs(specs) == _flat_specs(
        jax_common.layernorm_specs(120, _JAX_DT[dtype]))


# the smoke sections (8, 4, 4) on hd 32 with 16 vision tokens on 4 x 4, and
# qwen2-vl-7b's own (16, 24, 24) on hd 128 with 256 on 16 x 16
MROPE_CASES = {"smoke": (32, (8, 4, 4), 16, (4, 4)),
               "full": (128, (16, 24, 24), 256, (16, 16))}


@pytest.mark.parametrize("case", sorted(MROPE_CASES))
def test_mrope_positions_and_angles_match_jax(case):
    """The (3, B, S) positions exactly (a prompt past the prefix, and an
    offset one), int64 as RoPE's; the angles in float32 to 1e-6."""
    hd, sections, v, grid = MROPE_CASES[case]
    for seq, offset in ((v + 40, 0), (50, v - 20)):
        want = np.asarray(jax_rope.mrope_positions(2, seq, v, grid, offset))
        got = rope.mrope_positions(2, seq, v, grid, offset)
        assert got.dtype == torch.int64 and got.shape == (3, 2, seq)
        np.testing.assert_array_equal(got.numpy(), want)
        aj = jax_rope.mrope_angles(jnp.asarray(want), hd, 1e6, sections)
        at = rope.mrope_angles(got, hd, 1e6, sections)
        assert at.dtype == torch.float32 and at.shape == (2, seq, hd // 2)
        np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-6)


@pytest.mark.parametrize("case", sorted(MROPE_CASES))
def test_mrope_angles_for_the_model_match_jax(case):
    """``lm._angles_for`` with M-RoPE against the JAX package's: the
    parallel forward's (B, S, hd/2) grid angles, and decode's at positions
    below the vision prefix (p = pos - V + 1 < 0), at its edge and past
    it."""
    hd, sections, v, grid = MROPE_CASES[case]
    cfg = dataclasses.replace(get_config("qwen2-vl-7b"), head_dim=hd,
                              mrope_sections=sections, vision_tokens=v,
                              vision_grid=grid)
    cfg_j = dataclasses.replace(jax_config("qwen2-vl-7b"), head_dim=hd,
                                mrope_sections=sections, vision_tokens=v,
                                vision_grid=grid)
    got = lm._angles_for(cfg, 3, v + 24, "cpu")
    want = np.asarray(jax_lm._angles_for(cfg_j, 3, v + 24))
    assert got.shape == (3, v + 24, hd // 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    for pos in (0, 5, v - 2, v - 1, v, v + 3000):
        got = lm._angles_for(cfg, 3, 1, "cpu", position=pos)
        want = np.asarray(jax_lm._angles_for(cfg_j, 3, 1,
                                             positions=jnp.int32(pos)))
        assert got.shape == (3, 1, hd // 2), pos
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, err_msg=pos)
        assert (float(got[0, 0, 1]) < 0) == (pos < v - 1), pos


def test_params_from_jax_keeps_bfloat16_bits():
    cfg = jax_config("h2o-danube-3-4b").smoke()
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16", dtype="bfloat16")
    pj = jax_lm.init_model(cfg, jax.random.PRNGKey(3))
    pt = lm.params_from_jax(jax.tree.map(np.asarray, pj))
    wq_j = np.asarray(pj["blocks"][0]["attn"]["wq"])
    wq_t = pt["blocks"][0]["attn"]["wq"]
    assert wq_t.dtype == torch.bfloat16 and wq_t.shape == wq_j.shape
    np.testing.assert_array_equal(wq_t.view(torch.int16).numpy(),
                                  wq_j.view(np.int16))
    # a bf16 hybrid keeps Mamba's float32 leaves (A_log, D) in float32
    cfg = dataclasses.replace(jax_config("jamba-1.5-large-398b").smoke(),
                              param_dtype="bfloat16", dtype="bfloat16")
    pj = jax_lm.init_model(cfg, jax.random.PRNGKey(4))
    pt = lm.params_from_jax(jax.tree.map(np.asarray, pj))
    for name in ("A_log", "D", "in_proj"):
        want = np.asarray(pj["blocks"][0]["mamba"][name])
        got = pt["blocks"][0]["mamba"][name]
        assert got.dtype == _TORCH_DT[want.dtype.name], name
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.astype(np.float32))


# ---------------------------------------------------------------------------
# the model: logits, decode, replay prefill
# ---------------------------------------------------------------------------

# smoke variants beside the configs' own: qwen2-vl with 7 query heads on
# one KV head, so that a GQA group of 7 (qwen2-vl-7b's 28 on 4) runs
# through the whole model; phi3-medium with 4 on 1 (its smoke model is
# MHA, its published one 40 on 10); seamless with an encoder one layer
# deeper than its decoder, so that each stack runs its own depth;
# phi3-medium with the two-tier decode cache's ring of 8
VARIANTS = {"qwen2-vl-7b-gqa7": ("qwen2-vl-7b",
                                 {"n_heads": 7, "n_kv_heads": 1}),
            "phi3-medium-14b-gqa4": ("phi3-medium-14b",
                                     {"n_heads": 4, "n_kv_heads": 1}),
            "seamless-m4t-large-v2-enc3": ("seamless-m4t-large-v2",
                                           {"n_encoder_layers": 3}),
            "phi3-medium-14b-ring8": ("phi3-medium-14b", {"decode_ring": 8})}


def _model(arch, seed=0, **over):
    """The JAX package's smoke model of ``arch`` (a key of ``VARIANTS`` or
    a config name), with the config fields ``over`` replaced, seeded, and
    the port's with the same weights."""
    arch, var = VARIANTS.get(arch, (arch, {}))
    over = {**var, **over}
    cfg_j = dataclasses.replace(jax_config(arch).smoke(), **over)
    pj = jax_lm.init_model(cfg_j, jax.random.PRNGKey(seed))
    return (cfg_j, pj, dataclasses.replace(get_config(arch).smoke(), **over),
            lm.params_from_jax(jax.tree.map(np.asarray, pj)))



def _vision(cfg, b, seed):
    """Seeded patch embeddings (B, V, D) as numpy, for a vision model."""
    return np.random.default_rng(seed).normal(
        size=(b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)


def _inputs(cfg, toks, seed, enc_len):
    """The batch of ``toks`` (B, S) for both packages, with a vision
    model's patch embeddings, or an encoder-decoder's ``enc_len`` seeded
    frame embeddings (another length than the prompt, as speech has)."""
    extra = {}
    if cfg.vision_tokens:
        extra["vision_embeds"] = _vision(cfg, toks.shape[0], seed)
    if cfg.encoder_decoder:
        extra["enc_embeds"] = np.random.default_rng(seed).normal(
            size=(toks.shape[0], enc_len, cfg.d_model)).astype(np.float32)
    extra["tokens"] = toks
    return ({k: jnp.asarray(v) for k, v in extra.items()},
            {k: torch.from_numpy(v) for k, v in extra.items()})


def _one_ulp_witness(pj, run, base):
    """How far the reference's ``run(params)`` (logits) moves from ``base``
    (``run(pj)``) when every element of its embedding table moves by one
    float32 ulp (x (1 +- 2^-23)): the model's own sensitivity to rounding,
    taken from the JAX package alone, the witness that a few deep recurrent
    layers need (xlstm-350m's smoke model moves its logits by more than
    1e-4 under it)."""
    sign = np.random.default_rng(9).choice([-1.0, 1.0],
                                           size=tuple(pj["embed"].shape))
    moved = dict(pj, embed=pj["embed"] * jnp.asarray(
        1 + 2.0 ** -23 * sign, pj["embed"].dtype))
    return float(np.abs(np.asarray(run(moved)) - base).max())


@pytest.mark.parametrize("arch,jax_impl", [
    ("h2o-danube-3-4b", "xla"), ("h2o-danube-3-4b", "pallas_interpret"),
    ("llama3.2-1b", "xla"), ("qwen3-1.7b", "xla"),
    ("olmoe-1b-7b", "xla"), ("olmoe-1b-7b", "pallas_interpret"),
    ("qwen3-moe-30b-a3b", "xla"), ("xlstm-350m", "xla"),
    ("jamba-1.5-large-398b", "xla"),
    ("qwen2-vl-7b", "xla"), ("qwen2-vl-7b", "pallas_interpret"),
    ("qwen2-vl-7b-gqa7", "xla"), ("qwen2-vl-7b-gqa7", "pallas_interpret"),
    ("seamless-m4t-large-v2", "xla"),
    ("seamless-m4t-large-v2", "pallas_interpret"),
    ("seamless-m4t-large-v2-enc3", "xla"),
    ("phi3-medium-14b", "xla"), ("phi3-medium-14b", "pallas_interpret"),
    ("phi3-medium-14b-gqa4", "xla"),
    ("phi3-medium-14b-gqa4", "pallas_interpret")])
def test_lm_logits_match_jax(arch, jax_impl):
    """h2o-danube at S = 128 so that its smoke window of 64 bites; llama
    (tied embeddings) and qwen3 (qk-norm) for the other branches; the MoE
    models (olmoe MHA, qwen3-moe GQA), xLSTM (mLSTM and sLSTM) and jamba
    (Mamba, attention, dense and MoE layers); qwen2-vl (M-RoPE, 16 vision
    embeddings merged over the first positions) and its 7-heads-on-1
    variant; seamless (a bidirectional encoder over 96 frame embeddings,
    the decoder's 128 tokens cross-attending to them: S != Skv; without
    them a ``KeyError``, as in the JAX package), also with 3 encoder
    layers against 2 decoder layers; phi3-medium (untied, no window) and
    its 4-heads-on-1 variant.  1e-4,
    or for xlstm-350m twice the reference's one-ulp witness
    (``_one_ulp_witness``) where that is larger."""
    cfg_j, pj, cfg, pt = _model(arch)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 128))
    batch_j, batch = _inputs(cfg, toks, seed=3, enc_len=96)

    def reference(params):
        return np.asarray(jax_lm.lm_logits(params, batch_j, cfg_j,
                                           attn_impl=jax_impl))

    want = reference(pj)
    step = make_prefill_step(cfg)
    got = step(pt, batch)
    assert got.shape == (2, 128, cfg.padded_vocab)
    tol = 1e-4
    if arch == "xlstm-350m":
        tol = max(tol, 2 * _one_ulp_witness(pj, reference, want))
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    plain = make_prefill_step(cfg, attn_impl="plain")(pt, batch)
    np.testing.assert_array_equal(plain.numpy(), got.numpy())
    if cfg.encoder_decoder:
        with pytest.raises(KeyError, match="enc_embeds"):
            step(pt, {"tokens": batch["tokens"]})


def test_decode_and_replay_prefill_match_jax():
    cfg_j, pj, cfg, pt = _model("h2o-danube-3-4b", seed=1)
    b, s, cache_len = 2, 12, 16
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (b, s))
    cj = jax_lm.init_cache(cfg_j, b, cache_len)
    ct = lm.init_cache(cfg, b, cache_len, device="cpu")
    step = make_serve_step(cfg)
    for t in range(s):
        lj, cj = jax_lm.decode_step(pj, cj, jnp.asarray(toks[:, t:t + 1]),
                                    jnp.int32(t), cfg_j)
        lt, ct = step(pt, ct, torch.from_numpy(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_allclose(ct[0]["k"].numpy(), np.asarray(cj[0]["k"]),
                               rtol=1e-4, atol=1e-4)
    want, _ = jax_lm.prefill(pj, {"tokens": jnp.asarray(toks)}, cfg_j,
                             cache_len)
    with torch.no_grad():
        got, caches = lm.prefill(pt, {"tokens": torch.from_numpy(toks)}, cfg,
                                 cache_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # the replay is the serving path of the parallel forward
    par = make_prefill_step(cfg)(pt, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), par.numpy(), rtol=2e-2,
                               atol=2e-2)
    assert caches[0]["k"].shape == (cfg.n_repeats, b, cache_len,
                                    cfg.n_kv_heads, cfg.resolved_head_dim)


def test_decode_ring_wraps_like_jax():
    """A cache shorter than the sequence wraps (slot pos % S) and the window
    of 64 never exceeds it here: the ring write matches the reference's
    one-hot where."""
    cfg_j, pj, cfg, pt = _model("llama3.2-1b", seed=2)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 10))
    cj = jax_lm.init_cache(cfg_j, 1, 4)
    ct = lm.init_cache(cfg, 1, 4, device="cpu")
    for t in range(10):
        lj, cj = jax_lm.decode_step(pj, cj, jnp.asarray(toks[:, t:t + 1]),
                                    jnp.int32(t), cfg_j)
        with torch.no_grad():
            lt, ct = lm.decode_step(pt, ct, torch.from_numpy(toks[:, t:t + 1]),
                                    t, cfg)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen3-moe-30b-a3b",
                                  "xlstm-350m", "jamba-1.5-large-398b",
                                  "qwen2-vl-7b", "qwen2-vl-7b-gqa7",
                                  "seamless-m4t-large-v2",
                                  "phi3-medium-14b-ring8"])
def test_decode_of_every_mixer_matches_jax(arch):
    """Decode steps against the reference's (1e-4; for xlstm-350m twice the
    reference's one-ulp witness of the same steps where that is larger),
    the recurrent states after them (1e-4), and the replay against the
    parallel forward within tests/test_model_consistency.py's 2e-2.  MoE
    decode is dropless (a group of B tokens).  qwen2-vl's prompt runs past
    its 16 vision tokens, and its replay ``prefill`` is held against the
    reference's with vision embeddings in the batch, which both ignore:
    their prefix takes the decode positions (negative), not the grid, so
    the replay is not the parallel forward there.  seamless's decode needs
    the cross-attention caches that only ``prefill`` builds (from 12
    encoder frames against a prompt of 16): the reference's logits come
    from its ``prefill``, and the cross caches are held to its (1e-4).
    Under ``decode_ring`` (8 slots) the replay writes only the rings, which
    wrap twice and are held to the reference's (1e-4); the main cache
    stays zero in both, so that replay is not the parallel forward."""
    cfg_j, pj, cfg, pt = _model(arch, seed=1)
    b, s = 2, 24 if cfg.vision_tokens else 16
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (b, s))
    batch_j, batch = _inputs(cfg, toks, seed=4, enc_len=12)
    jax_step = jax.jit(jax_lm.decode_step, static_argnums=4)

    def reference(params):
        if cfg.encoder_decoder:
            logits, cj = jax_lm.prefill(params, batch_j, cfg_j, s)
            return np.asarray(logits), cj
        cj = jax_lm.init_cache(cfg_j, b, s)
        logits = []
        for t in range(s):
            lj, cj = jax_step(params, cj, jnp.asarray(toks[:, t:t + 1]),
                              jnp.int32(t), cfg_j)
            logits.append(np.asarray(lj[:, 0]))
        return np.stack(logits, 1), cj

    want, cj = reference(pj)
    if cfg.vision_tokens:
        replay, _ = jax_lm.prefill(pj, batch_j, cfg_j, s)
        np.testing.assert_allclose(np.asarray(replay), want, rtol=1e-4,
                                   atol=1e-4)
    with torch.no_grad():
        got, ct = lm.prefill(pt, batch, cfg, s)
    tol = 1e-4
    if arch == "xlstm-350m":
        tol = max(tol, 2 * _one_ulp_witness(pj, lambda p: reference(p)[0],
                                            want))
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    for pos, spec in enumerate(cfg.pattern):
        assert sorted(ct[pos]) == sorted(cj[pos]), spec
        for name, state in ct[pos].items():
            ref = np.asarray(cj[pos][name], np.float32)
            assert state.dtype == _TORCH_DT[str(cj[pos][name].dtype)]
            assert tuple(state.shape) == ref.shape
            if spec.mixer != "attn" or name.startswith(("cross_",
                                                         "ring_")):
                np.testing.assert_allclose(_f32(state), ref, rtol=1e-4,
                                           atol=1e-4, err_msg=name)
    if cfg.encoder_decoder:
        assert ct[0]["cross_k"].shape[2] == 12
    if cfg.decode_ring:
        assert ct[0]["ring_k"].shape[2] == cfg.decode_ring
        assert not ct[0]["k"].any() and not ct[0]["v"].any()
    if cfg.vision_tokens or cfg.decode_ring:
        return
    par = make_prefill_step(cfg)(pt, batch)
    np.testing.assert_allclose(got.numpy(), par.numpy(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "qwen2-vl-7b"])
def test_serve_lm_cli_on_cpu(capsys, arch):
    serve_lm.main(["--arch", arch, "--preset", "ci", "--batch",
                   "2", "--prompt-len", "8", "--decode-steps", "4",
                   "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"[serve] arch={arch}-smoke batch=2 "
                             "prefill=8 tok")
    assert out[1].startswith("[serve] sample generation ids: [")
    assert len(eval(out[1].split(": ", 1)[1])) == 4


def test_serve_lm_refuses_an_encoder_decoder_arch(monkeypatch):
    """The JAX package's demo gives seamless no encoder inputs and fails
    in its first decode step (``KeyError: 'cross_k'``: its caches have no
    cross-attention K/V); the port's refuses the arch before it builds
    anything, saying why, and so does ``serve``."""
    from repro.launch import serve_lm as jax_serve_lm
    monkeypatch.setattr("sys.argv", ["serve_lm", "--arch",
                                     "seamless-m4t-large-v2", "--batch", "1",
                                     "--prompt-len", "2",
                                     "--decode-steps", "1"])
    with pytest.raises(KeyError, match="cross_k"):
        jax_serve_lm.main()
    with pytest.raises(ValueError, match="encoder-decoder.*enc_embeds"):
        serve_lm.main(["--arch", "seamless-m4t-large-v2", "--device",
                       "cpu"])
    cfg = get_config("seamless-m4t-large-v2").smoke()
    with pytest.raises(ValueError, match="encoder-decoder"):
        serve_lm.serve({}, cfg, torch.zeros(1, 2, dtype=torch.long), 1)


# ---------------------------------------------------------------------------
# the transformer embedder
# ---------------------------------------------------------------------------

def test_transformer_embedder_matches_jax():
    jcfg = jax_embedder.EmbedderConfig(feature_dim=64, embed_dim=128,
                                       backbone="tasti-embedder")
    pj = jax_embedder.init_embedder(jcfg, jax.random.PRNGKey(0))
    x = np.random.default_rng(4).normal(size=(50, 64)).astype(np.float32)
    want = np.asarray(jax_embedder.embed(pj, jnp.asarray(x), jcfg))
    cfg = pt_embedder.EmbedderConfig(feature_dim=64, embed_dim=128,
                                     backbone="tasti-embedder")
    model = pt_embedder.Embedder(cfg)
    model.load_state_dict(pt_embedder.params_from_jax(
        jax.tree.map(np.asarray, pj)))
    got = pt_embedder.embed_all(model, x, batch=16)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        plain = model(torch.from_numpy(x), attn_impl="plain").numpy()
    np.testing.assert_allclose(plain, got, rtol=1e-5, atol=1e-5)


def test_build_tasti_takes_the_transformer_embedder():
    """PT build with the transformer backbone embeds as the JAX embedder
    does with the same weights."""
    jcfg = jax_embedder.EmbedderConfig(feature_dim=64, embed_dim=128,
                                       backbone="tasti-embedder")
    pj = jax_embedder.init_embedder(jcfg, jax.random.PRNGKey(1))
    wl = make_workload("night-street", n_frames=300)
    cfg = pt_embedder.EmbedderConfig(feature_dim=64, embed_dim=128,
                                     backbone="tasti-embedder")
    system = build_tasti(
        wl, TastiConfig(n_reps=30, k=4), variant="PT", device="cpu",
        embed_params=pt_embedder.params_from_jax(jax.tree.map(np.asarray, pj)),
        embedder=cfg)
    want = jax_embedder.embed_all(pj, wl.features, jcfg)
    np.testing.assert_allclose(system.index.embeddings, want, rtol=1e-4,
                               atol=1e-4)
    assert system.index.n_reps == 30 and system.ecfg == cfg
    with pytest.raises(ValueError, match="does not map"):
        build_tasti(wl, TastiConfig(n_reps=30, k=4, embed_dim=32),
                    variant="PT", device="cpu", embedder=cfg,
                    embed_params=system.embed_params)


# ---------------------------------------------------------------------------
# the attention options of the config
# ---------------------------------------------------------------------------

def _decode_logits(step, params, caches, toks, start=0):
    """(B, T, V) logits of ``step`` fed ``toks`` (B, T) one at a time from
    position ``start`` over ``caches``."""
    out = []
    for t in range(toks.shape[1]):
        lg, caches = step(params, caches, toks[:, t:t + 1], start + t)
        out.append(np.asarray(lg[:, 0], np.float32))
    return np.stack(out, 1)


@pytest.mark.parametrize("field,value,arch", [
    ("decode_cache_update", "dus", "h2o-danube-3-4b"),
    ("shard_strategy", "seq_dp", "h2o-danube-3-4b"),
    ("shard_strategy", "seq_dp", "olmoe-1b-7b"),
    ("shard_strategy", "ep_seq", "h2o-danube-3-4b"),
    ("shard_strategy", "ep_seq", "olmoe-1b-7b"),
    ("shard_strategy", "pure_dp", "h2o-danube-3-4b"),
    ("shard_strategy", "pure_dp", "olmoe-1b-7b")])
def test_attention_options_match_jax(field, value, arch):
    """Each option against the reference under the same option (1e-4),
    and the port under it against the port under the default, bit for bit:
    on one device the JAX package computes ``megatron``'s function under
    ``seq_dp``, ``ep_seq`` and ``pure_dp`` (no mesh, no ``model`` axis),
    and its ``dus`` cache write the ``masked`` one's values.  The
    strategies on logits at S 128 (h2o-danube's smoke window of 64 bites);
    ``dus`` on 12 decode steps over a cache of 8 slots, which wraps."""
    cfg_j, pj, cfg, pt = _model(arch, **{field: value})
    base = dataclasses.replace(cfg, **{field: getattr(
        get_config(arch), field)})
    if field == "shard_strategy":
        toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 128))
        want = np.asarray(jax_lm.lm_logits(pj, {"tokens": jnp.asarray(toks)},
                                           cfg_j))
        batch = {"tokens": torch.from_numpy(toks)}
        got = make_prefill_step(cfg)(pt, batch).numpy()
        default = make_prefill_step(base)(pt, batch).numpy()
    else:
        toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12))
        jax_step = jax.jit(jax_lm.decode_step, static_argnums=4)
        want = _decode_logits(
            lambda p, c, tok, t: jax_step(p, c, jnp.asarray(tok),
                                          jnp.int32(t), cfg_j),
            pj, jax_lm.init_cache(cfg_j, 2, 8), toks)
        got, default = (_decode_logits(
            make_serve_step(c), pt, lm.init_cache(c, 2, 8, device="cpu"),
            torch.from_numpy(toks)) for c in (cfg, base))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got, default)


def test_attention_rejects_an_unknown_impl():
    cfg = get_config("llama3.2-1b").smoke()
    p = common.init_params(attention.attention_specs(cfg), device="cpu")
    with pytest.raises(ValueError, match="attn impl"):
        attention.attention_fwd(p, torch.zeros(1, 4, cfg.d_model), cfg,
                                impl="xla")


def _two_tier_caches(init_cache, cfg_ring, main, b, s):
    """The two-tier caches of ``cfg_ring``: zero rings and the main cache
    grafted from ``main``, the caches of a masked decode of ``s`` steps
    (capacity exactly ``s``); ``init_cache(cfg, b, s)`` of either
    package."""
    ring = init_cache(cfg_ring, b, s)
    return tuple(dict(r, k=m["k"], v=m["v"]) for r, m in zip(ring, main))


def test_two_tier_decode_matches_plain():
    """tests/test_model_consistency.py's test on the port: phi3-medium's
    smoke model, a prompt of 16 into the main cache by the masked decode,
    then 6 steps on a ring of 8 against the masked decode over all 22
    tokens (2e-3)."""
    cfg = get_config("phi3-medium-14b").smoke()
    b, s, extra = 2, 16, 6
    cfg_ring = dataclasses.replace(cfg, decode_ring=8)
    params = lm.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (b, s + extra),
                         generator=torch.Generator().manual_seed(1))
    step, ring_step = make_serve_step(cfg), make_serve_step(cfg_ring)
    want = _decode_logits(step, params,
                          lm.init_cache(cfg, b, s + extra, device="cpu"),
                          toks)[:, -1]
    main = lm.init_cache(cfg, b, s, device="cpu")
    _decode_logits(step, params, main, toks[:, :s])
    caches = _two_tier_caches(
        lambda c, bb, ss: lm.init_cache(c, bb, ss, device="cpu"), cfg_ring,
        main, b, s)
    got = _decode_logits(ring_step, params, caches, toks[:, s:], start=s)
    np.testing.assert_allclose(got[:, -1], want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch,window", [("phi3-medium-14b", 0),
                                         ("qwen3-1.7b", 0),
                                         ("h2o-danube-3-4b", 6)])
def test_two_tier_decode_matches_jax(arch, window):
    """The main cache (8 slots) filled by the masked decode, then 10 steps
    on a ring of 4, past its capacity, where the reference overwrites the
    token 4 steps back (ROADMAP C, noted): each step's logits and the
    rings after it against the reference's (1e-4).  qwen3's qk-norm takes
    the k_norm-under-q_norm branch; h2o-danube with a window of 6 masks
    main keys, and ring slots by the positions S + i that the reference
    gives them even after the ring wraps."""
    b, s, w, steps = 2, 8, 4, 10
    cfg_j, pj, cfg, pt = _model(arch, seed=3, sliding_window=window)
    rcfg_j = dataclasses.replace(cfg_j, decode_ring=w)
    rcfg = dataclasses.replace(cfg, decode_ring=w)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                             (b, s + steps))
    jax_step = jax.jit(jax_lm.decode_step, static_argnums=4)
    cj = jax_lm.init_cache(cfg_j, b, s)
    ct = lm.init_cache(cfg, b, s, device="cpu")
    for t in range(s):
        _, cj = jax_step(pj, cj, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t),
                         cfg_j)
    _decode_logits(make_serve_step(cfg), pt, ct, torch.from_numpy(toks[:, :s]))
    np.testing.assert_allclose(ct[0]["k"].numpy(), np.asarray(cj[0]["k"]),
                               rtol=1e-4, atol=1e-4)
    cj = _two_tier_caches(jax_lm.init_cache, rcfg_j, cj, b, s)
    ct = _two_tier_caches(
        lambda c, bb, ss: lm.init_cache(c, bb, ss, device="cpu"), rcfg, ct,
        b, s)
    main = ct[0]["k"].clone()
    ring_step = make_serve_step(rcfg)
    for t in range(s, s + steps):
        lj, cj = jax_step(pj, cj, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t),
                          rcfg_j)
        lt, ct = ring_step(pt, ct, torch.from_numpy(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {t}")
        for name in ("ring_k", "ring_v"):
            np.testing.assert_allclose(ct[0][name].numpy(),
                                       np.asarray(cj[0][name]), rtol=1e-4,
                                       atol=1e-4, err_msg=f"{name} {t}")
    assert torch.equal(ct[0]["k"], main)


def test_lm_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_lm.main(["--arch", "h2o-danube-3-4b", "--preset", "ci"])


@pytest.mark.parametrize("make", [
    lambda cfg: lm.init_model(cfg, torch.Generator().manual_seed(0)),
    lambda cfg: common.init_params(attention.attention_specs(cfg)),
    lambda cfg: lm.init_cache(cfg, 1, 4)],
    ids=["init_model", "init_params", "init_cache"])
def test_model_state_defaults_to_cuda_and_raises_without_it(monkeypatch,
                                                            make):
    """Parameters and caches land on CUDA unless the caller asks for
    another device; without CUDA, asking for nothing raises."""
    cfg = get_config("h2o-danube-3-4b").smoke()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make(cfg)
