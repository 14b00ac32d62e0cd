"""The port's MoE, Mamba and xLSTM layers against the JAX package's on the
CPU, and the parameter initialisation they need (``init_scale``, the
sliced draw of a large leaf).

Inputs come from seeded numpy; JAX weights are carried across with
``params_from_jax``.  Tolerances are the reference's own: 1e-5 in float32
for a layer (the same arithmetic, sums in another order), 5e-2 in bf16
(tests/test_kernels.py), and decode against the layer's forward within
test_model_consistency.py's bounds (Mamba 2e-3, mLSTM 3e-3)."""
import contextlib
import dataclasses
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models import mamba as jax_mamba  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models import xlstm as jax_xlstm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import common, lm, mamba, moe, xlstm  # noqa: E402

pytestmark = pytest.mark.tier1

_JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _layer(arch, specs_j, seed=0, dtype="float32", **over):
    """(cfg_j, params_j, cfg, params) of one layer of ``arch``'s smoke
    config, JAX weights carried across.  An sLSTM's ``up`` is drawn 4x
    wider, so that its GELU's argument reaches |x| ~ 3, where the tanh
    form (``jax.nn.gelu``'s default) and the exact one part by ~5e-4."""
    over = dict(over, dtype=dtype, param_dtype=dtype)
    cfg_j = dataclasses.replace(jax_config(arch).smoke(), **over)
    cfg = dataclasses.replace(get_config(arch).smoke(), **over)
    pj = jax_common.init_params(specs_j(cfg_j), jax.random.PRNGKey(seed))
    if specs_j is jax_xlstm.slstm_specs:
        pj = dict(pj, up=pj["up"] * 4)
    pt = common.params_from_jax(jax.tree.map(np.asarray, pj))
    return cfg_j, pj, cfg, pt


def _x(shape, seed, dtype="float32", scale=1.0):
    a = (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)
    return (jnp.asarray(a).astype(_JAX_DT[dtype]),
            torch.from_numpy(a).to(_TORCH_DT[dtype]))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _jax_keep(pj, xj, cfg_j):
    """The reference's capacity mask, recomputed from its own pieces
    (``moe.py``'s routing and positions; ``moe_fwd`` returns no mask)."""
    b, s, d = xj.shape
    gt = min(cfg_j.moe_group_size, b * s)
    xg = xj.reshape(-1, gt, d)
    logits = jnp.dot(xg, pj["router"]).astype(jnp.float32)
    _, idx = jax_moe._top_k_gating(logits, cfg_j.top_k)
    onehot = jax.nn.one_hot(idx, cfg_j.n_experts, dtype=jnp.float32)
    flat = onehot.reshape(xg.shape[0], -1, cfg_j.n_experts)
    pos = jnp.sum(((jnp.cumsum(flat, 1) - flat).reshape(onehot.shape))
                  * onehot, -1)
    cap = gt if gt <= 64 else max(1, int(round(
        gt * cfg_j.top_k * cfg_j.capacity_factor / cfg_j.n_experts)))
    return np.asarray(pos < cap)


@contextlib.contextmanager
def _count_drops():
    """Yields a list that gets each ``moe_fwd`` call's dropped (token,
    choice) pairs: the pairs routed less those its dispatch tensor keeps."""
    counts, route = [], moe._route

    def counting(params, xg, cfg, cap):
        dispatch, combine, aux = route(params, xg, cfg, cap)
        counts.append(xg.shape[0] * xg.shape[1] * cfg.top_k
                      - int(dispatch.sum(dtype=torch.float32)))
        return dispatch, combine, aux

    with mock.patch.object(moe, "_route", counting):
        yield counts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("regime", ["dropless", "dropping"])
def test_moe_fwd_matches_jax(regime, dtype):
    """Dropless: groups of 32 tokens (<= 64, capacity = group).  Dropping:
    one group of 128 over 256 tokens (capacity round(128 x 2 x 1.25 / 8) =
    40) with the router skewed towards expert 0, so that the reference
    drops choices; the port must drop as many (``_count_drops``)."""
    over = {} if regime == "dropless" else {"moe_group_size": 128}
    cfg_j, pj, cfg, pt = _layer("olmoe-1b-7b", jax_moe.moe_specs, seed=1,
                                dtype=dtype, **over)
    if regime == "dropping":
        router = np.array(pj["router"], np.float32)
        router[:, 0] += 0.4
        pj["router"] = jnp.asarray(router).astype(_JAX_DT[dtype])
        pt["router"] = torch.from_numpy(router).to(_TORCH_DT[dtype])
    xj, xt = _x((2, 128, cfg.d_model), seed=2, dtype=dtype)
    want, aux_j = jax_moe.moe_fwd(pj, xj, cfg_j)
    with _count_drops() as drops:
        got, aux = moe.moe_fwd(pt, xt, cfg)
    dropped = sum(drops)
    keep = _jax_keep(pj, xj, cfg_j)
    assert dropped == int((~keep).sum())
    assert (dropped > 0) == (regime == "dropping")
    assert got.dtype == _TORCH_DT[dtype] and got.shape == xt.shape
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    assert float(aux) == pytest.approx(float(aux_j), rel=1e-5)


def test_top_k_gating_breaks_ties_as_jax():
    """bf16-rounded router logits with planted ties among 64 experts (a
    value repeated at several indices, including across the k-th place):
    the same indices in the same order as ``jax.lax.top_k``, exactly."""
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(64, 64)).astype(np.float32)
    for row in logits:
        at = rng.choice(64, size=rng.integers(2, 12), replace=False)
        row[at] = row[rng.integers(64)]
    logits[0, :] = 0.5                                 # all 64 tied
    logits[1, ::2] = logits[1].max()                   # 32 tied at the top
    logits = np.asarray(jnp.asarray(logits).astype(jnp.bfloat16),
                        np.float32)
    for k in (1, 2, 8):
        wj, ij = jax_moe._top_k_gating(jnp.asarray(logits), k)
        wt, it = moe._top_k_gating(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-6)


# ---------------------------------------------------------------------------
# Mamba, mLSTM, sLSTM: forward and decode
# ---------------------------------------------------------------------------

_MIXERS = {
    "mamba": ("jamba-1.5-large-398b", jax_mamba.mamba_specs,
              jax_mamba.mamba_fwd, mamba.mamba_fwd),
    "mlstm": ("xlstm-350m", jax_xlstm.mlstm_specs, jax_xlstm.mlstm_fwd,
              xlstm.mlstm_fwd),
    "slstm": ("xlstm-350m", jax_xlstm.slstm_specs, jax_xlstm.slstm_fwd,
              xlstm.slstm_fwd),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mixer", sorted(_MIXERS))
def test_mixer_fwd_matches_jax(mixer, dtype):
    """64 tokens: four chunks of the smoke config's 16, so the carried
    state crosses three chunk boundaries."""
    arch, specs_j, fj, ft = _MIXERS[mixer]
    cfg_j, pj, cfg, pt = _layer(arch, specs_j, seed=4, dtype=dtype)
    xj, xt = _x((2, 64, cfg.d_model), seed=5, dtype=dtype, scale=0.5)
    want = fj(pj, xj, cfg_j)
    got = ft(pt, xt, cfg)
    assert got.dtype == _TORCH_DT[dtype] and got.shape == xt.shape
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def _decode_states(mixer, cfg, b, jax_side):
    zeros = (jnp.zeros if jax_side else
             (lambda shape: torch.zeros(shape)))
    if mixer == "mamba":
        return (zeros((b, cfg.ssm_conv_width - 1, cfg.d_inner)),
                zeros((b, cfg.d_inner, cfg.ssm_state_dim)))
    if mixer == "mlstm":
        hd = cfg.mlstm_inner // cfg.n_heads
        return (zeros((b, cfg.n_heads, hd, hd)),
                zeros((b, cfg.n_heads, hd)))
    return tuple(zeros((b, cfg.d_model)) for _ in range(4))


def _step(mod, mixer, params, x_t, state, cfg):
    if mixer == "slstm":
        y, state = mod.slstm_decode(params, x_t, state, cfg)
        return y, state
    fn = mod.mamba_decode if mixer == "mamba" else mod.mlstm_decode
    y, *state = fn(params, x_t, *state, cfg)
    return y, tuple(state)


@pytest.mark.parametrize("mixer", sorted(_MIXERS))
def test_mixer_decode_matches_jax(mixer):
    """Token by token from zero state: each step's output and state
    against the reference's decode at 1e-5, and the steps against the
    port's own chunked forward within the reference's consistency bounds
    (Mamba 2e-3, mLSTM 3e-3, sLSTM 2e-3)."""
    arch, specs_j, _, ft = _MIXERS[mixer]
    mod_j = jax_mamba if mixer == "mamba" else jax_xlstm
    mod = mamba if mixer == "mamba" else xlstm
    cfg_j, pj, cfg, pt = _layer(arch, specs_j, seed=6)
    b, s = 2, 32
    xj, xt = _x((b, s, cfg.d_model), seed=7, scale=0.5)
    sj_, st_ = _decode_states(mixer, cfg, b, True), \
        _decode_states(mixer, cfg, b, False)
    ys = []
    for t in range(s):
        yj, sj_ = _step(mod_j, mixer, pj, xj[:, t:t + 1], sj_, cfg_j)
        yt, st_ = _step(mod, mixer, pt, xt[:, t:t + 1], st_, cfg)
        np.testing.assert_allclose(_f32(yt), _f32(yj), rtol=1e-5, atol=1e-5)
        ys.append(yt[:, 0])
    for a, w in zip(st_, sj_):
        np.testing.assert_allclose(_f32(a), _f32(w), rtol=1e-5, atol=1e-5)
    par = ft(pt, xt, cfg)
    bound = {"mamba": 2e-3, "mlstm": 3e-3, "slstm": 2e-3}[mixer]
    np.testing.assert_allclose(_f32(torch.stack(ys, 1)), _f32(par),
                               rtol=bound, atol=bound)


# ---------------------------------------------------------------------------
# initialisation
# ---------------------------------------------------------------------------

def test_init_scale_reaches_the_router_and_conv_w():
    """std x sqrt(fan_in) reads each leaf's ``init_scale``: 0.1 for the MoE
    router, 0.5 for Mamba's conv_w and the sLSTM recurrence, 0.1 for the
    mLSTM gates; 1 for the rest, as in the JAX package's specs."""
    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b").smoke(),
                              d_model=256)
    p = lm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    blk = p["blocks"]
    router = blk[1]["moe"]["router"]                  # (R, d, E)
    conv = blk[0]["mamba"]["conv_w"]                  # (R, W, di)
    for w, fan_in, want in [(router, 256, 0.1), (conv, cfg.ssm_conv_width,
                                                 0.5),
                            (blk[0]["mamba"]["in_proj"], 256, 1.0)]:
        assert abs(float(w.std()) * np.sqrt(fan_in) / want - 1) < 0.1
    xcfg = get_config("xlstm-350m").smoke()
    specs = lm.model_specs(xcfg)
    jspecs = jax_lm.model_specs(jax_config("xlstm-350m").smoke())
    got = [s.init_scale for s in common.tree_leaves(specs)]
    want = [s.init_scale for s in jax.tree.leaves(
        jspecs, is_leaf=jax_common.is_spec_leaf)]
    assert got == want and 0.5 in got and 0.1 in got


def test_init_slices_a_large_leaf(monkeypatch):
    """A leaf above SLICE_DRAW_BYTES (lowered here to 64 KiB) is drawn slice
    by slice along its leading axis into a tensor of its dtype and device,
    with the right scale; a leaf under it keeps today's single draw, value
    for value."""
    specs = {"big": common.ParamSpec((6, 64, 80), torch.bfloat16,
                                     init_scale=0.5),
             "small": common.ParamSpec((16, 32), torch.float32)}
    before = common.init_params(specs, torch.Generator().manual_seed(0),
                                device="cpu")
    g = torch.Generator().manual_seed(0)
    single_big = torch.randn((6, 64, 80), generator=g) * (0.5 / np.sqrt(64))
    single_small = torch.randn((16, 32), generator=g) * (1 / np.sqrt(16))
    assert torch.equal(before["big"], single_big.bfloat16())
    assert torch.equal(before["small"], single_small)
    monkeypatch.setattr(common, "SLICE_DRAW_BYTES", 64 << 10)
    p = common.init_params(specs, torch.Generator().manual_seed(0),
                           device="cpu")
    big = p["big"]
    assert big.dtype == torch.bfloat16 and big.device.type == "cpu"
    assert big.shape == (6, 64, 80)
    g = torch.Generator().manual_seed(0)
    sliced = torch.stack([torch.randn((64, 80), generator=g)
                          * (0.5 / np.sqrt(64)) for _ in range(6)])
    assert torch.equal(big, sliced.bfloat16())
    assert abs(float(big.float().std()) * np.sqrt(64) / 0.5 - 1) < 0.05
    assert abs(float(big.float().mean())) < 0.01
    # the small leaf sits under the threshold and draws after the big one
    assert torch.equal(p["small"], torch.randn((16, 32), generator=g)
                       * (1 / np.sqrt(16)))
