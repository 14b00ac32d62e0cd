"""Kernel parity for the PyTorch port (repro_torch.kernels): each kernel's
plain PyTorch version (the CPU path of its wrapper) against the JAX
package's XLA reference and its Pallas kernel in interpret mode, on the
same seeded numpy inputs, with the JAX package's tolerances (1e-4 for
distance_topk float32, 1e-5 for fpf_update, 5e-2 for 16-bit inputs).
The kernels themselves run in tests/test_torch_cuda.py on a card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.distance_topk.ops import distance_topk as jax_topk  # noqa: E402
from repro.kernels.fpf_update.ops import fpf_update as jax_fpf  # noqa: E402
from repro.kernels.propagate.ops import propagate as jax_prop  # noqa: E402
from repro.kernels.propagate.ref import tie_break_prescale as jax_prescale  # noqa: E402
from repro_torch.kernels.distance_topk.ops import PAD_DIST, distance_topk  # noqa: E402
from repro_torch.kernels.fpf_update.ops import fpf_update  # noqa: E402
from repro_torch.kernels.propagate.ops import propagate  # noqa: E402
from repro_torch.kernels.propagate.ref import tie_break_prescale  # noqa: E402

pytestmark = pytest.mark.tier1

_JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
           "float16": jnp.float16}
_TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "float16": torch.float16}
IMPLS = ("xla", "pallas")


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a CPU tensor of ``dtype``."""
    j = jnp.asarray(a.astype(np.float32)).astype(_JAX_DT[dtype])
    t = torch.from_numpy(a.astype(np.float32)).to(_TORCH_DT[dtype])
    return j, t


def _jax_topk(x, r, k, impl):
    return jax_topk(x, r, k, impl=impl, interpret=(impl == "pallas"),
                    block_n=64, block_c=64)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n,c,d,k,dtype", [
    (200, 90, 32, 8, "float32"), (130, 37, 16, 5, "float32"),
    (97, 64, 24, 16, "bfloat16"), (70, 5, 16, 3, "float16"),
])
def test_distance_topk_matches_jax(impl, n, c, d, k, dtype):
    rng = np.random.default_rng(n + c)
    xj, xt = _pair(rng.normal(size=(n, d)), dtype)
    rj, rt = _pair(rng.normal(size=(c, d)), dtype)
    dj, ij = _jax_topk(xj, rj, k, impl)
    dt, it = distance_topk(xt, rt, k)
    assert dt.dtype == torch.float32 and it.dtype == torch.int32
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=tol, atol=tol)
    assert np.isfinite(dt.numpy()).all()
    # ids agree wherever the distances are not near-tied
    gap = np.diff(np.asarray(dj), axis=1)
    clear = np.ones_like(np.asarray(ij), bool)
    clear[:, 1:] &= gap > tol
    clear[:, :-1] &= gap > tol
    np.testing.assert_array_equal(it.numpy()[clear], np.asarray(ij)[clear])


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n_reps,k", [(3, 8), (1, 4), (5, 16)])
def test_distance_topk_pad_columns_are_sentinels(impl, n_reps, k):
    rng = np.random.default_rng(n_reps * 10 + k)
    xj, xt = _pair(rng.normal(size=(97, 24)), "float32")
    rj, rt = _pair(rng.normal(size=(n_reps, 24)), "float32")
    dj, ij = _jax_topk(xj, rj, k, impl)
    dt, it = distance_topk(xt, rt, k)
    assert dt.shape == (97, k) and it.shape == (97, k)
    assert np.all(dt.numpy()[:, n_reps:] >= PAD_DIST)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(it.numpy()[:, n_reps:],
                                  np.asarray(ij)[:, n_reps:])


def test_distance_topk_repless_and_ties():
    """No reps: every column is a sentinel with id 0.  Duplicate reps tie
    exactly: the lower id comes first, as lax.top_k orders them."""
    x = torch.randn(6, 4, generator=torch.Generator().manual_seed(0))
    d, i = distance_topk(x, torch.empty(0, 4), 3)
    assert (d >= PAD_DIST).all() and (i == 0).all()
    r = torch.cat([x[:2], x[:2]])                 # reps 0,1 == reps 2,3
    d, i = distance_topk(x, r, 4)
    dj, ij = distance_topk_jax_xla(x.numpy(), r.numpy(), 4)
    np.testing.assert_array_equal(i.numpy(), ij)
    np.testing.assert_allclose(d.numpy(), dj, rtol=1e-5, atol=1e-5)


def distance_topk_jax_xla(x, r, k):
    d, i = jax_topk(jnp.asarray(x), jnp.asarray(r), k, impl="xla")
    return np.asarray(d), np.asarray(i)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n,d,dtype", [(512, 64, "float32"),
                                       (130, 32, "float32"),
                                       (300, 24, "bfloat16")])
def test_fpf_update_matches_jax(impl, n, d, dtype):
    rng = np.random.default_rng(n)
    xj, xt = _pair(rng.normal(size=(n, d)), dtype)
    rj, rt = _pair(rng.normal(size=(d,)), dtype)
    m0 = rng.uniform(0.5, 8, size=(n,)).astype(np.float32)
    nm_j, i_j, v_j = jax_fpf(xj, rj, jnp.asarray(m0), impl=impl,
                             interpret=(impl == "pallas"), block_n=128)
    nm_t, i_t, v_t = fpf_update(xt, rt, torch.from_numpy(m0))
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(nm_t.numpy(), np.asarray(nm_j), rtol=tol,
                               atol=tol)
    assert i_t.dtype == torch.int32 and i_t.shape == ()
    assert abs(float(v_t) - float(v_j)) < max(tol, 1e-4)
    assert int(i_t) == int(i_j)
    assert float(nm_t[int(i_t)]) == float(v_t)


def test_fpf_update_first_index_on_ties():
    x = torch.zeros(8, 4)
    x[[2, 5]] = 1.0                               # two equal maxima
    nm, i, v = fpf_update(x, torch.zeros(4), torch.full((8,), float("inf")))
    _, ij, _ = jax_fpf(jnp.asarray(x.numpy()), jnp.zeros(4),
                       jnp.full((8,), np.inf, jnp.float32), impl="xla")
    assert int(i) == int(ij) == 2 and float(v) == 4.0


def _instance(seed, n_classes=None, pad_cols=0):
    rng = np.random.default_rng(seed)
    c = int(rng.integers(3, 40))
    n = int(rng.integers(5, 300))
    k = int(rng.integers(1, min(c, 8) + 1)) + pad_cols
    if n_classes is None:
        scores = rng.uniform(-0.2, 1.2, size=c)
    else:
        scores = rng.integers(0, n_classes, size=c).astype(np.float64)
    ids = rng.integers(0, c, size=(n, k)).astype(np.int32)
    d2 = np.sort(rng.uniform(0.0, 9.0, size=(n, k)), axis=1).astype(np.float32)
    if pad_cols:
        d2[:, -pad_cols:] = PAD_DIST
    return scores, ids, d2


def _both(scores, ids, d2, mode, impl, **kw):
    want = jax_prop(jnp.asarray(scores, jnp.float32), jnp.asarray(ids),
                    jnp.asarray(d2), mode, impl=impl,
                    interpret=(impl == "pallas"), block_n=128, donate=False,
                    **kw)
    got = propagate(torch.from_numpy(scores).float(), torch.from_numpy(ids),
                    torch.from_numpy(d2), mode, **kw)
    assert got.dtype == torch.float32
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("seed,pad_cols", [(0, 0), (1, 0), (2, 2), (3, 3)])
@pytest.mark.parametrize("clip01", [False, True])
def test_propagate_numeric_and_top1_match_jax(impl, seed, pad_cols, clip01):
    scores, ids, d2 = _instance(seed, pad_cols=pad_cols)
    for mode in ("numeric", "top1"):
        got, want = _both(scores, ids, d2, mode, impl, clip01=clip01)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("seed,pad_cols", [(0, 0), (4, 0), (5, 2)])
def test_propagate_categorical_matches_jax(impl, seed, pad_cols):
    n_classes = int(np.random.default_rng(seed + 500).integers(2, 9))
    scores, ids, d2 = _instance(seed, n_classes=n_classes, pad_cols=pad_cols)
    got, want = _both(scores, ids, d2, "categorical", impl,
                      n_classes=n_classes)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["numeric", "top1", "categorical"])
def test_propagate_one_rep_and_empty_index(mode):
    kw = {"n_classes": 3} if mode == "categorical" else {}
    ids = np.zeros((7, 4), np.int32)
    d2 = np.full((7, 4), PAD_DIST, np.float32)
    d2[:, 0] = np.arange(7, dtype=np.float32)
    scores = np.array([2.0])
    got, want = _both(scores, ids, d2, mode, "xla", **kw)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    empty = propagate(torch.zeros(0), torch.zeros((0, 4), dtype=torch.int32),
                      torch.zeros((0, 4)), mode, **kw)
    assert empty.shape == (0,)


def test_tie_break_prescale_matches_jax():
    rng = np.random.default_rng(3)
    scores = np.round(rng.uniform(0, 1, size=50), 2).astype(np.float32)
    d2 = rng.uniform(0, 4, size=(200, 4)).astype(np.float32)
    got = tie_break_prescale(torch.from_numpy(scores), torch.from_numpy(d2))
    want = jax_prescale(jnp.asarray(scores), jnp.asarray(d2))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    one = tie_break_prescale(torch.ones(1), torch.from_numpy(d2))
    np.testing.assert_allclose(
        float(one), float(jax_prescale(jnp.ones(1), jnp.asarray(d2))),
        rtol=1e-6)


# ---------------------------------------------------------------------------
# the kernels' build: one library per source, keyed by its own inputs
# ---------------------------------------------------------------------------

def test_each_kernel_library_hashes_its_own_source_and_headers(tmp_path,
                                                               monkeypatch):
    """Editing one source changes that library's hash alone; editing a
    header changes the hash of every source that includes it."""
    import shutil

    from repro_torch.kernels import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    names = sorted(p.stem for p in csrc.glob("*.cu"))
    assert names == ["distance_topk", "flash_attention", "fpf_update",
                     "propagate"]
    assert [p.name for p in _build._includes(csrc / "flash_attention.cu")] \
        == ["common.cuh", "hopper.cuh"]
    before = {n: _build.source_hash(n) for n in names}
    assert len(set(before.values())) == len(names)
    with open(csrc / "propagate.cu", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build.source_hash(n) for n in names}
    assert [n for n in names if after[n] != before[n]] == ["propagate"]
    with open(csrc / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    again = {n: _build.source_hash(n) for n in names}
    assert [n for n in names if again[n] != after[n]] == ["flash_attention"]
    assert _build._lib_path("flash_attention").name == \
        f"flash_attention-{again['flash_attention']}.so"
