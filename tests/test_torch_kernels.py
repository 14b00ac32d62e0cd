"""Kernel parity for the PyTorch port (repro_torch.kernels): each kernel's
plain PyTorch version (the CPU path of its wrapper) against the JAX
package's XLA reference and its Pallas kernel in interpret mode, on the
same seeded numpy inputs, with the JAX package's tolerances (1e-4 for
distance_topk float32, 1e-5 for fpf_update, 5e-2 for 16-bit inputs);
rmsnorm, which replaces no Pallas kernel, by its route, its plain version
and its traced call.  The kernels themselves run in
tests/test_torch_cuda.py on a card."""
import contextlib
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.distance_topk.ops import distance_topk as jax_topk  # noqa: E402
from repro.kernels.fpf_update.ops import fpf_update as jax_fpf  # noqa: E402
from repro.kernels.propagate.ops import propagate as jax_prop  # noqa: E402
from repro.kernels.propagate.ref import tie_break_prescale as jax_prescale  # noqa: E402
from repro_torch.kernels.distance_topk.ops import (  # noqa: E402
    PAD_DIST,
    distance_topk,
    distance_topk_route,
)
from repro_torch.kernels.distance_topk.ref import (  # noqa: E402
    distance_topk_ref,
    distance_topk_tc_ref,
    tf32_round,
)
from repro_torch.kernels.fpf_update.ops import fpf_update  # noqa: E402
from repro_torch.kernels.propagate.ops import propagate  # noqa: E402
from repro_torch.kernels.propagate.ref import (  # noqa: E402
    tie_break_prescale,
    tie_break_prescale_pairwise,
)

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


def test_distance_topk_ref_leaves_the_tf32_setting_alone():
    """The plain version computes in full float32 without changing the
    process-wide matmul precision (TF32 on a card) for anyone else."""
    prev = torch.get_float32_matmul_precision()
    x = torch.randn(20, 16, generator=torch.Generator().manual_seed(0))
    try:
        for setting in ("high", "highest", "medium"):
            torch.set_float32_matmul_precision(setting)
            tf32 = torch.backends.cuda.matmul.allow_tf32
            distance_topk_ref(x, x[:5], 3)
            distance_topk_tc_ref(x, x[:5], 3)
            assert torch.get_float32_matmul_precision() == setting
            assert torch.backends.cuda.matmul.allow_tf32 == tf32
    finally:
        torch.set_float32_matmul_precision(prev)


def test_tf32_round_is_cvt_rna():
    """Round to nearest at 10 mantissa bits, ties away from zero, carries
    into the exponent, the low 13 bits cleared."""
    ulp = 2.0 ** -10
    a = torch.tensor([1.0, 1 + ulp / 2, 1 + 1.5 * ulp, -(1 + ulp / 2),
                      1 + ulp / 2 - 2.0 ** -23, 2 - ulp / 2, 0.0, -0.0],
                     dtype=torch.float32)
    want = [1.0, 1 + ulp, 1 + 2 * ulp, -(1 + ulp), 1.0, 2.0, 0.0, -0.0]
    got = tf32_round(a)
    assert got.tolist() == want
    assert torch.signbit(got[-1])
    assert ((got.view(torch.int32) & 0x1FFF) == 0).all()


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n,c,d,k,dtype", [
    (200, 90, 32, 8, "float32"), (130, 37, 16, 5, "float32"),
    (150, 70, 128, 1, "float32"), (97, 64, 24, 8, "bfloat16"),
    (70, 5, 16, 3, "float16"),
])
def test_distance_topk_tc_arithmetic_matches_jax(impl, n, c, d, k, dtype):
    """The tc route's arithmetic (3xTF32 for float32, one exact pass for
    16-bit inputs) against the JAX package at its tolerances."""
    rng = np.random.default_rng(n + c + 1)
    xj, xt = _pair(rng.normal(size=(n, d)), dtype)
    rj, rt = _pair(rng.normal(size=(c, d)), dtype)
    dj, ij = _jax_topk(xj, rj, k, impl)
    dt, it = distance_topk_tc_ref(xt, rt, k)
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=tol, atol=tol)
    gap = np.diff(np.asarray(dj), axis=1)
    clear = np.ones_like(np.asarray(ij), bool)
    clear[:, 1:] &= gap > tol
    clear[:, :-1] &= gap > tol
    np.testing.assert_array_equal(it.numpy()[clear], np.asarray(ij)[clear])


def near_duplicates(n: int, c: int, d: int, seed: int = 0):
    """Records that sit 1e-2 (per dimension) from one of the reps, with an
    offset that puts |x|^2 near 1,000 (near-duplicate video frames): their
    distance to their own rep (~0.013) is what the expanded form cancels."""
    rng = np.random.default_rng(seed)
    reps = rng.normal(size=(c, d)) + 2.7
    x = reps[rng.integers(0, c, n)] + 1e-2 * rng.normal(size=(n, d))
    return x.astype(np.float32), reps.astype(np.float32)


def _err_vs_float64(vals, x, r, k):
    """Largest distance from the float64 top-k distances (direct form)."""
    x64, r64 = torch.from_numpy(x).double(), torch.from_numpy(r).double()
    d64 = ((x64[:, None] - r64[None]) ** 2).sum(-1)
    want = torch.sort(d64, 1).values[:, :k]
    return float((vals.double() - want).abs().max())


def test_distance_topk_tc_arithmetic_near_duplicates():
    """3xTF32 stays within 2x float32's own error against float64 where
    records sit near a rep; single-pass TF32 does not (its witness)."""
    x, r = near_duplicates(2048, 64, 128)
    assert 900 < float((x.astype(np.float64) ** 2).sum(1).mean()) < 1200
    xt, rt = torch.from_numpy(x), torch.from_numpy(r)
    f32 = _err_vs_float64(distance_topk_ref(xt, rt, 8)[0], x, r, 8)
    tc = _err_vs_float64(distance_topk_tc_ref(xt, rt, 8)[0], x, r, 8)
    one = _err_vs_float64(distance_topk_tc_ref(xt, rt, 8, passes=1)[0], x,
                          r, 8)
    assert 0 < f32 < 1e-2
    assert tc <= 2 * f32, (tc, f32)
    assert one > 10 * f32, (one, f32)
    # the JAX package's float32 agrees with the plain float32 there
    dj, _ = distance_topk_jax_xla(x, r, 8)
    assert _err_vs_float64(torch.from_numpy(dj.copy()), x, r, 8) <= 2 * f32


@pytest.mark.parametrize("n,d,k,dtype,route", [
    (1000, 128, 8, torch.float32, "tc"),       # the build and the cracks
    (1000, 128, 1, torch.float32, "tc"),       # max_intra_cluster_dist
    (1000, 128, 5, torch.float32, "tc"),       # a crack with 5 new reps
    (100, 16, 3, torch.float16, "tc"),
    (100, 64, 8, torch.bfloat16, "tc"),
    (100, 8, 8, torch.float32, "tc"),
    (100, 37, 8, torch.float32, "simt"),       # rows of no multiple of 16 B
    (100, 20, 8, torch.bfloat16, "simt"),
    (100, 128, 9, torch.float32, "simt"),      # k past the tc lists
    (100, 128, 32, torch.float32, "simt"),
    (100, 132, 8, torch.float32, "simt"),      # D past the tc tiles
])
def test_distance_topk_route(n, d, k, dtype, route):
    x = torch.zeros(n, d, dtype=dtype)
    assert distance_topk_route(x, x[:50], k) == route


def test_distance_topk_launch_rejects_an_unknown_route():
    from repro_torch.kernels.distance_topk.ops import _launch
    x = torch.zeros(10, 8)
    with pytest.raises(ValueError, match="route"):
        _launch(x, x, 2, "wgmma")


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


@pytest.mark.parametrize("c,kind", [(1, "any"), (2, "equal"), (50, "cents"),
                                    (50, "equal"), (700, "uniform"),
                                    (3000, "uniform"), (3000, "cents")])
def test_tie_break_prescale_pairwise_is_tie_break_prescale(c, kind):
    """The card's pairwise way to the top-1 prescale (its plain version)
    equals tie_break_prescale bit for bit; the JAX package's is the
    witness, at the tolerance of test_tie_break_prescale_matches_jax."""
    rng = np.random.default_rng(c)
    scores = rng.uniform(0, 1, size=c).astype(np.float32)
    if kind == "cents":
        scores = np.round(scores, 2).astype(np.float32)
    elif kind == "equal":
        scores[:] = 0.25
    d2 = rng.uniform(0, 4, size=(300, 8)).astype(np.float32)
    d2[:5, 0] = -1e-3                      # clamped at 0, as on the card
    st, dt = torch.from_numpy(scores), torch.from_numpy(d2)
    got = tie_break_prescale_pairwise(st, dt)
    want = tie_break_prescale(st, dt)
    assert got.dtype == want.dtype == torch.float32
    assert got.view(torch.int32) == want.view(torch.int32), (got, want)
    np.testing.assert_allclose(
        float(got), float(jax_prescale(jnp.asarray(scores), jnp.asarray(d2))),
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
                     "moe_combine", "propagate", "rmsnorm"]
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
    assert [n for n in names if again[n] != after[n]] == ["distance_topk",
                                                          "flash_attention"]
    assert _build._lib_path("flash_attention").name == \
        f"flash_attention-{again['flash_attention']}.so"


def test_launch_counts_lose_no_update_under_threads():
    """Serving threads launch kernels concurrently: the wrappers' counts go
    through one lock, so no increment is lost (16 threads, a switch
    interval of 1 microsecond)."""
    import sys
    import threading
    from repro_torch.kernels import _build

    def counted():
        pass

    counted.launches = 0
    counted.launches_by_path = {"a": 0, "b": 0}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda i=i: [
            _build.count_launch(counted, "ab"[i % 2]) for _ in range(2000)])
            for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert counted.launches == 32000
    assert counted.launches_by_path == {"a": 16000, "b": 16000}


# ---------------------------------------------------------------------------
# rmsnorm: the route, the plain version, the traced call
# ---------------------------------------------------------------------------

def _eager_rmsnorm(x, scale, eps):
    """The eager composition ``models/common.py`` ran before the kernel."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def _fake_cuda(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="cuda")


@pytest.mark.parametrize("device,grad_mode,needs_grad,want", [
    ("cpu", False, "", "plain"),
    ("cpu", True, "x", "plain"),
    ("cuda", False, "", "kernel"),
    ("cuda", True, "", "kernel"),
    ("cuda", False, "x", "kernel"),          # grad mode off: no gradient
    ("cuda", True, "x", "plain"),
    ("cuda", True, "scale", "plain"),
    ("meta", True, "", "kernel"),            # the dry run's traced tensors
    ("meta", True, "x", "plain"),
])
def test_rmsnorm_route(device, grad_mode, needs_grad, want):
    """CPU tensors and inputs that need a gradient take the plain version;
    CUDA tensors (here FakeTensorMode's) and tensors without data take the
    kernel."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_route
    mode = FakeTensorMode() if device == "cuda" else contextlib.nullcontext()
    with mode, torch.set_grad_enabled(grad_mode):
        x = torch.empty(3, 5, 128, dtype=torch.bfloat16, device=device)
        scale = torch.empty(128, dtype=torch.bfloat16, device=device)
        x.requires_grad_(needs_grad == "x")
        scale.requires_grad_(needs_grad == "scale")
        assert rmsnorm_route(x, scale) == want


@pytest.mark.parametrize("d,dtype,scale_d,error", [
    (128, torch.float64, 128, TypeError),    # no float64 kernel
    (100, torch.bfloat16, 100, ValueError),  # 200 B rows: no 16 B chunks
    (128, torch.bfloat16, 64, ValueError),   # scale of another width
    (65544, torch.bfloat16, 65544, ValueError),  # wider than 128 KiB
])
def test_rmsnorm_route_refuses_what_the_kernel_cannot_take(d, dtype, scale_d,
                                                           error):
    """On CUDA there is no fallback: what the kernel cannot take raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_route
    with FakeTensorMode():
        x = _fake_cuda(4, d, dtype=dtype)
        with pytest.raises(error):
            rmsnorm_route(x, _fake_cuda(scale_d, dtype=dtype))


@pytest.mark.parametrize("rows", [1, 7, 4096, "strided"])
@pytest.mark.parametrize("d", [64, 120, 256, 5120])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_ref_is_the_eager_composition(dtype, d, rows):
    """The plain version (``rmsnorm_ref``), and the model's norm on the CPU
    through the route, equal the eager composition bit for bit (a strided view: 7 rows
    of a wider buffer); the CPU wrapper launches nothing."""
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.models import common
    g = torch.Generator().manual_seed(d)
    if rows == "strided":
        x = torch.randn(7, d + 24, generator=g).to(dtype)[:, 8:8 + d]
        assert not x.is_contiguous()
    else:
        x = torch.randn(rows, d, generator=g).to(dtype)
    scale = (1 + 0.1 * torch.randn(d, generator=g)).to(dtype)
    want = _eager_rmsnorm(x, scale, 1e-6)
    before = rms_ops.rmsnorm.launches
    for got in (rmsnorm_ref(x, scale, 1e-6),
                common.rmsnorm({"scale": scale}, x, 1e-6)):
        assert got.dtype == dtype and got.shape == x.shape
        assert torch.equal(got, want)
    assert rms_ops.rmsnorm.launches == before


@pytest.mark.parametrize("device", ["meta", "fake_cuda"])
@pytest.mark.parametrize("shape,dtype", [((2, 9, 5120), torch.bfloat16),
                                         ((4096, 8, 256), torch.float32),
                                         ((3, 11, 4, 128), torch.bfloat16)])
def test_rmsnorm_traced_call_under_the_dry_run(monkeypatch, device, shape,
                                               dtype):
    """On tensors without data, under the dry run's ``Tally``: an output of
    x's shape and dtype, one traced call with its operations and bytes,
    one op's bytes in the tally, nothing built or launched."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import _build
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.launch.dryrun import Tally
    from repro_torch.models import common

    def no_build(*args, **kwargs):
        raise AssertionError("the traced path built or bound a kernel")

    monkeypatch.setattr(_build, "bind", no_build)
    monkeypatch.setattr(_build, "load", no_build)
    before = rms_ops.rmsnorm.launches
    d, item = shape[-1], torch.tensor([], dtype=dtype).element_size()
    rows = int(np.prod(shape[:-1]))
    fake = FakeTensorMode() if device == "fake_cuda" else \
        contextlib.nullcontext()
    dev = "cuda" if device == "fake_cuda" else "meta"
    with fake:
        x = torch.empty(shape, dtype=dtype, device=dev)
        scale = torch.empty(d, dtype=dtype, device=dev)
        with Tally(live=[x, scale]) as tally, \
                _build.trace_kernels() as traced:
            out = common.rmsnorm({"scale": scale}, x, 1e-6)
    assert out.shape == x.shape and out.dtype == dtype
    assert out.device.type == dev
    assert traced == [("rmsnorm", "kernel", 4.0 * rows * d,
                       2 * rows * d * item + d * item)]
    assert tally.bytes == (2 * rows * d + d) * item
    assert rms_ops.rmsnorm.launches == before


_DRYRUN_CELLS = """
import json, sys
from repro_torch.launch import dryrun
from repro_torch.kernels.rmsnorm import ops
keys = ("flops_per_device", "bytes_accessed_per_device", "argument_bytes",
        "peak_memory_bytes", "kernel_launches")
out = {}
for name, arch, shape in (("prefill", "phi3-medium-14b", "prefill_32k"),
                          ("train", "h2o-danube-3-4b", "train_4k")):
    r = dryrun.run_cell(arch, shape, "host", batch=1)
    out[name] = {k: r[k] for k in keys}
ops.rmsnorm_route = lambda x, scale: "plain"
r = dryrun.run_cell("phi3-medium-14b", "prefill_32k", "host", batch=1)
out["prefill_plain"] = {k: r[k] for k in keys}
print(json.dumps(out))
"""


def test_dryrun_phi3_traces_the_kernel_and_its_counts_hold():
    """dryrun_phi3's cell (phi3-medium-14b x prefill_32k at batch 1, one
    process): 81 traced rmsnorm calls (two a layer and the final norm)
    beside 40 tc flash calls; its flops, argument bytes and peak are those
    of the same trace with the plain norm, its bytes accessed lower by
    what the eager passes moved.  The training cell (danube x train_4k,
    the dry run's lm_train) traces no kernel: its norms take the plain
    version by the route."""
    import json
    import os
    import subprocess
    import sys
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    proc = subprocess.run(
        [sys.executable, "-c", _DRYRUN_CELLS], capture_output=True,
        text=True, timeout=240, env={**os.environ, "PYTHONPATH": src,
                                     "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.splitlines()[-1])
    kernel, plain = got["prefill"], got["prefill_plain"]
    assert kernel["kernel_launches"] == {"rmsnorm": {"kernel": 81},
                                         "flash_attention": {"tc": 40}}
    assert plain["kernel_launches"] == {"flash_attention": {"tc": 40}}
    for k in ("flops_per_device", "argument_bytes", "peak_memory_bytes"):
        assert kernel[k] == plain[k], k
    assert kernel["bytes_accessed_per_device"] < \
        plain["bytes_accessed_per_device"]
    assert got["train"]["kernel_launches"] == {}


def test_embedder_training_takes_the_plain_norm():
    """TASTI-T trains the transformer embedder with grad mode on and its
    parameters requiring grad: on tensors without data none of its norms
    reaches the kernel's traced call; under ``torch.no_grad`` (``embed_all``)
    all eight do (two a layer of four)."""
    from repro_torch.core.embedder import Embedder, EmbedderConfig
    from repro_torch.kernels import _build
    model = Embedder(EmbedderConfig(backbone="tasti-embedder"),
                     torch.Generator().manual_seed(0)).to("meta")
    x = torch.empty(16, 64, device="meta")
    with _build.trace_kernels() as traced:
        model(x, attn_impl="plain").sum()
    assert [t for t in traced if t[0] == "rmsnorm"] == []
    with torch.no_grad(), _build.trace_kernels() as traced:
        model(x, attn_impl="plain")
    assert [t[:2] for t in traced] == [("rmsnorm", "kernel")] * 8
