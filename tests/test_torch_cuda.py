"""The port's CUDA kernels against their plain PyTorch versions on an
NVIDIA GPU: `PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py`
on a machine with a card and nvcc (the first test builds the kernels).
Skipped where torch finds no CUDA device."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.distance_topk import ops as topk_ops  # noqa: E402
from repro_torch.kernels.distance_topk.ops import (  # noqa: E402
    PAD_DIST,
    distance_topk,
    distance_topk_route,
)
from repro_torch.kernels.distance_topk.ref import distance_topk_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import allowed_error  # noqa: E402
from repro_torch.kernels.fpf_update.ops import fpf_update  # noqa: E402
from repro_torch.kernels.fpf_update.ref import fpf_update_ref  # noqa: E402
from repro_torch.kernels.propagate import ops as propagate_ops  # noqa: E402
from repro_torch.kernels.propagate.ops import propagate  # noqa: E402
from repro_torch.kernels.propagate.ref import tie_break_prescale  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n,c,d,k,dtype,route", [
    (1000, 300, 128, 8, torch.float32, "simt"),
    (333, 70, 37, 5, torch.float32, "simt"),
    (512, 129, 64, 32, torch.float32, "simt"),
    (200, 5, 16, 3, torch.float16, "simt"),
    (300, 100, 64, 16, torch.bfloat16, "simt"),
    (1000, 300, 128, 8, torch.float32, "tc"),
    (2000, 7001, 128, 8, torch.float32, "tc"),     # C no tile multiple
    (3000, 1000, 128, 8, torch.float32, "tc"),     # a crack's C
    (1000, 700, 128, 1, torch.float32, "tc"),      # k 1
    (777, 37, 128, 5, torch.float32, "tc"),        # one tile, mostly past C
    (513, 70, 40, 8, torch.float32, "tc"),         # D no box multiple
    (200, 5, 16, 3, torch.float16, "tc"),
    (300, 100, 64, 8, torch.bfloat16, "tc"),
    (1000, 300, 128, 8, torch.bfloat16, "tc"),
])
def test_distance_topk_kernel_matches_plain(cuda, n, c, d, k, dtype, route):
    """Each route of the kernel against the plain version (float32 at the
    JAX package's 1e-4; 16-bit inputs at 5e-2), the ids reproducing the
    distances; the route taken is asserted by its launch count."""
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(n, d, device=cuda, generator=g).to(dtype)
    r = torch.randn(c, d, device=cuda, generator=g).to(dtype)
    if route == "tc":
        assert distance_topk_route(x, r, k) == "tc"
    before = distance_topk.launches
    by_path = dict(distance_topk.launches_by_path)
    dk, ik = topk_ops._launch(x, r, k, route)
    torch.cuda.synchronize()
    assert distance_topk.launches == before + 1
    by_path[route] += 1
    assert distance_topk.launches_by_path == by_path
    dp, ip = distance_topk_ref(x, r, k)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(dk, dp, rtol=tol, atol=tol)
    assert torch.isfinite(dk).all()
    assert int(ik.min()) >= 0 and int(ik.max()) < c
    d_ids = ((x.float()[:, None] - r.float()[ik.long()]) ** 2).sum(-1)
    torch.testing.assert_close(d_ids, dp, rtol=10 * tol, atol=10 * tol)


def test_distance_topk_tc_near_duplicates(cuda):
    """Records 1e-2 from their rep at |x|^2 ~ 1,000: the tc route (3xTF32)
    within 2x the plain float32 version's own error against float64."""
    rng = np.random.default_rng(0)
    reps = rng.normal(size=(700, 128)) + 2.7
    x = reps[rng.integers(0, 700, 20000)] + 1e-2 * rng.normal(
        size=(20000, 128))
    xt = torch.as_tensor(x, dtype=torch.float32, device=cuda)
    rt = torch.as_tensor(reps, dtype=torch.float32, device=cuda)
    x64, r64 = xt.double(), rt.double()
    d64 = (x64 * x64).sum(1)[:, None] + (r64 * r64).sum(1)[None] \
        - 2 * x64 @ r64.T
    want = torch.sort(d64, 1).values[:, :8]
    dk, _ = distance_topk(xt, rt, 8)
    dp, _ = distance_topk_ref(xt, rt, 8)
    assert distance_topk_route(xt, rt, 8) == "tc"
    err_tc = float((dk.double() - want).abs().max())
    err_f32 = float((dp.double() - want).abs().max())
    assert 0 < err_f32 and err_tc <= 2 * err_f32, (err_tc, err_f32)


def test_distance_topk_kernel_ties_and_sentinels(cuda):
    x = torch.randn(100, 8, device=cuda)
    r = torch.cat([x[:3], x[:3]])                 # exact duplicate reps
    dk, ik = distance_topk(x, r, 8)
    _, ip = distance_topk_ref(x, r, 6)
    assert torch.equal(ik[:, :6], ip)
    assert (dk[:, 6:] >= PAD_DIST).all()


@pytest.mark.parametrize("n,d", [(1, 4), (1000, 128), (4097, 33)])
def test_fpf_update_kernel_matches_plain(cuda, n, d):
    g = torch.Generator(device=cuda).manual_seed(d)
    x = torch.randn(n, d, device=cuda, generator=g)
    m0 = torch.rand(n, device=cuda, generator=g) * 8
    nm, i, v = fpf_update(x, x[n // 2], m0)
    nr, ir, vr = fpf_update_ref(x, x[n // 2], m0)
    torch.testing.assert_close(nm, nr, rtol=1e-5, atol=1e-5)
    assert abs(float(v) - float(vr)) <= 1e-5 * max(1.0, float(vr))
    assert float(nm[int(i)]) == float(v)
    x2 = torch.zeros(64, 4, device=cuda)
    x2[[9, 40]] = 1.0
    _, i2, _ = fpf_update(x2, torch.zeros(4, device=cuda),
                          torch.full((64,), float("inf"), device=cuda))
    assert int(i2) == 9                               # lowest index on ties


@pytest.mark.parametrize("mode", ["numeric", "top1", "categorical"])
@pytest.mark.parametrize("c", [50, 20000])
def test_propagate_kernel_matches_plain(cuda, mode, c):
    rng = np.random.default_rng(c)
    n, k = 5000, 8
    kw = {"n_classes": 5} if mode == "categorical" else {}
    scores = (rng.integers(0, 5, c) if kw else rng.uniform(0, 1, c))
    ids = torch.as_tensor(rng.integers(0, c, (n, k)), dtype=torch.int32,
                          device=cuda)
    d2 = torch.as_tensor(np.sort(rng.uniform(0, 9, (n, k)), 1),
                         dtype=torch.float32, device=cuda)
    d2[:100, -3:] = PAD_DIST
    s = torch.as_tensor(scores, dtype=torch.float32, device=cuda)
    got = propagate(s, ids, d2, mode, clip01=(mode == "numeric"), **kw)
    want = propagate(s.cpu(), ids.cpu(), d2.cpu(), mode,
                     clip01=(mode == "numeric"), **kw)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["numeric", "top1", "categorical"])
@pytest.mark.parametrize("k", [6, 12])
def test_propagate_kernel_matches_plain_at_any_k(cuda, mode, k):
    """The generic kernel (k other than 8): scalar rows (k 6) and 16-byte
    rows at run time (k 12), against the plain version."""
    rng = np.random.default_rng(k)
    c, n = 3000, 4000
    kw = {"n_classes": 4} if mode == "categorical" else {}
    s = torch.as_tensor(rng.integers(0, 4, c) if kw else rng.uniform(0, 1, c),
                        dtype=torch.float32, device=cuda)
    ids = torch.as_tensor(rng.integers(0, c, (n, k)), dtype=torch.int32,
                          device=cuda)
    d2 = torch.as_tensor(np.sort(rng.uniform(0, 9, (n, k)), 1),
                         dtype=torch.float32, device=cuda)
    d2[:50, -2:] = PAD_DIST
    got = propagate(s, ids, d2, mode, **kw)
    want = propagate(s.cpu(), ids.cpu(), d2.cpu(), mode, **kw)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)


def _device_kernels(fn):
    """Names of the kernels that ``fn()`` launched on the card
    (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()                                             # build, warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "memcpy" not in e.name.lower()
            and "memset" not in e.name.lower()]


@pytest.mark.parametrize("mode,most", [("numeric", 1), ("categorical", 1),
                                       ("top1", 2)])
def test_propagate_kernel_launches_per_call(cuda, mode, most):
    """Numeric and categorical are one launch a call; top1 at most two
    (its prescale on the card, no host sync)."""
    rng = np.random.default_rng(7)
    c, n, k = 7000, 100000, 8
    kw = {"n_classes": 5} if mode == "categorical" else {}
    s = torch.as_tensor(rng.integers(0, 5, c) if kw else rng.uniform(0, 1, c),
                        dtype=torch.float32, device=cuda)
    ids = torch.as_tensor(rng.integers(0, c, (n, k)), dtype=torch.int32,
                          device=cuda)
    d2 = torch.as_tensor(np.sort(rng.uniform(0, 9, (n, k)), 1),
                         dtype=torch.float32, device=cuda)
    names = _device_kernels(lambda: propagate(s, ids, d2, mode, **kw))
    assert 1 <= len(names) <= most, names


@pytest.mark.parametrize("c", [50, 7000, 20000, 40000])
def test_propagate_top1_prescale_is_tie_break_prescale(cuda, c):
    """The top1 prescale computed on the card equals tie_break_prescale bit
    for bit (read back as -out[0]: row 0's nearest rep scores 0 at distance
    1); above PAIRWISE_MAX_C the plain version computes it, counted."""
    rng = np.random.default_rng(c)
    n, k = 5000, 8
    scores = np.round(rng.uniform(0, 1, c), 3)
    scores[0] = 0.0
    s = torch.as_tensor(scores, dtype=torch.float32, device=cuda)
    ids = torch.as_tensor(rng.integers(0, c, (n, k)), dtype=torch.int32,
                          device=cuda)
    d2 = torch.as_tensor(np.sort(rng.uniform(0, 9, (n, k)), 1),
                         dtype=torch.float32, device=cuda)
    ids[0, 0], d2[0, 0] = 0, 1.0
    plain = propagate.plain_prescales
    out = propagate(s, ids, d2, "top1")
    want = tie_break_prescale(s, d2)
    got = -out[0]
    assert got.view(torch.int32) == want.view(torch.int32), (got, want)
    assert propagate.plain_prescales == plain + (
        c > propagate_ops.PAIRWISE_MAX_C)


def _assert_attention_close(got, q, k, v, causal, window, path):
    """Element by element within ``ref.allowed_error``: float32 at the JAX
    package's kernel-test tolerance, 2e-3 (tests/test_kernels.py); bf16 at a
    few bf16 ulps (rtol 1.6e-2) with atol 2e-3 (both routes round once to
    bf16), and on the tc path, which also rounds P to bf16 before P.V as the
    JAX package's XLA attention does, each element further by up to twice
    what that rounding alone moves it in the witness."""
    want, allowed = allowed_error(q, k, v, causal, window,
                                  round_p=path == "tc")
    diff = (got.float() - want).abs()
    outside = int((diff > allowed).sum())
    assert outside == 0, (outside, float(diff.max()))


@pytest.mark.parametrize("b,s,skv,h,hk,hd,causal,window,dtype,path", [
    (1, 1024, 1024, 32, 8, 120, True, 256, torch.bfloat16, "tc"),  # danube
    (2, 96, 96, 8, 2, 80, True, 0, torch.bfloat16, "tc"),       # ragged S
    (1, 130, 130, 2, 1, 128, False, 40, torch.bfloat16, "tc"),  # window only
    (2, 300, 200, 8, 8, 64, False, 0, torch.bfloat16, "tc"),    # GQA 1, Skv<S
    (1, 257, 513, 16, 4, 128, True, 0, torch.bfloat16, "tc"),   # GQA 4, Skv>S
    (1, 200, 50, 8, 2, 64, True, 30, torch.bfloat16, "tc"),     # rows, no key
    (1, 160, 160, 4, 2, 32, True, 0, torch.bfloat16, "tc"),     # hd < 64
    (512, 8, 8, 4, 4, 64, False, 0, torch.float32, "short"),    # embedder
    (300, 1, 1, 4, 4, 64, False, 0, torch.float32, "short"),    # S = 1
    (300, 1, 1, 4, 4, 64, False, 0, torch.bfloat16, "short"),
    (100, 8, 8, 4, 4, 64, False, 0, torch.bfloat16, "short"),
    (64, 32, 32, 4, 2, 64, True, 0, torch.bfloat16, "short"),   # S = 32, GQA
    (64, 32, 32, 2, 1, 64, True, 0, torch.float32, "short"),
    (33, 20, 24, 6, 3, 40, True, 5, torch.float32, "short"),    # window
    (33, 24, 20, 6, 3, 40, False, 3, torch.bfloat16, "short"),  # rows, no key
    (2, 1000, 1000, 8, 2, 64, True, 0, torch.float32, "simt"),  # ragged S
    (1, 64, 192, 4, 2, 64, False, 0, torch.float32, "simt"),    # S != Skv
    (1, 200, 50, 4, 2, 32, True, 30, torch.float32, "simt"),    # rows, no key
    (1, 100, 100, 4, 2, 60, True, 0, torch.bfloat16, "simt"),   # hd % 8 != 0
])
def test_flash_attention_kernel_matches_plain(cuda, b, s, skv, h, hk, hd,
                                              causal, window, dtype, path):
    """Each path of the kernel on the inputs it takes, against the plain
    version (``_assert_attention_close``)."""
    from repro_torch.kernels.flash_attention.ops import flash_route
    g = torch.Generator(device=cuda).manual_seed(s + hd)
    q = torch.randn(b, s, h, hd, device=cuda, generator=g).to(dtype)
    k = torch.randn(b, skv, hk, hd, device=cuda, generator=g).to(dtype)
    v = torch.randn(b, skv, hk, hd, device=cuda, generator=g).to(dtype)
    assert flash_route(q, k) == path
    before = flash_attention.launches
    by_path = dict(flash_attention.launches_by_path)
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    by_path[path] += 1
    assert flash_attention.launches_by_path == by_path
    assert got.dtype == dtype and got.shape == q.shape
    _assert_attention_close(got, q, k, v, causal, window, path)


def test_flash_attention_kernel_takes_unaligned_views(cuda):
    """A view at an address that is no multiple of 16 bytes is copied to
    one that is before the tc and short paths read it."""
    g = torch.Generator(device=cuda).manual_seed(0)
    for s, path in ((200, "tc"), (8, "short")):
        buf = torch.randn(2 * s * 4 * 64 + 1, device=cuda,
                          generator=g).bfloat16()
        q = buf[1:].view(2, s, 4, 64)
        assert q.data_ptr() % 16 != 0
        got = flash_attention(q, q, q, causal=True)
        _assert_attention_close(got, q, q, q, True, 0, path)


def test_flash_attention_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.zeros(1, 8, 2, 160, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    with pytest.raises(TypeError, match="dtype"):
        flash_attention(q[..., :64], q[..., :64].half(), q[..., :64])
    half = q[..., :64].half()
    with pytest.raises(TypeError, match="float32/bfloat16"):
        flash_attention(half, half, half)


# ---------------------------------------------------------------------------
# training: no kernel cuts a gradient; the card trains as the CPU does
# ---------------------------------------------------------------------------

def _kernel_calls(dev):
    x = torch.randn(64, 16, device=dev)
    ids = torch.zeros(64, 4, dtype=torch.int32, device=dev)
    q = torch.randn(1, 8, 2, 64, device=dev)
    return {
        "distance_topk": (lambda t: distance_topk(t, x[:8], 4), x),
        "fpf_update": (lambda t: fpf_update(t, x[0], torch.full(
            (64,), float("inf"), device=dev)), x),
        "propagate": (lambda t: propagate(t, ids, torch.ones(64, 4,
                                                             device=dev),
                                          "numeric"), torch.ones(8, device=dev)),
        "flash_attention": (lambda t: flash_attention(t, q, q), q),
    }


@pytest.mark.parametrize("name", ["distance_topk", "fpf_update", "propagate",
                                  "flash_attention"])
def test_kernel_refuses_an_input_that_requires_grad(cuda, name):
    """A kernel's output has no grad_fn: under grad mode an input that
    requires grad raises instead of cutting the gradient; under no_grad,
    or with no such input, the kernel launches."""
    call, arg = _kernel_calls(cuda)[name]
    with pytest.raises(RuntimeError, match="no backward.*plain route"):
        call(arg.clone().requires_grad_(True))
    with torch.no_grad():
        call(arg.clone().requires_grad_(True))
    call(arg)
    torch.cuda.synchronize()


@pytest.mark.parametrize("backbone", ["mlp", "tasti-embedder"])
def test_train_embedder_step_on_the_card_matches_the_cpu(cuda, backbone):
    """One train_embedder step and one pretrain_embedder step from the same
    weights on the same batch: the card (float32, TF32 off) against the
    CPU's plain path, weights to rtol 1e-5 with atol 1e-5, a fifth of the
    first triplet step (lr 1e-3 / 20 warm-up steps), for the few weights
    whose gradient lies near Adam's eps.  The MLP's last bias has a zero
    gradient under the triplet loss (it shifts every embedding alike):
    noise that Adam's normalised step moves by up to lr, so it is held to
    2 x lr."""
    from repro_torch.core import baselines, triplet
    from repro_torch.core.embedder import Embedder, EmbedderConfig
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rng = np.random.default_rng(0)
        feats = rng.normal(size=(200, 64)).astype(np.float32)
        triples = rng.integers(0, 200, size=(500, 3)).astype(np.int32)
        cfg = EmbedderConfig(feature_dim=64, embed_dim=32, backbone=backbone)
        init = Embedder(cfg, torch.Generator().manual_seed(1)).state_dict()
        out = {}
        for dev in ("cpu", cuda):
            model = Embedder(cfg)
            model.load_state_dict(init)
            model.to(dev)
            _, hist = triplet.train_embedder(
                model, feats, triples, triplet.TripletConfig(steps=1,
                                                             batch=64))
            pre = baselines.pretrain_embedder(
                feats, cfg, steps=1, seed=2, device=dev, encoder_init=init)
            out[str(dev)] = (hist, {k: v.cpu() for k, v in
                                    model.state_dict().items()},
                             {k: v.cpu() for k, v in
                              pre.state_dict().items()})
        (h0, w0, p0), (h1, w1, p1) = out.values()
        assert h1 == pytest.approx(h0, rel=1e-5)
        for a, b in ((w0, w1), (p0, p1)):
            for k in a:
                if a is w0 and k == "layers.2.bias":
                    assert float((b[k] - a[k]).abs().max()) <= 2 * 1e-3 / 20
                    continue
                torch.testing.assert_close(b[k], a[k], rtol=1e-5, atol=1e-5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def test_bfloat16_embedding_gradient_sums_in_float32_on_the_card(cuda):
    """The card's backward of the bfloat16 embedding lookup (CUDA's
    index_add_ into a float32 buffer) is within one bf16 rounding (2^-8
    relative) of the exact sum, as on the CPU
    (tests/test_torch_lm_train.py)."""
    from repro_torch.models import lm
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(50, 8, generator=gen).bfloat16()
    tokens = torch.randint(0, 3, (2, 2048), generator=gen)
    g_out = (torch.randn(2, 2048, 8, generator=gen) * 1e-3).bfloat16()
    exact = torch.zeros(50, 8, dtype=torch.float64).index_add_(
        0, tokens.reshape(-1), g_out.reshape(-1, 8).double())
    table_dev = table.to(cuda).requires_grad_()
    with torch.enable_grad():
        out = lm._embed_tokens({"embed": table_dev}, tokens.to(cuda))
        (got,) = torch.autograd.grad(out, table_dev, g_out.to(cuda))
    torch.testing.assert_close(out.cpu(), table[tokens], rtol=0, atol=0)
    assert got.dtype == torch.bfloat16 and got.device.type == "cuda"
    assert float((got.cpu().double() - exact).norm() / exact.norm()) \
        <= 2 ** -8


def test_distance_topk_ref_leaves_the_tf32_setting_alone_on_the_card(cuda):
    """On CUDA tensors the plain version computes in full float32 and puts
    the process-wide matmul precision (and allow_tf32) back as it found
    it, whatever that was."""
    from repro_torch.kernels.distance_topk.ref import distance_topk_tc_ref
    prev = torch.get_float32_matmul_precision()
    x = torch.randn(300, 64, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(0))
    x64 = x.double().cpu()
    exact = torch.cdist(x64, x64[:40]).square().topk(3, largest=False).values
    try:
        for setting in ("high", "highest", "medium"):
            torch.set_float32_matmul_precision(setting)
            tf32 = torch.backends.cuda.matmul.allow_tf32
            d2, ids = distance_topk_ref(x, x[:40], 3)
            distance_topk_tc_ref(x, x[:40], 3)
            assert torch.get_float32_matmul_precision() == setting
            assert torch.backends.cuda.matmul.allow_tf32 == tf32
            torch.testing.assert_close(d2.cpu().double(), exact,
                                       rtol=1e-4, atol=1e-4)
    finally:
        torch.set_float32_matmul_precision(prev)


def test_served_proxies_on_the_card_match_the_host(cuda, tmp_path):
    """A port QueryServer over a CUDA index: its sessions' proxies go
    through the resident propagate kernel (device computes, no fallback
    without a crack), a warm restart costs 0 fresh calls, and the proxy
    equals the float64 host propagation (rtol 1e-5, atol 1e-6)."""
    from repro_torch.core import propagation
    from repro_torch.core.engine import QueryEngine
    from repro_torch.core.index import TastiIndex
    from repro_torch.core.schema import make_workload
    from repro_torch.serve import LabelStore, QueryClient, QueryServer
    wl = make_workload("night-street", n_frames=3000)
    index = TastiIndex.build(wl.features, 200, wl.target_dnn_batch, k=8,
                             device=cuda)
    stem = str(tmp_path / "idx")
    index.save(stem)
    specs = [{"kind": "aggregation", "score": "score_count", "err": 0.1},
             {"kind": "selection", "score": "score_has_object",
              "budget": 100}]
    fresh = []
    for _ in range(2):
        idx = TastiIndex.load(stem, device="cuda")
        store = LabelStore.for_index(stem, idx)
        eng = QueryEngine(idx, wl)
        store.attach(eng.broker, eng)
        assert eng.resident.enabled
        srv = QueryServer(eng, port=0, admission_window=0.0,
                          store=store).start()
        try:
            out = QueryClient(srv.url).query(specs)
            fresh.append(out["request"]["fresh"])
        finally:
            srv.shutdown()
        assert eng.resident.stats["computes"] > 0
        assert eng.resident.stats["fallbacks"] == 0
        assert eng.stats["proxy_device_computes"] == \
            eng.resident.stats["computes"]
    assert fresh[0] > 0 and fresh[1] == 0
    want = propagation.propagate_numeric(idx.rep_scores(wl.score_count),
                                         idx.topk_ids, idx.topk_d2)
    np.testing.assert_allclose(eng.proxy_scores("score_count"), want,
                               rtol=1e-5, atol=1e-6)
