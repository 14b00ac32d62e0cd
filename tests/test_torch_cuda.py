"""The port's CUDA kernels against their plain PyTorch versions on an
NVIDIA GPU: `PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py`
on a machine with a card and nvcc (the first test builds the kernels).
Skipped where torch finds no CUDA device."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.distance_topk.ops import PAD_DIST, distance_topk  # noqa: E402
from repro_torch.kernels.distance_topk.ref import distance_topk_ref  # noqa: E402
from repro_torch.kernels.fpf_update.ops import fpf_update  # noqa: E402
from repro_torch.kernels.fpf_update.ref import fpf_update_ref  # noqa: E402
from repro_torch.kernels.propagate.ops import propagate  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n,c,d,k,dtype", [
    (1000, 300, 128, 8, torch.float32), (333, 70, 37, 5, torch.float32),
    (512, 129, 64, 32, torch.float32), (200, 5, 16, 3, torch.float16),
    (300, 100, 64, 16, torch.bfloat16),
])
def test_distance_topk_kernel_matches_plain(cuda, n, c, d, k, dtype):
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(n, d, device=cuda, generator=g).to(dtype)
    r = torch.randn(c, d, device=cuda, generator=g).to(dtype)
    before = distance_topk.launches
    dk, ik = distance_topk(x, r, k)
    torch.cuda.synchronize()
    assert distance_topk.launches == before + 1
    dp, ip = distance_topk_ref(x, r, k)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(dk, dp, rtol=tol, atol=tol)
    assert torch.isfinite(dk).all() and int(ik.max()) < c
    d_ids = ((x.float()[:, None] - r.float()[ik.long()]) ** 2).sum(-1)
    torch.testing.assert_close(d_ids, dp, rtol=10 * tol, atol=10 * tol)


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
@pytest.mark.parametrize("c", [50, 20000])             # smem and global path
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
