"""The dropless MoE's combine (``kernels/moe_combine``) on the CPU: the
route, the wrapper's checks, the plain version bit for bit against the
composition the dropless MoE ran before it, the inverse of the sort's
order, and the kernel's own arithmetic within the bound of a reordered
sum.  The ``moe.forward`` span's ``combine`` is held in
``tests/test_torch_olmoe.py``, the kernel itself on the card
(``tests/test_torch_cuda.py``)."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.moe_combine import ops  # noqa: E402
from repro_torch.kernels.moe_combine.ops import (  # noqa: E402
    moe_combine,
    moe_combine_route,
)
from repro_torch.kernels.moe_combine.ref import (  # noqa: E402
    allowed_error,
    combine_in_choice_order,
    moe_combine_ref,
    positions_ref,
)


def _case(tokens=64, k=4, experts=8, d=64, dtype=torch.bfloat16, seed=0,
          empty=(3,)):
    """(y, order, weights, top_idx): a seeded routing of ``tokens`` tokens
    to ``k`` of ``experts`` experts, none of them to the experts in
    ``empty``, sorted by expert as the dropless MoE sorts them, and rows
    y (T k, d) in expert order."""
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(tokens, experts, generator=g)
    logits[:, list(empty)] = -1e9
    top_idx = torch.sort(logits, dim=-1, descending=True, stable=True).indices[
        :, :k]
    weights = torch.softmax(logits, -1).gather(-1, top_idx)
    _, order = torch.sort(top_idx.reshape(-1), stable=True)
    y = torch.randn(tokens * k, d, generator=g).to(dtype)
    return y, order, weights, top_idx


def _composition(y, order, weights, k):
    """The dropless MoE's combine before the kernel, as it stood in
    ``models/moe.py``."""
    token_of = order // k
    scaled = y * weights.reshape(-1).index_select(0, order)[:, None]
    out = torch.zeros((weights.shape[0], y.shape[1]), dtype=torch.float32)
    out.index_add_(0, token_of, scaled)
    return out.to(y.dtype)


def test_route_takes_the_plain_version_on_the_cpu_and_for_gradients():
    y, order, weights, _ = _case()
    assert moe_combine_route(y, order, weights) == "plain"
    assert moe_combine_route(y.float().requires_grad_(), order,
                             weights) == "plain"
    with pytest.raises(ValueError, match="no moe_combine for device meta"):
        moe_combine_route(y.to("meta"), order.to("meta"),
                          weights.to("meta"))
    assert moe_combine_route(y, order, weights.requires_grad_()) == "plain"


@pytest.mark.parametrize("change,error,match", [
    (lambda y, o, w: (y.to(torch.float64), o, w), TypeError, "float32"),
    (lambda y, o, w: (y, o, w.to(torch.bfloat16)), TypeError, "weights"),
    (lambda y, o, w: (y, o.int(), w), TypeError, "int64"),
    (lambda y, o, w: (y[:-1], o, w), ValueError, "rows"),
    (lambda y, o, w: (y, o[:-1], w), ValueError, "order"),
    (lambda y, o, w: (y, o, w[:-1]), ValueError, "weights"),
    (lambda y, o, w: (y[:, :60], o, w), ValueError, "16 bytes"),
    (lambda y, o, w: (y.reshape(-1, 8, 8), o, w), ValueError, "rows"),
    (lambda y, o, w: (y[:2 * (ops.MAX_K + 1)], o[:2 * (ops.MAX_K + 1)],
                      torch.ones(2, ops.MAX_K + 1)), ValueError, "choices"),
])
def test_check_raises_for_what_the_kernel_cannot_take(change, error, match):
    y, order, weights, _ = _case(k=ops.MAX_K, experts=64, tokens=8,
                                 empty=())
    ops._check(y, order, weights)
    with pytest.raises(error, match=match):
        ops._check(*change(y, order, weights))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("k", [1, 2, 8])
def test_plain_version_is_the_old_composition_bit_for_bit(dtype, k):
    """An expert with no rows among them; the output in y's dtype."""
    y, order, weights, top_idx = _case(k=k, experts=16, dtype=dtype, seed=k)
    assert 3 not in top_idx
    got = moe_combine(y, order, weights)
    assert got.dtype == dtype and got.shape == (64, 64)
    assert torch.equal(got, _composition(y, order, weights, k))
    assert torch.equal(moe_combine_ref(y, order, weights), got)


def test_no_tokens():
    y, order, weights, _ = _case(tokens=0)
    assert moe_combine(y, order, weights).shape == (0, 64)


@pytest.mark.parametrize("tokens,k", [(1, 8), (64, 4), (333, 8)])
def test_positions_are_the_inverse_of_the_order(tokens, k):
    _, order, _, _ = _case(tokens=tokens, k=k, experts=16)
    pos = positions_ref(order)
    n = tokens * k
    assert pos.dtype == torch.int32
    assert torch.equal(order[pos.long()], torch.arange(n))
    assert torch.equal(pos[order].long(), torch.arange(n))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_choice_order_sum_lies_within_a_reordered_sums_bound(dtype):
    """The kernel's arithmetic against the plain version: the same rounded
    products, added in another order, so each element within
    ``allowed_error`` and, rounded to bf16, nearly every one equal bit for
    bit (in float32 the order shows in the last bits of about half); with
    one choice a token there is no order, and they are equal."""
    y, order, weights, _ = _case(tokens=512, k=8, experts=64, d=256,
                                 dtype=dtype, empty=())
    pos = positions_ref(order)
    got = combine_in_choice_order(y, pos, weights)
    want = moe_combine_ref(y, order, weights)
    err = (got.float() - want.float()).abs()
    assert bool((err <= allowed_error(y, pos, weights, got, want)).all())
    if dtype == torch.bfloat16:
        assert float((got == want).float().mean()) >= 0.99
    y1, order1, weights1, _ = _case(k=1, dtype=dtype)
    assert torch.equal(
        combine_in_choice_order(y1, positions_ref(order1), weights1),
        moe_combine_ref(y1, order1, weights1))
