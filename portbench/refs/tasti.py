"""Plain reference of a TASTI-PT index build, and the judges of a build's
outputs.

``embed`` is the transformer embedder's forward (features split into
tokens, projected, pre-norm blocks of RMSNorm, bidirectional multi-head
attention and a SwiGLU MLP, mean-pooled, projected), written from the
weights' names alone.  The judges take a build's outputs and hold them to
what the reference computes, in float64 from the reference's embeddings:

* ``fpf_gap``: each furthest-point pick against the earlier picks; a pick
  may lie below the furthest record by a share of that distance (ties
  allowed), nothing more;
* ``random_picks``: the start and the random tenth of the
  representatives, as numpy's generator draws them from the build's seed;
* ``topk``: each record's k ids among the representatives and their
  squared distances.

``build`` is the reference put in the program's place, at a precision
(the control).  Nothing here imports the program.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from portbench.refs.precision import ein, exact_float32, mm

#: rows of the embedder's forward and of the judges' distance blocks
EMBED_ROWS = 65536
JUDGE_BYTES = 1 << 30


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.float()


@torch.no_grad()
def embed(state: Dict[str, torch.Tensor], features: torch.Tensor, e: dict,
          precision: str = "float32") -> torch.Tensor:
    """(N, embed_dim) float32 embeddings of ``features`` (N, F)."""
    p = {k.replace("params.", "", 1): v for k, v in state.items()}
    b = "blocks.0."
    s, h, hk, hd = e["seq_tokens"], e["n_heads"], e["n_kv_heads"], e["head_dim"]
    g = h // hk
    outs = []
    with exact_float32():
        for r0 in range(0, features.shape[0], EMBED_ROWS):
            x = features[r0:r0 + EMBED_ROWS].float()
            n = x.shape[0]
            hid = mm(x.reshape(n, s, -1), p["proj_in"], precision)
            for layer in range(e["n_layers"]):
                def w(name):
                    return p[b + name][layer]
                a = rmsnorm(hid, w("norm1.scale"), e["norm_eps"])
                q = mm(a, w("attn.wq"), precision).reshape(n, s, hk, g, hd)
                k = mm(a, w("attn.wk"), precision).reshape(n, s, hk, hd)
                v = mm(a, w("attn.wv"), precision).reshape(n, s, hk, hd)
                sc = ein("nqkgd,ntkd->nkgqt", q, k, precision) / math.sqrt(hd)
                pr = torch.softmax(sc, dim=-1)
                o = ein("nkgqt,ntkd->nqkgd", pr, v, precision)
                hid = hid + mm(o.reshape(n, s, h * hd), w("attn.wo"),
                               precision)
                a = rmsnorm(hid, w("norm2.scale"), e["norm_eps"])
                gate = mm(a, w("mlp.wi_gate"), precision)
                up = mm(a, w("mlp.wi_up"), precision)
                hid = hid + mm(torch.nn.functional.silu(gate) * up,
                               w("mlp.wo"), precision)
            outs.append(mm(hid.mean(1), p["proj_out"], precision))
    return torch.cat(outs)


def _rows(n_cols: int) -> int:
    return max(1, JUDGE_BYTES // (8 * max(n_cols, 1)))


def _sqdist(x: torch.Tensor, c: torch.Tensor, csq: torch.Tensor):
    """Squared distances (rows, C) in float64."""
    d = (x * x).sum(1)[:, None] + csq[None] - 2.0 * (x @ c.T)
    return d.clamp_min_(0.0)


@torch.no_grad()
def fpf_gap(emb: torch.Tensor, picks: np.ndarray) -> float:
    """The largest share by which a furthest-point pick t lies nearer to
    picks 0..t-1 than the furthest record does: 0 for an exact pick (or a
    tie), 1 for a repeated one, inf for an id out of range."""
    n = emb.shape[0]
    if len(picks) < 2:
        return 0.0
    if picks.min() < 0 or picks.max() >= n:
        return math.inf
    e = emb.double()
    idx = torch.as_tensor(picks, device=emb.device)
    c = e[idx]
    csq = (c * c).sum(1)
    m = len(picks)
    furthest = torch.full((m,), -math.inf, dtype=torch.float64,
                          device=emb.device)
    step = _rows(m)
    with exact_float32():
        for r0 in range(0, n, step):
            d = _sqdist(e[r0:r0 + step], c, csq)
            furthest = torch.maximum(furthest, torch.cummin(d, 1).values.amax(0))
            del d
        own = _sqdist(c, c, csq)
    own.masked_fill_(torch.ones_like(own, dtype=torch.bool).triu(), math.inf)
    own = own.amin(1)[1:]                   # pick t to picks 0..t-1
    best = furthest[:-1]                    # the furthest record at step t
    gap = (best - own) / best.clamp_min(1e-300)
    return float(gap.max())


def random_picks(rep_ids: np.ndarray, n: int, n_reps: int,
                 random_fraction: float, seed: int) -> int:
    """How many of the start and the random picks differ from what the
    build's seed gives (the FPF picks taken as the build made them)."""
    rng = np.random.default_rng(seed)
    n_rand = int(round(n_reps * random_fraction))
    n_fpf = n_reps - n_rand
    if len(rep_ids) != n_reps:
        return n_reps
    start = int(rng.integers(n))
    chosen = np.asarray(rep_ids[:n_fpf], np.int64)
    pool = np.setdiff1d(np.arange(n), chosen)
    extra = rng.choice(pool, size=min(n_rand, len(pool)), replace=False)
    return int(chosen[0] != start) + int(np.sum(rep_ids[n_fpf:] != extra))


@torch.no_grad()
def topk(emb: torch.Tensor, rep_ids: np.ndarray, ids: np.ndarray,
         d2: np.ndarray) -> Dict[str, float]:
    """``rank``: the largest share by which a record's k-th chosen
    representative lies further than its k-th nearest (0 when the k
    chosen are the k nearest, ties allowed); ``d2``: the largest error of
    a reported squared distance, as a share of that record's k-th nearest.
    Both inf where an id is out of range or repeated in a row."""
    n, k = ids.shape
    c_n = len(rep_ids)
    bad = {"rank": math.inf, "d2": math.inf}
    if ids.min() < 0 or ids.max() >= c_n or d2.shape != ids.shape:
        return bad
    srt = np.sort(ids, 1)
    if k > 1 and np.any(srt[:, 1:] == srt[:, :-1]):
        return bad
    e = emb.double()
    c = e[torch.as_tensor(np.asarray(rep_ids, np.int64), device=emb.device)]
    csq = (c * c).sum(1)
    ids_t = torch.as_tensor(ids, dtype=torch.int64, device=emb.device)
    d2_t = torch.as_tensor(d2, dtype=torch.float64, device=emb.device)
    rank = err = 0.0
    step = _rows(c_n)
    with exact_float32():
        for r0 in range(0, n, step):
            d = _sqdist(e[r0:r0 + step], c, csq)
            kth = torch.topk(d, k, dim=1, largest=False).values[:, -1]
            kth = kth.clamp_min(1e-30)
            got = torch.gather(d, 1, ids_t[r0:r0 + step])
            rank = max(rank, float(((got.amax(1) - kth) / kth).max()))
            err = max(err, float(((d2_t[r0:r0 + step] - got).abs()
                                  / kth[:, None]).max()))
            del d
    return {"rank": rank, "d2": err}


def annotations_wrong(annotations, rep_ids: np.ndarray, scenes) -> int:
    """Representatives whose annotation is not the oracle's scene."""
    if len(annotations) != len(rep_ids):
        return len(rep_ids)
    wrong = 0
    for got, want in zip(annotations, scenes):
        boxes = np.asarray(getattr(got, "boxes", None))
        if boxes.shape != want.boxes.shape or not np.array_equal(boxes,
                                                                 want.boxes):
            wrong += 1
    return wrong


@torch.no_grad()
def build(state, features: torch.Tensor, e: dict, t: dict, seed: int,
          precision: str):
    """The reference in the program's place: (embeddings, rep ids, top-k
    ids, top-k squared distances) at ``precision``: FPF in float32 from a
    start the build's seed draws, numpy's random tenth, the k nearest by
    the expanded distance at ``precision``."""
    emb = embed(state, features, e, precision)
    n = emb.shape[0]
    n_reps, k = t["n_reps"], t["k"]
    n_rand = int(round(n_reps * t["random_fraction"]))
    n_fpf = n_reps - n_rand
    rng = np.random.default_rng(seed)
    chosen = torch.empty(n_fpf, dtype=torch.int64, device=emb.device)
    chosen[0] = int(rng.integers(n))
    nearest = torch.full((n,), math.inf, device=emb.device)
    esq = (emb * emb).sum(1)
    with exact_float32():
        for i in range(1, n_fpf):
            c = emb[chosen[i - 1]]
            d = esq - 2.0 * torch.mv(emb, c) + (c * c).sum()
            nearest = torch.minimum(nearest, d)
            chosen[i] = torch.argmax(nearest)
    chosen = chosen.cpu().numpy()
    pool = np.setdiff1d(np.arange(n), chosen)
    extra = rng.choice(pool, size=min(n_rand, len(pool)), replace=False)
    rep_ids = np.concatenate([chosen, extra]).astype(np.int64)
    reps = emb[torch.as_tensor(rep_ids, device=emb.device)]
    rsq = (reps * reps).sum(1)
    d2s, idss = [], []
    with exact_float32():
        for r0 in range(0, n, EMBED_ROWS):
            x = emb[r0:r0 + EMBED_ROWS]
            d = ((x * x).sum(1)[:, None] + rsq[None]
                 - 2.0 * mm(x, reps.T, precision)).clamp_min(0.0)
            d2, ids = torch.topk(d, min(k, len(rep_ids)), dim=1,
                                 largest=False)
            d2s.append(d2.cpu())
            idss.append(ids.cpu())
    return (emb, rep_ids, torch.cat(idss).numpy(),
            torch.cat(d2s).numpy())
