"""Induced schemas + synthetic workloads with an oracle target DNN.

The paper evaluates on three videos (night-street / taipei / amsterdam, Mask
R-CNN target DNN) and WikiSQL (crowd-worker "target DNN").  Those datasets are
not available offline, so we generate workloads with the same statistical
structure (DESIGN.md §7):

* ``VideoWorkload``: a latent scene process — object count follows a sticky
  Markov chain (mostly empty frames, bursts of traffic, *rare* high-count
  events), object positions drift smoothly.  A frame's unstructured record is
  a fixed random nonlinear rendering of its latent scene + noise; the *target
  DNN* is an oracle that reads the latent scene (cost-modeled at the paper's
  measured 3 fps vs 12,000 fps embedder ratio).
* ``TextWorkload``: latent = (SQL operator, #predicates); records are noisy
  nonlinear renderings of the latent, mirroring the WikiSQL semantic-parsing
  setup.

Both expose the *induced schema* (structured outputs), the paper's
``IsClose`` heuristic, and a metric ``d`` on schema outputs used by the
theoretical analysis and the triplet miner.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

# Cost model (paper §3.4: Mask R-CNN 3 fps vs embedding DNN 12,000 fps).
TARGET_DNN_COST_S = 1.0 / 3.0
EMBED_DNN_COST_S = 1.0 / 12000.0
DIST_COST_S = 1e-7  # per record-representative distance

# Frames rendered per chunk in VideoWorkload (bounds the float64 intermediate).
_RENDER_CHUNK = 65536


@dataclass
class Scene:
    """Induced-schema record for video: object positions in [0,1]^2."""
    boxes: np.ndarray  # (n_objects, 2) positions; n_objects may be 0

    @property
    def count(self) -> int:
        return len(self.boxes)

    def mean_x(self) -> float:
        return float(np.mean(self.boxes[:, 0])) if len(self.boxes) else 0.5


def scene_distance(a: Scene, b: Scene) -> float:
    """Metric d on the induced schema: count mismatch dominates, matched
    objects contribute their nearest-neighbor position distance."""
    if a.count != b.count:
        return 1.0 + abs(a.count - b.count)
    if a.count == 0:
        return 0.0
    # greedy nearest matching (counts are small)
    pa = a.boxes.copy()
    pb = b.boxes.copy()
    total = 0.0
    used = np.zeros(len(pb), bool)
    for p in pa:
        d = np.linalg.norm(pb - p, axis=1)
        d[used] = np.inf
        j = int(np.argmin(d))
        used[j] = True
        total += float(d[j])
    return total / a.count


def is_close_video(a: Scene, b: Scene, pos_tol: float = 0.25) -> bool:
    """The paper's IsClose pseudocode (§2.2): same count, all boxes close."""
    return scene_distance(a, b) < pos_tol


@dataclass
class VideoWorkload:
    n_frames: int = 20000
    feature_dim: int = 64
    max_objects: int = 8
    rare_count: int = 6           # frames with >= rare_count objects are rare
    p_stay: float = 0.98          # stickiness of the count chain
    noise: float = 0.15
    seed: int = 0
    name: str = "night-street-synth"

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.scenes: List[Scene] = []
        # sticky markov chain over counts, biased to 0 (mostly-empty street)
        count = 0
        positions = rng.uniform(0, 1, size=(self.max_objects, 2))
        velocity = rng.normal(0, 0.01, size=(self.max_objects, 2))
        counts = np.zeros(self.n_frames, np.int32)
        all_pos = np.zeros((self.n_frames, self.max_objects, 2), np.float32)
        for t in range(self.n_frames):
            if rng.uniform() > self.p_stay:
                # mostly small counts; rare heavy frames
                count = int(min(self.max_objects, rng.geometric(0.5) - 1))
            positions = np.clip(positions + velocity, 0, 1)
            velocity = 0.95 * velocity + rng.normal(0, 0.004, velocity.shape)
            bounce = (positions <= 0) | (positions >= 1)
            velocity[bounce] *= -1
            counts[t] = count
            all_pos[t] = positions
        self.counts = counts
        self._positions = all_pos
        for t in range(self.n_frames):
            self.scenes.append(Scene(boxes=all_pos[t, :counts[t]].copy()))
        # Compositional rendering: each *object* contributes an appearance
        # vector that depends nonlinearly on its position; the frame record is
        # a saturating mix of contributions + background + noise.  Count is
        # only implicit (no linearly-decodable count channel), which makes
        # small-label-budget supervised proxies genuinely hard — the regime
        # the paper studies — while the metric structure the triplet loss
        # needs is preserved.
        w_pos = rng.normal(0, 2.0, size=(3, 96))
        w_mix = rng.normal(0, 1.0, size=(96, self.feature_dim)) / np.sqrt(96)
        background = rng.normal(0, 0.3, size=(self.feature_dim,))
        # rendered in row chunks: the (T, M, 96) float64 intermediate is
        # ~6 GB at a million frames; every step below is row-independent
        mixed = np.empty((self.n_frames, self.feature_dim))
        for s in range(0, self.n_frames, _RENDER_CHUNK):
            e = min(s + _RENDER_CHUNK, self.n_frames)
            mask = (np.arange(self.max_objects)[None, :] < counts[s:e, None])
            aug = np.concatenate([all_pos[s:e],
                                  np.ones((e - s, self.max_objects, 1))],
                                 axis=2)  # (t, M, 3)
            appear = np.tanh(aug @ w_pos)            # (t, M, 96)
            appear = appear * mask[:, :, None]
            mixed[s:e] = appear.sum(axis=1) @ w_mix  # (t, F)
        # Nuisance latent (lighting / weather): slowly-varying, schema-
        # irrelevant, and *dominant* in feature variance.  This is what makes
        # small-label-budget supervised proxies fit spuriously while the
        # induced-schema triplet loss learns invariance to it.
        nuis = np.zeros((self.n_frames, 4))
        z = rng.normal(0, 1, size=4)
        for t in range(self.n_frames):
            z = 0.98 * z + rng.normal(0, 0.2, size=4)
            nuis[t] = z
        w_nuis_gain = rng.normal(0, 0.6, size=(4, self.feature_dim))
        w_nuis_add = rng.normal(0, 1.2, size=(4, self.feature_dim))
        gain = 1.0 + np.tanh(nuis @ w_nuis_gain)
        feats = np.tanh((mixed + background[None]) * gain + nuis @ w_nuis_add)
        feats = feats + rng.normal(0, self.noise, size=feats.shape)
        self.features = feats.astype(np.float32)
        self.nuisance = nuis.astype(np.float32)

    # --- the "target DNN" oracle + cost model ---
    def target_dnn(self, idx: int) -> Scene:
        return self.scenes[idx]

    def target_dnn_batch(self, ids) -> List[Scene]:
        return [self.scenes[i] for i in ids]

    def schema_distance(self, i: int, j: int) -> float:
        return scene_distance(self.scenes[i], self.scenes[j])

    def is_close(self, i: int, j: int) -> bool:
        return is_close_video(self.scenes[i], self.scenes[j])

    # --- paper's query-specific scoring functions (§4.1) ---
    def score_count(self, scene: Scene) -> float:
        return float(scene.count)

    def score_has_object(self, scene: Scene) -> float:
        return 1.0 if scene.count > 0 else 0.0

    def score_rare(self, scene: Scene) -> float:
        return 1.0 if scene.count >= self.rare_count else 0.0

    def score_left_side(self, scene: Scene) -> float:
        """Selecting objects on the left (paper §6.4, violates Lipschitz)."""
        return 1.0 if (scene.count > 0 and scene.mean_x() < 0.5) else 0.0

    def score_mean_x(self, scene: Scene) -> float:
        """Average x position (paper §6.4 regression query)."""
        return scene.mean_x()


_TEXT_OPS = ("SELECT", "COUNT", "MAX", "MIN", "AVG", "SUM")


@dataclass
class TextRecord:
    op: int            # index into _TEXT_OPS
    n_predicates: int  # 0..4


def text_distance(a: TextRecord, b: TextRecord) -> float:
    return (1.0 if a.op != b.op else 0.0) + 0.5 * abs(a.n_predicates - b.n_predicates)


@dataclass
class TextWorkload:
    """WikiSQL-like: latent (operator, #predicates) -> noisy record features."""
    n_records: int = 8000
    feature_dim: int = 64
    noise: float = 0.15
    seed: int = 1
    name: str = "wikisql-synth"

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        ops = rng.choice(len(_TEXT_OPS), size=self.n_records,
                         p=[0.45, 0.25, 0.1, 0.1, 0.05, 0.05])
        preds = np.minimum(rng.geometric(0.5, size=self.n_records), 5) - 1
        self.records = [TextRecord(int(o), int(p)) for o, p in zip(ops, preds)]
        self.ops = ops
        self.n_predicates = preds
        lat = np.stack([ops / len(_TEXT_OPS), preds / 5.0], axis=1)
        w1 = rng.normal(0, 1, size=(2, 96)) / np.sqrt(2)
        w2 = rng.normal(0, 1, size=(96, self.feature_dim)) / np.sqrt(96)
        h = np.tanh(lat @ w1)
        self.features = (np.tanh(h @ w2) + rng.normal(
            0, self.noise, size=(self.n_records, self.feature_dim))
        ).astype(np.float32)

    def target_dnn(self, idx: int) -> TextRecord:
        return self.records[idx]

    def target_dnn_batch(self, ids) -> List[TextRecord]:
        return [self.records[i] for i in ids]

    def schema_distance(self, i: int, j: int) -> float:
        return text_distance(self.records[i], self.records[j])

    def is_close(self, i: int, j: int) -> bool:
        return self.schema_distance(i, j) < 0.5

    def score_n_predicates(self, rec: TextRecord) -> float:
        return float(rec.n_predicates)

    def score_is_select(self, rec: TextRecord) -> float:
        return 1.0 if rec.op == 0 else 0.0


#: Datasets make_workload knows how to synthesize (CLIs and the serving
#: registry validate workload mounts against this list).
VIDEO_WORKLOAD_NAMES = ("night-street", "taipei", "amsterdam")
WORKLOAD_NAMES = VIDEO_WORKLOAD_NAMES + ("wikisql",)


def make_workload(name: str, **kw):
    """Synthesize the named workload.  The size kw is dataset-specific
    (``n_frames`` for video, ``n_records`` for text) but either spelling is
    accepted and translated, so generic callers (CLIs, the serving
    registry) can size every dataset uniformly."""
    if "n_frames" in kw and "n_records" in kw:
        raise ValueError("pass n_frames or n_records, not both")
    if name in VIDEO_WORKLOAD_NAMES:
        if "n_records" in kw:
            kw["n_frames"] = kw.pop("n_records")
        seeds = {"night-street": 0, "taipei": 7, "amsterdam": 13}
        # taipei has two object classes in the paper; we model heavier traffic
        overrides = {"taipei": dict(p_stay=0.96), "amsterdam": dict(p_stay=0.99)}
        return VideoWorkload(seed=seeds[name], name=name + "-synth",
                             **{**overrides.get(name, {}), **kw})
    if name == "wikisql":
        if "n_frames" in kw:
            kw["n_records"] = kw.pop("n_frames")
        return TextWorkload(**kw)
    raise KeyError(name)
