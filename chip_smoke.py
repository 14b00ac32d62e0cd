"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py            # full width: 1M frames, 7,000 reps

1. Prints the card (nvidia-smi), builds every CUDA kernel of the port from
   ``src/repro_torch/csrc`` (one nvcc per source, in parallel).
2. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes and times kernel, plain version and, where one PyTorch
   call computes the same function, that call (``library_ms``).
3. Builds a TASTI index (``build_tasti``, variant PT, seeded random embedder
   weights) over the synthetic night-street video at 1M frames and serves a
   three-query session twice through a cracking ``QueryEngine`` with
   resident scoring, counting each kernel's launches on that path.

Prints per-phase seconds, a JSON line of per-kernel numbers, and as its last
line ``{"ok": true, "device": {...}}``.  Any failure exits non-zero before
that line.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet peaks (float32 without tensor cores; HBM3)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` launches (after one
    warm-up), by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_summary(build_dir: pathlib.Path, digest: str) -> str:
    out = []
    for logf in sorted(build_dir.glob(f"*-{digest}.log")):
        text = logf.read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores",
                                             text)]
        out.append(f"{logf.stem.split('-')[0]}: max {max(regs, default=0)} "
                   f"registers, max {max(spills, default=0)} B spill stores")
    return "; ".join(out)


class Phase:
    """Times a phase of the main path; with ``profile_dir`` set, also traces
    it with torch.profiler, writes a chrome trace and the top kernels there,
    and prints the device busy share (kernel time over wall time)."""

    def __init__(self, name: str, profile_dir):
        self.name, self.dir, self.prof = name, profile_dir, None

    def __enter__(self):
        if self.dir is not None:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self.t0
        if self.prof is None or exc[0] is not None:
            return False
        self.prof.__exit__(None, None, None)
        out = pathlib.Path(self.dir)
        out.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(out / f"{self.name}.json"))
        kernels = [e for e in self.prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.time_range.elapsed_us() for e in kernels)
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us()
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        (out / f"{self.name}_kernels.txt").write_text(
            "\n".join(f"{us / 1e3:.3f} ms  {name}" for name, us in
                       sorted(by_name.items(), key=lambda kv: -kv[1])))
        log(f"profile {self.name}: wall {self.seconds:.3f} s, device busy "
            f"{busy_us / 1e6:.3f} s ({100 * busy_us / 1e6 / self.seconds:.1f}"
            f"%), {len(kernels)} kernels; top: " + "; ".join(
                f"{name[:60]} {us / 1e3:.1f} ms" for name, us in top))
        return False


def check_distance_topk(dev, rows: int, c: int, d: int, k: int,
                        full_rows: int):
    from repro_torch.kernels.distance_topk.ops import distance_topk
    from repro_torch.kernels.distance_topk.ref import distance_topk_ref
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(rows, d, device=dev, generator=g)
    r = torch.randn(c, d, device=dev, generator=g)
    dk, ik = distance_topk(x, r, k)
    dp, _ = distance_topk_ref(x, r, k)
    torch.cuda.synchronize()
    err = float((dk - dp).abs().max())
    torch.testing.assert_close(dk, dp, rtol=1e-4, atol=1e-4)
    # the returned ids reproduce the returned distances (direct form)
    d_ids = ((x[:, None, :] - r[ik.long()]) ** 2).sum(-1)
    torch.testing.assert_close(d_ids, dk, rtol=1e-3, atol=1e-3)
    assert int(ik.min()) >= 0 and int(ik.max()) < c
    ms = time_ms(lambda: distance_topk(x, r, k), 10)
    plain_ms = time_ms(lambda: distance_topk_ref(x, r, k), 3)
    lib_ms = time_ms(lambda: torch.topk(torch.cdist(x, r), k, dim=1,
                                        largest=False), 10)
    b, by = bound_ms(4 * (rows * d + c * d) + 8 * rows * k, 2.0 * rows * c * d)
    del dp, d_ids
    # one launch at the main path's full row count (kernel only: the plain
    # (N, C) matrix would not be worth materialising)
    xf = torch.randn(full_rows, d, device=dev, generator=g)
    full_ms = time_ms(lambda: distance_topk(xf, r, k), 2)
    fb, _ = bound_ms(4 * (full_rows * d + c * d) + 8 * full_rows * k,
                     2.0 * full_rows * c * d)
    del xf
    log(f"distance_topk {rows}x{c}x{d} k={k}: max_abs_err {err:.3g} "
        f"(tol rtol 1e-4 atol 1e-4), kernel {ms:.3f} ms, plain {plain_ms:.3f}"
        f" ms, cdist+topk {lib_ms:.3f} ms, bound {b:.3f} ms ({by}); at "
        f"{full_rows} rows kernel {full_ms:.3f} ms, bound {fb:.3f} ms")
    return {"name": "distance_topk", "shape": [rows, c, d, k],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": lib_ms,
            "full_rows": full_rows, "full_ms": full_ms, "full_bound_ms": fb}


def check_fpf_update(dev, n: int, d: int):
    from repro_torch.kernels.fpf_update.ops import fpf_update
    from repro_torch.kernels.fpf_update.ref import fpf_update_ref
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(n, d, device=dev, generator=g)
    min_d2 = torch.full((n,), float("inf"), device=dev)
    errs = []
    for step in range(3):          # a few chained steps, as FPF runs them
        rep = x[(step * 7919) % n]
        nm_k, i_k, v_k = fpf_update(x, rep, min_d2)
        nm_p, i_p, v_p = fpf_update_ref(x, rep, min_d2)
        torch.cuda.synchronize()
        errs.append(float((nm_k - nm_p).abs().max()))
        torch.testing.assert_close(nm_k, nm_p, rtol=1e-5, atol=1e-5)
        # values reached agree; ids may differ only within rounding
        assert abs(float(v_k) - float(v_p)) <= 1e-5 * float(v_p)
        assert abs(float(nm_p[int(i_k)]) - float(v_p)) <= 1e-5 * float(v_p)
        assert float(nm_k[int(i_k)]) == float(v_k)
        min_d2 = nm_p
    err = max(errs)
    rep = x[123]
    ms = time_ms(lambda: fpf_update(x, rep, min_d2), 50)
    plain_ms = time_ms(lambda: fpf_update_ref(x, rep, min_d2), 10)
    b, by = bound_ms(4 * (n * d + d + 2 * n) + 8, 3.0 * n * d + 2.0 * n)
    log(f"fpf_update {n}x{d}: max_abs_err {err:.3g} (tol rtol 1e-5 atol "
        f"1e-5), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b:.4f} "
        f"ms ({by})")
    return {"name": "fpf_update", "shape": [n, d], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "library_ms": None}


def check_propagate(dev, n: int, c: int, k: int, n_classes: int = 9):
    from repro_torch.kernels.distance_topk.ops import PAD_DIST
    from repro_torch.kernels.propagate.ops import propagate
    from repro_torch.kernels.propagate.ref import masked_weights, propagate_ref
    g = torch.Generator(device=dev).manual_seed(3)
    ids = torch.randint(0, c, (n, k), device=dev, generator=g,
                        dtype=torch.int32)
    d2 = torch.sort(torch.rand(n, k, device=dev, generator=g) * 9, 1).values
    d2[: n // 100, -2:] = PAD_DIST               # some k > C style columns
    numeric = torch.rand(c, device=dev, generator=g)
    classes = torch.randint(0, n_classes, (c,), device=dev,
                            generator=g).float()
    modes = {}
    for mode, scores, kw in [
            ("numeric", numeric, {}), ("top1", numeric, {}),
            ("categorical", classes, {"n_classes": n_classes})]:
        got = propagate(scores, ids, d2, mode, **kw)
        want = propagate_ref(scores, ids, d2, mode, **kw)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        if mode == "categorical":
            # a class may differ only where the plain top-2 votes are tied
            # to float32 rounding (sums taken in another order)
            w = masked_weights(d2, 1e-6)
            cls = classes[ids.long()].long()
            votes = torch.zeros(n, n_classes, device=dev).scatter_add_(
                1, cls, w)
            top2 = torch.topk(votes, 2, dim=1).values
            near_tie = (top2[:, 0] - top2[:, 1]) <= 1e-5 * top2[:, 0]
            bad = int(((diff > 0) & ~near_tie).sum())
            assert bad == 0, f"{bad} categorical rows disagree"
            err = float(diff[~near_tie].max())
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
            err = float(diff.max())
        ms = time_ms(lambda: propagate(scores, ids, d2, mode, **kw), 50)
        plain_ms = time_ms(
            lambda: propagate_ref(scores, ids, d2, mode, **kw), 10)
        modes[mode] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        log(f"propagate[{mode}] {n}x{k}, C={c}: max_abs_err {err:.3g}, "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    ops_per_row = {"numeric": 6 * k, "top1": 4, "categorical": 6 * k * k}
    b, by = bound_ms(8 * n * k + 4 * c + 4 * n, ops_per_row["numeric"] * n)
    log(f"propagate bound {b:.4f} ms ({by})")
    return {"name": "propagate", "shape": [n, k, c],
            "max_abs_err": max(m["max_abs_err"] for m in modes.values()),
            "ms": modes["numeric"]["ms"],
            "plain_ms": modes["numeric"]["plain_ms"], "bound_ms": b,
            "bound_by": by, "library_ms": None, "modes": modes}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=7000)
    ap.add_argument("--check-rows", type=int, default=65536,
                    help="rows of the distance_topk plain comparison")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="trace build_tasti and the first session with "
                         "torch.profiler into DIR and print each phase's "
                         "device busy share")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False   # exact float32 products
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"({ptxas_summary(_build.build_dir(), _build.sources_hash())})")

    from repro_torch.core.embedder import Embedder, EmbedderConfig
    from repro_torch.core.engine import QueryEngine, QuerySpec
    from repro_torch.core.pipeline import TastiConfig, build_tasti
    from repro_torch.core.propagation import propagate_numeric
    from repro_torch.core.schema import make_workload
    from repro_torch.core.session import QuerySession
    from repro_torch.kernels.distance_topk.ops import distance_topk
    from repro_torch.kernels.fpf_update.ops import fpf_update
    from repro_torch.kernels.propagate.ops import propagate

    dev = torch.device("cuda", 0)
    cfg = TastiConfig(n_reps=args.reps, k=8, embed_dim=128,
                      random_fraction=0.1, seed=0)
    t0 = time.perf_counter()
    results = [
        check_distance_topk(dev, min(args.check_rows, args.frames), cfg.n_reps,
                            cfg.embed_dim, cfg.k, args.frames),
        check_fpf_update(dev, args.frames, cfg.embed_dim),
        check_propagate(dev, args.frames, cfg.n_reps, cfg.k),
    ]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase kernel_checks: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    wl = make_workload("night-street", n_frames=args.frames)
    log(f"phase workload ({args.frames} frames, CPU): "
        f"{time.perf_counter() - t0:.2f} s")
    ecfg = EmbedderConfig(feature_dim=wl.features.shape[1],
                          embed_dim=cfg.embed_dim)
    params = Embedder(ecfg, generator=torch.Generator().manual_seed(
        0)).state_dict()

    wrappers = {"distance_topk": distance_topk, "fpf_update": fpf_update,
                "propagate": propagate}
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with Phase("build_tasti", args.profile) as ph:
        system = build_tasti(wl, cfg, variant="PT", embed_params=params,
                             device=dev)
    index = system.index
    log(f"phase build_tasti: {ph.seconds:.2f} s (reps {index.n_reps}, "
        f"fpf_update launches {fpf_update.launches}, distance_topk launches "
        f"{distance_topk.launches})")
    assert index.topk_ids.shape == (args.frames, cfg.k)
    assert np.isfinite(index.topk_d2).all()
    assert 0 <= index.topk_ids.min() and index.topk_ids.max() < index.n_reps

    engine = QueryEngine(index, wl, crack=True)
    assert engine.resident.enabled
    specs = [QuerySpec(kind="aggregation", score="score_count", err=0.05),
             QuerySpec(kind="selection", score="score_has_object",
                       budget=500),
             QuerySpec(kind="limit", score="score_rare", k_results=5)]
    true_mean = float(wl.counts.mean())
    for run in (1, 2):
        with Phase(f"session{run}", args.profile if run == 1 else None) as ph:
            out = QuerySession(engine, specs).execute()
        log(f"phase session run {run}: {ph.seconds:.2f} s")
        for r in out.results:
            log(f"  {r.kind}: estimate {r.estimate} ci {r.ci_half_width} "
                f"selected {None if r.selected is None else len(r.selected)}"
                f" invocations {r.n_invocations} fresh {r.n_oracle_fresh} "
                f"cached {r.n_oracle_cached} cracked {r.n_cracked}")
        agg = out.results[0]
        assert abs(agg.estimate - true_mean) <= 3 * agg.ci_half_width, \
            (agg.estimate, agg.ci_half_width, true_mean)
        assert out.results[2].selected is not None
    # the served proxy (kernel path) against the float64 host path over the
    # final, cracked index
    proxy = engine.proxy_scores("score_count")
    host = propagate_numeric(index.rep_scores(wl.score_count),
                             index.topk_ids, index.topk_d2)
    assert proxy.shape == (args.frames,) and np.isfinite(proxy).all()
    np.testing.assert_allclose(proxy, host, rtol=1e-5, atol=1e-5)
    launches = {name: w.launches for name, w in wrappers.items()}
    log(f"launches on the main path: {launches}; engine {engine.stats}; "
        f"resident {engine.resident.stats}; index version {index.version}, "
        f"reps {index.n_reps}; true mean count {true_mean:.6f}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    assert all(v > 0 for v in launches.values()), launches
    assert engine.stats["proxy_device_computes"] > 0, engine.stats

    sources = {"distance_topk": "src/repro/kernels/distance_topk/kernel.py:77",
               "fpf_update": "src/repro/kernels/fpf_update/kernel.py:34",
               "propagate": "src/repro/kernels/propagate/kernel.py:84"}
    kernels = []
    for res in results:
        name = res["name"]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/csrc/{name}.cu",
                        "replaces": sources[name],
                        "launches": launches[name], **{
                            k: v for k, v in res.items() if k != "name"}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
