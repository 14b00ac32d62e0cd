"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU.

    python3 chip_smoke.py            # full width: 1M frames, 7,000 reps,
                                     # h2o-danube-3-4b on a 32,768-token prompt

1. Prints the card (nvidia-smi), builds every CUDA kernel of the port from
   ``src/repro_torch/csrc`` (one nvcc per source, in parallel).
2. Holds each kernel against its plain PyTorch version on the card at the
   paths' shapes and times kernel, plain version and, where one PyTorch
   call computes the same function, that call (``library_ms``); for
   distance_topk and propagate also the kernels' own device time
   (torch.profiler) beside the wrapper's CUDA-event time.
   flash_attention is held on each of its three paths (tc, short, simt)
   and distance_topk on each of its two routes (tc, simt), and each check
   asserts which path its input takes; distance_topk's tc route also at a
   crack's C, at C 7,001, k 1, in bf16 and on near-duplicate records
   (against float64); propagate's top1 prescale bit for bit against
   tie_break_prescale.
3. tasti: builds a TASTI index (``build_tasti``, variant PT, seeded random
   embedder weights) over the synthetic night-street video at 1M frames and
   serves a three-query session twice through a cracking ``QueryEngine``
   with resident scoring; every distance_topk launch of the build and of
   the cracks must take the tc route.
4. lm_prefill: h2o-danube-3-4b at its published widths (seeded random bf16
   weights) through ``make_prefill_step`` on one 32,768-token prompt, every
   attention layer through the ``flash_attention`` kernel's tc path; the
   same model on 8,192 tokens against the plain attention route, in bf16
   and with the weights cast to float32.
5. lm_serve and lm_decode_window: the ``serve_lm`` path (replay prefill,
   greedy decode) at the same width, batch 4, prompt 32, 16 decode steps;
   16 decode steps with the 4,096-key window full.
   tasti_t: the paper's TASTI-T build over the same records (the default
   TastiConfig: 200 pre-training steps, 3,000 FPF-mined training records,
   400 triplet steps of 256, 7,000 reps; stage seconds, launches by kernel
   and route, the triplet loss, which must fall), one three-spec session
   over its index, and one train_embedder and one pretrain_embedder step
   on the card against the CPU's plain path.
6. embedder: the transformer embedder (``tasti-embedder``, seeded random
   weights) over the night-street records, attention through the kernel's
   short path.
7. lm_train: ``make_train_step`` at h2o-danube-3-4b's published widths
   (seeded bf16 weights, float32 moments, remat per block, plain attention
   as the JAX package trains through XLA attention), 3 steps at batch 1 x
   4,096; loss, grad norm, seconds and tokens/s per step, peak device
   memory; every leaf must move, and the loss of the kernel's (tc) forward
   must agree with the step-1 loss within the bf16 witness rule.  Before
   it, step 1 at the same widths, depth cut to 2, against a float32
   autograd and AdamW recompute (grad norm, first moments, every updated
   element), which rejects planted faults in the update.
8. lm_train_resilient: ``python -m repro_torch.launch.train --preset 100m
   --steps 50 --inject-failure-at 25`` into a temporary checkpoint
   directory (removed afterwards): one restart, the pipeline state restored,
   the launcher's own check that the loss fell.

Each path's kernel launches are counted from 0 just before it runs.  Prints
per-phase seconds, a JSON line of per-kernel numbers, and as its last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before that
line.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet peaks (float32 without tensor cores; dense TF32 and
# bf16/f16 tensor cores; HBM3)
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_BF16_FLOPS = 989e12
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


def device_ms(fn, iters: int) -> dict:
    """{kernel name: device ms per call} of ``fn`` over ``iters`` calls
    (after one warm-up), from torch.profiler's kernel records: the kernels'
    own time, without the wrapper's host time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / iters
    return out


def own_time(fn, iters: int, main: str) -> dict:
    """The kernels' own device time per call (all of them, and the one
    whose name holds ``main``) and the kernels launched per call."""
    ms = device_ms(fn, iters)
    assert ms, "torch.profiler recorded no kernel"
    return {"device_ms": sum(ms.values()),
            "main_device_ms": sum(v for n, v in ms.items() if main in n),
            "kernels": sorted(ms)}


def bound_ms(n_bytes: float, n_flops: float, peak: float = PEAK_F32_FLOPS):
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mangled_label(fn: str) -> str:
    """``name<args>`` for a mangled kernel: the length-prefixed component
    that ends in ``_kernel`` and its template arguments (f32, f16, bf16,
    integers, flags as 0/1)."""
    pos = 3 if fn.startswith("_ZN") else 2
    while True:
        m = re.match(r"\d+", fn[pos:])
        if not m:
            return fn
        pos += m.end()
        name = fn[pos:pos + int(m.group())]
        pos += len(name)
        if name.endswith("_kernel"):
            break
    rest, args = fn[pos:], []
    if rest.startswith("I"):
        rest = rest[1:]
        while rest and not rest.startswith("E"):
            t = re.match(r"f|6__half|13__nv_bfloat16|Li(\d+)E|Lb([01])E",
                         rest)
            if not t:
                break
            args.append({"f": "f32", "6__half": "f16",
                         "13__nv_bfloat16": "bf16"}.get(
                             t.group(), t.group(1) or t.group(2)))
            rest = rest[t.end():]
    return name + (f"<{', '.join(args)}>" if args else "")


def entry_label(fn: str) -> str:
    """A short name for a mangled entry function.  flash_attention: its
    path, its input type and the head-dim bound of its tiles; others: the
    kernel's name and its template arguments (types, integers, flags)."""
    m = re.search(r"flash_(tc|short|fwd)_kernelI(13__nv_bfloat16|f)?(?:Li("
                  r"\d+))?", fn)
    if not m:
        return mangled_label(fn)
    path = {"fwd": "simt"}.get(m.group(1), m.group(1))
    dtype = {"f": " f32", "13__nv_bfloat16": " bf16", None: " bf16"}[
        m.group(2)]
    return path + dtype + (f" hd<={m.group(3)}" if m.group(3) else "")


def ptxas_report(build_dir: pathlib.Path, digests: dict) -> dict:
    """{library: [(entry function, registers, spill store bytes)]} from the
    compiler's report beside each library."""
    out = {}
    for name, digest in sorted(digests.items()):
        text = (build_dir / f"{name}-{digest}.log").read_text()
        entries = []
        for block in text.split("Compiling entry function '")[1:]:
            fn = block.split("'", 1)[0]
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores", block)
            entries.append((entry_label(fn),
                            int(regs.group(1)) if regs else None,
                            int(spill.group(1)) if spill else None))
        out[name] = entries
    return out


def ptxas_summary(report: dict) -> str:
    return "; ".join(
        f"{name}: max {max((r or 0) for _, r, _ in e)} registers, max "
        f"{max((sp or 0) for _, _, sp in e)} B spill stores"
        for name, e in report.items())


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


def topk_bytes(rows: int, c: int, d: int, k: int, item: int = 4) -> int:
    return item * (rows * d + c * d) + 8 * rows * k


def check_distance_topk(dev, rows: int, c: int, d: int, k: int,
                        full_rows: int):
    """Both routes at the build's shape against the plain version (rtol and
    atol 1e-4), ids reproducing distances; each route's CUDA-event time, its
    kernels' own device time (torch.profiler) and bound: simt against the
    float32 SIMT peak, tc (3xTF32: three products) against the TF32 one."""
    from repro_torch.kernels.distance_topk.ops import (_launch, distance_topk,
                                                       distance_topk_route)
    from repro_torch.kernels.distance_topk.ref import distance_topk_ref
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(rows, d, device=dev, generator=g)
    r = torch.randn(c, d, device=dev, generator=g)
    assert distance_topk_route(x, r, k) == "tc"
    dp, _ = distance_topk_ref(x, r, k)
    flops = 2.0 * rows * c * d
    n_bytes = topk_bytes(rows, c, d, k)
    bounds = {"simt": bound_ms(n_bytes, flops),
              "tc": bound_ms(n_bytes, 3 * flops, PEAK_TF32_FLOPS)}
    routes = {}
    for route in ("tc", "simt"):
        before = distance_topk.launches_by_path[route]
        dk, ik = _launch(x, r, k, route)
        torch.cuda.synchronize()
        assert distance_topk.launches_by_path[route] == before + 1, route
        err = float((dk - dp).abs().max())
        torch.testing.assert_close(dk, dp, rtol=1e-4, atol=1e-4)
        # the returned ids reproduce the returned distances (direct form)
        d_ids = ((x[:, None, :] - r[ik.long()]) ** 2).sum(-1)
        torch.testing.assert_close(d_ids, dk, rtol=1e-3, atol=1e-3)
        assert int(ik.min()) >= 0 and int(ik.max()) < c
        del dk, ik, d_ids
        call = lambda: _launch(x, r, k, route)  # noqa: E731
        routes[route] = {"max_abs_err": err, "ms": time_ms(call, 10),
                         **own_time(call, 5, "distance_topk"),
                         "bound_ms": bounds[route][0],
                         "bound_by": bounds[route][1]}
    plain_ms = time_ms(lambda: distance_topk_ref(x, r, k), 3)
    lib_ms = time_ms(lambda: torch.topk(torch.cdist(x, r), k, dim=1,
                                        largest=False), 10)
    del dp
    # one launch at the main path's full row count (kernel only: the plain
    # (N, C) matrix would not be worth materialising)
    xf = torch.randn(full_rows, d, device=dev, generator=g)
    fb = {"simt": bound_ms(topk_bytes(full_rows, c, d, k),
                           2.0 * full_rows * c * d),
          "tc": bound_ms(topk_bytes(full_rows, c, d, k),
                         6.0 * full_rows * c * d, PEAK_TF32_FLOPS)}
    for route in ("tc", "simt"):
        call = lambda: _launch(xf, r, k, route)  # noqa: E731
        routes[route].update(full_ms=time_ms(call, 2),
                             full_device_ms=own_time(call, 1, "distance_topk")
                             ["device_ms"], full_bound_ms=fb[route][0])
    # the library calls at the full row count, in chunks of 262,144 rows
    # (one chunk's (rows, C) float32 distances are 7.3 GB)
    chunks = xf.split(262144)
    full_lib_ms = time_ms(lambda: [torch.topk(torch.cdist(xc, r), k, dim=1,
                                              largest=False) for xc in chunks],
                          2)
    del xf, chunks
    for route, m in routes.items():
        log(f"distance_topk[{route}] {rows}x{c}x{d} k={k}: max_abs_err "
            f"{m['max_abs_err']:.3g} (tol rtol 1e-4 atol 1e-4), kernel "
            f"{m['ms']:.3f} ms (own device time {m['device_ms']:.3f} ms, main "
            f"kernel {m['main_device_ms']:.3f}), bound {m['bound_ms']:.3f} ms "
            f"({m['bound_by']}); at {full_rows} rows kernel "
            f"{m['full_ms']:.3f} ms (device {m['full_device_ms']:.3f}), "
            f"bound {m['full_bound_ms']:.3f} ms")
    log(f"distance_topk {rows}x{c}x{d} k={k}: plain {plain_ms:.3f} ms, "
        f"cdist+topk {lib_ms:.3f} ms; at {full_rows} rows cdist+topk "
        f"{full_lib_ms:.3f} ms")
    tc = routes["tc"]
    return {"name": "distance_topk", "shape": [rows, c, d, k],
            "max_abs_err": max(m["max_abs_err"] for m in routes.values()),
            "ms": tc["ms"], "device_ms": tc["device_ms"],
            "plain_ms": plain_ms, "bound_ms": tc["bound_ms"],
            "bound_by": tc["bound_by"],
            "bound_f32_simt_ms": bounds["simt"][0], "library_ms": lib_ms,
            "full_rows": full_rows, "full_ms": tc["full_ms"],
            "full_bound_ms": tc["full_bound_ms"],
            "full_library_ms": full_lib_ms, "routes": routes}


def check_distance_topk_cases(dev, rows: int, full_rows: int):
    """The tc route at the main path's other shapes, against the plain
    version (float32 at rtol/atol 1e-4, bf16 at 5e-2) with ids reproducing
    their distances: a crack's C (1,000; also timed at the full row count),
    a C that is no tile multiple (7,001), k 1, bf16 inputs (timed, bound at
    the bf16 peak); and near-duplicate records (1e-2 from their rep, |x|^2
    ~ 1,000), within 2x the plain float32 version's own error against a
    float64 computation."""
    from repro_torch.kernels.distance_topk.ops import (_launch, distance_topk,
                                                       distance_topk_route)
    from repro_torch.kernels.distance_topk.ref import distance_topk_ref
    g = torch.Generator(device=dev).manual_seed(4)
    out = []
    for label, c, d, k, dtype in [("crack", 1000, 128, 8, torch.float32),
                                  ("c7001", 7001, 128, 8, torch.float32),
                                  ("k1", 7000, 128, 1, torch.float32),
                                  ("bf16", 7000, 128, 8, torch.bfloat16)]:
        x = torch.randn(rows, d, device=dev, generator=g).to(dtype)
        r = torch.randn(c, d, device=dev, generator=g).to(dtype)
        assert distance_topk_route(x, r, k) == "tc", label
        before = distance_topk.launches_by_path["tc"]
        dk, ik = distance_topk(x, r, k)
        dp, _ = distance_topk_ref(x, r, k)
        torch.cuda.synchronize()
        assert distance_topk.launches_by_path["tc"] == before + 1, label
        tol = 1e-4 if dtype == torch.float32 else 5e-2
        err = float((dk - dp).abs().max())
        torch.testing.assert_close(dk, dp, rtol=tol, atol=tol)
        d_ids = ((x.float()[:, None, :] - r.float()[ik.long()]) ** 2).sum(-1)
        torch.testing.assert_close(d_ids, dk, rtol=10 * tol, atol=10 * tol)
        assert int(ik.min()) >= 0 and int(ik.max()) < c
        res = {"label": label, "shape": [rows, c, d, k],
               "dtype": str(dtype)[6:], "max_abs_err": err, "tol": tol}
        del dk, ik, dp, d_ids
        if label in ("crack", "bf16"):
            xf = torch.randn(full_rows, d, device=dev, generator=g).to(dtype)
            call = lambda: distance_topk(xf, r, k)  # noqa: E731
            flops = 2.0 * full_rows * c * d
            peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 \
                else PEAK_TF32_FLOPS
            bnd, by = bound_ms(topk_bytes(full_rows, c, d, k,
                                          x.element_size()),
                               flops * (1 if dtype == torch.bfloat16 else 3),
                               peak)
            res.update(full_rows=full_rows, ms=time_ms(call, 3),
                       device_ms=own_time(call, 2, "distance_topk")
                       ["device_ms"], bound_ms=bnd, bound_by=by)
            if label == "crack":
                res["simt_ms"] = time_ms(lambda: _launch(xf, r, k, "simt"), 3)
            del xf
        log(f"distance_topk[tc {label}] {rows}x{c}x{d} k={k} "
            f"{str(dtype)[6:]}: max_abs_err {err:.3g} (tol {tol:g})" + (
                f"; at {full_rows} rows {res['ms']:.3f} ms (device "
                f"{res['device_ms']:.3f}), bound {res['bound_ms']:.3f} ms "
                f"({res['bound_by']})" if "ms" in res else "") + (
                f", simt {res['simt_ms']:.3f} ms" if "simt_ms" in res
                else ""))
        out.append(res)
    # near-duplicates: the expanded form cancels ~2,000 down to ~0.013
    c, d, k = 7000, 128, 8
    reps = torch.randn(c, d, device=dev, generator=g) + 2.7
    pick = torch.randint(0, c, (rows,), device=dev, generator=g)
    x = reps[pick] + 1e-2 * torch.randn(rows, d, device=dev, generator=g)
    x64, r64 = x.double(), reps.double()
    d64 = ((x64 * x64).sum(1)[:, None] + (r64 * r64).sum(1)[None, :]
           - 2.0 * (x64 @ r64.T))
    want = torch.sort(d64, 1).values[:, :k]
    del d64
    dk, _ = distance_topk(x, reps, k)
    dp, _ = distance_topk_ref(x, reps, k)
    err_tc = float((dk.double() - want).abs().max())
    err_f32 = float((dp.double() - want).abs().max())
    log(f"distance_topk[tc near-duplicates] {rows}x{c}x{d} k={k}, |x|^2 "
        f"{float((x64 * x64).sum(1).mean()):.1f}, own-rep d2 "
        f"{float(want[:, 0].mean()):.4f}: error against float64 tc "
        f"{err_tc:.3g}, plain float32 {err_f32:.3g} (allowed 2x: "
        f"{2 * err_f32:.3g})")
    assert 0 < err_f32 and err_tc <= 2 * err_f32, (err_tc, err_f32)
    out.append({"label": "near-duplicates", "shape": [rows, c, d, k],
                "dtype": "float32", "err_vs_float64": err_tc,
                "plain_err_vs_float64": err_f32})
    return out


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
    """Each mode against the plain version (rtol 1e-5; categorical exact
    but where the plain top-2 votes tie to float32 rounding), the top1
    prescale against tie_break_prescale bit for bit; per mode the wrapper's
    CUDA-event time, the kernels' own device time and kernels per call
    (torch.profiler: 1 for numeric and categorical, at most 2 for top1)."""
    from repro_torch.kernels.distance_topk.ops import PAD_DIST
    from repro_torch.kernels.propagate.ops import propagate
    from repro_torch.kernels.propagate.ref import (masked_weights,
                                                   propagate_ref,
                                                   tie_break_prescale)
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
        call = lambda: propagate(scores, ids, d2, mode, **kw)  # noqa: E731
        ms = time_ms(call, 50)
        own = own_time(call, 20, "propagate")
        assert len(own["kernels"]) <= (2 if mode == "top1" else 1), own
        plain_ms = time_ms(
            lambda: propagate_ref(scores, ids, d2, mode, **kw), 10)
        modes[mode] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       **own}
        log(f"propagate[{mode}] {n}x{k}, C={c}: max_abs_err {err:.3g}, "
            f"kernel {ms:.4f} ms (own device time {own['device_ms']:.4f} ms,"
            f" {len(own['kernels'])} kernel(s) a call), plain "
            f"{plain_ms:.4f} ms")
    # the prescale the card computed, read back where the nearest rep of
    # row 0 scores 0 at distance 1: out[0] = -prescale
    sc0, ids0, d20 = numeric.clone(), ids.clone(), d2.clone()
    sc0[0], ids0[0, 0], d20[0, 0] = 0.0, 0, 1.0
    got = -propagate(sc0, ids0, d20, "top1")[0]
    want = tie_break_prescale(sc0, d20)
    assert got.view(torch.int32) == want.view(torch.int32), (got, want)
    modes["top1"]["prescale"] = float(want)
    log(f"propagate[top1] prescale on the card {float(got):.9g}, "
        f"tie_break_prescale {float(want):.9g}: bitwise equal")
    ops_per_row = {"numeric": 6 * k, "top1": 4, "categorical": 6 * k * k}
    b, by = bound_ms(8 * n * k + 4 * c + 4 * n, ops_per_row["numeric"] * n)
    log(f"propagate bound {b:.4f} ms ({by})")
    return {"name": "propagate", "shape": [n, k, c],
            "max_abs_err": max(m["max_abs_err"] for m in modes.values()),
            "ms": modes["numeric"]["ms"],
            "device_ms": modes["numeric"]["device_ms"],
            "plain_ms": modes["numeric"]["plain_ms"], "bound_ms": b,
            "bound_by": by, "library_ms": None, "modes": modes}


def attention_pairs(s: int, skv: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of one (batch, head): the work this
    input needs (a row with no key left needs none)."""
    qpos = np.arange(s)
    hi = np.minimum(qpos, skv - 1) if causal else np.full(s, skv - 1)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(s, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def attention_bound(b, s, skv, h, hk, hd, dtype, causal, window):
    """(bound ms, what bounds it, flops): 4 * hd flops per unmasked pair
    over the peak for the input type, against q, k, v read once and the
    output written once."""
    n_flops = 4.0 * hd * b * h * attention_pairs(s, skv, causal, window)
    item = torch.finfo(dtype).bits // 8
    n_bytes = item * hd * (2 * b * s * h + 2 * b * skv * hk)
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    return (*bound_ms(n_bytes, n_flops, peak), n_flops)


# Kernel against plain attention: ``ref.allowed_error``, element by element.
# float32 at 2e-3, bf16 at rtol 1.6e-2, atol 2e-3 (``ref.ATTN_TOL``); the tc
# path also rounds P to bf16 before P.V, so there each element may move, in
# addition, by up to twice (``ref.WITNESS_P``) what that rounding alone moves
# it in the witness ``flash_attention_ref(..., round_p=True)``.  Shape a also
# holds a planted fault (``check_planted_fault``) that the rule must reject.


def sdpa_ms(q, k, v, causal: bool, window: int, iters: int) -> float:
    """``scaled_dot_product_attention`` on the same inputs (heads moved to
    dim 1, GQA, the same boolean band mask; no mask where nothing is
    masked): the library yardstick, used nowhere in the port."""
    import torch.nn.functional as F
    s, skv = q.shape[1], k.shape[1]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    mask = None
    if causal or window:
        qpos = torch.arange(s, device=q.device)[:, None]
        kpos = torch.arange(skv, device=q.device)[None, :]
        mask = torch.ones(s, skv, dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos >= kpos
        if window:
            mask &= qpos - kpos < window
    ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), iters)
    del qt, kt, vt, mask
    return ms


def check_planted_fault(q, k, v, causal: bool, window: int, want, allowed):
    """The check must reject a kernel that drops a key tile: the kernel run
    with v zeroed over the 128 keys at the window's lower edge of the last
    128 query rows, held to the clean inputs' ``allowed``.  Returns the
    elements outside, in all and in those last rows, where the tile is the
    window's edge and only partly inside it."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    s = q.shape[1]
    e0 = max(0, s - 128 - window + 1) // 128 * 128
    vz = v.clone()
    vz[:, e0:e0 + 128] = 0
    got = flash_attention(q, k, vz, causal=causal, window=window).float()
    bad = (got - want).abs() > allowed
    out = {"keys": [e0, e0 + 128], "outside": int(bad.sum()),
           "outside_last_rows": int(bad[:, -128:].sum()),
           "elements": bad.numel(), "elements_last_rows": bad[:, -128:].numel()}
    del vz, got, bad
    log(f"planted fault (v zeroed at keys {e0}..{e0 + 127}): "
        f"{out['outside']} of {out['elements']} elements outside, "
        f"{out['outside_last_rows']} of {out['elements_last_rows']} in the "
        f"last 128 query rows")
    assert out["outside"] > 0 and out["outside_last_rows"] > 0, out
    return out


def check_flash_attention(dev, label: str, b: int, s: int, h: int, hk: int,
                          hd: int, dtype, causal: bool, window: int,
                          path: str, skv: int = None, timed: bool = True,
                          iters: int = 5):
    """The kernel against its plain version on the same inputs
    (``allowed_error``, with the P-rounding witness on the tc path); it must
    take ``path``.  With ``timed``, kernel, plain and
    ``scaled_dot_product_attention`` ms."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         flash_route)
    from repro_torch.kernels.flash_attention.ref import (ATTN_TOL,
                                                         WITNESS_P,
                                                         allowed_error,
                                                         flash_attention_ref)
    skv = s if skv is None else skv
    g = torch.Generator(device=dev).manual_seed(s + hd)
    q = torch.randn(b, s, h, hd, device=dev, generator=g).to(dtype)
    k = torch.randn(b, skv, hk, hd, device=dev, generator=g).to(dtype)
    v = torch.randn(b, skv, hk, hd, device=dev, generator=g).to(dtype)
    assert flash_route(q, k) == path, (label, flash_route(q, k), path)
    got = flash_attention(q, k, v, causal=causal, window=window)
    want, allowed = allowed_error(q, k, v, causal, window,
                                  round_p=path == "tc")
    torch.cuda.synchronize()
    tol = ATTN_TOL[dtype]
    diff = (got.float() - want).abs()
    err = float(diff.max())
    outside = int((diff > allowed).sum())
    # the witness's largest distance from the plain version, for the record
    wit_err = None
    if path == "tc":
        base = tol["atol"] + tol["rtol"] * want.abs()
        wit_err = float((allowed - base).max()) / WITNESS_P
        del base
    assert outside == 0, (label, err, outside)
    planted = (check_planted_fault(q, k, v, causal, window, want, allowed)
               if label == "a" else None)
    del got, want, allowed, diff
    out = {"label": label, "path": path, "shape": [b, s, skv, h, hk, hd],
           "dtype": str(dtype)[6:], "causal": causal, "window": window,
           "max_abs_err": err, "tol": tol, "outside_tol": outside,
           "witness_err": wit_err, "planted": planted}
    line = (f"flash_attention[{label}] {path} q {(b, s, h, hd)} k "
            f"{(b, skv, hk, hd)} {str(dtype)[6:]} causal={causal} "
            f"window={window}: max_abs_err {err:.3g} (tol rtol "
            f"{tol['rtol']:g} atol {tol['atol']:g}"
            + ("" if wit_err is None else
               f" + 2x the P-rounding witness's error, at most {wit_err:.3g}")
            + f"; {outside} outside)")
    if not timed:
        log(line)
        return out
    ms = time_ms(lambda: flash_attention(q, k, v, causal=causal,
                                         window=window), iters)
    plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, causal=causal,
                                                   window=window), 2)
    lib_ms = sdpa_ms(q, k, v, causal, window, iters)
    bnd, by, flops = attention_bound(b, s, skv, h, hk, hd, dtype, causal,
                                     window)
    log(f"{line}, kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
        f"{plain_ms:.3f} ms, library {lib_ms:.3f} ms, bound {bnd:.4f} ms "
        f"({by})")
    out.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd,
               bound_by=by)
    return out


def time_flash_full(dev, cfg, seq: int, iters: int = 2):
    """One kernel launch at a full-width prefill layer's shape, beside
    ``scaled_dot_product_attention`` (no plain comparison: its (H, S, S)
    float32 scores would not fit)."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         flash_route)
    g = torch.Generator(device=dev).manual_seed(7)
    hd, h, hk = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q = torch.randn(1, seq, h, hd, device=dev, generator=g).bfloat16()
    k = torch.randn(1, seq, hk, hd, device=dev, generator=g).bfloat16()
    v = torch.randn(1, seq, hk, hd, device=dev, generator=g).bfloat16()
    path = flash_route(q, k)
    ms = time_ms(lambda: flash_attention(q, k, v, causal=True,
                                         window=cfg.sliding_window), iters)
    lib_ms = sdpa_ms(q, k, v, True, cfg.sliding_window, iters)
    bnd, by, flops = attention_bound(1, seq, seq, h, hk, hd, torch.bfloat16,
                                     True, cfg.sliding_window)
    log(f"flash_attention[prefill {seq}] {path} one launch {ms:.3f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s), library {lib_ms:.3f} ms, bound "
        f"{bnd:.4f} ms ({by})")
    return {"seq": seq, "path": path, "ms": ms, "library_ms": lib_ms,
            "plain_ms": None, "bound_ms": bnd, "bound_by": by}


# Logits of the bf16 model along two attention routes: one bf16 ulp (2^-8
# relative) of a differently rounded activation grows through 24 residual
# layers, and random weights leave near-ties among 32,000 logits that this
# noise flips.  So the kernel route is held against what rounding alone
# gives: the plain route against itself with its softmax and P.V sums taken
# in another order (keys reversed).  The kernel route may differ from the
# plain one by no more than WITNESS_RATIO times the witness's mean |d logit|,
# and agree on top-1 no less than the witness does, less WITNESS_TOP1_SLACK;
# BF16_LOGITS_MEAN is an absolute backstop.  In float32 rounding no longer
# hides the function: F32_LOGITS_TOL and top-1 >= 99% hold there.
BF16_LOGITS_MAX, BF16_LOGITS_MEAN = 0.25, 0.03
WITNESS_RATIO, WITNESS_TOP1_SLACK = 2.0, 0.02
F32_LOGITS_TOL = 1e-2


def check_logits(cmp: dict, what: str) -> None:
    assert cmp["max_abs"] <= BF16_LOGITS_MAX and \
        cmp["mean_abs"] <= BF16_LOGITS_MEAN, (what, cmp)


def logits_agreement(got: torch.Tensor, want: torch.Tensor, vocab: int):
    """(max abs diff, mean abs diff, top-1 agreement) over real vocab."""
    got, want = got[..., :vocab].float(), want[..., :vocab].float()
    diff = (got - want).abs()
    top1 = (got.argmax(-1) == want.argmax(-1)).float().mean()
    return float(diff.max()), float(diff.mean()), float(top1)


def plain_attention_keys_reversed(q, k, v, causal: bool = True,
                                  window: int = 0):
    """``flash_attention_ref`` with the key axis reversed: the same
    function, its softmax and P.V sums taken in the other order."""
    from repro_torch.kernels.flash_attention.ref import NEG_INF
    b, s, h, hd = q.shape
    skv, hk = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, hk, h // hk, hd).float()
    scores = torch.einsum("bskgh,btkh->bkgst", qg,
                          k.flip(1).float()) / math.sqrt(hd)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(skv - 1, -1, -1, device=q.device)[None, :]
    mask = torch.ones((s, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    scores.masked_fill_(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", p, v.flip(1).float())
    return out.reshape(b, s, h, hd).to(q.dtype)


def compare_routes(cfg, params, tokens, prefill, prefill_plain) -> dict:
    """Kernel route against plain route over ``tokens``: in bf16 as served,
    with the keys-reversed plain route as the witness of rounding alone, and
    with the same weights cast to float32."""
    from unittest import mock

    from repro_torch.models import attention
    from repro_torch.models.common import tree_map
    short = {"tokens": tokens}
    out = {"tokens": tokens.shape[1]}
    lp = prefill_plain(params, short)
    for name in ("bf16", "witness"):
        if name == "bf16":
            lx = prefill(params, short)
        else:
            with mock.patch.object(attention, "flash_attention_ref",
                                   plain_attention_keys_reversed):
                lx = prefill_plain(params, short)
        mx, mean, top1 = logits_agreement(lx, lp, cfg.vocab_size)
        out[name] = {"max_abs": mx, "mean_abs": mean, "top1": top1}
        del lx
    del lp
    p32 = tree_map(lambda a: a.float(), params)
    lk, lp = prefill(p32, short), prefill_plain(p32, short)
    mx, mean, top1 = logits_agreement(lk, lp, cfg.vocab_size)
    out["f32"] = {"max_abs": mx, "mean_abs": mean, "top1": top1}
    del lk, lp, p32
    torch.cuda.empty_cache()
    for name, what in (("bf16", "kernel vs plain"),
                       ("witness", "plain keys reversed vs plain"),
                       ("f32", "kernel vs plain, weights cast to float32")):
        c = out[name]
        log(f"lm_prefill compare {out['tokens']} tokens, {name} ({what}): "
            f"max |d logits| {c['max_abs']:.4g}, mean {c['mean_abs']:.4g}, "
            f"top-1 agreement {c['top1']:.5f}")
    bf, wit, f32 = out["bf16"], out["witness"], out["f32"]
    assert bf["mean_abs"] <= min(WITNESS_RATIO * wit["mean_abs"],
                                 BF16_LOGITS_MEAN), (bf, wit)
    assert bf["top1"] >= wit["top1"] - WITNESS_TOP1_SLACK, (bf, wit)
    assert f32["max_abs"] <= F32_LOGITS_TOL and f32["top1"] >= 0.99, f32
    return out


def run_lm(dev, prefill_len: int, compare_len: int, profile):
    """lm_prefill, lm_serve and lm_decode_window at h2o-danube-3-4b's
    published widths."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         reset_launches)
    from repro_torch.launch import serve_lm
    from repro_torch.models import lm
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    cfg = get_config("h2o-danube-3-4b")
    n_attn = cfg.n_repeats * sum(sp.mixer == "attn" for sp in cfg.pattern)
    g = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = lm.init_model(cfg, g, device=dev)
    torch.cuda.synchronize()
    log(f"lm init: {cfg.name}, {cfg.param_count() / 1e9:.3f}B parameters (bf16, "
        f"seeded), {time.perf_counter() - t0:.2f} s")
    prefill = make_prefill_step(cfg)
    prefill_plain = make_prefill_step(cfg, attn_impl="plain")
    tokens = torch.randint(0, cfg.vocab_size, (1, prefill_len), device=dev,
                           generator=g)

    # the kernel route against the plain route on a prompt longer than the
    # window, so that its mask and the key-tile skipping take effect (this
    # also warms cuBLAS and the kernel up before the timed prefill)
    compare = compare_routes(cfg, params, tokens[:, :compare_len], prefill,
                             prefill_plain)

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with Phase("lm_prefill", profile) as ph:
        logits = prefill(params, {"tokens": tokens})
    prefill_launches = flash_attention.launches
    prefill_paths = dict(flash_attention.launches_by_path)
    prefill_s = ph.seconds
    finite = bool(torch.isfinite(logits).all())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"phase lm_prefill: {prefill_len} tokens in {ph.seconds:.3f} s "
        f"({prefill_len / ph.seconds:.1f} tok/s), logits "
        f"{tuple(logits.shape)} finite={finite}, flash launches "
        f"{prefill_launches} {prefill_paths}, peak device memory {peak:.2f} "
        f"GiB")
    assert logits.shape == (1, prefill_len, cfg.padded_vocab), logits.shape
    assert finite
    assert prefill_launches == n_attn, (prefill_launches, n_attn)
    assert prefill_paths == {"simt": 0, "tc": n_attn, "short": 0}, \
        prefill_paths
    del logits

    # lm_serve: replay prefill + greedy decode, batch 4, prompt 32 (a smoke
    # size: the cache holds 48 of the window's 4,096 keys)
    prompts = torch.randint(1, cfg.vocab_size, (4, 32), device=dev,
                            generator=g)
    reset_launches()
    with Phase("lm_serve", profile) as ph:
        out = serve_lm.serve(params, cfg, prompts, decode_steps=16)
    serve_launches = flash_attention.launches
    serve_paths = dict(flash_attention.launches_by_path)
    par = prefill(params, {"tokens": prompts})[:, -1]
    smx, smean, stop1 = logits_agreement(out["last_logits"], par,
                                         cfg.vocab_size)
    serve_cmp = {"max_abs": smx, "mean_abs": smean, "top1": stop1}
    tok_s = prompts.shape[0] * 16 / out["decode_s"]
    log(f"phase lm_serve: {ph.seconds:.3f} s; replay prefill "
        f"{out['prefill_s']:.3f} s, decode 16 steps x batch 4 "
        f"{out['decode_s']:.3f} s ({tok_s:.1f} tok/s, smoke size); flash "
        f"launches {serve_launches} (the decode path runs plain attention, as "
        f"the reference's does); replay vs lm_logits at the last prompt "
        f"position: max |d| {smx:.4g}, mean {smean:.4g}, top-1 {stop1:.3f}")
    check_logits(serve_cmp, "lm_serve replay vs lm_logits")

    # lm_decode_window: decode with the window full.  Seeded random keys
    # and values in 4,096 cache slots stand in for a replayed 4,096-token
    # prompt (the replay alone would take minutes); then 16 greedy steps
    # at positions 4,096.., each attending to the window's 4,096 keys.
    ctx, steps = cfg.sliding_window or 4096, 16
    caches = lm.init_cache(cfg, prompts.shape[0], ctx + steps, device=dev)
    for layer in caches:
        for t in layer.values():
            t.normal_(generator=g)
    step = make_serve_step(cfg)
    tok = prompts[:, -1:]
    reset_launches()
    with Phase("lm_decode_window", profile) as ph:
        for t in range(steps):
            lg, caches = step(params, caches, tok, ctx + t)
            tok = torch.argmax(lg[:, :, :cfg.vocab_size], dim=-1)
    window_launches = flash_attention.launches
    window_paths = dict(flash_attention.launches_by_path)
    win_tok_s = prompts.shape[0] * steps / ph.seconds
    log(f"phase lm_decode_window: {steps} steps x batch {prompts.shape[0]} "
        f"at cache {ctx} in {ph.seconds:.3f} s ({win_tok_s:.1f} tok/s, "
        f"{1e3 * ph.seconds / steps:.2f} ms per step); flash launches "
        f"{window_launches}")
    assert bool(torch.isfinite(lg).all())
    del caches
    return {"prefill": {"tokens": prefill_len, "seconds": prefill_s,
                        "launches": prefill_launches,
                        "launches_by_path": prefill_paths, "peak_gib": peak,
                        "compare": compare},
            "serve": {"launches": serve_launches,
                      "launches_by_path": serve_paths, "decode_tok_s": tok_s,
                      "decode_s": out["decode_s"],
                      "replay_prefill_s": out["prefill_s"], **serve_cmp},
            "decode_window": {"cache": ctx, "steps": steps,
                              "batch": prompts.shape[0],
                              "seconds": ph.seconds, "tok_s": win_tok_s,
                              "launches": window_launches,
                              "launches_by_path": window_paths},
            "cfg": cfg}


# The card's training against the CPU's plain path: one step each of
# train_embedder and pretrain_embedder from the same weights on the same
# batch, float32 with TF32 off.  Weights to rtol 1e-5 and atol 1e-5 (a fifth
# of the first triplet step, lr 1e-3 / 20 warm-up steps, for weights whose
# gradient lies near Adam's eps); the MLP's last bias has a zero gradient
# under the triplet loss (it shifts every embedding alike), noise that
# Adam's normalised step moves by up to lr: held to 2 x lr.
TRAIN_TOL = {"rtol": 1e-5, "atol": 1e-5}
SHIFT_BOUND = 2 * 1e-3 / 20


def check_training_steps(dev, feats: np.ndarray, triples: np.ndarray,
                         embed_dim: int) -> dict:
    from repro_torch.core import baselines, triplet
    from repro_torch.core.embedder import Embedder, EmbedderConfig
    ecfg = EmbedderConfig(feature_dim=feats.shape[1], embed_dim=embed_dim)
    init = Embedder(ecfg, torch.Generator().manual_seed(5)).state_dict()
    out = []
    for where in ("cpu", dev):
        model = Embedder(ecfg)
        model.load_state_dict(init)
        model.to(where)
        _, hist = triplet.train_embedder(model, feats, triples,
                                         triplet.TripletConfig(steps=1))
        pre = baselines.pretrain_embedder(feats, ecfg, steps=1, seed=6,
                                          device=where, encoder_init=init)
        out.append((hist[0], {k: v.cpu() for k, v in
                              model.state_dict().items()},
                    {k: v.cpu() for k, v in pre.state_dict().items()}))
    (l0, w0, p0), (l1, w1, p1) = out
    res = {"triplet_loss_cpu": l0, "triplet_loss_card": l1}
    assert abs(l1 - l0) <= 1e-5 * abs(l0), res
    for what, a, b in (("train_embedder", w0, w1),
                       ("pretrain_embedder", p0, p1)):
        worst = 0.0
        for k in a:
            d = float((b[k] - a[k]).abs().max())
            if what == "train_embedder" and k == "layers.2.bias":
                assert d <= SHIFT_BOUND, (k, d)
                res["shift_bias_abs_diff"] = d
                continue
            torch.testing.assert_close(b[k], a[k], **TRAIN_TOL)
            worst = max(worst, float(((b[k] - a[k]).abs()
                                      / (a[k].abs() + 1e-6)).max()))
        res[f"{what}_max_rel_diff"] = worst
    log(f"tasti_t training, card vs CPU plain path (one step each, batch "
        f"256, float32, TF32 off): triplet loss {l1:.7f} vs {l0:.7f}; "
        f"weights max rel diff train_embedder "
        f"{res['train_embedder_max_rel_diff']:.3g}, pretrain_embedder "
        f"{res['pretrain_embedder_max_rel_diff']:.3g} (tol rtol 1e-5 atol "
        f"1e-5), last bias {res['shift_bias_abs_diff']:.3g} (<= "
        f"{SHIFT_BOUND:.3g})")
    return res


def run_tasti_t(dev, wl, n_train: int, n_reps: int, specs, profile,
                pt_rows) -> dict:
    """tasti_t: the paper's TASTI-T build (the default TastiConfig:
    pre-training, FPF-mined training set, triplet training, 7,000 reps)
    over the workload, then one three-spec session over its index."""
    from unittest import mock

    from repro_torch.core import pipeline
    from repro_torch.core.engine import QueryEngine
    from repro_torch.core.pipeline import TastiConfig, build_tasti
    from repro_torch.core.session import QuerySession
    from repro_torch.kernels.distance_topk import ops as topk_ops
    from repro_torch.kernels.distance_topk.ops import distance_topk
    from repro_torch.kernels.fpf_update.ops import fpf_update
    from repro_torch.kernels.propagate import ops as propagate_ops
    from repro_torch.kernels.propagate.ops import propagate

    cfg = TastiConfig(n_train=n_train, n_reps=n_reps)
    stage_s, seen = {}, {}

    def timed(names, fn):
        """``fn`` with its seconds (the card synchronised after it) logged
        under the next of ``names``; keeps its last call's arguments."""
        names = iter(names)

        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            stage_s[next(names)] = time.perf_counter() - t0
            seen[fn.__name__] = a
            return out

        return run

    # the build's stages, timed around the functions build_tasti calls
    stages = [("pretrain_embedder", ["pretrain"]),
              ("embed_all", ["embed", "embed_trained"]),
              ("fpf_select", ["mine_fpf"]),
              ("mine_triplets", ["mine_triplets"]),
              ("train_embedder", ["train_embedder"])]
    fpf_update.launches = 0
    topk_ops.reset_launches()
    propagate_ops.reset_launches()
    with contextlib.ExitStack() as patches:
        for fn, names in stages:
            patches.enter_context(mock.patch.object(
                pipeline, fn, timed(names, getattr(pipeline, fn))))
        patches.enter_context(mock.patch.object(
            pipeline.TastiIndex, "build",
            staticmethod(timed(["index"], pipeline.TastiIndex.build))))
        with Phase("tasti_t", profile) as ph:
            system = build_tasti(wl, cfg, variant="T", device=dev)
    build_s = ph.seconds
    st = dict(system.build_stats, stage_s=stage_s,
              train_ids=seen["mine_triplets"][0])
    triples = seen["train_embedder"][2]
    assert len(triples) == st["n_triples"]
    build_paths = dict(distance_topk.launches_by_path)
    fpf_launches = fpf_update.launches
    losses = st["triplet_losses"]
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    log(f"phase tasti_t build: {build_s:.2f} s; stages (s) " + ", ".join(
        f"{k} {v:.3f}" for k, v in st["stage_s"].items())
        + f"; fpf_update launches {fpf_launches}, distance_topk launches "
        f"{distance_topk.launches} {build_paths}; {st['n_triples']} triples "
        f"from {len(st['train_ids'])} training records; triplet loss first "
        f"{losses[0]:.4f} last {losses[-1]:.4f} (means of 20: {first:.4f} -> "
        f"{last:.4f}); cost {vars(system.index.cost)}")
    assert len(losses) == cfg.triplet.steps and np.isfinite(losses).all()
    assert last < first, (first, last)
    assert build_paths["simt"] == 0 and build_paths["tc"] > 0, build_paths
    assert fpf_launches > 0
    index = system.index
    assert np.isfinite(index.topk_d2).all()
    assert index.topk_ids.shape == (len(wl.features), cfg.k)

    engine = QueryEngine(index, wl, crack=True)
    assert engine.resident.enabled
    with Phase("tasti_t_session", None) as ph:
        out = QuerySession(engine, specs).execute()
    true_mean = float(wl.counts.mean())
    agg = out.results[0]
    log(f"phase tasti_t session: {ph.seconds:.2f} s")
    for r, pt in zip(out.results, pt_rows):
        log(f"  {r.kind}: estimate {r.estimate} ci {r.ci_half_width} "
            f"invocations {r.n_invocations} fresh {r.n_oracle_fresh} cached "
            f"{r.n_oracle_cached} cracked {r.n_cracked}; PT index, session "
            f"1: fresh {pt[0]} cached {pt[1]}")
    assert abs(agg.estimate - true_mean) <= 3 * agg.ci_half_width, \
        (agg.estimate, agg.ci_half_width, true_mean)
    crack_paths = {r: n - build_paths[r]
                   for r, n in distance_topk.launches_by_path.items()}
    assert crack_paths["simt"] == 0, crack_paths
    launches = {"fpf_update": fpf_launches,
                "distance_topk": distance_topk.launches,
                "propagate": propagate.launches}
    log(f"launches on the tasti_t path: {launches}; distance_topk by route: "
        f"build {build_paths}, cracks {crack_paths}")
    steps = check_training_steps(dev, wl.features[st["train_ids"]],
                                 triples, cfg.embed_dim)
    return {"build_s": build_s, "session_s": ph.seconds,
            "stage_s": st["stage_s"],
            "n_triples": st["n_triples"], "loss_first": losses[0],
            "loss_last": losses[-1], "loss_mean_first20": first,
            "loss_mean_last20": last, "launches": launches,
            "distance_topk_by_route": {"build": build_paths,
                                       "cracks": crack_paths},
            "session": [(r.kind, r.n_oracle_fresh, r.n_oracle_cached)
                        for r in out.results],
            "card_vs_cpu": steps}


def token_nll(cfg, params, batch, attn_impl: str) -> torch.Tensor:
    """Per-token cross-entropy (B, S) of the LM over the real vocabulary."""
    from repro_torch.models import lm
    logits = lm.lm_logits(params, {"tokens": batch["tokens"]}, cfg,
                          attn_impl=attn_impl)[..., :cfg.vocab_size].float()
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, batch["targets"][..., None])[..., 0])


# The bf16 train step held against float32: step 1 of make_train_step at
# h2o-danube-3-4b's widths, depth cut to LM_STEP_DEPTH layers (a float32
# recompute without remat keeps every layer's (32, S, S) scores), against
# autograd of the same loss on the same weights cast to float32, remat off,
# and the AdamW formula written out here in float64.  Bounds: bf16
# rounding moves the gradient by ~1% of its size (LM_GRAD_RTOL, on the
# norm and on each leaf's first moment, relative L2); Adam's first step is
# lr x sign(g) (+ decay), so an element's update may differ where that
# noise flips the sign of a small gradient, but not where the reference's
# |g| is at least LM_LARGE_G of its leaf's RMS: there at most LM_FLIP_SHARE
# of the elements lie more than one bf16 ulp from the reference.  Each
# planted fault (the update's sign, 2 x lr, no gradient, two leaves'
# gradients swapped) must be rejected (a swap agrees in sign, so within an
# ulp, on about half the elements).
LM_STEP_DEPTH = 2
LM_GRAD_RTOL = 3e-2
LM_LARGE_G = 0.1
LM_FLIP_SHARE = 1e-3


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance in bf16 ulps between two bf16 tensors (int32)."""
    def ordered(x):
        i = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def adamw_step1_reference(p0: torch.Tensor, g: torch.Tensor, gnorm: float,
                          opt, lr: float) -> torch.Tensor:
    """The parameter after AdamW's first step from ``p0`` with gradient
    ``g`` of global norm ``gnorm``, in float64: clip, moments, bias
    corrections, decoupled decay."""
    scale = min(1.0, opt.clip_norm / (gnorm + 1e-9))
    gs = g.double() * scale
    m_hat = (1 - opt.b1) * gs / (1 - opt.b1)
    v_hat = (1 - opt.b2) * gs * gs / (1 - opt.b2)
    p = p0.double()
    return p - lr * (m_hat / (v_hat.sqrt() + opt.eps) + opt.weight_decay * p)


def check_lm_train_step(dev, cfg, opt, batch) -> dict:
    """make_train_step's first step (bf16 params, float32 moments, remat,
    in-place chunked AdamW) at full width and depth LM_STEP_DEPTH against
    the float32 reference above; returns the readings."""
    import dataclasses

    from repro_torch.models import lm
    from repro_torch.models.common import (tree_leaves,
                                           tree_leaves_with_names, tree_map)
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train.steps import make_train_step

    cut = dataclasses.replace(cfg, n_layers=LM_STEP_DEPTH)
    f32 = dataclasses.replace(cut, dtype="float32", param_dtype="float32",
                              remat="none")
    params = lm.init_model(cut, torch.Generator(device=dev).manual_seed(1),
                           device=dev)
    p0 = [p.detach().clone() for p in tree_leaves(params)]
    ref_params = tree_map(lambda p: p.detach().float().requires_grad_(True),
                          params)
    ref_leaves = tree_leaves(ref_params)
    with torch.enable_grad():
        ref_loss, _ = lm.lm_loss(ref_params, batch, f32, attn_impl="plain")
        g32 = [g.detach() for g in torch.autograd.grad(ref_loss, ref_leaves)]
    ref_loss = float(ref_loss.detach())
    del ref_params, ref_leaves
    ref_norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in g32)))

    opt_state = init_opt_state(params, opt)
    params, opt_state, m = make_train_step(cut, opt, attn_impl="plain")(
        params, opt_state, batch)
    lr, gnorm = float(m["lr"]), float(m["grad_norm"])
    names, got = zip(*tree_leaves_with_names(params))
    mu = tree_leaves(opt_state["mu"])
    scale = min(1.0, opt.clip_norm / (ref_norm + 1e-9))

    def outside(i, g, lr_i=lr, sign=1.0, every=False):
        """Share of leaf i's elements (those of a large reference gradient
        unless ``every``) more than one bf16 ulp from the reference."""
        want = adamw_step1_reference(p0[i], g, ref_norm, opt, sign * lr_i)
        far = bf16_ulps(got[i], want.to(torch.bfloat16)) > 1
        if not every:
            a = g32[i].abs()
            far = far[a >= LM_LARGE_G * a.square().mean().sqrt()]
        return float(far.double().mean())

    rows = {}
    for i, name in enumerate(names):
        m_ref = (1 - opt.b1) * scale * g32[i].double()
        rows[name] = {
            "moment_rel_l2": float((mu[i].double() - m_ref).norm()
                                   / m_ref.norm()),
            "outside_share": outside(i, g32[i]),
            "outside_share_all": outside(i, g32[i], every=True),
            "moved_share": float((got[i] != p0[i]).double().mean())}
    # planted faults, on the largest leaf of the layers (every element has
    # a gradient there, unlike the embedding's rows of absent tokens) and on
    # the first pair of leaves of one shape (their gradients swapped)
    big = max((i for i, n in enumerate(names) if n.startswith("blocks")),
              key=lambda i: got[i].numel())
    pair = next((i, j) for i in range(len(got)) for j in range(i + 1, len(got))
                if got[i].shape == got[j].shape)
    faults = {"sign": outside(big, g32[big], sign=-1.0),
              "2 x lr": outside(big, g32[big], lr_i=2 * lr),
              "no gradient": outside(big, torch.zeros_like(g32[big])),
              f"swap {names[pair[0]]}/{names[pair[1]]}": min(
                  outside(pair[0], g32[pair[1]]),
                  outside(pair[1], g32[pair[0]]))}
    worst_moment = max(r["moment_rel_l2"] for r in rows.values())
    worst_share = max(r["outside_share"] for r in rows.values())
    worst_all = max(r["outside_share_all"] for r in rows.values())
    log(f"lm_train step 1 vs float32 reference ({cfg.name} widths, "
        f"{LM_STEP_DEPTH} layers, S {batch['tokens'].shape[1]}): loss "
        f"{float(m['loss']):.5f} vs {ref_loss:.5f}; grad norm "
        f"{gnorm:.5f} vs {ref_norm:.5f}; worst leaf: first moment rel L2 "
        f"{worst_moment:.4g} (<= {LM_GRAD_RTOL}), share of elements > 1 bf16 "
        f"ulp from the reference where |g| >= {LM_LARGE_G} RMS "
        f"{worst_share:.4g} (<= {LM_FLIP_SHARE}), of all elements "
        f"{worst_all:.4g}; planted faults, share outside: " + ", ".join(
            f"{k} {v:.4f}" for k, v in faults.items()))
    for name, r in rows.items():
        log(f"    {name}: moment rel L2 {r['moment_rel_l2']:.4g}, outside "
            f"{r['outside_share']:.4g} (all {r['outside_share_all']:.4g}), "
            f"moved {r['moved_share']:.4f}")
    assert abs(gnorm - ref_norm) <= LM_GRAD_RTOL * ref_norm, (gnorm, ref_norm)
    assert worst_moment <= LM_GRAD_RTOL, rows
    assert worst_share <= LM_FLIP_SHARE, rows
    assert all(v > LM_FLIP_SHARE for v in faults.values()), faults
    del params, opt_state, got, mu, p0, g32
    torch.cuda.empty_cache()
    return {"depth": LM_STEP_DEPTH, "loss": float(m["loss"]),
            "loss_f32": ref_loss, "grad_norm": gnorm,
            "grad_norm_f32": ref_norm, "worst_moment_rel_l2": worst_moment,
            "worst_outside_share": worst_share,
            "worst_outside_share_all": worst_all, "planted_faults": faults,
            "leaves": rows}


def run_lm_train(dev, seq: int, steps: int, profile) -> dict:
    """lm_train: make_train_step at h2o-danube-3-4b's published widths
    (seeded bf16 weights, float32 moments, remat per block, the plain
    attention route), ``steps`` steps at batch 1 x ``seq``."""
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenDataset
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         reset_launches)
    from repro_torch.models import attention, lm
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim.adamw import OptimizerConfig, init_opt_state
    from repro_torch.train.steps import make_train_step

    cfg = get_config("h2o-danube-3-4b")
    assert cfg.remat == "full" and cfg.param_dtype == "bfloat16"
    # warm-up 1: the first step takes the peak lr, so that every bf16 leaf
    # moves (half an ulp of a norm scale of 1.0 is 2^-9)
    opt = OptimizerConfig(peak_lr=3e-3, min_lr=3e-4, warmup_steps=1,
                          total_steps=steps, state_dtype=cfg.opt_state_dtype)
    ds = TokenDataset(vocab_size=cfg.vocab_size, n_docs=16,
                      doc_len=seq + 64, seed=0)
    batches = [{k: torch.as_tensor(v, dtype=torch.long, device=dev)
                for k, v in ds.batch(0, i, 1, seq).items()}
               for i in range(steps)]
    t0 = time.perf_counter()
    step_check = check_lm_train_step(dev, cfg, opt, batches[0])
    log(f"lm_train step-1 check: {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    opt_state = init_opt_state(params, opt)
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    n_params = sum(p.numel() for p in leaves)
    log(f"lm_train init: {cfg.name}, {n_params / 1e9:.3f}B parameters (bf16, "
        f"seeded), moments {cfg.opt_state_dtype}, remat {cfg.remat}, "
        f"{time.perf_counter() - t0:.2f} s, device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    # the kernel's forward against the trainer's: per-token loss of the
    # kernel (tc) route and of the plain route beside the witness of bf16
    # rounding alone (the plain route with keys reversed), as lm_prefill
    # holds its logits
    reset_launches()
    with torch.no_grad():
        nll_k = token_nll(cfg, params, batches[0], "kernel")
        k_launches = dict(flash_attention.launches_by_path)
        nll_p = token_nll(cfg, params, batches[0], "plain")
        with mock.patch.object(attention, "flash_attention_ref",
                               plain_attention_keys_reversed):
            nll_w = token_nll(cfg, params, batches[0], "plain")
    d_kernel = float((nll_k - nll_p).abs().mean())
    d_witness = float((nll_w - nll_p).abs().mean())
    loss_kernel, loss_plain = float(nll_k.mean()), float(nll_p.mean())
    del nll_k, nll_p, nll_w
    assert k_launches == {"simt": 0, "tc": cfg.n_layers, "short": 0}, \
        k_launches
    samples = [p.detach().reshape(-1)[::max(1, p.numel() // 65536)].clone()
               for p in leaves]
    step_fn = make_train_step(cfg, opt, attn_impl="plain")
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    rows = []
    with Phase("lm_train", profile) as ph:
        for i, batch in enumerate(batches):
            t1 = time.perf_counter()
            params, opt_state, m = step_fn(params, opt_state, batch)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
            rows.append({"step": i + 1, "loss": loss, "grad_norm": gnorm,
                         "lr": float(m["lr"]), "seconds": dt,
                         "tokens_s": seq / dt})
            log(f"  lm_train step {i + 1}: loss {loss:.5f} grad norm "
                f"{gnorm:.5f} lr {float(m['lr']):.2e} {dt:.3f} s "
                f"({seq / dt:.1f} tok/s)")
            assert math.isfinite(loss) and math.isfinite(gnorm), rows[-1]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    train_launches = flash_attention.launches
    changed = sum(not torch.equal(p.detach().reshape(-1)[
        ::max(1, p.numel() // 65536)], s) for p, s in zip(leaves, samples))
    warm = rows[1:] or rows
    step_s = sum(r["seconds"] for r in warm) / len(warm)
    log(f"phase lm_train: {steps} steps x batch 1 x {seq} tokens in "
        f"{ph.seconds:.3f} s; {step_s:.3f} s a step after the first "
        f"({seq / step_s:.1f} tok/s); peak device memory {peak:.2f} GiB; "
        f"{changed} of {len(leaves)} leaves changed; flash launches in the "
        f"steps {train_launches} (plain attention); step-1 loss "
        f"{rows[0]['loss']:.5f}, plain forward {loss_plain:.5f}, kernel "
        f"(tc) forward {loss_kernel:.5f}: mean |d token loss| kernel vs plain "
        f"{d_kernel:.4g}, witness (keys reversed) vs plain {d_witness:.4g}")
    assert changed == len(leaves), (changed, len(leaves))
    assert train_launches == 0
    assert d_kernel <= WITNESS_RATIO * d_witness, (d_kernel, d_witness)
    assert abs(loss_kernel - rows[0]["loss"]) <= \
        abs(loss_plain - rows[0]["loss"]) + WITNESS_RATIO * d_witness, \
        (loss_kernel, loss_plain, rows[0]["loss"], d_witness)
    del params, opt_state, leaves, samples, step_fn
    torch.cuda.empty_cache()
    return {"model": cfg.name, "params": n_params, "batch": 1, "seq": seq,
            "steps": rows, "seconds_per_step": step_s,
            "tokens_s": seq / step_s, "peak_gib": peak,
            "loss_check": {"kernel": loss_kernel, "plain": loss_plain,
                           "step1": rows[0]["loss"],
                           "mean_abs_kernel_vs_plain": d_kernel,
                           "mean_abs_witness_vs_plain": d_witness,
                           "kernel_launches": k_launches},
            "step1_vs_float32": step_check}


def run_lm_train_resilient(steps: int = 50, fail_at: int = 25) -> dict:
    """lm_train_resilient: ``repro_torch.launch.train`` (preset 100m) in a
    child process with a failure injected, into a temporary checkpoint
    directory that is removed afterwards."""
    import shutil
    import tempfile

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--preset",
             "100m", "--steps", str(steps), "--inject-failure-at",
             str(fail_at), "--ckpt-dir", ckpt_dir],
            cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
            capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        for line in lines:
            log(f"  train: {line}")
        if proc.returncode != 0:
            log(proc.stderr[-4000:])
        assert proc.returncode == 0, proc.returncode
        done = re.match(r"\[train\] done: (\d+) steps in \d+s, restarts=(\d+)"
                        r", first-loss=([\d.]+) last-loss=([\d.]+)", lines[-1])
        assert done and int(done[1]) == steps and int(done[2]) == 1, lines[-1]
        # the pipeline state rides in the checkpoint: its offset is the step
        last = max(int(p.name[5:]) for p in pathlib.Path(ckpt_dir).glob(
            "step_*"))
        d = pathlib.Path(ckpt_dir) / f"step_{last:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        with np.load(d / "arrays.npz") as arrays:
            offset = int(arrays[f"a{manifest['names'].index('2/1')}"])
        log(f"phase lm_train_resilient: {seconds:.2f} s, {done[1]} steps, "
            f"restarts {done[2]}, loss {done[3]} -> {done[4]}; checkpoint "
            f"step {last}: next_step {manifest['extra']['next_step']}, "
            f"pipeline offset {offset}")
        assert offset == manifest["extra"]["next_step"] == last
        return {"seconds": seconds, "steps": int(done[1]),
                "restarts": int(done[2]), "loss_first": float(done[3]),
                "loss_last": float(done[4]), "checkpoint_step": last,
                "pipeline_offset": offset}
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=7000)
    ap.add_argument("--check-rows", type=int, default=65536,
                    help="rows of the distance_topk plain comparison")
    ap.add_argument("--prefill-len", type=int, default=32768,
                    help="prompt length of the full-width lm_prefill")
    ap.add_argument("--compare-len", type=int, default=8192,
                    help="prompt length of the kernel-vs-plain LM comparison "
                         "(above the 4,096 window by default)")
    ap.add_argument("--n-train", type=int, default=3000,
                    help="training records of the tasti_t build (the "
                         "paper's 3,000)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="trace build_tasti, the first session, lm_prefill, "
                         "lm_serve, lm_decode_window and the embedder with "
                         "torch.profiler into "
                         "DIR and print each phase's device busy share")
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
    libs = _build.build_all()
    ptxas = ptxas_report(_build.build_dir(),
                         {n: p.stem.split("-")[-1] for n, p in libs.items()})
    log(f"build: {time.perf_counter() - t0:.2f} s ({ptxas_summary(ptxas)})")
    for name in ("flash_attention", "distance_topk", "propagate"):
        for fn, regs, spill in ptxas[name]:
            log(f"  ptxas {name} {fn}: {regs} registers, {spill} B spill "
                f"stores")

    from repro_torch.core.embedder import Embedder, EmbedderConfig
    from repro_torch.core.engine import QueryEngine, QuerySpec
    from repro_torch.core.pipeline import TastiConfig, build_tasti
    from repro_torch.core.propagation import propagate_numeric
    from repro_torch.core.schema import make_workload
    from repro_torch.core.session import QuerySession
    from repro_torch.kernels.distance_topk import ops as topk_ops
    from repro_torch.kernels.distance_topk.ops import distance_topk
    from repro_torch.core.embedder import embed_all
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         reset_launches)
    from repro_torch.kernels.fpf_update.ops import fpf_update
    from repro_torch.kernels.propagate import ops as propagate_ops
    from repro_torch.kernels.propagate.ops import propagate

    dev = torch.device("cuda", 0)
    cfg = TastiConfig(n_reps=args.reps, k=8, embed_dim=128,
                      random_fraction=0.1, seed=0)
    t0 = time.perf_counter()
    check_rows = min(args.check_rows, args.frames)
    results = [
        check_distance_topk(dev, check_rows, cfg.n_reps, cfg.embed_dim, cfg.k,
                            args.frames),
        check_fpf_update(dev, args.frames, cfg.embed_dim),
        check_propagate(dev, args.frames, cfg.n_reps, cfg.k),
    ]
    results[0]["checks"] = check_distance_topk_cases(dev, check_rows,
                                                     args.frames)
    torch.cuda.empty_cache()
    # flash_attention, timed: (a) a danube-3-4b layer (GQA 32/8, hd 120,
    # bf16, causal, window 4096; tc), the same in float32 (a32; simt), where
    # a wrong window edge or key-tile skip cannot hide in rounding; (b) the
    # transformer embedder's batch (f32, bidirectional, S 8, hd 64; short);
    # (c) a ragged S that is no tile multiple (f32; simt)
    flash = [
        check_flash_attention(dev, "a", 1, 8192, 32, 8, 120, torch.bfloat16,
                              True, 4096, "tc"),
        check_flash_attention(dev, "a32", 1, 8192, 32, 8, 120, torch.float32,
                              True, 4096, "simt"),
        check_flash_attention(dev, "b", 65536, 8, 4, 4, 64, torch.float32,
                              False, 0, "short"),
        check_flash_attention(dev, "c", 2, 1000, 8, 2, 64, torch.float32,
                              True, 0, "simt"),
    ]
    # correctness only: the tc path at hd 64, 80 and 128, S no multiple of
    # 128 and Skv != S, GQA ratios 1 and 4, rows with no key, a window
    # without causal; the short path at S 1, 8 and 32 in both dtypes
    bf, f32 = torch.bfloat16, torch.float32
    for label, b, s, skv, h, hk, hd, dtype, causal, window, path in [
            ("tc-hd64-gqa1", 2, 1000, 1000, 8, 8, 64, bf, True, 0, "tc"),
            ("tc-hd80-ragged", 2, 333, 333, 8, 2, 80, bf, True, 100, "tc"),
            ("tc-hd128-skv", 1, 700, 1500, 16, 4, 128, bf, True, 0, "tc"),
            ("tc-skv<s", 2, 1000, 300, 8, 2, 128, bf, False, 0, "tc"),
            ("tc-no-key", 1, 1200, 500, 8, 2, 64, bf, True, 256, "tc"),
            ("tc-window-only", 1, 1000, 1000, 8, 2, 120, bf, False, 200,
             "tc"),
            ("short-s1-f32", 4096, 1, 1, 4, 4, 64, f32, False, 0, "short"),
            ("short-s1-bf16", 4096, 1, 1, 4, 4, 64, bf, False, 0, "short"),
            ("short-s8-f32", 4096, 8, 8, 4, 4, 64, f32, False, 0, "short"),
            ("short-s8-bf16", 4096, 8, 8, 4, 4, 64, bf, False, 0, "short"),
            ("short-s32-f32", 1024, 32, 32, 2, 1, 64, f32, True, 0, "short"),
            ("short-s32-bf16", 1024, 32, 32, 4, 2, 64, bf, True, 8, "short"),
    ]:
        flash.append(check_flash_attention(
            dev, label, b, s, h, hk, hd, dtype, causal, window, path, skv=skv,
            timed=False))
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
    fpf_update.launches = 0
    topk_ops.reset_launches()
    propagate_ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with Phase("build_tasti", args.profile) as ph:
        system = build_tasti(wl, cfg, variant="PT", embed_params=params,
                             device=dev)
    index = system.index
    build_paths = dict(distance_topk.launches_by_path)
    log(f"phase build_tasti: {ph.seconds:.2f} s (reps {index.n_reps}, "
        f"fpf_update launches {fpf_update.launches}, distance_topk launches "
        f"{distance_topk.launches} {build_paths})")
    assert build_paths["simt"] == 0 and build_paths["tc"] > 0, build_paths
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
    n_cracked = 0
    for run in (1, 2):
        with Phase(f"session{run}", args.profile if run == 1 else None) as ph:
            out = QuerySession(engine, specs).execute()
        if run == 1:
            pt_rows = [(r.n_oracle_fresh, r.n_oracle_cached)
                       for r in out.results]
        log(f"phase session run {run}: {ph.seconds:.2f} s")
        for r in out.results:
            log(f"  {r.kind}: estimate {r.estimate} ci {r.ci_half_width} "
                f"selected {None if r.selected is None else len(r.selected)}"
                f" invocations {r.n_invocations} fresh {r.n_oracle_fresh} "
                f"cached {r.n_oracle_cached} cracked {r.n_cracked}")
        n_cracked += sum(r.n_cracked or 0 for r in out.results)
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
    topk_paths = {"build": build_paths, "cracks": {
        r: n - build_paths[r] for r, n in distance_topk.launches_by_path.items()}}
    log(f"distance_topk launches by route over the tasti path: {topk_paths}; "
        f"propagate launches by mode {propagate.launches_by_path}, top1 "
        f"prescales by the plain version {propagate.plain_prescales}")
    assert topk_paths["cracks"]["simt"] == 0, topk_paths
    assert topk_paths["cracks"]["tc"] > 0 or n_cracked == 0, topk_paths
    assert propagate.plain_prescales == 0
    log(f"launches on the main path: {launches}; engine {engine.stats}; "
        f"resident {engine.resident.stats}; index version {index.version}, "
        f"reps {index.n_reps}; true mean count {true_mean:.6f}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    assert all(v > 0 for v in launches.values()), launches
    assert engine.stats["proxy_device_computes"] > 0, engine.stats
    del engine, system, index
    torch.cuda.empty_cache()

    tasti_t = run_tasti_t(dev, wl, args.n_train, args.reps, specs,
                          args.profile, pt_rows)
    for name, n in tasti_t["launches"].items():
        launches[name] += n
    topk_paths["tasti_t"] = tasti_t.pop("distance_topk_by_route")
    torch.cuda.empty_cache()

    lm_out = run_lm(dev, args.prefill_len, args.compare_len, args.profile)
    torch.cuda.empty_cache()
    flash_full = time_flash_full(dev, lm_out["cfg"], args.prefill_len)
    torch.cuda.empty_cache()

    # embedder: the transformer backbone over the night-street records
    tcfg = EmbedderConfig(feature_dim=wl.features.shape[1],
                          embed_dim=cfg.embed_dim, backbone="tasti-embedder")
    model = Embedder(tcfg, generator=torch.Generator().manual_seed(0)).to(dev)
    batch = 65536
    reset_launches()
    with Phase("embedder", args.profile) as ph:
        emb = embed_all(model, wl.features, batch=batch)
    emb_launches = flash_attention.launches
    emb_paths = dict(flash_attention.launches_by_path)
    n_check = min(batch, args.frames)
    with torch.no_grad():
        plain = model(torch.as_tensor(wl.features[:n_check], device=dev),
                      attn_impl="plain").cpu().numpy()
    emb_err = float(np.abs(emb[:n_check] - plain).max())
    want_launches = -(-args.frames // batch) * model.backbone.n_layers
    log(f"phase embedder: {args.frames} records in {ph.seconds:.3f} s "
        f"({args.frames / ph.seconds:.0f} records/s), flash launches "
        f"{emb_launches} {emb_paths}; first {n_check} against the plain "
        f"route: max abs "
        f"err {emb_err:.3g} (tol rtol 2e-3 atol 2e-3; embeddings up to "
        f"{float(np.abs(plain).max()):.3g})")
    assert emb.shape == (args.frames, cfg.embed_dim) and np.isfinite(emb).all()
    np.testing.assert_allclose(emb[:n_check], plain, rtol=2e-3, atol=2e-3)
    assert emb_launches == want_launches, (emb_launches, want_launches)
    assert emb_paths == {"simt": 0, "tc": 0, "short": want_launches}, \
        emb_paths
    launches["flash_attention"] = (lm_out["prefill"]["launches"]
                                   + lm_out["serve"]["launches"]
                                   + lm_out["decode_window"]["launches"]
                                   + emb_launches)
    del model, emb, plain
    torch.cuda.empty_cache()

    lm_train = run_lm_train(dev, 4096, 3, args.profile)
    resilient = run_lm_train_resilient()

    sources = {"distance_topk": "src/repro/kernels/distance_topk/kernel.py:77",
               "fpf_update": "src/repro/kernels/fpf_update/kernel.py:34",
               "propagate": "src/repro/kernels/propagate/kernel.py:84",
               "flash_attention":
                   "src/repro/kernels/flash_attention/kernel.py:72"}
    # per kernel path: its timed shape (tc: a, simt: a32, short: b) and its
    # launches over the main path's phases
    by_label = {r["label"]: r for r in flash}
    phase_paths = [lm_out["prefill"]["launches_by_path"],
                   lm_out["serve"]["launches_by_path"],
                   lm_out["decode_window"]["launches_by_path"], emb_paths]
    paths = {}
    for path, label in (("tc", "a"), ("short", "b"), ("simt", "a32")):
        r = by_label[label]
        paths[path] = {"shape_label": label, "launches": sum(
            pp[path] for pp in phase_paths), **{k: r[k] for k in (
                "shape", "dtype", "ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "max_abs_err")}}
    paths["tc"]["prefill_full"] = flash_full
    paths["registers"] = {fn: {"registers": regs, "spill_bytes": spill}
                          for fn, regs, spill in ptxas["flash_attention"]}
    a = by_label["a"]
    results.append({
        "name": "flash_attention", "max_abs_err": max(
            r["max_abs_err"] for r in flash),
        **{k: a[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms")},
        "paths": paths, "checks": flash,
        "launches_by_phase": {"lm_prefill": lm_out["prefill"]["launches"],
                              "lm_serve": lm_out["serve"]["launches"],
                              "lm_decode_window":
                                  lm_out["decode_window"]["launches"],
                              "embedder": emb_launches},
        "lm_prefill": lm_out["prefill"], "lm_serve": lm_out["serve"],
        "lm_decode_window": lm_out["decode_window"]})
    results[0]["launches_by_path"] = topk_paths
    results[0]["registers"] = {fn: {"registers": regs, "spill_bytes": spill}
                               for fn, regs, spill in ptxas["distance_topk"]}
    results[2]["launches_by_path"] = dict(propagate.launches_by_path)
    results[2]["registers"] = {fn: {"registers": regs, "spill_bytes": spill}
                               for fn, regs, spill in ptxas["propagate"]}
    kernels = []
    for res in results:
        name = res["name"]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/csrc/{name}.cu",
                        "replaces": sources[name],
                        "launches": launches[name], **{
                            k: v for k, v in res.items() if k != "name"}})
    log("training paths: " + json.dumps({
        "tasti_t": tasti_t, "lm_train": lm_train,
        "lm_train_resilient": resilient}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
