"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU.

    python3 chip_smoke.py            # full width: 1M frames, 7,000 reps,
                                     # h2o-danube-3-4b, olmoe-1b-7b,
                                     # qwen2-vl-7b and phi3-medium-14b on
                                     # a 32,768-token prompt,
                                     # qwen3-moe-30b-a3b on 8,192,
                                     # seamless-m4t-large-v2 on 16,384
                                     # frames and 16,384 tokens

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
   tie_break_prescale; rmsnorm at phi3's prefill rows, OLMoE-1B-7B-0924's
   (several rows a block), the embedder's batch, a qk-norm and decode's
   1-8 rows (RMSNORM_CASES), within an ulp
   or two, beside its bytes bound and PyTorch's own ``rms_norm``.  Its
   launches are then counted phase by phase, the mesh phases' by their
   ranks: above zero wherever a model prefills or decodes, zero in the
   training steps (which take the plain norm).  moe_combine, the dropless
   MoE's combine, at OLMoE-1B-7B-0924's step and decode's rows
   (MOE_COMBINE_CASES), bit for bit its own order's plain sum and within a
   reordered sum's bound of the plain scatter-add, beside its bytes bound;
   one launch a layer of a forward of the dropless model at a small width.
   On the main path only moe_prefill_0924 (phase 9) launches it.
3. tasti: builds a TASTI index (``build_tasti``, variant PT, seeded random
   embedder weights) over the synthetic night-street video at 1M frames and
   serves a three-query session twice through a cracking ``QueryEngine``
   with resident scoring; every distance_topk launch of the build and of
   the cracks must take the tc route.
   serve: the same index saved and mounted with its label store in a
   ``QueryServer``: 8 x 4 concurrent ``QueryClient`` requests of the three
   kinds, a Poisson open loop (``OpenLoopGenerator``: p50/p90/p99, fresh
   and cached calls), a warm restart from the saved files that must cost 0
   fresh calls, and one session through two forked process replicas
   against two thread replicas; propagations must run on the card
   (resident computes above fallbacks) and every crack take the tc route.
4. lm_prefill: h2o-danube-3-4b at its published widths (seeded random bf16
   weights) through ``make_prefill_step`` on one 32,768-token prompt, every
   attention layer through the ``flash_attention`` kernel's tc path; the
   same model on 8,192 tokens against the plain attention route, in bf16
   and with the weights cast to float32, and its logits under
   ``shard_strategy`` seq_dp and ep_seq bitwise against megatron's.
5. lm_serve and lm_decode_window: the ``serve_lm`` path (replay prefill,
   greedy decode) at the same width, batch 4, prompt 32, 16 decode steps;
   16 decode steps with the 4,096-key window full, repeated under
   ``decode_cache_update="dus"`` for the same logits bit for bit.
   lm_decode_ring: the two-tier decode cache (``decode_ring`` 256) over a
   main cache of the same 4,096 seeded slots, 256 + 16 steps at batch 4,
   timed in turns with the masked decode, and held against it in float32
   (2e-3) while the ring holds every token; past 256 steps the reference
   forgets tokens, and the distance is reported.
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
9. The MoE, xLSTM and Mamba models, in an order that leaves the card empty
   for the largest: moe_prefill (olmoe-1b-7b at its published widths,
   seeded bf16 weights, one 32,768-token prompt through
   ``make_prefill_step``: 16 attention launches, all tc; dropped (token,
   choice) pairs counted; kernel against plain route at 8,192 tokens by the
   routed rule; one layer's stages timed), moe_decode (16 steps at batch 4
   after 4,096 seeded keys; a float32 replay of 4 x 32 against
   ``lm_logits``), moe_prefill_0924 (olmoe-1b-7b-0924, the dropless MoE,
   at its published widths on the benchmark cell's 8 x 4,096 tokens: 16
   attention launches, all tc, and 16 moe_combine launches, counted from
   0 just before the forward; these are the main path's combine launches
   in the ``kernels`` line), moe_train (``make_train_step`` at olmoe widths, 2
   layers, 3 steps of 1 x 4,096: the aux loss > 0, every leaf moves),
   xlstm (xlstm-350m forward over 4,096 tokens, the sLSTM loop's share; a
   float32 decode replay of 64 tokens), mamba_layer (one Mamba mixer at
   jamba-1.5-large's widths over 4,096 tokens; 512 float32 decode steps
   against it) and moe_prefill_qwen3 (qwen3-moe-30b-a3b, all 48 layers,
   56.9 GiB of bf16 weights, one 8,192-token prompt: 48 launches, all
   tc); then the kernel alone at both prefill shapes.
10. qwen2-vl-7b at its published widths (seeded bf16 weights, 256 seeded
   patch embeddings merged over the first positions, M-RoPE): the kernel
   route against the plain route at 8,192 tokens with the vision prefix
   (compare_routes); vlm_prefill (one 32,768-token prompt through
   ``make_prefill_step``: 28 launches, all tc, at a GQA group of 7);
   vlm_decode (16 greedy steps at batch 4 after 4,096 seeded cache slots;
   the card's replay, a 4 x 24 replay prefill and those steps, against
   the CPU's with the depth cut to 2 layers in float32); then the kernel
   alone at the prefill's shape, heads 0, 6, 7, 20, 21 and 27 each held
   against the plain version run on that head and its KV head.
11. seamless-m4t-large-v2 at its published widths (all 24 + 24 layers,
   seeded bf16 weights, seeded frame embeddings for the stubbed audio
   frontend): the kernel route against the plain route at 4,096 frames +
   4,096 tokens (compare_routes; float32 on the simt path);
   seamless_prefill (16,384 frames + 16,384 tokens through
   ``make_prefill_step``: 72 launches, all tc, bidirectional in the
   encoder and the cross-attention, Skv != S there at other lengths);
   seamless_decode (4,096 frames encoded on the card, the cross K/V
   filled as ``prefill`` fills them, 16 greedy steps at batch 4 after
   4,096 seeded self-attention slots; a float32 replay ``prefill`` of 4 x
   48 tokens over 256 frames against the parallel forward); then the
   kernel alone at (1, 16384, 16, 64), bidirectional and causal, each head
   held against the plain version on its own.
12. phi3-medium-14b at its published widths (40 layers, 40/10 heads, hd
   128, seeded bf16 weights, 27.3 GiB): the kernel route against the plain
   route at 8,192 tokens (compare_routes; float32 at 8 of the 40 layers);
   phi3_prefill (one 32,768-token prompt through ``make_prefill_step``: 40
   launches, all tc, and 81 rmsnorm launches, with launch/analytic.py's
   FLOPs); then the kernel
   alone at the prefill's shape, heads 0, 3, 4, 36 and 39 each held
   against the plain version on that head and its KV head.
13. The mesh layer (no kernel of its own), after the card is freed:
   compress (``compress_decompress`` with error feedback over a seeded
   bf16 gradient tree of every h2o-danube-3-4b leaf, 3.96B elements, 3
   rounds by CUDA events beside their byte bound; one leaf against the
   CPU bitwise; the convergence rule on 1M elements); then 4 spawned
   ranks sharing the card over gloo (NCCL takes one rank per GPU, so
   these times say nothing of NCCL across cards): compressed_psum (each
   rank's own seeded gradient of one danube block: means equal on every
   rank, within max|g|/64 of the true mean, errors g + e - dequant(q)),
   seq_dp_prefill (danube at full width under ``shard_strategy="seq_dp"``
   on a (1, 4) mesh, one 32,768-token prompt, 8,192 positions a rank;
   held to seq_dp in one process and to the plain and kernel routes),
   pipeline (danube's 24 blocks in 2 stages of 12 on 2 of the ranks,
   batch 4 x 4,096 in 4 microbatches, against the sequential blocks) and
   elastic_restore (``make_elastic_mesh()`` (1, 4); danube's embedding and
   one block restored with the placements of ``param_pspecs``, each rank's
   slice bitwise); then ``make_compressed_psum`` on a 1-rank NCCL group.
14. Compute on sharded weights (``parallel/tensor_parallel.py``): whether
   gloo takes CUDA tensors for reduce_scatter (gloo_probe), then 4 spawned
   ranks sharing the card over gloo, each holding only its slices of the
   weights (and moments), the one-process references on rank 0 first:
   megatron_prefill (phi3-medium-14b at full width and depth on a (1, 4)
   mesh, 8,192 tokens, 2.5 KV heads a rank, every attention call through
   the kernel's tc path on the rank's whole GQA groups; held to the
   one-process kernel route in bf16 and, at 8 layers, in float32),
   serve_fsdp_prefill (the same model on a (2, 2) mesh, two replicas of
   two-way tensor parallelism, a batch of 2 x 4,096 tokens, a prompt a
   data rank: each rank holds its ``lm.serve_pspecs`` slices, which the
   shipped budget splits over data too (fsdp), about a quarter of the
   weights, gathered a block at a time; held as megatron_prefill, its
   rank-0 weight bytes, launches and collectives against the dry run's),
   ep_prefill (olmoe-1b-7b on a (1, 4) mesh under megatron and ep_seq, 16
   experts a rank; drops with the one-process routing pinned equal to
   the one-process forward's) and megatron_train (one step of
   h2o-danube-3-4b with fsdp on a (2, 2) mesh, batch 2 x 2,048, against
   the one-process step's loss and gradients).
15. Decode and prefill over sharded caches (``lm.decode_step``,
   ``lm.prefill`` and ``make_serve_step`` with ``mesh=``): 4 spawned gloo
   ranks sharing the card, each holding only its serving slices of the
   weights and its ``cache_pspecs`` slices of every cache, the
   one-process references (bf16, the witness with every weight one ulp
   off, float32 at reduced depth and its witnesses) on rank 0 first: sharded_decode
   (phi3-medium-14b under megatron on (1, 4), batch 4, 8,192 seeded
   slots, 2,048 a rank, 16 steps of a seeded token stream),
   sharded_decode_xlstm (xlstm-350m, batch 4, 16 steps after a 64-token
   sharded prefill, its states split by channel), sharded_decode_long
   (h2o-danube-3-4b, batch 1, on (2, 2): 32,768 seeded slots over
   ("data", "model"), 8,192 a rank, most of them outside the window) and
   sharded_decode_long_ring (the same with ``decode_ring`` 256, the rings
   split on head_dim), sharded_seamless (seamless-m4t-large-v2 under
   megatron on (1, 4), batch 4: a sharded prefill of 4,096 frames, the
   encoder through the kernel's tc path on each rank's 4 heads, and 16
   tokens into 4,096 slots, then 16 steps).  Each held by its logits and
   every rank's cache slices against one process: bf16 by the witness
   rule and the phase's absolute bounds, float32 within SD_F32_TOL (or
   twice the smaller of two float32 witnesses); ms a step, peak memory
   and weight and cache bytes by rank.
12. The dry run (``launch/dryrun.py``), in a child process started before
   the build, beside the card's phases: one rank's step traced on meta
   tensors over a fake process group, read after phi3_prefill.
   dryrun_phi3 (phi3-medium-14b x prefill_32k at batch 1 on the (1, 1)
   mesh, the kernel route): its argument bytes equal phi3_prefill's
   weights and tokens exactly, its traced flash_attention calls the
   phase's 40 tc launches and its traced rmsnorm calls the phase's 81,
   its predicted peak within DRYRUN_PEAK_BOUNDS of the phase's, and the roofline's bound (H100 constants) against
   the phase's wall; dryrun_train (h2o-danube-3-4b x train_4k at 1 x
   4,096, lm_train's cell): argument bytes (weights, moments, step,
   batch) equal lm_train's, peak within its bound; dryrun_production
   (jamba-1.5-large-398b x train_4k on 16 x 16, rank 0 of 256, and x
   decode_32k on 2 x 16 x 16, rank 0 of 512): per-device argument, peak
   and temporary bytes against the card's memory, wire bytes and
   collective seconds, the roofline row, the trace seconds;
   dryrun_serve_fsdp_prefill (phi3-medium-14b's prefill at 2 x 4,096 as
   rank 0 of a (2, 2) mesh, read after serve_fsdp_prefill): its weight
   bytes, traced launches and collectives equal rank 0's there, its peak
   beside the measured one.

Each path's kernel launches are counted from 0 just before it runs.  Prints
per-phase seconds, a JSON line of per-kernel numbers, and as its last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before that
line.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
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
    for attempt in range(3):
        ms = device_ms(fn, iters)
        if ms:
            break
        log(f"torch.profiler recorded no kernel of {main} (attempt "
            f"{attempt + 1} of 3)")
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


#: (label, rows, d, dtype, most ulps, least share bitwise equal) of
#: check_rmsnorm: phi3-medium-14b's prefill rows, OLMoE-1B-7B-0924's
#: 8 x 4,096 prefill rows of 2,048 (every one of its norms, the q/k norms
#: over the projection too; the launch puts several rows in a block and
#: sums each row over several warps), the transformer embedder's batch of
#: 4,096 records x 8 tokens, a qk-norm over 8,192 tokens x 32 heads of
#: 128, decode's rows at phi3's width.  float32 keeps
#: the ulps the sum's order moves: over 256 terms the mean moves by an ulp
#: or two, rsqrtf and the two products carry that on (4 read on the card)
RMSNORM_CASES = (
    ("phi3", 32768, 5120, torch.bfloat16, 1, 0.99),
    ("olmoe", 32768, 2048, torch.bfloat16, 1, 0.99),
    ("embedder", 32768, 256, torch.float32, 4, 0.0),
    ("qk_norm", 8192 * 32, 128, torch.bfloat16, 1, 0.99),
    *((f"decode{r}", r, 5120, torch.bfloat16, 1, 0.99) for r in range(1, 9)),
)


def check_rmsnorm(dev):
    """The rmsnorm kernel against its plain version at each shape of
    RMSNORM_CASES (within the case's ulps, the case's share of elements
    bitwise equal), one launch a call; the wrapper's CUDA-event time, the
    kernel's own device time, the plain version's time and the bytes
    bound (x read and y written once, the scale once); and PyTorch's own
    ``rms_norm``, where the installed version has it, timed and held to the
    case's limits against the plain version (recorded, not asserted)."""
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, traced_cost
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    library = getattr(torch.nn.functional, "rms_norm", None)
    g = torch.Generator(device=dev).manual_seed(6)
    out = []
    for label, rows, d, dtype, most, share in RMSNORM_CASES:
        x = (torch.randn(rows, d, device=dev, generator=g) * 2).to(dtype)
        scale = (1 + 0.1 * torch.randn(d, device=dev, generator=g)).to(dtype)
        before = rmsnorm.launches
        with torch.no_grad():
            got = rmsnorm(x, scale, 1e-6)
        want = rmsnorm_ref(x, scale, 1e-6)
        torch.cuda.synchronize()
        assert rmsnorm.launches == before + 1, label
        u = ulps(got, want)
        worst, equal = int(u.max()), float((u == 0).float().mean())
        assert worst <= most and equal >= share, (label, worst, equal)
        lib = None
        if library is not None:         # held to the same limits, not asserted
            u = ulps(library(x, (d,), scale, 1e-6), want)
            lib = {"max_ulps": int(u.max()),
                   "bitwise_share": float((u == 0).float().mean())}
            lib["within_limits"] = (lib["max_ulps"] <= most
                                    and lib["bitwise_share"] >= share)
        del got, want, u
        with torch.no_grad():
            call = lambda: rmsnorm(x, scale, 1e-6)  # noqa: E731
            ms = time_ms(call, 50)
            own = own_time(call, 20, "rmsnorm_kernel")
            plain_ms = time_ms(lambda: rmsnorm_ref(x, scale, 1e-6), 10)
            if lib is not None:
                lib["ms"] = time_ms(lambda: library(x, (d,), scale, 1e-6),
                                    50)
        assert own["kernels"] and all("rmsnorm_kernel" in k
                                      for k in own["kernels"]), own
        flops, nbytes = traced_cost(rows, d, x.element_size(),
                                    scale.element_size())
        b, by = bound_ms(nbytes, flops)
        log(f"rmsnorm[{label}] ({rows}, {d}) {str(dtype)[6:]}: at most "
            f"{worst} ulp (allowed {most}), {100 * equal:.3f}% bitwise "
            f"equal; kernel {ms:.4f} ms (own device time "
            f"{own['main_device_ms']:.4f} ms), plain {plain_ms:.4f} ms, "
            f"bound {b:.4f} ms ({by}): {100 * b / own['main_device_ms']:.1f}"
            f"% of it; torch.nn.functional.rms_norm {lib}")
        out.append({"label": label, "shape": [rows, d],
                    "dtype": str(dtype)[6:], "max_ulps": worst,
                    "bitwise_share": equal, "ms": ms,
                    "device_ms": own["main_device_ms"], "plain_ms": plain_ms,
                    "bound_ms": b, "bound_by": by, "library": lib,
                    "library_ms": lib and lib["ms"]})
        del x
    torch.cuda.empty_cache()
    return {"name": "rmsnorm", "shape": out[0]["shape"],
            "max_abs_err": None, "ms": out[0]["ms"],
            "device_ms": out[0]["device_ms"], "plain_ms": out[0]["plain_ms"],
            "bound_ms": out[0]["bound_ms"], "bound_by": out[0]["bound_by"],
            "library_ms": out[0]["library_ms"], "cases": out}


#: (label, tokens, k, d, dtype, timed) of check_moe_combine: the dropless
#: MoE's combine at OLMoE-1B-7B-0924's step of 8 x 4,096 tokens, 8 of 64
#: experts, rows of 2,048 (the benchmark's cell), at decode's 1 and 8 rows
#: and at a count of tokens no block multiple
MOE_COMBINE_CASES = (
    ("olmoe", 32768, 8, 2048, torch.bfloat16, True),
    ("decode1", 1, 8, 2048, torch.bfloat16, False),
    ("decode8", 8, 8, 2048, torch.bfloat16, False),
    ("ragged", 4099, 8, 2048, torch.bfloat16, False),
)


def dropless_combines(dev) -> int:
    """moe_combine launches in one forward of OLMoE-1B-7B-0924 at its 16
    layers and a small width (bf16, 2 prompts of 64 tokens) on the card."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_combine.ops import moe_combine
    from repro_torch.models import lm
    from repro_torch.models.common import tree_map
    cfg = dataclasses.replace(
        get_config("olmoe-1b-7b-0924"), d_model=128, n_heads=4, n_kv_heads=4,
        head_dim=32, n_experts=8, top_k=2, moe_d_ff=64, d_ff=64,
        vocab_size=300, vocab_pad_multiple=16)
    params = tree_map(lambda a: a.to(dev), lm.init_model(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    tokens = torch.randint(0, 300, (2, 64), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    before = moe_combine.launches
    with torch.no_grad():
        logits = lm.lm_logits(params, {"tokens": tokens}, cfg)
    torch.cuda.synchronize()
    assert torch.isfinite(logits.float()).all()
    return moe_combine.launches - before


def check_moe_combine(dev):
    """The dropless MoE's combine kernel against its plain version (the
    float32 product and the scatter-add by atomics) at each shape of
    MOE_COMBINE_CASES, an expert given no rows: bit for bit the plain sum
    in choice order (the kernel's own arithmetic), the positions the
    inverse of the order, two launches equal, and against the plain
    version every element within ``allowed_error`` (one ulp where a
    token's terms do not cancel) and at least 99% bitwise equal; at the
    cell's shape the wrapper's CUDA-event time, the kernel's own device
    time, the plain version's and the bytes bound (the T k bf16 rows and
    float32 weights read, the T rows written once).  No single PyTorch
    call computes this function.  Then one forward of the dropless model,
    one launch a layer."""
    from repro_torch.kernels.moe_combine import ops as combine_ops
    from repro_torch.kernels.moe_combine.ops import moe_combine
    from repro_torch.kernels.moe_combine.ref import (allowed_error,
                                                     combine_in_choice_order,
                                                     moe_combine_ref,
                                                     positions_ref)
    g = torch.Generator(device=dev).manual_seed(7)
    out = []
    for label, tokens, k, d, dtype, timed in MOE_COMBINE_CASES:
        logits = torch.randn(tokens, 64, device=dev, generator=g)
        logits[:, 5] = -1e9                      # an expert with no rows
        top = torch.sort(logits, dim=-1, descending=True,
                         stable=True).indices[:, :k]
        weights = torch.softmax(logits, -1).gather(-1, top)
        _, order = torch.sort(top.reshape(-1), stable=True)
        y = torch.randn(tokens * k, d, device=dev, generator=g).to(dtype)
        before = moe_combine.launches
        with torch.no_grad():
            got, pos = combine_ops._launch(y, order, weights)
            again = moe_combine(y, order, weights)
        want = moe_combine_ref(y, order, weights)
        torch.cuda.synchronize()
        assert moe_combine.launches == before + 2, label
        assert torch.equal(got, again), label
        assert torch.equal(pos, positions_ref(order)), label
        assert torch.equal(got, combine_in_choice_order(y, pos, weights)), \
            label
        u = ulps(got, want)
        worst, equal = int(u.max()), float((u == 0).float().mean())
        beyond = int((u > 1).sum())
        share = float(((got.float() - want.float()).abs() / allowed_error(
            y, pos, weights, got, want)).max())
        assert share <= 1 and equal >= 0.99, (label, share, equal)
        rec = {"label": label, "shape": [tokens, k, d],
               "dtype": str(dtype)[6:], "max_ulps": worst,
               "bitwise_share": equal, "beyond_one_ulp": beyond,
               "max_share_of_allowed": share}
        del again, want, u
        msg = ""
        if timed:
            call = lambda: moe_combine(y, order, weights)  # noqa: E731
            with torch.no_grad():
                ms = time_ms(call, 50)
                own = own_time(call, 20, "moe_combine_kernel")
                plain_ms = time_ms(
                    lambda: moe_combine_ref(y, order, weights), 10)
            assert own["kernels"] and all("moe_combine" in n
                                          for n in own["kernels"]), own
            item = y.element_size()
            b, by = bound_ms(tokens * k * d * item + 4 * tokens * k
                             + tokens * d * item, 2.0 * tokens * k * d)
            rec.update(ms=ms, device_ms=own["main_device_ms"],
                       positions_ms=own["device_ms"] - own["main_device_ms"],
                       plain_ms=plain_ms, bound_ms=b, bound_by=by)
            msg = (f"; kernel {ms:.4f} ms (own device time "
                   f"{own['main_device_ms']:.4f} ms, the positions "
                   f"{rec['positions_ms']:.4f} ms), plain {plain_ms:.4f} ms, "
                   f"bound {b:.4f} ms ({by}): "
                   f"{100 * b / own['main_device_ms']:.1f}% of it")
        log(f"moe_combine[{label}] T {tokens}, k {k}, d {d} "
            f"{str(dtype)[6:]}: at most {worst} ulp ({beyond} elements "
            f"beyond one, the largest at {share:.3f} of allowed_error), "
            f"{100 * equal:.4f}% bitwise equal{msg}")
        out.append(rec)
        del y, got, pos, order, weights
    torch.cuda.empty_cache()
    forward = dropless_combines(dev)
    assert forward == 16, forward
    log(f"moe_combine launches in a forward of the dropless model (16 "
        f"layers, small width): {forward}")
    first = out[0]
    return {"name": "moe_combine", "shape": first["shape"],
            "max_abs_err": None, "ms": first["ms"],
            "device_ms": first["device_ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": None, "cases": out,
            "launches_by_phase": {"dropless_forward": forward}}


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


def time_flash_full(dev, cfg, seq: int, iters: int = 2,
                    plain: bool = False, heads=(), causal: bool = True):
    """One kernel launch at a full-width prefill layer's shape, causal
    unless asked otherwise, beside ``scaled_dot_product_attention``; with
    ``plain`` (only where its (H, S, S) float32 scores fit) the plain
    version is timed and the kernel's output held against it as
    ``check_flash_attention`` holds it (``allowed_error``, with the
    P-rounding witness on the tc path).  With ``heads`` (where they do not
    fit), each of those query heads of the kernel's output is held the
    same way against the plain version run on that head and its KV head
    alone, and that one-head run is timed."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         flash_route)
    from repro_torch.kernels.flash_attention.ref import (allowed_error,
                                                         flash_attention_ref)
    g = torch.Generator(device=dev).manual_seed(7)
    hd, h, hk = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    window = cfg.sliding_window
    q = torch.randn(1, seq, h, hd, device=dev, generator=g).bfloat16()
    k = torch.randn(1, seq, hk, hd, device=dev, generator=g).bfloat16()
    v = torch.randn(1, seq, hk, hd, device=dev, generator=g).bfloat16()
    path = flash_route(q, k)
    ms = time_ms(lambda: flash_attention(q, k, v, causal=causal,
                                         window=window), iters)
    lib_ms = sdpa_ms(q, k, v, causal, window, iters)
    plain_ms = plain_head_ms = err = outside = None
    held = []
    if plain:
        plain_ms = time_ms(lambda: flash_attention_ref(
            q, k, v, causal=causal, window=window), 1)
        got = flash_attention(q, k, v, causal=causal, window=window)
        want, allowed = allowed_error(q, k, v, causal, window,
                                      round_p=path == "tc")
        diff = (got.float() - want).abs()
        err, outside = float(diff.max()), int((diff > allowed).sum())
        del got, want, allowed, diff
    if heads:
        got = flash_attention(q, k, v, causal=causal, window=window)
        for hi in heads:
            kv = hi // (h // hk)
            one = (q[:, :, hi:hi + 1], k[:, :, kv:kv + 1], v[:, :, kv:kv + 1])
            want, allowed = allowed_error(*one, causal, window,
                                          round_p=path == "tc")
            diff = (got[:, :, hi:hi + 1].float() - want).abs()
            held.append({"head": hi, "kv_head": kv,
                         "max_abs_err": float(diff.max()),
                         "outside_tol": int((diff > allowed).sum())})
            del want, allowed, diff
        one = (q[:, :, :1], k[:, :, :1], v[:, :, :1])
        plain_head_ms = time_ms(lambda: flash_attention_ref(
            *one, causal=causal, window=window), 1)
        del got, one
        err = max(x["max_abs_err"] for x in held)
        outside = sum(x["outside_tol"] for x in held)
    bnd, by, flops = attention_bound(1, seq, seq, h, hk, hd, torch.bfloat16,
                                     causal, window)
    if plain_ms is not None:
        against = (f"{plain_ms:.3f} ms; against it max_abs_err {err:.3g}, "
                   f"{outside} outside the tolerance")
    elif held:
        against = (f"not measured on all heads at once (their scores and "
                   f"the witness's temporaries do not fit), one head alone "
                   f"{plain_head_ms:.3f} ms; heads (kv head) "
                   + ", ".join(f"{x['head']} ({x['kv_head']})" for x in held)
                   + f" held against it: max_abs_err {err:.3g}, {outside} "
                   f"outside the tolerance")
    else:
        against = "not measured"
    log(f"flash_attention[{cfg.name} prefill {seq}] {path} q {(1, seq, h, hd)}"
        f" k {(1, seq, hk, hd)} causal={causal} one launch {ms:.3f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s), library {lib_ms:.3f} ms, plain "
        f"{against}, bound {bnd:.4f} ms ({by})")
    assert not outside, (cfg.name, seq, err, outside, held)
    return {"model": cfg.name, "seq": seq, "shape": [1, seq, seq, h, hk, hd],
            "causal": causal, "path": path, "ms": ms, "library_ms": lib_ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "max_abs_err": err, "outside_tol": outside,
            **({"heads_held": held, "plain_head_ms": plain_head_ms}
               if held else {})}


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
# The routed rule, for a MoE model: a token whose k-th and (k+1)-th router
# logits lie closer than the rounding noise changes experts, which moves its
# layer output by a whole expert's share, and through attention every later
# token's.  Each route's top-k indices are recorded in every layer
# (``record_routing``) and the tokens that route differently from the plain
# route in some layer are counted.  Over the routes as they fall, the
# witness bounds hold and, in float32, top-1 >= 99%.  The kernel route is
# then run again with the plain route's routing replayed (``pin_routing``:
# its indices, this route's own logits at them), so that only the kernel's
# numerics part the two: there the bf16 backstop and F32_LOGITS_TOL hold.
BF16_LOGITS_MAX, BF16_LOGITS_MEAN = 0.25, 0.03
WITNESS_RATIO, WITNESS_TOP1_SLACK = 2.0, 0.02
F32_LOGITS_TOL = 1e-2


def check_logits(cmp: dict, what: str) -> None:
    assert cmp["max_abs"] <= BF16_LOGITS_MAX and \
        cmp["mean_abs"] <= BF16_LOGITS_MEAN, (what, cmp)


def logits_agreement(got: torch.Tensor, want: torch.Tensor, vocab: int,
                     rows: torch.Tensor = None):
    """(max abs diff, mean abs diff, top-1 agreement) over real vocab, at
    the (B, S) positions ``rows`` selects (all by default)."""
    got, want = got[..., :vocab].float(), want[..., :vocab].float()
    if rows is not None:
        got, want = got[rows], want[rows]
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


@contextlib.contextmanager
def record_routing():
    """Records the top-k expert indices of every MoE layer a forward runs,
    one (tokens, k) tensor a layer, in the list it yields."""
    from unittest import mock

    from repro_torch.models import moe
    calls, gating = [], moe._top_k_gating

    def recording(logits, k):
        weights, idx = gating(logits, k)
        calls.append(idx.reshape(-1, k))
        return weights, idx

    with mock.patch.object(moe, "_top_k_gating", recording):
        yield calls


@contextlib.contextmanager
def pin_routing(recorded: list):
    """Routes every MoE layer a forward runs to ``recorded``'s top-k
    indices (``record_routing``), layer by layer; the weights stay the
    softmax of this forward's own logits at those indices."""
    from unittest import mock

    from repro_torch.models import moe
    queue = iter(recorded)

    def pinned(logits, k):
        idx = next(queue).reshape(*logits.shape[:-1], k)
        return torch.softmax(torch.gather(logits, -1, idx).float(), -1), idx

    with mock.patch.object(moe, "_top_k_gating", pinned):
        yield


def routing_agrees(a: list, b: list, shape) -> torch.Tensor:
    """(B, S) bool: the positions whose top-k indices agree, in the same
    order, in every MoE layer of two recorded forwards."""
    assert len(a) == len(b) and a, (len(a), len(b))
    same = torch.stack([(x == y).all(-1) for x, y in zip(a, b)]).all(0)
    return same.reshape(shape)


def compare_routes(cfg, params, short: dict, prefill, prefill_plain,
                   label: str = "lm_prefill", f32_depth: int = 0) -> dict:
    """Kernel route against plain route over the batch ``short`` (tokens,
    and a vision model's vision_embeds): in bf16 as served, with the
    keys-reversed plain route as the witness of rounding alone, and with
    the same weights cast to float32 (with ``f32_depth``, only the first
    that many layers, where float32 weights of all of them do not fit
    beside the bf16 ones).  A MoE model is held by the routed rule (above),
    its flips counted."""
    from unittest import mock

    from repro_torch.models import attention
    from repro_torch.models.common import tree_map
    routed = any(sp.mlp == "moe" for sp in cfg.pattern)
    tokens = short["tokens"]

    def run(step, p, pin=None):
        if not routed:
            return step(p, short), None
        with (record_routing() if pin is None else pin_routing(pin)) as rec:
            return step(p, short), rec

    out = {"tokens": tokens.shape[1]}
    lp, rp = run(prefill_plain, params)
    names = ("bf16", "witness") + (("bf16_pinned",) if routed else ()) + (
        ("f32", "f32_pinned") if routed else ("f32",))
    for name in names:
        if name == "witness":
            with mock.patch.object(attention, "flash_attention_ref",
                                   plain_attention_keys_reversed):
                lx, rx = run(prefill_plain, params)
        elif name == "f32":
            del lp
            cut = params if not f32_depth else dict(params, blocks=tree_map(
                lambda a: a[:f32_depth], params["blocks"]))
            p32 = tree_map(lambda a: a.float(), cut)
            del cut
            lp, rp = run(prefill_plain, p32)
            lx, rx = run(prefill, p32)
        else:
            lx, rx = run(prefill, p32 if name == "f32_pinned" else params,
                         rp if name.endswith("_pinned") else None)
        mx, mean, top1 = logits_agreement(lx, lp, cfg.vocab_size)
        out[name] = c = {"max_abs": mx, "mean_abs": mean, "top1": top1}
        if rx:
            same = routing_agrees(rx, rp, tokens.shape)
            c["flipped_tokens"] = int((~same).sum())
            if same.any():
                amx, amean, _ = logits_agreement(lx, lp, cfg.vocab_size,
                                                 same)
                c.update(agreeing_max_abs=amx, agreeing_mean_abs=amean)
        del lx, rx
    del lp, rp, p32
    torch.cuda.empty_cache()
    whats = {"bf16": "kernel vs plain",
             "witness": "plain keys reversed vs plain",
             "bf16_pinned": "kernel with the plain route's routing vs plain",
             "f32": "kernel vs plain, weights cast to float32" + (
                 f", first {f32_depth} of {cfg.n_layers} layers"
                 if f32_depth else ""),
             "f32_pinned": "kernel with the plain route's routing vs plain, "
                           "weights cast to float32"}
    for name in names:
        c = out[name]
        log(f"{label} compare {out['tokens']} tokens, {name} ({whats[name]})"
            f": max |d logits| {c['max_abs']:.4g}, mean {c['mean_abs']:.4g}, "
            f"top-1 agreement {c['top1']:.5f}" + (
                f"; {c['flipped_tokens']} tokens route differently in some "
                f"layer" if "flipped_tokens" in c else "") + (
                f", on the others max {c['agreeing_max_abs']:.4g}, mean "
                f"{c['agreeing_mean_abs']:.4g}"
                if "agreeing_max_abs" in c else ""))
    bf, wit, f32 = out["bf16"], out["witness"], out["f32"]
    assert bf["mean_abs"] <= WITNESS_RATIO * wit["mean_abs"], (bf, wit)
    assert bf["top1"] >= wit["top1"] - WITNESS_TOP1_SLACK, (bf, wit)
    assert f32["top1"] >= 0.99, f32
    exact, exact32 = ((out["bf16_pinned"], out["f32_pinned"]) if routed
                      else (bf, f32))
    assert exact["mean_abs"] <= BF16_LOGITS_MEAN, exact
    assert exact32["max_abs"] <= F32_LOGITS_TOL, exact32
    if f32_depth:
        out["f32_depth"] = f32_depth
    return out


def check_strategies(cfg, params, short: dict) -> dict:
    """The kernel route's logits over ``short`` under ``shard_strategy``
    ``seq_dp`` and ``ep_seq``: on one device the function of ``megatron``,
    so the same logits, bit for bit."""
    import dataclasses

    from repro_torch.train.steps import make_prefill_step
    base = make_prefill_step(cfg)(params, short)
    out = {}
    for name in ("seq_dp", "ep_seq"):
        got = make_prefill_step(dataclasses.replace(
            cfg, shard_strategy=name))(params, short)
        out[name] = bool(torch.equal(got, base))
        del got
    log(f"shard_strategy on one device, {short['tokens'].shape[1]} tokens, "
        f"kernel route: logits bitwise equal to megatron's: {out}")
    assert all(out.values()), out
    return out


# lm_decode_ring: the two-tier decode cache at the JAX package's
# launch/roofline.py default ring of 256 slots, after a main cache of 4,096 seeded slots; 256 steps
# fill the ring, 16 more overwrite its oldest tokens (the reference's
# forgetting).  Held against a masked decode over a cache of 4,096 + 272
# slots that starts with the same 4,096, in float32 to the reference's
# 2e-3 (tests/test_model_consistency.py) while no token is lost.
DECODE_RING, DECODE_RING_EXTRA, DECODE_RING_TOL = 256, 16, 2e-3
DECODE_RING_TIMED = 64


def run_decode_ring(dev, cfg, params, main: tuple, g, profile) -> dict:
    """lm_decode_ring: ``cfg`` (bf16 ``params``) decoding a seeded token
    stream of 256 + 16 steps at batch 4 over the main cache ``main``
    (4,096 slots) and a ring of 256; timed in turns with the masked decode
    at the same cache; then both in float32, compared step by step."""
    import dataclasses

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         reset_launches)
    from repro_torch.launch import analytic
    from repro_torch.models import lm
    from repro_torch.models.common import tree_map
    from repro_torch.train.steps import make_serve_step

    batch, ctx = main[0]["k"].shape[1], main[0]["k"].shape[2]
    steps = DECODE_RING + DECODE_RING_EXTRA
    rcfg = dataclasses.replace(cfg, decode_ring=DECODE_RING)
    toks = torch.randint(1, cfg.vocab_size, (batch, steps), device=dev,
                         generator=g)

    def caches_for(c):
        """Two-tier caches of ``c`` (main grafted, zero rings) or, without a
        ring, a masked cache of ctx + steps slots starting with ``main``,
        in ``c``'s dtype."""
        out = lm.init_cache(c, batch, ctx if c.decode_ring else ctx + steps,
                            device=dev)
        for layer, m in zip(out, main):
            for name in ("k", "v"):
                layer[name][:, :, :ctx] = m[name]
        return out

    def decode(c, p, caches, n, keep=False):
        step, kept = make_serve_step(c), []
        for t in range(n):
            lg, caches = step(p, caches, toks[:, t:t + 1], ctx + t)
            if keep:
                kept.append(lg[:, 0, :cfg.vocab_size].float())
        return lg, kept

    # bf16 as served: the two-tier decode is the phase, the masked decode
    # at the same cache its yardstick
    caches = caches_for(rcfg)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with Phase("lm_decode_ring", profile) as ph:
        lg, _ = decode(rcfg, params, caches, steps)
    launches = flash_attention.launches
    finite = bool(torch.isfinite(lg).all())
    peak = peak_gib()
    ring_ms = 1e3 * ph.seconds / steps
    main_same = all(torch.equal(layer[n], m[n]) for layer, m in
                    zip(caches, main) for n in ("k", "v"))
    del caches
    log(f"phase lm_decode_ring: {cfg.name}, {steps} steps x batch {batch} "
        f"over a main cache of {ctx} and a ring of {DECODE_RING} in "
        f"{ph.seconds:.3f} s ({ring_ms:.2f} ms per step, "
        f"{batch * 1e3 / ring_ms:.1f} tok/s), finite={finite}, flash "
        f"launches {launches} (decode attention is plain, as the "
        f"reference's), main cache unchanged={main_same}, peak device "
        f"memory {peak:.2f} GiB")
    assert finite and main_same and launches == 0
    # the two-tier and the masked decode (a cache of ctx + steps slots) at
    # the same main cache, timed in turns: masked, two-tier, two-tier,
    # masked, DECODE_RING_TIMED steps each from fresh caches
    turns = {"two_tier": [], "masked": []}
    for name, c in (("masked", cfg), ("two_tier", rcfg),
                    ("two_tier", rcfg), ("masked", cfg)):
        caches = caches_for(c)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode(c, params, caches, DECODE_RING_TIMED)
        torch.cuda.synchronize()
        turns[name].append(1e3 * (time.perf_counter() - t0)
                           / DECODE_RING_TIMED)
        del caches
    log(f"lm_decode_ring timed in turns ({DECODE_RING_TIMED} steps each, "
        f"ms per step): masked over {ctx + steps} slots "
        f"{turns['masked'][0]:.2f}, two-tier {turns['two_tier'][0]:.2f}, "
        f"two-tier {turns['two_tier'][1]:.2f}, masked "
        f"{turns['masked'][1]:.2f}")

    # float32: the two against each other, step by step
    p32 = tree_map(lambda a: a.float(), params)
    f32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    r32 = dataclasses.replace(rcfg, dtype="float32", param_dtype="float32")
    t0 = time.perf_counter()
    _, two = decode(r32, p32, caches_for(r32), steps, True)
    _, masked = decode(f32, p32, caches_for(f32), steps, True)
    diff = torch.stack([(a - b).abs().amax() for a, b in zip(two, masked)])
    diff = diff.cpu()
    finite32 = all(bool(torch.isfinite(a).all()) for a in two)
    del p32, two, masked
    free_card()
    held = float(diff[:DECODE_RING].max())
    past = float(diff[DECODE_RING:].max())
    log(f"lm_decode_ring vs the masked decode, float32: steps 0.."
        f"{DECODE_RING - 1} max |d logits| {held:.4g} (<= "
        f"{DECODE_RING_TOL}); steps {DECODE_RING}..{steps - 1}, where each "
        f"new token overwrites the ring's oldest (the reference's "
        f"forgetting), max {past:.4g}, finite={finite32}; "
        f"{time.perf_counter() - t0:.2f} s")
    assert held <= DECODE_RING_TOL and finite32, (held, past)

    # the analytic model's bytes a step (the JAX package's, which counts a
    # masked update as a rewrite of the whole cache; the port writes one
    # slot in place under either) and the bound they give
    shape = ShapeConfig("lm_decode_ring", ctx, batch, "decode")
    cost = {name: analytic.decode_cost(c, shape) for name, c in
            (("two_tier", rcfg), ("masked", cfg))}
    bounds = {name: 1e3 * c.bytes / PEAK_BYTES_S for name, c in cost.items()}
    log("lm_decode_ring analytic bytes a step (launch/analytic.py): " + ", ".join(
        f"{name} {c.bytes:.4e} B, {c.flops:.4e} flops, bound "
        f"{bounds[name]:.3f} ms" for name, c in cost.items()))
    return {"steps": steps, "batch": batch, "main_cache": ctx,
            "ring": DECODE_RING, "seconds": ph.seconds, "step_ms": ring_ms,
            "turns_step_ms": turns, "launches": launches,
            "peak_gib": peak, "f32_max_abs_held": held,
            "f32_max_abs_past_ring": past,
            "f32_max_abs_by_step": diff.tolist(),
            "analytic": {name: {"bytes": c.bytes, "flops": c.flops,
                                "bound_ms": bounds[name]}
                         for name, c in cost.items()}}


def run_lm(dev, prefill_len: int, compare_len: int, profile):
    """lm_prefill, lm_serve, lm_decode_window (also under the ``dus``
    cache update) and lm_decode_ring at h2o-danube-3-4b's published
    widths; the shard strategies that mean megatron on one device."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         reset_launches)
    from repro_torch.launch import serve_lm
    from repro_torch.models import lm
    from repro_torch.models.common import tree_map
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
    compare = compare_routes(cfg, params, {"tokens": tokens[:, :compare_len]},
                             prefill, prefill_plain)
    strategies = check_strategies(cfg, params,
                                  {"tokens": tokens[:, :compare_len]})

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with Phase("lm_prefill", profile) as ph:
        logits = prefill(params, {"tokens": tokens})
    prefill_launches = flash_attention.launches
    prefill_paths = dict(flash_attention.launches_by_path)
    prefill_s = ph.seconds
    # the peak before the check: isfinite's temporaries (|x| and two masks)
    # would add twice the logits' size
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finite = bool(torch.isfinite(logits).all())
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
    seeded = tree_map(lambda a: a.clone(), caches)
    step = make_serve_step(cfg)
    tok = prompts[:, -1:]
    window_logits = []
    reset_launches()
    with Phase("lm_decode_window", profile) as ph:
        for t in range(steps):
            lg, caches = step(params, caches, tok, ctx + t)
            window_logits.append(lg)
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
    # the same steps under decode_cache_update="dus": the same logits, bit
    # for bit (the port writes the one slot in place under either)
    dus = make_serve_step(dataclasses.replace(cfg, decode_cache_update="dus"))
    caches = tree_map(lambda a: a.clone(), seeded)
    tok = prompts[:, -1:]
    dus_equal = True
    for t in range(steps):
        lg, caches = dus(params, caches, tok, ctx + t)
        dus_equal &= torch.equal(lg, window_logits[t])
        tok = torch.argmax(lg[:, :, :cfg.vocab_size], dim=-1)
    log(f"lm_decode_window under decode_cache_update='dus': {steps} steps' "
        f"logits bitwise equal to masked: {dus_equal}")
    assert dus_equal
    del caches, window_logits
    ring = run_decode_ring(dev, cfg, params, tree_map(
        lambda a: a[:, :, :ctx], seeded), g, profile)
    del seeded
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
                              "launches_by_path": window_paths,
                              "dus_bitwise_equal": dus_equal},
            "decode_ring": ring, "strategies": strategies, "cfg": cfg}


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


# the serve phase's open loop: a Poisson rate (requests/s) the server keeps
# up with at 1M frames, for long enough to read p99 off ~30 requests
SERVE_RATE = 2.0
SERVE_SECONDS = 15.0


def serve_specs(rng: np.random.Generator) -> list:
    """One request of the serve phase: a single spec of one of the tasti
    phase's three kinds, its score and seed drawn from ``rng``."""
    kind = rng.choice(["aggregation", "selection", "limit"], p=[0.5, 0.3,
                                                               0.2])
    seed = int(rng.integers(0, 4))
    if kind == "aggregation":
        return [{"kind": "aggregation", "seed": seed,
                 "score": str(rng.choice(["score_count",
                                          "score_has_object"])),
                 "err": float(rng.choice([0.05, 0.1]))}]
    if kind == "selection":
        return [{"kind": "selection", "score": "score_has_object",
                 "seed": seed, "budget": int(rng.choice([200, 500]))}]
    return [{"kind": "limit", "score": str(rng.choice(["score_rare",
                                                       "score_has_object"])),
             "seed": seed, "k_results": 5}]


def run_serve(dev, wl, index, rate: float, seconds: float, threads: int = 8,
              per_thread: int = 4) -> dict:
    """serve: the query server over the tasti phase's index and workload.

    1. The index saved to a temporary stem and mounted, with its label
       store (``LabelStore.for_index``), in a ``QueryServer`` on
       127.0.0.1:0 (cracking on, the default admission window).
    2. ``threads`` x ``per_thread`` concurrent ``QueryClient`` requests.
    3. An ``OpenLoopGenerator`` at a Poisson ``rate`` for ``seconds``.
    4. Every request of step 2 once more, one at a time and without
       cracking, so that the index no longer moves; shutdown (the store
       saved), the index saved to the same stem; a second server over
       ``TastiIndex.load(..., device="cuda")`` and its store repeats them:
       0 fresh calls, the same rows.
    5. One session through an engine with two forked process replicas
       (behind a server: the pool forks from a request thread) against
       the same session through two thread replicas."""
    import shutil
    import tempfile
    import threading

    from repro_torch.core.engine import QueryEngine
    from repro_torch.core.index import TastiIndex
    from repro_torch.core.propagation import propagate_numeric
    from repro_torch.kernels.distance_topk import ops as topk_ops
    from repro_torch.kernels.distance_topk.ops import distance_topk
    from repro_torch.kernels.fpf_update.ops import fpf_update
    from repro_torch.kernels.propagate import ops as propagate_ops
    from repro_torch.kernels.propagate.ops import propagate
    from repro_torch.loadgen import (ArrivalProcess, OpenLoopGenerator,
                                     SpecClass, SpecMix)
    from repro_torch.serve import LabelStore, QueryClient, QueryServer

    truth = {"score_count": float(wl.counts.mean()),
             "score_has_object": float((wl.counts > 0).mean())}
    rows_seen = []

    def check_rows(rows, specs):
        """Aggregations within 3 CI half-widths of the true mean."""
        for row, spec in zip(rows, specs):
            rows_seen.append(row)
            if row["kind"] == "aggregation":
                want = truth[spec["score"]]
                assert abs(row["estimate"] - want) <= 3 * row[
                    "ci_half_width"], (row, want)

    def start(engine, store=None):
        srv = QueryServer(engine, port=0, store=store).start()
        client = QueryClient(srv.url, timeout=300.0)
        client.wait_ready(60)
        return srv, client

    tmp = tempfile.mkdtemp(prefix="chip-smoke-serve-")
    out = {}
    try:
        stem = os.path.join(tmp, "ns")
        t0 = time.perf_counter()
        index.save(stem)
        store = LabelStore.for_index(stem, index)
        engine = QueryEngine(index, wl, crack=True)
        store.attach(engine.broker, engine)
        assert engine.resident.enabled
        srv, client = start(engine, store)
        out["save_mount_s"] = time.perf_counter() - t0
        fpf_update.launches = 0
        topk_ops.reset_launches()
        propagate_ops.reset_launches()

        # 2. concurrent sessions
        rng = np.random.default_rng(0)
        plan = [[serve_specs(rng) for _ in range(per_thread)]
                for _ in range(threads)]
        answers, errors = {}, []

        def client_thread(i):
            c = QueryClient(srv.url, timeout=300.0)
            try:
                for j, specs in enumerate(plan[i]):
                    answers[i, j] = c.query(specs)
            except Exception as e:  # noqa: BLE001 - fails the phase below
                errors.append(f"{type(e).__name__}: {e}")

        t0 = time.perf_counter()
        workers = [threading.Thread(target=client_thread, args=(i,))
                   for i in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(600)
        out["concurrent_s"] = time.perf_counter() - t0
        assert not errors and len(answers) == threads * per_thread, errors
        for (i, j), ans in answers.items():
            check_rows(ans["results"], plan[i][j])
        stats = client.stats()
        out["concurrent"] = {
            "requests": threads * per_thread,
            "sessions": stats["server"]["sessions"],
            "coalesced": stats["server"]["coalesced"],
            "fresh": sum(a["request"]["fresh"] for a in answers.values()),
            "cached": sum(a["request"]["cached"] for a in answers.values())}
        log(f"phase serve concurrent: {threads} x {per_thread} requests in "
            f"{out['concurrent_s']:.2f} s: {out['concurrent']}")

        # 3. open-loop load
        mix = SpecMix([SpecClass("mixed", serve_specs)], seed=1)

        def post(specs, budget=None, priority=None, deadline_ms=None,
                 name=None, trace_id=None):
            res = client.query(specs, budget=budget, priority=priority,
                               deadline_ms=deadline_ms, trace_id=trace_id)
            check_rows(res["results"], specs)
            return res

        t0 = time.perf_counter()
        report = OpenLoopGenerator(post, mix, ArrivalProcess(
            rate=rate, seed=2), seconds).run()
        wall = time.perf_counter() - t0
        ok = [o for o in report.outcomes if o.ok]
        lat = np.asarray([o.latency_s * 1e3 for o in ok])
        p50, p90, p99 = (float(v) for v in np.percentile(lat, [50, 90, 99]))
        out["open_loop"] = {
            "rate_per_s": rate, "seconds": seconds, "wall_s": wall,
            "fired": report.offered - report.dropped,
            "offered": report.offered, "completed": report.completed,
            "dropped": report.dropped, "errors": report.errors,
            "p50_ms": p50, "p90_ms": p90, "p99_ms": p99,
            "max_fire_lag_ms": report.max_fire_lag_ms,
            "fresh": sum(o.response["request"]["fresh"] for o in ok),
            "cached": sum(o.response["request"]["cached"] for o in ok),
            "achieved_per_s": report.completed / wall}
        errs = [o.error for o in report.outcomes if not o.ok]
        log(f"phase serve open loop: {out['open_loop']}"
            + (f"; first errors {errs[:3]}" if errs else ""))
        assert report.errors == 0 and report.dropped == 0, errs[:3]
        assert report.completed == report.offered > 0

        # 4. the repeat set at the final index, then a warm restart
        repeat = [specs for per in plan for specs in per]
        repeat = [[dict(s, crack=False) for s in specs] for specs in repeat]
        t0 = time.perf_counter()
        before = [client.query(specs) for specs in repeat]
        out["repeat_first_s"] = time.perf_counter() - t0
        for ans, specs in zip(before, repeat):
            check_rows(ans["results"], specs)
        stats = client.stats()
        assert stats["server"]["errors"] == 0, stats["server"]
        version = index.version
        srv.shutdown()
        proxy = engine.proxy_scores("score_count")
        host = propagate_numeric(index.rep_scores(wl.score_count),
                                 index.topk_ids, index.topk_d2)
        assert proxy.shape == (len(wl.features),) and np.isfinite(proxy).all()
        np.testing.assert_allclose(proxy, host, rtol=1e-5, atol=1e-5)
        out["engine"] = dict(engine.stats)
        out["resident"] = dict(engine.resident.stats)
        out["broker"] = {k: stats["broker"][k] for k in (
            "requests", "fresh", "cached", "dedup_inflight", "batches")}
        out["index"] = {"version": version, "reps": index.n_reps}
        out["store_labels"] = len(store)
        t0 = time.perf_counter()
        index.save(stem)
        index2 = TastiIndex.load(stem, device="cuda")
        store2 = LabelStore.for_index(stem, index2)
        engine2 = QueryEngine(index2, wl, crack=True)
        seeded = store2.attach(engine2.broker, engine2)
        srv2, client2 = start(engine2, store2)
        out["restart_s"] = time.perf_counter() - t0
        assert index2.version == version and seeded == len(store) > 0
        t0 = time.perf_counter()
        after = [client2.query(specs) for specs in repeat]
        out["repeat_warm_s"] = time.perf_counter() - t0
        drop = ("n_oracle_fresh", "n_oracle_cached", "query_cost_s",
                "session")
        for a, b in zip(before, after):
            assert [{k: v for k, v in r.items() if k not in drop}
                    for r in a["results"]] == \
                [{k: v for k, v in r.items() if k not in drop}
                 for r in b["results"]]
        out["warm_restart"] = {
            "requests": len(repeat), "seeded": seeded,
            "fresh_before": sum(a["request"]["fresh"] for a in before),
            "fresh": sum(a["request"]["fresh"] for a in after),
            "cached": sum(a["request"]["cached"] for a in after)}
        log(f"phase serve warm restart: index version {version}, "
            f"{index.n_reps} reps; {out['warm_restart']}; restart "
            f"{out['restart_s']:.2f} s, repeats {out['repeat_first_s']:.2f}"
            f" s before and {out['repeat_warm_s']:.2f} s after")
        assert out["warm_restart"]["fresh"] == 0, out["warm_restart"]
        assert client2.stats()["server"]["errors"] == 0
        srv2.shutdown()

        # 5. process replicas against thread replicas, one session each
        session = [dict(s, crack=False) for s in (
            repeat[0] + [{"kind": "selection", "score": "score_has_object",
                          "budget": 300, "seed": 7},
                         {"kind": "limit", "score": "score_rare",
                          "k_results": 5, "seed": 7}])]
        rows = {}
        t0 = time.perf_counter()
        for backend in ("process", "thread"):
            eng = QueryEngine(index2, wl, oracle_replicas=2,
                              oracle_backend=backend)
            srv3, client3 = start(eng)
            try:
                res = client3.query(session)
                rows[backend] = ([{k: v for k, v in r.items()
                                   if k != "session"}
                                  for r in res["results"]],
                                 res["request"]["fresh"])
                pool = eng.oracle_pool
                assert pool is not None and pool.backend == backend
                snap = pool.snapshot()
                assert all(snap["per_replica_alive"]), snap
            finally:
                srv3.shutdown()
        out["replicas_s"] = time.perf_counter() - t0
        assert rows["process"] == rows["thread"], rows
        out["process_replicas"] = {"rows": len(rows["process"][0]),
                                   "fresh": rows["process"][1]}
        log(f"phase serve process replicas: one {len(session)}-spec "
            f"session, rows equal to the thread backend's, fresh "
            f"{rows['process'][1]}, {out['replicas_s']:.2f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    out["launches"] = {"fpf_update": fpf_update.launches,
                       "distance_topk": distance_topk.launches,
                       "propagate": propagate.launches}
    out["distance_topk_by_route"] = dict(distance_topk.launches_by_path)
    out["propagate_by_mode"] = dict(propagate.launches_by_path)
    out["propagate_plain_prescales"] = propagate.plain_prescales
    res = out["resident"]
    log(f"serve: engine {out['engine']}; resident {res}; broker "
        f"{out['broker']}; launches {out['launches']}, distance_topk by "
        f"route {out['distance_topk_by_route']}, propagate by mode "
        f"{out['propagate_by_mode']}, top1 prescales by the plain version "
        f"{out['propagate_plain_prescales']}")
    assert out["distance_topk_by_route"]["simt"] == 0, out
    assert out["distance_topk_by_route"]["tc"] > 0 or \
        out["engine"]["cracked_records"] == 0, out
    assert out["launches"]["propagate"] > 0 and res["computes"] > 0, out
    assert res["computes"] > res["fallbacks"], res
    return out


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
            - logits.gather(-1, batch["targets"][..., None].long())[..., 0])


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


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in units in the last place of their floating type (float32,
    float16, bfloat16)."""
    bits = 8 * a.element_size()
    ints = {16: torch.int16, 32: torch.int32}[bits]

    def ordered(t):
        i = t.contiguous().view(ints).to(torch.int64)
        return torch.where(i < 0, -(i & (2 ** (bits - 1) - 1)), i)
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
    from unittest import mock

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
    looked_up = {}
    embed_tokens = lm._embed_tokens

    def capture(p, tokens):
        looked_up["h"] = embed_tokens(p, tokens)
        return looked_up["h"]

    # the float32 gradient of every leaf, and of the embedding's output
    # (each occurrence's contribution to its token's row)
    with torch.enable_grad(), mock.patch.object(lm, "_embed_tokens",
                                                capture):
        ref_loss, _ = lm.lm_loss(ref_params, batch, f32, attn_impl="plain")
        *g32, g_occ = (g.detach() for g in torch.autograd.grad(
            ref_loss, ref_leaves + [looked_up["h"]]))
    g_occ = g_occ.reshape(-1, g_occ.shape[-1])
    tokens = batch["tokens"].reshape(-1)
    ref_loss = float(ref_loss.detach())
    del ref_params, ref_leaves, looked_up
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
        far = ulps(got[i], want.to(torch.bfloat16)) > 1
        if not every:
            a = g32[i].abs()
            far = far[a >= LM_LARGE_G * a.square().mean().sqrt()]
        return float(far.double().mean())

    def flips(i, most=16):
        """The elements of large reference gradient that ``outside`` counts
        in leaf i: index, float32 gradient, the step's own (clipped)
        gradient read back from its first moment, the parameter before,
        after, the float64 update from the float32 gradient (``want``) and
        the float64 update from the step's own gradient (``redo``).  Where
        ``redo`` lands within one ulp of ``after`` the step's arithmetic
        is right and its bf16 gradient made the difference."""
        g = g32[i]
        want = adamw_step1_reference(p0[i], g, ref_norm, opt, lr)
        g_step = mu[i].double() / (1 - opt.b1)          # clipped already
        redo = adamw_step1_reference(p0[i], g_step, opt.clip_norm, opt, lr)
        a = g.abs()
        far = (ulps(got[i], want.to(torch.bfloat16)) > 1) & (
            a >= LM_LARGE_G * a.square().mean().sqrt())
        idx = far.nonzero()
        redo_ulps = ulps(got[i][far], redo.to(torch.bfloat16)[far])
        sign_flips = int((torch.sign(g_step[far]) != torch.sign(
            g[far].double())).sum())
        shown = []
        for t in idx[:most].tolist():
            at = tuple(t)
            shown.append({
                "index": at, "g_f32": float(g[at]),
                "g_step": float(g_step[at]), "before": float(p0[i][at]),
                "after": float(got[i][at]), "want": float(want[at]),
                "redo": float(redo[at]),
                "ulps_want": int(ulps(got[i][at], want[at].to(
                    torch.bfloat16))),
                "ulps_redo": int(ulps(got[i][at], redo[at].to(
                    torch.bfloat16)))})
        out = {"n": len(idx), "redo_within_1_ulp": int(
            (redo_ulps <= 1).sum()), "gradient_sign_flips": sign_flips,
            "elements": shown}
        if names[i] == "embed":
            out["rows"] = embed_rows(idx, g, g_step)
        return out

    def embed_rows(idx, g, g_step):
        """Each embedding element in ``idx``: its token, the token's
        occurrences in the batch, the float32 gradient over the sum of its
        per-occurrence magnitudes (small: the occurrences cancel), and
        whether the step's gradient has the other sign."""
        rows = []
        for v, j in idx.tolist():
            occ = tokens == v
            mag = float(g_occ[occ, j].abs().sum())
            rows.append({"token": v, "col": j, "count": int(occ.sum()),
                         "ratio": abs(float(g[v, j])) / max(mag, 1e-30),
                         "other_sign": bool(torch.sign(g_step[v, j])
                                            != torch.sign(g[v, j]))})
        return rows

    rows = {}
    for i, name in enumerate(names):
        m_ref = (1 - opt.b1) * scale * g32[i].double()
        rows[name] = {
            "moment_rel_l2": float((mu[i].double() - m_ref).norm()
                                   / m_ref.norm()),
            "outside_share": outside(i, g32[i]),
            "outside_share_all": outside(i, g32[i], every=True),
            "moved_share": float((got[i] != p0[i]).double().mean())}
        if rows[name]["outside_share"] > 0:
            rows[name]["flips"] = flips(i)
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
        if "flips" in r:
            f = r["flips"]
            log(f"      {f['n']} elements of large gradient outside; the "
                f"update from the step's own gradient within 1 ulp of the "
                f"step at {f['redo_within_1_ulp']}; the step's gradient of "
                f"the other sign at {f['gradient_sign_flips']}; first "
                f"{len(f['elements'])}: {json.dumps(f['elements'])}")
            if "rows" in f:
                rows_ = f["rows"]
                tokens_ = sorted({r["token"] for r in rows_})
                log(f"      embed elements outside: tokens {tokens_}; (token,"
                    f" col, occurrences, |g32| / sum of |per-occurrence "
                    f"g32|, other sign): " + "; ".join(
                        f"({r['token']}, {r['col']}, {r['count']}, "
                        f"{r['ratio']:.3g}, {int(r['other_sign'])})"
                        for r in rows_))
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
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
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
    batches = [{k: torch.as_tensor(v, dtype=torch.int32, device=dev)
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
    arg_bytes = tree_bytes(params, opt_state, batches[0])
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
    norms = rmsnorm.launches
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
    train_norms = rmsnorm.launches - norms
    changed = sum(not torch.equal(p.detach().reshape(-1)[
        ::max(1, p.numel() // 65536)], s) for p, s in zip(leaves, samples))
    warm = rows[1:] or rows
    step_s = sum(r["seconds"] for r in warm) / len(warm)
    log(f"phase lm_train: {steps} steps x batch 1 x {seq} tokens in "
        f"{ph.seconds:.3f} s; {step_s:.3f} s a step after the first "
        f"({seq / step_s:.1f} tok/s); peak device memory {peak:.2f} GiB; "
        f"{changed} of {len(leaves)} leaves changed; flash launches in the "
        f"steps {train_launches} (plain attention), rmsnorm launches "
        f"{train_norms} (the plain norm, by the route); step-1 loss "
        f"{rows[0]['loss']:.5f}, plain forward {loss_plain:.5f}, kernel "
        f"(tc) forward {loss_kernel:.5f}: mean |d token loss| kernel vs plain "
        f"{d_kernel:.4g}, witness (keys reversed) vs plain {d_witness:.4g}")
    assert changed == len(leaves), (changed, len(leaves))
    assert train_launches == 0 and train_norms == 0, (train_launches,
                                                      train_norms)
    assert d_kernel <= WITNESS_RATIO * d_witness, (d_kernel, d_witness)
    assert abs(loss_kernel - rows[0]["loss"]) <= \
        abs(loss_plain - rows[0]["loss"]) + WITNESS_RATIO * d_witness, \
        (loss_kernel, loss_plain, rows[0]["loss"], d_witness)
    del params, opt_state, leaves, samples, step_fn
    torch.cuda.empty_cache()
    return {"model": cfg.name, "params": n_params, "batch": 1, "seq": seq,
            "steps": rows, "rmsnorm_launches_in_steps": train_norms,
            "seconds_per_step": step_s,
            "tokens_s": seq / step_s, "peak_gib": peak,
            "argument_bytes": arg_bytes,
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


# ---------------------------------------------------------------------------
# The MoE, xLSTM and Mamba phases.  Each resets the launch counts just
# before the path it drives and frees its tensors after it, so that
# qwen3-moe-30b-a3b (56.9 GiB of bf16 weights) finds the card empty.
# ---------------------------------------------------------------------------

MOE_DEPTH_TRAIN = 2
# qwen3-moe's prompt: its 32,768-token logits alone would add 9.3 GiB to
# 56.9 GiB of weights; moe_train, xlstm and mamba_layer take MIXER_LEN
QWEN3_LEN, MIXER_LEN = 8192, 4096
XLSTM_REPLAY, MAMBA_REPLAY = 64, 512
REPLAY_TOL = 2e-2          # tests/test_model_consistency.py, decode replay
MAMBA_TOL = 2e-3           # the same file, Mamba chunked vs stepwise


def free_card() -> None:
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2 ** 30


def moe_breakdown(cfg, params, h, iters: int = 3) -> dict:
    """Device ms of one MoE layer's stages at the prefill's shape, by CUDA
    events: routing (router, top-k, positions, dispatch and combine
    tensors), the dispatch einsum, the expert GEMMs, the combine einsum;
    and the layer's attention (projections, RoPE, the kernel)."""
    from repro_torch.models import attention, moe
    from repro_torch.models.common import take_layer
    from repro_torch.models.lm import _angles_for
    layer = take_layer(params["blocks"][0], 0)
    p = layer["moe"]
    b, s, d = h.shape
    gt, cap = moe._capacity(cfg, b * s)
    xg = h.reshape(-1, gt, d)
    dispatch, combine, _ = moe._route(p, xg, cfg, cap)
    xe = torch.einsum("gtd,gtec->gecd", xg, dispatch)
    ye = moe._experts(p, xe)
    angles = _angles_for(cfg, b, s, h.device)
    with torch.no_grad():
        out = {
            "route": time_ms(lambda: moe._route(p, xg, cfg, cap), iters),
            "dispatch_einsum": time_ms(lambda: torch.einsum(
                "gtd,gtec->gecd", xg, dispatch), iters),
            "expert_gemms": time_ms(lambda: moe._experts(p, xe), iters),
            "combine_einsum": time_ms(lambda: torch.einsum(
                "gecd,gtec->gtd", ye, combine), iters),
            "attention_layer": time_ms(lambda: attention.attention_fwd(
                layer["attn"], h, cfg, angles=angles), iters)}
    out["moe_layer"] = sum(out[k] for k in ("route", "dispatch_einsum",
                                            "expert_gemms", "combine_einsum"))
    del dispatch, combine, xe, ye
    return out


@contextlib.contextmanager
def count_drops():
    """Counts the dropped (token, choice) pairs of every MoE layer a forward
    runs, one device count a layer (no host sync), in the list it yields:
    the pairs routed less those the dispatch tensor keeps."""
    from unittest import mock

    from repro_torch.models import moe
    counts, route = [], moe._route

    def counting(params, xg, cfg, cap):
        dispatch, combine, aux = route(params, xg, cfg, cap)
        counts.append(xg.shape[0] * xg.shape[1] * cfg.top_k
                      - dispatch.sum(dtype=torch.float32))
        return dispatch, combine, aux

    with mock.patch.object(moe, "_route", counting):
        yield counts


def run_moe_prefill(dev, cfg, seq: int, compare_len: int, profile,
                    label: str, params=None) -> dict:
    """A MoE model's prefill through ``make_prefill_step``: every attention
    layer on the kernel's tc path; the dropped (token, choice) pairs
    counted (``count_drops``); with ``compare_len``, the kernel route
    against the plain route first (``compare_routes``, the routed rule)."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         reset_launches)
    from repro_torch.models import lm, moe
    from repro_torch.train.steps import make_prefill_step

    n_attn = cfg.n_repeats * sum(sp.mixer == "attn" for sp in cfg.pattern)
    g = torch.Generator(device=dev).manual_seed(0)
    if params is None:
        t0 = time.perf_counter()
        params = lm.init_model(cfg, g, device=dev)
        torch.cuda.synchronize()
        log(f"{label} init: {cfg.name}, {cfg.param_count() / 1e9:.3f}B "
            f"parameters (bf16, seeded), {time.perf_counter() - t0:.2f} s, "
            f"device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    prefill = make_prefill_step(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (1, seq), device=dev,
                           generator=g)
    out = {"model": cfg.name, "tokens": seq}
    if compare_len:
        out["compare"] = compare_routes(
            cfg, params, {"tokens": tokens[:, :compare_len]}, prefill,
            make_prefill_step(cfg, attn_impl="plain"), label=label)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with count_drops() as dropped, Phase(label, profile) as ph:
        logits = prefill(params, {"tokens": tokens})
    drops = int(sum(int(n) for n in dropped))
    n_moe = len(dropped)
    paths = dict(flash_attention.launches_by_path)
    launches = flash_attention.launches
    peak = peak_gib()                       # before isfinite's temporaries
    finite = bool(torch.isfinite(logits).all())
    pairs = seq * cfg.top_k * n_moe
    log(f"phase {label}: {cfg.name}, {seq} tokens in {ph.seconds:.3f} s "
        f"({seq / ph.seconds:.1f} tok/s), logits {tuple(logits.shape)} "
        f"finite={finite}, flash launches {launches} {paths}; dropped "
        f"(token, choice) pairs {drops} of {pairs} ({100 * drops / pairs:.3f}"
        f"%, capacity factor {cfg.capacity_factor}, groups of "
        f"{moe._capacity(cfg, seq)[0]}); peak device memory {peak:.2f} GiB")
    assert logits.shape == (1, seq, cfg.padded_vocab), logits.shape
    assert finite
    assert launches == n_attn, (launches, n_attn)
    assert paths == {"simt": 0, "tc": n_attn, "short": 0}, paths
    del logits
    out.update(seconds=ph.seconds, tokens_s=seq / ph.seconds,
               launches=launches, launches_by_path=paths,
               dropped_pairs=drops, routed_pairs=pairs, peak_gib=peak)
    return out, params


#: moe_prefill_0924's step: the benchmark cell's 8 prompts of 4,096 tokens
DROPLESS_BATCH, DROPLESS_LEN = 8, 4096


def run_dropless_prefill(dev, profile) -> dict:
    """moe_prefill_0924: OLMoE-1B-7B-0924 at its published widths (all 16
    layers, 64 experts, top 8, seeded bf16 weights) through
    ``make_prefill_step`` on the benchmark cell's step of DROPLESS_BATCH x
    DROPLESS_LEN tokens, after one warm forward: the launch counts reset
    just before the timed forward, every attention layer on the kernel's
    tc path and the dropless dispatch's combine one moe_combine launch a
    layer; finite logits."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         reset_launches)
    from repro_torch.kernels.moe_combine.ops import moe_combine
    from repro_torch.models import lm
    from repro_torch.train.steps import make_prefill_step

    cfg = get_config("olmoe-1b-7b-0924")
    assert cfg.moe_dropless
    n_moe = cfg.n_repeats * sum(sp.mlp == "moe" for sp in cfg.pattern)
    n_attn = cfg.n_repeats * sum(sp.mixer == "attn" for sp in cfg.pattern)
    g = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = lm.init_model(cfg, g, device=dev)
    torch.cuda.synchronize()
    log(f"moe_prefill_0924 init: {cfg.name}, {cfg.param_count() / 1e9:.3f}B "
        f"parameters (bf16, seeded), {time.perf_counter() - t0:.2f} s, "
        f"device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    prefill = make_prefill_step(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (DROPLESS_BATCH, DROPLESS_LEN),
                           device=dev, generator=g)
    prefill(params, {"tokens": tokens})                 # warm
    torch.cuda.synchronize()
    reset_launches()
    moe_combine.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with Phase("moe_prefill_0924", profile) as ph:
        logits = prefill(params, {"tokens": tokens})
    combines, launches = moe_combine.launches, flash_attention.launches
    paths = dict(flash_attention.launches_by_path)
    peak = peak_gib()
    finite = bool(torch.isfinite(logits).all())
    n = DROPLESS_BATCH * DROPLESS_LEN
    log(f"phase moe_prefill_0924: {cfg.name}, {DROPLESS_BATCH} x "
        f"{DROPLESS_LEN} tokens in {ph.seconds:.3f} s ({n / ph.seconds:.1f} "
        f"tok/s), logits {tuple(logits.shape)} finite={finite}, flash "
        f"launches {launches} {paths}, moe_combine launches {combines} "
        f"({n_moe} MoE layers); peak device memory {peak:.2f} GiB")
    assert logits.shape == (DROPLESS_BATCH, DROPLESS_LEN, cfg.padded_vocab)
    assert finite
    assert paths == {"simt": 0, "tc": n_attn, "short": 0}, paths
    assert combines == n_moe, (combines, n_moe)
    del logits, params, tokens
    return {"model": cfg.name, "batch": DROPLESS_BATCH,
            "tokens": DROPLESS_LEN, "seconds": ph.seconds,
            "tokens_s": n / ph.seconds, "launches": launches,
            "launches_by_path": paths, "combine_launches": combines,
            "peak_gib": peak}


def run_moe_decode(dev, cfg, params, profile, steps: int = 16,
                   batch: int = 4, ctx: int = 4096) -> dict:
    """moe_decode: ``steps`` greedy decode steps at batch ``batch`` after
    ``ctx`` seeded keys in every attention cache; then a replay of a 4 x 32
    prompt (``lm.prefill``) against ``lm_logits`` with moe_group_size 64,
    so that both sides are dropless, in float32 (weights cast) within the
    reference's decode-replay bound, as a bf16 replay changes experts at
    near-tied router logits."""
    import dataclasses

    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         reset_launches)
    from repro_torch.models import lm
    from repro_torch.models.common import tree_map
    from repro_torch.train.steps import make_serve_step

    g = torch.Generator(device=dev).manual_seed(2)
    caches = lm.init_cache(cfg, batch, ctx + steps, device=dev)
    for layer in caches:
        for t in layer.values():
            t.normal_(generator=g)
    step = make_serve_step(cfg)
    tok = torch.randint(1, cfg.vocab_size, (batch, 1), device=dev,
                        generator=g)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with Phase("moe_decode", profile) as ph:
        for t in range(steps):
            lg, caches = step(params, caches, tok, ctx + t)
            tok = torch.argmax(lg[:, :, :cfg.vocab_size], dim=-1)
    launches = flash_attention.launches
    finite = bool(torch.isfinite(lg).all())
    peak = peak_gib()
    cache_gb = sum(t.numel() * t.element_size() for layer in caches
                   for t in layer.values()) / 1e9
    del caches
    free_card()
    tok_s = batch * steps / ph.seconds
    # the replay check, float32, dropless on both sides
    rcfg = dataclasses.replace(cfg, moe_group_size=64, dtype="float32",
                               param_dtype="float32")
    p32 = tree_map(lambda a: a.float(), params)
    prompts = torch.randint(1, cfg.vocab_size, (batch, 32), device=dev,
                            generator=g)
    with torch.no_grad():
        replay, _ = lm.prefill(p32, {"tokens": prompts}, rcfg, 32)
        par = lm.lm_logits(p32, {"tokens": prompts}, rcfg)
    mx, mean, top1 = logits_agreement(replay, par, cfg.vocab_size)
    del p32, replay, par
    free_card()
    log(f"phase moe_decode: {steps} steps x batch {batch} at cache {ctx} "
        f"({cache_gb:.2f} GB of cache) in {ph.seconds:.3f} s ({tok_s:.1f} "
        f"tok/s, {1e3 * ph.seconds / steps:.2f} ms per step), finite="
        f"{finite}, flash launches {launches} (decode attention is plain, as "
        f"the reference's); peak device memory {peak:.2f} GiB; replay of "
        f"{batch} x 32 vs lm_logits in float32 (groups of 64, dropless): max "
        f"|d logits| {mx:.4g} (<= {REPLAY_TOL}), mean {mean:.4g}, top-1 "
        f"{top1:.4f}")
    assert finite and launches == 0
    assert mx <= REPLAY_TOL, (mx, mean, top1)
    return {"steps": steps, "batch": batch, "cache": ctx,
            "cache_gb": cache_gb, "seconds": ph.seconds, "tok_s": tok_s,
            "launches": launches, "peak_gib": peak,
            "replay": {"max_abs": mx, "mean_abs": mean, "top1": top1}}


def run_moe_train(dev, cfg, seq: int, steps: int, profile) -> dict:
    """moe_train: make_train_step at the model's widths, depth cut to
    MOE_DEPTH_TRAIN, ``steps`` steps at batch 1 x ``seq``: finite loss and
    aux loss (> 0), every leaf moves, the routers' among them."""
    import dataclasses

    from repro_torch.data.pipeline import TokenDataset
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         reset_launches)
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves_with_names
    from repro_torch.optim.adamw import OptimizerConfig, init_opt_state
    from repro_torch.train.steps import make_train_step

    cut = dataclasses.replace(cfg, n_layers=MOE_DEPTH_TRAIN)
    opt = OptimizerConfig(peak_lr=3e-3, min_lr=3e-4, warmup_steps=1,
                          total_steps=steps, state_dtype=cut.opt_state_dtype)
    ds = TokenDataset(vocab_size=cut.vocab_size, n_docs=16,
                      doc_len=seq + 64, seed=1)
    batches = [{k: torch.as_tensor(v, dtype=torch.int32, device=dev)
                for k, v in ds.batch(0, i, 1, seq).items()}
               for i in range(steps)]
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_model(cut, torch.Generator(device=dev).manual_seed(3),
                           device=dev)
    opt_state = init_opt_state(params, opt)
    named = tree_leaves_with_names(params)
    samples = [p.detach().reshape(-1)[::max(1, p.numel() // 65536)].clone()
               for _, p in named]
    step_fn = make_train_step(cut, opt)
    reset_launches()
    rows = []
    with Phase("moe_train", profile) as ph:
        for i, batch in enumerate(batches):
            t1 = time.perf_counter()
            params, opt_state, m = step_fn(params, opt_state, batch)
            row = {k: float(m[k]) for k in ("loss", "ce_loss", "aux_loss",
                                            "grad_norm", "lr")}
            torch.cuda.synchronize()
            row.update(step=i + 1, seconds=time.perf_counter() - t1)
            rows.append(row)
            log(f"  moe_train step {i + 1}: loss {row['loss']:.5f} (ce "
                f"{row['ce_loss']:.5f} + aux {row['aux_loss']:.6f}) grad "
                f"norm {row['grad_norm']:.5f} {row['seconds']:.3f} s")
            assert all(math.isfinite(v) for v in row.values()), row
            assert row["aux_loss"] > 0, row
    peak = peak_gib()
    moved = {name: not torch.equal(p.detach().reshape(-1)[
        ::max(1, p.numel() // 65536)], s0)
        for (name, p), s0 in zip(tree_leaves_with_names(params), samples)}
    warm = rows[1:] or rows
    step_s = sum(r["seconds"] for r in warm) / len(warm)
    n_params = sum(p.numel() for _, p in named)
    routers = [n for n in moved if n.endswith("moe/router")]
    log(f"phase moe_train: {cfg.name} widths, {MOE_DEPTH_TRAIN} layers "
        f"({n_params / 1e9:.3f}B parameters, moments {cut.opt_state_dtype}),"
        f" {steps} steps x batch 1 x {seq} in {ph.seconds:.3f} s; "
        f"{step_s:.3f} s a step after the first ({seq / step_s:.1f} tok/s); "
        f"peak device memory {peak:.2f} GiB; {sum(moved.values())} of "
        f"{len(moved)} leaves moved (routers {routers}); flash launches "
        f"{flash_attention.launches} (plain attention)")
    assert all(moved.values()), [n for n, v in moved.items() if not v]
    assert routers and flash_attention.launches == 0
    del params, opt_state, samples, step_fn
    free_card()
    return {"model": cfg.name, "depth": MOE_DEPTH_TRAIN, "params": n_params,
            "seq": seq, "steps": rows, "seconds_per_step": step_s,
            "tokens_s": seq / step_s, "peak_gib": peak}


def run_xlstm(dev, seq: int, profile) -> dict:
    """xlstm: xlstm-350m at its published widths, forward at batch 1 x
    ``seq`` (bf16, seeded weights); the sLSTM layers' share of it timed
    alone; decode replay of the first XLSTM_REPLAY tokens against the
    forward, float32."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         reset_launches)
    from repro_torch.models import lm, xlstm
    from repro_torch.models.common import take_layer, tree_map
    from repro_torch.train.steps import make_prefill_step

    cfg = get_config("xlstm-350m")
    g = torch.Generator(device=dev).manual_seed(4)
    params = lm.init_model(cfg, g, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, seq), device=dev,
                           generator=g)
    prefill = make_prefill_step(cfg)
    prefill(params, {"tokens": tokens[:, :256]})            # warm-up
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with Phase("xlstm", profile) as ph:
        logits = prefill(params, {"tokens": tokens})
    launches = flash_attention.launches
    peak = peak_gib()                       # before isfinite's temporaries
    finite = bool(torch.isfinite(logits).all())
    del logits
    n_slstm = cfg.n_repeats * sum(sp.mixer == "slstm" for sp in cfg.pattern)
    pos = next(i for i, sp in enumerate(cfg.pattern) if sp.mixer == "slstm")
    x = torch.randn(1, seq, cfg.d_model, device=dev, generator=g).to(
        params["embed"].dtype)
    sp = take_layer(params["blocks"][pos], 0)["slstm"]
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xlstm.slstm_fwd(sp, x, cfg)
        torch.cuda.synchronize()
        slstm_s = time.perf_counter() - t0
    share = n_slstm * slstm_s / ph.seconds
    # decode replay against the forward, float32
    f32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    p32 = tree_map(lambda a: a.float(), params)
    short = {"tokens": tokens[:, :XLSTM_REPLAY]}
    with torch.no_grad():
        replay, _ = lm.prefill(p32, short, f32, XLSTM_REPLAY)
        par = lm.lm_logits(p32, short, f32)
    mx, mean, top1 = logits_agreement(replay, par, cfg.vocab_size)
    del p32, replay, par, params, x
    free_card()
    log(f"phase xlstm: {cfg.name} ({cfg.n_layers} layers, {n_slstm} sLSTM), "
        f"forward {seq} tokens in {ph.seconds:.3f} s ({seq / ph.seconds:.1f} "
        f"tok/s), finite={finite}; one sLSTM layer's loop alone {slstm_s:.3f}"
        f" s ({seq} steps), the {n_slstm} sLSTM layers ~{100 * share:.1f}% of "
        f"the forward; peak device memory {peak:.2f} GiB; flash launches "
        f"{launches} (no attention); replay of {XLSTM_REPLAY} tokens vs the "
        f"forward in float32: max |d logits| {mx:.4g} (<= {REPLAY_TOL}), "
        f"mean {mean:.4g}, top-1 {top1:.4f}")
    assert finite and launches == 0
    assert mx <= REPLAY_TOL, (mx, mean, top1)
    return {"model": cfg.name, "tokens": seq, "seconds": ph.seconds,
            "tokens_s": seq / ph.seconds, "slstm_layer_s": slstm_s,
            "slstm_share": share, "peak_gib": peak, "launches": launches,
            "replay": {"tokens": XLSTM_REPLAY, "max_abs": mx,
                       "mean_abs": mean, "top1": top1}}


def run_mamba_layer(dev, seq: int, profile) -> dict:
    """mamba_layer: one Mamba mixer at jamba-1.5-large's published widths
    (seeded weights), mamba_fwd at batch 1 x ``seq`` in bf16; in float32,
    MAMBA_REPLAY tokens through mamba_decode against mamba_fwd."""
    from repro_torch.configs import get_config
    from repro_torch.models import common, mamba
    from repro_torch.models.common import tree_map

    cfg = get_config("jamba-1.5-large-398b")
    g = torch.Generator(device=dev).manual_seed(5)
    params = common.init_params(mamba.mamba_specs(cfg), g, device=dev)
    x = torch.randn(1, seq, cfg.d_model, device=dev, generator=g)
    xb = x.bfloat16()
    with torch.no_grad():
        mamba.mamba_fwd(params, xb[:, :cfg.ssm_chunk], cfg)     # warm-up
        torch.cuda.reset_peak_memory_stats()
        with Phase("mamba_layer", profile) as ph:
            y = mamba.mamba_fwd(params, xb, cfg)
    finite = bool(torch.isfinite(y).all())
    peak = peak_gib()
    del y
    free_card()
    p32 = tree_map(lambda a: a.float(), params)
    n = MAMBA_REPLAY
    with torch.no_grad():
        want = mamba.mamba_fwd(p32, x[:, :n], cfg)
        conv = torch.zeros(1, cfg.ssm_conv_width - 1, cfg.d_inner,
                           device=dev)
        h = torch.zeros(1, cfg.d_inner, cfg.ssm_state_dim, device=dev)
        got = []
        for t in range(n):
            yt, conv, h = mamba.mamba_decode(p32, x[:, t:t + 1], conv, h, cfg)
            got.append(yt)
        got = torch.cat(got, 1)
    diff = (got - want).abs()
    err = float(diff.max())
    outside = int((diff > MAMBA_TOL + MAMBA_TOL * want.abs()).sum())
    scale = float(want.abs().max())
    del p32, params, x, xb, want, got, diff
    free_card()
    log(f"phase mamba_layer: jamba-1.5-large widths (d {cfg.d_model}, "
        f"d_inner {cfg.d_inner}, N {cfg.ssm_state_dim}, dt_rank "
        f"{cfg.dt_rank}, conv {cfg.ssm_conv_width}, chunk {cfg.ssm_chunk}), "
        f"mamba_fwd {seq} tokens (bf16) in {ph.seconds:.3f} s "
        f"({seq / ph.seconds:.1f} tok/s), finite={finite}, peak device "
        f"memory {peak:.2f} GiB; {n} decode steps vs mamba_fwd in float32: "
        f"max |d| {err:.4g} (outputs up to {scale:.4g}; {outside} outside "
        f"rtol/atol {MAMBA_TOL})")
    assert finite and outside == 0, (err, outside)
    return {"tokens": seq, "seconds": ph.seconds, "tokens_s": seq / ph.seconds,
            "peak_gib": peak, "replay": {"tokens": n, "max_abs": err,
                                         "outside": outside}}


def run_mixers(dev, prefill_len: int, compare_len: int, profile) -> dict:
    """The phases of the MoE, xLSTM and Mamba slice, in an order that
    leaves the card empty for qwen3-moe-30b-a3b."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm, moe

    olmoe = get_config("olmoe-1b-7b")
    out = {}
    prefill, params = run_moe_prefill(dev, olmoe, prefill_len, compare_len,
                                      profile, "moe_prefill")
    # where the time goes in one layer, at the prompt's shape
    with torch.no_grad():
        h = lm._embed_tokens(params, torch.randint(
            0, olmoe.vocab_size, (1, prefill_len), device=dev))
    prefill["layer_ms"] = moe_breakdown(olmoe, params, h)
    del h
    free_card()
    log("moe_prefill one layer at " + str(prefill_len) + " tokens, device ms: "
        + ", ".join(f"{k} {v:.3f}" for k, v in prefill["layer_ms"].items()))
    out["moe_prefill"] = prefill
    out["moe_decode"] = run_moe_decode(dev, olmoe, params, profile)
    del params
    free_card()
    out["moe_prefill_0924"] = run_dropless_prefill(dev, profile)
    free_card()
    out["moe_train"] = run_moe_train(dev, olmoe, MIXER_LEN, 3, profile)
    out["xlstm"] = run_xlstm(dev, MIXER_LEN, profile)
    out["mamba_layer"] = run_mamba_layer(dev, MIXER_LEN, profile)
    qwen3 = get_config("qwen3-moe-30b-a3b")
    assert torch.cuda.memory_allocated() < 2 ** 30, \
        torch.cuda.memory_allocated()
    out["moe_prefill_qwen3"], params = run_moe_prefill(
        dev, qwen3, QWEN3_LEN, 0, profile, "moe_prefill_qwen3")
    del params
    free_card()
    # the kernel alone at the two models' prefill shapes
    out["flash_full"] = [time_flash_full(dev, olmoe, prefill_len),
                         time_flash_full(dev, qwen3, QWEN3_LEN, plain=True)]
    free_card()
    return out


# ---------------------------------------------------------------------------
# qwen2-vl-7b: M-RoPE and the vision prefix
# ---------------------------------------------------------------------------

# the card's decode replay against the CPU's: the model's widths with its
# depth cut to VLM_REPLAY_DEPTH layers and the weights cast to float32 (the
# whole model in float32, 30.5 GB, would take the host seconds a step to
# read); a replay prefill of VLM_REPLAY_LEN tokens inside the vision prefix
# (negative M-RoPE decode positions), then the decode steps over the
# seeded caches
VLM_REPLAY_DEPTH, VLM_REPLAY_LEN = 2, 24
# the kernel at the prefill's shape, held head by head: the edges of the
# GQA groups of 7 at 28 heads on 4 (kv heads 0, 0, 1, 2, 3, 3)
VLM_HELD_HEADS = (0, 6, 7, 20, 21, 27)


def vlm_replay(params, cfg, prompts, vision, caches, toks, ctx: int):
    """Logits of a replay ``lm.prefill`` of ``prompts`` (with ``vision``
    in the batch, which the replay ignores, as the reference's does) and
    of one decode step per token of ``toks`` at positions ``ctx``.. over
    ``caches`` (updated in place)."""
    from repro_torch.models import lm
    with torch.no_grad():
        replay, _ = lm.prefill(params, {"tokens": prompts,
                                        "vision_embeds": vision}, cfg,
                               prompts.shape[1])
        steps = []
        for t, tok in enumerate(toks):
            lg, caches = lm.decode_step(params, caches, tok, ctx + t, cfg)
            steps.append(lg[:, 0])
    return replay, torch.stack(steps, 1)


def run_vlm(dev, prefill_len: int, compare_len: int, profile) -> dict:
    """vlm_prefill and vlm_decode at qwen2-vl-7b's published widths (seeded
    bf16 weights, a 256-patch vision prefix); then the kernel alone at the
    prefill's shape, held head by head against the plain version."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         reset_launches)
    from repro_torch.models import lm
    from repro_torch.models.common import tree_map
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    cfg = get_config("qwen2-vl-7b")
    n_attn = cfg.n_repeats * sum(sp.mixer == "attn" for sp in cfg.pattern)
    g = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = lm.init_model(cfg, g, device=dev)
    torch.cuda.synchronize()
    log(f"vlm init: {cfg.name}, {cfg.param_count() / 1e9:.3f}B parameters "
        f"(bf16, seeded), {time.perf_counter() - t0:.2f} s, device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    prefill = make_prefill_step(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (1, prefill_len), device=dev,
                           generator=g)
    # the stubbed frontend's output: seeded patch embeddings at the
    # embedding rows' scale (init draws normal / sqrt(fan_in), fan_in the
    # padded vocabulary)
    vision = torch.randn(1, cfg.vision_tokens, cfg.d_model, device=dev,
                         generator=g) / math.sqrt(cfg.padded_vocab)
    vision = vision.bfloat16()
    out = {"model": cfg.name, "tokens": prefill_len,
           "vision_tokens": cfg.vision_tokens}
    # the kernel route against the plain route, the vision prefix merged
    # and on the M-RoPE grid (also warms cuBLAS and the kernel up)
    out["compare"] = compare_routes(
        cfg, params, {"tokens": tokens[:, :compare_len],
                      "vision_embeds": vision}, prefill,
        make_prefill_step(cfg, attn_impl="plain"), label="vlm_prefill")
    free_card()

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with Phase("vlm_prefill", profile) as ph:
        logits = prefill(params, {"tokens": tokens, "vision_embeds": vision})
    launches = flash_attention.launches
    paths = dict(flash_attention.launches_by_path)
    peak = peak_gib()                       # before isfinite's temporaries
    finite = bool(torch.isfinite(logits).all())
    log(f"phase vlm_prefill: {cfg.name}, {prefill_len} tokens "
        f"({cfg.vision_tokens} of them vision patches) in {ph.seconds:.3f} s "
        f"({prefill_len / ph.seconds:.1f} tok/s), logits "
        f"{tuple(logits.shape)} finite={finite}, flash launches {launches} "
        f"{paths}, peak device memory {peak:.2f} GiB")
    assert logits.shape == (1, prefill_len, cfg.padded_vocab), logits.shape
    assert finite
    assert launches == n_attn, (launches, n_attn)
    assert paths == {"simt": 0, "tc": n_attn, "short": 0}, paths
    del logits
    free_card()
    out.update(seconds=ph.seconds, tokens_s=prefill_len / ph.seconds,
               launches=launches, launches_by_path=paths, peak_gib=peak)

    # vlm_decode: 16 greedy steps at batch 4 after 4,096 seeded cache slots
    # (M-RoPE decode positions 3,841..)
    batch, ctx, steps = 4, 4096, 16
    caches = lm.init_cache(cfg, batch, ctx + steps, device=dev)
    for layer in caches:
        for t in layer.values():
            t.normal_(generator=g)
    seeded = tree_map(lambda a: a[:VLM_REPLAY_DEPTH].float().cpu(), caches)
    step = make_serve_step(cfg)
    tok = torch.randint(1, cfg.vocab_size, (batch, 1), device=dev,
                        generator=g)
    fed = []
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with Phase("vlm_decode", profile) as ph:
        for t in range(steps):
            fed.append(tok)
            lg, caches = step(params, caches, tok, ctx + t)
            tok = torch.argmax(lg[:, :, :cfg.vocab_size], dim=-1)
    dec_launches = flash_attention.launches
    dec_finite = bool(torch.isfinite(lg).all())
    dec_peak = peak_gib()
    tok_s = batch * steps / ph.seconds
    del caches, lg
    log(f"phase vlm_decode: {steps} steps x batch {batch} at cache {ctx} "
        f"(M-RoPE positions {ctx - cfg.vision_tokens + 1}..) in "
        f"{ph.seconds:.3f} s ({tok_s:.1f} tok/s, "
        f"{1e3 * ph.seconds / steps:.2f} ms per step), finite={dec_finite}, "
        f"flash launches {dec_launches} (decode attention is plain, as the "
        f"reference's); peak device memory {dec_peak:.2f} GiB")
    assert dec_finite and dec_launches == 0

    # the card's replay against the CPU's, depth cut, float32 (TF32 off)
    rcfg = dataclasses.replace(cfg, n_layers=VLM_REPLAY_DEPTH,
                               dtype="float32", param_dtype="float32")
    cut = dict(params, blocks=tree_map(lambda a: a[:VLM_REPLAY_DEPTH],
                                       params["blocks"]))
    p32 = tree_map(lambda a: a.float(), cut)
    del params, cut
    free_card()
    prompts = torch.randint(1, cfg.vocab_size, (batch, VLM_REPLAY_LEN),
                            device=dev, generator=g)
    fed = torch.stack(fed).cpu()
    t0 = time.perf_counter()
    card = vlm_replay(p32, rcfg, prompts, vision.expand(batch, -1, -1),
                      tree_map(lambda a: a.to(dev), seeded), fed.to(dev), ctx)
    card = [x.cpu() for x in card]
    card_s = time.perf_counter() - t0
    p32 = tree_map(lambda a: a.cpu(), p32)
    free_card()
    t0 = time.perf_counter()
    host = vlm_replay(p32, rcfg, prompts.cpu(),
                      vision.cpu().expand(batch, -1, -1), seeded, fed, ctx)
    host_s = time.perf_counter() - t0
    del p32, seeded
    replay = {}
    for name, a, b in zip(("prefill", "decode"), card, host):
        mx, mean, top1 = logits_agreement(a, b, cfg.vocab_size)
        replay[name] = {"max_abs": mx, "mean_abs": mean, "top1": top1}
    log(f"vlm_decode replay, card vs CPU ({VLM_REPLAY_DEPTH} layers at full "
        f"width, float32): prefill of {batch} x {VLM_REPLAY_LEN} (M-RoPE "
        f"positions {1 - cfg.vision_tokens}.."
        f"{VLM_REPLAY_LEN - cfg.vision_tokens}) max |d logits| "
        f"{replay['prefill']['max_abs']:.4g}, mean "
        f"{replay['prefill']['mean_abs']:.4g}; {steps} decode steps at cache "
        f"{ctx} max |d logits| {replay['decode']['max_abs']:.4g}, mean "
        f"{replay['decode']['mean_abs']:.4g} (<= {REPLAY_TOL}); card "
        f"{card_s:.2f} s, CPU {host_s:.2f} s")
    assert all(r["max_abs"] <= REPLAY_TOL for r in replay.values()), replay
    out["decode"] = {"steps": steps, "batch": batch, "cache": ctx,
                     "seconds": ph.seconds, "tok_s": tok_s,
                     "launches": dec_launches, "peak_gib": dec_peak,
                     "replay": replay, "replay_depth": VLM_REPLAY_DEPTH}
    free_card()
    # the kernel alone at the prefill's shape, held head by head
    out["flash_full"] = time_flash_full(dev, cfg, prefill_len,
                                        heads=VLM_HELD_HEADS)
    free_card()
    return out


# seamless-m4t-large-v2: a prompt's length split 50/50 between encoder
# frames and decoder tokens, as the reference splits its shapes
# (src/repro/launch/specs.py); decode at batch 4 over 4,096 encoded frames
# and 4,096 seeded self-attention slots; its replay, float32 at full depth,
# of 4 x 48 tokens over 256 frames
SEAMLESS_DECODE_BATCH, SEAMLESS_DECODE_CTX, SEAMLESS_DECODE_STEPS = 4, 4096, 16
SEAMLESS_REPLAY_BATCH, SEAMLESS_REPLAY_LEN, SEAMLESS_REPLAY_FRAMES = 4, 48, 256


def seamless_frames(cfg, b: int, s: int, g, dev) -> torch.Tensor:
    """Seeded frame embeddings (B, S, D), the stubbed audio frontend's
    output, at the embedding rows' scale (init draws normal / sqrt(fan_in),
    fan_in the padded vocabulary), in bf16."""
    return (torch.randn(b, s, cfg.d_model, device=dev, generator=g)
            / math.sqrt(cfg.padded_vocab)).bfloat16()


def prefill_in_weight_dtype(cfg, attn_impl: str):
    """``make_prefill_step`` of ``cfg`` run in the dtype of the weights it
    is given: the encoder casts its input to ``cfg.dtype``, so the weights
    cast to float32 take a config whose dtype is float32 too."""
    import dataclasses

    from repro_torch.train.steps import make_prefill_step
    steps = {dt: make_prefill_step(dataclasses.replace(cfg, dtype=dt),
                                   attn_impl=attn_impl)
             for dt in ("bfloat16", "float32")}
    return lambda p, batch: steps[str(p["embed"].dtype)[6:]](p, batch)


def run_seamless(dev, prefill_len: int, compare_len: int, profile) -> dict:
    """seamless_prefill and seamless_decode at seamless-m4t-large-v2's
    published widths (seeded bf16 weights, seeded frame embeddings); then
    the kernel alone at its two layer shapes, bidirectional (encoder and
    cross) and causal (decoder self), every head held against the plain
    version on its own."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         reset_launches)
    from repro_torch.models import lm
    from repro_torch.models.common import tree_map
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    cfg = get_config("seamless-m4t-large-v2")
    # encoder self, decoder self and decoder cross: one launch each a layer
    n_attn = cfg.n_encoder_layers + 2 * cfg.n_repeats
    g = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = lm.init_model(cfg, g, device=dev)
    torch.cuda.synchronize()
    log(f"seamless init: {cfg.name}, {cfg.param_count() / 1e9:.3f}B "
        f"parameters (bf16, seeded), {time.perf_counter() - t0:.2f} s, device "
        f"memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    enc_len = prefill_len // 2
    dec_len = prefill_len - enc_len
    frames = seamless_frames(cfg, 1, enc_len, g, dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, dec_len), device=dev,
                           generator=g)
    out = {"model": cfg.name, "frames": enc_len, "tokens": dec_len}
    # the kernel route against the plain route at compare_len, split the
    # same way (also warms cuBLAS and the kernel up); the float32 run takes
    # the kernel's simt path
    c_enc = compare_len // 2
    reset_launches()
    out["compare"] = compare_routes(
        cfg, params, {"tokens": tokens[:, :compare_len - c_enc],
                      "enc_embeds": frames[:, :c_enc]},
        prefill_in_weight_dtype(cfg, "kernel"),
        prefill_in_weight_dtype(cfg, "plain"), label="seamless_prefill")
    cmp_paths = dict(flash_attention.launches_by_path)
    log(f"seamless_prefill compare: {c_enc} frames, "
        f"{compare_len - c_enc} tokens; flash launches {cmp_paths} (bf16 on "
        f"tc, float32 on simt)")
    assert cmp_paths == {"simt": n_attn, "tc": n_attn, "short": 0}, cmp_paths
    out["compare"]["launches_by_path"] = cmp_paths
    free_card()

    prefill = make_prefill_step(cfg)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with Phase("seamless_prefill", profile) as ph:
        logits = prefill(params, {"tokens": tokens, "enc_embeds": frames})
    launches = flash_attention.launches
    paths = dict(flash_attention.launches_by_path)
    peak = peak_gib()                       # before isfinite's temporaries
    finite = bool(torch.isfinite(logits).all())
    log(f"phase seamless_prefill: {cfg.name}, {enc_len} frames + {dec_len} "
        f"tokens in {ph.seconds:.3f} s ({prefill_len / ph.seconds:.1f} "
        f"frames and tokens/s), logits {tuple(logits.shape)} "
        f"finite={finite}, flash launches {launches} {paths}, peak device "
        f"memory {peak:.2f} GiB")
    assert logits.shape == (1, dec_len, cfg.padded_vocab), logits.shape
    assert finite
    assert launches == n_attn, (launches, n_attn)
    assert paths == {"simt": 0, "tc": n_attn, "short": 0}, paths
    del logits, frames, tokens
    free_card()
    out.update(seconds=ph.seconds, tokens_s=prefill_len / ph.seconds,
               launches=launches, launches_by_path=paths, peak_gib=peak)

    # seamless_decode: encode the frames on the card, fill the cross K/V as
    # prefill fills them, seed the self-attention slots, then greedy steps
    batch, ctx = SEAMLESS_DECODE_BATCH, SEAMLESS_DECODE_CTX
    steps = SEAMLESS_DECODE_STEPS
    dframes = seamless_frames(cfg, batch, ctx, g, dev)
    caches = lm.init_cache(cfg, batch, ctx + steps, ctx, device=dev)
    for layer in caches:
        for name in ("k", "v"):
            layer[name].normal_(generator=g)
    step = make_serve_step(cfg)
    tok = torch.randint(1, cfg.vocab_size, (batch, 1), device=dev,
                        generator=g)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with Phase("seamless_decode", profile) as ph:
        with torch.no_grad():
            lm.fill_cross_caches(params, caches,
                                 lm.encode(params, dframes, cfg))
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - ph.t0
        for t in range(steps):
            lg, caches = step(params, caches, tok, ctx + t)
            tok = torch.argmax(lg[:, :, :cfg.vocab_size], dim=-1)
    dec_launches = flash_attention.launches
    dec_paths = dict(flash_attention.launches_by_path)
    dec_finite = bool(torch.isfinite(lg).all())
    dec_peak = peak_gib()
    step_ms = 1e3 * (ph.seconds - enc_s) / steps
    del caches, lg, dframes
    log(f"phase seamless_decode: encode {batch} x {ctx} frames and fill "
        f"the cross K/V {enc_s:.3f} s; {steps} steps x batch {batch} at "
        f"self cache {ctx} and cross {ctx} in {ph.seconds - enc_s:.3f} s "
        f"({step_ms:.2f} ms per step, {batch * 1e3 / step_ms:.1f} tok/s), "
        f"finite={dec_finite}, flash launches {dec_launches} {dec_paths} "
        f"(the encoder's; decode attention is plain, as the reference's); "
        f"peak device memory {dec_peak:.2f} GiB")
    assert dec_finite
    assert dec_paths == {"simt": 0, "tc": cfg.n_encoder_layers,
                         "short": 0}, dec_paths

    # the replay against the parallel forward, float32 at full depth
    rcfg = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    p32 = tree_map(lambda a: a.float(), params)
    del params
    free_card()
    rb = {"tokens": torch.randint(1, cfg.vocab_size, (
        SEAMLESS_REPLAY_BATCH, SEAMLESS_REPLAY_LEN), device=dev, generator=g),
          "enc_embeds": seamless_frames(
              cfg, SEAMLESS_REPLAY_BATCH, SEAMLESS_REPLAY_FRAMES, g,
              dev).float()}
    t0 = time.perf_counter()
    with torch.no_grad():
        par = lm.lm_logits(p32, rb, rcfg)
        replay, _ = lm.prefill(p32, rb, rcfg, SEAMLESS_REPLAY_LEN)
    torch.cuda.synchronize()
    mx, mean, top1 = logits_agreement(replay, par, cfg.vocab_size)
    log(f"seamless_decode replay ({SEAMLESS_REPLAY_BATCH} x "
        f"{SEAMLESS_REPLAY_LEN} tokens over {SEAMLESS_REPLAY_FRAMES} frames, "
        f"float32, all {cfg.n_encoder_layers} + {cfg.n_repeats} layers) vs "
        f"the parallel forward: max |d logits| {mx:.4g}, mean {mean:.4g}, "
        f"top-1 {top1:.5f} (<= {REPLAY_TOL}); {time.perf_counter() - t0:.2f}"
        f" s")
    assert mx <= REPLAY_TOL, mx
    out["decode"] = {"steps": steps, "batch": batch, "frames": ctx,
                     "cache": ctx, "encode_s": enc_s, "step_ms": step_ms,
                     "tok_s": batch * 1e3 / step_ms,
                     "launches": dec_launches, "launches_by_path": dec_paths,
                     "peak_gib": dec_peak,
                     "replay": {"max_abs": mx, "mean_abs": mean,
                                "top1": top1}}
    del p32, par, replay, rb
    free_card()
    # the kernel alone at both layer shapes, every head held on its own
    heads = tuple(range(cfg.n_heads))
    out["flash_full"] = [
        time_flash_full(dev, cfg, enc_len, heads=heads, causal=False),
        time_flash_full(dev, cfg, dec_len, heads=heads, causal=True)]
    free_card()
    return out


# phi3-medium-14b: the kernel alone is held at the group edges (query heads
# 0, 3 on KV head 0; 4 on 1; 36, 39 on 9); the float32 route comparison at
# 8 of its 40 layers (float32 weights of all 40, 54.6 GiB, do not fit
# beside the bf16 ones)
PHI3_HELD_HEADS = (0, 3, 4, 36, 39)
PHI3_F32_DEPTH = 8


def run_phi3(dev, prefill_len: int, compare_len: int, profile) -> dict:
    """phi3_prefill at phi3-medium-14b's published widths (seeded bf16
    weights): the kernel route against the plain route, the prefill with
    its analytic FLOPs, then the kernel alone at the prefill's shape, held
    head by head."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         reset_launches)
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.launch import analytic
    from repro_torch.models import lm
    from repro_torch.train.steps import make_prefill_step

    cfg = get_config("phi3-medium-14b")
    n_attn = cfg.n_repeats * sum(sp.mixer == "attn" for sp in cfg.pattern)
    g = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = lm.init_model(cfg, g, device=dev)
    torch.cuda.synchronize()
    log(f"phi3 init: {cfg.name}, {cfg.param_count() / 1e9:.3f}B parameters "
        f"(bf16, seeded), {time.perf_counter() - t0:.2f} s, device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    prefill = make_prefill_step(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (1, prefill_len), device=dev,
                           generator=g, dtype=torch.int32)
    out = {"model": cfg.name, "tokens": prefill_len,
           "argument_bytes": tree_bytes(params, tokens)}
    # the kernel route against the plain route (also warms cuBLAS and the
    # kernel up)
    out["compare"] = compare_routes(
        cfg, params, {"tokens": tokens[:, :compare_len]}, prefill,
        make_prefill_step(cfg, attn_impl="plain"), label="phi3_prefill",
        f32_depth=PHI3_F32_DEPTH)
    free_card()

    flops = analytic.forward_cost(cfg, 1, prefill_len).flops
    reset_launches()
    norms = rmsnorm.launches
    torch.cuda.reset_peak_memory_stats()
    with Phase("phi3_prefill", profile) as ph:
        logits = prefill(params, {"tokens": tokens})
    launches = flash_attention.launches
    paths = dict(flash_attention.launches_by_path)
    norms = rmsnorm.launches - norms
    peak = peak_gib()                       # before isfinite's temporaries
    finite = bool(torch.isfinite(logits).all())
    log(f"phase phi3_prefill: {cfg.name}, {prefill_len} tokens in "
        f"{ph.seconds:.3f} s ({prefill_len / ph.seconds:.1f} tok/s; "
        f"{flops:.4e} flops by launch/analytic.py's forward_cost, "
        f"{flops / ph.seconds / 1e12:.1f} TFLOP/s), logits "
        f"{tuple(logits.shape)} finite={finite}, flash launches {launches} "
        f"{paths}, rmsnorm launches {norms}, peak device memory "
        f"{peak:.2f} GiB")
    assert logits.shape == (1, prefill_len, cfg.padded_vocab), logits.shape
    assert finite
    assert launches == n_attn, (launches, n_attn)
    assert paths == {"simt": 0, "tc": n_attn, "short": 0}, paths
    assert norms == 2 * cfg.n_layers + 1, norms
    del logits, params
    free_card()
    out.update(seconds=ph.seconds, tokens_s=prefill_len / ph.seconds,
               analytic_flops=flops, tflops_s=flops / ph.seconds / 1e12,
               launches=launches, launches_by_path=paths,
               rmsnorm_launches=norms, peak_gib=peak)
    # the kernel alone at the prefill's shape, held head by head
    out["flash_full"] = time_flash_full(dev, cfg, prefill_len,
                                        heads=PHI3_HELD_HEADS)
    free_card()
    return out


# ---------------------------------------------------------------------------
# The mesh layer (parallel/, optim/compression.py, runtime/elastic.py,
# checkpoint restore with shardings) on the card.  compress runs in this
# process; compressed_psum, seq_dp_prefill, pipeline and elastic_restore in
# PAR_RANKS spawned processes sharing the one card over gloo (NCCL takes
# one rank per GPU), so their times say nothing of NCCL across cards; then
# compressed_psum once more on a 1-rank NCCL group.  gloo runs all_reduce,
# broadcast and all_gather on CUDA tensors, and the port stages send/recv
# through host memory (parallel/collectives.py); DTensor.full_tensor()
# over gloo on CUDA tensors crashed torch 2.11 on the H100, so every check
# reads each rank's own slice.
# ---------------------------------------------------------------------------

PAR_RANKS = 4
PAR_GROUP_TIMEOUT_S = 240     # each collective of the multi-rank phases
PAR_DEADLINE_S = 600          # all of them; then every rank is killed
COMPRESS_ROUNDS = 3
# bytes a round per element: g (bf16) and e (f32) read for the max and
# again for the codes, deq (bf16) and e (f32) written once
COMPRESS_BYTES = 2 * (2 + 4) + (2 + 4)
COMPRESS_CONVERGE = 1 << 20   # elements of the error-feedback rule's leaf
SEQ_WITNESS_RATIO = 1.5       # bf16: mean |d logit| against the witness's
SEQ_F32_DEPTH, SEQ_F32_TOL = 8, 2e-3
SEQ_TAIL = 256                # positions per shard held at full length
PIPE_BATCH, PIPE_SEQ, PIPE_MICRO = 4, 4096, 4
PIPE_F32_DEPTH, PIPE_F32_TOL = 4, 1e-4
PIPE_BF16_REL = 2e-2          # max |d| over max |h|, whole-batch reference


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _peak(dev) -> float:
    return peak_gib() if dev.type == "cuda" else 0.0


def _reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _free(dev) -> None:
    if dev.type == "cuda":
        free_card()


def run_compress(dev, cfg) -> dict:
    """compress: error-feedback int8 compression (``compress_decompress``)
    of a seeded bf16 "gradient" tree with every leaf shape of ``cfg``, its
    float32 errors carried from round to round; CUDA-event time a round
    beside the bound of COMPRESS_BYTES an element; one leaf against the
    CPU (bitwise) and the JAX package's convergence rule on a 1M leaf."""
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves_with_names
    from repro_torch.optim.compression import compress_decompress
    g = torch.Generator(device=dev).manual_seed(5)
    names, grads, errors = [], [], []
    for name, spec in tree_leaves_with_names(lm.model_specs(cfg)):
        names.append(name)
        grads.append(torch.randn(spec.shape, generator=g, device=dev,
                                 dtype=torch.bfloat16))
        errors.append(torch.zeros(spec.shape, device=dev))
    n = sum(t.numel() for t in grads)

    def one_round():
        for i, gi in enumerate(grads):
            _, errors[i] = compress_decompress(gi, errors[i])

    _reset_peak(dev)
    ms = time_ms(one_round, COMPRESS_ROUNDS)
    peak = _peak(dev)
    n_bytes = COMPRESS_BYTES * n
    bound = 1e3 * n_bytes / PEAK_BYTES_S
    # one leaf against the CPU, from the errors the rounds left
    i = names.index("blocks/0/attn/wk")
    deq, err = compress_decompress(grads[i], errors[i])
    deq_c, err_c = compress_decompress(grads[i].cpu(), errors[i].cpu())
    cpu_equal = bool(torch.equal(deq.cpu(), deq_c)
                     and torch.equal(err.cpu(), err_c))
    del grads, errors, deq, err, deq_c, err_c
    # the JAX package's rule: the accumulated dequantized stream follows
    # the accumulated gradient within 2% of its largest element
    g1 = torch.randn(COMPRESS_CONVERGE, generator=g, device=dev)
    e1 = torch.zeros_like(g1)
    acc = torch.zeros(COMPRESS_CONVERGE, dtype=torch.float64, device=dev)
    for _ in range(50):
        deq, e1 = compress_decompress(g1, e1)
        acc += deq.double()
    true = 50 * g1.double()
    rel = float((acc - true).abs().max() / true.abs().max())
    free_card()
    out = {"elements": n, "leaves": len(names), "rounds": COMPRESS_ROUNDS,
           "ms_per_round": ms, "bytes_per_round": n_bytes,
           "bound_ms": bound, "peak_gib": peak,
           "cpu_leaf": names[i], "cpu_bitwise": cpu_equal,
           "converge_rel_50": rel}
    log(f"phase compress: {n} elements in {len(names)} leaves (bf16, "
        f"float32 errors), {ms:.3f} ms a round (CUDA events, {COMPRESS_ROUNDS}"
        f" rounds), {n_bytes / 1e9:.2f} GB a round at {COMPRESS_BYTES} B an "
        f"element, bound {bound:.3f} ms at {PEAK_BYTES_S / 1e12:.2f} TB/s; "
        f"peak {peak:.2f} GiB; {names[i]} against the CPU bitwise: "
        f"{cpu_equal}; 50 rounds of error feedback on {COMPRESS_CONVERGE} "
        f"elements: rel {rel:.3g} (< 0.02)")
    assert cpu_equal and rel < 0.02, out
    return out


def _block_leaves(cfg, dev, seed: int, dtype=torch.bfloat16) -> list:
    """Seeded tensors with the leaf shapes of one block of ``cfg``."""
    from repro_torch.models import blocks
    from repro_torch.models.common import tree_leaves
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s.shape, generator=g, device=dev, dtype=dtype)
            for s in tree_leaves(blocks.block_specs(cfg))]


def _par_compressed_psum(dev, cfg, rank: int, world: int) -> dict:
    """compressed_psum: each rank's own seeded gradient (one block's leaf
    shapes, bf16) and error through ``make_compressed_psum`` over a 1-D
    mesh of every rank; the mean equal on every rank and within max|g|/64
    of the true mean, the errors ``g + e - dequant(q)`` with the shared
    scale; every rank regenerates all ranks' gradients to check."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.compression import make_compressed_psum
    mesh = make_mesh((world,), ("data",), dev.type)
    f = make_compressed_psum(mesh, ("data",))
    grads = _block_leaves(cfg, dev, 100 + rank)
    errs = [1e-3 * t.float() for t in _block_leaves(cfg, dev, 200 + rank)]
    mean, new_e = f(grads, errs)            # warm-up, then timed
    _sync(dev)
    dist.barrier()
    t0 = time.perf_counter()
    mean, new_e = f(grads, errs)
    _sync(dev)
    seconds = time.perf_counter() - t0
    equal = True
    for m in mean:
        m0 = m.clone()
        dist.broadcast(m0, src=0)
        equal &= bool(torch.equal(m0, m))
    # every rank's g + e, regenerated: the true mean and the shared scale
    total = [torch.zeros(m.shape, device=dev) for m in mean]
    top = [torch.zeros((), device=dev) for _ in mean]
    for r in range(world):
        for i, (gr, er) in enumerate(zip(_block_leaves(cfg, dev, 100 + r),
                                         _block_leaves(cfg, dev, 200 + r))):
            gf = gr.float() + 1e-3 * er.float()
            total[i] += gf
            top[i] = torch.maximum(top[i], gf.abs().max())
    worst_mean, worst_err = 0.0, 0.0
    for i, (m, e) in enumerate(zip(mean, new_e)):
        scale = torch.clamp_min(top[i], 1e-12) / 127.0
        gf = grads[i].float() + errs[i]
        q = torch.clamp(torch.round(gf / scale), -127, 127)
        worst_err = max(worst_err, float((e - (gf - q * scale)).abs().max()))
        worst_mean = max(worst_mean, float(
            (m.float() - total[i] / world).abs().max() / top[i]))
    out = {"ranks": world, "elements": sum(t.numel() for t in grads),
           "seconds": seconds, "equal_on_every_rank": equal,
           "mean_err_over_max_g": worst_mean, "error_stream_max_diff":
           worst_err}
    assert equal and worst_mean <= 1 / 64 and worst_err == 0.0, out
    return out


def _par_seq_dp(dev, cfg, rank: int, world: int, prefill_len: int,
                compare_len: int) -> dict:
    """seq_dp_prefill: ``make_prefill_step(cfg, mesh=)`` under seq_dp on a
    (1, world) mesh, each rank holding prefill_len/world positions and
    gathering K/V once a layer.  Its attention keeps the JAX package's
    sharded arithmetic, which rounds the scores to bf16 (the einsum of
    bf16 inputs), where the plain route and the kernel keep them in
    float32.  In bf16 it is held, by compare_routes' rule with
    SEQ_WITNESS_RATIO of the keys-reversed witness, to the same function
    in one process (seq_dp on a 1-rank mesh, rank 0) and to the plain
    route at compare_len, and to both of those routes' one-process runs
    on the last SEQ_TAIL positions of each shard at prefill_len (the
    kernel route standing in for the plain one, whose scores do not fit
    at that length); in float32 at SEQ_F32_DEPTH layers against the plain
    route within SEQ_F32_TOL."""
    import dataclasses
    from unittest import mock

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import attention, lm
    from repro_torch.models.common import tree_map
    from repro_torch.parallel import collectives
    from repro_torch.train.steps import make_prefill_step
    mesh = make_mesh((1, world), ("data", "model"), dev.type)
    one = make_mesh((1, 1), ("data", "model"), dev.type)     # rank 0 alone
    seq_cfg = dataclasses.replace(cfg, shard_strategy="seq_dp")
    step = make_prefill_step(seq_cfg, mesh=mesh)
    step_one = make_prefill_step(seq_cfg, mesh=one)
    plain = make_prefill_step(cfg, attn_impl="plain")
    g = torch.Generator(device=dev).manual_seed(0)
    params = lm.init_model(cfg, g, device=dev)    # the same on every rank
    tokens = torch.randint(0, cfg.vocab_size, (1, prefill_len), device=dev,
                           generator=g)
    short = {"tokens": tokens[:, :compare_len]}
    v = cfg.vocab_size
    out = {"ranks": world, "tokens": prefill_len, "compare_tokens":
           compare_len}

    def agree(a, b):
        return dict(zip(("max_abs", "mean_abs", "top1"),
                        logits_agreement(a, b, v)))

    def gathered(batch, p):
        return collectives.all_gather_cat(step(p, batch).to_local(), mesh,
                                          ("model",), 1)

    got = gathered(short, params)
    if rank == 0:
        out["bf16_vs_one_process"] = agree(got, step_one(params,
                                                         short).to_local())
        want = plain(params, short)
        out["bf16_vs_plain"] = agree(got, want)
        with mock.patch.object(attention, "flash_attention_ref",
                               plain_attention_keys_reversed):
            out["witness"] = agree(plain(params, short), want)
        del want
    del got
    _free(dev)
    dist.barrier()

    # full length, timed; each rank keeps its shard's last SEQ_TAIL rows
    _reset_peak(dev)
    norms = _norm_launches()
    dist.barrier()
    t0 = time.perf_counter()
    logits = step(params, {"tokens": tokens}).to_local()
    _sync(dev)
    seconds = time.perf_counter() - t0
    norms = _norm_launches() - norms
    peak = _peak(dev)
    finite = bool(torch.isfinite(logits).all())
    times = torch.tensor([seconds, peak, float(finite), norms], device=dev)
    every = collectives.all_gather_cat(times[None], mesh, ("model",),
                                       0).cpu()
    tails = collectives.all_gather_cat(logits[:, -SEQ_TAIL:], mesh,
                                       ("model",), 1)
    del logits
    _free(dev)
    if rank == 0:
        shard = prefill_len // world

        def rows(full):
            return torch.cat([full[:, (r + 1) * shard - SEQ_TAIL:
                                   (r + 1) * shard] for r in range(world)],
                             dim=1)

        full = step_one(params, {"tokens": tokens}).to_local()
        out["tails_vs_one_process"] = agree(tails, rows(full))
        del full
        full = make_prefill_step(cfg)(params, {"tokens": tokens})
        out["tails_vs_kernel"] = agree(tails, rows(full))
        del full
    del tails
    _free(dev)
    out.update(seconds=float(every[:, 0].max()),
               seconds_by_rank=every[:, 0].tolist(),
               peak_gib_by_rank=every[:, 1].tolist(),
               finite=bool(every[:, 2].all()),
               norms_by_rank=[int(n) for n in every[:, 3]])
    out["tokens_s"] = prefill_len / out["seconds"]
    dist.barrier()

    # float32 at a depth cut that fits world copies on the card
    cut = dict(params, blocks=tree_map(lambda a: a[:SEQ_F32_DEPTH],
                                       params["blocks"]))
    p32 = tree_map(lambda a: a.float(), cut)
    del params, cut
    _free(dev)
    got = gathered(short, p32)
    if rank == 0:
        out["f32_vs_plain"] = agree(got, plain(p32, short))
        out["f32_depth"] = SEQ_F32_DEPTH
    del got, p32
    _free(dev)
    dist.barrier()
    return out


def _par_pipeline(dev, cfg, rank: int) -> dict:
    """pipeline: ``pipeline_fwd`` of cfg's stacked blocks (the port's block
    stack, plain attention) over a 2-rank ``pod`` mesh, PIPE_BATCH x
    PIPE_SEQ in PIPE_MICRO microbatches, against the one-process
    sequential blocks on the same h: bitwise against them microbatch by
    microbatch and within PIPE_BF16_REL of them on the whole batch in
    bf16, and within PIPE_F32_TOL in float32 at PIPE_F32_DEPTH layers."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.common import tree_map
    from repro_torch.parallel.pipeline import pipeline_fwd
    mesh = make_mesh((2,), ("pod",), dev.type)    # ranks 0 and 1
    out = {"stages": 2, "batch": PIPE_BATCH, "seq": PIPE_SEQ,
           "microbatches": PIPE_MICRO, "layers": cfg.n_repeats}
    if mesh.get_coordinate() is None:
        dist.barrier()
        return out
    group = mesh.get_group("pod")
    g = torch.Generator(device=dev).manual_seed(1)
    params = lm.init_model(cfg, g, device=dev)
    h = torch.randn((PIPE_BATCH, PIPE_SEQ, cfg.d_model), generator=g,
                    device=dev, dtype=torch.bfloat16)
    angles = lm._angles_for(cfg, 1, PIPE_SEQ, dev)

    @torch.no_grad()
    def block_apply(stage_params, hm):
        return lm._run_blocks({"blocks": stage_params}, hm, cfg, angles,
                              causal=True, attn_impl="plain")[0]

    def run(blocks_, h_):
        dist.barrier(group=group)
        t0 = time.perf_counter()
        y = pipeline_fwd(block_apply, blocks_, h_, mesh, PIPE_MICRO,
                         axis="pod")
        _sync(dev)
        return y, time.perf_counter() - t0

    y, seconds = run(params["blocks"], h)
    if rank == 0:
        per_micro = torch.cat([block_apply(params["blocks"], hm)
                               for hm in h.chunk(PIPE_MICRO)])
        whole = block_apply(params["blocks"], h)
        out["bitwise_per_microbatch"] = bool(torch.equal(y, per_micro))
        out["whole_batch_max_rel"] = float(
            (y.float() - whole.float()).abs().max()
            / whole.float().abs().max())
        out["finite"] = bool(torch.isfinite(y).all())
        del per_micro, whole
    out["seconds"] = seconds
    del y
    blocks32 = tree_map(lambda a: a[:PIPE_F32_DEPTH].float(),
                        params["blocks"])
    del params
    _free(dev)
    y32, seconds32 = run(blocks32, h.float())
    if rank == 0:
        want = block_apply(blocks32, h.float())
        out["f32_max_abs"] = float((y32 - want).abs().max())
        out["f32_ref_max_abs"] = float(want.abs().max())
        out["f32_depth"] = PIPE_F32_DEPTH
        out["f32_seconds"] = seconds32
        del want
    del y32, blocks32
    _free(dev)
    dist.barrier()
    return out


def _par_elastic_restore(dev, cfg, rank: int, ckpt_dir: str) -> dict:
    """elastic_restore: ``make_elastic_mesh()`` over the ranks, a checkpoint
    of cfg's embedding and one block at full width written once (rank 0),
    restored with ``shardings=`` from ``param_shardings`` (the megatron
    rules: vocab, heads and mlp over model); every rank's local slice
    bitwise its slice of the written leaf."""
    import torch.distributed as dist

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.models import blocks, lm
    from repro_torch.models.common import (abstract_params, init_params,
                                           stack_specs,
                                           tree_leaves_with_names)
    from repro_torch.parallel import sharding as shd
    from repro_torch.runtime.elastic import make_elastic_mesh
    mesh = make_elastic_mesh(device_type=dev.type)
    specs = {"embed": lm.model_specs(cfg)["embed"],
             "blocks": tuple(stack_specs(t, 1)
                             for t in blocks.block_specs(cfg))}
    tree = init_params(specs, torch.Generator(device=dev).manual_seed(3),
                       device=dev)
    ck = Checkpointer(ckpt_dir)
    t0 = time.perf_counter()
    if rank == 0:
        ck.save(1, tree)
    save_s = time.perf_counter() - t0
    dist.barrier()
    t0 = time.perf_counter()
    shardings = shd.param_shardings(specs, cfg, mesh)
    restored, _ = ck.restore(1, abstract_params(specs), shardings=shardings)
    _sync(dev)
    restore_s = time.perf_counter() - t0
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}
    pspecs = dict(tree_leaves_with_names(shd.param_pspecs(specs, cfg,
                                                          mesh)))
    local_of = dict(tree_leaves_with_names(restored))
    bitwise, split = True, 0
    for name, full in tree_leaves_with_names(tree):
        want = full
        for d, entry in enumerate(pspecs[name]):
            for a in (() if entry is None else
                      entry if isinstance(entry, tuple) else (entry,)):
                step = want.shape[d] // sizes[a]
                want = want.narrow(d, coord[a] * step, step)
                split += 1
        local = local_of[name].to_local()
        bitwise &= local.device == full.device and bool(
            torch.equal(local, want))
    out = {"mesh": [mesh.size(0), mesh.size(1)],
           "dims": list(mesh.mesh_dim_names),
           "elements": sum(t.numel() for _, t in
                           tree_leaves_with_names(tree)),
           "leaves_split": split, "save_s": save_s, "restore_s": restore_s,
           "bitwise": bitwise}
    assert out["mesh"] == [1, PAR_RANKS] and out["dims"] == ["data", "model"]
    assert bitwise and split > 0, out
    dist.barrier()
    return out


def parallel_worker(rank: int, world: int, store: str, out_dir: str,
                    opts: dict) -> None:
    """One rank of the multi-rank phases (a spawned process)."""
    import dataclasses
    import datetime

    import torch.distributed as dist

    from repro_torch.configs import get_config
    dev = torch.device(opts["device"], 0) if opts["device"] == "cuda" \
        else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method="file://" + store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=PAR_GROUP_TIMEOUT_S))
    cfg = get_config(opts["arch"])
    if opts.get("smoke"):
        cfg = dataclasses.replace(cfg.smoke(), dtype="bfloat16",
                                  param_dtype="bfloat16")
    out = {}
    for name, fn in (
            ("compressed_psum", lambda: _par_compressed_psum(
                dev, cfg, rank, world)),
            ("seq_dp_prefill", lambda: _par_seq_dp(
                dev, cfg, rank, world, opts["prefill_len"],
                opts["compare_len"])),
            ("pipeline", lambda: _par_pipeline(dev, cfg, rank)),
            ("elastic_restore", lambda: _par_elastic_restore(
                dev, cfg, rank, os.path.join(out_dir, "ckpt")))):
        t0 = time.perf_counter()
        out[name] = fn()
        _free(dev)
        if rank == 0:
            log(f"  rank 0: {name} done in {time.perf_counter() - t0:.2f} s")
    pathlib.Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def nccl_worker(out_dir: str, arch: str) -> None:
    """make_compressed_psum on a 1-rank NCCL group (a spawned process): the
    NCCL path builds and runs; with one rank the mean is the local round
    trip, bitwise."""
    import datetime

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.compression import (compress_decompress,
                                               make_compressed_psum)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    cfg = get_config(arch)
    f = make_compressed_psum(make_mesh((1,), ("data",)), ("data",))
    grads = _block_leaves(cfg, dev, 100)
    errs = [1e-3 * t.float() for t in _block_leaves(cfg, dev, 200)]
    mean, new_e = f(grads, errs)
    ms = time_ms(lambda: f(grads, errs), 3)
    bitwise = True
    for gi, ei, m, e in zip(grads, errs, mean, new_e):
        deq, err = compress_decompress(gi, ei)
        bitwise &= bool(torch.equal(m, deq) and torch.equal(e, err))
    out = {"backend": dist.get_backend(), "ranks": 1, "ms": ms,
           "bitwise_vs_round_trip": bitwise}
    pathlib.Path(out_dir, "nccl.json").write_text(json.dumps(out))
    dist.destroy_process_group()


def _spawn(target, args_list, deadline_s: float) -> list:
    """Starts one spawned process per args tuple and joins them by the
    deadline; kills every one left then.  Returns the exit codes."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=a) for a in args_list]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    for p in procs:
        p.join(max(0.1, end - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    return [p.exitcode for p in procs]


def run_parallel(opts: dict) -> dict:
    """The multi-rank phases: PAR_RANKS gloo ranks (compressed_psum,
    seq_dp_prefill, pipeline on 2 of them, elastic_restore), then the
    1-rank NCCL check.  Their numbers are gloo on one card."""
    import shutil
    import tempfile

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_par_")
    try:
        store = os.path.join(out_dir, "store")
        t0 = time.perf_counter()
        codes = _spawn(parallel_worker,
                       [(r, PAR_RANKS, store, out_dir, opts)
                        for r in range(PAR_RANKS)], PAR_DEADLINE_S)
        seconds = time.perf_counter() - t0
        assert codes == [0] * PAR_RANKS, f"ranks exited with {codes}"
        ranks = [json.loads(pathlib.Path(out_dir, f"rank{r}.json")
                            .read_text()) for r in range(PAR_RANKS)]
        out = {"ranks": PAR_RANKS, "backend": "gloo, one card",
               "seconds": seconds}
        for name in ("compressed_psum", "seq_dp_prefill", "pipeline",
                     "elastic_restore"):
            out[name] = ranks[0][name]
        out["elastic_restore"]["bitwise_every_rank"] = all(
            r["elastic_restore"]["bitwise"] for r in ranks)
        if opts["device"] == "cuda":
            codes = _spawn(nccl_worker, [(out_dir, opts["arch"])], 300)
            assert codes == [0], f"the NCCL check exited with {codes}"
            out["compressed_psum"]["nccl_1_rank"] = json.loads(
                pathlib.Path(out_dir, "nccl.json").read_text())
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    cp, sq, pp, er = (out[k] for k in ("compressed_psum", "seq_dp_prefill",
                                       "pipeline", "elastic_restore"))
    log(f"phase compressed_psum (gloo, {PAR_RANKS} ranks on one card): "
        f"{cp['elements']} elements a rank (one block, bf16), "
        f"{cp['seconds']:.3f} s a call; means equal on every rank "
        f"{cp['equal_on_every_rank']}, max |mean - true| / max|g| "
        f"{cp['mean_err_over_max_g']:.4g} (<= 1/64), error stream max diff "
        f"{cp['error_stream_max_diff']}; 1-rank NCCL: "
        f"{cp.get('nccl_1_rank')}")
    log(f"phase seq_dp_prefill (gloo, {PAR_RANKS} ranks on one card): "
        f"{sq['tokens']} tokens in {sq['seconds']:.3f} s "
        f"({sq['tokens_s']:.1f} tok/s; by rank {sq['seconds_by_rank']}), "
        f"peak GiB by rank {sq['peak_gib_by_rank']}, finite {sq['finite']}; "
        f"at {sq['compare_tokens']} tokens, bf16 against seq_dp in one "
        f"process {sq['bf16_vs_one_process']}, against the plain route "
        f"{sq['bf16_vs_plain']}, witness (plain keys reversed vs plain) "
        f"{sq['witness']}; float32 at {sq['f32_depth']} layers against the "
        f"plain route {sq['f32_vs_plain']}; last {SEQ_TAIL} positions of "
        f"each shard at {sq['tokens']} tokens against seq_dp in one process "
        f"{sq['tails_vs_one_process']}, against the kernel route "
        f"{sq['tails_vs_kernel']}")
    log(f"phase pipeline (gloo, 2 ranks on one card): {pp}")
    log(f"phase elastic_restore (gloo, {PAR_RANKS} ranks on one card): {er}")
    wit = sq["witness"]
    for cmp in (sq["bf16_vs_one_process"], sq["tails_vs_one_process"],
                sq["bf16_vs_plain"], sq["tails_vs_kernel"]):
        assert cmp["mean_abs"] <= SEQ_WITNESS_RATIO * wit["mean_abs"], \
            (cmp, wit)
        assert cmp["top1"] >= wit["top1"] - WITNESS_TOP1_SLACK, (cmp, wit)
        assert cmp["mean_abs"] <= BF16_LOGITS_MEAN, cmp
    assert sq["f32_vs_plain"]["max_abs"] <= SEQ_F32_TOL, sq["f32_vs_plain"]
    assert sq["finite"], sq
    assert all(n > 0 if opts["device"] == "cuda" else n == 0
               for n in sq["norms_by_rank"]), sq["norms_by_rank"]
    assert pp["bitwise_per_microbatch"] and pp["finite"], pp
    assert pp["whole_batch_max_rel"] <= PIPE_BF16_REL, pp
    assert pp["f32_max_abs"] <= PIPE_F32_TOL, pp
    assert er["bitwise_every_rank"], er
    if opts["device"] == "cuda":
        nc = cp["nccl_1_rank"]
        assert nc["backend"] == "nccl" and nc["bitwise_vs_round_trip"], nc
    return out


# ---------------------------------------------------------------------------
# Compute on sharded weights (parallel/tensor_parallel.py): megatron_prefill,
# serve_fsdp_prefill, ep_prefill and megatron_train in TP_RANKS spawned
# processes sharing the one card over gloo, each rank holding only its
# slices of the weights (and moments), drawn slice by slice as init_model
# draws the whole leaves (init_local).  The one-process references run on
# rank 0 before any rank holds its shards.  Each rank's logits are its
# columns of the vocabulary; the checks gather them over gloo, as
# DTensor.full_tensor() is not used on CUDA tensors over gloo (above).  Before them, gloo_probe: whether gloo
# takes CUDA tensors for reduce_scatter, in a pair of processes of its own.
# ---------------------------------------------------------------------------

TP_RANKS = 4
TP_SERVE_MESH = (2, 2)         # serve_fsdp_prefill: 2 replicas of TP 2
TP_SERVE_ROWS, TP_SERVE_LEN = 2, 4096   # a prompt a data rank
TP_SHARE_SLACK = 0.01          # a rank's weight bytes: 1/4 of the whole +-
TP_F32_DEPTH, TP_F32_TOL = 8, 1e-4
TP_TRAIN_BATCH = 2             # over data 2 of the (2, 2) mesh
TP_TRAIN_LEN = 2048            # four ranks' steps share the card
TP_GRAD_COS = 0.99             # every leaf's gradient against one process
# its relative L2 error, and |norm ratio - 1| of a leaf and of the whole
# gradient: twice and six times the largest read on the H100 (0.0316 and
# 3.3e-4, bf16)
TP_GRAD_REL, TP_NORM_REL = 0.0625, 2e-3


def init_local(cfg, mesh, seed: int, dev, pspecs=None):
    """This rank's slices of ``lm.init_model(cfg, Generator(dev)
    .manual_seed(seed))``: every leaf drawn as ``models.common.init_params``
    draws it (whole, or slice by slice along its leading axis above
    ``SLICE_DRAW_BYTES``), in its order, and cut to the slice
    ``param_pspecs`` gives this rank, so that no rank holds a whole
    model."""
    from repro_torch.models import lm
    from repro_torch.models.common import SLICE_DRAW_BYTES
    from repro_torch.parallel import sharding as shd
    specs = lm.model_specs(cfg)
    pspecs = pspecs or shd.param_pspecs(specs, cfg, mesh)
    g = torch.Generator(device=dev).manual_seed(seed)

    def cut(t, ranges):
        for d, (lo, hi) in enumerate(ranges):
            t = t.narrow(d, lo, hi - lo)
        return t

    def one(spec, pspec):
        ranges = shd.NamedSharding(mesh, pspec).local_ranges(spec.shape)
        shape = tuple(hi - lo for lo, hi in ranges)
        if spec.init in ("zeros", "ones"):
            fill = torch.zeros if spec.init == "zeros" else torch.ones
            return fill(shape, dtype=spec.dtype, device=dev)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        scale = spec.init_scale / np.sqrt(max(fan_in, 1))
        if 4 * int(np.prod(spec.shape)) <= SLICE_DRAW_BYTES:
            full = torch.randn(spec.shape, generator=g, device=dev) * scale
            return cut(full.to(spec.dtype), ranges).contiguous()
        out = torch.empty(shape, dtype=spec.dtype, device=dev)
        lo, hi = ranges[0]
        for i in range(spec.shape[0]):
            part = torch.randn(spec.shape[1:], generator=g, device=dev) \
                * scale
            if lo <= i < hi:
                out[i - lo].copy_(cut(part, ranges[1:]))
        return out

    def build(s, p):
        if isinstance(s, dict):
            vals = {k: build(s[k], p[k]) for k in sorted(s)}
            return {k: vals[k] for k in s}
        if isinstance(s, tuple):
            return tuple(build(a, b) for a, b in zip(s, p))
        return one(s, p)

    return build(specs, pspecs)


def _tp_bytes(tree) -> int:
    from repro_torch.models.common import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _tp_vocab_gather(logits, mesh) -> torch.Tensor:
    """Every rank's vocabulary columns of its logits, gathered (the whole
    row on every rank of the ``model`` group)."""
    from repro_torch.parallel import collectives
    return collectives.all_gather_cat(logits, mesh, ("model",), -1)


def _tp_flash_counts():
    from repro_torch.kernels.flash_attention.ops import flash_attention
    return flash_attention.launches, dict(flash_attention.launches_by_path)


def _norm_launches() -> int:
    """rmsnorm kernel launches in this process so far."""
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    return rmsnorm.launches


def _tp_prefill(dev, cfg, rank: int, world: int, mesh_shape: tuple,
                rows: int, seq: int) -> dict:
    """A prefill through ``make_prefill_step(cfg, mesh=)`` under megatron
    on a ("data", "model") mesh of ``mesh_shape``, a batch of ``rows``
    seeded prompts of ``seq`` tokens (over ``data``), each rank holding its
    serving slices (``lm.serve_pspecs``) of every leaf: a share of the
    heads (KV heads split mid-head where they do not divide), the MLP
    width and the vocabulary over ``model``, and where ``serve_needs_fsdp``
    holds the width over ``data`` too, gathered a block at a time.
    Attention goes through the kernel on the rank's whole GQA groups.
    Held in bf16 to the one-process kernel route by compare_routes' rule
    (WITNESS_RATIO) with the one-process plain route against the kernel
    route as the witness (on the card: on the CPU the kernel route is the
    plain one) and the BF16_LOGITS_MEAN backstop, and in float32 at
    TP_F32_DEPTH layers within TP_F32_TOL.  The run's collectives are
    recorded (``launch.wire``): the all-gathers are fsdp's."""
    import torch.distributed as dist

    from repro_torch.kernels.flash_attention.ops import reset_launches
    from repro_torch.launch import wire
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.common import tree_map
    from repro_torch.parallel import collectives
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.steps import make_prefill_step
    mesh = make_mesh(mesh_shape, ("data", "model"), dev.type)
    cfg = dataclasses.replace(cfg, shard_strategy="megatron")
    step = make_prefill_step(cfg, mesh=mesh)
    g = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (rows, seq), device=dev,
                           generator=g)
    batch = {"tokens": tokens}
    v = cfg.vocab_size
    out = {"model": cfg.name, "ranks": world, "mesh": list(mesh_shape),
           "batch": [rows, seq], "tokens": rows * seq,
           "serve_needs_fsdp": shd.serve_needs_fsdp(cfg, mesh)}
    every_dim = ("data", "model")

    def agree(a, b):
        return dict(zip(("max_abs", "mean_abs", "top1"),
                        logits_agreement(a, b, v)))

    def whole(local):
        """Every rank's logits (its rows, its vocabulary columns) put
        together on rank 0 (None on the others): the vocabulary gathered
        over ``model``, then each other data rank's rows sent to rank 0 by
        its first ``model`` rank (a gather over ``data`` would hold the
        whole batch's logits on every rank: four ranks' float32 copies
        do not fit beside their weights)."""
        rows = _tp_vocab_gather(local, mesh)
        data, model = mesh.get_coordinate()
        if rank == 0:
            return torch.cat([rows] + [
                collectives.recv(torch.empty_like(rows),
                                 int(mesh.mesh[d, 0]), None)
                for d in range(1, mesh_shape[0])])
        if model == 0:
            collectives.send(rows, 0, None)
        return None

    def cut(p):
        return dict(p, blocks=tree_map(lambda a: a[:TP_F32_DEPTH],
                                       p["blocks"]))

    ref = ref32 = None
    if rank == 0:          # one process, before any rank holds its shards
        full = lm.init_model(cfg, torch.Generator(device=dev).manual_seed(1),
                             device=dev)
        out["whole_bytes"] = _tp_bytes(full)
        ref = make_prefill_step(cfg)(full, batch)
        out["witness"] = agree(make_prefill_step(cfg, attn_impl="plain")(
            full, batch), ref)
        p32 = tree_map(lambda a: a.float(), cut(full))
        del full
        _free(dev)
        ref32 = make_prefill_step(cfg)(p32, batch)
        del p32
        _free(dev)
    dist.barrier()

    params = init_local(cfg, mesh, 1, dev, pspecs=lm.serve_pspecs(cfg, mesh))
    local_bytes = _tp_bytes(params)
    _free(dev)
    _reset_peak(dev)
    reset_launches()
    norms = _norm_launches()
    dist.barrier()
    with wire.count_collectives() as coll:
        t0 = time.perf_counter()         # one run, timed and held
        logits = step(params, batch).to_local()
        _sync(dev)
        seconds = time.perf_counter() - t0
    launches, paths = _tp_flash_counts()
    norms = _norm_launches() - norms
    peak = _peak(dev)
    finite = bool(torch.isfinite(logits).all())
    shape = list(logits.shape)
    got = whole(logits)
    if rank == 0:
        out["bf16_vs_one_process"] = agree(got, ref)
        summary = coll.summary()
        out["wire_bytes_rank0"] = summary["wire_bytes_per_device"]
        out["collective_op_counts_rank0"] = summary["op_counts"]
        out["gather_bytes_rank0"] = sum(
            wire.wire_bytes(op, n, size) for op, n, size in coll.records
            if op == "all-gather")
    del logits, got, ref
    _free(dev)
    stats = torch.tensor([seconds, peak, float(finite), local_bytes,
                          launches, paths["tc"], norms], device=dev,
                         dtype=torch.float64)
    every = collectives.all_gather_cat(stats[None], mesh, every_dim,
                                       0).cpu()
    p32 = tree_map(lambda a: a.float(), cut(params))
    del params
    _free(dev)
    got = whole(step(p32, batch).to_local())
    if rank == 0:
        out["f32_vs_one_process"] = agree(got, ref32)
        out["f32_depth"] = TP_F32_DEPTH
    del got, p32, ref32
    _free(dev)
    out.update(seconds=float(every[:, 0].max()),
               seconds_by_rank=every[:, 0].tolist(),
               peak_gib_by_rank=every[:, 1].tolist(),
               finite=bool(every[:, 2].all()),
               bytes_by_rank=[int(b) for b in every[:, 3]],
               launches_by_rank=[int(n) for n in every[:, 4]],
               tc_by_rank=[int(n) for n in every[:, 5]],
               norms_by_rank=[int(n) for n in every[:, 6]],
               local_logits_shape=shape)
    out["tokens_s"] = out["tokens"] / out["seconds"]
    dist.barrier()
    return out


def _tp_ep_prefill(dev, cfg, rank: int, world: int, seq: int) -> dict:
    """ep_prefill: olmoe on a (1, world) mesh under megatron and under
    ep_seq, each rank holding a quarter of the experts (and under megatron
    its slices of everything else).  Routing is replicated, so the drops
    (count_drops) of a run whose routing is the one-process forward's
    (pin_routing of rank 0's record_routing) equal that forward's exactly;
    the unpinned runs' drops and routing flips are reported, and the
    pinned logits held to the one-process kernel route's by the bf16
    backstop BF16_LOGITS_MEAN."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.kernels.flash_attention.ops import reset_launches
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.parallel import collectives
    from repro_torch.train.steps import make_prefill_step
    mesh = make_mesh((1, world), ("data", "model"), dev.type)
    g = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (1, seq), device=dev,
                           generator=g)
    batch = {"tokens": tokens}
    v = cfg.vocab_size
    out = {"model": cfg.name, "ranks": world, "tokens": seq}
    n_layers = cfg.n_repeats * sum(sp.mlp == "moe" for sp in cfg.pattern)

    ref = None
    # float32 on the wire (gloo takes it on CUDA tensors; ids < 2^24)
    routing = [torch.empty((seq, cfg.top_k), dtype=torch.float32,
                           device=dev) for _ in range(n_layers)]
    if rank == 0:
        full = lm.init_model(cfg, torch.Generator(device=dev).manual_seed(1),
                             device=dev)
        out["whole_bytes"] = _tp_bytes(full)
        with record_routing() as rec, count_drops() as drops:
            ref = make_prefill_step(cfg)(full, batch)
        out["one_process_drops"] = [int(d) for d in drops]
        for dst, src in zip(routing, rec):
            dst.copy_(src)
        del full, rec
        _free(dev)
    for r in routing:
        collectives.broadcast(r, 0, mesh.get_group("model"))
    routing = [r.long() for r in routing]
    dist.barrier()

    for strategy in ("megatron", "ep_seq"):
        c = dataclasses.replace(cfg, shard_strategy=strategy)
        step = make_prefill_step(c, mesh=mesh)
        _reset_peak(dev)
        params = init_local(c, mesh, 1, dev)
        local_bytes = _tp_bytes(params)
        reset_launches()
        norms = _norm_launches()
        dist.barrier()
        t0 = time.perf_counter()
        with record_routing() as rec, count_drops() as drops:
            logits = step(params, batch).to_local()
        _sync(dev)
        seconds = time.perf_counter() - t0
        launches, paths = _tp_flash_counts()
        norms = _norm_launches() - norms
        peak = _peak(dev)
        res = {"drops": [int(d) for d in drops],
               "flipped_tokens": int((~routing_agrees(
                   rec, routing, tokens.shape)).sum())}
        del rec
        finite = bool(torch.isfinite(logits).all())
        del logits
        with pin_routing(routing), count_drops() as drops:
            logits = step(params, batch).to_local()
        res["pinned_drops"] = [int(d) for d in drops]
        full_logits = (_tp_vocab_gather(logits, mesh) if strategy ==
                       "megatron" else collectives.all_gather_cat(
                           logits, mesh, ("model",), 1))
        del logits
        if rank == 0:
            res["pinned_vs_one_process"] = dict(zip(
                ("max_abs", "mean_abs", "top1"),
                logits_agreement(full_logits, ref, v)))
        del full_logits, params
        _free(dev)
        stats = torch.tensor([seconds, peak, float(finite), local_bytes,
                              launches, paths["tc"], norms], device=dev,
                             dtype=torch.float64)
        every = collectives.all_gather_cat(stats[None], mesh, ("model",),
                                           0).cpu()
        res.update(seconds=float(every[:, 0].max()),
                   seconds_by_rank=every[:, 0].tolist(),
                   peak_gib_by_rank=every[:, 1].tolist(),
                   finite=bool(every[:, 2].all()),
                   bytes_by_rank=[int(b) for b in every[:, 3]],
                   launches_by_rank=[int(n) for n in every[:, 4]],
                   tc_by_rank=[int(n) for n in every[:, 5]],
                   norms_by_rank=[int(n) for n in every[:, 6]])
        res["tokens_s"] = seq / res["seconds"]
        out[strategy] = res
        dist.barrier()
    del ref
    return out


def _tp_megatron_train(dev, cfg, rank: int, world: int, seq: int) -> dict:
    """megatron_train: one ``make_train_step(cfg, opt, mesh=)`` step under
    megatron with fsdp and bf16 moments (jamba-1.5-large's rule) on a (2,
    2) mesh: each rank holds a quarter of every split leaf and of the
    moments, gathers each layer's fsdp leaves over data and its batch row.
    Held against the one-process step's loss and gradients at the same
    batch, computed on rank 0 before any rank holds its shards: the loss
    within one bf16 ulp; each leaf's gradient (each rank's slices against
    the one-process gradient's, on rank 0) by its cosine (at least
    TP_GRAD_COS), its relative L2 error (at most TP_GRAD_REL) and the
    ratio of its norm to the one-process one (within TP_NORM_REL of 1), so
    that a gradient off by a scale fails; the step's global gradient norm
    within TP_NORM_REL of the one-process gradients' norm.  The step runs
    the plain attention route: its flash_attention launches are counted
    and must be 0."""
    import dataclasses
    from unittest import mock

    import torch.distributed as dist

    from repro_torch.kernels.flash_attention.ops import reset_launches
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves, tree_leaves_with_names
    from repro_torch.optim.adamw import OptimizerConfig, init_opt_state
    from repro_torch.parallel import collectives
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import steps
    cfg = dataclasses.replace(cfg, shard_strategy="megatron", fsdp=True,
                              opt_state_dtype="bfloat16")
    mesh = make_mesh((2, world // 2), ("data", "model"), dev.type)
    g = torch.Generator(device=dev).manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (TP_TRAIN_BATCH, seq + 1),
                         device=dev, generator=g)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    opt = OptimizerConfig(peak_lr=3e-3, warmup_steps=1, total_steps=10,
                          state_dtype=cfg.opt_state_dtype)
    out = {"model": cfg.name, "ranks": world, "mesh": [2, world // 2],
           "batch": [TP_TRAIN_BATCH, seq], "fsdp": True,
           "moments": cfg.opt_state_dtype}
    pspecs = shd.param_pspecs(lm.model_specs(cfg), cfg, mesh)
    names = [n for n, _ in tree_leaves_with_names(pspecs)]

    ref_grads = None
    if rank == 0:
        full = lm.init_model(cfg, torch.Generator(device=dev).manual_seed(1),
                             device=dev)
        out["whole_bytes"] = _tp_bytes(full)
        leaves = tree_leaves(full)
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss, _ = lm.lm_loss(full, batch, cfg)
            ref_grads = [x.cpu() for x in torch.autograd.grad(loss, leaves)]
        out["one_process_loss"] = float(loss.detach())
        out["one_process_grad_norm"] = math.sqrt(sum(
            float(torch.sum(torch.square(x.double()))) for x in ref_grads))
        del full, leaves, loss
        _free(dev)
    dist.barrier()

    params = init_local(cfg, mesh, 1, dev, pspecs)
    state = init_opt_state(params, opt)
    local = {"params": _tp_bytes(params),
             "moments": _tp_bytes((state["mu"], state["nu"]))}
    seen = {}
    update = steps.adamw_update

    def spy(p, grads, st, o, m=None, split=None, zero=None):
        seen["grads"] = grads
        return update(p, grads, st, o, m, split, zero)

    train = steps.make_train_step(cfg, opt, mesh=mesh)
    _reset_peak(dev)
    reset_launches()
    norms = _norm_launches()
    dist.barrier()
    t0 = time.perf_counter()
    with mock.patch.object(steps, "adamw_update", spy):
        params, state, metrics = train(params, state, batch)
    _sync(dev)
    seconds = time.perf_counter() - t0
    launches, _ = _tp_flash_counts()
    norms = _norm_launches() - norms
    peak = _peak(dev)
    loss = float(metrics["loss"])
    grads = seen.pop("grads")
    stats = torch.tensor([seconds, peak, loss, local["params"],
                          local["moments"], launches, norms], device=dev,
                         dtype=torch.float64)
    whole = collectives.all_gather_cat(stats[None], mesh, ("model",), 0)
    every = collectives.all_gather_cat(whole, mesh, ("data",), 0).cpu()
    del params, state
    _free(dev)

    # each rank's gradient slices to rank 0, leaf by leaf
    world_group = dist.group.WORLD
    cos, rel, ratio = {}, {}, {}
    for i, n in enumerate(names):
        if rank == 0:
            dot = na = nb = nd = 0.0
            for r in range(world):
                if r == 0:
                    mine = grads[i]
                else:
                    mine = torch.empty(
                        tuple(hi - lo for lo, hi in _tp_ranges(
                            mesh, pspecs, i, r, ref_grads[i].shape)),
                        dtype=grads[i].dtype, device=dev)
                    collectives.recv(mine, r, world_group)
                want = ref_grads[i]
                for d, (lo, hi) in enumerate(_tp_ranges(
                        mesh, pspecs, i, r, want.shape)):
                    want = want.narrow(d, lo, hi - lo)
                a = mine.double().reshape(-1)
                b = want.to(dev).double().reshape(-1)
                dot += float(a @ b)
                na += float(a @ a)
                nb += float(b @ b)
                nd += float(torch.sum(torch.square(a - b)))
            cos[n] = dot / max(math.sqrt(na * nb), 1e-300)
            rel[n] = math.sqrt(nd / max(nb, 1e-300))
            ratio[n] = math.sqrt(na / max(nb, 1e-300))
        else:
            collectives.send(grads[i], 0, world_group)
    del grads, ref_grads
    _free(dev)
    out.update(seconds=float(every[:, 0].max()),
               seconds_by_rank=every[:, 0].tolist(),
               peak_gib_by_rank=every[:, 1].tolist(),
               loss_by_rank=every[:, 2].tolist(),
               param_bytes_by_rank=[int(b) for b in every[:, 3]],
               moment_bytes_by_rank=[int(b) for b in every[:, 4]],
               launches_by_rank=[int(n) for n in every[:, 5]],
               norms_by_rank=[int(n) for n in every[:, 6]],
               grad_cos=cos, grad_rel_err=rel, grad_norm_ratio=ratio,
               loss=loss, grad_norm=float(metrics["grad_norm"]))
    out["tokens_s"] = TP_TRAIN_BATCH * seq / out["seconds"]
    dist.barrier()
    return out


def _tp_ranges(mesh, pspecs, i: int, rank: int, shape) -> tuple:
    """The [start, stop) along each dim of leaf ``i``'s slice on rank
    ``rank`` of ``mesh`` (row-major), by its PartitionSpec in ``pspecs``."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.parallel import sharding as shd
    sizes = [mesh.size(k) for k in range(len(mesh.mesh_dim_names))]
    coord = [int(c) for c in np.unravel_index(rank, sizes)]
    return shd.NamedSharding(mesh, tree_leaves(pspecs)[i]).local_ranges(
        shape, coord)


def tp_worker(rank: int, world: int, store: str, out_dir: str,
              opts: dict) -> None:
    """One rank of the compute-on-sharded-weights phases (a spawned
    process)."""
    import dataclasses
    import datetime

    import torch.distributed as dist

    from repro_torch.configs import get_config
    # four ranks share the card: segments that grow, not a cache per size
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    dev = torch.device(opts["device"], 0) if opts["device"] == "cuda" \
        else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method="file://" + store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=PAR_GROUP_TIMEOUT_S))

    def config(arch):
        cfg = get_config(arch)
        if opts.get("smoke"):
            cfg = dataclasses.replace(cfg.smoke(), dtype="bfloat16",
                                      param_dtype="bfloat16")
        return cfg

    def serve_fsdp_prefill():
        """phi3 on TP_SERVE_MESH: at full width the shipped budget asks
        for fsdp (its bf16 weights over model 2 exceed it); at the smoke
        size the budget is lowered for the run, so that it does too."""
        from repro_torch.parallel import sharding as shd
        shipped = shd.HBM_BYTES_BUDGET
        if opts.get("smoke"):
            shd.HBM_BYTES_BUDGET = 0
        try:
            return _tp_prefill(dev, config("phi3-medium-14b"), rank, world,
                               TP_SERVE_MESH, TP_SERVE_ROWS,
                               opts.get("serve_len", TP_SERVE_LEN))
        finally:
            shd.HBM_BYTES_BUDGET = shipped

    out = {}
    for name, fn in (
            ("megatron_prefill", lambda: _tp_prefill(
                dev, config("phi3-medium-14b"), rank, world, (1, world), 1,
                opts["prefill_len"])),
            ("serve_fsdp_prefill", serve_fsdp_prefill),
            ("ep_prefill", lambda: _tp_ep_prefill(
                dev, config("olmoe-1b-7b"), rank, world,
                opts["prefill_len"])),
            ("megatron_train", lambda: _tp_megatron_train(
                dev, config("h2o-danube-3-4b"), rank, world,
                opts["train_len"]))):
        t0 = time.perf_counter()
        out[name] = fn()
        _free(dev)
        if rank == 0:
            log(f"  rank 0: {name} done in {time.perf_counter() - t0:.2f} s: "
                + json.dumps(out[name]))
    pathlib.Path(out_dir, f"tp{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def probe_worker(rank: int, store: str, out_dir: str) -> None:
    """One of two ranks that run gloo's ``reduce_scatter`` once on bf16
    CUDA tensors (the gradients fsdp scatters) and check its result (a
    spawned process: a collective gloo does not take on CUDA may kill
    it)."""
    import datetime

    import torch.distributed as dist
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    x = torch.arange(4, dtype=torch.bfloat16, device=dev) + 10 * rank
    out = torch.empty(2, dtype=torch.bfloat16, device=dev)
    dist.reduce_scatter(out, list(x.chunk(2)))
    want = (torch.arange(4.0) * 2 + 10).chunk(2)[rank].to(torch.bfloat16)
    pathlib.Path(out_dir, f"probe{rank}.json").write_text(
        json.dumps(bool(torch.equal(out.cpu(), want))))
    dist.destroy_process_group()


def gloo_probe() -> str:
    """Whether a gloo group takes CUDA tensors for ``reduce_scatter``, as
    ``parallel/collectives.py`` assumes, in a pair of processes of its
    own: "ok" (the right result), "wrong", or the exit codes of a pair
    that raised or died."""
    import shutil
    import tempfile
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_probe_")
    try:
        codes = _spawn(probe_worker, [(r, os.path.join(out_dir, "store"),
                                       out_dir) for r in range(2)], 120)
        if codes != [0, 0]:
            return f"exit codes {codes}"
        oks = [json.loads(pathlib.Path(out_dir, f"probe{r}.json")
                          .read_text()) for r in range(2)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return "ok" if all(oks) else "wrong"


def run_tensor_parallel(opts: dict) -> dict:
    """The compute-on-sharded-weights phases: TP_RANKS gloo ranks
    (megatron_prefill, serve_fsdp_prefill, ep_prefill, megatron_train),
    after the gloo probe on the card.  Their times are gloo on one
    card."""
    import shutil
    import tempfile

    out = {"ranks": TP_RANKS, "backend": "gloo, one card"}
    if opts["device"] == "cuda":
        out["gloo_cuda_reduce_scatter"] = gloo_probe()
        log(f"phase gloo_probe (2 ranks, bf16 CUDA tensors): reduce_scatter "
            f"{out['gloo_cuda_reduce_scatter']}")
        assert out["gloo_cuda_reduce_scatter"] == "ok", out
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    try:
        store = os.path.join(out_dir, "store")
        t0 = time.perf_counter()
        codes = _spawn(tp_worker, [(r, TP_RANKS, store, out_dir, opts)
                                   for r in range(TP_RANKS)], PAR_DEADLINE_S)
        out["seconds"] = time.perf_counter() - t0
        assert codes == [0] * TP_RANKS, f"ranks exited with {codes}"
        ranks = [json.loads(pathlib.Path(out_dir, f"tp{r}.json").read_text())
                 for r in range(TP_RANKS)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    mp, sp, ep, mt = (ranks[0][k] for k in (
        "megatron_prefill", "serve_fsdp_prefill", "ep_prefill",
        "megatron_train"))
    out.update(megatron_prefill=mp, serve_fsdp_prefill=sp, ep_prefill=ep,
               megatron_train=mt)
    cuda = opts["device"] == "cuda"
    for name, r in (("megatron_prefill", mp), ("serve_fsdp_prefill", sp)):
        log(f"phase {name} (gloo, {TP_RANKS} ranks on one card, mesh "
            f"{r['mesh']}, serve_needs_fsdp {r['serve_needs_fsdp']}): "
            f"{r['model']}, batch {r['batch']}, {r['tokens']} tokens in "
            f"{r['seconds']:.3f} s ({r['tokens_s']:.1f} tok/s; by rank "
            f"{r['seconds_by_rank']}), weight bytes by rank "
            f"{r['bytes_by_rank']} of {r['whole_bytes']}, peak GiB by rank "
            f"{r['peak_gib_by_rank']}, flash launches by rank "
            f"{r['launches_by_rank']} (tc {r['tc_by_rank']}), finite "
            f"{r['finite']}; rank 0's collectives "
            f"{r['collective_op_counts_rank0']}, wire bytes "
            f"{r['wire_bytes_rank0']:.6g} (all-gathers "
            f"{r['gather_bytes_rank0']:.6g}); bf16 against the one-process "
            f"kernel route {r['bf16_vs_one_process']}, witness (one process,"
            f" plain vs kernel route) {r['witness']}; float32 at "
            f"{r['f32_depth']} layers {r['f32_vs_one_process']}")
    for strategy in ("megatron", "ep_seq"):
        r = ep[strategy]
        log(f"phase ep_prefill {strategy} (gloo, {TP_RANKS} ranks on one "
            f"card): {ep['model']}, {ep['tokens']} tokens in "
            f"{r['seconds']:.3f} s ({r['tokens_s']:.1f} tok/s; by rank "
            f"{r['seconds_by_rank']}), weight bytes by rank "
            f"{r['bytes_by_rank']} of {ep['whole_bytes']}, peak GiB by rank "
            f"{r['peak_gib_by_rank']}, flash launches by rank "
            f"{r['launches_by_rank']} (tc {r['tc_by_rank']}); drops "
            f"{sum(r['drops'])} (one process {sum(ep['one_process_drops'])})"
            f", {r['flipped_tokens']} tokens route differently; with the "
            f"one-process routing pinned drops {sum(r['pinned_drops'])}, "
            f"logits against the one-process kernel route "
            f"{r['pinned_vs_one_process']}")
    log(f"phase megatron_train (gloo, {TP_RANKS} ranks on one card, mesh "
        f"{mt['mesh']}, fsdp, {mt['moments']} moments): {mt['model']}, "
        f"batch {mt['batch']} in "
        f"{mt['seconds']:.3f} s ({mt['tokens_s']:.1f} tok/s; by rank "
        f"{mt['seconds_by_rank']}), loss {mt['loss']:.6f} (one process "
        f"{mt['one_process_loss']:.6f}), grad norm {mt['grad_norm']:.6g} "
        f"(one process {mt['one_process_grad_norm']:.6g}), flash launches "
        f"by rank {mt['launches_by_rank']}, "
        f"param bytes by rank {mt['param_bytes_by_rank']} of "
        f"{mt['whole_bytes']}, moment bytes by rank "
        f"{mt['moment_bytes_by_rank']}, peak GiB by rank "
        f"{mt['peak_gib_by_rank']}; by leaf: gradient cosine "
        f"{mt['grad_cos']}, relative L2 error {mt['grad_rel_err']}, norm "
        f"ratio {mt['grad_norm_ratio']}")

    def quarter(by_rank, whole):
        return all(abs(b / whole - 1 / TP_RANKS) <= TP_SHARE_SLACK
                   for b in by_rank)

    n_attn = 40 if not opts.get("smoke") else None
    for r in (mp, sp):
        wit = r["witness"]
        cmp = r["bf16_vs_one_process"]
        if cuda:
            assert cmp["mean_abs"] <= WITNESS_RATIO * wit["mean_abs"], \
                (cmp, wit)
            assert cmp["top1"] >= wit["top1"] - WITNESS_TOP1_SLACK, \
                (cmp, wit)
        assert cmp["mean_abs"] <= BF16_LOGITS_MEAN, cmp
        assert r["f32_vs_one_process"]["max_abs"] <= TP_F32_TOL, r
        assert r["finite"] and quarter(r["bytes_by_rank"],
                                       r["whole_bytes"]), r
        if cuda:
            assert r["tc_by_rank"] == r["launches_by_rank"] and all(
                n == (n_attn or n) and n > 0
                for n in r["launches_by_rank"]), r
            assert all(n > 0 for n in r["norms_by_rank"]), r
    # fsdp on (2, 2): the width over data, gathered a block at a time (on
    # that mesh no other all-gather: a rank's 5 KV heads are whole)
    assert sp["serve_needs_fsdp"] and sp["gather_bytes_rank0"] > 0, sp
    assert not mp["serve_needs_fsdp"], mp
    for strategy in ("megatron", "ep_seq"):
        r = ep[strategy]
        assert r["pinned_drops"] == ep["one_process_drops"], (strategy, r)
        assert r["finite"], r
        assert r["pinned_vs_one_process"]["mean_abs"] <= BF16_LOGITS_MEAN, r
        if cuda and strategy == "megatron":
            assert r["tc_by_rank"] == r["launches_by_rank"] and all(
                n > 0 for n in r["launches_by_rank"]), r
        if cuda:
            assert all(n > 0 for n in r["norms_by_rank"]), (strategy, r)
    assert quarter(ep["megatron"]["bytes_by_rank"], ep["whole_bytes"]), ep
    loss = mt["one_process_loss"]
    assert abs(mt["loss"] - loss) <= abs(loss) * 2 ** -8, mt
    assert quarter(mt["param_bytes_by_rank"], mt["whole_bytes"]), mt
    assert min(mt["grad_cos"].values()) >= TP_GRAD_COS, mt["grad_cos"]
    assert max(mt["grad_rel_err"].values()) <= TP_GRAD_REL, mt
    # read at full width on the card; the CPU's smoke sizes by the looser
    norm_rel = TP_NORM_REL if cuda else TP_GRAD_REL
    assert all(abs(r - 1) <= norm_rel
               for r in mt["grad_norm_ratio"].values()), mt
    norm = mt["one_process_grad_norm"]
    assert abs(mt["grad_norm"] - norm) <= norm_rel * norm, mt
    assert mt["launches_by_rank"] == [0] * TP_RANKS, mt
    assert mt["norms_by_rank"] == [0] * TP_RANKS, mt      # the plain norm
    return out


SD_RANKS = 4
SD_STEPS = 16                  # decode steps of a seeded token stream
SD_F32_TOL = 1e-4              # float32 logits and caches at SD_F32_DEPTH
SD_F32_DEPTH = 4               # layers of the float32 runs (phi3, danube)
SD_SEAMLESS_F32_DEPTH = 3      # encoder and decoder layers, float32 run
@dataclasses.dataclass(frozen=True)
class SdPhase:
    """One decode-over-sharded-caches phase: its config, mesh, batch, cache
    slots, first decode position, prompt tokens and encoder frames (a
    prompt is prefilled on the mesh; without one the self-attention caches
    are seeded), config overrides and the absolute bf16 bounds; ``smoke``
    runs it at the config's smoke size in bf16 (a CPU dry run, held by the
    witness rule alone)."""
    name: str
    arch: str
    mesh: tuple
    batch: int
    slots: int
    start: int
    prompt: int = 0
    frames: int = 0
    over: tuple = ()
    smoke: bool = False
    #: bf16 logits against one process, beside the witness rule: the
    #: largest mean |d| and the least top-1 agreement, at ~1.5x the
    #: largest mean and below the least top-1 of the earlier card reads
    bf16_mean: float = 0.0
    bf16_top1: float = 1.0

    def config(self, f32: bool = False):
        """The phase's config under ``megatron``; with ``f32``, in float32
        at SD_F32_DEPTH layers (seamless: SD_SEAMLESS_F32_DEPTH a stack)."""
        from repro_torch.configs import get_config
        cfg = get_config(self.arch)
        if self.smoke:
            cfg = dataclasses.replace(cfg.smoke(), dtype="bfloat16",
                                      param_dtype="bfloat16")
        cfg = dataclasses.replace(cfg, shard_strategy="megatron",
                                  **dict(self.over))
        if not f32:
            return cfg
        period = len(cfg.pattern)
        depth = SD_SEAMLESS_F32_DEPTH if cfg.encoder_decoder else SD_F32_DEPTH
        return dataclasses.replace(
            cfg, dtype="float32", param_dtype="float32",
            n_layers=min(cfg.n_layers, max(period, depth // period * period)),
            n_encoder_layers=min(cfg.n_encoder_layers, depth))

    def at_smoke_size(self) -> "SdPhase":
        """The phase at smoke sizes: 64 slots, 16 prompt tokens, 32 frames,
        a ring of 8."""
        slots, prompt = (64 if self.slots > 128 else self.slots), min(
            self.prompt, 16)
        start = prompt if prompt else (
            min(self.start, slots - SD_STEPS) if self.start < self.slots
            else slots)
        return dataclasses.replace(
            self, slots=slots, start=start, prompt=prompt,
            frames=min(self.frames, 32),
            over=tuple((k, min(v, 8)) for k, v in self.over), smoke=True)


SD_PHASES = (
    SdPhase("sharded_decode", "phi3-medium-14b", (1, 4), 4, 8192,
            8192 - SD_STEPS, bf16_mean=0.08, bf16_top1=0.75),
    SdPhase("sharded_decode_xlstm", "xlstm-350m", (1, 4), 4, 128, 64,
            prompt=64, bf16_mean=0.45, bf16_top1=0.3),
    SdPhase("sharded_decode_long", "h2o-danube-3-4b", (2, 2), 1, 32768,
            32768 - SD_STEPS, bf16_mean=0.06, bf16_top1=0.875),
    SdPhase("sharded_decode_long_ring", "h2o-danube-3-4b", (2, 2), 1, 32768,
            32768, over=(("decode_ring", 256),), bf16_mean=0.06,
            bf16_top1=0.875),
    SdPhase("sharded_seamless", "seamless-m4t-large-v2", (1, 4), 4, 4096, 16,
            prompt=16, frames=4096, bf16_mean=0.02, bf16_top1=0.875),
)
#: the seeds of the float32 witnesses (every weight one ulp off), read on
#: two seeds: the float32 bound is twice the smaller where it exceeds
#: SD_F32_TOL
SD_F32_WITNESS_SEEDS = (4, 5)
#: the recurrent states, held relative to the leaf's largest magnitude
SD_RECURRENT = ("conv", "h", "c", "n", "m")


def nudge_ulp(params, seed: int) -> None:
    """Moves every nonzero element of every leaf of ``params`` by one ulp of
    its dtype, up or down at random (seeded), in place: the witness of
    rounding alone for the bf16 decode phases."""
    from repro_torch.models.common import tree_leaves
    g = torch.Generator(device=tree_leaves(params)[0].device).manual_seed(
        seed)
    for t in tree_leaves(params):
        bits = t.view(torch.int16 if t.element_size() == 2 else torch.int32)
        step = torch.randint(0, 2, t.shape, generator=g, device=t.device,
                             dtype=bits.dtype) * 2 - 1
        bits.add_(torch.where(t == 0, 0, step).to(bits.dtype))


def _sd_cut(params, cfg):
    """The first layers of ``params`` that the cut ``cfg`` keeps (stacked
    leaves over its n_repeats; the encoder's over n_encoder_layers), in
    float32."""
    from repro_torch.models.common import tree_map
    out = dict(params, blocks=tree_map(lambda a: a[:cfg.n_repeats],
                                       params["blocks"]))
    if cfg.encoder_decoder:
        enc = params["encoder"]
        out["encoder"] = dict(enc, blocks=tree_map(
            lambda a: a[:cfg.n_encoder_layers], enc["blocks"]))
    return tree_map(lambda a: a.float().contiguous(), out)


def _sd_seed_caches(cfg, ph: SdPhase, dev, mesh=None):
    """The decode caches of phase ``ph`` (``lm.init_cache``, whole, or
    this rank's slices of them with ``mesh``): every attention leaf "k"
    and "v" of a phase without a prompt seeded (normal draws, layer by
    layer in one order, each rank keeping its slice)."""
    from repro_torch.models import lm
    from repro_torch.parallel import sharding as shd
    b = ph.batch
    caches = lm.init_cache(cfg, b, ph.slots, device=dev, mesh=mesh)
    if ph.prompt:
        return caches
    specs = lm.cache_specs(cfg, b, ph.slots)
    shards = (None if mesh is None
              else shd.cache_shardings(specs, cfg, mesh, b))
    g = torch.Generator(device=dev).manual_seed(7)
    for i, (layer, spec) in enumerate(zip(caches, specs)):
        for leaf in ("k", "v"):
            if leaf not in layer:
                continue
            shape, dt = spec[leaf]
            t = layer[leaf] if mesh is None else layer[leaf].to_local()
            ranges = [(0, n) for n in shape] if mesh is None else \
                shards[i][leaf].local_ranges(shape)
            for r in range(shape[0]):
                part = torch.randn(shape[1:], generator=g, device=dev)
                for d, (lo, hi) in enumerate(ranges[1:]):
                    part = part.narrow(d, lo, hi - lo)
                t[r].copy_(part.to(dt))
    return caches


def _sd_inputs(cfg, ph: SdPhase, dev) -> dict:
    """The phase's seeded token stream (B, SD_STEPS), prompt and frames."""
    from repro_torch.models.common import DTYPES
    g = torch.Generator(device=dev).manual_seed(11)
    out = {"stream": torch.randint(0, cfg.vocab_size, (ph.batch, SD_STEPS),
                                   device=dev, generator=g)}
    if ph.prompt:
        out["tokens"] = torch.randint(0, cfg.vocab_size,
                                      (ph.batch, ph.prompt), device=dev,
                                      generator=g)
    if ph.frames:
        out["enc_embeds"] = seamless_frames(cfg, ph.batch, ph.frames, g,
                                            dev).to(DTYPES[cfg.dtype])
    return out


def _sd_written(ph: SdPhase, cfg) -> list:
    """The self-attention slots the phase writes (its prompt's and its
    steps'); with ``decode_ring``, none (the ring takes them)."""
    if cfg.decode_ring:
        return []
    pos = list(range(ph.prompt)) + [ph.start + t for t in range(SD_STEPS)]
    return sorted({p % ph.slots for p in pos})


def _sd_session(cfg, ph: SdPhase, params, dev, mesh=None) -> dict:
    """Phase ``ph``'s decode: its caches (seeded, or a prefill of its
    prompt, seamless's with its frames through the encoder), then SD_STEPS
    steps of its token stream from its first position, through
    ``make_serve_step(cfg, mesh=)``.  Returns the logits of every prompt
    position and step (B, P + SD_STEPS, V) float32 (gathered over the
    vocabulary on a mesh), the caches, ms a step, prefill seconds, peak
    GiB and the flash_attention launches (by path) of the session."""
    import torch.distributed as dist

    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         reset_launches)
    from repro_torch.models import lm
    from repro_torch.train.steps import make_serve_step
    slots, start, prompt = ph.slots, ph.start, ph.prompt
    inp = _sd_inputs(cfg, ph, dev)
    step = make_serve_step(cfg, mesh=mesh)

    def whole(lg):
        if mesh is None:
            return lg.float()
        lg = lg.to_local()
        if lg.shape[-1] != cfg.padded_vocab:
            lg = _tp_vocab_gather(lg, mesh)
        return lg.float()

    _free(dev)
    _reset_peak(dev)
    reset_launches()
    norms = _norm_launches()
    if mesh is not None:
        dist.barrier()
    out = {"prefill_s": 0.0}
    logits = []
    if prompt:
        batch = {k: inp[k] for k in ("tokens", "enc_embeds") if k in inp}
        t0 = time.perf_counter()
        with torch.no_grad():
            lg, caches = lm.prefill(params, batch, cfg, slots, mesh=mesh)
        _sync(dev)
        out["prefill_s"] = time.perf_counter() - t0
        logits.append(whole(lg))
    else:
        caches = _sd_seed_caches(cfg, ph, dev, mesh)
    seeded = None
    if mesh is not None and not prompt:
        seeded = [{k: t.to_local().clone() for k, t in layer.items()
                   if k in ("k", "v")} for layer in caches]
    times = []
    for t in range(SD_STEPS):
        _sync(dev)
        t0 = time.perf_counter()
        lg, caches = step(params, caches, inp["stream"][:, t:t + 1],
                          start + t)
        _sync(dev)
        times.append(1e3 * (time.perf_counter() - t0))
        logits.append(whole(lg))
    out.update(logits=torch.cat(logits, dim=1), caches=caches, seeded=seeded,
               ms=times, peak_gib=_peak(dev),
               launches=flash_attention.launches,
               tc=flash_attention.launches_by_path["tc"],
               norms=_norm_launches() - norms)
    return out


def _sd_leaves(caches, mesh=None) -> dict:
    """{"position/name": tensor} of a cache tree (local tensors)."""
    return {f"{i}/{k}": (t if mesh is None else t.to_local())
            for i, layer in enumerate(caches) for k, t in layer.items()}


def _sd_reference(cfg, ph: SdPhase, dev, params, path: str = None) -> dict:
    """The one-process session on the whole ``params`` (rank 0): its
    logits, and (with ``path``) the caches to hold the ranks to written
    there: the written self-attention slots, every other leaf whole (on
    the host)."""
    run = _sd_session(cfg, ph, params, dev)
    ms = float(np.median(run["ms"][1:]))
    if path is None:
        logits = run["logits"]
        del run
        _free(dev)
        return {"logits": logits, "ms": ms}
    written = _sd_written(ph, cfg)
    ref = {}
    for key, t in _sd_leaves(run["caches"]).items():
        if key.split("/")[1] in ("k", "v") and not ph.prompt:
            t = t[:, :, written]
        ref[key] = t.cpu()
    torch.save(ref, path)
    logits = run["logits"]
    del run, ref
    _free(dev)
    return {"logits": logits, "ms": ms}


def _sd_cache_agreement(ph: SdPhase, cfg, caches, seeded, ref: dict,
                        mesh) -> dict:
    """This rank's cache slices against ``ref`` (``_sd_reference``'s, cut
    to the slices): by leaf group (attention written slots, other
    attention leaves, recurrent states) the max and mean |d| (the
    recurrent states' relative to the leaf's largest magnitude); and
    whether every unwritten seeded slot kept its value bit for bit."""
    from repro_torch.models import lm
    from repro_torch.parallel import sharding as shd
    prompt = ph.prompt
    specs = lm.cache_specs(cfg, ph.batch, ph.slots, ph.frames)
    shards = shd.cache_shardings(specs, cfg, mesh, ph.batch)
    written = _sd_written(ph, cfg)
    groups = {}
    kept = True
    for i, layer in enumerate(caches):
        for leaf, t in layer.items():
            local = t.to_local()
            want = ref[f"{i}/{leaf}"].to(local.device)
            ranges = shards[i][leaf].local_ranges(specs[i][leaf][0])
            if leaf in ("k", "v") and not prompt:
                lo, hi = ranges[2]
                mine = [s for s in written if lo <= s < hi]
                idx = [written.index(s) for s in mine]
                rest = torch.ones(hi - lo, dtype=torch.bool,
                                  device=local.device)
                rest[[s - lo for s in mine]] = False
                kept &= bool(torch.equal(local[:, :, rest],
                                         seeded[i][leaf][:, :, rest]))
                got, want = local[:, :, [s - lo for s in mine]], \
                    want[:, :, idx]
                ranges = ranges[:2] + ((0, got.shape[2]),) + ranges[3:]
                group = "written"
            else:
                got = local
                group = "recurrent" if leaf in SD_RECURRENT else "attention"
            for d, (lo, hi) in enumerate(ranges):
                if want.shape[d] != got.shape[d]:
                    want = want.narrow(d, lo, hi - lo)
            if got.numel() == 0:
                continue
            diff = (got.float() - want.float()).abs()
            scale = (float(want.float().abs().max()) or 1.0) \
                if group == "recurrent" else 1.0
            g = groups.setdefault(group, {"max_abs": 0.0, "sum": 0.0,
                                          "n": 0})
            g["max_abs"] = max(g["max_abs"], float(diff.max()) / scale)
            g["sum"] += float(diff.sum()) / scale
            g["n"] += diff.numel()
    return {"groups": {k: {"max_abs": v["max_abs"],
                           "mean_abs": v["sum"] / v["n"]}
                       for k, v in groups.items()}, "seeded_kept": kept}


def _sd_phase(dev, ph: SdPhase, rank: int, world: int, out_dir: str) -> dict:
    """One decode phase over sharded caches on its mesh of ``world`` gloo
    ranks, each holding only its serving slices (``lm.serve_pspecs``) and
    its slices of every cache: first, on rank 0, the float32 session at
    reduced depth and its witnesses (the same with every weight one ulp
    off, on each of SD_F32_WITNESS_SEEDS), the one-process bf16 session
    and its witness (references freed before the ranks load); then the
    ranks' bf16 session (timed, launches counted) and their float32 one.
    Rank 0 holds the logits and times the parts of the phase; every rank
    holds its cache slices against the one-process caches it wrote to
    disk."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.common import tree_map
    from repro_torch.parallel import collectives
    from repro_torch.parallel import sharding as shd
    name, shape, b, slots, frames = (ph.name, ph.mesh, ph.batch, ph.slots,
                                     ph.frames)
    mesh = make_mesh(shape, ("data", "model"), dev.type)
    cfg, f32 = ph.config(), ph.config(f32=True)
    v = cfg.vocab_size
    refs = {k: os.path.join(out_dir, f"{name}-{k}.pt")
            for k in ("bf16", "witness", "f32")}
    out = {"model": cfg.name, "mesh": list(shape), "batch": b,
           "slots": slots, "first_position": ph.start, "prompt": ph.prompt,
           "frames": frames, "steps": SD_STEPS, "f32_layers": f32.n_layers}
    ref = {}
    seconds = {}
    t0 = time.perf_counter()

    def agree(a, b):
        return dict(zip(("max_abs", "mean_abs", "top1"),
                        logits_agreement(a, b, v)))

    def lap(part):
        nonlocal t0
        _sync(dev)
        seconds[part] = time.perf_counter() - t0
        t0 = time.perf_counter()

    if rank == 0:          # one process, before any rank holds its shards
        full = lm.init_model(cfg, torch.Generator(device=dev).manual_seed(1),
                             device=dev)
        out["whole_bytes"] = _tp_bytes(full)
        p32 = _sd_cut(full, f32)
        ref["f32"] = _sd_reference(f32, ph, dev, p32, refs["f32"])
        out["f32_witness"] = []
        for seed in SD_F32_WITNESS_SEEDS:
            nudged = tree_map(torch.clone, p32)
            nudge_ulp(nudged, seed)
            out["f32_witness"].append(agree(_sd_reference(
                f32, ph, dev, nudged)["logits"], ref["f32"]["logits"]))
            del nudged
        out["f32_max_logit"] = float(ref["f32"]["logits"].abs().max())
        del p32
        _free(dev)
        ref["bf16"] = _sd_reference(cfg, ph, dev, full, refs["bf16"])
        out["one_process_ms"] = ref["bf16"]["ms"]
        # a wrong answer's reading, for scale: the logits one position late
        late = ref["bf16"]["logits"]
        out["one_position_late"] = agree(late[:, 1:], late[:, :-1])
        nudge_ulp(full, 3)
        ref["witness"] = _sd_reference(cfg, ph, dev, full,
                                       refs["witness"])
        del full, late
        _free(dev)
    dist.barrier()
    lap("references")
    params = init_local(cfg, mesh, 1, dev, pspecs=lm.serve_pspecs(cfg, mesh))
    local_bytes = _tp_bytes(params)
    lap("load")
    run = _sd_session(cfg, ph, params, dev, mesh)
    lap("bf16")
    cache_bytes = _tp_bytes(_sd_leaves(run["caches"], mesh))
    cspecs = lm.cache_specs(cfg, b, slots, frames)
    whole_cache = sum(math.prod(s) * dt.itemsize for layer in cspecs
                      for s, dt in layer.values())
    want_cache = sum(
        math.prod(hi - lo for lo, hi in sh[k].local_ranges(spec[k][0]))
        * spec[k][1].itemsize for spec, sh in zip(
            cspecs, shd.cache_shardings(cspecs, cfg, mesh, b))
        for k in spec)
    cmp = {k: _sd_cache_agreement(ph, cfg, run["caches"], run["seeded"],
                                  torch.load(refs[k], map_location="cpu",
                                             mmap=True), mesh)
           for k in ("bf16", "witness")}
    if rank == 0:
        out["witness"] = agree(ref["witness"]["logits"], ref["bf16"]["logits"])
        out["bf16_vs_one_process"] = agree(run["logits"],
                                           ref["bf16"]["logits"])
    finite = bool(torch.isfinite(run["logits"]).all())
    stats = torch.tensor([float(np.median(run["ms"][1:])), run["ms"][0],
                          run["prefill_s"], run["peak_gib"], float(finite),
                          local_bytes, cache_bytes, run["launches"],
                          run["tc"], run["norms"]], device=dev,
                         dtype=torch.float64)
    del run
    _free(dev)
    p32 = _sd_cut(params, f32)
    del params
    _free(dev)
    run32 = _sd_session(f32, ph, p32, dev, mesh)
    cmp["f32"] = _sd_cache_agreement(ph, f32, run32["caches"],
                                     run32["seeded"],
                                     torch.load(refs["f32"],
                                                map_location="cpu",
                                                mmap=True), mesh)
    if rank == 0:
        out["f32_vs_one_process"] = agree(run32["logits"],
                                          ref["f32"]["logits"])
    del run32, p32
    _free(dev)
    lap("f32")
    every = collectives.all_gather_cat(stats[None], mesh, tuple(
        mesh.mesh_dim_names), 0).cpu()
    caches_by_rank = [None] * world
    dist.all_gather_object(caches_by_rank, cmp)
    out.update(ms_by_rank=every[:, 0].tolist(),
               first_ms_by_rank=every[:, 1].tolist(),
               prefill_s_by_rank=every[:, 2].tolist(),
               peak_gib_by_rank=every[:, 3].tolist(),
               finite=bool(every[:, 4].all()),
               bytes_by_rank=[int(x) for x in every[:, 5]],
               cache_bytes_by_rank=[int(x) for x in every[:, 6]],
               whole_cache_bytes=int(whole_cache),
               expected_cache_bytes=int(want_cache),
               launches_by_rank=[int(x) for x in every[:, 7]],
               tc_by_rank=[int(x) for x in every[:, 8]],
               norms_by_rank=[int(x) for x in every[:, 9]],
               caches_by_rank=caches_by_rank, seconds=seconds,
               expected_bytes=int(sum(
                   math.prod(hi - lo for lo, hi in ranges)
                   * s.dtype.itemsize for s, ranges in _sd_ranges(cfg, mesh)))
               )
    out["tokens_s"] = b * 1e3 / max(out["ms_by_rank"])
    dist.barrier()
    return out


def _sd_ranges(cfg, mesh):
    """(ParamSpec, this rank's ranges) of every leaf by ``serve_pspecs``."""
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves
    from repro_torch.parallel import sharding as shd
    return [(s, shd.NamedSharding(mesh, p).local_ranges(s.shape))
            for s, p in zip(tree_leaves(lm.model_specs(cfg)),
                            tree_leaves(lm.serve_pspecs(cfg, mesh)))]


def sd_worker(rank: int, world: int, store: str, out_dir: str,
              opts: dict) -> None:
    """One rank of the decode-over-sharded-caches phases (a spawned
    process)."""
    import datetime

    import torch.distributed as dist
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    dev = torch.device(opts["device"], 0) if opts["device"] == "cuda" \
        else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method="file://" + store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=PAR_GROUP_TIMEOUT_S))
    out = {}
    for ph in sd_phases(opts):
        t0 = time.perf_counter()
        out[ph.name] = _sd_phase(dev, ph, rank, world, out_dir)
        _free(dev)
        if rank == 0:
            log(f"  rank 0: {ph.name} done in {time.perf_counter() - t0:.2f} "
                "s")
    pathlib.Path(out_dir, f"sd{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def sd_phases(opts: dict) -> list:
    """The phases ``opts`` asks for (``"phases"``: names; all by default),
    at smoke sizes with ``"smoke"``."""
    names = opts.get("phases", [ph.name for ph in SD_PHASES])
    return [ph.at_smoke_size() if opts.get("smoke") else ph
            for ph in SD_PHASES if ph.name in names]


def run_sharded_decode(opts: dict) -> dict:
    """The decode-over-sharded-caches phases: SD_RANKS gloo ranks on the
    one card, each phase's mesh over them (sharded_decode,
    sharded_decode_xlstm, sharded_decode_long, sharded_decode_long_ring,
    sharded_seamless).  Their times are gloo on one card."""
    import shutil
    import tempfile

    out = {"ranks": SD_RANKS, "backend": "gloo, one card"}
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_sd_")
    try:
        store = os.path.join(out_dir, "store")
        t0 = time.perf_counter()
        codes = _spawn(sd_worker, [(r, SD_RANKS, store, out_dir, opts)
                                   for r in range(SD_RANKS)], PAR_DEADLINE_S)
        out["seconds"] = time.perf_counter() - t0
        assert codes == [0] * SD_RANKS, f"ranks exited with {codes}"
        ranks = [json.loads(pathlib.Path(out_dir, f"sd{r}.json").read_text())
                 for r in range(SD_RANKS)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    cuda = opts["device"] == "cuda"
    for ph in sd_phases(opts):
        name = ph.name
        r = out[name] = ranks[0][name]
        log(f"phase {name} (gloo, {SD_RANKS} ranks on one card, mesh "
            f"{r['mesh']}): {r['model']}, batch {r['batch']}, {r['slots']} "
            f"slots, prompt {r['prompt']} (frames {r['frames']}), "
            f"{r['steps']} steps from position {r['first_position']}: ms a "
            f"step by rank {r['ms_by_rank']} (median of steps 2..; first "
            f"{r['first_ms_by_rank']}; one process "
            f"{r['one_process_ms']:.2f}), prefill s {r['prefill_s_by_rank']}, "
            f"{r['tokens_s']:.1f} tok/s; weight bytes by rank "
            f"{r['bytes_by_rank']} of {r['whole_bytes']}, cache bytes by "
            f"rank {r['cache_bytes_by_rank']} of {r['whole_cache_bytes']}, "
            f"peak GiB by rank {r['peak_gib_by_rank']}, flash launches by "
            f"rank {r['launches_by_rank']} (tc {r['tc_by_rank']}); logits "
            f"bf16 against one process {r['bf16_vs_one_process']}, witness "
            f"(every weight one ulp off) {r['witness']}, bounds mean "
            f"{ph.bf16_mean} top-1 {ph.bf16_top1}, one position late "
            f"{r['one_position_late']}; float32 at {r['f32_layers']} layers "
            f"{r['f32_vs_one_process']} (witnesses by seed "
            f"{r['f32_witness']}, largest logit {r['f32_max_logit']:.4g}); "
            f"caches by rank {r['caches_by_rank']}; rank 0's seconds "
            f"{r['seconds']}")
    for ph in sd_phases(opts):
        name = ph.name
        r = out[name]
        assert r["finite"], r
        model = r["mesh"][1]
        for i, rb in enumerate(r["bytes_by_rank"]):
            assert rb == ranks[i][name]["expected_bytes"], (name, i, rb)
            assert rb / r["whole_bytes"] <= 1 / model + 0.06, (name, rb)
        for i, cb in enumerate(r["cache_bytes_by_rank"]):
            assert cb == ranks[i][name]["expected_cache_bytes"], (name, i)
            # the rings (head_dim over model alone) add ~0.1% at full size
            assert opts.get("smoke") or abs(
                cb / r["whole_cache_bytes"] - 1 / SD_RANKS) \
                <= TP_SHARE_SLACK, (name, cb, r["whole_cache_bytes"])
        # bf16 by the witness rule and by the phase's absolute bounds (at
        # decode the witness itself reads above the prefill phases'
        # BF16_LOGITS_MEAN; the bounds sit well under the witness's)
        wit, cmp = r["witness"], r["bf16_vs_one_process"]
        assert cmp["mean_abs"] <= WITNESS_RATIO * wit["mean_abs"], (name, cmp,
                                                                   wit)
        assert cmp["top1"] >= wit["top1"] - WITNESS_TOP1_SLACK, (name, cmp,
                                                                wit)
        if not opts.get("smoke"):
            assert cmp["mean_abs"] <= ph.bf16_mean, (name, cmp)
            assert cmp["top1"] >= ph.bf16_top1, (name, cmp)
            # the bound fails a wrong answer: under half of the reading of
            # the one-process logits against themselves one position late
            assert ph.bf16_mean <= 0.5 * r["one_position_late"]["mean_abs"], (
                name, r["one_position_late"])
        # float32 within SD_F32_TOL, or twice the smaller float32 witness
        # where that is larger (xlstm-350m: its logits move by ~1e-4 under
        # a one-ulp change of every weight), the witnesses under 1e-2 of
        # the largest logit so that the bound can still fail a wrong value
        wits = [w["max_abs"] for w in r["f32_witness"]]
        f32_tol = max(SD_F32_TOL, 2 * min(wits))
        assert 2 * max(wits) <= 1e-2 * r["f32_max_logit"], r
        assert r["f32_vs_one_process"]["max_abs"] <= f32_tol, (name, r)
        for caches in r["caches_by_rank"]:
            assert all(c["seeded_kept"] for c in caches.values()), name
            for group, g32 in caches["f32"]["groups"].items():
                assert g32["max_abs"] <= SD_F32_TOL, (name, group, g32)
            for group, g in caches["bf16"]["groups"].items():
                w = caches["witness"]["groups"][group]
                assert g["mean_abs"] <= WITNESS_RATIO * w["mean_abs"], (
                    name, group, g, w)
        # the encoder's layers launch the kernel (tc) on each rank's heads;
        # decode attention is plain, as the reference's (on the CPU the
        # wrapper runs its plain version and counts nothing)
        want = ph.config().n_encoder_layers if cuda else 0
        assert r["launches_by_rank"] == [want] * SD_RANKS, r
        assert r["tc_by_rank"] == r["launches_by_rank"], r
        assert all(n > 0 if cuda else n == 0 for n in r["norms_by_rank"]), (
            name, r["norms_by_rank"])
    return out


# ---------------------------------------------------------------------------
# The dry run (launch/dryrun.py, launch/roofline.py): host-side traces of
# one rank's step on meta tensors over a fake process group, held against
# the phases that run the same cells on the card.  They run in a child
# process of their own (a dry run owns its process's default group, and
# needs no card) from the start of the run, beside the card's phases.
# ---------------------------------------------------------------------------

#: name -> launch.dryrun.run_cell's keywords
DRYRUN_CELLS = {
    "dryrun_phi3": dict(arch="phi3-medium-14b", shape_name="prefill_32k",
                        mesh_kind="host", batch=1, attn_impl="kernel"),
    "dryrun_train": dict(arch="h2o-danube-3-4b", shape_name="train_4k",
                         mesh_kind="host", batch=1),
    "dryrun_production_decode": dict(arch="jamba-1.5-large-398b",
                                     shape_name="decode_32k",
                                     mesh_kind="multi"),
    "dryrun_production_train": dict(arch="jamba-1.5-large-398b",
                                    shape_name="train_4k",
                                    mesh_kind="single"),
    # serve_fsdp_prefill's cell: rank 0 of the (2, 2) mesh, built directly
    # (no mesh kind of run_cell's is (2, 2))
    "dryrun_serve_fsdp_prefill": dict(arch="phi3-medium-14b",
                                      shape_name="prefill_32k",
                                      mesh_shape=TP_SERVE_MESH,
                                      batch=TP_SERVE_ROWS,
                                      seq_len=TP_SERVE_LEN),
}
#: predicted peak over the phase's measured peak (PERF.md §6, written
#: before the first card run): the trace allocates the tensors the card's
#: run allocates, less the caching allocator's rounding and workspaces
DRYRUN_PEAK_BOUNDS = {"dryrun_phi3": (0.9, 1.1), "dryrun_train": (0.85, 1.15)}
DRYRUN_DEADLINE_S = 900


def dryrun_worker(out_path: str) -> None:
    """Runs every cell of DRYRUN_CELLS in turn, writing the results (each
    with its wall seconds) to ``out_path`` after each."""
    from repro_torch.launch import dryrun
    os.nice(19)         # the host's cores go to the card's phases first
    out = {}
    for name, kw in DRYRUN_CELLS.items():
        t0 = time.perf_counter()
        r = (dryrun_mesh_cell(**kw) if "mesh_shape" in kw
             else dryrun.run_cell(**kw))
        r["seconds"] = time.perf_counter() - t0
        out[name] = r
        pathlib.Path(out_path).write_text(json.dumps(out))


def dryrun_mesh_cell(arch: str, shape_name: str, mesh_shape: tuple,
                     batch: int, seq_len: int) -> dict:
    """Rank 0's step of ``arch``'s cell of ``shape_name`` (``launch.specs.
    build_cell``: a prefill on the serving weights) at ``batch`` x
    ``seq_len`` on a ("data", "model") mesh of ``mesh_shape``, traced over
    a fake group as ``dryrun.run_cell`` traces its cells; with the
    weights' bytes of the rank (``weight_bytes``, the params' slices)."""
    from repro_torch.configs import SHAPE_BY_NAME, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import tree_leaves
    from repro_torch.parallel import sharding as shd
    cfg = get_config(arch)
    base = SHAPE_BY_NAME[shape_name]
    shape = ShapeConfig(base.name, seq_len, batch, base.kind)
    with dryrun.fake_world(math.prod(mesh_shape)):
        mesh = make_mesh(mesh_shape, ("data", "model"), device_type="cpu")
        cell = specs.build_cell(cfg, shape, mesh)
        cost = dryrun.trace(cell)
        fsdp = shd.serve_needs_fsdp(cfg, mesh)
    return {"status": "ok", "arch": arch, "shape": shape_name,
            "mesh": list(mesh_shape), "rank": 0, "batch": [batch, seq_len],
            "serve_needs_fsdp": fsdp, "weight_bytes": sum(
                a.local_bytes for a in tree_leaves(cell.specs[0])), **cost}


def check_serve_fsdp_dryrun(r: dict, phase: dict) -> dict:
    """dryrun_serve_fsdp_prefill against serve_fsdp_prefill's rank 0: its
    weight bytes exactly, its traced flash_attention calls the rank's tc
    launches and its traced rmsnorm calls two a layer and the final norm,
    its collectives those rank 0 recorded (the same code records both);
    its peak printed beside the measured one."""
    from repro_torch.configs import get_config
    measured_gib = phase["peak_gib_by_rank"][0]
    log(f"phase dryrun_serve_fsdp_prefill: {r['arch']} x {r['shape']} at "
        f"batch {r['batch']} on {r['mesh']}, rank 0, serve_needs_fsdp "
        f"{r['serve_needs_fsdp']}: traced in {r['trace_s']:.2f} s; weight "
        f"bytes {r['weight_bytes']} predicted, {phase['bytes_by_rank'][0]} "
        f"held by rank 0; flash launches {r['kernel_launches']} (rank 0 "
        f"tc {phase['tc_by_rank'][0]}); collectives "
        f"{r['collective_op_counts']}, wire bytes "
        f"{r['wire_bytes_per_device']:.6g} predicted, "
        f"{phase['collective_op_counts_rank0']} and "
        f"{phase['wire_bytes_rank0']:.6g} recorded; peak "
        f"{r['peak_memory_bytes'] / 2**30:.3f} GiB predicted against "
        f"{measured_gib:.3f} GiB measured (ratio "
        f"{r['peak_memory_bytes'] / 2**30 / measured_gib:.4f})")
    assert r["serve_needs_fsdp"] and phase["serve_needs_fsdp"], (r, phase)
    assert r["weight_bytes"] == phase["bytes_by_rank"][0], \
        (r["weight_bytes"], phase["bytes_by_rank"])
    assert r["kernel_launches"] == {
        "flash_attention": {"tc": phase["tc_by_rank"][0]},
        "rmsnorm": {"kernel": 2 * get_config(r["arch"]).n_layers + 1}}, r
    assert r["collective_op_counts"] == phase["collective_op_counts_rank0"]
    assert r["wire_bytes_per_device"] == phase["wire_bytes_rank0"]
    return {"peak_ratio": r["peak_memory_bytes"] / 2**30 / measured_gib,
            "seconds": r.get("seconds"), **{k: r[k] for k in (
                "trace_s", "weight_bytes", "argument_bytes",
                "peak_memory_bytes", "flops_per_device",
                "wire_bytes_per_device", "collective_op_counts",
                "kernel_launches")}}


def start_dryruns() -> dict:
    """Starts :func:`dryrun_worker` in a child process with no card; it is
    killed at exit if it still runs."""
    import atexit
    import tempfile
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-dryrun-"))
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT / "src")}
    err = open(tmp / "err.txt", "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "import chip_smoke; chip_smoke.dryrun_worker(sys.argv[2])",
         str(ROOT), str(tmp / "out.json")], cwd=ROOT, env=env,
        stdout=err, stderr=subprocess.STDOUT)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return {"proc": proc, "dir": tmp, "t0": time.perf_counter(), "err": err}


def tree_bytes(*trees) -> int:
    """Bytes of every tensor leaf of ``trees``."""
    from repro_torch.models.common import tree_leaves
    return sum(t.numel() * t.element_size() for tree in trees
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def finish_dryruns(handle: dict, phi3: dict, lm_train: dict) -> dict:
    """Waits for the dry runs and holds them against the card's phases:
    dryrun_phi3 (phi3_prefill's arguments, launches and peak, and its wall
    against the roofline's bound), dryrun_train (lm_train's arguments and
    peak), dryrun_production (jamba-1.5-large-398b x train_4k on 16 x 16,
    rank 0 of 256, and x decode_32k on 2 x 16 x 16, rank 0 of 512)."""
    import shutil

    from repro_torch.configs import SHAPE_BY_NAME
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import LINK_BW

    proc = handle["proc"]
    try:
        proc.wait(timeout=max(1.0, DRYRUN_DEADLINE_S - (
            time.perf_counter() - handle["t0"])))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    handle["err"].close()
    tail = (handle["dir"] / "err.txt").read_text()[-3000:]
    out_path = handle["dir"] / "out.json"
    got = json.loads(out_path.read_text()) if out_path.exists() else {}
    shutil.rmtree(handle["dir"], ignore_errors=True)
    cells = ", ".join(f"{k} {v['seconds']:.1f} s" for k, v in got.items())
    log(f"dry runs: exit {proc.returncode} after "
        f"{time.perf_counter() - handle['t0']:.1f} s beside the card's "
        f"phases (cells {cells})")
    assert proc.returncode == 0 and set(got) == set(DRYRUN_CELLS), tail
    for name, r in got.items():
        assert r["status"] == "ok", (name, r)
    card = torch.cuda.get_device_properties(0).total_memory

    def row(name, seconds=None):
        kw = DRYRUN_CELLS[name]
        base = SHAPE_BY_NAME[kw["shape_name"]]
        shape = ShapeConfig(base.name, base.seq_len,
                            kw.get("batch") or base.global_batch, base.kind)
        r = roofline.roofline_row(got[name], None, kw["arch"], shape,
                                  kw["mesh_kind"])
        r["bound_s"] = max(r["compute_s"], r["memory_s"], r["collective_s"])
        if seconds:
            r["measured_s"] = seconds
            r["fraction_of_roofline"] = r["bound_s"] / seconds
        return r

    out = {}
    for name, phase, want_launches in (
            ("dryrun_phi3", phi3, {
                "flash_attention": {"tc": phi3["launches"]},
                "rmsnorm": {"kernel": phi3["rmsnorm_launches"]}}),
            ("dryrun_train", lm_train, {})):
        r = got[name]
        ratio = r["peak_memory_bytes"] / (phase["peak_gib"] * 2 ** 30)
        lo, hi = DRYRUN_PEAK_BOUNDS[name]
        seconds = phase.get("seconds_per_step") or phase["seconds"]
        rr = row(name, seconds)
        log(f"phase {name}: traced in {r['trace_s']:.2f} s; argument bytes "
            f"{r['argument_bytes']} (the phase passes "
            f"{phase['argument_bytes']}), flash launches "
            f"{r['kernel_launches']} (the phase {want_launches}), peak "
            f"{r['peak_memory_bytes'] / 2**30:.3f} GiB predicted against "
            f"{phase['peak_gib']:.3f} GiB measured (ratio {ratio:.4f}, held "
            f"to [{lo}, {hi}]); flops {r['flops_per_device']:.4e} traced, "
            f"{rr['analytic_flops_global']:.4e} analytic; roofline bound "
            f"{rr['bound_s']:.4f} s ({rr['dominant']}) against "
            f"{seconds:.4f} s measured: {100 * rr['fraction_of_roofline']:.1f}"
            f"% of the roofline")
        assert r["argument_bytes"] == phase["argument_bytes"], \
            (name, r["argument_bytes"], phase["argument_bytes"])
        assert r["kernel_launches"] == want_launches, \
            (name, r["kernel_launches"])
        assert lo <= ratio <= hi, (name, ratio)
        out[name] = {"peak_ratio": ratio, "roofline": rr,
                     **{k: r[k] for k in (
                         "trace_s", "seconds", "argument_bytes",
                         "peak_memory_bytes", "temp_bytes",
                         "flops_per_device", "bytes_accessed_per_device",
                         "kernel_launches")}}
    prod = {}
    for name in ("dryrun_production_train", "dryrun_production_decode"):
        r, rr = got[name], row(name)
        log(f"phase {name}: {r['arch']} x {r['shape']} on {r['mesh']}, rank "
            f"{r['rank']} of {r['n_devices']}: traced in {r['trace_s']:.2f} "
            f"s; a device: arguments {r['argument_bytes'] / 1e9:.3f} GB, "
            f"peak {r['peak_memory_bytes'] / 1e9:.3f} GB, temporaries "
            f"{r['temp_bytes'] / 1e9:.3f} GB against the card's "
            f"{card / 1e9:.1f} GB; wire {r['wire_bytes_per_device']:.4e} "
            f"bytes ({r['collective_op_counts']}), collective_s "
            f"{r['wire_bytes_per_device'] / LINK_BW:.4f} at "
            f"{LINK_BW:.3g} B/s; roofline compute {rr['compute_s']:.4f} s, "
            f"memory {rr['memory_s']:.4f} s, collective "
            f"{rr['collective_s']:.4f} s, {rr['dominant']}-bound, "
            f"{100 * rr['roofline_fraction']:.2f}% of the roofline")
        assert r["flops_per_device"] > 0 and r["wire_bytes_per_device"] > 0
        assert r["argument_bytes"] > 0 and r["peak_memory_bytes"] > 0
        prod[name] = {"roofline": rr, "card_bytes": card, **{
            k: r[k] for k in ("trace_s", "seconds", "argument_bytes",
                              "peak_memory_bytes", "temp_bytes",
                              "output_bytes", "flops_per_device",
                              "bytes_accessed_per_device",
                              "wire_bytes_per_device",
                              "collective_op_counts")}}
    out["dryrun_production"] = prod
    # held against serve_fsdp_prefill after the tensor-parallel phases
    out["dryrun_serve_fsdp_prefill"] = got["dryrun_serve_fsdp_prefill"]
    return out


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

    dry = start_dryruns()
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    ptxas = ptxas_report(_build.build_dir(),
                         {n: p.stem.split("-")[-1] for n, p in libs.items()})
    log(f"build: {time.perf_counter() - t0:.2f} s ({ptxas_summary(ptxas)})")
    for name in ("flash_attention", "distance_topk", "propagate",
                 "rmsnorm", "moe_combine"):
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
    from repro_torch.kernels.moe_combine.ops import moe_combine
    from repro_torch.kernels.rmsnorm.ops import rmsnorm

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
        check_rmsnorm(dev),
        check_moe_combine(dev),
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
    # without causal, and the shapes the mixer and seamless paths launch
    # below their full-width prefills (seamless_decode's encoder: batch 4
    # over 4,096 frames; sharded_seamless's: each rank's 4 of its 16 heads),
    # and the step of the benchmark's OLMoE-1B-7B-0924 cell (8 prompts of
    # 4,096); the short path at S 1, 8 and 32 in both dtypes
    bf, f32 = torch.bfloat16, torch.float32
    for label, b, s, skv, h, hk, hd, dtype, causal, window, path in [
            ("tc-hd64-gqa1", 2, 1000, 1000, 8, 8, 64, bf, True, 0, "tc"),
            ("tc-hd80-ragged", 2, 333, 333, 8, 2, 80, bf, True, 100, "tc"),
            ("tc-hd128-skv", 1, 700, 1500, 16, 4, 128, bf, True, 0, "tc"),
            ("tc-skv<s", 2, 1000, 300, 8, 2, 128, bf, False, 0, "tc"),
            ("tc-no-key", 1, 1200, 500, 8, 2, 64, bf, True, 256, "tc"),
            ("tc-window-only", 1, 1000, 1000, 8, 2, 120, bf, False, 200,
             "tc"),
            ("tc-hd128-gqa1-olmoe", 1, 2048, 2048, 16, 16, 128, bf, True, 0,
             "tc"),
            ("tc-hd128-gqa8-qwen3moe", 1, 2048, 2048, 32, 4, 128, bf, True,
             0, "tc"),
            ("tc-hd128-gqa1-olmoe-0924", 8, 4096, 4096, 16, 16, 128, bf,
             True, 0, "tc"),
            ("tc-hd64-cross-seamless", 1, 3000, 5000, 16, 16, 64, bf, False,
             0, "tc"),
            ("tc-hd64-bidir-seamless-decode", 4, 4096, 4096, 16, 16, 64, bf,
             False, 0, "tc"),
            ("tc-hd64-bidir-seamless-rank", 4, 4096, 4096, 4, 4, 64, bf,
             False, 0, "tc"),
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
    rmsnorm.launches = 0
    moe_combine.launches = 0
    # rmsnorm launches by phase of the main path, in this process (the
    # mesh phases' workers report theirs)
    norms, norm_mark = {}, [0]

    def count_norms(phase: str) -> None:
        norms[phase] = rmsnorm.launches - norm_mark[0]
        norm_mark[0] = rmsnorm.launches

    torch.cuda.reset_peak_memory_stats()
    with Phase("build_tasti", args.profile) as ph:
        system = build_tasti(wl, cfg, variant="PT", embed_params=params,
                             device=dev)
    index = system.index
    count_norms("build_tasti")          # the MLP embedder: no norm
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
    count_norms("sessions")
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
    del engine, system
    torch.cuda.empty_cache()

    with Phase("serve", args.profile) as ph:
        serve = run_serve(dev, wl, index, SERVE_RATE, SERVE_SECONDS)
    log(f"phase serve: {ph.seconds:.2f} s")
    count_norms("serve")
    for name, n in serve["launches"].items():
        launches[name] += n
    topk_paths["serve"] = serve["distance_topk_by_route"]
    del index
    torch.cuda.empty_cache()

    tasti_t = run_tasti_t(dev, wl, args.n_train, args.reps, specs,
                          args.profile, pt_rows)
    for name, n in tasti_t["launches"].items():
        launches[name] += n
    topk_paths["tasti_t"] = tasti_t.pop("distance_topk_by_route")
    count_norms("tasti_t")
    torch.cuda.empty_cache()

    lm_out = run_lm(dev, args.prefill_len, args.compare_len, args.profile)
    count_norms("lm")           # prefill, serve, decode window and ring
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
    count_norms("embedder")
    launches["flash_attention"] = (lm_out["prefill"]["launches"]
                                   + lm_out["serve"]["launches"]
                                   + lm_out["decode_window"]["launches"]
                                   + emb_launches)
    del model, emb, plain
    torch.cuda.empty_cache()

    lm_train = run_lm_train(dev, 4096, 3, args.profile)
    count_norms("lm_train")     # its kernel forward; none in the steps
    resilient = run_lm_train_resilient()
    count_norms("lm_train_resilient")
    free_card()
    mixers = run_mixers(dev, args.prefill_len, args.compare_len,
                        args.profile)
    count_norms("mixers")
    mixer_flash = {name: mixers[name]["launches"] for name in (
        "moe_prefill", "moe_decode", "moe_prefill_0924", "xlstm",
        "moe_prefill_qwen3")}
    mixer_flash["moe_train"] = 0            # asserted in run_moe_train
    launches["flash_attention"] += sum(mixer_flash.values())
    vlm = run_vlm(dev, args.prefill_len, args.compare_len, args.profile)
    count_norms("vlm")
    vlm_flash = {"vlm_prefill": vlm["launches"],
                 "vlm_decode": vlm["decode"]["launches"]}
    launches["flash_attention"] += sum(vlm_flash.values())
    seamless = run_seamless(dev, args.prefill_len, args.compare_len,
                            args.profile)
    count_norms("seamless")
    seamless_flash = {"seamless_prefill": seamless["launches"],
                      "seamless_decode": seamless["decode"]["launches"]}
    launches["flash_attention"] += sum(seamless_flash.values())
    phi3 = run_phi3(dev, args.prefill_len, args.compare_len, args.profile)
    count_norms("phi3")
    log(f"rmsnorm launches by phase: {norms}")
    assert all(norms[ph] > 0 for ph in (
        "lm", "embedder", "lm_train", "mixers", "vlm", "seamless", "phi3")), \
        norms
    phi3_flash = {"phi3_prefill": phi3["launches"],
                  "lm_decode_ring": lm_out["decode_ring"]["launches"]}
    launches["flash_attention"] += sum(phi3_flash.values())
    free_card()
    dry_out = finish_dryruns(dry, phi3, lm_train)

    # the mesh layer, after the card has been freed: no kernel of its own
    from repro_torch.configs import get_config
    compress = run_compress(dev, get_config("h2o-danube-3-4b"))
    count_norms("compress")
    parallel = run_parallel({"device": "cuda", "arch": "h2o-danube-3-4b",
                             "prefill_len": args.prefill_len,
                             "compare_len": args.compare_len})
    parallel["compress"] = compress
    tensor_parallel = run_tensor_parallel({
        "device": "cuda", "prefill_len": args.compare_len,
        "train_len": TP_TRAIN_LEN})
    parallel["tensor_parallel"] = tensor_parallel
    dry_out["dryrun_serve_fsdp_prefill"] = check_serve_fsdp_dryrun(
        dry_out["dryrun_serve_fsdp_prefill"],
        tensor_parallel["serve_fsdp_prefill"])
    tp_flash = {
        "megatron_prefill": sum(
            tensor_parallel["megatron_prefill"]["launches_by_rank"]),
        "serve_fsdp_prefill": sum(
            tensor_parallel["serve_fsdp_prefill"]["launches_by_rank"]),
        "ep_prefill_megatron": sum(
            tensor_parallel["ep_prefill"]["megatron"]["launches_by_rank"]),
        "ep_prefill_ep_seq": sum(
            tensor_parallel["ep_prefill"]["ep_seq"]["launches_by_rank"]),
        "megatron_train": sum(
            tensor_parallel["megatron_train"]["launches_by_rank"])}
    launches["flash_attention"] += sum(tp_flash.values())
    sharded = run_sharded_decode({"device": "cuda"})
    parallel["sharded_decode"] = sharded
    sd_flash = {ph.name: sum(sharded[ph.name]["launches_by_rank"])
                for ph in SD_PHASES}
    launches["flash_attention"] += sum(sd_flash.values())
    # the mesh phases' workers, each asserted above zero where it prefills
    # or decodes on the card
    norms["seq_dp_prefill"] = sum(parallel["seq_dp_prefill"]["norms_by_rank"])
    for name in ("megatron_prefill", "serve_fsdp_prefill", "megatron_train"):
        norms[name] = sum(tensor_parallel[name]["norms_by_rank"])
    for name in ("megatron", "ep_seq"):
        norms[f"ep_prefill_{name}"] = sum(
            tensor_parallel["ep_prefill"][name]["norms_by_rank"])
    for ph in SD_PHASES:
        norms[ph.name] = sum(sharded[ph.name]["norms_by_rank"])
    launches["rmsnorm"] = sum(norms.values())
    log(f"rmsnorm launches by phase, the mesh phases' added: {norms}")
    # moe_prefill_0924 resets the combine's count just before its forward,
    # and only the dropless MoE reaches the kernel: the capacity dispatch
    # of the phases after it (qwen3-moe) launches none
    launches["moe_combine"] = moe_combine.launches
    combine_phase = mixers["moe_prefill_0924"]["combine_launches"]
    log(f"moe_combine launches over the main path: {launches['moe_combine']}"
        f" (moe_prefill_0924's forward: {combine_phase})")
    assert launches["moe_combine"] == combine_phase == 16, launches
    results[4]["launches_by_phase"]["moe_prefill_0924"] = combine_phase

    sources = {"distance_topk": "src/repro/kernels/distance_topk/kernel.py:77",
               "fpf_update": "src/repro/kernels/fpf_update/kernel.py:34",
               "propagate": "src/repro/kernels/propagate/kernel.py:84",
               "flash_attention":
                   "src/repro/kernels/flash_attention/kernel.py:72",
               "rmsnorm": None,     # the norm, which XLA fuses
               "moe_combine": None}  # an einsum in the JAX package
    # per kernel path: its timed shape (tc: a, simt: a32, short: b) and its
    # launches over the main path's phases
    by_label = {r["label"]: r for r in flash}
    phase_paths = [mixers["moe_prefill"]["launches_by_path"],
                   mixers["moe_prefill_qwen3"]["launches_by_path"],
                   vlm["launches_by_path"], seamless["launches_by_path"],
                   seamless["decode"]["launches_by_path"],
                   phi3["launches_by_path"],
                   lm_out["prefill"]["launches_by_path"],
                   lm_out["serve"]["launches_by_path"],
                   lm_out["decode_window"]["launches_by_path"], emb_paths]
    tp_tc = sum(sum(tensor_parallel[k]["tc_by_rank"]) for k in (
        "megatron_prefill", "serve_fsdp_prefill")) + sum(
        sum(tensor_parallel["ep_prefill"][k]["tc_by_rank"])
        for k in ("megatron", "ep_seq")) + sum(
        sum(sharded[ph.name]["tc_by_rank"]) for ph in SD_PHASES)
    paths = {}
    for path, label in (("tc", "a"), ("short", "b"), ("simt", "a32")):
        r = by_label[label]
        paths[path] = {"shape_label": label, "launches": sum(
            pp[path] for pp in phase_paths) + (tp_tc if path == "tc" else 0),
            **{k: r[k] for k in (
                "shape", "dtype", "ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "max_abs_err")}}
    paths["tc"]["prefill_full"] = flash_full
    paths["tc"]["prefill_full_moe"] = mixers["flash_full"]
    paths["tc"]["prefill_full_vlm"] = vlm["flash_full"]
    paths["tc"]["prefill_full_seamless"] = seamless["flash_full"]
    paths["tc"]["prefill_full_phi3"] = phi3["flash_full"]
    paths["registers"] = {fn: {"registers": regs, "spill_bytes": spill}
                          for fn, regs, spill in ptxas["flash_attention"]}
    a = by_label["a"]
    results.append({
        "name": "flash_attention", "max_abs_err": max(
            r["max_abs_err"] for r in flash + mixers["flash_full"]
            + [vlm["flash_full"], phi3["flash_full"]]
            + seamless["flash_full"] if r["max_abs_err"] is not None),
        **{k: a[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms")},
        "paths": paths, "checks": flash,
        "launches_by_phase": {"lm_prefill": lm_out["prefill"]["launches"],
                              "lm_serve": lm_out["serve"]["launches"],
                              "lm_decode_window":
                                  lm_out["decode_window"]["launches"],
                              "embedder": emb_launches, **mixer_flash,
                              **vlm_flash, **seamless_flash, **phi3_flash,
                              **tp_flash, **sd_flash},
        "lm_prefill": lm_out["prefill"], "lm_serve": lm_out["serve"],
        "lm_decode_window": lm_out["decode_window"],
        "lm_decode_ring": lm_out["decode_ring"],
        "shard_strategies": lm_out["strategies"]})
    results[0]["launches_by_path"] = topk_paths
    results[0]["registers"] = {fn: {"registers": regs, "spill_bytes": spill}
                               for fn, regs, spill in ptxas["distance_topk"]}
    results[2]["launches_by_path"] = dict(propagate.launches_by_path)
    results[2]["serve_launches_by_mode"] = serve["propagate_by_mode"]
    results[2]["registers"] = {fn: {"registers": regs, "spill_bytes": spill}
                               for fn, regs, spill in ptxas["propagate"]}
    results[3]["launches_by_phase"] = dict(
        norms, phi3_prefill=phi3["rmsnorm_launches"])
    kernels = []
    for res in results:
        name = res["name"]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/csrc/{name}.cu",
                        "replaces": sources[name],
                        "launches": launches[name], **{
                            k: v for k, v in res.items() if k != "name"}})
    log("serve path: " + json.dumps(serve))
    log("training paths: " + json.dumps({
        "tasti_t": tasti_t, "lm_train": lm_train,
        "lm_train_resilient": resilient}))
    log("mixer paths: " + json.dumps(mixers))
    log("vlm paths: " + json.dumps(vlm))
    log("seamless paths: " + json.dumps(seamless))
    log("phi3 paths: " + json.dumps(phi3))
    log("dry-run paths: " + json.dumps(dry_out))
    log("parallel paths: " + json.dumps(parallel))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
