"""Roofline analysis from the port's dry-run artifacts (``launch.dryrun``).

Per (arch x shape) on the single-pod 16x16 mesh, for one H100 SXM5 80 GB
at its 700 W limit (``launch.mesh``; ``hw=`` takes other constants):

    compute    = FLOPs      / (chips * 989.4e12 bf16 FLOP/s)
    memory     = bytes      / (chips * 3.35e12  B/s HBM)
    collective = wire_bytes / (50e9 B/s per GPU and direction, InfiniBand)

The primary compute and memory terms come from the analytic op model
(``launch/analytic.py``), as the JAX package's do.  The dry run's own
traced flops and bytes are reported beside them (``hlo_flops_global``,
``hlo_bytes_global``, ``hlo_vs_analytic_flops``: the names of the JAX
package's rows, whose numbers came from XLA).

One difference from the JAX package: XLA counts a scanned layer's body once,
so the JAX roofline scales each count as ``full + (n_repeats - 1) * block``.
The port runs every layer eagerly and its dry run traces them all: the
full cell's flops, bytes and wire bytes already cover every layer, and
this roofline takes them as they are.  A ``__block`` JSON, where there is
one, gives the per-block cost (``block_flops_per_device``,
``block_wire_bytes_per_device``) and scales nothing.

MODEL_FLOPS uses 6*N*D (train), 2*N*D (prefill), 2*N_active*B (decode); the
ratio MODEL_FLOPS / analytic FLOPs exposes remat/redundancy waste.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--json out.json]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
from typing import List, NamedTuple, Optional

from repro_torch.configs import (ASSIGNED_ARCHS, SHAPE_BY_NAME, SHAPES,
                                 cell_is_runnable, get_config)
from repro_torch.launch import analytic
from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16

DRYRUN_DIR = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
              / "dryrun_torch")


class Hardware(NamedTuple):
    """Per-chip peak bf16 FLOP/s, HBM bytes/s, and collective link
    bytes/s."""
    peak_flops: float
    hbm_bw: float
    link_bw: float


#: one H100 SXM5 80 GB at 700 W, InfiniBand NDR between nodes
H100 = Hardware(PEAK_FLOPS_BF16, HBM_BW, LINK_BW)


def _load(tag: str) -> Optional[dict]:
    p = DRYRUN_DIR / f"{tag}.json"
    if not p.exists():
        return None
    d = json.loads(p.read_text())
    return d if d.get("status") == "ok" else None


def model_flops(arch: str, shape) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); enc-dec tokens split 50/50 so the
    effective token count is halved (each token crosses ~half the stack)."""
    cfg = get_config(arch)
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * shape.seq_len
    if cfg.encoder_decoder:
        tokens /= 2
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch


def roofline_row(full: dict, block: Optional[dict], arch: str, shape,
                 mesh: str = "single", variant: str = "",
                 hw: Hardware = H100) -> dict:
    """The roofline row of one cell from its dry-run result ``full`` (and
    its block's, ``block``, or None)."""
    chips = full["n_devices"]
    traced_flops_dev = full.get("flops_per_device") or 0.0
    traced_bytes_dev = full.get("bytes_accessed_per_device") or 0.0
    wire_dev = full.get("wire_bytes_per_device") or 0.0

    # primary terms: the analytic op model (launch/analytic.py)
    cfg = get_config(arch)
    overrides = full.get("overrides") or {}
    if overrides:
        typed = {k: type(getattr(cfg, k))(v) for k, v in overrides.items()}
        cfg = dataclasses.replace(cfg, **typed)
    cost = analytic.cell_cost(cfg, shape)
    flops_dev = cost.flops / chips
    bytes_dev = cost.bytes / chips

    compute_s = flops_dev / hw.peak_flops
    memory_s = bytes_dev / hw.hbm_bw
    collective_s = wire_dev / hw.link_bw
    dominant = max(("compute", compute_s), ("memory", memory_s),
                   ("collective", collective_s), key=lambda kv: kv[1])[0]
    mf = model_flops(arch, shape)
    bound_s = max(compute_s, memory_s, collective_s)
    ideal_s = mf / (chips * hw.peak_flops)
    if shape.kind == "decode":
        # decode is irreducibly memory-bound: the ideal step time is the
        # minimal traffic (params + one cache read; ring-buffered writes)
        min_cfg = dataclasses.replace(cfg, decode_ring=cfg.decode_ring or 256)
        min_bytes = analytic.cell_cost(min_cfg, shape).bytes
        ideal_s = max(ideal_s, min_bytes / (chips * hw.hbm_bw))
    row = {
        "arch": arch,
        "shape": shape.name,
        "mesh": mesh,
        "chips": chips,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "model_flops": mf,
        "analytic_flops_global": cost.flops,
        "analytic_bytes_global": cost.bytes,
        "hlo_flops_global": traced_flops_dev * chips,
        "hlo_bytes_global": traced_bytes_dev * chips,
        "hlo_vs_analytic_flops": (traced_flops_dev * chips) / cost.flops
        if cost.flops else 0.0,
        "useful_ratio": mf / cost.flops if cost.flops else 0.0,
        # fraction of roofline: ideal (model-FLOPs-limited) time over the
        # dominant-term time
        "roofline_fraction": ideal_s / bound_s if bound_s else 0.0,
        "peak_memory_gib": (full.get("peak_memory_bytes") or 0) / 2 ** 30,
        "block_scaled": False,
        "variant": variant,
    }
    if block is not None:
        row["block_flops_per_device"] = block.get("flops_per_device") or 0.0
        row["block_wire_bytes_per_device"] = (
            block.get("wire_bytes_per_device") or 0.0)
    return row


def analyze_cell(arch: str, shape, mesh: str = "single", variant: str = "",
                 hw: Hardware = H100) -> Optional[dict]:
    """The row of the cell whose dry-run JSON is in :data:`DRYRUN_DIR`, or
    None where there is none."""
    suffix = f"__{variant}" if variant else ""
    full = _load(f"{arch}__{shape.name}__{mesh}{suffix}")
    if full is None:
        return None
    block = _load(f"{arch}__{shape.name}__{mesh}__block{suffix}")
    return roofline_row(full, block, arch, shape, mesh, variant, hw)


def full_table(mesh: str = "single", hw: Hardware = H100) -> List[dict]:
    rows = []
    for arch in ASSIGNED_ARCHS:
        for shape in SHAPES:
            if not cell_is_runnable(arch, shape):
                rows.append({"arch": arch, "shape": shape.name, "mesh": mesh,
                             "skipped": True})
                continue
            cell = analyze_cell(arch, shape, mesh, hw=hw)
            if cell:
                rows.append(cell)
    return rows


def format_table(rows: List[dict]) -> str:
    hdr = (f"{'arch':26s} {'shape':12s} {'compute_s':>10s} {'memory_s':>10s} "
           f"{'coll_s':>10s} {'dom':>10s} {'useful':>7s} {'roofl%':>7s} "
           f"{'peakGiB':>8s} {'trc/ana':>8s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        if r.get("skipped"):
            lines.append(f"{r['arch']:26s} {r['shape']:12s} "
                         f"{'— skipped (full attention @500k)':>40s}")
            continue
        lines.append(
            f"{r['arch']:26s} {r['shape']:12s} {r['compute_s']:10.4f} "
            f"{r['memory_s']:10.4f} {r['collective_s']:10.4f} "
            f"{r['dominant']:>10s} {r['useful_ratio']:7.3f} "
            f"{100*r['roofline_fraction']:7.2f} {r['peak_memory_gib']:8.2f} "
            f"{r['hlo_vs_analytic_flops']:8.3f}")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--json", default="")
    ap.add_argument("--compare", nargs=3, metavar=("ARCH", "SHAPE", "VARIANT"),
                    action="append", default=[],
                    help="print baseline vs variant for one cell")
    args = ap.parse_args(argv)
    if args.compare:
        for arch, shape_name, variant in args.compare:
            shape = SHAPE_BY_NAME[shape_name]
            base = analyze_cell(arch, shape, args.mesh)
            var = analyze_cell(arch, shape, args.mesh, variant=variant)
            print(format_table([r for r in (base, var) if r]))
            if base and var:
                for term in ("compute_s", "memory_s", "collective_s"):
                    b, v = base[term], var[term]
                    print(f"  {term}: {b:.4f} -> {v:.4f} "
                          f"({b/max(v,1e-12):.2f}x)")
                print(f"  roofline: {100*base['roofline_fraction']:.2f}% -> "
                      f"{100*var['roofline_fraction']:.2f}%")
        return
    rows = full_table(args.mesh)
    print(format_table(rows))
    if args.json:
        pathlib.Path(args.json).write_text(json.dumps(rows, indent=2))


if __name__ == "__main__":
    main()
