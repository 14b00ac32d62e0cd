"""Fault-tolerant LM training launcher.  The same flags, presets and output
lines as ``repro.launch.train``, plus ``--device``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --preset ci --steps 50 --ckpt-dir /path/to/ckpt

Composes the runtime: the resumable data pipeline (its state carried in
checkpoints), AdamW, async checkpointing, straggler monitoring, retry-on-
failure, and optional failure injection (--inject-failure-at) to show
checkpoint/restart end to end.  ``--device`` picks where the model trains
(CUDA by default; ``cpu`` for a machine without a card).  The train step
updates the state in place, so a step-0 checkpoint is written first when
the directory holds none: a failure before the first periodic checkpoint
then replays from the initial state, as the JAX package's launcher does.
Exits non-zero if the last loss is not below the first.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data.pipeline import TokenDataset
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.common import tree_leaves
from repro_torch.optim.adamw import OptimizerConfig, init_opt_state
from repro_torch.runtime.fault_tolerance import StragglerMonitor, run_resilient
from repro_torch.train.steps import make_train_step


def preset_config(arch: str, preset: str):
    cfg = get_config(arch)
    if preset == "ci":
        cfg = cfg.smoke()
        return cfg, 8, 64
    if preset == "100m":
        # ~100M-parameter member of the arch family for the e2e example
        cfg = dataclasses.replace(
            cfg.smoke(), name=cfg.name + "-100m", d_model=576, n_layers=12,
            n_heads=9, n_kv_heads=3, head_dim=64,
            d_ff=2304, vocab_size=32000, vocab_pad_multiple=128)
        return cfg, 8, 256
    return cfg, 256, 4096  # full (pod-scale)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--preset", default="ci", choices=["ci", "100m", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--inject-failure-at", type=int, default=-1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda",
                    help="device to train on (cuda, or cpu)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg, batch, seq = preset_config(args.arch, args.preset)
    opt = OptimizerConfig(peak_lr=args.lr, min_lr=args.lr * 0.1,
                          warmup_steps=max(args.steps // 20, 5),
                          total_steps=args.steps,
                          state_dtype=cfg.opt_state_dtype)
    params = lm.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    opt_state = init_opt_state(params, opt)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"[train] arch={cfg.name} params={n_params/1e6:.1f}M "
          f"batch={batch} seq={seq} steps={args.steps}")

    ds = TokenDataset(vocab_size=cfg.vocab_size, seed=0)
    step_fn = make_train_step(cfg, opt)
    ckpt = Checkpointer(args.ckpt_dir)
    monitor = StragglerMonitor()
    losses = []
    injected = {"armed": args.inject_failure_at >= 0}

    def one_step(state, step):
        if injected["armed"] and step == args.inject_failure_at:
            injected["armed"] = False
            raise RuntimeError("injected failure (see --inject-failure-at)")
        # pipeline state rides in the checkpointed tree as numeric leaves
        params, opt_state, (epoch, offset) = state
        batch_np = ds.batch(int(epoch), int(offset), batch, seq)
        tb = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
              for k, v in batch_np.items()}
        params, opt_state, metrics = step_fn(params, opt_state, tb)
        losses.append(float(metrics["loss"]))
        if step % 10 == 0:
            print(f"  step {step:5d} loss {losses[-1]:.4f} "
                  f"lr {float(metrics['lr']):.2e}")
        return (params, opt_state,
                (epoch, torch.tensor(int(offset) + 1, dtype=torch.int32))), \
            metrics

    init_state = (params, opt_state, (torch.tensor(0, dtype=torch.int32),
                                      torch.tensor(0, dtype=torch.int32)))
    if ckpt.latest_step() is None:
        ckpt.save(0, init_state, extra={"next_step": 0})
    t0 = time.time()
    report = run_resilient(
        one_step, init_state, n_steps=args.steps, ckpt=ckpt,
        ckpt_every=args.ckpt_every, monitor=monitor)
    dt = time.time() - t0
    print(f"[train] done: {report.steps_completed} steps in {dt:.0f}s, "
          f"restarts={report.restarts}, "
          f"first-loss={losses[0]:.4f} last-loss={losses[-1]:.4f}")
    if not losses[-1] < losses[0]:
        raise SystemExit("loss did not decrease")


if __name__ == "__main__":
    main()
