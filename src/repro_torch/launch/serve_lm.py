"""Batched LM decode demo: prefill by replay, then greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch qwen3-1.7b \
        --preset ci --batch 4 --prompt-len 32 --decode-steps 16

The same flags and output lines as ``repro.launch.serve_lm``, plus
``--device`` (default ``cuda``; ``cpu`` to run without a card).  An
encoder-decoder arch (seamless-m4t-large-v2) is refused: the demo has no
encoder inputs to give it (the JAX package's demo fails on it with a
``KeyError``).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.common import PyTree
from repro_torch.train.steps import make_serve_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def check_decoder_only(cfg: ModelConfig) -> None:
    """Raises ``ValueError`` for an encoder-decoder config: its decoder
    cross-attends to an encoder's output over audio frames, and the demo
    has only token prompts."""
    if cfg.encoder_decoder:
        raise ValueError(
            f"serve_lm: {cfg.name} is an encoder-decoder model; its decoder "
            "needs encoder inputs (enc_embeds), which this token-prompt demo "
            "does not have; use models.lm.prefill with enc_embeds in the "
            "batch, then decode_step")


def serve(params: PyTree, cfg: ModelConfig, prompts: torch.Tensor,
          decode_steps: int) -> Dict[str, object]:
    """Replay ``prompts`` (B, S) through the decode step into caches of
    capacity S + decode_steps, then decode greedily.  Returns the logits at
    the last prompt position (B, V), the generated ids (B, decode_steps)
    and the wall seconds of both phases.  Decoder-only models."""
    check_decoder_only(cfg)
    dev = prompts.device
    b, s = prompts.shape
    step = make_serve_step(cfg)
    t0 = time.perf_counter()
    caches = lm.init_cache(cfg, b, s + decode_steps, device=dev)
    logits = None
    for t in range(s):
        logits, caches = step(params, caches, prompts[:, t:t + 1], t)
    last_logits = logits[:, 0]
    _sync(dev)
    t1 = time.perf_counter()
    out_tokens = []
    tok = torch.argmax(logits[:, :, :cfg.vocab_size], dim=-1)
    for t in range(decode_steps):
        out_tokens.append(tok[:, 0])
        logits, caches = step(params, caches, tok, s + t)
        tok = torch.argmax(logits[:, :, :cfg.vocab_size], dim=-1)
    gen = torch.stack(out_tokens, 1).cpu().numpy()
    t2 = time.perf_counter()
    return {"last_logits": last_logits, "generated": gen,
            "prefill_s": t1 - t0, "decode_s": t2 - t1}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--preset", default="ci", choices=["ci", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (cuda, or cpu without a card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    check_decoder_only(cfg)
    dev = resolve_device(args.device)
    if args.preset == "ci":
        cfg = cfg.smoke()
    params = lm.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    b, s = args.batch, args.prompt_len
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(1, cfg.vocab_size, size=(b, s)),
                              device=dev)
    out = serve(params, cfg, prompts, args.decode_steps)
    gen = out["generated"]
    print(f"[serve] arch={cfg.name} batch={b} prefill={s} tok "
          f"({out['prefill_s']:.2f}s) decode={args.decode_steps} tok "
          f"({out['decode_s']:.2f}s, "
          f"{b * args.decode_steps / out['decode_s']:.1f} tok/s)")
    print(f"[serve] sample generation ids: {gen[0][:12].tolist()}")
    assert gen.shape == (b, args.decode_steps)


if __name__ == "__main__":
    main()
