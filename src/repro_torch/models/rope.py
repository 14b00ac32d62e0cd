"""Rotary position embeddings (standard RoPE, half-split layout).

M-RoPE (Qwen2-VL) waits for the vision slice of the port (ROADMAP A4):
``repro_torch.models.lm`` raises for a config that asks for it.
"""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> torch.Tensor:
    """positions (..., S) -> angles (..., S, head_dim//2), float32."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    return positions[..., None].float() * freqs


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, hd); angles (B, S, hd//2) or (S, hd//2).

    cos and sin are cast to x's dtype before they multiply, as the JAX
    package does, so bfloat16 results round the same way."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if angles.ndim == 2:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
