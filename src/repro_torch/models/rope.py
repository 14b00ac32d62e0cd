"""Rotary position embeddings: standard RoPE (half-split layout) and M-RoPE
(Qwen2-VL).

M-RoPE splits the head dimension into (temporal, height, width) sections;
text tokens use identical positions in all three sections, vision tokens
use their (t, h, w) grid coordinates.  ``mrope_positions`` builds the (3, B,
S) position tensor for the stubbed vision frontend: ``vision_tokens`` patch
embeddings occupy positions [0, V) on a (gh, gw) grid, text follows.
"""
from __future__ import annotations

from typing import Tuple

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


def mrope_angles(positions_3d: torch.Tensor, head_dim: int, theta: float,
                 sections: Tuple[int, int, int]) -> torch.Tensor:
    """positions_3d (3, B, S) -> angles (B, S, head_dim//2), float32.

    ``sections`` gives per-axis sizes in *half-dim* units, summing to hd//2:
    the first section of the frequencies takes the temporal positions, the
    next the heights, the last the widths."""
    assert sum(sections) == head_dim // 2, (sections, head_dim)
    freqs = rope_freqs(head_dim, theta, positions_3d.device)
    all_angles = positions_3d[..., None].float() * freqs  # (3, B, S, hd//2)
    parts, off = [], 0
    for axis, sec in enumerate(sections):
        parts.append(all_angles[axis, :, :, off:off + sec])
        off += sec
    return torch.cat(parts, dim=-1)


def mrope_positions(batch: int, seq: int, vision_tokens: int,
                    grid: Tuple[int, int], offset: int = 0,
                    device=None) -> torch.Tensor:
    """(3, B, S) int64 positions: vision patches on a grid, then text.
    Position i < V is (0, (i mod gh*gw) // gw, i mod gw); a text position
    is i - V + 1 on all three axes."""
    gh, gw = grid
    v = vision_tokens
    idx = torch.arange(seq, device=device) + offset
    text = idx - v + 1
    vision = idx < v
    t_pos = torch.where(vision, 0, text)
    h_pos = torch.where(vision, (idx % (gh * gw)) // gw, text)
    w_pos = torch.where(vision, idx % gw, text)
    pos = torch.stack([t_pos, h_pos, w_pos])  # (3, S)
    return pos[:, None, :].expand(3, batch, seq)
