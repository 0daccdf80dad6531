"""Rotary position embeddings, including Qwen2-VL M-RoPE (arXiv:2409.12191)
(port of ``repro.models.rope``).

M-RoPE splits the head_dim/2 rotary frequencies into (temporal, height,
width) sections, each rotated by its own position stream.  Text tokens carry
identical (t, h, w) positions, reducing to standard 1-D RoPE.
"""
from __future__ import annotations

import torch

__all__ = ["rope_angles", "apply_rope", "mrope_angles", "sinusoidal_positions"]


def _freqs(half: int, theta: float, device) -> torch.Tensor:
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for integer positions.

    positions: (...,) int -> cos, sin each (..., head_dim // 2) float32.
    """
    half = head_dim // 2
    freqs = _freqs(half, theta, positions.device)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def mrope_angles(positions: torch.Tensor, head_dim: int,
                 sections: tuple[int, int, int],
                 theta: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """M-RoPE cos/sin. positions: (3, B, S) int for (t, h, w) streams.

    sections are sizes over the head_dim/2 frequency axis, sum == head_dim/2.
    """
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"sections {sections} do not sum to {half}")
    freqs = _freqs(half, theta, positions.device)
    ang_all = positions.float()[..., None] * freqs          # (3, B, S, half)
    parts = []
    start = 0
    for i, sec in enumerate(sections):
        parts.append(ang_all[i, ..., start:start + sec])
        start += sec
    ang = torch.cat(parts, dim=-1)                           # (B, S, half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (B, S, hd/2) -> rotated x (same dtype)."""
    dt = x.dtype
    x = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]  # broadcast over heads
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(dt)


def sinusoidal_positions(positions: torch.Tensor,
                         d_model: int) -> torch.Tensor:
    """Additive sinusoidal embeddings (whisper-style stub frontend)."""
    half = d_model // 2
    freqs = 10000.0 ** (-torch.arange(half, dtype=torch.float32,
                                      device=positions.device)
                        / max(half - 1, 1))
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
