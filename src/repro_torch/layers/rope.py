"""Rotary position embeddings (half-split, not interleaved pairs):
standard RoPE and Qwen2-VL's M-RoPE.

Port of ``src/repro/layers/rope.py``.  M-RoPE [arXiv:2409.12191] splits
the rotary frequencies into (temporal, height, width) sections, each
rotated by its own position stream, so it takes a ``(3, ..., L)``
position tensor; text passes the same positions three times, and then
the tables equal plain RoPE's.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def rope_freqs(head_dim: int, theta: float,
               device: torch.device | None = None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), float32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., L) int -> cos/sin (..., L, head_dim // 2) float32."""
    inv = rope_freqs(head_dim, theta, positions.device)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Rotate x (B, L, H, D) with cos/sin (B, L, D//2); float32 math."""
    orig = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(orig)


def mrope_cos_sin(positions3: torch.Tensor, head_dim: int, theta: float,
                  sections: Sequence[int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """M-RoPE cos/sin.  positions3 (3, ..., L) int; ``sections`` (summing
    to head_dim // 2) say how many frequency bands each stream drives, in
    order.  Returns cos/sin (..., L, head_dim // 2) float32."""
    if sum(sections) != head_dim // 2:
        raise ValueError(f"mrope sections {tuple(sections)} must sum to "
                         f"head_dim // 2 = {head_dim // 2}")
    inv = rope_freqs(head_dim, theta, positions3.device)
    sel = torch.repeat_interleave(
        torch.arange(3, device=positions3.device),
        torch.as_tensor(list(sections), device=positions3.device))
    # each band's angle from its own stream: (..., L, D/2)
    ang = positions3.float()[..., None] * inv               # (3, ..., L, D/2)
    ang = ang.movedim(0, -1).gather(
        -1, sel.expand(ang.shape[1:-1] + (head_dim // 2,))[..., None])[..., 0]
    return torch.cos(ang), torch.sin(ang)


def text_positions3(positions: torch.Tensor) -> torch.Tensor:
    """Text-only M-RoPE positions: all three streams equal."""
    return positions[None].expand((3,) + tuple(positions.shape))
