"""Attention dispatch: every attention of the port goes through here.

A CUDA tensor launches the hand-written kernel (or the wrapper raises);
a CPU tensor takes the kernel's plain PyTorch version.  There is no
switch that sends CUDA tensors to the plain versions and no fallback
from a failed launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels.flash_attention import INVALID_POS  # noqa: F401


def _plain_device(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cpu":
        raise ValueError(f"{name}: no kernel for device {t.device}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lo: torch.Tensor, hi: torch.Tensor,
                     softcap: float = 0.0) -> torch.Tensor:
    """K1.  q (B, H, D); k/v (B, S, KV, D); slots ``[lo, hi)`` (B,) are
    attended.  Returns (B, H, D)."""
    if q.is_cuda:
        return DA.decode_attention_cuda(q, k, v, lo, hi, softcap)
    _plain_device(q, "decode_attention")
    DA.COUNTER.plain += 1
    return DA.decode_attention_plain(q, k, v, lo, hi, softcap)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, k_pos: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """K2.  q (B, Lq, H, D); k/v (B, Lk, KV, D); q_pos (B, Lq), k_pos
    (B, Lk) with ``INVALID_POS`` marking dead keys.  Returns
    (B, Lq, H, D)."""
    if q.is_cuda:
        return FA.flash_attention_cuda(q, k, v, q_pos, k_pos, causal,
                                       window, softcap)
    _plain_device(q, "flash_attention")
    FA.COUNTER.plain += 1
    return FA.flash_attention_plain(q, k, v, q_pos, k_pos, causal, window,
                                    softcap)
