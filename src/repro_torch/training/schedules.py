"""Learning-rate schedules (port of ``src/repro/training/schedules.py``).

Includes WSD (warmup-stable-decay) [arXiv:2404.06395] plus cosine and
linear-warmup baselines.  Each maps the optimizer's step (an int tensor)
to an f32 scale in [0, 1] multiplying the peak LR, on the step's device,
in the JAX package's f32 arithmetic.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]


def warmup_cosine(warmup: int, total: int, floor: float = 0.1) -> Schedule:
    def f(step):
        step = step.to(torch.float32)
        warm = step / max(1.0, warmup)
        prog = torch.clamp((step - warmup) / max(1.0, total - warmup),
                           0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return f


def wsd(warmup: int, stable: int, decay: int, floor: float = 0.0
        ) -> Schedule:
    """Warmup-Stable-Decay: linear warmup, flat plateau, then a fast decay
    tail (minicpm uses ~10% of total steps for the decay phase)."""
    def f(step):
        step = step.to(torch.float32)
        warm = step / max(1.0, warmup)
        in_decay = step > warmup + stable
        prog = torch.clamp((step - warmup - stable) / max(1.0, decay),
                           0.0, 1.0)
        tail = 1.0 - (1.0 - floor) * prog
        return torch.where(step < warmup, warm,
                           torch.where(in_decay, tail, torch.ones_like(tail)))
    return f


def constant() -> Schedule:
    return lambda step: torch.ones((), dtype=torch.float32,
                                   device=step.device)
