"""SwiGLU feed-forward (port of ``src/repro/layers/mlp.py:20-25``; the
SiLU is taken in float32)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.layers.common import Params


def swiglu(params: Params, x: torch.Tensor) -> torch.Tensor:
    dtype = x.dtype
    g = torch.einsum("bld,df->blf", x, params["w_gate"].to(dtype))
    u = torch.einsum("bld,df->blf", x, params["w_up"].to(dtype))
    h = F.silu(g.float()).to(dtype) * u
    return torch.einsum("blf,fd->bld", h, params["w_down"].to(dtype))
