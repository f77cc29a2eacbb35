"""SwiGLU feed-forward (port of ``src/repro/layers/mlp.py:10-25``; the
SiLU is taken in float32)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.layers.common import Params, dense_init


def init_swiglu(d_model: int, d_ff: int, gen: torch.Generator,
                dtype: Optional[torch.dtype] = None) -> Params:
    """``w_gate``, ``w_up``, ``w_down`` from :func:`dense_init`, drawn
    from ``gen`` in that order (cast to ``dtype`` as drawn)."""
    return {"w_gate": dense_init((d_model, d_ff), d_model, gen, dtype),
            "w_up": dense_init((d_model, d_ff), d_model, gen, dtype),
            "w_down": dense_init((d_ff, d_model), d_ff, gen, dtype)}


def swiglu(params: Params, x: torch.Tensor) -> torch.Tensor:
    dtype = x.dtype
    g = torch.einsum("bld,df->blf", x, params["w_gate"].to(dtype))
    u = torch.einsum("bld,df->blf", x, params["w_up"].to(dtype))
    h = F.silu(g.float()).to(dtype) * u
    return torch.einsum("blf,fd->bld", h, params["w_down"].to(dtype))
