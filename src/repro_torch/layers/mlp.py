"""SwiGLU and GELU feed-forwards (port of ``src/repro/layers/mlp.py:10-45``;
the SiLU and the GELU are taken in float32).  ``jax.nn.gelu`` defaults to
the tanh approximation, so :func:`gelu_mlp` takes it too."""
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


def init_gelu_mlp(d_model: int, d_ff: int, gen: torch.Generator,
                  dtype: Optional[torch.dtype] = None) -> Params:
    """``w_in`` then ``w_out`` from :func:`dense_init`, drawn from ``gen``
    in that order (cast to ``dtype`` as drawn), and zero biases ``b_in``
    (d_ff,) / ``b_out`` (d_model,)."""
    w_in = dense_init((d_model, d_ff), d_model, gen, dtype)
    w_out = dense_init((d_ff, d_model), d_ff, gen, dtype)
    return {"w_in": w_in, "b_in": torch.zeros(d_ff, dtype=w_in.dtype,
                                              device=w_in.device),
            "w_out": w_out, "b_out": torch.zeros(d_model, dtype=w_in.dtype,
                                                 device=w_in.device)}


def gelu_mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    dtype = x.dtype
    h = torch.einsum("bld,df->blf", x, params["w_in"].to(dtype))
    h = h + params["b_in"].to(dtype)
    h = F.gelu(h.float(), approximate="tanh").to(dtype)
    y = torch.einsum("blf,fd->bld", h, params["w_out"].to(dtype))
    return y + params["b_out"].to(dtype)
