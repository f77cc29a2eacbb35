"""Shared building blocks: the seeded dense init, parameter placement,
RMSNorm, LayerNorm and per-row batch-axis helpers.

Port of ``src/repro/layers/common.py:28-35,60-84,99-120``.  Parameters are
plain nested dicts of tensors, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def dense_init(shape, fan_in: int, gen: torch.Generator,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Truncated normal in [-2, 2] scaled by 1/sqrt(fan_in) (LeCun normal,
    as the JAX package's ``dense_init``), drawn in float32 from ``gen`` on
    the generator's device, then cast to ``dtype`` (default: kept
    float32)."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    t = t * (1.0 / math.sqrt(max(1, fan_in)))
    return t if dtype is None else t.to(dtype)


def to_device(params: Any, device: Optional[torch.device],
              dtype: Optional[torch.dtype] = None,
              keep: Iterable[str] = ("scale",)) -> Any:
    """Map a nested dict/list of tensors onto ``device`` (and, when
    ``dtype`` is given, cast every tensor to it but those under a key in
    ``keep``, which stay float32 as the layers read them: the norm
    scales by default)."""
    keep = frozenset(keep)

    def go(x, key=""):
        if isinstance(x, dict):
            return {k: go(v, k) for k, v in x.items()}
        if isinstance(x, list):
            return [go(v, key) for v in x]
        if dtype is not None and key not in keep:
            x = x.to(dtype)
        return x if device is None else x.to(device)
    return go(params)


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """RMSNorm computed in float32, returned in x's dtype."""
    orig = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(orig)


def init_layernorm(d: int, device: Optional[torch.device] = None) -> Params:
    """LayerNorm ``scale`` ones and ``bias`` zeros, float32."""
    return {"scale": torch.ones(d, device=device),
            "bias": torch.zeros(d, device=device)}


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    """LayerNorm computed in float32 (biased variance, as JAX's), returned
    in x's dtype: one fused ``layer_norm`` where JAX spells out the mean,
    the variance and the affine map (a few launches a call instead of
    ~11 on the served decode step)."""
    return F.layer_norm(x.float(), x.shape[-1:], params["scale"].float(),
                        params["bias"].float(), eps).to(x.dtype)


def _row_shape(rows: torch.Tensor, ndim: int, axis: int):
    shape = [1] * ndim
    shape[axis] = rows.shape[0]
    return shape


def where_rows(rows: torch.Tensor, new: torch.Tensor, old: torch.Tensor,
               axis: int) -> torch.Tensor:
    """Per-row select along a batch axis: ``new`` where ``rows`` (B,) is
    True, else ``old``."""
    return torch.where(rows.reshape(_row_shape(rows, new.ndim, axis)),
                       new, old)


def take_rows(arr: torch.Tensor, idx: torch.Tensor, axis: int
              ) -> torch.Tensor:
    """Gather rows ``idx`` along a batch axis."""
    return arr.index_select(axis, idx)


def put_rows(arr: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
             axis: int) -> torch.Tensor:
    """Scatter rows ``vals`` into ``idx`` along a batch axis, IN PLACE
    (the port updates caches in place; returns ``arr``)."""
    return arr.index_copy_(axis, idx, vals.to(arr.dtype))
