"""Shared building blocks: RMSNorm and per-row batch-axis helpers.

Port of ``src/repro/layers/common.py:60-65,99-120``.  Parameters are plain
nested dicts of tensors, as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

Params = Dict[str, Any]


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """RMSNorm computed in float32, returned in x's dtype."""
    orig = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(orig)


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
