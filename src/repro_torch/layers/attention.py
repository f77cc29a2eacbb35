"""Grouped-query attention for the TConst paths, the dense LM and the
enc-dec.

Port of ``src/repro/layers/attention.py`` (projections, ``make_mask``,
the masked-safe ``sdpa``, ``attention_block`` with or without RoPE,
``cross_attend_cached`` and the KVView decode / cross attends).  Every
attention the model runs goes through :mod:`repro_torch.kernels.ops`:
multi-query attention is K2 (flash, positional masks); one-query decode
attention is K1 over a per-row ``[lo, hi)`` slot range on dense views,
K1's int8 variant on int8 views and K3 on paged views (a sliding
window: K3's ``window``, K1's ``lo``).  ``sdpa`` with a
boolean mask is kept as the plain reference of the JAX function and
takes CPU tensors only.

Weights keep the JAX layouts: ``wq`` (d, H, hd), ``wk``/``wv``
(d, KV, hd), ``wo`` (H, hd, d).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import masked_attention
from repro_torch.layers.common import Params, dense_init
from repro_torch.layers.rope import apply_rope
from repro_torch.models import layouts as LT

NEG_INF = -2.3819763e38


def init_attention(cfg: ModelConfig, gen: torch.Generator,
                   dtype: Optional[torch.dtype] = None) -> Params:
    """``wq``, ``wk``, ``wv``, ``wo`` from :func:`dense_init`, drawn from
    ``gen`` in that order, cast to ``dtype`` as drawn (the port's own
    init)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    return {"wq": dense_init((d, H, hd), d, gen, dtype),
            "wk": dense_init((d, KV, hd), d, gen, dtype),
            "wv": dense_init((d, KV, hd), d, gen, dtype),
            "wo": dense_init((H, hd, d), H * hd, gen, dtype)}


def qkv_proj(params: Params, xq: torch.Tensor, xkv: torch.Tensor,
             dtype: torch.dtype
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = torch.einsum("bld,dhk->blhk", xq, params["wq"].to(dtype))
    k = torch.einsum("bsd,dhk->bshk", xkv, params["wk"].to(dtype))
    v = torch.einsum("bsd,dhk->bshk", xkv, params["wv"].to(dtype))
    return q, k, v


def q_proj(params: Params, x: torch.Tensor, dtype: torch.dtype
           ) -> torch.Tensor:
    return torch.einsum("bld,dhk->blhk", x, params["wq"].to(dtype))


def out_proj(params: Params, o: torch.Tensor, dtype: torch.dtype
             ) -> torch.Tensor:
    return torch.einsum("blhk,hkd->bld", o, params["wo"].to(dtype))


def project_kv(params: Params, x: torch.Tensor,
               cos: Optional[torch.Tensor] = None,
               sin: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project (and RoPE) K/V for caching. x (B, S, d) -> (B, S, KV, D)."""
    dtype = x.dtype
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(dtype))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(dtype))
    if cos is not None:
        k = apply_rope(k, cos, sin)
    return k, v


def make_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, mode: str,
              window: int = 0) -> Optional[torch.Tensor]:
    """Boolean (..., Lq, Lk) mask, True = attend.  mode: causal | sliding
    | full (None)."""
    if mode == "full":
        return None
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    mask = kp <= qp
    if mode == "sliding":
        weff = window if window > 0 else 2 ** 30
        mask = mask & (kp > qp - weff)
    elif mode != "causal":
        raise ValueError(mode)
    return mask


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: Optional[torch.Tensor] = None, logit_softcap: float = 0.0,
         kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain masked-safe attention with a boolean mask (B?, Lq, Lk) and/or
    ``kv_valid`` (B, Lk); fully masked rows give zeros.  CPU tensors only:
    the model's attention runs through :mod:`repro_torch.kernels.ops`."""
    if q.device.type != "cpu":
        raise ValueError("sdpa is the plain reference (CPU only); CUDA "
                         "attention goes through repro_torch.kernels.ops")
    B, Lq = q.shape[:2]
    Lk = k.shape[1]
    cm = torch.ones((B, Lq, Lk), dtype=torch.bool)
    if mask is not None:
        cm = cm & (mask if mask.ndim == 3 else mask[None])
    if kv_valid is not None:
        cm = cm & kv_valid[:, None, :]
    return masked_attention(q, k, v, cm, logit_softcap)


def attention_block(params: Params, xq: torch.Tensor, xkv: torch.Tensor,
                    q_pos: torch.Tensor, k_pos: torch.Tensor,
                    cos_q: Optional[torch.Tensor] = None,
                    sin_q: Optional[torch.Tensor] = None,
                    cos_k: Optional[torch.Tensor] = None,
                    sin_k: Optional[torch.Tensor] = None,
                    logit_softcap: float = 0.0,
                    causal: bool = True) -> torch.Tensor:
    """Projected multi-query attention (K2): q/k RoPE'd where their
    cos/sin are given (the encoder and the cross-attention of the
    enc-dec have none), a key attended iff ``k_pos != INVALID_POS`` and
    (causal) ``k_pos <= q_pos``."""
    dtype = xq.dtype
    q, k, v = qkv_proj(params, xq, xkv, dtype)
    if cos_q is not None:
        q = apply_rope(q, cos_q, sin_q)
    if cos_k is not None:
        k = apply_rope(k, cos_k, sin_k)
    o = ops.flash_attention(q, k, v, q_pos, k_pos, causal=causal,
                            softcap=logit_softcap)
    return out_proj(params, o, dtype)


def cross_attend_cached(params: Params, x: torch.Tensor,
                        k_cache: torch.Tensor, v_cache: torch.Tensor
                        ) -> torch.Tensor:
    """Multi-query cross-attention of x (B, Lq, d) to pre-projected K/V
    (B, S, KV, D) with no RoPE and no mask: the enc-dec decoder reading
    its encoder memory (K2, not causal, every key live).  The query is
    projected with this block's own ``wq``."""
    dtype = x.dtype
    B, Lq = x.shape[:2]
    S = k_cache.shape[1]
    q = q_proj(params, x, dtype)
    q_pos = torch.arange(Lq, dtype=torch.int32, device=x.device)
    k_pos = torch.arange(S, dtype=torch.int32, device=x.device)
    o = ops.flash_attention(q, k_cache.to(dtype), v_cache.to(dtype),
                            q_pos[None].expand(B, Lq),
                            k_pos[None].expand(B, S), causal=False)
    return out_proj(params, o, dtype)


def _attend_views(q: torch.Tensor, k_view, v_view,
                  lo: Optional[torch.Tensor], hi: torch.Tensor,
                  logit_softcap: float = 0.0, window: int = 0
                  ) -> torch.Tensor:
    """One-query attention over a per-layer KVView pair
    (``repro_torch.models.layouts``), in its PHYSICAL representation:

    * :class:`~repro_torch.models.layouts.PagedView` -- K3 walks the page
      table (int8 pools: its int8 entry).  Needs a prefix range
      (``lo`` None, slots ``[0, hi)``), the last ``window`` of them when
      ``window > 0``.
    * :class:`~repro_torch.models.layouts.QuantView` -- K1's int8 variant
      over ``[lo, hi)``.  (The JAX package sends a ``kv_valid``-masked
      cross-attention to dequantise-then-``sdpa``; here the valid context
      slots are a suffix, so the ``[lo, hi)`` range is exact.)
    * :class:`~repro_torch.models.layouts.DenseView` -- K1 over
      ``[lo, hi)``.

    On the last two a ``window > 0`` raises ``lo`` to ``hi - window``:
    the same slots K3 attends, JAX's ``kv_valid`` of a sliding window.
    q (B, H, D) RoPE'd; lo/hi (B,) int (``lo`` None means 0).  Returns
    (B, H, D)."""
    dtype = q.dtype
    if isinstance(k_view, LT.PagedView):
        if lo is not None:
            raise ValueError("paged attention takes a prefix range [0, hi)")
        if k_view.quant:
            return ops.paged_decode(
                q, k_view.storage.q, v_view.storage.q, k_view.page_table, hi,
                softcap=logit_softcap, window=window,
                k_scale=k_view.storage.scale, v_scale=v_view.storage.scale)
        return ops.paged_decode(
            q, k_view.storage.data.to(dtype), v_view.storage.data.to(dtype),
            k_view.page_table, hi, softcap=logit_softcap, window=window)
    if lo is None:
        lo = torch.zeros_like(hi)
    if window > 0:
        lo = torch.maximum(lo, hi - window)
    if isinstance(k_view, LT.QuantView):
        return ops.decode_attention_int8(q, k_view.q, v_view.q, k_view.scale,
                                         v_view.scale, lo, hi, logit_softcap)
    return ops.decode_attention(q, k_view.data.to(dtype),
                                v_view.data.to(dtype), lo, hi, logit_softcap)


def decode_attend_view(params: Params, x: torch.Tensor, k_view, v_view,
                       slot: torch.Tensor, write: torch.Tensor,
                       lo: Optional[torch.Tensor], hi: torch.Tensor,
                       cos_q: torch.Tensor, sin_q: torch.Tensor,
                       logit_softcap: float = 0.0, window: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token decode self-attention over a per-layer KVView pair.
    Projects q/k/v for the new token and writes k/v THROUGH THE VIEWS at
    ``slot`` (IN PLACE; int8: quantized; paged: only the owning page) in
    rows where ``write`` is True -- before attending, so the new token is
    attended in its stored representation, as in the JAX package.  Other
    rows' entries are rewritten with their own values and come through
    bit-identical.  Attends slots ``[lo, hi)``, the last ``window`` of
    them when ``window > 0``.  Returns (out (B, 1, d), the RoPE'd query
    (B, 1, H, D) for the cross-attention)."""
    dtype = x.dtype
    q, k_new, v_new = qkv_proj(params, x, x, dtype)
    q = apply_rope(q, cos_q, sin_q)
    k_new = apply_rope(k_new, cos_q, sin_q)
    k_view.write_token(slot, k_new[:, 0], write)
    v_view.write_token(slot, v_new[:, 0], write)
    o = _attend_views(q[:, 0], k_view, v_view, lo, hi, logit_softcap,
                      window)
    return out_proj(params, o[:, None], dtype), q


def cross_attend_view(params: Params, q: torch.Tensor, k_view, v_view,
                      lo: Optional[torch.Tensor], hi: torch.Tensor,
                      logit_softcap: float = 0.0) -> torch.Tensor:
    """One-token cross-attention of RoPE'd queries q (B, 1, H, D) to
    cached, already RoPE'd K/V read through a KVView pair, slots
    ``[lo, hi)`` (``lo`` None: ``[0, hi)``, required for paged views)."""
    dtype = q.dtype
    o = _attend_views(q[:, 0], k_view, v_view, lo, hi, logit_softcap)
    return out_proj(params, o[:, None], dtype)
