"""Kernel dispatch: every attention and SSD scan of the port goes through
here.

A CUDA tensor launches the hand-written kernel (or the wrapper raises);
a CPU tensor takes the kernel's plain PyTorch version.  There is no
switch that sends CUDA tensors to the plain versions and no fallback
from a failed launch.  Every kernel counts its launches, the int8
variants apart from the float ones (``repro_torch.runtime``).

K2 is differentiable: with autograd on and an input that requires grad,
:func:`flash_attention` runs through :class:`FlashAttention` (the
``jax.custom_vjp`` of ``xla_flash.flash_attention``), whose forward also
returns the rows' log-sum-exp and whose backward is K2's backward kernel
(CUDA tensors) or its plain version (CPU tensors).  So is K4:
:func:`ssd_scan` runs through :class:`SSDScan`, whose forward on the card
also saves the state entering each chunk and whose backward is K4's
backward kernel (CUDA tensors) or autograd through the plain forward at
JAX's chunk (CPU tensors), the gradient JAX's ``value_and_grad`` takes
through ``ssd_chunked``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import paged_decode_attention as PD
from repro_torch.kernels import ssd_scan as SS
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


def decode_attention_int8(q: torch.Tensor, kq: torch.Tensor,
                          vq: torch.Tensor, k_scale: torch.Tensor,
                          v_scale: torch.Tensor, lo: torch.Tensor,
                          hi: torch.Tensor, softcap: float = 0.0
                          ) -> torch.Tensor:
    """K1's int8 variant.  kq/vq int8 (B, S, KV, D) with (B, S, KV, 1)
    float32 scales, dequantised inside the kernel; slots ``[lo, hi)``.
    Returns (B, H, D) in q's dtype."""
    if q.is_cuda:
        return DA.decode_attention_int8_cuda(q, kq, vq, k_scale, v_scale,
                                             lo, hi, softcap)
    _plain_device(q, "decode_attention_int8")
    DA.COUNTER_INT8.plain += 1
    return DA.decode_attention_plain(q, kq, vq, lo, hi, softcap, k_scale,
                                     v_scale)


def paged_decode(q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
                 page_table: torch.Tensor, valid_len: torch.Tensor, *,
                 softcap: float = 0.0, window: int = 0,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3.  q (B, H, D); pools (P + 1, page, KV, D) (int8 with
    (P + 1, page, KV, 1) float32 scale pools); page_table (B, pps);
    slots ``[0, valid_len)``, the last ``window`` of them when
    ``window > 0``.  Returns (B, H, D) in q's dtype."""
    if q.is_cuda:
        return PD.paged_decode_attention_cuda(q, pool_k, pool_v, page_table,
                                              valid_len, softcap, window,
                                              k_scale, v_scale)
    _plain_device(q, "paged_decode")
    (PD.COUNTER if k_scale is None else PD.COUNTER_INT8).plain += 1
    return PD.paged_decode_attention_plain(q, pool_k, pool_v, page_table,
                                           valid_len, softcap, window,
                                           k_scale, v_scale)


class FlashAttention(torch.autograd.Function):
    """K2 with its backward: the forward saves q, k, v, the positions, its
    output and the rows' log-sum-exp; the backward returns dq, dk, dv (dk
    and dv summed over each KV head's group)."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, causal, window, softcap):
        if q.is_cuda:
            o, lse = FA.flash_attention_cuda(q, k, v, q_pos, k_pos, causal,
                                             window, softcap, return_lse=True)
        else:
            _plain_device(q, "flash_attention")
            FA.COUNTER.plain += 1
            o, lse = FA.flash_attention_plain(q, k, v, q_pos, k_pos, causal,
                                              window, softcap,
                                              return_lse=True)
        ctx.save_for_backward(q, k, v, q_pos, k_pos, o, lse)
        ctx.flags = (causal, window, softcap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_pos, k_pos, o, lse = ctx.saved_tensors
        if q.is_cuda:
            dq, dk, dv = FA.flash_attention_bwd_cuda(q, k, v, q_pos, k_pos, o,
                                                     lse, do, *ctx.flags)
        else:
            _plain_device(q, "flash_attention_bwd")
            FA.COUNTER_BWD.plain += 1
            dq, dk, dv = FA.flash_attention_bwd_plain(q, k, v, q_pos, k_pos,
                                                      o, lse, do, *ctx.flags)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, k_pos: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """K2.  q (B, Lq, H, D); k/v (B, Lk, KV, D); q_pos (B, Lq), k_pos
    (B, Lk) with ``INVALID_POS`` marking dead keys.  Returns
    (B, Lq, H, D); differentiable in q, k, v (:class:`FlashAttention`)
    when autograd is on and one of them requires grad."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or
                                    v.requires_grad):
        return FlashAttention.apply(q, k, v, q_pos, k_pos, causal, window,
                                    softcap)
    if q.is_cuda:
        return FA.flash_attention_cuda(q, k, v, q_pos, k_pos, causal,
                                       window, softcap)
    _plain_device(q, "flash_attention")
    FA.COUNTER.plain += 1
    return FA.flash_attention_plain(q, k, v, q_pos, k_pos, causal, window,
                                    softcap)


def prefill_chunk_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, q_pos: torch.Tensor,
                            k_pos: torch.Tensor, window: int = 0,
                            softcap: float = 0.0) -> torch.Tensor:
    """K2 on one chunk of a chunked admission: the chunk's C queries at
    positions ``q_pos`` (B, C) = ``[start, start + C)`` against the slot's
    row cache, causal, with the layer's ``window``.  q (B, C, H, D);
    k/v (B, S, KV, D) at positions ``k_pos`` (B, S).

    The port's caller passes the row's keys ``[0, start + C)`` (the
    resident prefix, the earlier chunks and this one), where JAX's passes
    the whole ``max_len`` row: every key past them lies after every
    query's position, so it is causally dead and the result is the same;
    K2 reads only the live keys.  JAX takes masked ``sdpa`` below
    ``PREFILL_CHUNK_FLASH_ELEMS`` scores and its blocked flash above;
    the port runs K2 at every size (both compute this function).  No
    mesh scope: ROADMAP Queue 1 item 12.  Returns (B, C, H, D)."""
    return flash_attention(q, k, v, q_pos, k_pos, causal=True,
                           window=window, softcap=softcap)


class SSDScan(torch.autograd.Function):
    """K4 with its backward: on the card the forward saves its inputs and
    the state entering each chunk (``ssd_scan_train_cuda``) and the
    backward launches K4's backward kernel; on the CPU the backward is
    autograd through the plain forward at JAX's chunk.  Returns dx, ddt,
    da, db, dc and, with an ``init_state``, its gradient."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, chunk, init_state):
        entry = None
        if x.is_cuda:
            y, final, entry = SS.ssd_scan_train_cuda(x, dt, a, b, c, chunk,
                                                     init_state)
        else:
            y, final = SS.ssd_scan(x, dt, a, b, c, chunk, init_state)
        ctx.save_for_backward(x, dt, a, b, c, init_state, entry)
        ctx.chunk = chunk
        # an output nothing reads gets None, not a zero tensor (the
        # trainer never reads the final state)
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, a, b, c, init_state, entry = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        if x.is_cuda:
            grads = SS.ssd_scan_bwd_cuda(x, dt, a, b, c, ctx.chunk, entry,
                                         dy, dfinal)
        else:
            _plain_device(x, "ssd_scan_bwd")
            SS.COUNTER_BWD.plain += 1
            grads = SS.ssd_scan_bwd_plain(x, dt, a, b, c, ctx.chunk,
                                          init_state, dy, dfinal)
        dx, ddt, da, db, dc, dinit = grads
        return dx, ddt, da, db, dc, None, \
            None if init_state is None else dinit


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 (both entries: the intra-chunk block and the chunk scan).  x
    (Bt, L, H, P); dt (Bt, L, H); a (H,); b/c (Bt, L, N); init_state
    (Bt, H, P, N) or None; ``chunk`` the model's ``ssm_chunk`` (the card
    tiles at it with a ragged last chunk, the CPU path halves it until it
    divides L).  Returns (y (Bt, L, H, P), final state (Bt, H, P, N) f32)
    -- ``ssd_chunked``'s result; differentiable (:class:`SSDScan`) when
    autograd is on and an input requires grad."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, a, b, c, init_state)):
        return SSDScan.apply(x, dt, a, b, c, chunk, init_state)
    return SS.ssd_scan(x, dt, a, b, c, chunk, init_state)
