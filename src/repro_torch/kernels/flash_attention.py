"""K2: blocked online-softmax attention forward with per-row positions.

Port of ``src/repro/kernels/flash_attention.py``
(``flash_attention_fwd_pallas``) and, on the TConst path, of the
semantics of ``src/repro/kernels/xla_flash.py``.  Masking is positional:
a key is attended iff ``k_pos != INVALID_POS`` and, when ``causal``,
``k_pos <= q_pos`` and, when ``window > 0``, ``k_pos > q_pos - window``.
A query with no valid key gives zeros.  The port's kernel is CUDA C++
(``csrc/flash_attention.cu``): ragged ``Lq``/``Lk``, a runtime window,
and the KV head indexed as ``h // G``; bf16 on tensor cores (``mma.sync``),
f32 in exact f32 on the CUDA cores; key tiles in which no pair of the
block can be attended (:func:`tile_live`) are skipped.  One launch per
call.

Beside the kernel's wrapper sits its plain PyTorch version; only CPU
tensors reach it (the dispatch is :func:`repro_torch.kernels.ops.flash_attention`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import runtime
from repro_torch.kernels import _build

NEG_INF = -2.3819763e38
INVALID_POS = (2 ** 31 - 1) // 2
MAX_HEAD_DIM = 128
COUNTER = runtime.counter("flash_attention")

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 +
             [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def position_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                  window: int) -> torch.Tensor:
    """(B, Lq, Lk) bool: which keys each query attends."""
    kp = k_pos[:, None, :]
    qp = q_pos[:, :, None]
    mask = kp != INVALID_POS
    if causal:
        mask = mask & (kp <= qp)
    if window > 0:
        mask = mask & (kp > qp - window)
    return mask


def tile_live(k_pos: torch.Tensor, q_pos: torch.Tensor, causal: bool,
              window: int) -> bool:
    """The kernel's tile-skip predicate: whether a key tile with positions
    ``k_pos`` (1-D) can hold a key that some query of a block with active
    positions ``q_pos`` (1-D, nonempty) attends -- a key not
    ``INVALID_POS``, at or before the block's largest query position
    (causal), after its smallest minus the window (window).  It may keep a
    tile in which no pair is attended; it never drops one in which a pair
    is."""
    live = k_pos != INVALID_POS
    if causal:
        live = live & (k_pos <= q_pos.max())
    if window > 0:
        live = live & (k_pos > q_pos.min() - window)
    return bool(live.any())


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor, softcap: float = 0.0
                     ) -> torch.Tensor:
    """Masked-safe GQA softmax attention in f32.  q (B, Lq, H, D); k/v
    (B, Lk, KV, D); mask (B, Lq, Lk) bool.  Fully masked query rows give
    zeros (NEG_INF fill, probabilities forced to 0, +1e-30 denominator).
    Returns (B, Lq, H, D) in q's dtype."""
    B, Lq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Lq, KV, G, D).float() * (D ** -0.5)
    s = torch.einsum("blkgd,bskd->bklgs", qg, k.float())   # (B,KV,Lq,G,Lk)
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    mm = mask[:, None, :, None, :]
    s = torch.where(mm, s, torch.full_like(s, NEG_INF))
    mx = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - mx) * mm
    p = e / (e.sum(dim=-1, keepdim=True) + 1e-30)
    o = torch.einsum("bklgs,bskd->blkgd", p, v.float())
    return o.reshape(B, Lq, H, D).to(q.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_pos: torch.Tensor, k_pos: torch.Tensor,
                          causal: bool = True, window: int = 0,
                          softcap: float = 0.0) -> torch.Tensor:
    """Plain version of K2 (materialises the scores).  q (B, Lq, H, D);
    k/v (B, Lk, KV, D); q_pos (B, Lq), k_pos (B, Lk) int.  Returns
    (B, Lq, H, D)."""
    return masked_attention(q, k, v, position_mask(q_pos, k_pos, causal,
                                                   window), softcap)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_pos: torch.Tensor, k_pos: torch.Tensor,
                         causal: bool = True, window: int = 0,
                         softcap: float = 0.0) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream.  Raises on an
    input the kernel does not take and on a failed launch."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda and q_pos.is_cuda
            and k_pos.is_cuda):
        raise ValueError("flash_attention_cuda takes CUDA tensors only")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes matching float32/bfloat16 "
                        f"q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}")
    B, Lq, H, D = q.shape
    if k.ndim != 4 or k.shape[0] != B or k.shape[3] != D or \
            v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    Lk, KV = k.shape[1], k.shape[2]
    if H % KV or D > MAX_HEAD_DIM:
        raise ValueError(f"flash kernel needs H % KV == 0 and head_dim <= "
                         f"{MAX_HEAD_DIM}; got H={H} KV={KV} D={D}")
    if q_pos.shape != (B, Lq) or k_pos.shape != (B, Lk):
        raise ValueError(f"positions must be (B, Lq)/(B, Lk), got "
                         f"{tuple(q_pos.shape)}/{tuple(k_pos.shape)}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    q_pos = q_pos.to(torch.int32).contiguous()
    k_pos = k_pos.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    fn = _build.function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
                 k_pos.data_ptr(), out.data_ptr(), B, Lq, Lk, H, KV, D,
                 int(bool(causal)), int(window), float(D ** -0.5),
                 float(softcap), _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    COUNTER.kernel += 1
    return out
