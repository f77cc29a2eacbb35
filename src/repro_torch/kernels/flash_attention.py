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
call.  On request the forward also writes each row's log-sum-exp ``lse``
(B, H, Lq) f32, ``m + log(l + 1e-30)`` as ``xla_flash._fwd`` returns it.

The backward (``csrc/flash_attention_bwd.cu``, the counterpart of
``xla_flash._bwd``) takes q, k, v, the positions, the forward's output
and ``lse`` and the output gradient, and returns dq, dk, dv (dk and dv
summed over each KV head's group of query heads).  Bound by its
operations (five products per attended pair, S and dP recomputed), it
takes three launches a call (delta; dk/dv over key tiles, each block
walking its KV head's G query heads, so no atomics; dq over query
tiles), dead tiles skipped by :func:`tile_live` and its mirror
:func:`query_tile_live`.  bf16 runs FlashAttention-2's backward on
tensor cores (``mma.sync``, 16 rows a warp): the dk/dv pass holds blocks
of 16-64 keys and walks query tiles of 32, the dq pass holds blocks of
16-64 queries and walks key tiles of 64 (32 at head dim 128), both
copying tiles through a three-stage cp.async ring.  Only the products'
operands are bf16 -- P and dS rounded once each -- and every sum is f32,
where ``xla_flash._bwd`` runs the bf16 backward in f32 throughout.  f32 stays exact f32 on the CUDA cores.

Beside each kernel's wrapper sits its plain PyTorch version; only CPU
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
COUNTER_BWD = runtime.counter("flash_attention_bwd")

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 +
             [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 +
                 [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                  ctypes.c_void_p])
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


def query_tile_live(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                    window: int) -> bool:
    """The backward's dk/dv pass skips query tiles by this mirror of
    :func:`tile_live`: whether a query tile with positions ``q_pos``
    (1-D) can hold a query that attends some key of a key tile with
    positions ``k_pos`` (1-D) -- the key tile holds a key not
    ``INVALID_POS``, and some query is at or after the smallest such key
    (causal) and before the largest plus the window (window).  It never
    drops a tile in which a pair is attended."""
    valid = k_pos[k_pos != INVALID_POS]
    if valid.numel() == 0:
        return False
    live = torch.ones_like(q_pos, dtype=torch.bool)
    if causal:
        live = live & (q_pos >= valid.min())
    if window > 0:
        live = live & (q_pos < valid.max() + window)
    return bool(live.any())


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor, softcap: float = 0.0,
                     return_lse: bool = False):
    """Masked-safe GQA softmax attention in f32.  q (B, Lq, H, D); k/v
    (B, Lk, KV, D); mask (B, Lq, Lk) bool.  Fully masked query rows give
    zeros (NEG_INF fill, probabilities forced to 0, +1e-30 denominator).
    Returns (B, Lq, H, D) in q's dtype and, with ``return_lse``, each
    row's ``m + log(l + 1e-30)`` (B, H, Lq) f32."""
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
    l = e.sum(dim=-1, keepdim=True)
    p = e / (l + 1e-30)
    o = torch.einsum("bklgs,bskd->blkgd", p, v.float())
    o = o.reshape(B, Lq, H, D).to(q.dtype)
    if not return_lse:
        return o
    lse = (mx + torch.log(l + 1e-30))[..., 0]            # (B, KV, Lq, G)
    return o, lse.permute(0, 1, 3, 2).reshape(B, H, Lq)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_pos: torch.Tensor, k_pos: torch.Tensor,
                          causal: bool = True, window: int = 0,
                          softcap: float = 0.0, return_lse: bool = False):
    """Plain version of K2 (materialises the scores).  q (B, Lq, H, D);
    k/v (B, Lk, KV, D); q_pos (B, Lq), k_pos (B, Lk) int.  Returns
    (B, Lq, H, D) and, with ``return_lse``, the rows' log-sum-exp
    (B, H, Lq) f32."""
    return masked_attention(q, k, v, position_mask(q_pos, k_pos, causal,
                                                   window), softcap,
                            return_lse)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, q_pos: torch.Tensor,
                              k_pos: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              causal: bool = True, window: int = 0,
                              softcap: float = 0.0):
    """Plain version of K2's backward: ``xla_flash._bwd``'s arithmetic
    step by step from ``lse`` (B, H, Lq) in f32, on the whole score
    matrix (not autograd of the forward).  o/do (B, Lq, H, D).  Returns
    (dq, dk, dv) in q's, k's and v's dtypes, dk and dv summed over each
    KV head's group."""
    B, Lq, H, D = q.shape
    Lk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = D ** -0.5
    qf = q.reshape(B, Lq, KV, G, D).float()
    kf, vf = k.float(), v.float()
    dof = do.reshape(B, Lq, KV, G, D).float()
    s = torch.einsum("blkgd,bskd->bklgs", qf * scale, kf)   # (B,KV,Lq,G,Lk)
    dcap = None
    if softcap > 0.0:
        t = torch.tanh(s / softcap)
        s = t * softcap
        dcap = 1.0 - t * t
    mask = position_mask(q_pos, k_pos, causal, window)[:, None, :, None, :]
    lse_r = lse.reshape(B, KV, G, Lq).permute(0, 1, 3, 2)[..., None]
    p = torch.exp(torch.where(mask, s, torch.full_like(s, NEG_INF)) - lse_r)
    p = torch.where(mask, p, torch.zeros_like(p))
    delta = (dof * o.reshape(B, Lq, KV, G, D).float()).sum(-1)
    delta = delta.permute(0, 2, 1, 3)[..., None]            # (B,KV,Lq,G,1)
    dv = torch.einsum("bklgs,blkgd->bskd", p, dof)
    dp = torch.einsum("blkgd,bskd->bklgs", dof, vf)
    ds = p * (dp - delta)
    if dcap is not None:
        ds = ds * dcap
    dq = torch.einsum("bklgs,bskd->blkgd", ds, kf) * scale
    dk = torch.einsum("bklgs,blkgd->bskd", ds, qf) * scale
    return (dq.reshape(B, Lq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_pos: torch.Tensor, k_pos: torch.Tensor,
                         causal: bool = True, window: int = 0,
                         softcap: float = 0.0, return_lse: bool = False):
    """Launch the CUDA kernel on PyTorch's current stream.  Returns
    (B, Lq, H, D) and, with ``return_lse``, the rows' log-sum-exp
    (B, H, Lq) f32.  Raises on an input the kernel does not take and on
    a failed launch."""
    q, k, v, q_pos, k_pos = _check(q, k, v, q_pos, k_pos,
                                   "flash_attention_cuda")
    B, Lq, H, D = q.shape
    Lk, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    fn = _build.function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
                 k_pos.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(), B, Lq, Lk, H, KV, D,
                 int(bool(causal)), int(window), float(D ** -0.5),
                 float(softcap), _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    COUNTER.kernel += 1
    return out if lse is None else (out, lse)


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, q_pos: torch.Tensor,
                             k_pos: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor,
                             causal: bool = True, window: int = 0,
                             softcap: float = 0.0):
    """Launch K2's backward on PyTorch's current stream (three device
    launches: delta, dk/dv, dq).  Returns (dq, dk, dv) in q's dtype.
    Raises on an input the kernel does not take and on a failed
    launch."""
    q, k, v, q_pos, k_pos = _check(q, k, v, q_pos, k_pos,
                                   "flash_attention_bwd_cuda")
    B, Lq, H, D = q.shape
    Lk, KV = k.shape[1], k.shape[2]
    if not (o.is_cuda and do.is_cuda and lse.is_cuda):
        raise ValueError("flash_attention_bwd_cuda takes CUDA tensors only")
    if o.shape != q.shape or do.shape != q.shape or \
            o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"o / do must match q {tuple(q.shape)} {q.dtype}, "
                         f"got {tuple(o.shape)} {o.dtype} / "
                         f"{tuple(do.shape)} {do.dtype}")
    if lse.shape != (B, H, Lq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be (B, H, Lq) float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    o, lse, do = o.contiguous(), lse.contiguous(), do.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    delta = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    fn = _build.function("flash_attention_bwd", "flash_attention_bwd",
                         _BWD_ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
                 k_pos.data_ptr(), o.data_ptr(), lse.data_ptr(),
                 do.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), B, Lq, Lk, H, KV, D,
                 int(bool(causal)), int(window), float(D ** -0.5),
                 float(softcap), _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: "
                           f"CUDA error {err}")
    COUNTER_BWD.kernel += 1
    return dq, dk, dv


def _check(q, k, v, q_pos, k_pos, name: str):
    """Validate the inputs both kernels take; returns them contiguous,
    the positions as int32."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda and q_pos.is_cuda
            and k_pos.is_cuda):
        raise ValueError(f"{name} takes CUDA tensors only")
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
    return (q.contiguous(), k.contiguous(), v.contiguous(),
            q_pos.to(torch.int32).contiguous(),
            k_pos.to(torch.int32).contiguous())
