"""K3: one-query decode attention over a shared page pool.

Port of ``src/repro/kernels/paged_decode_attention.py``
(``paged_decode_attention_pallas``).  The physical cache of a paged field
is a shared pool of fixed-size pages ``(P + 1, page, KV, D)`` (the last
page is the trash page) plus a per-slot int32 page table ``(B, pps)``;
the kernel consumes that representation directly, so nothing materialises
the dense ``(B, max_len, KV, D)`` view on the decode path.  Slots
``[0, valid_len)`` are attended, only the last ``window`` of them when
``window > 0`` (a runtime value, 0 meaning none).  int8 pools come with
``(P + 1, page, KV, 1)`` float32 scale pools, dequantised inside the
kernel as it stages each tile.  Output in q's dtype.

The port's kernel is CUDA C++ (``csrc/paged_decode_attention.cu``): a
split-KV decode whose grid is ``(KV, B, n_split)``.  Each block attends a
run of a row's pages (:func:`split_plan`, from ``pps`` and ``page`` on
the host) and writes an f32 partial (m, l, acc) to a workspace; the last
block of each (row, KV head) merges them -- one launch per call, through
an int32 ticket per (row, KV head) that the wrapper keeps per device.
Float and int8 pools are two entries of the same source, counted apart
(``paged_decode_attention`` / ``paged_decode_attention_int8``).

Beside the kernel's wrapper sits its plain PyTorch version (gather the
row's pages, then attend); only CPU tensors reach it (the dispatch is
:func:`repro_torch.kernels.ops.paged_decode`).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import runtime
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import (
    MAX_GROUP, MAX_HEAD_DIM, MAX_SPLIT, SMEM_LIMIT, THREADS, TILE,
    decode_attention_plain, split_plan, tickets)

COUNTER = runtime.counter("paged_decode_attention")
COUNTER_INT8 = runtime.counter("paged_decode_attention_int8")

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 +
             [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
              ctypes.c_void_p])
_ARGTYPES_INT8 = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 +
                  [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TICKETS = {}            # device -> int32 tickets, zero between calls


def attended_range(valid_len: torch.Tensor, window: int, limit: int
                   ) -> tuple:
    """Per-row ``[lo, hi)`` of the slots attended: ``hi = valid_len``
    (clamped to ``[0, limit]``), ``lo = hi - window`` when ``window > 0``
    (clamped at 0), else 0."""
    hi = valid_len.to(torch.int32).clamp(0, limit)
    lo = (hi - window).clamp(min=0) if window > 0 else torch.zeros_like(hi)
    return lo, hi


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """The rows' pages as a dense (B, pps * page, ...) tensor."""
    B, pps = page_table.shape
    g = pool.index_select(0, page_table.reshape(-1).long())
    return g.reshape((B, pps * pool.shape[1]) + tuple(pool.shape[2:]))


def paged_decode_attention_plain(q: torch.Tensor, pool_k: torch.Tensor,
                                 pool_v: torch.Tensor,
                                 page_table: torch.Tensor,
                                 valid_len: torch.Tensor, softcap: float = 0.0,
                                 window: int = 0,
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Plain version of K3: gather each row's pages into a dense buffer,
    then attend slots ``[lo, hi)`` (:func:`attended_range`) with K1's
    plain version.  q (B, H, D); pools (P + 1, page, KV, D); page_table
    (B, pps) int; valid_len (B,).  Returns (B, H, D) in q's dtype."""
    k = gather_pages(pool_k, page_table)
    v = gather_pages(pool_v, page_table)
    ks = vs = None
    if k_scale is not None:
        ks = gather_pages(k_scale, page_table)
        vs = gather_pages(v_scale, page_table)
    lo, hi = attended_range(valid_len, window, k.shape[1])
    return decode_attention_plain(q, k, v, lo, hi, softcap, ks, vs)


def smem_bytes(H: int, KV: int, D: int) -> int:
    """Shared memory of one launch (mirrors ``smem_bytes`` in
    ``csrc/split_decode.cuh``: q, one tile of K and V rows padded to
    D + 1, its scores, the slot-group sums, m / l / alpha and the merge's
    weights).  It does not depend on the page size or the context."""
    G = H // KV
    sg = max(1, THREADS // (G * D))
    return 4 * (G * D + 2 * TILE * (D + 1) + G * TILE + sg * G * D +
                3 * G + MAX_SPLIT * G)


def paged_decode_attention_cuda(q: torch.Tensor, pool_k: torch.Tensor,
                                pool_v: torch.Tensor,
                                page_table: torch.Tensor,
                                valid_len: torch.Tensor, softcap: float = 0.0,
                                window: int = 0,
                                k_scale: Optional[torch.Tensor] = None,
                                v_scale: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream (the int8 entry
    when scales are given).  Raises on an input the kernel does not take
    and on a failed launch."""
    quant = k_scale is not None
    tensors = [q, pool_k, pool_v, page_table, valid_len] + \
        ([k_scale, v_scale] if quant else [])
    if not all(t.is_cuda for t in tensors):
        raise ValueError("paged_decode_attention_cuda takes CUDA tensors "
                         "only")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    pool_dtype = torch.int8 if quant else q.dtype
    if pool_k.dtype != pool_dtype or pool_v.dtype != pool_dtype:
        raise TypeError(f"pools must be {pool_dtype} with q {q.dtype}"
                        f"{' and scales' if quant else ''}, got "
                        f"{pool_k.dtype}/{pool_v.dtype}")
    B, H, D = q.shape
    if pool_k.ndim != 4 or pool_k.shape[3] != D or \
            pool_v.shape != pool_k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} pools "
                         f"{tuple(pool_k.shape)} / {tuple(pool_v.shape)}")
    page, KV = pool_k.shape[1], pool_k.shape[2]
    if H % KV or H // KV > MAX_GROUP or D > MAX_HEAD_DIM:
        raise ValueError(f"paged kernel needs H % KV == 0, H/KV <= "
                         f"{MAX_GROUP}, head_dim <= {MAX_HEAD_DIM}; got "
                         f"H={H} KV={KV} D={D}")
    if smem_bytes(H, KV, D) > SMEM_LIMIT:
        raise ValueError(f"paged kernel stages a tile of {TILE} slots in "
                         f"shared memory: H/KV={H // KV}, D={D} needs "
                         f"{smem_bytes(H, KV, D)} B > {SMEM_LIMIT} B")
    if page_table.ndim != 2 or page_table.shape[0] != B or \
            valid_len.shape != (B,):
        raise ValueError(f"page_table must be (B, pps) and valid_len (B,), "
                         f"got {tuple(page_table.shape)} / "
                         f"{tuple(valid_len.shape)}")
    if quant:
        scale_shape = pool_k.shape[:3] + (1,)
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32 \
                or k_scale.shape != scale_shape or \
                v_scale.shape != scale_shape:
            raise ValueError(f"scale pools must be float32 of shape "
                             f"{tuple(scale_shape)}")
    pps = page_table.shape[1]
    q, pool_k, pool_v = q.contiguous(), pool_k.contiguous(), \
        pool_v.contiguous()
    pt = page_table.to(torch.int32).contiguous()
    vl = valid_len.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    per, n_split = split_plan(pps, page)
    part = torch.empty((B, KV, n_split, H // KV, D + 2), dtype=torch.float32,
                       device=q.device)
    tk = tickets(_TICKETS, q.device, B * KV)
    ptrs = [q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr()]
    if quant:
        k_scale, v_scale = k_scale.contiguous(), v_scale.contiguous()
        ptrs += [k_scale.data_ptr(), v_scale.data_ptr()]
    symbol = "paged_decode_int8_fwd" if quant else "paged_decode_fwd"
    fn = _build.function("paged_decode_attention", symbol,
                         _ARGTYPES_INT8 if quant else _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(*ptrs, pt.data_ptr(), vl.data_ptr(), out.data_ptr(),
                 part.data_ptr(), tk.data_ptr(), B, H, KV, D, page, pps,
                 per, n_split, float(D ** -0.5), float(softcap), int(window),
                 _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error "
                           f"{err}")
    (COUNTER_INT8 if quant else COUNTER).kernel += 1
    return out
