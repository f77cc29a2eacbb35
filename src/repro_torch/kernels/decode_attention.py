"""K1: one-query decode attention over a constant-size KV buffer.

Port of ``src/repro/kernels/decode_attention.py`` (``decode_attention_pallas``,
the TPU kernel of the O(1) cache-hit step, paper Eq. 5).  The port's
kernel is CUDA C++ (``csrc/decode_attention.cu``); it takes a per-row
slot range ``[lo, hi)`` instead of ``valid_len``/``window``, so one kernel
serves the generation-window self-attention (``[0, gen_len + 1)``) and the
compressed-context cross-attention (the valid context slots are a suffix
``[W_oh - n_valid, W_oh)``).

It is a split-KV decode whose grid is ``(KV, B, n_split)``: each block
attends a run of a row's slots (:func:`split_plan`, from ``S`` alone on
the host) and writes an f32 partial (m, l, acc) to a workspace; the last
block of each (row, KV head) merges them -- one launch per call, through
an int32 ticket per (row, KV head) that the wrapper keeps per device.
The int8 variant (``decode_attention_int8_cuda``, a second entry of the
same source) reads int8 K/V with ``(B, S, KV, 1)`` float32 per-vector
scales and dequantises each tile as it stages it -- the counterpart of
``decode_attention_pallas(k_scale=..., v_scale=...)`` for the int8 cache
layouts.  Its launches are counted apart (``decode_attention_int8``).

Beside the kernel's wrappers sits its plain PyTorch version; only CPU
tensors reach it (the dispatch is :mod:`repro_torch.kernels.ops`).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch import runtime
from repro_torch.kernels import _build

NEG_INF = -2.3819763e38
MAX_GROUP = 8            # query heads per KV head the kernel holds
MAX_HEAD_DIM = 256
# bytes of dynamic shared memory a block may use on Hopper (the kernels
# raise their own limit above the default 48 KB)
SMEM_LIMIT = 232448
COUNTER = runtime.counter("decode_attention")
COUNTER_INT8 = runtime.counter("decode_attention_int8")
# csrc/split_decode.cuh's kThreads, kTile and kMaxSplit (K1 and K3)
THREADS = 128            # the kernel's threads per block
TILE = 64                # slots it stages at a time
MAX_SPLIT = 64           # runs per row (its merge holds 64 weights)

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 +
             [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_ARGTYPES_INT8 = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 +
                  [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                   ctypes.c_void_p])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TICKETS: Dict[torch.device, torch.Tensor] = {}   # zero between calls


def split_plan(n: int, unit: int) -> tuple:
    """``(units_per_split, n_split)``: how a split decode divides a row of
    ``n`` units of ``unit`` slots (K3: pages; K1: ``split_plan(S, 1)``,
    slots) across blocks.  A run holds at least 64 slots and a row at most
    ``MAX_SPLIT`` runs; the plan reads shapes only, never the attended
    range (a device value), so no call synchronises."""
    per = max(-(-TILE // unit), -(-n // MAX_SPLIT), 1)
    return per, max(-(-n // per), 1)


def tickets(store: Dict[torch.device, torch.Tensor], device: torch.device,
            n: int) -> torch.Tensor:
    """A split decode's ticket buffer on ``device`` (kept in ``store``, one
    per kernel), at least ``n`` entries, zeroed once when it is made (the
    kernel's merging block resets each ticket it used)."""
    t = store.get(device)
    if t is None or t.numel() < n:
        t = store[device] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                        device=device)
    return t


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lo: torch.Tensor, hi: torch.Tensor,
                           softcap: float = 0.0,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """q (B, H, D); k/v (B, S, KV, D); lo/hi (B,) int.  Slots
    ``lo <= s < hi`` are attended; an empty range gives zeros.  int8 k/v
    come with (B, S, KV, 1) float32 scales (dequantised in f32).  f32
    arithmetic, output in q's dtype.  Returns (B, H, D)."""
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf, vf = kf * k_scale, vf * v_scale
    qg = q.reshape(B, KV, G, D).float() * (D ** -0.5)
    s = torch.einsum("bkgd,bskd->bkgs", qg, kf)
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    slot = torch.arange(S, device=q.device)[None]
    valid = (slot >= lo[:, None]) & (slot < hi[:, None])       # (B, S)
    mm = valid[:, None, None, :]
    s = torch.where(mm, s, torch.full_like(s, NEG_INF))
    mx = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - mx) * mm
    p = e / (e.sum(dim=-1, keepdim=True) + 1e-30)
    o = torch.einsum("bkgs,bskd->bkgd", p, vf)
    return o.reshape(B, H, D).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           lo: torch.Tensor, hi: torch.Tensor, what: str) -> None:
    if not (q.is_cuda and k.is_cuda and v.is_cuda and lo.is_cuda
            and hi.is_cuda):
        raise ValueError(f"{what} takes CUDA tensors only")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{what}: q must be float32 or bfloat16, got "
                        f"{q.dtype}")
    B, H, D = q.shape
    if k.ndim != 4 or k.shape[0] != B or k.shape[3] != D or \
            v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    KV = k.shape[2]
    if H % KV or H // KV > MAX_GROUP or D > MAX_HEAD_DIM:
        raise ValueError(f"decode kernel needs H % KV == 0, H/KV <= "
                         f"{MAX_GROUP}, head_dim <= {MAX_HEAD_DIM}; got "
                         f"H={H} KV={KV} D={D}")
    if lo.shape != (B,) or hi.shape != (B,):
        raise ValueError("lo/hi must be (B,)")


def _launch(symbol: str, argtypes, ptrs, q: torch.Tensor, S: int, KV: int,
            softcap: float) -> torch.Tensor:
    B, H, D = q.shape
    out = torch.empty_like(q)
    split, n_split = split_plan(S, 1)
    part = torch.empty((B, KV, n_split, H // KV, D + 2), dtype=torch.float32,
                       device=q.device)
    tk = tickets(_TICKETS, q.device, B * KV)
    fn = _build.function("decode_attention", symbol, argtypes)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(*ptrs, out.data_ptr(), part.data_ptr(), tk.data_ptr(), B, S,
                 H, KV, D, split, n_split, float(D ** -0.5), float(softcap),
                 _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error "
                           f"{err}")
    return out


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lo: torch.Tensor, hi: torch.Tensor,
                          softcap: float = 0.0) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream.  Raises on an
    input the kernel does not take and on a failed launch."""
    _check(q, k, v, lo, hi, "decode_attention_cuda")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode attention takes matching float32/bfloat16 "
                        f"q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lo = lo.to(torch.int32).contiguous()
    hi = hi.to(torch.int32).contiguous()
    out = _launch("decode_attention_fwd", _ARGTYPES,
                  (q.data_ptr(), k.data_ptr(), v.data_ptr(), lo.data_ptr(),
                   hi.data_ptr()), q, k.shape[1], k.shape[2], softcap)
    COUNTER.kernel += 1
    return out


def decode_attention_int8_cuda(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, k_scale: torch.Tensor,
                               v_scale: torch.Tensor, lo: torch.Tensor,
                               hi: torch.Tensor, softcap: float = 0.0
                               ) -> torch.Tensor:
    """Launch the int8 variant: k/v int8 (B, S, KV, D) with (B, S, KV, 1)
    float32 scales.  Raises on an input it does not take and on a failed
    launch."""
    _check(q, k, v, lo, hi, "decode_attention_int8_cuda")
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise TypeError(f"the int8 variant takes int8 k/v, got "
                        f"{k.dtype}/{v.dtype}")
    scale_shape = k.shape[:3] + (1,)
    if not (k_scale.is_cuda and v_scale.is_cuda) or \
            k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32 \
            or k_scale.shape != scale_shape or v_scale.shape != scale_shape:
        raise ValueError(f"scales must be float32 CUDA tensors of shape "
                         f"{tuple(scale_shape)}, got {tuple(k_scale.shape)} "
                         f"{k_scale.dtype} / {tuple(v_scale.shape)} "
                         f"{v_scale.dtype}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    k_scale, v_scale = k_scale.contiguous(), v_scale.contiguous()
    lo = lo.to(torch.int32).contiguous()
    hi = hi.to(torch.int32).contiguous()
    out = _launch("decode_attention_int8_fwd", _ARGTYPES_INT8,
                  (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   k_scale.data_ptr(), v_scale.data_ptr(), lo.data_ptr(),
                   hi.data_ptr()), q, k.shape[1], k.shape[2], softcap)
    COUNTER_INT8.kernel += 1
    return out
