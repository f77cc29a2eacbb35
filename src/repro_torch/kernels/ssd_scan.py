"""K4: the Mamba-2 SSD scan (state-space duality).

Port of ``src/repro/kernels/ssd_scan.py``: ``ssd_intra_chunk_pallas``
(the TPU kernel: per (batch, head, chunk) the cumulative log-decay, the
decay-masked ``C . B^T`` scores times ``xdt`` and the chunk-end state)
and its wrapper ``ssd_scan_pallas``, whose inter-chunk recurrence the JAX
package runs as a ``jax.lax.scan`` in XLA.  The port's kernels are CUDA
C++ (``csrc/ssd_scan.cu``), two launches counted apart:

* ``ssd_intra_chunk`` -- the Pallas kernel's function, parallel over
  chunks: ``y_intra`` and each chunk's end state;
* ``ssd_chunk_scan`` -- the wrapper's scan over chunks, sequential inside
  the kernel: ``y = y_intra + y_inter`` and the final state, the running
  state kept on chip.

On the card the rows are tiled at the model's ``ssm_chunk`` for ANY
length L: the last chunk holds the ``L - (nc - 1) Q`` rows left (the
exact SSD identity on a ragged partition; nothing is padded).  The
kernels read x, dt, b, c in their natural layouts and dtypes and write y
in x's dtype.  :func:`ssd_scan_tiled_plain` (with its two halves) is the
plain mirror of that tiling, the one the kernels are held against.

On the CPU :func:`ssd_scan` keeps the JAX mixer's rule -- the chunk
``min(chunk, L)`` halved until it divides L -- and runs the plain
versions ``ssd_intra_chunk_plain`` / ``ssd_chunk_scan_plain`` on the
``(B, H, nc, Q, P)`` layout of the Pallas kernel, so the CPU path sums in
JAX's order.  Only CPU tensors reach a plain version: a CUDA tensor
launches both kernels or the wrapper raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch import runtime
from repro_torch.kernels import _build

MAX_Q, MAX_P, MAX_N = 64, 64, 128      # the kernels' runtime limits
COUNTER_INTRA = runtime.counter("ssd_intra_chunk")
COUNTER_SCAN = runtime.counter("ssd_chunk_scan")
DTYPES = (torch.float32, torch.bfloat16)     # x, b and c on the card

_LL = ctypes.c_longlong
_INTRA_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [_LL] * 6 + \
    [ctypes.c_int, ctypes.c_void_p]
_SCAN_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [_LL] * 2 + \
    [ctypes.c_int, ctypes.c_void_p]


def jax_chunk(chunk: int, L: int) -> int:
    """The JAX mixer's chunk rule: ``min(chunk, L)`` halved until it
    divides L (``src/repro/layers/ssm.py``)."""
    q = min(chunk, L)
    while L % q:
        q //= 2
    return max(1, q)


# ---------------------------------------------------------------------------
# plain PyTorch versions: the Pallas layout (the CPU path)
# ---------------------------------------------------------------------------


def ssd_intra_chunk_plain(xdt: torch.Tensor, da: torch.Tensor,
                          b: torch.Tensor, c: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batched form of ``ref.ssd_chunk_reference``.  xdt (B, H, nc, Q,
    P) dt-scaled inputs; da (B, H, nc, Q) log-decays; b, c (B, nc, Q, N)
    (one group, shared by the heads), all f32.  Returns (y_intra (B, H,
    nc, Q, P), states (B, H, nc, P, N))."""
    Q = xdt.shape[3]
    cs = da.cumsum(dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]                 # (.., Q, Q)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=xdt.device).tril()
    # masked before the exponential: exp(cs_l - cs_s) overflows for s > l
    decay = torch.exp(torch.where(tri, diff, float("-inf")))
    scores = torch.einsum("bnlm,bnsm->bnls", c, b)
    y = torch.einsum("bnls,bhnls,bhnsp->bhnlp", scores, decay, xdt)
    decay_end = torch.exp(cs[..., -1:] - cs)                   # (.., Q)
    states = torch.einsum("bhnsp,bnsm,bhns->bhnpm", xdt, b, decay_end)
    return y, states


def ssd_chunk_scan_plain(y_intra: torch.Tensor, states: torch.Tensor,
                         da: torch.Tensor, c: torch.Tensor,
                         init_state: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The loop the JAX wrapper scans.  y_intra (B, H, nc, Q, P); states
    (B, H, nc, P, N); da (B, H, nc, Q); c (B, nc, Q, N); init_state
    (B, H, P, N) or None (zeros).  Returns (y = y_intra + y_inter (B, H,
    nc, Q, P), the final state (B, H, P, N))."""
    B, H, nc, Q, P = y_intra.shape
    N = c.shape[-1]
    chunk_decay = torch.exp(da.sum(dim=-1))                    # (B, H, nc)
    from_start = torch.exp(da.cumsum(dim=-1))                  # (B, H, nc, Q)
    prev = init_state.float() if init_state is not None else \
        torch.zeros((B, H, P, N), dtype=torch.float32, device=c.device)
    y = torch.empty_like(y_intra)
    for n in range(nc):
        y[:, :, n] = y_intra[:, :, n] + torch.einsum(
            "blm,bhl,bhpm->bhlp", c[:, n], from_start[:, :, n], prev)
        prev = prev * chunk_decay[:, :, n, None, None] + states[:, :, n]
    return y, prev


def prepare(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor, c: torch.Tensor, chunk: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor]:
    """The Pallas wrapper's elementwise preparation (plain ops, f32): x
    (Bt, L, H, P), dt (Bt, L, H), a (H,), b/c (Bt, L, N) -> (xdt (Bt, H,
    nc, Q, P), da (Bt, H, nc, Q), b, c (Bt, nc, Q, N)); L a multiple of
    ``chunk``."""
    Bt, L, H, P = x.shape
    N = b.shape[-1]
    if L % chunk:
        raise ValueError(f"sequence length {L} is not a multiple of the "
                         f"chunk {chunk}")
    nc = L // chunk
    dtf = dt.float()
    da = (dtf * a.float()[None, None, :]).reshape(Bt, nc, chunk, H)
    da = da.permute(0, 3, 1, 2).contiguous()
    xdt = (x.float() * dtf[..., None]).reshape(Bt, nc, chunk, H, P)
    xdt = xdt.permute(0, 3, 1, 2, 4).contiguous()
    bc = b.float().reshape(Bt, nc, chunk, N).contiguous()
    cc = c.float().reshape(Bt, nc, chunk, N).contiguous()
    return xdt, da, bc, cc


# ---------------------------------------------------------------------------
# plain mirror of the card's ragged tiling (natural layouts)
# ---------------------------------------------------------------------------


def _chunk_rows(L: int, chunk: int):
    """(n, first row, rows) of each chunk of the ragged tiling."""
    for n, r0 in enumerate(range(0, L, chunk)):
        yield n, r0, min(chunk, L - r0)


def ssd_intra_chunk_tiled_plain(x: torch.Tensor, dt: torch.Tensor,
                                a: torch.Tensor, b: torch.Tensor,
                                c: torch.Tensor, chunk: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch 1's function: x (Bt, L, H, P), dt (Bt, L, H), a (H,), b/c
    (Bt, L, N), chunks of ``chunk`` rows, the last one ragged.  Returns
    (y_intra (Bt, L, H, P), states (Bt, H, nc, P, N)), f32."""
    Bt, L, H, P = x.shape
    N = b.shape[-1]
    nc = -(-L // chunk)
    y = torch.empty((Bt, L, H, P), dtype=torch.float32, device=x.device)
    states = torch.empty((Bt, H, nc, P, N), dtype=torch.float32,
                         device=x.device)
    af = a.float()
    for n, r0, q in _chunk_rows(L, chunk):
        dtc = dt[:, r0:r0 + q].float()                          # (Bt, q, H)
        xdt = x[:, r0:r0 + q].float() * dtc[..., None]          # (Bt,q,H,P)
        bc, cc = b[:, r0:r0 + q].float(), c[:, r0:r0 + q].float()
        cs = (dtc * af).cumsum(dim=1)                           # (Bt, q, H)
        diff = cs[:, :, None, :] - cs[:, None, :, :]            # (Bt,l,s,H)
        tri = torch.ones((q, q), dtype=torch.bool,
                         device=x.device).tril()[None, :, :, None]
        # masked before the exponential: exp(cs_l - cs_s) overflows s > l
        decay = torch.exp(torch.where(tri, diff, float("-inf")))
        scores = torch.einsum("blm,bsm->bls", cc, bc)
        y[:, r0:r0 + q] = torch.einsum("bls,blsh,bshp->blhp", scores,
                                       decay, xdt)
        w = torch.exp(cs[:, -1:] - cs)                          # (Bt, q, H)
        states[:, :, n] = torch.einsum("bshp,bsh,bsm->bhpm", xdt, w, bc)
    return y, states


def ssd_chunk_scan_tiled_plain(y_intra: torch.Tensor, states: torch.Tensor,
                               dt: torch.Tensor, a: torch.Tensor,
                               c: torch.Tensor, chunk: int,
                               init_state: Optional[torch.Tensor] = None,
                               out_dtype: torch.dtype = torch.float32
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch 2's function: y_intra (Bt, L, H, P) and states (Bt, H, nc,
    P, N) as launch 1 gives them, dt/a/c as launch 1 takes them,
    init_state (Bt, H, P, N) or None (zeros).  Returns (y (Bt, L, H, P) in
    ``out_dtype``, the final state (Bt, H, P, N) f32)."""
    Bt, L, H, P = y_intra.shape
    N = c.shape[-1]
    prev = init_state.float() if init_state is not None else \
        torch.zeros((Bt, H, P, N), dtype=torch.float32, device=c.device)
    y = torch.empty_like(y_intra)
    af = a.float()
    for n, r0, q in _chunk_rows(L, chunk):
        cs = (dt[:, r0:r0 + q].float() * af).cumsum(dim=1)     # (Bt, q, H)
        y[:, r0:r0 + q] = y_intra[:, r0:r0 + q] + torch.einsum(
            "blm,blh,bhpm->blhp", c[:, r0:r0 + q].float(), torch.exp(cs),
            prev)
        prev = prev * torch.exp(cs[:, -1])[..., None, None] + \
            states[:, :, n]
    return y.to(out_dtype), prev


def ssd_scan_tiled_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                         b: torch.Tensor, c: torch.Tensor, chunk: int,
                         init_state: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole scan on the card's ragged tiling, in plain ops: the same
    signature and result as ``ssd_chunked`` for any L."""
    y_intra, states = ssd_intra_chunk_tiled_plain(x, dt, a, b, c, chunk)
    return ssd_chunk_scan_tiled_plain(y_intra, states, dt, a, c, chunk,
                                      init_state, x.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


def check_shapes(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, chunk: int) -> None:
    """Raise on shapes the kernels do not take (any device)."""
    if x.ndim != 4:
        raise ValueError(f"x must be (B, L, H, P), got {tuple(x.shape)}")
    B, L, H, P = x.shape
    N = b.shape[-1]
    if L < 1 or dt.shape != (B, L, H) or a.shape != (H,) or \
            b.shape != (B, L, N) or c.shape != b.shape:
        raise ValueError(f"bad shapes x {tuple(x.shape)} dt "
                         f"{tuple(dt.shape)} a {tuple(a.shape)} b "
                         f"{tuple(b.shape)} c {tuple(c.shape)}")
    if not (1 <= chunk <= MAX_Q and 8 <= P <= MAX_P and 8 <= N <= MAX_N
            and P % 8 == 0 and N % 8 == 0):
        raise ValueError(f"the SSD kernels take chunk Q <= {MAX_Q}, head "
                         f"dim P <= {MAX_P} and state N <= {MAX_N}, P and N "
                         f"multiples of 8; got Q={chunk} P={P} N={N}")


def _check_cuda(what: str, *ts: Optional[torch.Tensor]) -> None:
    for t in ts:
        if t is not None and not t.is_cuda:
            raise ValueError(f"{what} takes CUDA tensors only")


def _check_dtype(what: str, want, *ts: Optional[torch.Tensor]) -> None:
    for t in ts:
        if t is not None and t.dtype not in want:
            raise TypeError(f"{what} takes {want}, got {t.dtype}")


def _rows(t: torch.Tensor, inner: int) -> torch.Tensor:
    """``t`` itself if the kernels can read it in place -- the last
    ``inner`` dims packed, the outer strides and the base 16-byte aligned
    (a slice of the mixer's conv output is) -- else a packed copy."""
    es = t.element_size()
    packed = t.stride(-1) == 1 and (inner == 1 or t.stride(-2) ==
                                    t.shape[-1])
    aligned = t.data_ptr() % 16 == 0 and all(
        (t.stride(i) * es) % 16 == 0 for i in range(t.ndim - inner))
    return t if packed and aligned else \
        t.clone(memory_format=torch.contiguous_format)


def _launch(symbol: str, argtypes, args, dev: torch.device) -> None:
    fn = _build.function("ssd_scan", symbol, argtypes)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(*args, stream)
    if err:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {err}")


def ssd_intra_chunk_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                         b: torch.Tensor, c: torch.Tensor, chunk: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch 1 on PyTorch's current stream.  Same contract as
    :func:`ssd_intra_chunk_tiled_plain` (x, b, c float32 or bfloat16, one
    dtype; dt, a float32); raises on an input it does not take and on a
    failed launch."""
    _check_cuda("ssd_intra_chunk_cuda", x, dt, a, b, c)
    check_shapes(x, dt, a, b, c, chunk)
    _check_dtype("ssd_intra_chunk_cuda", DTYPES, x)
    _check_dtype("ssd_intra_chunk_cuda", (x.dtype,), b, c)
    _check_dtype("ssd_intra_chunk_cuda", (torch.float32,), dt, a)
    B, L, H, P = x.shape
    N = b.shape[-1]
    x, b, c = _rows(x, 2), _rows(b, 1), _rows(c, 1)
    dt, a = dt.contiguous(), a.contiguous()
    nc = -(-L // chunk)
    y = torch.empty((B, L, H, P), dtype=torch.float32, device=x.device)
    states = torch.empty((B, H, nc, P, N), dtype=torch.float32,
                         device=x.device)
    _launch("ssd_intra_chunk_fwd", _INTRA_ARGTYPES,
            (x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
             c.data_ptr(), y.data_ptr(), states.data_ptr(), B, L, H, P, N,
             chunk, x.stride(0), x.stride(1), b.stride(0), b.stride(1),
             c.stride(0), c.stride(1), int(x.dtype == torch.bfloat16)),
            x.device)
    COUNTER_INTRA.kernel += 1
    return y, states


def ssd_chunk_scan_cuda(y_intra: torch.Tensor, states: torch.Tensor,
                        dt: torch.Tensor, a: torch.Tensor, c: torch.Tensor,
                        chunk: int, init_state: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch 2 on PyTorch's current stream.  Same contract as
    :func:`ssd_chunk_scan_tiled_plain` with ``out_dtype = c.dtype`` (y is
    written in c's dtype, which is x's); raises on an input it does not
    take and on a failed launch."""
    _check_cuda("ssd_chunk_scan_cuda", y_intra, states, dt, a, c, init_state)
    if y_intra.ndim != 4:
        raise ValueError(f"y_intra must be (B, L, H, P), got "
                         f"{tuple(y_intra.shape)}")
    B, L, H, P = y_intra.shape
    N = c.shape[-1]
    check_shapes(y_intra, dt, a, c, c, chunk)
    nc = -(-L // chunk)
    init_shape = None if init_state is None else tuple(init_state.shape)
    if states.shape != (B, H, nc, P, N) or \
            init_shape not in (None, (B, H, P, N)):
        raise ValueError(f"bad shapes states {tuple(states.shape)} "
                         f"init_state {init_shape} for y_intra "
                         f"{tuple(y_intra.shape)}, chunk {chunk}, N={N}")
    _check_dtype("ssd_chunk_scan_cuda", DTYPES, c)
    _check_dtype("ssd_chunk_scan_cuda", (torch.float32,), y_intra, states,
                 dt, a, init_state)
    y_intra, states, dt, a = (t.contiguous()
                              for t in (y_intra, states, dt, a))
    c = _rows(c, 1)
    if init_state is not None:
        init_state = init_state.contiguous()
    y = torch.empty((B, L, H, P), dtype=c.dtype, device=c.device)
    final = torch.empty((B, H, P, N), dtype=torch.float32, device=c.device)
    _launch("ssd_chunk_scan_fwd", _SCAN_ARGTYPES,
            (y_intra.data_ptr(), states.data_ptr(), dt.data_ptr(),
             a.data_ptr(), c.data_ptr(),
             None if init_state is None else init_state.data_ptr(),
             y.data_ptr(), final.data_ptr(), B, L, H, P, N, chunk,
             c.stride(0), c.stride(1), int(c.dtype == torch.bfloat16)),
            c.device)
    COUNTER_SCAN.kernel += 1
    return y, final


# ---------------------------------------------------------------------------
# the wrapper: drop-in for ssd_chunked
# ---------------------------------------------------------------------------


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan through K4 (``ssd_scan_pallas`` / ``ssd_chunked``), any
    L.  x (Bt, L, H, P); dt (Bt, L, H) positive step sizes; a (H,)
    negative decay rates; b, c (Bt, L, N); init_state (Bt, H, P, N) f32 or
    None; ``chunk`` the model's ``ssm_chunk``.  Returns (y (Bt, L, H, P) in
    x's dtype, final state (Bt, H, P, N) f32).  CUDA tensors launch both
    kernels, tiled at ``chunk`` with a ragged last chunk; CPU tensors take
    the plain versions at JAX's chunk (:func:`jax_chunk`)."""
    if x.is_cuda:
        y_intra, states = ssd_intra_chunk_cuda(x, dt, a, b, c, chunk)
        return ssd_chunk_scan_cuda(y_intra, states, dt, a, c, chunk,
                                   init_state)
    if x.device.type != "cpu":
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    Bt, L, H, P = x.shape
    xdt, da, bc, cc = prepare(x, dt, a, b, c, jax_chunk(chunk, L))
    s0 = None if init_state is None else init_state.float()
    COUNTER_INTRA.plain += 1
    y, states = ssd_intra_chunk_plain(xdt, da, bc, cc)
    COUNTER_SCAN.plain += 1
    y, final = ssd_chunk_scan_plain(y, states, da, cc, s0)
    y = y.permute(0, 2, 3, 1, 4).reshape(Bt, L, H, P)
    return y.to(x.dtype), final
