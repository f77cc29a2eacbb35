"""K4: the Mamba-2 SSD chunk kernels (state-space duality).

Port of ``src/repro/kernels/ssd_scan.py``: ``ssd_intra_chunk_pallas``
(the TPU kernel: per (batch, head, chunk) the cumulative log-decay, the
decay-masked ``C . B^T`` scores times ``xdt`` and the chunk-final state)
and its wrapper ``ssd_scan_pallas``, whose inter-chunk recurrence the JAX
package runs as a ``jax.lax.scan`` in XLA.  The port's kernels are CUDA
C++ (``csrc/ssd_scan.cu``), two entries counted apart:

* ``ssd_intra_chunk`` -- the Pallas kernel's function;
* ``ssd_chunk_scan`` -- the wrapper's scan over chunks (the state before
  each chunk, its ``y_inter`` term, the final state): a sequential state
  pass and a parallel output pass, where a host loop would take ``nc``
  steps (``nc = L`` at chunk 1).

:func:`ssd_scan` is the drop-in equivalent of ``ssd_chunked`` /
``ssd_scan_pallas`` (same signature and result).  The elementwise
preparation (``da = dt * a``, ``xdt = x * dt``, the reshapes, the final
cast to ``x.dtype``) stays in plain ops.  Beside each entry sits its
plain PyTorch version; only CPU tensors reach them (a CUDA tensor
launches the kernels or the wrapper raises).
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

_INTRA_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + \
    [ctypes.c_void_p]
_SCAN_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + \
    [ctypes.c_void_p]


# ---------------------------------------------------------------------------
# plain PyTorch versions
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


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


def check_shapes(xdt: torch.Tensor, da: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor) -> None:
    """Raise on shapes the kernels do not take (any device)."""
    if xdt.ndim != 5:
        raise ValueError(f"xdt must be (B, H, nc, Q, P), got "
                         f"{tuple(xdt.shape)}")
    B, H, nc, Q, P = xdt.shape
    N = b.shape[-1]
    if da.shape != (B, H, nc, Q) or b.shape != (B, nc, Q, N) or \
            c.shape != b.shape:
        raise ValueError(f"bad shapes xdt {tuple(xdt.shape)} da "
                         f"{tuple(da.shape)} b {tuple(b.shape)} c "
                         f"{tuple(c.shape)}")
    if not (1 <= Q <= MAX_Q and 1 <= P <= MAX_P and 1 <= N <= MAX_N):
        raise ValueError(f"the SSD kernels take chunk Q <= {MAX_Q}, head "
                         f"dim P <= {MAX_P} and state N <= {MAX_N}; got "
                         f"Q={Q} P={P} N={N}")


def _check_cuda(what: str, *ts: Optional[torch.Tensor]) -> None:
    for t in ts:
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{what} takes CUDA tensors only")
        if t.dtype != torch.float32:
            raise TypeError(f"{what} takes float32 tensors, got {t.dtype}")


def _launch(symbol: str, argtypes, ptrs, dims, dev: torch.device) -> None:
    fn = _build.function("ssd_scan", symbol, argtypes)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(*ptrs, *dims, stream)
    if err:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {err}")


def ssd_intra_chunk_cuda(xdt: torch.Tensor, da: torch.Tensor,
                         b: torch.Tensor, c: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the intra-chunk kernel on PyTorch's current stream.  Same
    contract as :func:`ssd_intra_chunk_plain`; raises on an input it does
    not take and on a failed launch."""
    _check_cuda("ssd_intra_chunk_cuda", xdt, da, b, c)
    check_shapes(xdt, da, b, c)
    B, H, nc, Q, P = xdt.shape
    N = b.shape[-1]
    xdt, da, b, c = (t.contiguous() for t in (xdt, da, b, c))
    y = torch.empty_like(xdt)
    states = torch.empty((B, H, nc, P, N), dtype=torch.float32,
                         device=xdt.device)
    _launch("ssd_intra_chunk_fwd", _INTRA_ARGTYPES,
            (xdt.data_ptr(), da.data_ptr(), b.data_ptr(), c.data_ptr(),
             y.data_ptr(), states.data_ptr()), (B, H, nc, Q, P, N),
            xdt.device)
    COUNTER_INTRA.kernel += 1
    return y, states


def ssd_chunk_scan_cuda(y_intra: torch.Tensor, states: torch.Tensor,
                        da: torch.Tensor, c: torch.Tensor,
                        init_state: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the chunk-scan kernel on PyTorch's current stream.  Same
    contract as :func:`ssd_chunk_scan_plain`; raises on an input it does
    not take and on a failed launch."""
    _check_cuda("ssd_chunk_scan_cuda", y_intra, states, da, c, init_state)
    B, H, nc, Q, P = y_intra.shape
    N = c.shape[-1]
    check_shapes(y_intra, da, c, c)
    init_shape = None if init_state is None else tuple(init_state.shape)
    if states.shape != (B, H, nc, P, N) or \
            init_shape not in (None, (B, H, P, N)):
        raise ValueError(f"bad shapes states {tuple(states.shape)} "
                         f"init_state {init_shape} for y_intra "
                         f"{tuple(y_intra.shape)}, N={N}")
    y_intra, states, da, c = (t.contiguous()
                              for t in (y_intra, states, da, c))
    if init_state is not None:
        init_state = init_state.contiguous()
    y = torch.empty_like(y_intra)
    final = torch.empty((B, H, P, N), dtype=torch.float32,
                        device=y_intra.device)
    prevs = torch.empty_like(states)      # the state before each chunk
    _launch("ssd_chunk_scan_fwd", _SCAN_ARGTYPES,
            (y_intra.data_ptr(), states.data_ptr(), da.data_ptr(),
             c.data_ptr(),
             None if init_state is None else init_state.data_ptr(),
             y.data_ptr(), final.data_ptr(), prevs.data_ptr()),
            (B, H, nc, Q, P, N), y_intra.device)
    COUNTER_SCAN.kernel += 1
    return y, final


# ---------------------------------------------------------------------------
# the wrapper: drop-in for ssd_chunked
# ---------------------------------------------------------------------------


def prepare(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor, c: torch.Tensor, chunk: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor]:
    """The wrapper's elementwise preparation (plain ops, f32): x (Bt, L,
    H, P), dt (Bt, L, H), a (H,), b/c (Bt, L, N) -> (xdt (Bt, H, nc, Q,
    P), da (Bt, H, nc, Q), b, c (Bt, nc, Q, N))."""
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


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan through K4 (``ssd_scan_pallas`` / ``ssd_chunked``).
    x (Bt, L, H, P); dt (Bt, L, H) positive step sizes; a (H,) negative
    decay rates; b, c (Bt, L, N); init_state (Bt, H, P, N) or None.
    Returns (y (Bt, L, H, P) in x's dtype, final state (Bt, H, P, N) f32).
    CUDA tensors launch both kernels; CPU tensors take both plain
    versions."""
    Bt, L, H, P = x.shape
    xdt, da, bc, cc = prepare(x, dt, a, b, c, chunk)
    s0 = None if init_state is None else init_state.float()
    if x.is_cuda:
        y, states = ssd_intra_chunk_cuda(xdt, da, bc, cc)
        y, final = ssd_chunk_scan_cuda(y, states, da, cc, s0)
    else:
        if x.device.type != "cpu":
            raise ValueError(f"ssd_scan: no kernel for device {x.device}")
        COUNTER_INTRA.plain += 1
        y, states = ssd_intra_chunk_plain(xdt, da, bc, cc)
        COUNTER_SCAN.plain += 1
        y, final = ssd_chunk_scan_plain(y, states, da, cc, s0)
    y = y.permute(0, 2, 3, 1, 4).reshape(Bt, L, H, P)
    return y.to(x.dtype), final
