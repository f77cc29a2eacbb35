"""K4: the Mamba-2 SSD scan (state-space duality), and its backward.

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
  state kept on chip (under autograd it also saves the state entering
  each chunk for the backward).

The backward (``csrc/ssd_scan_bwd.cu``, counted as ``ssd_scan_bwd``, one
C entry of three device launches) has no TPU kernel behind it: the JAX
package differentiates its XLA ``ssd_chunked`` with ``value_and_grad``.
It runs a reverse scan over the chunks for the gradient of each chunk's
exit state, then one block a (batch, head, chunk) for the intra-chunk
terms, then a fixed-order sum of ``db`` / ``dc`` over the heads; its
derivation heads the source.  Its plain version is autograd through
:func:`ssd_scan_tiled_plain` (:func:`ssd_scan_bwd_tiled_plain`);
:func:`ssd_scan_bwd_mirror` spells the kernel's own formulas out in plain
ops, so the CPU tests prove them.

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
JAX's order; its backward (:func:`ssd_scan_bwd_plain`) is autograd
through them at that chunk.  Only CPU tensors reach a plain version: a
CUDA tensor launches the kernels or the wrapper raises.
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
COUNTER_BWD = runtime.counter("ssd_scan_bwd")
DTYPES = (torch.float32, torch.bfloat16)     # x, b and c on the card

_LL = ctypes.c_longlong
_INTRA_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [_LL] * 6 + \
    [ctypes.c_int, ctypes.c_void_p]
_SCAN_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [_LL] * 2 + \
    [ctypes.c_int, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 6 + [_LL] * 6 + \
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
# the backward: plain versions
# ---------------------------------------------------------------------------

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
              torch.Tensor, torch.Tensor]


def _vjp(fwd, x, dt, a, b, c, init_state, dy, dfinal) -> Grads:
    """(dx, ddt, da, db, dc, dinit) of ``fwd(x, dt, a, b, c, init)`` ->
    (y, final) against (dy, dfinal): autograd through the plain ops,
    each gradient in its input's dtype (dinit f32: without an
    ``init_state``, the gradient of the zero state the scan starts
    from)."""
    Bt, _, H, P = x.shape
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, dt, a, b, c)]
        s0 = torch.zeros((Bt, H, P, b.shape[-1]), device=x.device) \
            if init_state is None else init_state.detach().float()
        s0.requires_grad_(True)
        y, final = fwd(*ins, s0)
        outs, gos = [y], [dy.to(y.dtype)]
        if dfinal is not None:
            outs.append(final)
            gos.append(dfinal.float())
        wrt = ins + [s0]
        gs = torch.autograd.grad(outs, wrt, gos, allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g
                 for t, g in zip(wrt, gs))


def ssd_scan_bwd_tiled_plain(x: torch.Tensor, dt: torch.Tensor,
                             a: torch.Tensor, b: torch.Tensor,
                             c: torch.Tensor, chunk: int,
                             init_state: Optional[torch.Tensor],
                             dy: torch.Tensor,
                             dfinal: Optional[torch.Tensor]) -> Grads:
    """The backward kernel's plain version: autograd through
    :func:`ssd_scan_tiled_plain` (the card's ragged tiling at ``chunk``).
    Returns (dx, ddt, da, db, dc, dinit)."""
    return _vjp(lambda *t: ssd_scan_tiled_plain(*t[:5], chunk, t[5]), x, dt,
                a, b, c, init_state, dy, dfinal)


def _ssd_scan_jax_chunk(x, dt, a, b, c, chunk, init_state):
    """The CPU forward of :func:`ssd_scan` (plain, at JAX's chunk)."""
    Bt, L, H, P = x.shape
    xdt, da, bc, cc = prepare(x, dt, a, b, c, jax_chunk(chunk, L))
    y, states = ssd_intra_chunk_plain(xdt, da, bc, cc)
    y, final = ssd_chunk_scan_plain(y, states, da, cc, init_state)
    y = y.permute(0, 2, 3, 1, 4).reshape(Bt, L, H, P)
    return y.to(x.dtype), final


def ssd_scan_bwd_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor, chunk: int,
                       init_state: Optional[torch.Tensor], dy: torch.Tensor,
                       dfinal: Optional[torch.Tensor]) -> Grads:
    """The CPU backward of :func:`ssd_scan`: autograd through its plain
    forward at JAX's chunk (:func:`jax_chunk`), so the CPU path
    differentiates what JAX's ``value_and_grad`` does."""
    return _vjp(lambda *t: _ssd_scan_jax_chunk(*t[:5], chunk, t[5]), x, dt,
                a, b, c, init_state, dy, dfinal)


def ssd_entry_states_tiled_plain(states: torch.Tensor, dt: torch.Tensor,
                                 a: torch.Tensor, chunk: int,
                                 init_state: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """The state entering each chunk of the ragged tiling, (Bt, H, nc, P,
    N) f32, from launch 1's chunk-end ``states``: what launch 2 saves
    under autograd."""
    Bt, H, nc, P, N = states.shape
    L = dt.shape[1]
    prev = init_state.float() if init_state is not None else \
        torch.zeros((Bt, H, P, N), dtype=torch.float32, device=dt.device)
    entry = torch.empty_like(states)
    af = a.float()
    for n, r0, q in _chunk_rows(L, chunk):
        entry[:, :, n] = prev
        dec = torch.exp((dt[:, r0:r0 + q].float() * af).sum(dim=1))  # (Bt,H)
        prev = prev * dec[..., None, None] + states[:, :, n]
    return entry


def ssd_scan_bwd_mirror(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor, c: torch.Tensor, chunk: int,
                        init_state: Optional[torch.Tensor], dy: torch.Tensor,
                        dfinal: Optional[torch.Tensor]) -> Grads:
    """The backward kernel's own formulas in plain ops, on its ragged
    tiling (the derivation heads ``csrc/ssd_scan_bwd.cu``): the reverse
    scan over chunks for G_n, the gradient of the state leaving chunk n,
    then per chunk the intra-chunk terms from G_n and the saved entry
    state S_n, the suffix sum of dcs, the chain rule to x, dt and a, and
    db / dc summed over the heads.  Returns (dx, ddt, da, db, dc, dinit)
    as :func:`ssd_scan_bwd_tiled_plain` does."""
    Bt, L, H, P = x.shape
    N = b.shape[-1]
    nc = -(-L // chunk)
    af = a.float()
    _, states = ssd_intra_chunk_tiled_plain(x, dt, a, b, c, chunk)
    entry = ssd_entry_states_tiled_plain(states, dt, a, chunk, init_state)
    rows = list(_chunk_rows(L, chunk))
    dyf = dy.float()

    def chunk_vals(r0, q):
        dtc = dt[:, r0:r0 + q].float()                          # (Bt, q, H)
        cs = (dtc * af).cumsum(dim=1)
        return dtc, cs, torch.exp(cs), torch.exp(cs[:, -1:] - cs)

    # launch 1: the reverse scan
    gexit = torch.empty_like(states)
    g = dfinal.float() if dfinal is not None else \
        torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device)
    for n, r0, q in reversed(rows):
        gexit[:, :, n] = g
        _, cs, e, _ = chunk_vals(r0, q)
        g = g * torch.exp(cs[:, -1])[..., None, None] + torch.einsum(
            "blh,blhp,blm->bhpm", e, dyf[:, r0:r0 + q], c[:, r0:r0 + q].float())
    dinit = g
    # launch 2: the per-chunk terms
    dx = torch.empty((Bt, L, H, P), dtype=torch.float32, device=x.device)
    ddt = torch.empty((Bt, L, H), dtype=torch.float32, device=x.device)
    dbh = torch.empty((Bt, L, H, N), dtype=torch.float32, device=x.device)
    dch = torch.empty_like(dbh)
    da = torch.zeros((H,), dtype=torch.float32, device=x.device)
    for n, r0, q in rows:
        dtc, cs, e, w = chunk_vals(r0, q)
        xc, dyc = x[:, r0:r0 + q].float(), dyf[:, r0:r0 + q]
        bc, cc = b[:, r0:r0 + q].float(), c[:, r0:r0 + q].float()
        G, Sn = gexit[:, :, n], entry[:, :, n]
        xdt = xc * dtc[..., None]
        tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
        E = torch.exp(torch.where(tri[None, :, :, None],
                                  cs[:, :, None] - cs[:, None], float("-inf")))
        CB = torch.einsum("blm,bsm->bls", cc, bc) * tri
        T = E * torch.einsum("blhp,bshp->blsh", dyc, xdt)       # E o DX
        M = CB[..., None] * T
        g_ = torch.einsum("bsm,bhpm->bshp", bc, G)              # G b_s
        r = w * (xdt * g_).sum(dim=-1)                          # (Bt, q, H)
        u = torch.einsum("blm,bhpm->blhp", cc, Sn)              # S_n c_l
        # d(da)_l = sum_{k>=l} dcs_k, summed without cancellation: the
        # pairs (k >= l, s < l) of M, the exclusive prefix sum of r, the
        # suffix sum of the inter term and e_{q-1} <G_n, S_n>
        cross = torch.stack([M[:, l:, :l].sum(dim=(1, 2)) for l in range(q)],
                            dim=1)                              # (Bt, q, H)
        inter = e * (dyc * u).sum(dim=-1)
        dda = cross + (r.cumsum(dim=1) - r) + \
            inter.flip(1).cumsum(dim=1).flip(1) + \
            (e[:, -1] * (G * Sn).sum(dim=(-1, -2)))[:, None]
        dxdt = torch.einsum("bls,blsh,blhp->bshp", CB, E, dyc) + \
            w[..., None] * g_
        dbh[:, r0:r0 + q] = torch.einsum("blsh,blm->bshm", T, cc) + \
            w[..., None] * torch.einsum("bshp,bhpm->bshm", xdt, G)
        dch[:, r0:r0 + q] = torch.einsum("blsh,bsm->blhm", T, bc) + \
            e[..., None] * torch.einsum("blhp,bhpm->blhm", dyc, Sn)
        dx[:, r0:r0 + q] = dxdt * dtc[..., None]
        ddt[:, r0:r0 + q] = (dxdt * xc).sum(dim=-1) + af * dda
        da = da + (dtc * dda).sum(dim=(0, 1))
    # launch 3: db and dc summed over the heads
    return (dx.to(x.dtype), ddt, da, dbh.sum(dim=2).to(b.dtype),
            dch.sum(dim=2).to(c.dtype), dinit)


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


def _launch(symbol: str, argtypes, args, dev: torch.device,
            library: str = "ssd_scan") -> None:
    fn = _build.function(library, symbol, argtypes)
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
                        chunk: int, init_state: Optional[torch.Tensor] = None,
                        entry_out: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch 2 on PyTorch's current stream.  Same contract as
    :func:`ssd_chunk_scan_tiled_plain` with ``out_dtype = c.dtype`` (y is
    written in c's dtype, which is x's); ``entry_out`` (B, H, nc, P, N)
    f32, packed, where given, receives the state entering each chunk
    (:func:`ssd_entry_states_tiled_plain`).  Raises on an input it does
    not take and on a failed launch."""
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
                 dt, a, init_state, entry_out)
    if entry_out is not None and (entry_out.shape != states.shape or
                                  not entry_out.is_contiguous() or
                                  not entry_out.is_cuda):
        raise ValueError(f"entry_out must be a packed CUDA "
                         f"{tuple(states.shape)} tensor, got "
                         f"{tuple(entry_out.shape)}")
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
             y.data_ptr(), final.data_ptr(),
             None if entry_out is None else entry_out.data_ptr(),
             B, L, H, P, N, chunk,
             c.stride(0), c.stride(1), int(c.dtype == torch.bfloat16)),
            c.device)
    COUNTER_SCAN.kernel += 1
    return y, final


def ssd_scan_train_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor, c: torch.Tensor, chunk: int,
                        init_state: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4's forward under autograd: both launches, the scan also saving
    the state entering each chunk.  Returns (y, final, entry (B, H, nc,
    P, N) f32)."""
    y_intra, states = ssd_intra_chunk_cuda(x, dt, a, b, c, chunk)
    entry = torch.empty_like(states)
    y, final = ssd_chunk_scan_cuda(y_intra, states, dt, a, c, chunk,
                                   init_state, entry_out=entry)
    return y, final, entry


def ssd_scan_bwd_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, c: torch.Tensor, chunk: int,
                      entry: torch.Tensor, dy: torch.Tensor,
                      dfinal: Optional[torch.Tensor] = None) -> Grads:
    """The backward kernel (three device launches) on PyTorch's current
    stream: the forward's inputs, ``entry`` as :func:`ssd_scan_train_cuda`
    saved it, the output gradient ``dy`` (B, L, H, P) and ``dfinal`` (B,
    H, P, N) or None (zeros).  Same contract as
    :func:`ssd_scan_bwd_tiled_plain` (x, b, c float32 or bfloat16, one
    dtype; dt, a, entry float32); raises on an input it does not take and
    on a failed launch."""
    _check_cuda("ssd_scan_bwd_cuda", x, dt, a, b, c, entry, dy, dfinal)
    check_shapes(x, dt, a, b, c, chunk)
    _check_dtype("ssd_scan_bwd_cuda", DTYPES, x)
    _check_dtype("ssd_scan_bwd_cuda", (x.dtype,), b, c)
    _check_dtype("ssd_scan_bwd_cuda", (torch.float32,), dt, a, entry, dfinal)
    B, L, H, P = x.shape
    N = b.shape[-1]
    nc = -(-L // chunk)
    if entry.shape != (B, H, nc, P, N) or dy.shape != x.shape or \
            (dfinal is not None and dfinal.shape != (B, H, P, N)):
        raise ValueError(f"bad shapes entry {tuple(entry.shape)} dy "
                         f"{tuple(dy.shape)} dfinal "
                         f"{None if dfinal is None else tuple(dfinal.shape)}"
                         f" for x {tuple(x.shape)}, chunk {chunk}, N={N}")
    x, b, c = _rows(x, 2), _rows(b, 1), _rows(c, 1)
    dt, a, entry = dt.contiguous(), a.contiguous(), entry.contiguous()
    dy = dy.to(x.dtype).contiguous()
    if dfinal is not None:
        dfinal = dfinal.contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((B, L, H, P), dtype=x.dtype, device=x.device)
    ddt = torch.empty((B, L, H), **f32)
    da = torch.empty((H,), **f32)
    db = torch.empty((B, L, N), dtype=b.dtype, device=x.device)
    dc = torch.empty_like(db)
    dinit = torch.empty((B, H, P, N), **f32)
    gexit = torch.empty((B, H, nc, P, N), **f32)
    dbh = torch.empty((B, H, L, N), **f32)
    dch = torch.empty_like(dbh)
    dap = torch.empty((B, H, nc), **f32)
    _launch("ssd_scan_bwd", _BWD_ARGTYPES,
            (x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
             c.data_ptr(), entry.data_ptr(), dy.data_ptr(),
             None if dfinal is None else dfinal.data_ptr(), dx.data_ptr(),
             ddt.data_ptr(), da.data_ptr(), db.data_ptr(), dc.data_ptr(),
             dinit.data_ptr(), gexit.data_ptr(), dbh.data_ptr(),
             dch.data_ptr(), dap.data_ptr(), B, L, H, P, N, chunk,
             x.stride(0), x.stride(1), b.stride(0), b.stride(1), c.stride(0),
             c.stride(1), int(x.dtype == torch.bfloat16)), x.device,
            library="ssd_scan_bwd")
    COUNTER_BWD.kernel += 1
    return dx, ddt, da, db, dc, dinit


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
    COUNTER_INTRA.plain += 1
    COUNTER_SCAN.plain += 1
    return _ssd_scan_jax_chunk(x, dt, a, b, c, chunk, None if init_state is
                               None else init_state.float())
