"""Mamba-2 SSD (state-space duality) layer [arXiv:2405.21060].

Port of ``src/repro/layers/ssm.py``.  Layer layout follows the mamba2
block: in_proj -> (z, x, B, C, dt), depthwise causal conv over (x, B, C),
SSD core, gated RMSNorm, out_proj.  Single B/C group (n_groups=1), scalar
A per head.

The mixer's chunked branch runs K4 (``ops.ssd_scan``: the intra-chunk
kernel and the chunk scan, tiled at ``ssm_chunk`` for any length on the
card; the JAX mixer calls the plain ``ssd_chunked``, of which K4 is the
drop-in equivalent).  :func:`ssd_chunked` stays here as
the plain reference the tests hold K4 against.  The decode recurrence
:func:`ssd_step` is plain ops, as in JAX.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.layers.common import Params, dense_init

# mixer parameters read in float32 whatever the activation dtype (the
# JAX mixer casts them with ``.astype(jnp.float32)``): a prepared copy of
# the weights keeps them so
F32_PARAMS = ("conv_w", "conv_b", "dt_bias", "a_log", "norm_scale")


class SSMDims(NamedTuple):
    d_inner: int
    n_heads: int
    head_dim: int
    n_state: int
    d_conv: int
    conv_dim: int


def ssm_dims(cfg: ModelConfig, d_model: Optional[int] = None) -> SSMDims:
    d = d_model or cfg.d_model
    d_inner = cfg.ssm_expand * d
    head_dim = cfg.ssm_head_dim or 64
    n_heads = cfg.ssm_heads or d_inner // head_dim
    n_state = cfg.ssm_state
    conv_dim = d_inner + 2 * n_state
    return SSMDims(d_inner, n_heads, head_dim, n_state, cfg.ssm_conv, conv_dim)


def init_ssm(cfg: ModelConfig, gen: torch.Generator,
             d_model: Optional[int] = None) -> Params:
    """The port's own seeded init (float32, drawn from ``gen`` on its
    device): in_proj, conv_w, dt_bias and out_proj are random;
    ``dt_bias`` is the inverse softplus of a log-uniform draw in [1e-3,
    1e-1], ``a_log = log(1..H)``, ``d_skip`` and ``norm_scale`` are ones,
    ``conv_b`` zeros."""
    d = d_model or cfg.d_model
    dims = ssm_dims(cfg, d)
    dev = gen.device
    d_proj = 2 * dims.d_inner + 2 * dims.n_state + dims.n_heads
    in_proj = dense_init((d, d_proj), d, gen)
    conv_w = dense_init((dims.d_conv, dims.conv_dim), dims.d_conv, gen)
    u = torch.rand((dims.n_heads,), generator=gen, dtype=torch.float32,
                   device=dev)
    log_dt = math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3))
    dt_bias = torch.log(torch.expm1(torch.exp(log_dt)))
    out_proj = dense_init((dims.d_inner, d), dims.d_inner, gen)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((dims.conv_dim,), device=dev),
        "dt_bias": dt_bias,
        "a_log": torch.log(torch.arange(1, dims.n_heads + 1,
                                        dtype=torch.float32, device=dev)),
        "d_skip": torch.ones((dims.n_heads,), device=dev),
        "norm_scale": torch.ones((dims.d_inner,), device=dev),
        "out_proj": out_proj,
    }


# ---------------------------------------------------------------------------
# SSD core: the plain chunked reference and the decode recurrence
# ---------------------------------------------------------------------------


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{j < k <= i} x[..., k]
    (-inf above the diagonal).  x: (..., Q) -> (..., Q, Q)."""
    Q = x.shape[-1]
    cs = x.cumsum(dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, diff, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan, the plain reference (the JAX mixer's path).

    x: (Bt, L, H, P); dt: (Bt, L, H) positive step sizes; a: (H,)
    negative decay rates; b, c: (Bt, L, N) (single group, broadcast to
    H).  Returns (y (Bt, L, H, P) in x's dtype, final_state (Bt, H, P, N)
    f32)."""
    Bt, L, H, P = x.shape
    N = b.shape[-1]
    if L % chunk:
        raise ValueError(f"L={L} is not a multiple of chunk={chunk}")
    nc = L // chunk
    xc = x.float().reshape(Bt, nc, chunk, H, P)
    dtc = dt.float().reshape(Bt, nc, chunk, H)
    bc = b.float().reshape(Bt, nc, chunk, N)
    cc = c.float().reshape(Bt, nc, chunk, N)

    da = (dtc * a.float()[None, None, None, :]).movedim(-1, 2)  # (Bt,nc,H,Q)
    decay_mat = torch.exp(_segsum(da))                  # (Bt, nc, H, Q, Q)
    xdt = xc * dtc[..., None]                           # (Bt, nc, Q, H, P)
    scores = torch.einsum("bnlm,bnsm->bnls", cc, bc)
    y_intra = torch.einsum("bnls,bnhls,bnshp->bnlhp", scores, decay_mat,
                           xdt)
    decay_to_end = torch.exp(da.flip(-1).cumsum(-1).flip(-1) - da)
    states = torch.einsum("bnsm,bnhs,bnshp->bnhpm", bc, decay_to_end, xdt)

    chunk_decay = torch.exp(da.sum(dim=-1))             # (Bt, nc, H)
    s = init_state.float() if init_state is not None else \
        torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device)
    prev = []
    for n in range(nc):                 # the state BEFORE each chunk
        prev.append(s)
        s = s * chunk_decay[:, n, :, None, None] + states[:, n]
    prev_states = torch.stack(prev, dim=1)              # (Bt, nc, H, P, N)
    decay_from_start = torch.exp(da.cumsum(dim=-1))
    y_inter = torch.einsum("bnlm,bnhl,bnhpm->bnlhp", cc, decay_from_start,
                           prev_states)
    y = (y_intra + y_inter).reshape(Bt, L, H, P)
    return y.to(x.dtype), s


def ssd_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
             a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrent step (decode path), O(1) in sequence length.
    state: (Bt, H, P, N); x: (Bt, H, P); dt: (Bt, H); b, c: (Bt, N).
    Returns (y (Bt, H, P) in x's dtype, new state f32)."""
    dec = torch.exp(dt.float() * a.float()[None])       # (Bt, H)
    xdt = x.float() * dt.float()[..., None]             # (Bt, H, P)
    new = state.float() * dec[:, :, None, None] + \
        torch.einsum("bhp,bm->bhpm", xdt, b.float())
    y = torch.einsum("bhpm,bm->bhp", new, c.float())
    return y.to(x.dtype), new


# ---------------------------------------------------------------------------
# Full mamba2 mixer (projections + conv + SSD + gate)
# ---------------------------------------------------------------------------


def _split_proj(z_all: torch.Tensor, dims: SSMDims):
    di = dims.d_inner
    z = z_all[..., :di]
    xbc = z_all[..., di:di + dims.conv_dim]
    dt = z_all[..., di + dims.conv_dim:]
    return z, xbc, dt


def causal_conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                prev: Optional[torch.Tensor] = None,
                valid_len: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d + SiLU.  xbc: (B, L, C); w: (K, C).

    prev: (B, K-1, C) trailing context from the previous segment (decode).
    valid_len: optional (B,): only positions ``[0, valid_len)`` are real,
    and the returned context window ends at ``valid_len`` instead of L.
    Returns (out (B, L, C), new_prev (B, K-1, C))."""
    K = w.shape[0]
    B, L, C = xbc.shape
    if prev is None:
        prev = torch.zeros((B, K - 1, C), dtype=xbc.dtype, device=xbc.device)
    xp = torch.cat([prev.to(xbc.dtype), xbc], dim=1)    # (B, L+K-1, C)
    out = torch.zeros((B, L, C), dtype=torch.float32, device=xbc.device)
    for i in range(K):
        out = out + xp[:, i:i + L].float() * w[i].float()
    out = F.silu(out + bias.float()).to(xbc.dtype)
    if valid_len is None:
        return out, xp[:, L:]
    # xp index j holds segment position j - (K-1): the window preceding
    # position valid_len is xp[vl : vl + K - 1]
    idx = valid_len.long()[:, None] + torch.arange(K - 1, device=xbc.device)
    return out, torch.gather(xp, 1, idx[..., None].expand(B, K - 1, C))


def ssm_mixer(params: Params, x: torch.Tensor, cfg: ModelConfig,
              d_model: Optional[int] = None, state: Optional[dict] = None,
              valid_len: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Mamba2 mixer.  x: (B, L, d).  If ``state`` is given (keys: ssm,
    conv), runs in stepwise/streaming mode and returns the updated state
    (new tensors; the caller decides where they are written).

    valid_len: optional (B,): positions ``>= valid_len`` are padding; their
    ``dt`` is forced to 0 (an exact identity update of the SSD state) and
    the conv window ends at ``valid_len``."""
    dims = ssm_dims(cfg, d_model)
    dtype = x.dtype
    B, L, _ = x.shape
    z_all = torch.einsum("bld,dp->blp", x, params["in_proj"].to(dtype))
    z, xbc, dt_raw = _split_proj(z_all, dims)
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())  # (B, L, H)
    if valid_len is not None:
        pos = torch.arange(L, device=x.device)[None, :, None]
        dt = torch.where(pos < valid_len[:, None, None], dt, 0.0)
    a = -torch.exp(params["a_log"].float())

    prev_conv = state["conv"] if state is not None else None
    xbc, new_conv = causal_conv(xbc, params["conv_w"], params["conv_b"],
                                prev_conv, valid_len=valid_len)
    di, n = dims.d_inner, dims.n_state
    xs = xbc[..., :di].reshape(B, L, dims.n_heads, dims.head_dim)
    b = xbc[..., di:di + n]
    c = xbc[..., di + n:]

    if state is not None and L == 1:
        y, new_ssm = ssd_step(state["ssm"], xs[:, 0], dt[:, 0], a, b[:, 0],
                              c[:, 0])
        y = y[:, None]
    else:
        init = state["ssm"] if state is not None else None
        # the card tiles at ssm_chunk with a ragged last chunk; the CPU
        # path halves the chunk until it divides L, as JAX does
        y, new_ssm = ops.ssd_scan(xs, dt, a, b, c, cfg.ssm_chunk, init)

    y = y + xs * params["d_skip"].to(dtype)[None, None, :, None]
    y = y.reshape(B, L, di)

    # gated RMSNorm (mamba2 uses norm(y * silu(z)))
    g = y.float() * F.silu(z.float())
    var = g.square().mean(dim=-1, keepdim=True)
    g = g * torch.rsqrt(var + 1e-5) * params["norm_scale"].float()
    out = torch.einsum("blp,pd->bld", g.to(dtype),
                       params["out_proj"].to(dtype))
    new_state = {"ssm": new_ssm, "conv": new_conv} if state is not None \
        else None
    return out, new_state


def init_ssm_state(cfg: ModelConfig, batch: int,
                   d_model: Optional[int] = None,
                   device: Optional[torch.device] = None) -> dict:
    dims = ssm_dims(cfg, d_model)
    return {
        "ssm": torch.zeros((batch, dims.n_heads, dims.head_dim,
                            dims.n_state), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, dims.d_conv - 1, dims.conv_dim),
                            dtype=getattr(torch, cfg.dtype), device=device),
    }
