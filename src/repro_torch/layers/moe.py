"""Mixture-of-Experts FFN with GShard-style top-k capacity routing.

Port of ``src/repro/layers/moe.py``: mixtral-8x22b (8 experts, top-2, no
shared experts) and deepseek-moe-16b (64 fine-grained routed experts,
top-6, plus 2 always-on shared experts).  It computes the JAX function,
capacity drops included:

* Tokens are routed in groups of ``gs = min(T, GROUP_SIZE)`` (halved
  until it divides ``T = B * L``), each with capacity ``cap = max(4,
  ceil4(int(gs * K * cf / E)))`` slots an expert.
* Within a group, the position of each (choice, token) in its expert's
  queue counts CHOICE-MAJOR: every token's first choice is queued before
  any token's second choice (JAX flattens ``onehot(gate_idx.T)`` as
  ``(K * T, E)``).  Choices at a position ``>= cap`` are dropped.
* Top-k ties go to the lower expert index, as ``lax.top_k`` does (a
  stable descending sort; ``torch.topk`` leaves the order of ties
  unspecified).  In bf16 the router logits are rounded to bf16 before the
  f32 softmax, so exact ties are common.
* The top-k gates are renormalised and the combine weights rounded to
  the activation dtype; the aux loss is the Switch-style one, averaged
  over groups.

The dataflow is PyTorch's own, not JAX's one-hot ``(G, Tg, E, C)``
dispatch / combine einsums: each kept (choice, token) scatters its row
into a zeroed ``(E, G * C, d)`` buffer, the three expert products run as
batched matmuls over E, and each token gathers its choices' rows back
and sums them with their gates.  The number of launches does not grow
with E.  Every expert's weights are read whatever the routing (the
capacity form), as in JAX.

Weights keep JAX's layouts: ``router`` (d, E), ``w_gate`` / ``w_up``
(E, d, ff), ``w_down`` (E, ff, d), and ``shared`` a SwiGLU of width
``ff * n_shared_experts``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.layers.common import Params, dense_init
from repro_torch.layers.mlp import init_swiglu, swiglu

CAPACITY_FACTOR = 1.25
GROUP_SIZE = 1024      # GShard routing group: bounds the routing tensors


def init_moe(cfg: ModelConfig, gen: torch.Generator,
             dtype: Optional[torch.dtype] = None) -> Params:
    """``router``, ``w_gate``, ``w_up``, ``w_down`` and (deepseek) the
    shared SwiGLU, drawn from ``gen`` in that order on its device, each
    cast to ``dtype`` as drawn (the port's own init)."""
    d, e = cfg.d_model, cfg.n_experts
    ff = cfg.moe_d_ff or cfg.d_ff
    params: Params = {
        "router": dense_init((d, e), d, gen, dtype),
        "w_gate": dense_init((e, d, ff), d, gen, dtype),
        "w_up": dense_init((e, d, ff), d, gen, dtype),
        "w_down": dense_init((e, ff, d), ff, gen, dtype),
    }
    if cfg.n_shared_experts > 0:
        params["shared"] = init_swiglu(d, ff * cfg.n_shared_experts, gen,
                                       dtype)
    return params


def _capacity(n_tokens: int, n_experts: int, top_k: int,
              capacity_factor: float = CAPACITY_FACTOR) -> int:
    """Slots an expert per routing group, rounded up to a multiple of 4
    (at least 4)."""
    cap = int(n_tokens * top_k * capacity_factor / n_experts)
    return max(4, -(-cap // 4) * 4)


def group_size(n_tokens: int, group: Optional[int] = None) -> int:
    """The routing group size: ``group`` (default ``min(T, GROUP_SIZE)``)
    halved until it divides ``n_tokens``."""
    gs = group or min(n_tokens, GROUP_SIZE)
    while n_tokens % gs != 0:
        gs //= 2
    return gs


def route_topk(logits: torch.Tensor, top_k: int, capacity: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """GShard routing of one group (or a stack of groups) of tokens.

    logits (..., T, E).  Returns, each (..., K, T) choice-major:
    ``expert`` (int64) the choice's expert, ``pos`` (int32) its position
    in that expert's queue, ``gate`` (float32) its renormalised gate, 0
    where the choice is dropped (``pos >= capacity``); and the aux loss
    (...,) float32.  JAX's ``combine[t, e, c]`` is ``gate`` at ``e =
    expert``, ``c = pos``; its ``dispatch`` is ``combine > 0``.
    """
    E = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)                 # (.., T, E)
    # stable descending sort: ties keep the lower expert index first
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate = vals[..., :top_k]
    gate = gate / gate.sum(dim=-1, keepdim=True)
    expert = idx[..., :top_k].transpose(-1, -2)                   # (.., K, T)
    gate = gate.transpose(-1, -2)
    # position of each (choice, token) in its expert's queue: a running
    # count over the choice-major flattening of the K * T choices, taken
    # along the last axis of an (E, K * T) one-hot (a scan along an outer
    # axis of only E columns is a serial chain on a GPU)
    lead = expert.shape[:-2]
    flat = expert.reshape(lead + (1, -1))                          # (.., 1, KT)
    experts = torch.arange(E, device=logits.device).view(E, 1)
    onehot = (flat == experts).to(torch.int32)                     # (.., E, KT)
    before = onehot.cumsum(dim=-1) - onehot
    pos = before.gather(-2, flat).reshape(expert.shape)
    gate = torch.where(pos < capacity, gate, torch.zeros_like(gate))
    # load-balance auxiliary loss (Switch-style): top-1 density against
    # the mean router probability
    density = onehot[..., :expert.shape[-1]].float().mean(dim=-1)
    aux = (density * probs.mean(dim=-2)).sum(dim=-1) * E
    return expert, pos, gate, aux


def moe_ffn(params: Params, x: torch.Tensor, cfg: ModelConfig,
            capacity_factor: Optional[float] = None,
            group: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, L, d) -> (y (B, L, d) in x's dtype, aux loss () float32).

    ``capacity_factor=None`` is :data:`CAPACITY_FACTOR`; ``E / K`` routes
    dropless.  ``group`` overrides the group size (default
    ``min(T, GROUP_SIZE)``), as JAX's ``group_size``."""
    dtype = x.dtype
    B, L, d = x.shape
    T = B * L
    E, K = cfg.n_experts, cfg.n_experts_per_tok
    gs = group_size(T, group)
    G = T // gs
    xt = x.reshape(G, gs, d)
    logits = torch.einsum("gtd,de->gte", xt, params["router"].to(dtype))
    cap = _capacity(gs, E, K, CAPACITY_FACTOR if capacity_factor is None
                    else capacity_factor)
    expert, pos, gate, aux = route_topk(logits, K, cap)           # (G, K, gs)
    kept = gate > 0
    # flat row of each kept choice in the (E, G, C) buffer; dropped
    # choices write to (and read from) one trash row past the end
    g_idx = torch.arange(G, device=x.device).view(G, 1, 1)
    slot = (expert * G + g_idx) * cap + pos
    n = E * G * cap
    slot = torch.where(kept, slot, torch.full_like(slot, n)).reshape(-1)
    xe = x.new_zeros((n + 1, d))
    xe[slot] = xt[:, None].expand(G, K, gs, d).reshape(-1, d)
    xe = xe[:n].view(E, G * cap, d)
    g = torch.bmm(xe, params["w_gate"].to(dtype))
    u = torch.bmm(xe, params["w_up"].to(dtype))
    h = F.silu(g.float()).to(dtype) * u
    ye = torch.bmm(h, params["w_down"].to(dtype)).view(n, d)
    # each token sums its kept choices' rows, weighted by the gates
    # rounded to the activation dtype (JAX's combine), in float32
    rows = ye[slot.clamp(max=n - 1)].view(G, K, gs, d)
    w = gate.to(dtype).float()[..., None]
    y = (rows.float() * w).sum(dim=1).to(dtype).reshape(B, L, d)
    if "shared" in params:
        y = y + swiglu(params["shared"], x)
    return y, aux.mean()


def moe_ffn_dense_oracle(params: Params, x: torch.Tensor, cfg: ModelConfig
                         ) -> torch.Tensor:
    """Dropless reference: every expert computed for every token, combined
    with the renormalised top-k gates.  O(E) cost -- tests only."""
    dtype = x.dtype
    B, L, d = x.shape
    xt = x.reshape(B * L, d)
    logits = xt @ params["router"].to(dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg.n_experts_per_tok
    gv = vals[:, :K] / vals[:, :K].sum(dim=-1, keepdim=True)
    gates = torch.zeros_like(probs).scatter(1, idx[:, :K], gv)
    g = torch.einsum("td,edf->tef", xt, params["w_gate"].to(dtype))
    u = torch.einsum("td,edf->tef", xt, params["w_up"].to(dtype))
    h = F.silu(g.float()).to(dtype) * u
    ye = torch.einsum("tef,efd->ted", h, params["w_down"].to(dtype))
    y = torch.einsum("te,ted->td", gates.to(dtype), ye).reshape(B, L, d)
    if "shared" in params:
        y = y + swiglu(params["shared"], x)
    return y
