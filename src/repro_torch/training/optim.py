"""AdamW over a parameter tree (port of ``src/repro/training/optim.py``).

Functions over the tree, as the JAX package's are, not
``torch.optim.AdamW`` (whose update differs: no ``1e-30`` in g², decay
on every parameter, no factored moment).  Every detail is JAX's: the
global-norm clip with ``+1e-9``, bias correction, ``1e-30`` added to g²,
weight decay added to the update for parameters of rank >= 2 only, the
moments stored in ``state_dtype`` and updated in f32, and the optional
Adafactor-style ``factored`` second moment (row / column means of g² over
the last two axes of a rank >= 2 parameter).

Rank decides the decay and the factoring, so the trainer keeps its
parameters and optimizer state in the JAX package's tree layout
(:func:`repro_torch.bridge.stack_params`: TConst blocks and LM layers
stacked on a leading axis).  There a block's norm scale is one (nb, d)
leaf, decayed and factored as JAX's is; a per-block (d,) slice would be
neither.  A parameter the forward does not reach (the last TConst
block's RESTORE in the port) has a zero gradient: AdamW still decays it.

Trees are nested dicts and lists of tensors; leaves are visited in the
order JAX flattens them (dict keys sorted).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4                     # peak LR; scaled by the schedule
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"         # bf16 for the memory-tight configs
    factored: bool = False               # v of rank >= 2 params as row /
    # column means (outer-product reconstruction), ~1x params of state


class OptState(NamedTuple):
    step: torch.Tensor                   # int32 scalar
    m: Any
    v: Any


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a nested dict / list tree in JAX's flatten order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree``; ``rest`` are trees with
    ``tree``'s structure down to its leaves (their own subtrees there are
    passed whole, as the factored second moment's ``{"vr", "vc"}``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def tree_unflatten(tree: Any, leaves: List[Any]) -> Any:
    """``tree``'s structure with ``leaves`` (in :func:`tree_leaves`
    order) in place of its own."""
    it = iter(leaves)

    def go(t):
        if isinstance(t, dict):
            vals = {k: go(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if isinstance(t, (list, tuple)):
            return [go(x) for x in t]
        return next(it)
    out = go(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _factorable(p: torch.Tensor) -> bool:
    return p.ndim >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1


def _init_v(p: torch.Tensor, cfg: AdamWConfig):
    dt = getattr(torch, cfg.state_dtype)
    if cfg.factored and _factorable(p):
        return {"vr": torch.zeros(p.shape[:-1], dtype=dt, device=p.device),
                "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=dt,
                                  device=p.device)}
    return torch.zeros(p.shape, dtype=dt, device=p.device)


def init_opt_state(params: Any, cfg: AdamWConfig) -> OptState:
    dt = getattr(torch, cfg.state_dtype)
    dev = tree_leaves(params)[0].device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device),
                   params),
        v=tree_map(lambda p: _init_v(p, cfg), params))


def global_norm(tree: Any) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(x.float().square().sum() for x in leaves))


def adamw_update(params: Any, grads: Any, state: OptState,
                 cfg: AdamWConfig, lr_scale: torch.Tensor
                 ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step.  ``lr_scale`` comes from the schedule (f32 scalar
    tensor).  A gradient leaf that is None counts as zeros.  Returns new
    trees (the inputs are not modified)."""
    grads = tree_map(lambda p, g: torch.zeros_like(p) if g is None else g,
                     params, grads)
    step = state.step + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - b1 ** stepf
    bc2 = 1.0 - b2 ** stepf
    lr = cfg.lr * lr_scale
    sdt = getattr(torch, cfg.state_dtype)

    def upd(p, g, m, v):
        g = g.float() * clip
        m32 = m.float() * b1 + g * (1 - b1)
        g2 = g.square() + 1e-30
        if isinstance(v, dict):                      # factored second moment
            vr = v["vr"].float() * b2 + g2.mean(dim=-1) * (1 - b2)
            vc = v["vc"].float() * b2 + g2.mean(dim=-2) * (1 - b2)
            denom = vr.mean(dim=-1, keepdim=True)
            v32 = vr[..., None] * vc[..., None, :] / \
                torch.clamp(denom[..., None], min=1e-30)
            new_v = {"vr": vr.to(sdt), "vc": vc.to(sdt)}
        else:
            v32 = v.float() * b2 + g2 * (1 - b2)
            new_v = v32.to(sdt)
        update = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if p.ndim >= 2:
            update = update + cfg.weight_decay * p.float()
        new_p = p.float() - lr * update
        return new_p.to(p.dtype), m32.to(sdt), new_v

    out = tree_map(upd, params, grads, state.m, state.v)
    new_p, new_m, new_v = (tree_map(lambda p, o, i=i: o[i], params, out)
                           for i in range(3))
    return new_p, OptState(step, new_m, new_v), {"grad_norm": gnorm}
