"""Microbatched train step: grad accumulation + AdamW update (port of
``src/repro/training/train_step.py``).

The global batch is split into ``n_micro`` microbatches run one after
the other; only one microbatch's activations are live at a time.  The
gradient accumulation buffer is kept in ``accum_dtype`` (f32 default;
bf16 for memory-tight configs), as in the JAX package.  Its other knob,
``grad_shardings``, constrains the buffer's sharding over a device mesh:
multi-device work, ROADMAP Queue 1 item 12.

The step takes and returns the parameters in the JAX package's tree
layout (:func:`repro_torch.bridge.stack_params`; see
:mod:`repro_torch.training.optim` for why); the model reads per-block /
per-layer views of them (:func:`repro_torch.bridge.unstack_params`), so
the gradients come back in the same layout.  On CUDA every attention's
forward and backward run K2's kernels.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import bridge
from repro_torch.training.optim import (AdamWConfig, OptState, adamw_update,
                                        tree_leaves, tree_map,
                                        tree_unflatten)
from repro_torch.training.schedules import Schedule, constant


def loss_and_grads(api: Any, params: Any, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Any]:
    """(loss, grads) of ``api.loss`` at ``params`` (JAX tree layout);
    grads in ``params``'s layout and dtypes, zeros for a parameter the
    forward does not reach (``jax.value_and_grad``'s convention)."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    loss, _ = api.loss(bridge.unstack_params(live), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads: List[torch.Tensor] = [torch.zeros_like(p) if g is None else g
                                 for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(api: Any, opt_cfg: AdamWConfig,
                    schedule: Optional[Schedule] = None, n_micro: int = 1,
                    accum_dtype: str = "float32",
                    grad_shardings: Any = None) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics); ``batch["tokens"]`` (B, L) on the params' device, B a
    multiple of ``n_micro``.  metrics: loss, grad_norm, lr_scale (device
    scalars)."""
    if grad_shardings is not None:
        raise NotImplementedError(
            "grad_shardings (the accumulation buffer's sharding over a "
            "device mesh) is not ported yet: ROADMAP Queue 1 item 12")
    schedule = schedule or constant()
    adt = getattr(torch, accum_dtype)

    def train_step(params, opt_state: OptState, batch: Dict[str, Any]):
        B = batch["tokens"].shape[0]
        if B % n_micro:
            raise ValueError(f"batch {B} is not a multiple of n_micro "
                             f"{n_micro}")
        mb = B // n_micro
        if n_micro == 1:
            loss, grads = loss_and_grads(api, params, batch)
        else:
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=adt,
                                                  device=p.device), params)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            for i in range(n_micro):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss, grads = loss_and_grads(api, params, micro)
                gsum = tree_map(lambda a, g: a + g.to(a.dtype), gsum, grads)
                lsum = lsum + loss
            grads = tree_map(lambda g: g / n_micro, gsum)
            loss = lsum / n_micro
        lr_scale = schedule(opt_state.step)
        params, opt_state, info = adamw_update(params, grads, opt_state,
                                               opt_cfg, lr_scale)
        metrics = {"loss": loss, **info, "lr_scale": lr_scale}
        return params, opt_state, metrics

    return train_step
