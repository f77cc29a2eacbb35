"""Weight bridge: the JAX package's parameter pytrees <-> the port's params.

The JAX TConst model stacks its blocks on a leading ``n_blocks`` axis
(``jax.vmap`` over the block init), with ``blocks["layers"]`` a list of
per-layer dicts whose leaves carry that axis; the port keeps a list of
blocks, each ``{"layers": [...]}`` with unstacked leaves.  Weight layouts
are the same on both sides: ``wq``/``wk``/``wv`` (d, H|KV, hd), ``wo``
(H, hd, d), SwiGLU ``w_gate``/``w_up`` (d, ff) and ``w_down`` (ff, d),
norms ``{"scale": (d,)}``, and the tied head reads ``embed.tok``.

The JAX decoder-only LM (``models/lm.py::init_lm``) stacks its layers on
a leading ``n_layers`` axis the same way; the port keeps a list of
per-layer dicts in the JAX layouts -- ``ln1`` and, for the SSM family,
the mixer's ``in_proj``/``conv_w``/``conv_b``/``dt_bias``/``a_log``/
``d_skip``/``norm_scale``/``out_proj``; for the dense attention LMs
``attn`` (``wq``/``wk``/``wv``/``wo``), ``ln2`` and the SwiGLU ``ffn``
(for the MoE family the MoE ``ffn``: ``router`` (d, E), ``w_gate`` /
``w_up`` (E, d, ff), ``w_down`` (E, ff, d) and the ``shared`` SwiGLU;
DeepSeek's leading ``dense_layers`` are already a list in JAX) -- beside
``embed.tok`` / ``embed.head`` and ``final_norm``.

The trainer keeps its parameters and optimizer state in the JAX tree
layout (:func:`stack_params`; AdamW's decay and factoring depend on a
leaf's rank, :mod:`repro_torch.training.optim`), and the model reads
per-block / per-layer views of it (:func:`unstack_params`).
:func:`params_to_jax` is the inverse of :func:`params_from_jax` and
:func:`lm_params_from_jax`; :func:`opt_state_to_jax` /
:func:`opt_state_from_jax` carry the optimizer state (step, m, v, the
factored ``vr`` / ``vc``) both ways.  numpy has no bfloat16 without
``ml_dtypes``: a bf16 tensor goes to JAX as its exact float32 values, and
a JAX bfloat16 array comes in through its 16-bit pattern.

The caller turns the JAX leaves into numpy arrays first; this module
never imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch


def _tensor(a: Any, device: Optional[torch.device]) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":        # ml_dtypes' bfloat16 from JAX
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def params_from_jax(tree: Any, device: Any = None) -> Any:
    """``tree``: the JAX ``init_tconst_lm`` pytree with numpy leaves.
    Returns the port's params (float32 tensors as stored) on ``device``
    (default: CPU)."""
    blocks = tree["blocks"]
    nb = int(np.shape(blocks["layers"][0]["ln1"]["scale"])[0])
    return {
        "embed": _map(tree["embed"], lambda a: _tensor(a, device)),
        "blocks": [{"layers": [_map(layer, lambda a, i=ib: _tensor(a[i],
                                                                   device))
                               for layer in blocks["layers"]]}
                   for ib in range(nb)],
        "final_norm": _map(tree["final_norm"],
                           lambda a: _tensor(a, device)),
    }


def lm_params_from_jax(tree: Any, device: Any = None) -> Any:
    """``tree``: the JAX ``init_lm`` pytree with numpy leaves (layers
    stacked on a leading ``n_layers - n_dense`` axis; an MoE model's
    leading ``dense_layers`` a list of unstacked layers).  Returns the
    port's LM params (float32 tensors as stored) on ``device`` (default:
    CPU)."""
    layers = tree["layers"]
    n = int(np.shape(layers["ln1"]["scale"])[0])
    out = {"embed": _map(tree["embed"], lambda a: _tensor(a, device))}
    if "dense_layers" in tree:
        out["dense_layers"] = _map(tree["dense_layers"],
                                   lambda a: _tensor(a, device))
    out["layers"] = [_map(layers, lambda a, i=i: _tensor(a[i], device))
                     for i in range(n)]
    out["final_norm"] = _map(tree["final_norm"],
                             lambda a: _tensor(a, device))
    return out


# ---------------------------------------------------------------------------
# the JAX tree layout (training) and the way back
# ---------------------------------------------------------------------------


def _stack(trees: List[Any]) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], (list, tuple)):
        return [_stack([t[i] for t in trees]) for i in range(len(trees[0]))]
    return torch.stack(trees)


def stack_params(params: Any) -> Any:
    """The port's params (TConst: ``"blocks"``; LM: ``"layers"``) in the
    JAX package's tree layout, as tensors: each TConst layer's leaves
    stacked over the blocks, an LM's layers stacked on a leading axis
    (DeepSeek's ``dense_layers`` stay a list).  Copies."""
    out = {"embed": params["embed"]}
    if "blocks" in params:
        blocks = params["blocks"]
        out["blocks"] = {"layers": [
            _stack([b["layers"][i] for b in blocks])
            for i in range(len(blocks[0]["layers"]))]}
    else:
        if "dense_layers" in params:
            out["dense_layers"] = params["dense_layers"]
        out["layers"] = _stack(params["layers"])
    out["final_norm"] = params["final_norm"]
    return out


def unstack_params(tree: Any) -> Any:
    """Inverse of :func:`stack_params`: the port's per-block / per-layer
    params as views of the stacked leaves (no copy; autograd carries the
    gradients back to them)."""
    out = {"embed": tree["embed"]}
    if "blocks" in tree:
        layers = tree["blocks"]["layers"]
        nb = int(layers[0]["ln1"]["scale"].shape[0])
        out["blocks"] = [{"layers": [_map(layer, lambda a, i=ib: a[i])
                                     for layer in layers]}
                         for ib in range(nb)]
    else:
        if "dense_layers" in tree:
            out["dense_layers"] = tree["dense_layers"]
        n = int(tree["layers"]["ln1"]["scale"].shape[0])
        out["layers"] = [_map(tree["layers"], lambda a, i=i: a[i])
                         for i in range(n)]
    out["final_norm"] = tree["final_norm"]
    return out


def params_to_jax(params: Any) -> Any:
    """The port's params as the JAX package's pytree with numpy leaves:
    the inverse of :func:`params_from_jax` and
    :func:`lm_params_from_jax`."""
    return _map(stack_params(params), _numpy)


def opt_state_to_jax(state: Any) -> Dict[str, Any]:
    """The port's optimizer state (``training.optim.OptState`` in the JAX
    tree layout) as ``{"step", "m", "v"}`` with numpy leaves -- the
    fields of JAX's ``OptState``."""
    return {"step": _numpy(state.step), "m": _map(state.m, _numpy),
            "v": _map(state.v, _numpy)}


def opt_state_from_jax(state: Any, device: Any = None) -> Any:
    """JAX's ``OptState`` (or its ``_asdict()``) with numpy leaves as the
    port's ``OptState`` on ``device`` (dtypes as stored)."""
    from repro_torch.training.optim import OptState
    if not isinstance(state, dict):
        state = state._asdict()
    conv = lambda a: _tensor(a, device)  # noqa: E731
    return OptState(step=conv(state["step"]), m=_map(state["m"], conv),
                    v=_map(state["v"], conv))
