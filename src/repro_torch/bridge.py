"""Weight bridge: the JAX package's parameter pytrees -> the port's params.

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

The caller turns the JAX leaves into numpy arrays first; this module
never imports JAX.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def _tensor(a: Any, device: Optional[torch.device]) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


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
