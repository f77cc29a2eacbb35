"""Decoder-only language model: the SSM family (``arch_type == "ssm"``).

Port of the SSM part of ``src/repro/models/lm.py``: the per-layer params
(``ln1`` + the mamba2 mixer), the teacher-forced forward, the serving
cache (``ssm`` / ``conv`` recurrent state, O(1) in the sequence length),
the layout-native one-token decode step and the prefill.  Layers are kept
unstacked, one dict per layer in a list (the JAX package stacks them for
``jax.lax.scan``; :func:`repro_torch.bridge.lm_params_from_jax` unstacks
them).  Forward only: every entry point runs under ``torch.no_grad``.

In-place updates: :func:`lm_decode_step_views` writes each layer's new
``ssm`` / ``conv`` state and ``len`` into the cache tensors IN PLACE;
rows that are not ``live`` keep them bit-identical.

Attention, MoE, hybrid and VLM branches are not ported: the dense-LM and
MoE families are ROADMAP Queue 1 item 7, the hybrid (hymba) and VLM
(qwen2-vl) families item 9.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.layers import embed as E
from repro_torch.layers import ssm as S
from repro_torch.layers.common import Params, rmsnorm, to_device
from repro_torch.models import layouts as LT


def check_family(cfg: ModelConfig) -> None:
    """Raise for the families of this module that are not ported."""
    if cfg.arch_type == "ssm" and not cfg.hybrid_parallel:
        return
    if cfg.hybrid_parallel or cfg.arch_type in ("hybrid", "vlm", "audio"):
        item = "item 9 (enc-dec, hybrid and VLM families)"
    else:
        item = "item 7 (the dense-LM and MoE families: LM attention, MoE)"
    raise NotImplementedError(
        f"{cfg.name}: only the SSM family of models/lm.py is ported; "
        f"{cfg.arch_type} models are ROADMAP Queue 1 {item}")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _init_layer(cfg: ModelConfig, gen: torch.Generator) -> Params:
    return {"ln1": {"scale": torch.ones(cfg.d_model)},
            "ssm": S.init_ssm(cfg, gen)}


def init_lm(cfg: ModelConfig, seed: int = 0,
            device: Optional[torch.device] = None) -> Params:
    """The port's own seeded init (float32, drawn on the CPU from one
    ``torch.Generator``: the embedding, then the layers in order).  It does
    not reproduce ``jax.random``: parity tests bridge the JAX weights."""
    check_family(cfg)
    gen = torch.Generator().manual_seed(seed)
    params = {"embed": E.init_embed(cfg, gen),
              "layers": [_init_layer(cfg, gen) for _ in range(cfg.n_layers)],
              "final_norm": {"scale": torch.ones(cfg.d_model)}}
    return to_device(params, device)


def prepare_params(params: Params, device: torch.device,
                   dtype: torch.dtype) -> Params:
    """Weights on ``device``, matrices cast once to the activation dtype;
    the norm scales and the mixer's float32 parameters stay float32."""
    return to_device(params, device, dtype, keep=("scale",) + S.F32_PARAMS)


# ---------------------------------------------------------------------------
# Forward (prefill trunk)
# ---------------------------------------------------------------------------


def _layer_fwd(layer: Params, x: torch.Tensor, cfg: ModelConfig
               ) -> torch.Tensor:
    out, _ = S.ssm_mixer(layer["ssm"], rmsnorm(layer["ln1"], x,
                                               cfg.norm_eps), cfg)
    return x + out


def embed_inputs(params: Params, tokens: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    return E.embed_tokens(params["embed"], tokens, getattr(torch, cfg.dtype))


@torch.no_grad()
def lm_forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced forward.  tokens (B, L) -> (logits (B, L, V) f32,
    aux loss 0)."""
    check_family(cfg)
    x = embed_inputs(params, tokens, cfg)
    for layer in params["layers"]:
        x = _layer_fwd(layer, x, cfg)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = E.lm_head(params["embed"], x, cfg.logit_softcap)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# Serving: cache init / decode / prefill
# ---------------------------------------------------------------------------

# Cache partition for the serving layer (repro_torch.models.api.
# DecodeState): true KV / recurrent state vs bookkeeping, and the batch
# ("slot") axis of every entry.
KV_KEYS = ("k", "v", "dense_k", "dense_v", "ssm", "conv")
CACHE_BATCH_AXES = {
    "len": 0, "done": 0, "k": 1, "v": 1, "dense_k": 1, "dense_v": 1,
    "ssm": 1, "conv": 1,
}
# Cache-layout metadata (repro_torch.models.layouts): the growing
# max_len-axis KV buffers a paged layout pages, and the float KV an int8
# layout may store as int8.  The ssm recurrent state is mutated every
# step (requantizing it would accumulate error) and has no length axis:
# every layout holds ssm / conv dense.
LENGTH_AXES = {"k": 2, "v": 2, "dense_k": 2, "dense_v": 2}
QUANT_FIELDS = ("k", "v", "dense_k", "dense_v")


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device: Optional[torch.device] = None
                  ) -> Dict[str, torch.Tensor]:
    """``len``/``done`` bookkeeping and the per-layer recurrent state:
    ``ssm`` (n_layers, B, H, P, N) f32 and ``conv`` (n_layers, B, K-1,
    conv_dim) in the activation dtype -- constant in ``max_len``."""
    check_family(cfg)
    del max_len                       # pure SSM: no positional buffer
    dims = S.ssm_dims(cfg)
    n = cfg.n_layers
    return {
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
        "done": torch.zeros((batch,), dtype=torch.bool, device=device),
        "ssm": torch.zeros((n, batch, dims.n_heads, dims.head_dim,
                            dims.n_state), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((n, batch, dims.d_conv - 1, dims.conv_dim),
                            dtype=getattr(torch, cfg.dtype), device=device),
    }


def _layer_decode(layer: Params, x: torch.Tensor,
                  cache_slice: Dict[str, LT.FieldView], cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Per-layer decode over KVViews (the recurrent state is never paged
    or quantized, so ``dense()`` is the view's own tensor).  Returns (x,
    the layer's new ssm / conv state)."""
    xn = rmsnorm(layer["ln1"], x, cfg.norm_eps)
    st = {"ssm": cache_slice["ssm"].dense(),
          "conv": cache_slice["conv"].dense()}
    out, st = S.ssm_mixer(layer["ssm"], xn, cfg, state=st)
    return x + out, st


@torch.no_grad()
def lm_decode_step_views(params: Params, cache: Dict[str, Any],
                         token: torch.Tensor, cfg: ModelConfig,
                         live: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Layout-native one-token decode.  ``cache`` maps bookkeeping names
    to tensors and KV names to FieldViews.  token (B,) -> (logits (B, V),
    cache), the cache updated IN PLACE; rows where ``live`` (B,) bool is
    False keep their state and ``len`` bit-identical."""
    check_family(cfg)
    x = E.embed_tokens(params["embed"], token[:, None],
                       getattr(torch, cfg.dtype))
    for i, layer in enumerate(params["layers"]):
        slc = {k: cache[k].layer(i) for k in ("ssm", "conv")}
        x, new = _layer_decode(layer, x, slc, cfg)
        for k in ("ssm", "conv"):
            old = slc[k].dense()
            val = new[k].to(old.dtype)
            if live is not None:
                val = torch.where(
                    live.reshape((-1,) + (1,) * (val.ndim - 1)), val, old)
            old.copy_(val)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = E.lm_head(params["embed"], x, cfg.logit_softcap)[:, 0]
    cache["len"] += 1 if live is None else live.to(cache["len"].dtype)
    return logits, cache


@torch.no_grad()
def lm_decode_step(params: Params, cache: Dict[str, torch.Tensor],
                   token: torch.Tensor, cfg: ModelConfig,
                   live: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Dense-dict one-token decode: :func:`lm_decode_step_views` over
    DenseViews of ``cache`` (updated IN PLACE) -- the oracle of the
    layout-native step.  Returns (logits (B, V), cache)."""
    views = {k: LT.DenseView(v, CACHE_BATCH_AXES[k]) if k in KV_KEYS else v
             for k, v in cache.items()}
    logits, _ = lm_decode_step_views(params, views, token, cfg, live)
    return logits, cache


@torch.no_grad()
def lm_prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
               max_len: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Process a prompt, filling the recurrent state: each layer's mixer
    runs in streaming mode from a zero state.  tokens (B, L).  Returns
    (last-position logits (B, V), cache)."""
    check_family(cfg)
    B, L = tokens.shape
    x = embed_inputs(params, tokens, cfg)
    cache = init_kv_cache(cfg, B, max_len, device=tokens.device)
    for i, layer in enumerate(params["layers"]):
        xn = rmsnorm(layer["ln1"], x, cfg.norm_eps)
        st0 = {"ssm": torch.zeros_like(cache["ssm"][i]),
               "conv": torch.zeros_like(cache["conv"][i])}
        out, st = S.ssm_mixer(layer["ssm"], xn, cfg, state=st0)
        cache["ssm"][i] = st["ssm"]
        cache["conv"][i] = st["conv"].to(cache["conv"].dtype)
        x = x + out
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = E.lm_head(params["embed"], x[:, -1:], cfg.logit_softcap)[:, 0]
    cache["len"].fill_(L)
    return logits, cache
