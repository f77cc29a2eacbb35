"""Decoder-only language model: the SSM family (``arch_type == "ssm"``)
and the dense attention LMs (``arch_type == "dense"``).

Port of the SSM and attention parts of ``src/repro/models/lm.py``: the
per-layer windows, the per-layer params (``ln1`` + the mamba2 mixer, or
``ln1`` + GQA attention + ``ln2`` + a SwiGLU FFN), the teacher-forced
forward, the serving cache (``ssm`` / ``conv`` recurrent state, O(1) in
the sequence length; or ``k`` / ``v`` of shape (layers, B, max_len, KV,
hd)), the layout-native one-token decode step and the prefill.  Layers
are kept unstacked, one dict per layer in a list (the JAX package stacks
them for ``jax.lax.scan``; :func:`repro_torch.bridge.lm_params_from_jax`
unstacks them).  Forward only: every entry point runs under
``torch.no_grad``.

Attention runs on the port's kernels: every multi-query attention
(forward, prefill) is K2, causal with the layer's window; the decode step
attends slots ``[max(0, len + 1 - window), len + 1)`` through the
layout's view (K1 / K1-int8 over ``[lo, hi)``, K3 / K3-int8 with its
``window``).  The JAX package picks ``sdpa`` or its blocked flash by
sequence length (``FLASH_THRESHOLD``); both compute the function K2
computes.  The base transformer of the paper (``tconst-41m`` with
``attention_mode="full"``) is this family, initialised with the same
draws as the TConst model's layers.

In-place updates: :func:`lm_decode_step_views` writes each layer's new
state (SSM: ``ssm`` / ``conv``; attention: the token's K/V through the
view) and ``len`` into the cache tensors IN PLACE; rows that are not
``live`` keep them bit-identical.

Not ported: MoE (``layers/moe.py``, DeepSeek's ``dense_layers``) is
ROADMAP Queue 1 item 7b; ``lm_prefill_chunk`` and
``lm_verify_chunk_views`` come with their callers in item 8; the hybrid
(hymba) and VLM (qwen2-vl) families are item 9.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.layers import attention as A
from repro_torch.layers import embed as E
from repro_torch.layers import ssm as S
from repro_torch.layers.common import Params, rmsnorm, to_device
from repro_torch.layers.mlp import init_swiglu, swiglu
from repro_torch.layers.rope import apply_rope, rope_cos_sin
from repro_torch.models import layouts as LT


def check_family(cfg: ModelConfig) -> None:
    """Raise for the families of this module that are not ported."""
    if cfg.hybrid_parallel or cfg.arch_type in ("hybrid", "vlm", "audio"):
        item = "item 9 (enc-dec, hybrid and VLM families)"
    elif cfg.is_moe or cfg.arch_type == "moe":
        item = ("item 7b (the MoE family: layers/moe.py, route_topk, "
                "dense_layers)")
    else:
        return                      # ssm, or a dense attention LM
    raise NotImplementedError(
        f"{cfg.name}: {cfg.arch_type} models of models/lm.py are not "
        f"ported yet: ROADMAP Queue 1 {item}")


def _has_attention(cfg: ModelConfig) -> bool:
    return cfg.arch_type != "ssm"


def layer_windows(cfg: ModelConfig) -> List[int]:
    """Per-layer sliding window, 0 meaning full causal: gemma3's
    ``local_global_ratio`` local layers then one global, repeating; every
    layer under ``attention_mode="sliding"``; else none."""
    n = cfg.n_layers
    if cfg.local_global_ratio > 0:
        period = cfg.local_global_ratio + 1
        return [0 if i % period == cfg.local_global_ratio
                else cfg.sliding_window for i in range(n)]
    if cfg.attention_mode == "sliding" and cfg.sliding_window > 0:
        return [cfg.sliding_window] * n
    return [0] * n


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _init_layer(cfg: ModelConfig, gen: torch.Generator) -> Params:
    d = cfg.d_model
    if not _has_attention(cfg):
        return {"ln1": {"scale": torch.ones(d)}, "ssm": S.init_ssm(cfg, gen)}
    # attention, then the FFN: the draws of a TConst layer, so the base
    # transformer of tconst-41m gets the TConst model's weights
    return {"ln1": {"scale": torch.ones(d)},
            "attn": A.init_attention(cfg, gen),
            "ln2": {"scale": torch.ones(d)},
            "ffn": init_swiglu(d, cfg.d_ff, gen)}


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


def _rope(pos: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    return rope_cos_sin(pos, cfg.resolved_head_dim, cfg.rope_theta)


def _ssm_layer_fwd(layer: Params, x: torch.Tensor, cfg: ModelConfig
                   ) -> torch.Tensor:
    out, _ = S.ssm_mixer(layer["ssm"], rmsnorm(layer["ln1"], x,
                                               cfg.norm_eps), cfg)
    return x + out


def _attn_layer_fwd(layer: Params, x: torch.Tensor, pos: torch.Tensor,
                    window: int, cfg: ModelConfig, cos: torch.Tensor,
                    sin: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence attention layer: causal self-attention (K2) with the
    layer's window, then the SwiGLU FFN.  pos (B, L) token positions.
    Returns (x, the layer's RoPE'd K (B, L, KV, hd), its V)."""
    eps = cfg.norm_eps
    xn = rmsnorm(layer["ln1"], x, eps)
    dtype = xn.dtype
    q, k, v = A.qkv_proj(layer["attn"], xn, xn, dtype)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = ops.flash_attention(q, k, v, pos, pos, causal=True, window=window,
                            softcap=cfg.logit_softcap)
    x = x + A.out_proj(layer["attn"], o, dtype)
    x = x + swiglu(layer["ffn"], rmsnorm(layer["ln2"], x, eps))
    return x, k, v


def _positions(B: int, L: int, cfg: ModelConfig, device: torch.device):
    """(B, L) int32 positions 0..L-1 and their RoPE tables (L, hd/2)."""
    pos = torch.arange(L, dtype=torch.int32, device=device)
    cos, sin = _rope(pos, cfg)
    return pos[None].expand(B, L), cos, sin


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
    if _has_attention(cfg):
        pos, cos, sin = _positions(*tokens.shape, cfg, x.device)
        for layer, window in zip(params["layers"], layer_windows(cfg)):
            x, _, _ = _attn_layer_fwd(layer, x, pos, window, cfg, cos, sin)
    else:
        for layer in params["layers"]:
            x = _ssm_layer_fwd(layer, x, cfg)
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
    """``len``/``done`` bookkeeping and the per-layer state: attention
    LMs ``k`` / ``v`` (n_layers, B, max_len, KV, hd) in the activation
    dtype; the SSM ``ssm`` (n_layers, B, H, P, N) f32 and ``conv``
    (n_layers, B, K-1, conv_dim) in the activation dtype -- constant in
    ``max_len``."""
    check_family(cfg)
    n = cfg.n_layers
    dt = getattr(torch, cfg.dtype)
    cache = {"len": torch.zeros((batch,), dtype=torch.int32, device=device),
             "done": torch.zeros((batch,), dtype=torch.bool, device=device)}
    if _has_attention(cfg):
        shape = (n, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        cache["k"] = torch.zeros(shape, dtype=dt, device=device)
        cache["v"] = torch.zeros(shape, dtype=dt, device=device)
        return cache
    dims = S.ssm_dims(cfg)
    cache["ssm"] = torch.zeros((n, batch, dims.n_heads, dims.head_dim,
                                dims.n_state), dtype=torch.float32,
                               device=device)
    cache["conv"] = torch.zeros((n, batch, dims.d_conv - 1, dims.conv_dim),
                                dtype=dt, device=device)
    return cache


def _ssm_layer_decode(layer: Params, x: torch.Tensor,
                      cache_slice: Dict[str, LT.FieldView], cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Per-layer SSM decode over KVViews (the recurrent state is never
    paged or quantized, so ``dense()`` is the view's own tensor).
    Returns (x, the layer's new ssm / conv state)."""
    xn = rmsnorm(layer["ln1"], x, cfg.norm_eps)
    st = {"ssm": cache_slice["ssm"].dense(),
          "conv": cache_slice["conv"].dense()}
    out, st = S.ssm_mixer(layer["ssm"], xn, cfg, state=st)
    return x + out, st


def _ssm_decode(params: Params, cache: Dict[str, Any], x: torch.Tensor,
                cfg: ModelConfig, live: Optional[torch.Tensor]
                ) -> torch.Tensor:
    for i, layer in enumerate(params["layers"]):
        slc = {k: cache[k].layer(i) for k in ("ssm", "conv")}
        x, new = _ssm_layer_decode(layer, x, slc, cfg)
        for k in ("ssm", "conv"):
            old = slc[k].dense()
            val = new[k].to(old.dtype)
            if live is not None:
                val = torch.where(
                    live.reshape((-1,) + (1,) * (val.ndim - 1)), val, old)
            old.copy_(val)
    return x


def _attn_decode(params: Params, cache: Dict[str, Any], x: torch.Tensor,
                 cfg: ModelConfig, live: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """The attention layers of one decode step: each writes the token's
    K/V at slot ``len`` through the views (masked by ``live``; a row whose
    buffer is full is not written) and attends slots ``[max(0, len + 1 -
    window), len + 1)``."""
    eps = cfg.norm_eps
    length = cache["len"]
    max_len = LT.field_length(cache["k"])
    write = length < max_len
    if live is not None:
        write = write & live
    slot = length.clamp(max=max_len - 1)
    hi = length + 1
    cos, sin = _rope(length[:, None], cfg)
    for i, (layer, window) in enumerate(zip(params["layers"],
                                            layer_windows(cfg))):
        out, _ = A.decode_attend_view(
            layer["attn"], rmsnorm(layer["ln1"], x, eps), cache["k"].layer(i),
            cache["v"].layer(i), slot, write, None, hi, cos, sin,
            cfg.logit_softcap, window)
        x = x + out
        x = x + swiglu(layer["ffn"], rmsnorm(layer["ln2"], x, eps))
    return x


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
    decode = _attn_decode if _has_attention(cfg) else _ssm_decode
    x = decode(params, cache, x, cfg, live)
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
    """Process a prompt, filling the cache: an attention layer writes its
    RoPE'd K/V into the first L slots (the forward's own K2 pass); an SSM
    layer's mixer runs in streaming mode from a zero state.  tokens
    (B, L).  Returns (last-position logits (B, V), cache)."""
    check_family(cfg)
    B, L = tokens.shape
    x = embed_inputs(params, tokens, cfg)
    cache = init_kv_cache(cfg, B, max_len, device=tokens.device)
    if _has_attention(cfg):
        pos, cos, sin = _positions(B, L, cfg, x.device)
        for i, (layer, window) in enumerate(zip(params["layers"],
                                                layer_windows(cfg))):
            x, k, v = _attn_layer_fwd(layer, x, pos, window, cfg, cos, sin)
            cache["k"][i, :, :L] = k
            cache["v"][i, :, :L] = v
    else:
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
