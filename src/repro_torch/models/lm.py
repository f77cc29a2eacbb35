"""Decoder-only language model: the SSM family (``arch_type == "ssm"``),
the dense attention LMs (``arch_type == "dense"``) and the MoE family
(``cfg.is_moe``: mixtral, deepseek).

Port of the SSM, attention and MoE parts of ``src/repro/models/lm.py``:
the per-layer windows, the per-layer params (``ln1`` + the mamba2 mixer,
or ``ln1`` + GQA attention + ``ln2`` + an FFN: a SwiGLU, or the MoE FFN of
:mod:`repro_torch.layers.moe`), the teacher-forced forward (returning the
summed MoE aux loss), the serving cache (``ssm`` / ``conv`` recurrent
state, O(1) in the sequence length; or ``k`` / ``v`` of shape (layers,
B, max_len, KV, hd)), the layout-native one-token decode step and the
prefill.  DeepSeek's ``first_dense_layers`` are SwiGLU layers kept apart
as JAX keeps them: ``params["dense_layers"]`` runs before
``params["layers"]`` with windows ``[0, n_dense)``, and caches its K/V
in ``dense_k`` / ``dense_v`` of shape (n_dense, B, max_len, KV, hd),
beside ``k`` / ``v`` over the ``n_layers - n_dense`` MoE layers.  Layers
are kept unstacked, one dict per layer in a list (the JAX package stacks
them for ``jax.lax.scan``; :func:`repro_torch.bridge.lm_params_from_jax`
unstacks them).  The teacher-forced :func:`lm_forward` is
differentiable for the dense attention LMs (training: K2 with its
backward); the serving entry points run under ``torch.no_grad``.
Training the MoE and SSM families is not ported (``ModelAPI.loss``
refuses them: ROADMAP Queue 1 items 10b and 10c).

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
``live`` keep them bit-identical.  The MoE FFN routes all B rows, live
or not, as JAX's decode step does: a row that is not live still takes
expert capacity, so once capacity binds a row's output depends on its
batch (GShard semantics).

Not ported: ``lm_prefill_chunk`` and ``lm_verify_chunk_views`` come with
their callers in ROADMAP Queue 1 item 8; the hybrid (hymba) and VLM
(qwen2-vl) families are item 9.
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
from repro_torch.layers.moe import init_moe, moe_ffn
from repro_torch.layers.rope import apply_rope, rope_cos_sin
from repro_torch.models import layouts as LT


def check_family(cfg: ModelConfig) -> None:
    """Raise for the families of this module that are not ported."""
    if cfg.hybrid_parallel or cfg.arch_type in ("hybrid", "vlm", "audio"):
        raise NotImplementedError(
            f"{cfg.name}: {cfg.arch_type} models of models/lm.py are not "
            f"ported yet: ROADMAP Queue 1 item 9 (enc-dec, hybrid and VLM "
            f"families)")


def _has_attention(cfg: ModelConfig) -> bool:
    return cfg.arch_type != "ssm"


def n_dense_layers(cfg: ModelConfig) -> int:
    """DeepSeek's leading dense (SwiGLU) layers of an MoE model; 0 for
    every other model."""
    return cfg.first_dense_layers if cfg.is_moe else 0


def _attn_layers(params: Params, cfg: ModelConfig
                 ) -> List[Tuple[Params, int, bool, str, int]]:
    """Every attention layer in order, as (layer, window, moe, the prefix
    of its cache fields, its index there): ``dense_layers`` (windows
    ``[0, n_dense)``, fields ``dense_k`` / ``dense_v``), then ``layers``
    (``windows[n_dense:]``, ``k`` / ``v``; MoE FFNs in an MoE model)."""
    windows = layer_windows(cfg)
    dense = params.get("dense_layers", [])
    out = [(layer, windows[i], False, "dense_", i)
           for i, layer in enumerate(dense)]
    return out + [(layer, windows[len(dense) + i], cfg.is_moe, "", i)
                  for i, layer in enumerate(params["layers"])]


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


def _init_layer(cfg: ModelConfig, gen: torch.Generator, moe: bool = False,
                dtype: Optional[torch.dtype] = None) -> Params:
    d = cfg.d_model

    def norm():
        return {"scale": torch.ones(d, device=gen.device)}

    if not _has_attention(cfg):
        return {"ln1": norm(), "ssm": S.init_ssm(cfg, gen)}
    # attention, then the FFN: the draws of a TConst layer, so the base
    # transformer of tconst-41m gets the TConst model's weights
    return {"ln1": norm(), "attn": A.init_attention(cfg, gen, dtype),
            "ln2": norm(),
            "ffn": init_moe(cfg, gen, dtype) if moe else
            init_swiglu(d, cfg.d_ff, gen, dtype)}


def init_lm(cfg: ModelConfig, seed: int = 0,
            device: Optional[torch.device] = None) -> Params:
    """The port's own seeded init: the embedding, then the layers in
    order, from one ``torch.Generator``.  It does not reproduce
    ``jax.random``: parity tests bridge the JAX weights.

    The SSM and dense attention LMs draw float32 on the CPU (their weights
    are fixed by that).  The MoE family draws on ``device`` with a
    generator of that device and casts each tensor to the activation
    dtype as it is drawn, so at most one float32 tensor is the extra peak
    (deepseek-moe-16b: 16.4 B parameters, its largest tensor ``w_gate``
    738 MB in float32) and a full-width init takes seconds on a card; its
    norm scales stay float32.  So an MoE model's weights depend on the
    device's generator: a run that compares two devices copies one
    device's weights to the other."""
    check_family(cfg)
    moe = cfg.is_moe
    dev = torch.device("cpu") if device is None or not moe \
        else torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = getattr(torch, cfg.dtype) if moe else None
    n_dense = n_dense_layers(cfg)
    params: Params = {"embed": E.init_embed(cfg, gen, dtype)}
    if n_dense:
        params["dense_layers"] = [_init_layer(cfg, gen, False, dtype)
                                  for _ in range(n_dense)]
    params["layers"] = [_init_layer(cfg, gen, moe, dtype)
                        for _ in range(cfg.n_layers - n_dense)]
    params["final_norm"] = {"scale": torch.ones(cfg.d_model, device=dev)}
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


def _ffn(layer: Params, xn: torch.Tensor, cfg: ModelConfig, moe: bool
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's FFN: (output, the MoE aux loss, or None for a
    SwiGLU)."""
    if moe:
        return moe_ffn(layer["ffn"], xn, cfg)
    return swiglu(layer["ffn"], xn), None


def _attn_layer_fwd(layer: Params, x: torch.Tensor, pos: torch.Tensor,
                    window: int, cfg: ModelConfig, cos: torch.Tensor,
                    sin: torch.Tensor, moe: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               Optional[torch.Tensor]]:
    """Full-sequence attention layer: causal self-attention (K2) with the
    layer's window, then the FFN (``moe``: the MoE FFN).  pos (B, L) token
    positions.  Returns (x, the layer's RoPE'd K (B, L, KV, hd), its V,
    the MoE aux loss or None)."""
    eps = cfg.norm_eps
    xn = rmsnorm(layer["ln1"], x, eps)
    dtype = xn.dtype
    q, k, v = A.qkv_proj(layer["attn"], xn, xn, dtype)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = ops.flash_attention(q, k, v, pos, pos, causal=True, window=window,
                            softcap=cfg.logit_softcap)
    x = x + A.out_proj(layer["attn"], o, dtype)
    f, aux = _ffn(layer, rmsnorm(layer["ln2"], x, eps), cfg, moe)
    return x + f, k, v, aux


def _positions(B: int, L: int, cfg: ModelConfig, device: torch.device):
    """(B, L) int32 positions 0..L-1 and their RoPE tables (L, hd/2)."""
    pos = torch.arange(L, dtype=torch.int32, device=device)
    cos, sin = _rope(pos, cfg)
    return pos[None].expand(B, L), cos, sin


def embed_inputs(params: Params, tokens: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    return E.embed_tokens(params["embed"], tokens, getattr(torch, cfg.dtype))


def lm_forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced forward.  tokens (B, L) -> (logits (B, L, V) f32,
    the MoE layers' summed aux loss, 0 without MoE layers).
    Differentiable for the dense attention LMs (JAX remats its layer
    scan; nothing is rematerialised here)."""
    check_family(cfg)
    x = embed_inputs(params, tokens, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if _has_attention(cfg):
        pos, cos, sin = _positions(*tokens.shape, cfg, x.device)
        for layer, window, moe, _, _ in _attn_layers(params, cfg):
            x, _, _, a = _attn_layer_fwd(layer, x, pos, window, cfg, cos,
                                         sin, moe)
            if a is not None:
                aux = aux + a
    else:
        for layer in params["layers"]:
            x = _ssm_layer_fwd(layer, x, cfg)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = E.lm_head(params["embed"], x, cfg.logit_softcap)
    return logits, aux


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
    LMs ``k`` / ``v`` (n_layers - n_dense, B, max_len, KV, hd) and, for
    DeepSeek's leading dense layers, ``dense_k`` / ``dense_v`` (n_dense,
    B, max_len, KV, hd), in the activation dtype; the SSM ``ssm``
    (n_layers, B, H, P, N) f32 and ``conv`` (n_layers, B, K-1, conv_dim)
    in the activation dtype -- constant in ``max_len``."""
    check_family(cfg)
    n = cfg.n_layers
    dt = getattr(torch, cfg.dtype)
    cache = {"len": torch.zeros((batch,), dtype=torch.int32, device=device),
             "done": torch.zeros((batch,), dtype=torch.bool, device=device)}
    if _has_attention(cfg):
        n_dense = n_dense_layers(cfg)
        row = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        for prefix, layers in (("", n - n_dense), ("dense_", n_dense)):
            if layers:
                for f in ("k", "v"):
                    cache[prefix + f] = torch.zeros((layers,) + row,
                                                    dtype=dt, device=device)
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
    for layer, window, moe, prefix, i in _attn_layers(params, cfg):
        out, _ = A.decode_attend_view(
            layer["attn"], rmsnorm(layer["ln1"], x, eps),
            cache[prefix + "k"].layer(i), cache[prefix + "v"].layer(i), slot,
            write, None, hi, cos, sin, cfg.logit_softcap, window)
        x = x + out
        f, _ = _ffn(layer, rmsnorm(layer["ln2"], x, eps), cfg, moe)
        x = x + f
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
    RoPE'd K/V into the first L slots of its fields (the forward's own K2
    pass; DeepSeek's dense layers into ``dense_k`` / ``dense_v``); an SSM
    layer's mixer runs in streaming mode from a zero state.  tokens
    (B, L).  Returns (last-position logits (B, V), cache)."""
    check_family(cfg)
    B, L = tokens.shape
    x = embed_inputs(params, tokens, cfg)
    cache = init_kv_cache(cfg, B, max_len, device=tokens.device)
    if _has_attention(cfg):
        pos, cos, sin = _positions(B, L, cfg, x.device)
        for layer, window, moe, prefix, i in _attn_layers(params, cfg):
            x, k, v, _ = _attn_layer_fwd(layer, x, pos, window, cfg, cos,
                                         sin, moe)
            cache[prefix + "k"][i, :, :L] = k
            cache[prefix + "v"][i, :, :L] = v
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
