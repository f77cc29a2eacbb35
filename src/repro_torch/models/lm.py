"""Decoder-only language model: the SSM family (``arch_type == "ssm"``),
the dense attention LMs (``arch_type == "dense"``), the MoE family
(``cfg.is_moe``: mixtral, deepseek), the hybrid (``hybrid_parallel``:
hymba) and the VLM (``arch_type == "vlm"``: qwen2-vl).

Port of ``src/repro/models/lm.py``: the per-layer windows, the per-layer
params (``ln1`` + the mamba2 mixer, or ``ln1`` + GQA attention + ``ln2``
+ an FFN: a SwiGLU, or the MoE FFN of :mod:`repro_torch.layers.moe`; a
hybrid layer holds a mamba2 mixer beside its attention, on the same
normed input, and takes the mean of the two outputs), the teacher-forced
forward (returning the summed MoE aux loss), the serving cache (``ssm`` /
``conv`` recurrent state, O(1) in the sequence length; ``k`` / ``v`` of
shape (layers, B, max_len, KV, hd); a hybrid holds both), the
layout-native one-token decode step and the prefill.  The VLM's inputs
are JAX's: ``vision_embeds`` (B, Tv, frontend_dim) from the stub vision
encoder, projected by ``frontend_proj`` and scattered, in order, into
the prompt positions ``vision_mask`` (B, L) marks; ``positions3`` (3, B,
L) drive its M-RoPE sections (text positions, all three streams equal,
when absent).  DeepSeek's ``first_dense_layers`` are SwiGLU layers kept apart
as JAX keeps them: ``params["dense_layers"]`` runs before
``params["layers"]`` with windows ``[0, n_dense)``, and caches its K/V
in ``dense_k`` / ``dense_v`` of shape (n_dense, B, max_len, KV, hd),
beside ``k`` / ``v`` over the ``n_layers - n_dense`` MoE layers.  Layers
are kept unstacked, one dict per layer in a list (the JAX package stacks
them for ``jax.lax.scan``; :func:`repro_torch.bridge.lm_params_from_jax`
unstacks them).  The teacher-forced :func:`lm_forward` is
differentiable for every family (training): attention runs K2 with its
backward; the MoE FFN passes its gradient through the renormalised top-k
gates and the aux loss's mean router probability; a mamba2 mixer (the
SSM family, the hybrid's parallel heads) runs K4 with its backward
kernel (``ops.SSDScan``); a VLM's gradient reaches ``frontend_proj``
through the marked positions only, as JAX's does.  The serving entry
points run under ``torch.no_grad``.

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

:func:`lm_prefill_chunk` is one fixed-shape chunk of the chunked,
KV-conditioned admission (``models/api.py``): the chunk's queries attend
the batch-1 row cache's resident positions and the chunk itself (K2 at
the chunk's shape), and an SSM (or hybrid) layer's mixer runs from the carried
``ssm`` / ``conv`` state (K4 from an initial state).

Not ported: ``lm_verify_chunk_views`` comes with its caller (speculative
decoding, ROADMAP Queue 1 item 8).  The encoder-decoder is
:mod:`repro_torch.models.encdec`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.layers import attention as A
from repro_torch.layers import embed as E
from repro_torch.layers import ssm as S
from repro_torch.layers.common import Params, rmsnorm, to_device
from repro_torch.layers.mlp import init_swiglu, swiglu
from repro_torch.layers.moe import init_moe, moe_ffn
from repro_torch.layers.rope import (apply_rope, mrope_cos_sin,
                                     rope_cos_sin, text_positions3)
from repro_torch.models import layouts as LT


def check_family(cfg: ModelConfig) -> None:
    """Raise for the enc-dec, which is :mod:`repro_torch.models.encdec`'s;
    every decoder-only family is served here."""
    if cfg.is_encdec:
        raise ValueError(f"{cfg.name}: an encoder-decoder is served by "
                         f"models/encdec.py, not the decoder-only LM")


def _has_attention(cfg: ModelConfig) -> bool:
    return cfg.arch_type != "ssm"


def _has_ssm(cfg: ModelConfig) -> bool:
    """A mamba2 mixer in every layer: the SSM family, or beside the
    attention in the hybrid's."""
    return cfg.arch_type == "ssm" or cfg.hybrid_parallel


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
    # transformer of tconst-41m gets the TConst model's weights; a
    # hybrid draws its mixer between the two
    layer = {"ln1": norm(), "attn": A.init_attention(cfg, gen, dtype)}
    if cfg.hybrid_parallel:
        layer["ssm"] = S.init_ssm(cfg, gen)
    layer["ln2"] = norm()
    layer["ffn"] = init_moe(cfg, gen, dtype) if moe else \
        init_swiglu(d, cfg.d_ff, gen, dtype)
    return layer


def init_lm(cfg: ModelConfig, seed: int = 0,
            device: Optional[torch.device] = None,
            param_dtype: Optional[torch.dtype] = None) -> Params:
    """The port's own seeded init: the embedding, then the layers in
    order, from one ``torch.Generator``.  It does not reproduce
    ``jax.random``: parity tests bridge the JAX weights.  A model of n
    layers draws the first n layers of a deeper one of its config.

    The SSM and dense attention LMs draw float32 on the CPU (their weights
    are fixed by that).  The hybrid and the VLM (1.4-1.5 B parameters at
    full width: ~6 GB of float32 and tens of seconds on a host) draw
    float32 on ``device``.  The MoE family draws on ``device`` too, each
    tensor in float32, and keeps it in ``param_dtype``: by default
    (serving) the activation dtype, cast as it is drawn, so at most one
    float32 tensor is the extra peak (deepseek-moe-16b: 16.4 B
    parameters, its largest tensor ``w_gate`` 738 MB in float32) and a
    full-width init takes seconds on a card; training passes float32,
    JAX's ``param_dtype`` (``launch.train.load``: the train state's
    leaves, which a bf16 AdamW update would round away), so the serving
    weights are the training init's rounded to the activation dtype.
    Norm scales stay float32.  So the weights of a family drawn on
    ``device`` depend on the device's generator: a run that compares two
    devices copies one device's weights to the other."""
    check_family(cfg)
    moe = cfg.is_moe
    on_device = moe or cfg.hybrid_parallel or cfg.arch_type == "vlm"
    dev = torch.device("cpu") if device is None or not on_device \
        else torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = (param_dtype or getattr(torch, cfg.dtype)) if moe else None
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


def _rope(pos: torch.Tensor, cfg: ModelConfig,
          positions3: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE tables of ``pos`` (JAX's ``_rope_tables``): an M-RoPE config
    rotates by ``positions3`` (3, ..., L), or by ``pos`` on all three
    streams without them."""
    hd = cfg.resolved_head_dim
    if cfg.mrope and cfg.mrope_sections:
        p3 = text_positions3(pos) if positions3 is None else \
            torch.as_tensor(positions3, device=pos.device)
        return mrope_cos_sin(p3, hd, cfg.rope_theta, cfg.mrope_sections)
    return rope_cos_sin(pos, hd, cfg.rope_theta)


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


def _fuse(cfg: ModelConfig, layer: Params, out: torch.Tensor,
          xn: torch.Tensor, ssm_state: Optional[dict] = None,
          valid_len: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, Optional[dict]]:
    """A hybrid layer's output: the attention's ``out`` and the mamba2
    mixer's on the same normed input ``xn`` (from ``ssm_state``, with
    ``valid_len`` as the mixer takes them), mean-fused; any other layer's
    ``out`` as it is.  Returns (output, the mixer's new state or None)."""
    if not cfg.hybrid_parallel:
        return out, None
    ssm_out, st = S.ssm_mixer(layer["ssm"], xn, cfg, state=ssm_state,
                              valid_len=valid_len)
    return (out + ssm_out) * 0.5, st


def _attn_layer_fwd(layer: Params, x: torch.Tensor, pos: torch.Tensor,
                    window: int, cfg: ModelConfig, cos: torch.Tensor,
                    sin: torch.Tensor, moe: bool = False,
                    ssm_state: Optional[dict] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               Optional[torch.Tensor]]:
    """Full-sequence attention layer: causal self-attention (K2) with the
    layer's window (a hybrid: beside its mamba2 mixer, from
    ``ssm_state``, which then takes the mixer's new state IN PLACE), then
    the FFN (``moe``: the MoE FFN).  pos (B, L) token positions.  Returns
    (x, the layer's RoPE'd K (B, L, KV, hd), its V, the MoE aux loss or
    None)."""
    eps = cfg.norm_eps
    xn = rmsnorm(layer["ln1"], x, eps)
    dtype = xn.dtype
    q, k, v = A.qkv_proj(layer["attn"], xn, xn, dtype)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = ops.flash_attention(q, k, v, pos, pos, causal=True, window=window,
                            softcap=cfg.logit_softcap)
    out, st = _fuse(cfg, layer, A.out_proj(layer["attn"], o, dtype), xn,
                    ssm_state)
    if st is not None:
        ssm_state.update(st)
    x = x + out
    f, aux = _ffn(layer, rmsnorm(layer["ln2"], x, eps), cfg, moe)
    return x + f, k, v, aux


def _positions(B: int, L: int, cfg: ModelConfig, device: torch.device,
               positions3: Optional[torch.Tensor] = None):
    """(B, L) int32 positions 0..L-1 and their RoPE tables (L, hd/2); (B,
    L, hd/2) from ``positions3`` (3, B, L) under M-RoPE."""
    pos = torch.arange(L, dtype=torch.int32, device=device)
    cos, sin = _rope(pos, cfg, positions3)
    return pos[None].expand(B, L), cos, sin


def _on(t: Any, device: torch.device) -> Optional[torch.Tensor]:
    return None if t is None else torch.as_tensor(t, device=device)


def embed_inputs(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                 vision_embeds: Optional[torch.Tensor] = None,
                 vision_mask: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Token embeddings (B, L, d) in the activation dtype; with
    ``vision_embeds`` (B, Tv, frontend_dim), the projected patches replace
    the positions ``vision_mask`` (B, L) bool marks, the i-th marked
    position taking patch i (past Tv: the last patch)."""
    dtype = getattr(torch, cfg.dtype)
    x = E.embed_tokens(params["embed"], tokens, dtype)
    if vision_embeds is None:
        return x
    pv = E.project_frontend(params["embed"],
                            _on(vision_embeds, x.device).to(dtype))
    mask = _on(vision_mask, x.device).bool()
    idx = (mask.long().cumsum(dim=1) - 1).clamp(0, pv.shape[1] - 1)
    gathered = torch.gather(pv, 1, idx[..., None].expand(
        -1, -1, pv.shape[-1]))
    return torch.where(mask[..., None], gathered, x)


def lm_forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
               positions3: Optional[torch.Tensor] = None,
               vision_embeds: Optional[torch.Tensor] = None,
               vision_mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced forward.  tokens (B, L) -> (logits (B, L, V) f32,
    the MoE layers' summed aux loss, 0 without MoE layers); a VLM's
    inputs as :func:`embed_inputs` and :func:`_rope` take them.
    Differentiable for every family (JAX remats its layer scan; nothing
    is rematerialised here)."""
    check_family(cfg)
    x = embed_inputs(params, tokens, cfg, vision_embeds, vision_mask)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if _has_attention(cfg):
        pos, cos, sin = _positions(*tokens.shape, cfg, x.device, positions3)
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
    in the activation dtype -- constant in ``max_len``; the hybrid both."""
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
    if not _has_ssm(cfg):
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


def _write_state(cache: Dict[str, Any], i: int, new: Dict[str, torch.Tensor],
                 live: Optional[torch.Tensor]) -> None:
    """Layer ``i``'s new ``ssm`` / ``conv`` state into the cache IN PLACE,
    rows that are not ``live`` kept."""
    for k in ("ssm", "conv"):
        old = cache[k].layer(i).dense()
        val = new[k].to(old.dtype)
        if live is not None:
            val = torch.where(
                live.reshape((-1,) + (1,) * (val.ndim - 1)), val, old)
        old.copy_(val)


def _ssm_decode(params: Params, cache: Dict[str, Any], x: torch.Tensor,
                cfg: ModelConfig, live: Optional[torch.Tensor]
                ) -> torch.Tensor:
    for i, layer in enumerate(params["layers"]):
        slc = {k: cache[k].layer(i) for k in ("ssm", "conv")}
        x, new = _ssm_layer_decode(layer, x, slc, cfg)
        _write_state(cache, i, new, live)
    return x


def _attn_decode(params: Params, cache: Dict[str, Any], x: torch.Tensor,
                 cfg: ModelConfig, live: Optional[torch.Tensor],
                 positions3: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The attention layers of one decode step: each writes the token's
    K/V at slot ``len`` through the views (masked by ``live``; a row whose
    buffer is full is not written) and attends slots ``[max(0, len + 1 -
    window), len + 1)``; a hybrid layer's mixer takes its recurrent step
    beside it (its state written as :func:`_write_state` writes it)."""
    eps = cfg.norm_eps
    length = cache["len"]
    max_len = LT.field_length(cache["k"])
    write = length < max_len
    if live is not None:
        write = write & live
    slot = length.clamp(max=max_len - 1)
    hi = length + 1
    cos, sin = _rope(length[:, None], cfg, positions3)
    for layer, window, moe, prefix, i in _attn_layers(params, cfg):
        xn = rmsnorm(layer["ln1"], x, eps)
        out, _ = A.decode_attend_view(
            layer["attn"], xn, cache[prefix + "k"].layer(i),
            cache[prefix + "v"].layer(i), slot, write, None, hi, cos, sin,
            cfg.logit_softcap, window)
        if cfg.hybrid_parallel:
            out, new = _fuse(cfg, layer, out, xn, {
                k: cache[k].layer(i).dense() for k in ("ssm", "conv")})
            _write_state(cache, i, new, live)
        x = x + out
        f, _ = _ffn(layer, rmsnorm(layer["ln2"], x, eps), cfg, moe)
        x = x + f
    return x


@torch.no_grad()
def lm_decode_step_views(params: Params, cache: Dict[str, Any],
                         token: torch.Tensor, cfg: ModelConfig,
                         positions3: Optional[torch.Tensor] = None,
                         live: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Layout-native one-token decode.  ``cache`` maps bookkeeping names
    to tensors and KV names to FieldViews.  token (B,) -> (logits (B, V),
    cache), the cache updated IN PLACE; rows where ``live`` (B,) bool is
    False keep their state and ``len`` bit-identical.  ``positions3`` (3,
    B, 1): an M-RoPE model's position streams of the token (default: its
    slot ``len`` on all three)."""
    check_family(cfg)
    x = E.embed_tokens(params["embed"], token[:, None],
                       getattr(torch, cfg.dtype))
    x = _attn_decode(params, cache, x, cfg, live, positions3) \
        if _has_attention(cfg) else _ssm_decode(params, cache, x, cfg, live)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = E.lm_head(params["embed"], x, cfg.logit_softcap)[:, 0]
    cache["len"] += 1 if live is None else live.to(cache["len"].dtype)
    return logits, cache


@torch.no_grad()
def lm_decode_step(params: Params, cache: Dict[str, torch.Tensor],
                   token: torch.Tensor, cfg: ModelConfig,
                   positions3: Optional[torch.Tensor] = None,
                   live: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Dense-dict one-token decode: :func:`lm_decode_step_views` over
    DenseViews of ``cache`` (updated IN PLACE) -- the oracle of the
    layout-native step.  Returns (logits (B, V), cache)."""
    views = {k: LT.DenseView(v, CACHE_BATCH_AXES[k]) if k in KV_KEYS else v
             for k, v in cache.items()}
    logits, _ = lm_decode_step_views(params, views, token, cfg,
                                     positions3, live)
    return logits, cache


def _zero_state(cache: Dict[str, torch.Tensor], i: int
                ) -> Optional[Dict[str, torch.Tensor]]:
    """A zero ``ssm`` / ``conv`` state of layer ``i`` (None without)."""
    if "ssm" not in cache:
        return None
    return {k: torch.zeros_like(cache[k][i]) for k in ("ssm", "conv")}


def _row_state(row: Dict[str, torch.Tensor], i: int
               ) -> Optional[Dict[str, torch.Tensor]]:
    """Layer ``i``'s carried ``ssm`` / ``conv`` state of a row cache (None
    without)."""
    if "ssm" not in row:
        return None
    return {k: row[k][i] for k in ("ssm", "conv")}


def _put_state(cache: Dict[str, torch.Tensor], i: int,
               st: Optional[Dict[str, torch.Tensor]]) -> None:
    if st is not None:
        cache["ssm"][i] = st["ssm"]
        cache["conv"][i] = st["conv"].to(cache["conv"].dtype)


@torch.no_grad()
def lm_prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
               max_len: int, positions3: Optional[torch.Tensor] = None,
               vision_embeds: Optional[torch.Tensor] = None,
               vision_mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Process a prompt, filling the cache: an attention layer writes its
    RoPE'd K/V into the first L slots of its fields (the forward's own K2
    pass; DeepSeek's dense layers into ``dense_k`` / ``dense_v``); an SSM
    (or hybrid) layer's mixer runs in streaming mode from a zero state.
    tokens (B, L); a VLM's inputs as :func:`lm_forward`'s.  Returns
    (last-position logits (B, V), cache)."""
    check_family(cfg)
    B, L = tokens.shape
    x = embed_inputs(params, tokens, cfg, vision_embeds, vision_mask)
    cache = init_kv_cache(cfg, B, max_len, device=tokens.device)
    if _has_attention(cfg):
        pos, cos, sin = _positions(B, L, cfg, x.device, positions3)
        for layer, window, moe, prefix, i in _attn_layers(params, cfg):
            st = _zero_state(cache, i)
            x, k, v, _ = _attn_layer_fwd(layer, x, pos, window, cfg, cos,
                                         sin, moe, st)
            cache[prefix + "k"][i, :, :L] = k
            cache[prefix + "v"][i, :, :L] = v
            _put_state(cache, i, st)
    else:
        for i, layer in enumerate(params["layers"]):
            xn = rmsnorm(layer["ln1"], x, cfg.norm_eps)
            out, st = S.ssm_mixer(layer["ssm"], xn, cfg,
                                  state=_zero_state(cache, i))
            _put_state(cache, i, st)
            x = x + out
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = E.lm_head(params["embed"], x[:, -1:], cfg.logit_softcap)[:, 0]
    cache["len"].fill_(L)
    return logits, cache


@torch.no_grad()
def lm_prefill_chunk(params: Params, row: Dict[str, torch.Tensor],
                     tokens: torch.Tensor, start: int, n_valid: int,
                     cfg: ModelConfig,
                     logits_at: Union[int, slice, None] = slice(None)
                     ) -> Tuple[Optional[torch.Tensor],
                                Dict[str, torch.Tensor],
                                Dict[str, torch.Tensor]]:
    """One fixed-shape chunk of the chunked (KV-conditioned) prefill.

    ``row`` is the dense batch-1 row cache (:func:`init_kv_cache`):
    ``k`` / ``v`` (and DeepSeek's ``dense_k`` / ``dense_v``) with
    positions ``[0, start)`` written -- the resident prefix copied from
    adopted pages and every earlier chunk -- and / or the ``ssm`` /
    ``conv`` state advanced to ``start``.  The chunk's C queries, at their true
    positions ``[start, start + C)``, attend those positions and the
    chunk itself (K2, causal, the layer's window), so the result is the
    one-shot :func:`lm_prefill`'s up to float association.  The chunk's
    K/V is written into the row IN PLACE and also returned per
    length-axis field for the slot's ``write_span``; an SSM or hybrid
    layer's new mixer state replaces the row's.  An M-RoPE model rotates
    by text positions (JAX's chunk takes no ``positions3``).

    tokens (B, C) int, zero-padded after the prompt: padded positions lie
    after every real query, past ``len`` afterwards, and ``n_valid`` (the
    whole prompt's length) keeps them out of the ssm / conv state.  The
    MoE FFN routes the whole padded chunk, as JAX's does.  ``logits_at``
    picks the LM head's positions: a slice (default: all, JAX's return,
    (B, C, V)), one index i ((B, V): the admission reads one position) or
    None (no head).  Returns (logits, row, chunk_kv {field: (layers, B,
    C, KV, hd)}, empty for the SSM family)."""
    check_family(cfg)
    B, C = tokens.shape
    dev = tokens.device
    eps = cfg.norm_eps
    x = embed_inputs(params, tokens, cfg)
    chunk_kv: Dict[str, torch.Tensor] = {}
    # real tokens in this chunk (the last one is zero-padded)
    vl = torch.full((B,), min(max(n_valid - start, 0), C),
                    dtype=torch.int32, device=dev)
    if _has_attention(cfg):
        pos = (start + torch.arange(C, dtype=torch.int32, device=dev)
               )[None].expand(B, C)
        cos, sin = _rope(pos, cfg)
        live = start + C
        kpos = torch.arange(live, dtype=torch.int32, device=dev)[None].expand(
            B, live)
        for layer, window, moe, prefix, i in _attn_layers(params, cfg):
            xn = rmsnorm(layer["ln1"], x, eps)
            q, k, v = A.qkv_proj(layer["attn"], xn, xn, xn.dtype)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
            k_row, v_row = row[prefix + "k"][i], row[prefix + "v"][i]
            k_row[:, start:live] = k
            v_row[:, start:live] = v
            # keys [0, start + C): the later ones are causally dead
            o = ops.prefill_chunk_attention(q, k_row[:, :live],
                                            v_row[:, :live], pos, kpos,
                                            window, cfg.logit_softcap)
            out, st = _fuse(cfg, layer, A.out_proj(layer["attn"], o,
                                                   xn.dtype), xn,
                            _row_state(row, i), vl)
            _put_state(row, i, st)
            x = x + out
            f, _ = _ffn(layer, rmsnorm(layer["ln2"], x, eps), cfg, moe)
            x = x + f
        for f in LENGTH_AXES:
            if f in row:
                chunk_kv[f] = row[f][:, :, start:live]
    else:
        for i, layer in enumerate(params["layers"]):
            out, st = S.ssm_mixer(layer["ssm"], rmsnorm(layer["ln1"], x, eps),
                                  cfg, state=_row_state(row, i),
                                  valid_len=vl)
            _put_state(row, i, st)
            x = x + out
    if logits_at is None:
        return None, row, chunk_kv
    x = rmsnorm(params["final_norm"], x, eps)
    one = isinstance(logits_at, int)
    sel = x[:, logits_at:logits_at + 1] if one else x[:, logits_at]
    logits = E.lm_head(params["embed"], sel, cfg.logit_softcap)
    return (logits[:, 0] if one else logits), row, chunk_kv
