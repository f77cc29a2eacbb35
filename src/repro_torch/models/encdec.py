"""Whisper-style encoder-decoder [arXiv:2212.04356] (``arch_type ==
"audio"``, ``cfg.is_encdec``).

Port of ``src/repro/models/encdec.py`` but ``encdec_verify_chunk_views``
(speculative decoding, ROADMAP Queue 1 item 8).  The mel-spectrogram and
conv frontend are a stub in the JAX package too: the model takes
post-conv frame embeddings ``audio_feats`` (B, encoder_seq,
frontend_dim), and the learned ``frontend_proj`` maps them to d_model.
As in the JAX package the decoder self-attention uses RoPE (not learned
positions); the encoder adds a learned ``enc_pos``; norms are LayerNorm
and FFNs the GELU MLP (tanh approximation).  Layers are kept unstacked,
one dict per layer in the lists ``enc_layers`` and ``dec_layers``
(:func:`repro_torch.bridge.encdec_params_from_jax` unstacks JAX's).

Attention runs on the port's kernels: the encoder's bidirectional
self-attention is K2 with ``causal=False`` over ``encoder_seq`` frames;
the decoder's teacher-forced self-attention is K2, causal (with the
window in ``sliding`` mode in :func:`decode_train` only, as in JAX: the
prefills are plainly causal); its cross-attention to the encoder memory
is K2 with ``causal=False``; a chunk of the chunked admission is K2 at
the chunk's shape.  The one-token decode step attends its growing
self-attention K/V through the layout's view (K1 / K1-int8 / K3 /
K3-int8) and the fixed cross K/V, which has no length axis and stays
dense under the paged layouts, through K1 (K1-int8 on the int8 layouts)
over slots ``[0, encoder_seq)``.  The JAX package picks ``sdpa`` or its
blocked flash by sequence length (``FLASH_THRESHOLD``) and reads an int8
cross K/V by dequantising it into ``sdpa``; all compute the functions
the port's kernels compute.

The cross-attention query is projected with the ``cross`` block's own
``wq`` and has no RoPE.  The serving entry points run under
``torch.no_grad``; the decode step updates the cache IN PLACE, and rows
that are not ``live`` keep every entry bit-identical.

Training: :func:`encdec_forward` (:func:`encode`, then
:func:`decode_train`) is differentiable and writes nothing in place.
Its every attention goes through ``ops.flash_attention``, which under
autograd is K2 with its backward kernel: the encoder's non-causal
``encoder_seq`` square, the decoder's causal self-attention and its
cross-attention of L queries over ``encoder_seq`` keys.  LayerNorm runs
in f32 (``F.layer_norm``), the GELU MLP, the frontend projection and
the tied head are einsums, so ``ModelAPI.loss`` differentiates every
leaf: ``frontend_proj`` and ``enc_pos`` through the encoder, each
decoder layer's ``cross`` ``wk`` / ``wv`` through the memory.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.layers import attention as A
from repro_torch.layers import embed as E
from repro_torch.layers.common import (Params, init_layernorm, layernorm,
                                       to_device)
from repro_torch.layers.mlp import gelu_mlp, init_gelu_mlp
from repro_torch.layers.rope import apply_rope, rope_cos_sin
from repro_torch.models import layouts as LT

# the float32 leaves prepare_params keeps: LayerNorm's scale and bias
F32_PARAMS = ("scale", "bias")


def _act_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _init_enc_layer(cfg: ModelConfig, gen: torch.Generator) -> Params:
    d = cfg.d_model
    return {"ln1": init_layernorm(d), "attn": A.init_attention(cfg, gen),
            "ln2": init_layernorm(d),
            "ffn": init_gelu_mlp(d, cfg.d_ff, gen)}


def _init_dec_layer(cfg: ModelConfig, gen: torch.Generator) -> Params:
    d = cfg.d_model
    return {"ln1": init_layernorm(d), "attn": A.init_attention(cfg, gen),
            "lnc": init_layernorm(d), "cross": A.init_attention(cfg, gen),
            "ln2": init_layernorm(d),
            "ffn": init_gelu_mlp(d, cfg.d_ff, gen)}


def init_encdec(cfg: ModelConfig, seed: int = 0,
                device: Optional[torch.device] = None) -> Params:
    """The port's own seeded init, float32 drawn on the CPU from one
    ``torch.Generator``: the embedding (with ``frontend_proj``), ``enc_pos``
    ~ N(0, 0.02^2) (encoder_seq, d), the encoder layers, the decoder layers
    in order; LayerNorms are ones / zeros.  It does not reproduce
    ``jax.random``: parity tests bridge the JAX weights."""
    check_family(cfg)
    gen = torch.Generator().manual_seed(seed)
    params: Params = {"embed": E.init_embed(cfg, gen)}
    params["enc_pos"] = torch.randn((cfg.encoder_seq, cfg.d_model),
                                    generator=gen) * 0.02
    params["enc_layers"] = [_init_enc_layer(cfg, gen)
                            for _ in range(cfg.encoder_layers)]
    params["enc_norm"] = init_layernorm(cfg.d_model)
    params["dec_layers"] = [_init_dec_layer(cfg, gen)
                            for _ in range(cfg.n_layers)]
    params["dec_norm"] = init_layernorm(cfg.d_model)
    return to_device(params, device)


def prepare_params(params: Params, device: torch.device,
                   dtype: torch.dtype) -> Params:
    """Weights on ``device``, matrices and the GELU MLP's biases cast once
    to the activation dtype (JAX casts them per call); the LayerNorms
    stay float32, as JAX's ``layernorm`` reads them."""
    return to_device(params, device, dtype, keep=F32_PARAMS)


def check_family(cfg: ModelConfig) -> None:
    if not cfg.is_encdec:
        raise ValueError(f"{cfg.name} is not an encoder-decoder")


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _arange(n: int, B: int, device: torch.device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)[None].expand(
        B, n)


def encode(params: Params, audio_feats: torch.Tensor, cfg: ModelConfig
           ) -> torch.Tensor:
    """audio_feats (B, T_enc, frontend_dim), the stub conv frontend's
    output -> the encoder memory (B, T_enc, d) in the activation dtype.
    Bidirectional self-attention (K2, not causal), no RoPE."""
    dtype = _act_dtype(cfg)
    eps = cfg.norm_eps
    x = E.project_frontend(params["embed"], audio_feats.to(dtype))
    B, T = x.shape[:2]
    x = x + params["enc_pos"].to(dtype)[None, :T]
    pos = _arange(T, B, x.device)
    for layer in params["enc_layers"]:
        xn = layernorm(layer["ln1"], x, eps)
        x = x + A.attention_block(layer["attn"], xn, xn, pos, pos,
                                  causal=False)
        x = x + gelu_mlp(layer["ffn"], layernorm(layer["ln2"], x, eps))
    return layernorm(params["enc_norm"], x, eps)


# ---------------------------------------------------------------------------
# Decoder (teacher-forced)
# ---------------------------------------------------------------------------


def _positions(B: int, L: int, cfg: ModelConfig, device: torch.device,
               start: int = 0):
    """(B, L) int32 positions start..start+L-1 and their RoPE tables."""
    pos = start + torch.arange(L, dtype=torch.int32, device=device)
    cos, sin = rope_cos_sin(pos, cfg.resolved_head_dim, cfg.rope_theta)
    return pos[None].expand(B, L), cos, sin


def _self_qkv(layer: Params, xn: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor):
    q, k, v = A.qkv_proj(layer["attn"], xn, xn, xn.dtype)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _cross_ffn(layer: Params, x: torch.Tensor, ck: torch.Tensor,
               cv: torch.Tensor, eps: float) -> torch.Tensor:
    """The decoder layer after its self-attention: cross-attention to the
    pre-projected memory K/V (K2, not causal), then the GELU MLP."""
    xc = layernorm(layer["lnc"], x, eps)
    x = x + A.cross_attend_cached(layer["cross"], xc, ck, cv)
    return x + gelu_mlp(layer["ffn"], layernorm(layer["ln2"], x, eps))


def decode_train(params: Params, tokens: torch.Tensor, memory: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Teacher-forced decoder.  tokens (B, L), memory (B, T_enc, d) ->
    logits (B, L, V) f32.  Causal self-attention with the window in
    ``sliding`` mode."""
    eps = cfg.norm_eps
    B, L = tokens.shape
    x = E.embed_tokens(params["embed"], tokens, _act_dtype(cfg))
    pos, cos, sin = _positions(B, L, cfg, x.device)
    window = cfg.sliding_window if cfg.attention_mode == "sliding" else 0
    for layer in params["dec_layers"]:
        xn = layernorm(layer["ln1"], x, eps)
        q, k, v = _self_qkv(layer, xn, cos, sin)
        o = ops.flash_attention(q, k, v, pos, pos, causal=True,
                                window=window)
        x = x + A.out_proj(layer["attn"], o, xn.dtype)
        ck, cv = A.project_kv(layer["cross"], memory)
        x = _cross_ffn(layer, x, ck, cv, eps)
    x = layernorm(params["dec_norm"], x, eps)
    return E.lm_head(params["embed"], x)


def encdec_forward(params: Params, tokens: torch.Tensor,
                   audio_feats: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits (B, L, V) f32, a zero aux loss)."""
    memory = encode(params, audio_feats, cfg)
    logits = decode_train(params, tokens, memory, cfg)
    return logits, torch.zeros((), dtype=torch.float32,
                               device=logits.device)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

# Cache partition for the serving layer (repro_torch.models.api.
# DecodeState): true KV vs bookkeeping, and the batch ("slot") axis of
# each entry.
KV_KEYS = ("k", "v", "cross_k", "cross_v")
CACHE_BATCH_AXES = {"len": 0, "done": 0, "k": 1, "v": 1,
                    "cross_k": 1, "cross_v": 1}

# Cache-layout metadata (repro_torch.models.layouts): the decoder
# self-attention KV grows with max_len (paged); the cross K/V is fixed
# encoder_seq and stays dense.  All four are quantizable.
LENGTH_AXES = {"k": 2, "v": 2}
QUANT_FIELDS = KV_KEYS


def init_encdec_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device: Optional[torch.device] = None
                      ) -> Dict[str, torch.Tensor]:
    """``len`` / ``done`` and, in the activation dtype, the decoder's
    ``k`` / ``v`` (n_layers, B, max_len, KV, hd) and the cross
    ``cross_k`` / ``cross_v`` (n_layers, B, encoder_seq, KV, hd)."""
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    dt = _act_dtype(cfg)
    n = cfg.n_layers
    cache = {"len": torch.zeros((batch,), dtype=torch.int32, device=device),
             "done": torch.zeros((batch,), dtype=torch.bool, device=device)}
    for f, S in (("k", max_len), ("v", max_len),
                 ("cross_k", cfg.encoder_seq), ("cross_v", cfg.encoder_seq)):
        cache[f] = torch.zeros((n, batch, S, kv, hd), dtype=dt,
                               device=device)
    return cache


@torch.no_grad()
def encdec_prefill(params: Params, tokens: torch.Tensor,
                   audio_feats: torch.Tensor, cfg: ModelConfig, max_len: int
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Encode the audio, pre-project each layer's cross K/V into the
    cache, teacher-force the prompt through the decoder (plainly causal)
    and fill the self-attention cache's first L slots.  tokens (B, L).
    Returns (last-position logits (B, V), cache)."""
    eps = cfg.norm_eps
    B, L = tokens.shape
    memory = encode(params, audio_feats, cfg)
    cache = init_encdec_cache(cfg, B, max_len, device=tokens.device)
    x = E.embed_tokens(params["embed"], tokens, _act_dtype(cfg))
    pos, cos, sin = _positions(B, L, cfg, x.device)
    for i, layer in enumerate(params["dec_layers"]):
        xn = layernorm(layer["ln1"], x, eps)
        q, k, v = _self_qkv(layer, xn, cos, sin)
        o = ops.flash_attention(q, k, v, pos, pos, causal=True)
        x = x + A.out_proj(layer["attn"], o, xn.dtype)
        cache["k"][i, :, :L] = k
        cache["v"][i, :, :L] = v
        ck, cv = A.project_kv(layer["cross"], memory)
        cache["cross_k"][i] = ck
        cache["cross_v"][i] = cv
        x = _cross_ffn(layer, x, ck, cv, eps)
    x = layernorm(params["dec_norm"], x, eps)
    logits = E.lm_head(params["embed"], x[:, -1:])[:, 0]
    cache["len"].fill_(L)
    return logits, cache


@torch.no_grad()
def encdec_seed_cache(params: Params, audio_feats: torch.Tensor,
                      cfg: ModelConfig, max_len: int
                      ) -> Dict[str, torch.Tensor]:
    """Seed of the chunked admission: run the encoder once and
    pre-project each layer's cross K/V, which the decoder chunks then
    attend.  The self-attention K/V starts empty and is filled chunk by
    chunk."""
    memory = encode(params, audio_feats, cfg)
    cache = init_encdec_cache(cfg, audio_feats.shape[0], max_len,
                              device=memory.device)
    for i, layer in enumerate(params["dec_layers"]):
        ck, cv = A.project_kv(layer["cross"], memory)
        cache["cross_k"][i] = ck
        cache["cross_v"][i] = cv
    return cache


@torch.no_grad()
def encdec_prefill_chunk(params: Params, row: Dict[str, torch.Tensor],
                         tokens: torch.Tensor, start: int, n_valid: int,
                         cfg: ModelConfig,
                         logits_at: Union[int, slice, None] = slice(None)
                         ) -> Tuple[Optional[torch.Tensor],
                                    Dict[str, torch.Tensor],
                                    Dict[str, torch.Tensor]]:
    """One fixed-shape chunk of the chunked decoder prefill: the chunk's C
    queries, at their true positions ``[start, start + C)``, self-attend
    the row cache's resident positions ``[0, start)`` and the chunk (K2,
    plainly causal, as the one-shot prefill) and cross-attend the
    pre-projected memory of :func:`encdec_seed_cache`.  The chunk's K/V
    is written into the row IN PLACE and also returned for the slot's
    ``write_span``.  ``n_valid`` is not needed (no recurrent state; the
    padding after the prompt is causally dead).  ``logits_at`` as in
    :func:`repro_torch.models.lm.lm_prefill_chunk`.  Returns (logits,
    row, chunk_kv {"k", "v": (n_layers, B, C, KV, hd)})."""
    del n_valid
    eps = cfg.norm_eps
    B, C = tokens.shape
    x = E.embed_tokens(params["embed"], tokens, _act_dtype(cfg))
    pos, cos, sin = _positions(B, C, cfg, x.device, start)
    live = start + C
    kpos = _arange(live, B, x.device)
    for i, layer in enumerate(params["dec_layers"]):
        xn = layernorm(layer["ln1"], x, eps)
        q, k, v = _self_qkv(layer, xn, cos, sin)
        k_row, v_row = row["k"][i], row["v"][i]
        k_row[:, start:live] = k
        v_row[:, start:live] = v
        # keys [0, start + C): the later ones are causally dead
        o = ops.prefill_chunk_attention(q, k_row[:, :live], v_row[:, :live],
                                        pos, kpos)
        x = x + A.out_proj(layer["attn"], o, xn.dtype)
        x = _cross_ffn(layer, x, row["cross_k"][i], row["cross_v"][i], eps)
    chunk_kv = {f: row[f][:, :, start:live] for f in LENGTH_AXES}
    if logits_at is None:
        return None, row, chunk_kv
    x = layernorm(params["dec_norm"], x, eps)
    one = isinstance(logits_at, int)
    sel = x[:, logits_at:logits_at + 1] if one else x[:, logits_at]
    logits = E.lm_head(params["embed"], sel)
    return (logits[:, 0] if one else logits), row, chunk_kv


@torch.no_grad()
def encdec_decode_step_views(params: Params, cache: Dict[str, Any],
                             token: torch.Tensor, cfg: ModelConfig,
                             live: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Layout-native one-token decode: ``cache`` maps bookkeeping names to
    tensors and KV names to FieldViews.  Each layer writes the token's K/V
    at slot ``len`` through the views (masked by ``live``; a row whose
    buffer is full is not written), attends slots ``[max(0, len + 1 -
    window), len + 1)`` (a window in ``sliding`` mode), then reads the
    fixed cross K/V over ``[0, encoder_seq)``.  token (B,) -> (logits
    (B, V), cache), the cache updated IN PLACE; rows where ``live`` (B,)
    bool is False keep their state and ``len`` bit-identical."""
    eps = cfg.norm_eps
    dtype = _act_dtype(cfg)
    x = E.embed_tokens(params["embed"], token[:, None], dtype)
    length = cache["len"]
    max_len = LT.field_length(cache["k"])
    write = length < max_len
    if live is not None:
        write = write & live
    slot = length.clamp(max=max_len - 1)
    hi = length + 1
    cos, sin = rope_cos_sin(length[:, None], cfg.resolved_head_dim,
                            cfg.rope_theta)
    window = cfg.sliding_window if cfg.attention_mode == "sliding" else 0
    cross_hi = torch.full_like(length, LT.field_length(cache["cross_k"]))
    for i, layer in enumerate(params["dec_layers"]):
        out, _ = A.decode_attend_view(
            layer["attn"], layernorm(layer["ln1"], x, eps),
            cache["k"].layer(i), cache["v"].layer(i), slot, write, None, hi,
            cos, sin, 0.0, window)
        x = x + out
        q = A.q_proj(layer["cross"], layernorm(layer["lnc"], x, eps), dtype)
        x = x + A.cross_attend_view(layer["cross"], q,
                                    cache["cross_k"].layer(i),
                                    cache["cross_v"].layer(i), None,
                                    cross_hi)
        x = x + gelu_mlp(layer["ffn"], layernorm(layer["ln2"], x, eps))
    x = layernorm(params["dec_norm"], x, eps)
    logits = E.lm_head(params["embed"], x)[:, 0]
    cache["len"] += 1 if live is None else live.to(cache["len"].dtype)
    return logits, cache


@torch.no_grad()
def encdec_decode_step(params: Params, cache: Dict[str, torch.Tensor],
                       token: torch.Tensor, cfg: ModelConfig,
                       live: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Dense-dict one-token decode: :func:`encdec_decode_step_views` over
    DenseViews of ``cache`` (updated IN PLACE) -- the oracle of the
    layout-native step.  Returns (logits (B, V), cache)."""
    views = {k: LT.DenseView(v, CACHE_BATCH_AXES[k]) if k in KV_KEYS else v
             for k, v in cache.items()}
    logits, _ = encdec_decode_step_views(params, views, token, cfg, live)
    return logits, cache
