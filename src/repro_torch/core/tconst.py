"""TConstFormer core in PyTorch (``mode="tconst"`` and ``mode="tlin"``).

Port of ``src/repro/core/tconst.py``: the same topology (one TConst block
of depth h + 2: context COMPRESS, h context self-attention layers,
context RESTORE, and the generation window's causal self-attention plus
cross-attention to the compressed states), the same Eq. (7) O(1) cache,
the O(1) cache-hit decode step (paper Eq. 5) and the O(N) resync (Eq. 4).
``mode="tlin"`` is the paper's TLinFormer baseline (Fig 1a): layer 0 of
each block's generation path also cross-attends the raw history, so the
cache keeps an O(N) per-block history KV (``hist_k`` / ``hist_v``) and the
hit step reads it -- the one field the paged layouts page.  The
teacher-forced :func:`tconst_forward` is differentiable (training: its
attentions run K2 with its backward); the serving entry points
(``resync``, ``decode_step*``, ``prefill``) run under ``torch.no_grad``.
For a dense FFN the forward skips the last block's RESTORE, whose output
nothing reads, so those parameters get no gradient where JAX's gives
zeros; the training step treats a missing gradient as zeros.

MoE configs (deepseek, mixtral) put the MoE FFN of
:mod:`repro_torch.layers.moe` in every layer, as JAX's TConst init does
(no dense first layer).  The forward then returns JAX's aux loss, the sum
over chunks, blocks and layers, which counts the last block's RESTORE:
for MoE configs that restore runs.  Every FFN routes the token set JAX's
routes, since GShard's capacity drops depend on which tokens share a
group: the compress FFN all W_oh tail slots (negative positions too), the
restore FFN the whole (B, max_len) history buffer (past ``hist_len``
too), the decode step all B rows (live or not), the prefill pass its
whole window.  Nothing on this path drops or compacts rows or positions.

Attention routing: every multi-query attention (compress, context self,
restore, the teacher-forced generation window and its history
cross-attention) is "causal by position AND key valid" and runs as K2
with ``INVALID_POS`` for dead keys.  The decode step reads the cache
through KVViews (:mod:`repro_torch.models.layouts`): dense views run K1
over ``[lo, hi)`` slot ranges, int8 views K1's int8 variant, the paged
history K3.

In-place updates: :func:`decode_step_views` writes the new token's K/V,
its id and the counters into the cache tensors IN PLACE.  Rows that are
not ``live`` (inactive or EOS-finished slots) have their writes masked,
so they come through bit-identical.

Not ported yet: ``prefill_bucketed`` (chunked admission, ROADMAP Queue 1
item 8) and ``verify_chunk_views`` (ROADMAP Queue 1 item 8, speculative
decoding).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import INVALID_POS
from repro_torch.layers import attention as A
from repro_torch.layers import embed as E
from repro_torch.layers import rope as R
from repro_torch.layers.common import Params, rmsnorm, to_device
from repro_torch.layers.mlp import init_swiglu, swiglu
from repro_torch.layers.moe import init_moe, moe_ffn
from repro_torch.models import layouts as LT

MODES = ("tconst", "tlin")

# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode={mode!r}: the TConst core has modes {MODES}")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _init_layer(cfg: ModelConfig, gen: torch.Generator,
                dtype: Optional[torch.dtype] = None) -> Params:
    """One layer: attention, then the FFN (SwiGLU, or the MoE FFN of an
    MoE config), drawn from ``gen`` in that order (the dense LM's
    attention layers draw the same way) and cast to ``dtype`` as drawn."""
    d = cfg.d_model
    attn = A.init_attention(cfg, gen, dtype)
    ffn = init_moe(cfg, gen, dtype) if cfg.is_moe else \
        init_swiglu(d, cfg.d_ff, gen, dtype)
    return {"attn": attn, "ffn": ffn,
            "ln1": {"scale": torch.ones(d, device=gen.device)},
            "ln2": {"scale": torch.ones(d, device=gen.device)}}


def init_tconst_lm(cfg: ModelConfig, seed: int = 0,
                   device: Optional[torch.device] = None) -> Params:
    """The port's own seeded init from one ``torch.Generator``.  It does
    not reproduce ``jax.random``: parity tests load the JAX weights
    through :func:`repro_torch.bridge.params_from_jax` instead.

    Dense configs draw float32 on the CPU, so every device gets the same
    weights.  MoE configs draw on ``device`` with a generator of that
    device and cast each tensor to the activation dtype as it is drawn
    (norm scales stay float32), as ``models/lm.py:init_lm`` does:
    deepseek-moe-16b in tconst mode is 16.9 B parameters, which drawn in
    float32 on the host would take ~68 GB and minutes.  Their weights
    then depend on the device's generator."""
    moe = cfg.is_moe
    dev = torch.device("cpu") if device is None or not moe \
        else torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = _dtype(cfg.dtype) if moe else None
    embed = E.init_embed(cfg, gen, dtype)
    blocks = [{"layers": [_init_layer(cfg, gen, dtype)
                          for _ in range(cfg.tconst.block_depth)]}
              for _ in range(cfg.tconst_blocks)]
    params = {"embed": embed, "blocks": blocks,
              "final_norm": {"scale": torch.ones(cfg.d_model, device=dev)}}
    return to_device(params, device)


def _ffn_apply(layer: Params, x: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's FFN: (output, the MoE aux loss, or None for a
    SwiGLU)."""
    if cfg.is_moe:
        return moe_ffn(layer["ffn"], x, cfg)
    return swiglu(layer["ffn"], x), None


def _add_aux(total: Optional[torch.Tensor], aux: Optional[torch.Tensor]
             ) -> Optional[torch.Tensor]:
    if aux is None:
        return total
    return aux if total is None else total + aux


# ---------------------------------------------------------------------------
# Context path (compress -> h self-attn -> restore)
# ---------------------------------------------------------------------------


def _rope(pos: torch.Tensor, cfg: ModelConfig):
    return R.rope_cos_sin(pos, cfg.resolved_head_dim, cfg.rope_theta)


def _key_pos(pos: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Positions with dead keys at ``INVALID_POS`` (the K2 key mask)."""
    return torch.where(valid, pos, torch.full_like(pos, INVALID_POS))


def context_path(block: Params, hist: torch.Tensor, hist_pos: torch.Tensor,
                 hist_valid: torch.Tensor, tail_pos: torch.Tensor,
                 tail_valid: torch.Tensor, cfg: ModelConfig,
                 restore: bool = True
                 ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor],
                            Optional[torch.Tensor]]:
    """Context path of one block.  hist (B, N, D); hist_pos/hist_valid
    (B, N); tail_pos/tail_valid (B, W_oh).  Returns (c_states [C_0..C_h]
    each (B, W_oh, D), restored history (B, N, D) -- None when
    ``restore`` is False, for a last block whose restore nothing reads --
    and the summed MoE aux loss of the layers run, None for SwiGLUs).

    Compress queries at negative tail positions are rotated at position 0
    but masked at their raw position: they have no valid key and give 0.
    """
    eps = cfg.norm_eps
    h = cfg.tconst.h
    cap = cfg.logit_softcap
    layers = block["layers"]
    B, N, D = hist.shape

    cos_h, sin_h = _rope(hist_pos, cfg)
    cos_t, sin_t = _rope(tail_pos.clamp(min=0), cfg)
    hist_kp = _key_pos(hist_pos, hist_valid)
    tail_kp = _key_pos(tail_pos, tail_valid)

    idx = tail_pos.clamp(0, N - 1)
    tail_x = torch.gather(hist, 1, idx[..., None].expand(B, -1, D))

    # layer 0: COMPRESS (Fig 2c) -- W_oh tail queries over the history
    l0 = layers[0]
    c = tail_x + A.attention_block(
        l0["attn"], rmsnorm(l0["ln1"], tail_x, eps),
        rmsnorm(l0["ln1"], hist, eps), tail_pos, hist_kp,
        cos_t, sin_t, cos_h, sin_h, cap)
    f, aux = _ffn_apply(l0, rmsnorm(l0["ln2"], c, eps), cfg)
    c = c + f
    c_states = [c]

    # layers 1..h: context self-attention over the W_oh slots
    for i in range(1, h + 1):
        li = layers[i]
        cn = rmsnorm(li["ln1"], c, eps)
        c = c + A.attention_block(li["attn"], cn, cn, tail_pos, tail_kp,
                                  cos_t, sin_t, cos_t, sin_t, cap)
        f, a = _ffn_apply(li, rmsnorm(li["ln2"], c, eps), cfg)
        c = c + f
        aux = _add_aux(aux, a)
        c_states.append(c)

    if not restore:
        return c_states, None, aux
    # layer h+1: RESTORE (Fig 2d) -- history queries over the W_oh slots
    lf = layers[h + 1]
    r = hist + A.attention_block(
        lf["attn"], rmsnorm(lf["ln1"], hist, eps),
        rmsnorm(lf["ln1"], c, eps), hist_pos, tail_kp,
        cos_h, sin_h, cos_t, sin_t, cap)
    f, a = _ffn_apply(lf, rmsnorm(lf["ln2"], r, eps), cfg)
    return c_states, r + f, _add_aux(aux, a)


# ---------------------------------------------------------------------------
# Generation path (teacher-forced window pass -- training forward)
# ---------------------------------------------------------------------------


def gen_path(block: Params, hg: torch.Tensor, gen_pos: torch.Tensor,
             c_states: List[torch.Tensor], tail_pos: torch.Tensor,
             tail_valid: torch.Tensor, cfg: ModelConfig,
             hist: Optional[torch.Tensor] = None,
             hist_kp: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Generation-window pass of one block: hg (B, G, D).  When ``hist``
    (B, N, D) is given (mode="tlin"), layer 0 also cross-attends the raw
    history -- the TLinFormer pathway the paper severs -- at key positions
    ``hist_kp`` (B, N) (``INVALID_POS`` for keys outside the history).
    Returns (hg, the summed MoE aux loss, None for SwiGLUs)."""
    eps = cfg.norm_eps
    h = cfg.tconst.h
    cap = cfg.logit_softcap
    layers = block["layers"]
    cos_g, sin_g = _rope(gen_pos, cfg)
    cos_t, sin_t = _rope(tail_pos.clamp(min=0), cfg)
    tail_kp = _key_pos(tail_pos, tail_valid)
    aux = None
    for i in range(h + 2):
        li = layers[i]
        xn = rmsnorm(li["ln1"], hg, eps)
        out = A.attention_block(li["attn"], xn, xn, gen_pos, gen_pos,
                                cos_g, sin_g, cos_g, sin_g, cap)
        if i >= 1:
            cn = rmsnorm(li["ln1"], c_states[i - 1], eps)
            out = out + A.attention_block(li["attn"], xn, cn, gen_pos,
                                          tail_kp, cos_g, sin_g, cos_t,
                                          sin_t, cap)
        elif hist is not None:
            hpos = torch.arange(hist.shape[1], device=hist.device).expand(
                hist.shape[0], -1)
            cos_h, sin_h = _rope(hpos, cfg)
            out = out + A.attention_block(
                li["attn"], xn, rmsnorm(li["ln1"], hist, eps), gen_pos,
                hist_kp, cos_g, sin_g, cos_h, sin_h, cap)
        hg = hg + out
        f, a = _ffn_apply(li, rmsnorm(li["ln2"], hg, eps), cfg)
        hg = hg + f
        aux = _add_aux(aux, a)
    return hg, aux


def tconst_forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                   mode: str = "tconst") -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced forward (differentiable).  tokens (B, N), N % W_og == 0;
    chunk j sees chunks 0..j-1 as compressed history (and, in tlin mode,
    its block's raw history at layer 0).  Returns (logits (B, N, V)
    float32, aux loss () float32: JAX's sum over chunks, blocks and
    layers of the MoE aux losses, the last block's RESTORE included; 0
    for SwiGLUs)."""
    _check_mode(mode)
    tc = cfg.tconst
    B, N = tokens.shape
    if N % tc.w_og:
        raise ValueError(f"sequence length {N} must be a multiple of W_og "
                         f"{tc.w_og}")
    dev = tokens.device
    X = E.embed_tokens(params["embed"], tokens, _dtype(cfg.dtype))
    pos = torch.arange(N, device=dev).expand(B, N)
    nb = len(params["blocks"])
    use_tlin = mode == "tlin"
    # an MoE config runs the last RESTORE for its aux loss, as JAX does
    last_restore = cfg.is_moe
    out, aux = [], torch.zeros((), device=dev)
    for j in range(N // tc.w_og):
        hist_valid = pos < j * tc.w_og
        hist_kp = _key_pos(pos, hist_valid) if use_tlin else None
        tail_pos = (j * tc.w_og - tc.w_oh +
                    torch.arange(tc.w_oh, device=dev)).expand(B, tc.w_oh)
        tail_valid = tail_pos >= 0
        gen_pos = (j * tc.w_og +
                   torch.arange(tc.w_og, device=dev)).expand(B, tc.w_og)
        hist = X
        hg = X[:, j * tc.w_og:(j + 1) * tc.w_og]
        for ib, block in enumerate(params["blocks"]):
            c_states, restored, a_ctx = context_path(
                block, hist, pos, hist_valid, tail_pos, tail_valid, cfg,
                restore=last_restore or ib + 1 < nb)
            hg, a_gen = gen_path(block, hg, gen_pos, c_states, tail_pos,
                                 tail_valid, cfg,
                                 hist=hist if use_tlin else None,
                                 hist_kp=hist_kp)
            aux = _add_aux(_add_aux(aux, a_ctx), a_gen)
            hist = restored
        hg = rmsnorm(params["final_norm"], hg, cfg.norm_eps)
        out.append(E.lm_head(params["embed"], hg, cfg.logit_softcap))
    return torch.cat(out, dim=1), aux


# ---------------------------------------------------------------------------
# Inference: O(1) cache, cache-hit decode step, periodic resync
# ---------------------------------------------------------------------------

# True KV-cache entries vs bookkeeping (token ids, lengths, phase flags).
KV_KEYS = ("ctx_k", "ctx_v", "gen_k", "gen_v", "hist_k", "hist_v")
# Batch ("slot") axis of every cache entry.
CACHE_BATCH_AXES = {
    "tokens": 0, "hist_len": 0, "gen_len": 0, "done": 0, "ctx_valid": 0,
    "ctx_k": 2, "ctx_v": 2, "gen_k": 2, "gen_v": 2,
    "hist_k": 1, "hist_v": 1,
}
# Cache-layout metadata (repro_torch.models.layouts): the fields with an
# O(N) length axis a paged layout splits into pages (only TLinFormer's
# history KV -- the tconst ctx/gen buffers are already O(1)), and the
# float KV fields an int8 layout quantizes.
LENGTH_AXES = {"hist_k": 2, "hist_v": 2}
QUANT_FIELDS = KV_KEYS
# resync rebuilds the ctx KV from these alone; a row-wise resync gathers
# only them -- never the KV cache.
RESYNC_INPUT_KEYS = ("tokens", "hist_len", "gen_len")


def init_tconst_cache(cfg: ModelConfig, batch: int, max_len: int,
                      mode: str = "tconst",
                      device: Optional[torch.device] = None
                      ) -> Dict[str, torch.Tensor]:
    """The paper's Eq. (7) constant-size cache (+ the raw token id buffer,
    int32, which is not KV cache and is the only O(N) residue of tconst).
    mode="tlin" adds the O(N) per-block history KV ``hist_k`` /
    ``hist_v`` (nb, B, max_len, KV, hd)."""
    _check_mode(mode)
    tc = cfg.tconst
    nb = cfg.tconst_blocks
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    dt = _dtype(cfg.dtype)

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    cache = {
        "tokens": z((batch, max_len), torch.int32),
        "hist_len": z((batch,), torch.int32),
        "gen_len": z((batch,), torch.int32),
        "done": z((batch,), torch.bool),
        "ctx_k": z((nb, tc.h + 1, batch, tc.w_oh, kv, hd), dt),
        "ctx_v": z((nb, tc.h + 1, batch, tc.w_oh, kv, hd), dt),
        "ctx_valid": z((batch, tc.w_oh), torch.bool),
        "gen_k": z((nb, tc.h + 2, batch, tc.w_og, kv, hd), dt),
        "gen_v": z((nb, tc.h + 2, batch, tc.w_og, kv, hd), dt),
    }
    if mode == "tlin":
        cache["hist_k"] = z((nb, batch, max_len, kv, hd), dt)
        cache["hist_v"] = z((nb, batch, max_len, kv, hd), dt)
    return cache


def kv_cache_bytes(cache: Dict[str, torch.Tensor]) -> int:
    """KV-cache footprint (the quantity in paper Fig 8g)."""
    return sum(cache[k].numel() * cache[k].element_size()
               for k in cache if k.endswith("_k") or k.endswith("_v"))


def needs_resync(cache: Dict[str, torch.Tensor], cfg: ModelConfig
                 ) -> torch.Tensor:
    """(B,) bool: the generation window is full."""
    return cache["gen_len"] >= cfg.tconst.w_og


def pending_resync_rows(cache: Dict[str, torch.Tensor], cfg: ModelConfig
                        ) -> torch.Tensor:
    """(B,) bool: rows that must sync before the next step -- the window
    is full AND the slot is not EOS-finished."""
    return needs_resync(cache, cfg) & ~cache["done"]


def resync_buckets(batch: int) -> Tuple[int, ...]:
    """Static gather sizes of JAX's compacted resync: 0, powers of two,
    and the full batch.  The pending count is rounded UP to the nearest
    bucket (a copy of ``repro.core.tconst.resync_buckets``)."""
    sizes = {0, batch}
    k = 1
    while k < batch:
        sizes.add(k)
        k *= 2
    return tuple(sorted(sizes))


@torch.no_grad()
def resync(params: Params, cache: Dict[str, torch.Tensor], cfg: ModelConfig,
           mode: str = "tconst") -> Dict[str, torch.Tensor]:
    """Cache-miss path (paper Eq. 4): fold the generation window into
    history and recompute the compressed-context KV (tlin: and the history
    KV, a projection of each block's input history) from the token ids.
    Cost O(N).  Needs only ``RESYNC_INPUT_KEYS``; returns a new dict with
    ``ctx_k``/``ctx_v``/``ctx_valid`` (tlin: ``hist_k``/``hist_v``)
    rebuilt, ``hist_len`` advanced and ``gen_len`` zeroed (other entries
    passed through)."""
    _check_mode(mode)
    tc = cfg.tconst
    eps = cfg.norm_eps
    B, max_len = cache["tokens"].shape
    dev = cache["tokens"].device
    hist_len = cache["hist_len"] + cache["gen_len"]
    X = E.embed_tokens(params["embed"], cache["tokens"], _dtype(cfg.dtype))
    pos = torch.arange(max_len, device=dev).expand(B, max_len)
    hist_valid = pos < hist_len[:, None]
    tail_pos = hist_len[:, None] - tc.w_oh + \
        torch.arange(tc.w_oh, device=dev)[None]
    tail_valid = tail_pos >= 0
    cos_t, sin_t = _rope(tail_pos.clamp(min=0), cfg)
    use_tlin = mode == "tlin"
    if use_tlin:
        cos_h, sin_h = _rope(pos, cfg)

    nb = len(params["blocks"])
    cks, cvs, hks, hvs = [], [], [], []
    hist = X
    for ib, block in enumerate(params["blocks"]):
        c_states, restored, _ = context_path(block, hist, pos, hist_valid,
                                             tail_pos, tail_valid, cfg,
                                             restore=ib + 1 < nb)
        ks, vs = [], []
        for i in range(1, tc.h + 2):
            li = block["layers"][i]
            cn = rmsnorm(li["ln1"], c_states[i - 1], eps)
            ck, cv = A.project_kv(li["attn"], cn, cos_t, sin_t)
            ks.append(ck)
            vs.append(cv)
        cks.append(torch.stack(ks))
        cvs.append(torch.stack(vs))
        if use_tlin:
            l0 = block["layers"][0]
            hk, hv = A.project_kv(l0["attn"], rmsnorm(l0["ln1"], hist, eps),
                                  cos_h, sin_h)
            hks.append(hk)
            hvs.append(hv)
        hist = restored
    out = dict(cache)
    out["ctx_k"] = torch.stack(cks)
    out["ctx_v"] = torch.stack(cvs)
    if use_tlin:
        out["hist_k"] = torch.stack(hks)
        out["hist_v"] = torch.stack(hvs)
    out["ctx_valid"] = tail_valid
    out["hist_len"] = hist_len.to(torch.int32)
    out["gen_len"] = torch.zeros_like(cache["gen_len"])
    return out


@torch.no_grad()
def decode_step_views(params: Params, cache: Dict[str, Any],
                      token: torch.Tensor, cfg: ModelConfig,
                      mode: str = "tconst",
                      live: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Layout-native cache-hit step (paper Eq. 5): O(1) compute and reads
    for mode="tconst"; mode="tlin" also reads the O(N) history KV.
    ``cache`` maps bookkeeping names to tensors and KV names to
    :mod:`repro_torch.models.layouts` FieldViews: the attention consumes
    the PHYSICAL representation (K3 walks the paged history's page table,
    K1's int8 variant dequantises int8 fields) and the new token's K/V is
    written through the views.  token (B,).

    Updates the cache IN PLACE and returns (logits (B, V), cache).  Rows
    where ``live`` (B,) bool is False keep every cache entry bit-identical
    (their K/V, id and counter writes are masked).  The caller must run
    :func:`resync` on a live row once its ``gen_len`` reaches ``W_og``.
    """
    _check_mode(mode)
    tc = cfg.tconst
    eps = cfg.norm_eps
    cap = cfg.logit_softcap
    B = token.shape[0]
    dev = token.device
    if live is None:
        live = torch.ones((B,), dtype=torch.bool, device=dev)
    gen_len = cache["gen_len"]
    pos = cache["hist_len"] + gen_len                           # (B,)
    x = E.embed_tokens(params["embed"], token[:, None], _dtype(cfg.dtype))
    cos_q, sin_q = _rope(pos[:, None], cfg)

    write = live & (gen_len < tc.w_og)
    slot = gen_len.clamp(0, tc.w_og - 1).long()
    self_lo = torch.zeros_like(gen_len)
    self_hi = gen_len + 1
    # the valid context slots are a suffix: ctx_valid = tail_pos >= 0
    ctx_lo = (tc.w_oh - cache["ctx_valid"].sum(dim=-1)).to(torch.int32)
    ctx_hi = torch.full_like(gen_len, tc.w_oh)
    use_tlin = mode == "tlin"

    for ib, block in enumerate(params["blocks"]):
        gkb, gvb = cache["gen_k"].layer(ib), cache["gen_v"].layer(ib)
        ckb, cvb = cache["ctx_k"].layer(ib), cache["ctx_v"].layer(ib)
        for i in range(tc.h + 2):
            li = block["layers"][i]
            xn = rmsnorm(li["ln1"], x, eps)
            out, q = A.decode_attend_view(li["attn"], xn, gkb.layer(i),
                                          gvb.layer(i), slot, write, self_lo,
                                          self_hi, cos_q, sin_q, cap)
            if i >= 1:
                out = out + A.cross_attend_view(
                    li["attn"], q, ckb.layer(i - 1), cvb.layer(i - 1),
                    ctx_lo, ctx_hi, cap)
            elif use_tlin:
                # TLinFormer's O(N) history KV, slots [0, hist_len): the
                # one paged field of this family, attended in its layout
                out = out + A.cross_attend_view(
                    li["attn"], q, cache["hist_k"].layer(ib),
                    cache["hist_v"].layer(ib), None, cache["hist_len"], cap)
            x = x + out
            x = x + _ffn_apply(li, rmsnorm(li["ln2"], x, eps), cfg)[0]

    x = rmsnorm(params["final_norm"], x, eps)
    logits = E.lm_head(params["embed"], x, cap)[:, 0]

    # record the token id into the O(N) id buffer (int32, not KV cache)
    toks = cache["tokens"]
    max_len = toks.shape[1]
    rows = torch.arange(B, device=dev)
    tpos = pos.clamp(0, max_len - 1).long()
    toks[rows, tpos] = torch.where(live & (pos < max_len),
                                   token.to(torch.int32), toks[rows, tpos])
    gen_len += live.to(gen_len.dtype)
    return logits, cache


def _dense_views(cache: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Wrap a dense cache dict's KV fields in DenseViews (aliasing)."""
    return {k: LT.DenseView(v, CACHE_BATCH_AXES[k]) if k in KV_KEYS else v
            for k, v in cache.items()}


@torch.no_grad()
def decode_step(params: Params, cache: Dict[str, torch.Tensor],
                token: torch.Tensor, cfg: ModelConfig, mode: str = "tconst",
                live: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Dense-dict cache-hit step: :func:`decode_step_views` over DenseViews
    of ``cache`` (updated IN PLACE) -- the oracle the layout-native step
    is tested against.  Returns (logits (B, V), cache)."""
    logits, _ = decode_step_views(params, _dense_views(cache), token, cfg,
                                  mode, live)
    return logits, cache


def _prefill_window_pass(params: Params, cache: Dict[str, torch.Tensor],
                         win: torch.Tensor, gen_pos: torch.Tensor,
                         cfg: ModelConfig, mode: str = "tconst"
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Teacher-forced pass over the prompt's trailing window (B, W):
    causal self-attention over the window plus cross-attention to the
    valid context slots (tlin, layer 0: to the history KV slots
    ``[0, hist_len)``).  Returns (hg (B, W, D), gen_k, gen_v stacked
    (nb, h+2, B, W, KV, hd))."""
    tc = cfg.tconst
    eps = cfg.norm_eps
    cap = cfg.logit_softcap
    dtype = _dtype(cfg.dtype)
    cos_g, sin_g = _rope(gen_pos, cfg)
    hg = E.embed_tokens(params["embed"], win, dtype)
    # cross-attention to the context is masked by validity only
    ctx_kp = _key_pos(torch.zeros_like(cache["ctx_valid"], dtype=torch.int32),
                      cache["ctx_valid"])
    use_tlin = mode == "tlin"
    if use_tlin:
        slots = torch.arange(cache["tokens"].shape[1], device=win.device)
        hist_valid = slots[None] < cache["hist_len"][:, None]
        hist_kp = _key_pos(torch.zeros_like(hist_valid, dtype=torch.int32),
                           hist_valid)
    gks, gvs = [], []
    for ib, block in enumerate(params["blocks"]):
        ks, vs = [], []
        for i in range(tc.h + 2):
            li = block["layers"][i]
            xn = rmsnorm(li["ln1"], hg, eps)
            k, v = A.project_kv(li["attn"], xn, cos_g, sin_g)
            q = R.apply_rope(A.q_proj(li["attn"], xn, dtype), cos_g, sin_g)
            out = A.out_proj(li["attn"], ops.flash_attention(
                q, k, v, gen_pos, gen_pos, causal=True, softcap=cap), dtype)
            ks.append(k)
            vs.append(v)
            if i >= 1:
                out = out + A.out_proj(li["attn"], ops.flash_attention(
                    q, cache["ctx_k"][ib, i - 1].to(dtype),
                    cache["ctx_v"][ib, i - 1].to(dtype), gen_pos, ctx_kp,
                    causal=False, softcap=cap), dtype)
            elif use_tlin:
                out = out + A.out_proj(li["attn"], ops.flash_attention(
                    q, cache["hist_k"][ib].to(dtype),
                    cache["hist_v"][ib].to(dtype), gen_pos, hist_kp,
                    causal=False, softcap=cap), dtype)
            hg = hg + out
            hg = hg + _ffn_apply(li, rmsnorm(li["ln2"], hg, eps), cfg)[0]
        gks.append(torch.stack(ks))
        gvs.append(torch.stack(vs))
    return hg, torch.stack(gks), torch.stack(gvs)


@torch.no_grad()
def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int, mode: str = "tconst"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Process a prompt: resync over the history part, teacher-forced pass
    over the trailing (1..W_og) generation-window part, fill all caches.
    tokens (B, N0).  Returns (next-token logits (B, V), cache)."""
    _check_mode(mode)
    tc = cfg.tconst
    B, n0 = tokens.shape
    if n0 < 1 or n0 > max_len:
        raise ValueError(f"prompt length {n0} must be in [1, {max_len}]")
    g0 = ((n0 - 1) % tc.w_og) + 1
    dev = tokens.device
    cache = init_tconst_cache(cfg, B, max_len, mode, device=dev)
    cache["tokens"][:, :n0] = tokens.to(torch.int32)
    cache["hist_len"].fill_(n0 - g0)
    cache = resync(params, cache, cfg, mode)

    win = tokens[:, n0 - g0:]
    gen_pos = (n0 - g0 + torch.arange(g0, device=dev)).expand(B, g0)
    hg, gk, gv = _prefill_window_pass(params, cache, win, gen_pos, cfg,
                                      mode)
    hg = rmsnorm(params["final_norm"], hg, cfg.norm_eps)
    logits = E.lm_head(params["embed"], hg[:, -1:], cfg.logit_softcap)[:, 0]
    cache["gen_k"][:, :, :, :g0] = gk
    cache["gen_v"][:, :, :, :g0] = gv
    cache["gen_len"] = torch.full_like(cache["gen_len"], g0)
    return logits, cache


def prefill_bucketed(*args, **kwargs):
    raise NotImplementedError(
        "prefill_bucketed (one fixed-shape admission for every prompt "
        "length, the TConst form of chunked admission) is not ported yet: "
        "ROADMAP Queue 1 item 8")


def verify_chunk_views(*args, **kwargs):
    raise NotImplementedError(
        "verify_chunk_views (speculative verify) is not ported yet: ROADMAP "
        "Queue 1 item 8 (speculative decoding)")
