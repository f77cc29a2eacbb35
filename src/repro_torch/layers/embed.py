"""Token embedding, the (tied or separate) output head and the frontend
projector.

Port of ``src/repro/layers/embed.py:19-55``: the head multiplies in the
activation dtype, then returns float32 logits (optional tanh softcap).
The audio frontend is a stub in the JAX package too: the model takes
post-conv frame embeddings (B, T, frontend_dim), and ``frontend_proj``
maps them to d_model.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.layers.common import Params, dense_init


def init_embed(cfg: ModelConfig, gen: torch.Generator,
               dtype: Optional[torch.dtype] = None) -> Params:
    """``tok`` (V, d) ~ N(0, 0.02^2), then, for untied embeddings, the
    head (d, V) from :func:`dense_init` -- drawn in float32 from ``gen``
    on its device in that order, each cast to ``dtype`` as drawn (default:
    kept float32; the port's own init), then, with a frontend, its
    ``frontend_proj`` (frontend_dim, d) from :func:`dense_init`."""
    tok = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                      device=gen.device) * 0.02
    params = {"tok": tok if dtype is None else tok.to(dtype)}
    if not cfg.tie_embeddings:
        params["head"] = dense_init((cfg.d_model, cfg.vocab_size),
                                    cfg.d_model, gen, dtype)
    if cfg.frontend != "none":
        fdim = cfg.frontend_dim or cfg.d_model
        params["frontend_proj"] = dense_init((fdim, cfg.d_model), fdim, gen,
                                             dtype)
    return params


def embed_tokens(params: Params, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    return params["tok"].to(dtype)[tokens.long()]


def project_frontend(params: Params, feats: torch.Tensor) -> torch.Tensor:
    """Map stub frontend embeddings (B, T, frontend_dim) into d_model."""
    return torch.einsum("btf,fd->btd", feats,
                        params["frontend_proj"].to(feats.dtype))


def lm_head(params: Params, x: torch.Tensor,
            logit_softcap: float = 0.0) -> torch.Tensor:
    if "head" in params:
        logits = torch.einsum("bld,dv->blv", x, params["head"].to(x.dtype))
    else:
        logits = torch.einsum("bld,vd->blv", x, params["tok"].to(x.dtype))
    logits = logits.float()
    if logit_softcap > 0.0:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    return logits
