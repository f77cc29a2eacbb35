"""Token embedding and the tied output head.

Port of ``src/repro/layers/embed.py:35-55``: the head multiplies in the
activation dtype, then returns float32 logits (optional tanh softcap).
"""
from __future__ import annotations

import torch

from repro_torch.layers.common import Params


def embed_tokens(params: Params, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    return params["tok"].to(dtype)[tokens.long()]


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
