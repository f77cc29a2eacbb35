"""Uniform-batch generation engine (port of ``src/repro/serving/engine.py``
:50-175).

Same-length prompts in, ``(B, n)`` ids out.  ``generate(record_stats=
False)`` runs the eager chunked path (:func:`repro_torch.models.api.
decode_chunk`); ``record_stats=True`` the instrumented path that times
each cache hit and each resync (miss) separately -- the amortized O(1)
schedule of paper §4 (``W_og - 1`` constant-time hits, then one
linear-time miss) for the Fig 8 latency split; a family without a
periodic sync (SSM) records hit steps only.  On CUDA every timed
entry ends in ``torch.cuda.synchronize``.  ``layout`` picks the cache
layout (``repro_torch.models.layouts``); a uniform batch is prefilled in
one piece, so a paged layout needs its full pool.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.api import (ModelAPI, build_decode, decode_chunk,
                                    sample_tokens)


@dataclasses.dataclass
class StepStats:
    kind: str      # "prefill" | "hit" | "miss" | "chunk" | "admit" | "spill"
    seconds: float
    tokens: int = 1        # tokens produced by this entry (chunks: many)
    # True for the first dispatch of each (kind, signature): its time
    # includes one-time warm-up (the kernels' build and load on first use).
    compiled: bool = False
    # "admit" entries: the prompt positions the admission forwarded (a
    # chunked admission: the unshared tail padded to the chunk grid; the
    # bucketed TConst one: max_len; one-shot: the whole prompt; a restore
    # from the tier store: 0)
    forward_tokens: Optional[int] = None
    # "admit" entries: where the slot state came from -- "cold" (a prefill
    # forward), "resume" (a spilled session's pinned snapshot restored) or
    # "store" (a known prompt's post-admission state restored, no forward)
    source: Optional[str] = None


def tag_compiled(warm: set, kind: str, sig: Any = None) -> bool:
    """True exactly for the first dispatch of each (kind, signature)."""
    key = (kind, sig)
    fresh = key not in warm
    warm.add(key)
    return fresh


def device_sync(device: torch.device) -> None:
    """Wait for the device (host clocks around CUDA work need it)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Engine:
    def __init__(self, api: ModelAPI, params: Any, max_len: int,
                 sample_temperature: float = 0.0, seed: int = 0,
                 device: Any = None, layout: Any = None,
                 prefill_chunk: Optional[int] = None):
        self.api = api
        # prefill_chunk rides on the decode: the engine's own batch
        # prefill is one piece, but a SlotScheduler built on this decode
        # takes it as its chunked-admission default
        self.decode = build_decode(api.cfg, layout,
                                   device=device or api.device,
                                   prefill_chunk=prefill_chunk)
        self.device = self.decode.device
        self.params = self.decode.prepare_params(params)
        self.max_len = max_len
        self.temperature = sample_temperature
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed)
        self.stats: List[StepStats] = []
        self._warm: set = set()

    def _stat(self, kind: str, seconds: float, sig: Any = None,
              tokens: int = 1) -> None:
        self.stats.append(StepStats(kind, seconds, tokens=tokens,
                                    compiled=tag_compiled(self._warm, kind,
                                                          sig)))

    def _select(self, logits: torch.Tensor) -> torch.Tensor:
        B = logits.shape[0]
        return sample_tokens(logits, np.full((B,), self.temperature),
                             [self.generator] * B)

    def generate(self, batch: Dict[str, Any], n_tokens: int,
                 record_stats: bool = False) -> np.ndarray:
        """batch: {"tokens": (B, L) same-length prompts}.  Returns
        (B, n_tokens) generated ids."""
        t0 = time.perf_counter()
        logits, state = self.decode.prefill(self.params, batch,
                                            self.max_len)
        if record_stats:
            device_sync(self.device)
            self._stat("prefill", time.perf_counter() - t0,
                       sig=tuple(np.shape(batch["tokens"])))
        token = self._select(logits)
        if record_stats:
            return self._generate_instrumented(state, token, n_tokens)
        return self._generate_chunked(state, token, n_tokens)

    def _generate_chunked(self, state, token, n_tokens: int) -> np.ndarray:
        B = token.shape[0]
        toks, _, _ = decode_chunk(
            self.decode, self.params, state, token, [self.generator] * B,
            np.full((B,), self.temperature), np.ones((B,), bool),
            n_steps=n_tokens - 1)
        return torch.cat([token[:, None], toks], dim=1).cpu().numpy()

    def _generate_instrumented(self, state, token, n_tokens: int
                               ) -> np.ndarray:
        """One step at a time, the resync decided on the host (from the
        host mirror of gen_len), each hit and miss timed separately."""
        out = [token]
        for _ in range(n_tokens - 1):
            rows = self.decode.sync_candidates(state)
            if rows.any():
                t0 = time.perf_counter()
                state = self.decode.sync_rows(self.params, state, rows)
                device_sync(self.device)
                self._stat("miss", time.perf_counter() - t0)
            t0 = time.perf_counter()
            logits, state = self.decode.raw_step(self.params, state, token)
            token = self._select(logits)
            device_sync(self.device)
            self._stat("hit", time.perf_counter() - t0)
            out.append(token)
        return torch.stack(out, dim=1).cpu().numpy()

    def cache_bytes(self, batch_size: int) -> int:
        """KV-cache footprint at max_len (paper Fig 8g) in the engine's
        physical layout, from the shapes alone (meta tensors: no
        allocation)."""
        meta = dataclasses.replace(self.decode, device=torch.device("meta"))
        return meta.init_state(batch_size, self.max_len).kv_bytes()
