"""Per-request inference sessions for the streaming serving path.

A :class:`Session` is the unit the scheduler admits into a decode slot:
it owns its prompt (any length), sampling parameters, token budget and
an optional streaming callback fired once per generated token.  Sessions
are plain host-side objects — all device state lives in the scheduler's
fixed-shape :class:`repro_torch.models.api.DecodeState`.  (A copy of the
JAX package's ``serving/session.py``; the port imports nothing of it.)

Typical use (see ``repro_torch.launch.serve --sessions`` for a runnable
demo)::

    sched = SlotScheduler(build_model(cfg).decode, params,
                          slots=4, max_len=512)
    s = sched.submit(Session(prompt, max_new_tokens=32,
                             on_token=lambda sess, t: print(t)))
    sched.run()            # continuous batching; tokens stream via callback
    print(s.tokens)
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional

import numpy as np

_IDS = itertools.count()


@dataclasses.dataclass
class Session:
    """One generation request.

    prompt: 1-D int32 token ids (any length — slots in the same batch may
    have different prompt lengths and resync phases).
    max_new_tokens: total tokens to generate, INCLUDING the first token
    sampled from the prefill logits.
    temperature: sampling temperature (<= 0 means greedy).
    eos_id: optional end-of-sequence token id — generating it finishes
    the session early (the EOS itself is delivered).  On device, the
    slot's ``done`` flag freezes it for the rest of the decode chunk;
    the scheduler evicts it at the chunk boundary.
    on_token: optional ``f(session, token)`` streaming callback.
    extras: per-request model inputs beyond tokens: ``audio_feats``
    (encoder_seq, frontend_dim) for the encoder-decoder, which its
    admission requires; a VLM's ``vision_embeds`` (frontend_tokens,
    frontend_dim) and ``vision_mask`` (prompt length,) bool, without
    which its request is text-only.
    seed: optional per-session sampling seed.  When set, the session's
    ``torch.Generator`` is seeded with it and draws once per sampled
    token — a pure function of this session's own progress, so replaying
    the same session (any slot) yields the identical token stream.  When
    None, the seed derives from the scheduler seed and ``sid``.
    priority: scheduling weight (higher = more urgent); only consulted
    by priority-aware policies, never by the FIFO baseline.
    slo_ttft_chunks / slo_itl_chunks: optional SLO targets in scheduler
    chunk units — deadline for the first token after submission, and the
    max tolerated inter-token gap.  Pure metadata: policies may order
    work by them and telemetry scores attainment, but the scheduler
    mechanism never inspects them.
    """

    prompt: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    eos_id: Optional[int] = None
    on_token: Optional[Callable[["Session", int], None]] = None
    extras: Optional[Dict[str, Any]] = None
    seed: Optional[int] = None
    priority: int = 0
    slo_ttft_chunks: Optional[int] = None
    slo_itl_chunks: Optional[int] = None

    # filled by the scheduler -----------------------------------------------
    sid: int = dataclasses.field(default_factory=lambda: next(_IDS))
    tokens: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False
    # session tiering (scheduler-managed): while spilled, ``snap_key`` is
    # the tier-store key of the session's pinned slot snapshot and
    # ``slot`` is None; a later admission restores it into ANY free slot
    # and clears the key.  ``spills``/``resumes`` count the completed
    # HBM -> host -> HBM cycles (the serve demo's per-session report).
    snap_key: Optional[bytes] = None
    spills: int = 0
    resumes: int = 0
    # submit-time scheduler clock (chunk units) — set by ``submit``; the
    # anchor for TTFT/queue-wait accounting and deadline slack.
    submit_clock: Optional[int] = None
    # the session's sampling generator state, frozen across a spill (its
    # position is ``len(tokens)`` draws, so restoring it resumes the exact
    # stream): ``torch.Generator.get_state()`` as a uint8 array.
    sample_chain: Optional[np.ndarray] = None

    def __post_init__(self) -> None:
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        assert self.max_new_tokens >= 1, "need at least the prefill token"

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.tokens)

    def deliver(self, tokens) -> None:
        """Append generated tokens (clipped to the budget, truncated at
        ``eos_id``) and stream them through the callback; marks the
        session done at budget or EOS."""
        for t in list(tokens)[: self.remaining]:
            self.tokens.append(int(t))
            if self.on_token is not None:
                self.on_token(self, int(t))
            if self.eos_id is not None and int(t) == self.eos_id:
                self.done = True
                return
        if self.remaining == 0:
            self.done = True
