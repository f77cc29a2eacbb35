"""Slot-based continuous-batching scheduler (the core of
``src/repro/serving/scheduler.py``).

The scheduler owns one fixed-shape multi-slot ``DecodeState`` and admits
/ evicts :class:`~repro_torch.serving.session.Session` objects mid-flight:

* **admit** -- a free slot is filled by ``prefill_into_slot``: the
  session's prompt is prefilled as a batch-1 row and written into the
  slot; running slots are untouched.
* **decode** -- all slots advance together in chunks of ``chunk_size``
  tokens (:func:`~repro_torch.models.api.decode_chunk`).  The TConst
  resync of a slot whose window is full runs inside the chunk on exactly
  the rows that need it, decided from the host mirror of ``gen_len``; the
  sampled ids come to the host once per chunk.
* **retire** -- a session that exhausts its budget or hits EOS frees its
  slot at the chunk boundary (the slot is cleared, so a stale counter
  can never fire a resync of an empty row).

Sampling: each session draws from its own ``torch.Generator`` seeded from
``Session.seed`` (or the scheduler seed and ``sid``), so a session's
stream depends on the session alone.  Left out of the port so far (ROADMAP
Queue 1 item 8): paged pools, prefix sharing, session tiering, policies,
telemetry and speculative decoding.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.api import TConstDecode, decode_chunk, sample_tokens
from repro_torch.serving.engine import StepStats, device_sync, tag_compiled
from repro_torch.serving.session import Session


class SlotScheduler:
    def __init__(self, decode: TConstDecode, params: Any, slots: int,
                 max_len: int, chunk_size: int = 8, seed: int = 0):
        # accept a ModelAPI facade too (duck-typed .decode)
        if not isinstance(decode, TConstDecode) and hasattr(decode,
                                                            "decode"):
            decode = decode.decode
        if slots < 1:
            raise ValueError("scheduler needs at least one decode slot")
        if chunk_size < 1:
            raise ValueError("chunk_size must be positive")
        self.decode = decode
        self.device = decode.device
        self.params = decode.prepare_params(params)
        self.slots = slots
        self.max_len = max_len
        self.chunk_size = chunk_size
        self.seed = seed
        self.state = decode.init_state(slots, max_len)
        self._empty_row = decode.init_state(1, max_len)

        self.generators: List[Optional[torch.Generator]] = [None] * slots
        self.last_token = torch.zeros((slots,), dtype=torch.int32,
                                      device=self.device)
        self.temps = np.zeros((slots,), np.float32)
        self.eos = np.full((slots,), -1, np.int32)
        self.active = np.zeros((slots,), bool)
        self.sessions: List[Optional[Session]] = [None] * slots
        self.pending: Deque[Session] = collections.deque()
        self.stats: List[StepStats] = []
        self.admit_stats: List[StepStats] = []
        self.resyncs: Dict[int, int] = {}   # sid -> resyncs in its slot
        self._warm: set = set()
        self.clock = 0                      # completed step() calls

    # ------------------------------------------------------------------
    def submit(self, session: Session) -> Session:
        """Queue a session; it is admitted at the next chunk boundary."""
        # decode writes ids into the slot's fixed (max_len,) buffer; a
        # session may overshoot its budget by up to one chunk before it is
        # retired at the boundary
        need = len(session.prompt) + session.max_new_tokens + self.chunk_size
        if need > self.max_len:
            raise ValueError(
                f"session {session.sid}: prompt {len(session.prompt)} + "
                f"max_new_tokens {session.max_new_tokens} (+ headroom "
                f"{self.chunk_size}) exceeds max_len {self.max_len}")
        session.submit_clock = self.clock
        self.pending.append(session)
        return session

    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    def kv_bytes(self) -> int:
        return self.state.kv_bytes()

    def _session_generator(self, session: Session) -> torch.Generator:
        seed = session.seed if session.seed is not None else int(
            np.random.SeedSequence([self.seed, session.sid]).generate_state(
                1)[0])
        return torch.Generator(device=self.device).manual_seed(seed)

    def _admit(self, session: Session, slot: int) -> None:
        t0 = time.perf_counter()
        logits, self.state = self.decode.prefill_into_slot(
            self.params, self.state, slot, session.prompt)
        device_sync(self.device)
        self.admit_stats.append(StepStats(
            "admit", time.perf_counter() - t0, tokens=len(session.prompt),
            compiled=tag_compiled(self._warm, "admit",
                                  len(session.prompt))))
        gen = self._session_generator(session)
        t0k = sample_tokens(logits[None], np.array([session.temperature]),
                            [gen])[0]
        self.generators[slot] = gen
        self.last_token[slot] = t0k
        session.slot = slot
        self.sessions[slot] = session
        self.active[slot] = True
        self.temps[slot] = session.temperature
        self.eos[slot] = -1 if session.eos_id is None else session.eos_id
        self.resyncs.setdefault(session.sid, 0)
        session.deliver([int(t0k)])          # first token: prefill logits

    def admit_pending(self) -> bool:
        """Admit pending sessions, in arrival order, into free slots.
        Returns True if any session was admitted."""
        admitted = False
        free = [i for i in range(self.slots) if not self.active[i]]
        while free and self.pending:
            session = self.pending.popleft()
            slot = free.pop(0)
            self._admit(session, slot)
            admitted = True
            if session.done:
                self._release(slot)
                free.insert(0, slot)
        return admitted

    def _release(self, slot: int) -> None:
        self.sessions[slot] = None
        self.active[slot] = False
        self.temps[slot] = 0.0
        self.eos[slot] = -1
        self.generators[slot] = None
        # clear the slot so stale phase counters can't fire a resync of an
        # empty row
        self.state = self.state.with_slot(slot, self._empty_row)
        self.last_token[slot] = 0

    def step(self) -> bool:
        """Admit pending sessions, then decode ONE chunk for the active
        slots.  Returns False when no progress was made."""
        self.clock += 1
        admitted = self.admit_pending()
        if not self.active.any():
            return admitted
        run_mask = self.active.copy()
        t0 = time.perf_counter()
        toks, self.state, resyncs = decode_chunk(
            self.decode, self.params, self.state, self.last_token,
            self.generators, self.temps, run_mask,
            n_steps=self.chunk_size, eos=self.eos)
        self.last_token = toks[:, -1].clone()
        host_toks = toks.cpu().numpy()       # the one host sync per chunk
        self.stats.append(StepStats(
            "chunk", time.perf_counter() - t0, tokens=self.chunk_size,
            compiled=tag_compiled(self._warm, "chunk")))
        for slot in np.nonzero(run_mask)[0]:
            sess = self.sessions[slot]
            self.resyncs[sess.sid] += int(resyncs[slot])
            sess.deliver(host_toks[slot])
            if sess.done:
                self._release(int(slot))
        return True

    def run(self) -> None:
        """Drive chunks until every submitted session has completed."""
        while True:
            if self.step():
                continue
            if not self.pending and not self.active.any():
                return
            raise RuntimeError(
                f"scheduler stuck: {len(self.pending)} pending, "
                f"{self.n_active} active, nothing could run")
