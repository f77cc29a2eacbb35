"""Slot-based continuous-batching scheduler (the core of
``src/repro/serving/scheduler.py``).

The scheduler owns one fixed-shape multi-slot ``DecodeState`` and admits
/ evicts :class:`~repro_torch.serving.session.Session` objects mid-flight:

* **admit** -- a free slot is filled by ``prefill_into_slot``: the
  session's prompt is prefilled as a batch-1 row and written into the
  slot; running slots are untouched.
* **decode** -- all slots advance together in chunks of ``chunk_size``
  tokens (:func:`~repro_torch.models.api.decode_chunk`), through any
  decode of the :class:`~repro_torch.models.api.DecodeAPI` protocol.  The
  TConst resync of a slot whose window is full runs inside the chunk on
  exactly the rows that need it, decided from the host mirror of
  ``gen_len`` (a family without a periodic sync, the SSM one, never
  resyncs: ``resyncs`` stays 0); the sampled ids come to the host once
  per chunk.
* **retire** -- a session that exhausts its budget or hits EOS frees its
  slot at the chunk boundary (the slot is cleared, so a stale counter
  can never fire a resync of an empty row).
* **pages** -- on a paged layout whose cache has paged fields (tlin's
  history KV) the scheduler owns page assignment: the table starts
  all-TRASH with every pool page free, an admission takes the pages its
  session can ever need (prompt + budget + one chunk of headroom) or
  waits, and a release retargets the slot's table row at the trash page
  before clearing the slot, then frees its pages.  A page-blocked queue
  head may be overtaken by at most ``max_head_skips`` admissions, after
  which admission is strictly in arrival order until the head admits.

Sampling: each session draws from its own ``torch.Generator`` seeded from
``Session.seed`` (or the scheduler seed and ``sid``), so a session's
stream depends on the session alone.  Left out of the port so far (ROADMAP
Queue 1 item 8): prefix sharing (page refcounts above 1, copy-on-write),
chunked admission, session tiering, policies, telemetry and speculative
decoding.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import layouts as LT
from repro_torch.models.api import (DecodeAPI, ModelAPI, decode_chunk,
                                    sample_tokens)
from repro_torch.serving.engine import StepStats, device_sync, tag_compiled
from repro_torch.serving.session import Session


class SlotScheduler:
    def __init__(self, decode: DecodeAPI, params: Any, slots: int,
                 max_len: int, chunk_size: int = 8, seed: int = 0,
                 max_head_skips: Optional[int] = None):
        # accept a ModelAPI facade too (its dense-layout decode)
        if isinstance(decode, ModelAPI):
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
        self.layout = self.state.layout
        # prefilled rows are dense; the slot write goes through the
        # state's layout (paged: the slot's own pages)
        self._empty_row = dataclasses.replace(
            decode, layout=LT.DENSE_SPEC).init_state(1, max_len)

        # paged layout: the scheduler owns page assignment.  Start from an
        # all-TRASH table with every pool page free.  Only when the cache
        # HAS paged fields: pure tconst and the SSM state store nothing in
        # pages, and their admission must not gate on the pool.
        self._paged = isinstance(self.layout, LT.PagedLayout) and \
            self.layout.pages_anything(self.state.kv)
        self.free_pages: List[int] = []
        self._slot_pages: List[List[int]] = [[] for _ in range(slots)]
        self._page_ref = np.zeros((0,), np.int32)
        if self._paged:
            self.state.bookkeeping[LT.PAGE_TABLE].fill_(self.layout.trash)
            self.free_pages = list(range(self.layout.pool_pages))
            self._page_ref = np.zeros((self.layout.pool_pages,), np.int32)
        # bounded skip-ahead past a page-blocked queue head (then strict
        # arrival order until the head admits: no starvation)
        self.max_head_skips = 4 * slots if max_head_skips is None \
            else max_head_skips
        self._head_skips = 0
        # admission rounds in which a free slot waited for pool pages, and
        # the most sessions that decoded in one chunk
        self.page_waits = 0
        self.peak_active = 0

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
    def _pages_needed(self, session: Session) -> int:
        need = len(session.prompt) + session.max_new_tokens + self.chunk_size
        return -(-need // self.layout.page)

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
        # a session needing more pages than the POOL holds could never be
        # admitted, leaving run() to spin on it forever
        if self._paged and \
                self._pages_needed(session) > self.layout.pool_pages:
            raise ValueError(
                f"session {session.sid}: needs {self._pages_needed(session)}"
                f" pages but the paged pool only has "
                f"{self.layout.pool_pages} -- it could never be admitted")
        session.submit_clock = self.clock
        self.pending.append(session)
        return session

    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    def kv_bytes(self) -> int:
        """Physical KV bytes of the state (pools in full)."""
        return self.state.kv_bytes()

    def _set_table_row(self, slot: int, pages: List[int]) -> None:
        self._slot_pages[slot] = list(pages)
        row = np.full((self.layout.pages_per_slot,), self.layout.trash,
                      np.int32)
        row[:len(pages)] = pages
        self.state.bookkeeping[LT.PAGE_TABLE][slot] = torch.as_tensor(
            row, device=self.device)

    def _admission_plan(self, session: Session) -> Optional[int]:
        """How many pool pages this admission takes, or None while the
        free pool is short (the session waits for running sessions to
        retire)."""
        if not self._paged:
            return 0
        total = self._pages_needed(session)
        return total if total <= len(self.free_pages) else None

    def _session_generator(self, session: Session) -> torch.Generator:
        seed = session.seed if session.seed is not None else int(
            np.random.SeedSequence([self.seed, session.sid]).generate_state(
                1)[0])
        return torch.Generator(device=self.device).manual_seed(seed)

    def _admit(self, session: Session, slot: int, n_pages: int) -> None:
        if self._paged:
            pages = [self.free_pages.pop() for _ in range(n_pages)]
            for p in pages:
                self._page_ref[p] = 1
            self._set_table_row(slot, pages)
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
        """Admit pending sessions into free slots, in arrival order; a
        session blocked on pool pages may be overtaken by later ones, at
        most ``max_head_skips`` times in a row (then strict arrival order
        until the head admits).  Returns True if any session was
        admitted."""
        admitted = False
        free = [i for i in range(self.slots) if not self.active[i]]
        while free and self.pending:
            head = self.pending[0]
            candidates = [head] if self._head_skips >= self.max_head_skips \
                else list(self.pending)
            chosen = plan = None
            for cand in candidates:
                plan = self._admission_plan(cand)
                if plan is not None:
                    chosen = cand
                    break
            if chosen is None:
                self.page_waits += 1
                break                  # nothing admissible this round
            for i, s in enumerate(self.pending):
                if s is chosen:        # identity, not __eq__ (ndarrays)
                    del self.pending[i]
                    break
            self._head_skips = 0 if chosen is head else self._head_skips + 1
            slot = free.pop(0)
            self._admit(chosen, slot, plan)
            admitted = True
            if chosen.done:
                self._release(slot)
                free.insert(0, slot)
        if not self.pending:
            self._head_skips = 0
        return admitted

    def _release(self, slot: int) -> None:
        self.sessions[slot] = None
        self.active[slot] = False
        self.temps[slot] = 0.0
        self.eos[slot] = -1
        self.generators[slot] = None
        if self._paged:
            # retarget the table row at TRASH before the clearing write
            # below, so the clearing zeros land on the trash page; then
            # free the slot's pages
            pages = self._slot_pages[slot]
            self._set_table_row(slot, [])
            for p in pages:
                self._page_ref[p] -= 1
                if self._page_ref[p] == 0:
                    self.free_pages.append(p)
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
        self.peak_active = max(self.peak_active, self.n_active)
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
        """Drive chunks until every submitted session has completed.
        Raises instead of spinning when nothing could be admitted or
        decoded while work remains."""
        while True:
            if self.step():
                continue
            if not self.pending and not self.active.any():
                return
            head = self.pending[0] if self.pending else None
            need = self._pages_needed(head) if head and self._paged else 0
            pool = self.layout.pool_pages if self._paged else 0
            raise RuntimeError(
                f"scheduler stuck: {len(self.pending)} pending, "
                f"{self.n_active} active, nothing could run (head needs "
                f"{need} pages; free {len(self.free_pages)}/{pool})")
