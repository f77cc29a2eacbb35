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
  history KV, an attention LM's K/V) the scheduler owns page assignment:
  the table starts all-TRASH with every pool page free, an admission
  takes the pages its session can ever need (prompt + budget + one chunk
  of headroom) or waits, and a release retargets the slot's table row at
  the trash page before clearing the slot, then drops its page
  references.  A page-blocked queue head may be overtaken by at most
  ``max_head_skips`` admissions, after which admission is strictly in
  arrival order until the head admits.
* **chunked admission** -- with ``prefill_chunk`` (default: the
  decode's) an admission runs ``prefill_into_slot_chunked``: the prompt
  in fixed chunks that attend the KV already in the slot, so under
  prefix sharing it forwards the unshared tail only (the TConst family
  buckets its admission instead).  Chunks on a paged layout cover whole
  pages.
* **prefix sharing (copy-on-write)** -- with ``prefix_sharing=True`` the
  scheduler keeps a host-side map from page-aligned prompt chunks (sha1
  keys rolling over the prompt) to resident pool pages, and a refcount
  per page.  A session whose prompt prefix matches resident pages maps
  them into its table row instead of writing them again (the admission
  write is masked to the unshared tail), so S sessions sharing a system
  prompt store its KV once.  A page is writable only at refcount 1:
  before a chunk in which a slot's resync may fire
  (``DecodeAPI.sync_anticipated``), the slot's shared pages are forked
  to fresh pages (``fork_pages``, a device copy, then table surgery); a
  slot that cannot fork for lack of pages is paused for the chunk.
  Token appends never reach a shared page: only pages wholly inside
  ``stable_prefix_len`` enter the map.  A page returns to the free pool,
  and leaves the map, only at refcount 0.

Sampling: each session draws from its own ``torch.Generator`` seeded from
``Session.seed`` (or the scheduler seed and ``sid``), so a session's
stream depends on the session alone.  Left out of the port so far (ROADMAP
Queue 1 item 8): session tiering (and with it the retiring of refcount-0
prefix pages into a store), policies, telemetry and speculative
decoding.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
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
                 prefix_sharing: bool = False,
                 max_head_skips: Optional[int] = None,
                 prefill_chunk: Optional[int] = None):
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
        # chunked admission: the decode's default (build_decode(
        # prefill_chunk=...)) unless given; None admits in one shot
        if prefill_chunk is None:
            prefill_chunk = getattr(decode, "prefill_chunk", None)
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be positive (or None for "
                             "one-shot admission)")
        self.prefill_chunk = prefill_chunk
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
        if self.prefill_chunk is not None and self._paged and \
                self.prefill_chunk % self.layout.page != 0:
            raise ValueError(
                f"prefill_chunk {self.prefill_chunk} must be a multiple of "
                f"the page size {self.layout.page}: chunk-granular page "
                f"writes cover whole pages")
        # prefix sharing: chunk key -> page, page -> key, sid -> keys
        self.prefix_sharing = bool(prefix_sharing) and self._paged
        self._prefix_map: Dict[bytes, int] = {}
        self._page_key: Dict[int, bytes] = {}
        self._key_cache: Dict[int, List[bytes]] = {}
        # a resyncing model forks every page it adopted before its first
        # resync, so a sharing admission reserves those copies up front
        # (the LM families never fork)
        self._fork_reserve = self.prefix_sharing and bool(
            np.any(decode.sync_anticipated(self.state, 1 << 30)))
        # pages forked, and chunks a slot sat out for lack of fork pages
        self.pages_forked = 0
        self.fork_pauses = 0
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

    def assigned_kv_bytes(self) -> int:
        """KV bytes the live page tables reference; a prefix-shared page
        counts once."""
        return self.state.assigned_kv_bytes()

    def page_refcounts(self) -> np.ndarray:
        """Host-side per-page refcounts (a copy); all zeros when idle."""
        return self._page_ref.copy()

    # ------------------------------------------------------------------
    # prefix sharing: content-addressed page map + refcounts
    # ------------------------------------------------------------------
    def _chunk_keys(self, session: Session) -> List[bytes]:
        """Rolling keys of the page-aligned prompt chunks inside the
        session's stable prefix: key i covers ``prompt[:(i+1)*page]`` (KV
        at a position is a causal function of every token before it),
        salted with the per-request extras."""
        cached = self._key_cache.get(session.sid)
        if cached is not None:
            return cached
        page = self.layout.page
        stable = self.decode.stable_prefix_len(len(session.prompt))
        n = min(stable, len(session.prompt)) // page
        h = hashlib.sha1()
        if session.extras:
            for name in sorted(session.extras):
                h.update(name.encode())
                h.update(np.asarray(session.extras[name]).tobytes())
        prompt = np.ascontiguousarray(session.prompt, np.int32)
        keys = []
        for i in range(n):
            h.update(prompt[i * page:(i + 1) * page].tobytes())
            keys.append(h.copy().digest())
        self._key_cache[session.sid] = keys
        return keys

    def _register(self, key: bytes, page: int) -> None:
        self._prefix_map[key] = page
        self._page_key[page] = key

    def _unregister(self, page: int) -> None:
        key = self._page_key.pop(page, None)
        if key is not None:
            self._prefix_map.pop(key, None)

    def _set_table_row(self, slot: int, pages: List[int]) -> None:
        self._slot_pages[slot] = list(pages)
        row = np.full((self.layout.pages_per_slot,), self.layout.trash,
                      np.int32)
        row[:len(pages)] = pages
        self.state.bookkeeping[LT.PAGE_TABLE][slot] = torch.as_tensor(
            row, device=self.device)

    def _admission_plan(self, session: Session
                        ) -> Optional[Dict[str, Any]]:
        """The pages this admission takes, or None while the free pool is
        short (the session waits for running sessions to retire).  With
        prefix sharing, resident pages matching the prompt's chunk keys
        are adopted instead of drawn from the free pool; a resyncing
        model reserves a free page for each adopted one (its fork)."""
        if not self._paged:
            return {"total": 0, "adopted": [], "keys": []}
        total = self._pages_needed(session)
        keys = self._chunk_keys(session) if self.prefix_sharing else []
        adopted: List[int] = []
        for key in keys:
            page = self._prefix_map.get(key)
            if page is None:
                break
            adopted.append(page)
        reserve = len(adopted) if self._fork_reserve else 0
        if total - len(adopted) + reserve > len(self.free_pages):
            return None
        return {"total": total, "adopted": adopted, "keys": keys}

    def _session_generator(self, session: Session) -> torch.Generator:
        seed = session.seed if session.seed is not None else int(
            np.random.SeedSequence([self.seed, session.sid]).generate_state(
                1)[0])
        return torch.Generator(device=self.device).manual_seed(seed)

    def _admit(self, session: Session, slot: int,
               plan: Dict[str, Any]) -> None:
        mask = None
        if self._paged:
            adopted = plan["adopted"]
            fresh = [self.free_pages.pop()
                     for _ in range(plan["total"] - len(adopted))]
            pages = list(adopted) + fresh
            for p in adopted:
                self._page_ref[p] += 1
            for p in fresh:
                self._page_ref[p] = 1
            self._set_table_row(slot, pages)
            if self.prefix_sharing:
                # this prompt's freshly written stable pages become
                # adoptable (the adopted ones are in the map already)
                for i, key in enumerate(plan["keys"]):
                    if key not in self._prefix_map:
                        self._register(key, pages[i])
                if adopted:
                    # tail-only write: adopted pages hold this prompt's KV
                    # already, and a page at refcount > 1 is never written
                    host_mask = np.ones((self.layout.pages_per_slot,), bool)
                    host_mask[:len(adopted)] = False
                    mask = torch.as_tensor(host_mask, device=self.device)
        resident = len(plan["adopted"]) * self.layout.page \
            if self._paged else 0
        # JAX's rule, not a device fallback: a prompt whose chunk grid
        # would run past max_len is admitted in one shot
        chunked = self.prefill_chunk is not None and \
            self.decode.supports_chunked_prefill() and \
            self.decode.chunked_prefill_fits(len(session.prompt), resident,
                                             self.prefill_chunk,
                                             self.max_len)
        t0 = time.perf_counter()
        if chunked:
            # the adopted pages are attended, not forwarded again (but for
            # the one chunk the logits need), and every chunk has one
            # shape: the signature is the chunk, not the prompt length
            logits, self.state, info = \
                self.decode.prefill_into_slot_chunked(
                    self.params, self.state, slot, session.prompt,
                    page_write_mask=mask, resident_len=resident,
                    chunk=self.prefill_chunk)
            fwd = info["forward_tokens"]
            sig = ("chunked", self.prefill_chunk, resident > 0,
                   mask is not None)
        else:
            logits, self.state = self.decode.prefill_into_slot(
                self.params, self.state, slot, session.prompt,
                page_write_mask=mask)
            fwd = len(session.prompt)
            sig = (len(session.prompt), mask is not None)
        device_sync(self.device)
        self._key_cache.pop(session.sid, None)
        self.admit_stats.append(StepStats(
            "admit", time.perf_counter() - t0, tokens=len(session.prompt),
            compiled=tag_compiled(self._warm, "admit", sig),
            forward_tokens=fwd))
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

    # ------------------------------------------------------------------
    # copy-on-write forking (chunk boundary)
    # ------------------------------------------------------------------
    def _cow_before_chunk(self) -> np.ndarray:
        """A page is writable only at refcount 1.  The only writes that
        can reach resident prefix pages are a resync's history rebuild
        (token appends land past the stable prefix), so every active slot
        whose resync may fire within the coming chunk is made page-
        private now, by the same host mirror and the same ``n_steps``
        the chunk's resync decisions use.  A slot that cannot fork for
        lack of free pages is paused for this chunk (masked out of it,
        frozen bit-identically) and retried once retiring sessions free
        pages.  Returns the (B,) mask of the slots that decode."""
        run_mask = self.active.copy()
        anticipated = self.decode.sync_anticipated(self.state,
                                                   self.chunk_size)
        for slot in np.nonzero(self.active)[0]:
            if anticipated[slot] and not self._make_slot_private(int(slot)):
                run_mask[slot] = False
                self.fork_pauses += 1
        return run_mask

    def _make_slot_private(self, slot: int) -> bool:
        """Fork the slot's shared pages to fresh ones.  True on success;
        False, with nothing changed, when the free pool cannot hold the
        copies."""
        pages = self._slot_pages[slot]
        shared = [j for j, p in enumerate(pages) if self._page_ref[p] > 1]
        if len(shared) > len(self.free_pages):
            return False
        for p in pages:
            if self._page_ref[p] == 1:
                # the sole owner is about to rewrite the page: its content
                # may stop matching its key
                self._unregister(p)
        if not shared:
            return True
        fresh = [self.free_pages.pop() for _ in shared]
        pps = self.layout.pages_per_slot
        src = np.full((pps,), self.layout.trash, np.int32)
        dst = np.full((pps,), self.layout.trash, np.int32)
        for k, (j, p_new) in enumerate(zip(shared, fresh)):
            src[k], dst[k] = pages[j], p_new
        self.layout.fork_pages(self.state.kv,
                               torch.as_tensor(src, device=self.device),
                               torch.as_tensor(dst, device=self.device))
        for j, p_new in zip(shared, fresh):
            self._page_ref[pages[j]] -= 1
            self._page_ref[p_new] = 1
            pages[j] = p_new
        self._set_table_row(slot, pages)
        self.pages_forked += len(shared)
        return True

    def _release(self, slot: int) -> None:
        self.sessions[slot] = None
        self.active[slot] = False
        self.temps[slot] = 0.0
        self.eos[slot] = -1
        self.generators[slot] = None
        if self._paged:
            # retarget the table row at TRASH before the clearing write
            # below, so the clearing zeros land on the trash page and never
            # on a page another slot still maps; then drop the slot's
            # references: a page is freed, and leaves the prefix map, only
            # at refcount 0
            pages = self._slot_pages[slot]
            self._set_table_row(slot, [])
            for p in pages:
                self._page_ref[p] -= 1
                if self._page_ref[p] == 0:
                    self._unregister(p)
                    self.free_pages.append(p)
        # clear the slot so stale phase counters can't fire a resync of an
        # empty row
        self.state = self.state.with_slot(slot, self._empty_row)
        self.last_token[slot] = 0

    def step(self) -> bool:
        """Admit pending sessions, then decode ONE chunk for the active
        slots (under prefix sharing, those not paused for copy-on-write
        fork pages).  Returns False when no progress was made."""
        self.clock += 1
        admitted = self.admit_pending()
        if not self.active.any():
            return admitted
        run_mask = self._cow_before_chunk() if self.prefix_sharing \
            else self.active.copy()
        if not run_mask.any():
            return admitted            # every active slot fork-paused
        self.peak_active = max(self.peak_active, int(run_mask.sum()))
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
                f"scheduler stuck: {len(self.pending)} pending and "
                f"{self.n_active} fork-paused session(s), nothing could "
                f"run (head needs {need} pages; free "
                f"{len(self.free_pages)}/{pool})")
