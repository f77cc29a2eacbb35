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

* **session tiering (spill / resume)** -- with a
  :class:`~repro_torch.serving.tier_store.TierStore` attached, a
  preempted session SPILLS: its whole slot state is snapshotted in the
  physical representation (``DecodeState.snapshot_slot``: int8 stays
  compressed, paged holds only the live pages), copied to the host
  (a bfloat16 tensor as its int16 bits), pinned in the store under a
  digest of the session, and its slot and pages are freed.  A later
  admission RESUMES it into any free slot with one restore (fresh
  private pages; the host mirror of ``gen_len`` restored with the rows),
  token-identical to never having left.  With ``preempt_chunks=k``,
  slots that have decoded >= k chunks this residency are spilled, ripe
  longest-resident first, whenever sessions wait.  The store also holds
  refcount-0 prefix pages, which RETIRE into it under their chunk keys
  and are re-adopted (one page upload before the prefill) instead of
  forwarded again, and, for a family whose admission is a pure function
  of the prompt (TConst: ``admission_key``), the post-admission slot
  state with its logits, so a known prompt re-admits as an O(1) restore
  with zero forward compute.  A pinned snapshot missing at resume, or a
  failed copy, raises: nothing is silently prefilled again.

Admissions are recorded as ``StepStats(kind="admit")`` in ``admit_stats``
with ``source`` naming where the slot state came from ("cold" / "resume"
/ "store"); spills as ``StepStats(kind="spill")`` in ``stats``.

Two later additions layer policy on top of this mechanism:

* **pluggable scheduling policy** -- the WHICH decisions (admission try
  order, pool-pressure deferral, preemption victims) live in a
  :class:`~repro_torch.serving.policy.SchedulingPolicy`; the scheduler
  keeps the invariants (arrival-order queue, bounded overtake budget
  counted per admission past the oldest waiter -- resume-sourced or cold
  -- page refcounts, spill correctness), so no policy can starve or
  corrupt a session.  A policy reads host-side state only (``spill_cost``
  is arithmetic on tensor metadata), never a device tensor.  ``clock``
  counts completed ``step()`` calls: the deterministic time base for SLO
  deadlines and telemetry
  (:class:`~repro_torch.serving.metrics.ServingTelemetry` attaches via
  the ``telemetry`` argument and observes submit / admit / spill / token
  / retire, and the pool once a tick).
* **per-session sampling** -- each session draws from its own
  ``torch.Generator`` seeded from ``Session.seed`` (or the scheduler seed
  and ``sid``), once per sampled token; a spill freezes the generator's
  state in ``Session.sample_chain`` and the resume carries it on.  So a
  session's stream is a function of the session alone: replaying a
  workload trace is token-identical across runs, slot placements and
  scheduling policies.

Left out of the port so far (ROADMAP Queue 1 item 8): speculative
decoding.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import time
from typing import Any, Deque, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.models import layouts as LT
from repro_torch.models.api import (DecodeAPI, ModelAPI, decode_chunk,
                                    sample_tokens)
from repro_torch.serving.engine import StepStats, device_sync, tag_compiled
from repro_torch.serving.metrics import ServingTelemetry
from repro_torch.serving.policy import FifoPolicy, SchedulingPolicy, get_policy
from repro_torch.serving.session import Session
from repro_torch.serving.tier_store import (Blob, TierStore,
                                            flatten_slot_snapshot,
                                            unflatten_slot_snapshot)


def to_host(t: torch.Tensor) -> np.ndarray:
    """A host COPY of ``t`` on every device (on the CPU ``.numpy()``
    would alias the state, which a release then clears in place); a
    bfloat16 tensor as its int16 bit pattern (numpy has no bfloat16)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return np.ascontiguousarray(t.to("cpu", copy=True).numpy())


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A store array on ``device``: copied first (a disk-tier array is a
    read-only memmap), moved once.  The restore takes it by its bits."""
    return torch.from_numpy(np.array(a)).to(device)


def layout_key(layout: Any) -> str:
    """A stable string of a bound layout's defining fields (no tensor and
    no device in it): part of the store's key salt."""
    fields = ",".join(f"{f.name}={getattr(layout, f.name)!r}"
                      for f in dataclasses.fields(layout))
    return f"{type(layout).__name__}({fields})"


class SlotScheduler:
    def __init__(self, decode: DecodeAPI, params: Any, slots: int,
                 max_len: int, chunk_size: int = 8, seed: int = 0,
                 prefix_sharing: bool = False,
                 max_head_skips: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 tier_store: Optional[TierStore] = None,
                 preempt_chunks: Optional[int] = None,
                 policy: Union[SchedulingPolicy, str, None] = None,
                 telemetry: Optional[ServingTelemetry] = None):
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

        # session tiering: the host-side store and preemption
        if preempt_chunks is not None and preempt_chunks < 1:
            raise ValueError("preempt_chunks must be positive (or None to "
                             "disable preemptive spilling)")
        if preempt_chunks is not None and tier_store is None:
            raise ValueError("preempt_chunks needs a tier_store to spill "
                             "preempted sessions into")
        self.store = tier_store
        self.preempt_chunks = preempt_chunks
        self.spill_stats = {"spills": 0, "resumes": 0, "spilled_bytes": 0,
                            "pages_retired": 0, "pages_readopted": 0,
                            "admit_store_hits": 0, "admit_store_puts": 0}
        # chunks each slot has decoded since its residency began (admit
        # and resume reset it): the preemption ripeness clock
        self._slot_chunks = np.zeros((slots,), np.int64)
        self._page_axes = {f: self.layout.page_axis(f)
                           for f in self.state.kv
                           if self.layout.page_axis(f) is not None} \
            if self._paged else {}

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

        # policy seam + telemetry + deterministic clock (chunk units)
        if policy is None:
            policy = FifoPolicy()
        elif isinstance(policy, str):
            policy = get_policy(policy)
        self.policy = policy
        self.telemetry = telemetry
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
        if self.telemetry is not None:
            self.telemetry.on_submit(session, self.clock)
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

    def spill_cost(self, slot: int) -> Dict[str, int]:
        """Estimated cost of evicting the session in ``slot``, for
        cost-aware victim selection: ``bytes`` is the snapshot the spill
        would move to the host tier (paged: live pages only; dense: the
        slot's share of the state), ``readmit`` the bytes a later fresh
        admission of the same request would cost -- zero for a family
        whose admission is a pure function of the prompt
        (``DecodeAPI.admission_key`` not None: re-admission is an O(1)
        store restore), else the snapshot again.  Host arithmetic on
        tensor metadata only (``Tensor.nbytes``): no device work."""
        session = self.sessions[slot]
        assert session is not None, "spill_cost needs an occupied slot"
        snap_bytes = 0
        if self._paged:
            live = self._live_pages(session)
            for f, v in self.state.kv.items():
                ax = self._page_axes.get(f)
                if ax is not None:
                    snap_bytes += (v.nbytes // v.shape[ax]) * live
                else:
                    snap_bytes += v.nbytes // self.slots
        else:
            snap_bytes = self.kv_bytes() // self.slots
        pure = self.decode.admission_key(session.prompt,
                                         session.extras) is not None
        readmit = 0 if pure else snap_bytes
        return {"bytes": int(snap_bytes), "readmit": int(readmit),
                "total": int(snap_bytes + readmit)}

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

    # ------------------------------------------------------------------
    # session tiering: spill / resume / retire through the TierStore
    # ------------------------------------------------------------------
    def _store_salt(self) -> bytes:
        """Scheduler-level key salt: snapshot shapes and admission
        numerics depend on max_len, the bound layout and the prefill
        path, so schedulers differing in any of them never share store
        entries.  (The params are not hashed: a TierStore must not be
        shared across schedulers serving different weights.)"""
        return f"{self.max_len}|{layout_key(self.layout)}|" \
            f"{self.prefill_chunk}".encode()

    def _session_key(self, session: Session) -> bytes:
        """Content digest of a session's CURRENT state: extras + prompt +
        every token generated so far.  Two sessions at the same point of
        the same request share one snapshot entry (pins nest)."""
        h = hashlib.sha1(b"session\x00" + self._store_salt())
        if session.extras:
            for name in sorted(session.extras):
                h.update(name.encode())
                h.update(np.asarray(session.extras[name]).tobytes())
        h.update(np.ascontiguousarray(session.prompt, np.int32).tobytes())
        h.update(np.asarray(session.tokens, np.int32).tobytes())
        return h.digest()

    def _admission_key(self, session: Session) -> Optional[bytes]:
        """Store key of this request's post-admission slot state, or None
        when the family's admission is not a pure function of the prompt
        ids (``DecodeAPI.admission_key``) or there is no store."""
        if self.store is None:
            return None
        base = self.decode.admission_key(session.prompt, session.extras)
        if base is None:
            return None
        h = hashlib.sha1(b"admit\x00" + self._store_salt())
        h.update(base)
        return h.digest()

    def _live_pages(self, session: Session) -> int:
        """Pages that can hold WRITTEN content for this session now
        (prompt + generated ids, one position of slack): the host-tier
        size of a paged spill; the slot's pages beyond them hold nothing
        a restore needs."""
        need = len(session.prompt) + len(session.tokens) + 1
        return -(-need // self.layout.page)

    def _snapshot_slot_host(self, slot: int, n_keep: Optional[int] = None
                            ) -> Dict[str, Dict[str, np.ndarray]]:
        """Snapshot of ``slot`` copied to the host (:func:`to_host`), paged
        page stacks trimmed to the first ``n_keep`` table entries (the
        live prefix of the slot's allocation)."""
        snap = self.state.snapshot_slot(slot)
        if self._paged and n_keep is not None:
            n_keep = min(n_keep, len(self._slot_pages[slot]))
            for f, ax in self._page_axes.items():
                snap["kv"][f] = snap["kv"][f].narrow(ax, 0, n_keep)
        return {part: {n: to_host(t) for n, t in rows.items()}
                for part, rows in snap.items()}

    def _pad_kv_snapshot(self, kv: Dict[str, Any]
                         ) -> Dict[str, torch.Tensor]:
        """Store kv rows on the device, trimmed page stacks padded back to
        pages_per_slot with zeros (they land on the slot's unwritten
        pages, masked until written), so a restore fills the whole row
        as JAX's does."""
        out = {}
        pps = self.layout.pages_per_slot if self._paged else 0
        for f, v in kv.items():
            t = to_device(v, self.device)
            ax = self._page_axes.get(f)
            if ax is not None and t.shape[ax] < pps:
                shape = list(t.shape)
                shape[ax] = pps - t.shape[ax]
                t = torch.cat([t, t.new_zeros(shape)], dim=ax)
            out[f] = t
        return out

    def _restore(self, slot: int, blob: Blob) -> Dict[str, Any]:
        """Restore a slot snapshot blob into ``slot`` (its table row
        already points at fresh private pages).  Returns the meta."""
        bk_rows, kv_rows, meta = unflatten_slot_snapshot(blob)
        self.state.restore_slot(slot, {
            "bookkeeping": {n: to_device(v, self.device)
                            for n, v in bk_rows.items()},
            "kv": self._pad_kv_snapshot(kv_rows)})
        return meta

    def spill(self, slot: int) -> bytes:
        """Spill the active session in ``slot`` to the tier store: copy its
        whole slot state to the host (physical representation: int8
        compressed, paged only its live pages), PIN it under the
        session's content digest, freeze its sampling generator, free the
        slot and its pages, and re-queue the session.  A later admission
        restores it into ANY free slot, token-identical to never having
        left.  Returns the store key."""
        assert self.store is not None, "spilling needs a tier_store"
        session = self.sessions[slot]
        assert session is not None and not session.done, \
            "can only spill a live session"
        t0 = time.perf_counter()
        snap = self._snapshot_slot_host(
            slot, self._live_pages(session) if self._paged else None)
        blob = flatten_slot_snapshot(snap, {
            "kind": "session", "sid": session.sid,
            "last_token": int(self.last_token[slot])})
        key = self._session_key(session)
        self.store.put(key, blob, pin=True)
        self.stats.append(StepStats(
            "spill", time.perf_counter() - t0,
            tokens=len(session.prompt) + len(session.tokens),
            compiled=tag_compiled(self._warm, "spill")))
        session.snap_key = key
        session.spills += 1
        session.slot = None
        # the generator's state at the spill is the session's position in
        # its sampling stream (one draw per sampled token)
        session.sample_chain = self.generators[slot].get_state().numpy()
        self.spill_stats["spills"] += 1
        self.spill_stats["spilled_bytes"] += blob.nbytes
        self._release(slot)
        self.pending.append(session)
        if self.telemetry is not None:
            self.telemetry.on_spill(session, self.clock)
        return key

    def _resume(self, session: Session, slot: int,
                plan: Dict[str, Any]) -> None:
        """Admission of a spilled session: fresh private pages, ONE restore
        of its pinned snapshot into ``slot``, unpin.  No prefill and no
        sampling: the last sampled token rides in the snapshot's meta and
        decode picks up where it left off."""
        blob = self.store.get(session.snap_key)
        if blob is None:
            raise RuntimeError(
                f"session {session.sid}: its pinned snapshot is missing "
                f"from the tier store")
        if self._paged:
            fresh = [self.free_pages.pop() for _ in range(plan["total"])]
            for p in fresh:
                self._page_ref[p] = 1
            self._set_table_row(slot, fresh)
        t0 = time.perf_counter()
        meta = self._restore(slot, blob)
        device_sync(self.device)
        self.admit_stats.append(StepStats(
            "admit", time.perf_counter() - t0,
            tokens=len(session.prompt) + len(session.tokens),
            compiled=tag_compiled(self._warm, "admit", ("resume",)),
            forward_tokens=0, source="resume"))
        self.store.unpin(session.snap_key)
        session.snap_key = None
        session.resumes += 1
        self.spill_stats["resumes"] += 1
        self.last_token[slot] = int(meta["last_token"])
        # the sampling stream goes on where the spill froze it
        gen = torch.Generator(device=self.device)
        gen.set_state(torch.from_numpy(np.array(session.sample_chain)))
        self.generators[slot] = gen
        session.sample_chain = None
        session.slot = slot
        self.sessions[slot] = session
        self.active[slot] = True
        self.temps[slot] = session.temperature
        self.eos[slot] = -1 if session.eos_id is None else session.eos_id
        self._slot_chunks[slot] = 0
        self.resyncs.setdefault(session.sid, 0)
        if self.telemetry is not None:
            self.telemetry.on_admit(session, self.clock, "resume")

    def _retire_pages(self, retiring: List) -> None:
        """Refcount-0 prefix pages RETIRE into the tier store instead of
        vanishing with their map entry: their content stays re-adoptable
        (LRU-evictable, unpinned) under the same chunk key, so residency
        in the memory hierarchy, not refcount, decides whether a later
        admission forwards the prefix again.  ``retiring`` is [(page,
        key), ...] of pages ABOUT to be recycled; the gather runs before
        anything can reuse them."""
        idx = torch.as_tensor([p for p, _ in retiring], device=self.device)
        gathered = {f: to_host(v) for f, v in
                    self.layout.gather_pages(self.state.kv, idx).items()}
        for i, (_, key) in enumerate(retiring):
            arrays = {f: np.take(v, np.arange(i, i + 1),
                                 axis=self._page_axes[f])
                      for f, v in gathered.items()}
            self.store.put(key, Blob(arrays, {"kind": "page"}))
        self.spill_stats["pages_retired"] += len(retiring)

    def _fetch_restorable(self, keys: List[bytes]) -> List[Blob]:
        """The planned re-adoptable page blobs; a key that aged out
        between plan and admit truncates the run (the rest is prefilled:
        the page count is the same either way)."""
        blobs: List[Blob] = []
        for k in keys:
            b = self.store.get(k)
            if b is None:
                break
            blobs.append(b)
        return blobs

    def _upload_pages(self, page_ids: List[int],
                      blobs: List[Blob]) -> None:
        """Write retired-page content from the store onto freshly
        allocated pool pages (``scatter_pages``, by their bits): the
        re-adoption that replaces forwarding the prefix again."""
        idx = torch.as_tensor(page_ids, device=self.device)
        contents = {}
        for f, ax in self._page_axes.items():
            stack = np.concatenate([np.asarray(b.arrays[f]) for b in blobs],
                                   axis=ax)
            contents[f] = LT.bits_as(to_device(stack, self.device),
                                     self.state.kv[f].dtype)
        self.layout.scatter_pages(self.state.kv, idx, contents)
        self.spill_stats["pages_readopted"] += len(blobs)

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def _admission_plan(self, session: Session
                        ) -> Optional[Dict[str, Any]]:
        """The pages this admission takes, or None while the free pool is
        short (the session waits for running sessions to retire).  With
        prefix sharing, resident pages matching the prompt's chunk keys
        are adopted instead of drawn from the free pool; a resyncing
        model reserves a free page for each adopted one (its fork).  With
        a tier store, the chunk keys past the resident run whose pages
        retired into it are planned for re-adoption (a fresh page and an
        upload each), and a spilled session or a store-hit prompt plans
        an all-fresh restore."""
        resume = session.snap_key is not None
        admit_key = None if resume else self._admission_key(session)
        # a restore writes the WHOLE slot, so it owns every page privately
        # (no adoption); the probe does not touch the store's LRU order
        admit_hit = admit_key is not None and admit_key in self.store
        if not self._paged:
            return {"total": 0, "adopted": [], "keys": [], "restorable": [],
                    "resume": resume, "admit_key": admit_key,
                    "admit_hit": admit_hit}
        total = self._pages_needed(session)
        keys = [] if (resume or admit_hit or not self.prefix_sharing) \
            else self._chunk_keys(session)
        adopted: List[int] = []
        for key in keys:
            page = self._prefix_map.get(key)
            if page is None:
                break
            adopted.append(page)
        restorable: List[bytes] = []
        if self.store is not None:
            for key in keys[len(adopted):]:
                if key not in self.store:
                    break
                restorable.append(key)
        reserve = len(adopted) if self._fork_reserve else 0
        if total - len(adopted) + reserve > len(self.free_pages):
            return None
        return {"total": total, "adopted": adopted, "keys": keys,
                "restorable": restorable, "resume": resume,
                "admit_key": admit_key, "admit_hit": admit_hit}

    def _session_generator(self, session: Session) -> torch.Generator:
        seed = session.seed if session.seed is not None else int(
            np.random.SeedSequence([self.seed, session.sid]).generate_state(
                1)[0])
        return torch.Generator(device=self.device).manual_seed(seed)

    def _admit(self, session: Session, slot: int,
               plan: Dict[str, Any]) -> None:
        if plan.get("resume"):
            self._resume(session, slot, plan)
            return
        admit_blob = None
        if plan.get("admit_hit"):
            # fetched FIRST (nothing else touches the store before it):
            # None means the entry aged out since the plan, and the plan's
            # all-fresh pages keep the cold path below valid
            admit_blob = self.store.get(plan["admit_key"])
        mask = None
        n_resident = 0
        if self._paged:
            adopted = plan["adopted"]
            readopt = self._fetch_restorable(plan["restorable"]) \
                if admit_blob is None else []
            fresh = [self.free_pages.pop()
                     for _ in range(plan["total"] - len(adopted))]
            pages = list(adopted) + fresh
            for p in adopted:
                self._page_ref[p] += 1
            for p in fresh:
                self._page_ref[p] = 1
            self._set_table_row(slot, pages)
            if readopt:
                # retired prefix pages come back from the store onto this
                # slot's fresh pages BEFORE the prefill, which then attends
                # them instead of forwarding them again
                self._upload_pages(
                    pages[len(adopted):len(adopted) + len(readopt)], readopt)
            n_resident = len(adopted) + len(readopt)
            if self.prefix_sharing:
                # this prompt's freshly written stable pages become
                # adoptable (adopted ones are in the map already, and
                # re-adopted ones enter it resident again)
                for i, key in enumerate(plan["keys"]):
                    if key not in self._prefix_map:
                        self._register(key, pages[i])
                if n_resident:
                    # tail-only write: resident pages hold this prompt's
                    # KV already, and a page at refcount > 1 is never
                    # written
                    host_mask = np.ones((self.layout.pages_per_slot,), bool)
                    host_mask[:n_resident] = False
                    mask = torch.as_tensor(host_mask, device=self.device)
        resident = n_resident * self.layout.page if self._paged else 0
        # JAX's rule, not a device fallback: a prompt whose chunk grid
        # would run past max_len is admitted in one shot
        chunked = self.prefill_chunk is not None and \
            self.decode.supports_chunked_prefill(session.extras) and \
            self.decode.chunked_prefill_fits(len(session.prompt), resident,
                                             self.prefill_chunk,
                                             self.max_len)
        t0 = time.perf_counter()
        if admit_blob is not None:
            # admission-cache hit: the post-admission slot state and its
            # logits restore in one write; the O(N) resync never runs
            meta = self._restore(slot, admit_blob)
            logits = LT.bits_as(
                to_device(admit_blob.arrays["logits"], self.device),
                getattr(torch, meta["logits_dtype"]))
            fwd = 0
            sig = ("restore",)
            source = "store"
            self.spill_stats["admit_store_hits"] += 1
        elif chunked:
            # the resident pages are attended, not forwarded again (but for
            # the one chunk the logits need), and every chunk has one
            # shape: the signature is the chunk, not the prompt length
            logits, self.state, info = \
                self.decode.prefill_into_slot_chunked(
                    self.params, self.state, slot, session.prompt,
                    extras=session.extras, page_write_mask=mask,
                    resident_len=resident, chunk=self.prefill_chunk)
            fwd = info["forward_tokens"]
            sig = ("chunked", self.prefill_chunk, resident > 0,
                   mask is not None)
            source = "cold"
        else:
            logits, self.state = self.decode.prefill_into_slot(
                self.params, self.state, slot, session.prompt,
                extras=session.extras, page_write_mask=mask)
            fwd = len(session.prompt)
            sig = (len(session.prompt), mask is not None)
            source = "cold"
        device_sync(self.device)
        self._key_cache.pop(session.sid, None)
        self.admit_stats.append(StepStats(
            "admit", time.perf_counter() - t0, tokens=len(session.prompt),
            compiled=tag_compiled(self._warm, "admit", sig),
            forward_tokens=fwd, source=source))
        if admit_blob is None and plan.get("admit_key") is not None:
            # a cacheable cold admission: the slot state just admitted is a
            # pure function of the prompt; its snapshot (before sampling)
            # and logits make the NEXT admission of this prompt an O(1)
            # restore.  Unpinned: LRU decides how long it lives.
            snap = self._snapshot_slot_host(
                slot, self._live_pages(session) if self._paged else None)
            blob = flatten_slot_snapshot(snap, {
                "kind": "admit",
                "logits_dtype": str(logits.dtype).rsplit(".", 1)[-1]})
            blob.arrays["logits"] = to_host(logits)
            self.store.put(plan["admit_key"], blob)
            self.spill_stats["admit_store_puts"] += 1
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
        self._slot_chunks[slot] = 0
        self.resyncs.setdefault(session.sid, 0)
        if self.telemetry is not None:
            self.telemetry.on_admit(session, self.clock, source)
        session.deliver([int(t0k)])          # first token: prefill logits
        if self.telemetry is not None:
            # read after ``int(t0k)``: the token is on the host
            self.telemetry.on_tokens(session, len(session.tokens),
                                     self.clock,
                                     self.admit_stats[-1].compiled)

    def admit_pending(self) -> bool:
        """Admit as many pending sessions as free slots and pages allow.

        The policy proposes the try order (``order_pending``; arrival
        order for the FIFO baseline) and may defer an admissible session
        other than the arrival-order head (``defer_admission``); the
        scheduler enforces fairness around it: every admission of a
        session other than the head -- skip-ahead past a page-blocked
        head, policy reordering, or the resume of a spilled session --
        counts one overtake against ``max_head_skips``, and a spent
        budget offers the head alone (the policy is not asked) until it
        admits: no starvation.  The overtake count is per admitted
        identity, not queue position.  Returns True if any session was
        admitted."""
        admitted = False
        free = [i for i in range(self.slots) if not self.active[i]]
        while free and self.pending:
            head = self.pending[0]
            if self._head_skips >= self.max_head_skips:
                candidates: List[Session] = [head]       # budget spent
            else:
                candidates = self.policy.order_pending(
                    list(self.pending), self)
            chosen = plan = None
            for cand in candidates:
                p = self._admission_plan(cand)
                if p is None:
                    continue           # blocked on pool pages: try the next
                if cand is not head and \
                        self.policy.defer_admission(self, cand, p):
                    continue           # the policy holds it (never the head)
                chosen, plan = cand, p
                break
            if chosen is None:
                # a free slot waited: under FIFO every candidate was
                # blocked on pool pages; a round the policy ends by
                # deferring the admissible ones counts too (it holds the
                # pages for a tighter session that is page-blocked)
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
                if self.telemetry is not None:
                    self.telemetry.on_retire(chosen, self.clock)
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
            retiring = []
            for p in pages:
                self._page_ref[p] -= 1
                if self._page_ref[p] == 0:
                    # with a store, a prefix page at refcount 0 retires
                    # into it (gathered below, before anything reuses it)
                    key = self._page_key.get(p)
                    if self.store is not None and key is not None:
                        retiring.append((p, key))
                    self._unregister(p)
                    self.free_pages.append(p)
            if retiring:
                self._retire_pages(retiring)
        # clear the slot so stale phase counters can't fire a resync of an
        # empty row
        self.state = self.state.with_slot(slot, self._empty_row)
        self.last_token[slot] = 0

    def _preempt_for_pending(self) -> int:
        """Preemption: while sessions wait after admission (for slots or
        pool pages), active sessions that have decoded at least
        ``preempt_chunks`` chunks this residency are spill candidates, and
        the policy picks one victim per waiter (FIFO: the longest
        resident first; the SLO policy: the cheapest by ``spill_cost``).
        A fresh residency decodes >= preempt_chunks before it can be
        preempted again, so every rotation makes progress and an
        oversubscribed queue drains whatever the victim order.  Returns
        the number of spills."""
        ripe = [s for s in range(self.slots)
                if self.active[s] and
                self._slot_chunks[s] >= self.preempt_chunks]
        n = min(len(ripe), len(self.pending))
        if not n:
            return 0
        victims = self.policy.select_victims(self, ripe, n)[:n]
        for s in victims:
            self.spill(int(s))
        return len(victims)

    def _tick_telemetry(self) -> None:
        if self.telemetry is None:
            return
        self.telemetry.on_tick(
            self.clock, self.n_active, len(self.pending),
            len(self.free_pages) if self._paged else None,
            self.layout.pool_pages if self._paged else None)

    def step(self) -> bool:
        """Admit pending sessions, then decode ONE chunk for the active
        slots (under prefix sharing, those not paused for copy-on-write
        fork pages).  With a tier store and ``preempt_chunks``, ripe slots
        are spilled for waiting sessions first.  Each call advances
        ``clock`` by one: the time base of SLO deadlines and telemetry.
        Returns False when no progress was made."""
        self.clock += 1
        admitted = self.admit_pending()
        if self.store is not None and self.preempt_chunks is not None \
                and self.pending:
            if self._preempt_for_pending():
                admitted = self.admit_pending() or admitted
        if not self.active.any():
            self._tick_telemetry()
            return admitted
        run_mask = self._cow_before_chunk() if self.prefix_sharing \
            else self.active.copy()
        if not run_mask.any():
            self._tick_telemetry()
            return admitted            # every active slot fork-paused
        self.peak_active = max(self.peak_active, int(run_mask.sum()))
        t0 = time.perf_counter()
        toks, self.state, resyncs = decode_chunk(
            self.decode, self.params, self.state, self.last_token,
            self.generators, self.temps, run_mask,
            n_steps=self.chunk_size, eos=self.eos)
        self.last_token = toks[:, -1].clone()
        host_toks = toks.cpu().numpy()       # the one host sync per chunk
        compiled = tag_compiled(self._warm, "chunk")
        self.stats.append(StepStats(
            "chunk", time.perf_counter() - t0, tokens=self.chunk_size,
            compiled=compiled))
        for slot in np.nonzero(run_mask)[0]:
            self._slot_chunks[slot] += 1
            sess = self.sessions[slot]
            self.resyncs[sess.sid] += int(resyncs[slot])
            before = len(sess.tokens)
            sess.deliver(host_toks[slot])
            if self.telemetry is not None:
                self.telemetry.on_tokens(sess, len(sess.tokens) - before,
                                         self.clock, compiled)
            if sess.done:
                self._release(int(slot))
                if self.telemetry is not None:
                    self.telemetry.on_retire(sess, self.clock)
        self._tick_telemetry()
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
