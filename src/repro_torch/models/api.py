"""Model facade and the decode-side serving protocol.

Port of ``src/repro/models/api.py`` for the TConst family (tconst and
tlin modes), the decoder-only LM's families (SSM, dense attention LMs --
among them the paper's base transformer, ``tconst-41m`` with
``attention_mode="full"`` -- MoE, the hybrid and the VLM), and the
encoder-decoder (:class:`EncDecDecode`, whisper-small): the typed
:class:`DecodeState` (explicit kv / bookkeeping partition, a pluggable
physical layout from :mod:`repro_torch.models.layouts`, slot surgery
through the layout), per-slot sampling, the :class:`DecodeAPI` protocol,
:func:`decode_chunk`, :class:`TConstDecode`, :class:`DenseDecode` (a
growing KV cache or an O(1) recurrent state, no periodic resync), the
chunked, KV-conditioned admission (:class:`ChunkedAdmission`; the TConst
family's bucketed form), ``build_decode`` and ``build_model``; and the training side of the
facade: ``cross_entropy``, ``ModelAPI.forward`` and ``ModelAPI.loss``.
The hit step reads the cache through KVViews
(``DecodeState.decode_views``); ``merged`` (the dense logical dict) is
the oracle and the admission path's currency.

Where the JAX package scans a decode chunk on device and decides each
resync there, the port runs eagerly: the resync is decided from a
host-side mirror of ``gen_len`` (``DecodeState.host``), which advances by
one per step of every active slot, so no device value is read per token.
The cache tensors are updated in place; rows that are not live keep
every entry bit-identical because their writes are masked.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from repro_torch import runtime
from repro_torch.config import ModelConfig
from repro_torch.core import tconst as TC
from repro_torch.layers.common import (put_rows, take_rows, to_device,
                                       where_rows)
from repro_torch.models import encdec as ED
from repro_torch.models import layouts as LT
from repro_torch.models import lm as LM


def _is_tconst(cfg: ModelConfig) -> bool:
    return cfg.attention_mode in ("tconst", "tlin") and \
        cfg.arch_type not in ("ssm", "audio")


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
    """Mean next-token CE.  logits (B, L, V) f32; targets (B, L) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None].long())[..., 0]
    return (logz - gold).mean()


# ---------------------------------------------------------------------------
# DecodeState
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DecodeState:
    """Decode cache with an explicit kv / bookkeeping partition and a
    pluggable physical layout.

    ``kv`` holds the true KV buffers in the PHYSICAL representation of
    ``layout`` (dense tensors, paged pools, int8 + scales), so
    ``kv_bytes`` reflects the layout; ``bookkeeping`` the token-id
    buffer, lengths, phase counters, the EOS ``done`` mask and the
    layout's own fields (``layout__*``, e.g. the page table).  ``axes``
    maps every dense field to its batch ("slot") axis.  ``host`` holds
    host-side mirrors of the counters the decode loop branches on (here
    ``gen_len``), kept in step with the device without reading it.
    """

    kv: Dict[str, torch.Tensor]
    bookkeeping: Dict[str, torch.Tensor]
    axes: Dict[str, int]
    host: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    layout: Any = dataclasses.field(default_factory=LT.DenseLayout)

    @classmethod
    def from_dense(cls, cache: Dict[str, torch.Tensor],
                   kv_keys: Sequence[str], axes: Dict[str, int],
                   layout: Any = None) -> "DecodeState":
        """Wrap a dense logical cache dict, packing kv into ``layout``'s
        physical representation (with the layout's own bookkeeping, e.g.
        a fresh page table)."""
        layout = LT.DenseLayout() if layout is None else layout
        kv = {k: v for k, v in cache.items() if k in kv_keys}
        bk = {k: v for k, v in cache.items() if k not in kv_keys}
        name = next(iter(sorted(bk)))
        bk.update(layout.init_bookkeeping(bk[name].shape[axes[name]],
                                          device=bk[name].device))
        all_axes = {**{k: axes[k] for k in cache},
                    **layout.bookkeeping_axes()}
        return cls(layout.pack(kv, bk, all_axes), bk, all_axes,
                   layout=layout)

    def kv_views(self) -> Dict[str, Any]:
        """Per-field FieldViews over the PHYSICAL kv buffers (aliasing:
        no copy, no densification)."""
        return self.layout.view(self.kv, self.bookkeeping, self.axes)

    def decode_views(self) -> Dict[str, Any]:
        """What the layout-native step takes: non-layout bookkeeping as
        tensors + kv fields as FieldViews."""
        bk = {k: v for k, v in self.bookkeeping.items()
              if not k.startswith(LT.LAYOUT_BK_PREFIX)}
        return {**bk, **self.kv_views()}

    def absorb(self, views: Dict[str, Any]) -> "DecodeState":
        """Take back an updated ``decode_views`` dict.  The views alias
        the physical buffers and the step writes them in place, so this
        only re-reads which tensors the fields hold."""
        self.kv = LT.absorb_views({k: v for k, v in views.items()
                                   if isinstance(v, LT.FieldView)})
        self.bookkeeping.update({k: v for k, v in views.items()
                                 if not isinstance(v, LT.FieldView)})
        return self

    def merged(self) -> Dict[str, torch.Tensor]:
        """The dense LOGICAL cache dict (layout bookkeeping filtered out,
        kv unpacked).  On the dense layout its tensors alias the state's;
        on the others they are copies.  The oracle of the tests."""
        bk = {k: v for k, v in self.bookkeeping.items()
              if not k.startswith(LT.LAYOUT_BK_PREFIX)}
        return {**bk, **self.layout.unpack(self.kv, self.bookkeeping,
                                           self.axes)}

    def kv_bytes(self) -> int:
        """KV bytes of the PHYSICAL representation (paged pools and int8
        + scales report their true size)."""
        return sum(t.numel() * t.element_size() for t in self.kv.values())

    def assigned_kv_bytes(self) -> int:
        """KV bytes the live page tables reference (paged fields: the
        assigned pages; the others: their physical buffers).  Host-side:
        reads the page table."""
        return LT.assigned_kv_bytes(self.kv_views())

    def with_slot(self, slot: int, row: "DecodeState",
                  page_write_mask: Optional[torch.Tensor] = None,
                  exclude: Tuple[str, ...] = ()) -> "DecodeState":
        """Write a single-row state (batch size 1) into slot ``slot``, IN
        PLACE; returns self.  Bookkeeping is a per-field row write; kv
        goes through the layout (paged: only the slot's own pages).
        ``page_write_mask`` (pages_per_slot,) bool restricts the paged
        write to the unshared tail of the slot's table row: a page whose
        content is already resident (prefix sharing, refcount > 1) is
        mapped, never rewritten.  ``exclude`` skips kv fields by base
        name: the chunked admission has streamed its length-axis KV in
        through :meth:`write_span` and finalises with the rest."""
        for name, val in row.bookkeeping.items():
            if name.startswith(LT.LAYOUT_BK_PREFIX):
                continue
            ax = self.axes[name]
            self.bookkeeping[name].select(ax, slot).copy_(val.select(ax, 0))
        dense_row = row.layout.unpack(row.kv, row.bookkeeping, row.axes)
        self.layout.write_slot(self.kv, self.bookkeeping, slot, dense_row,
                               self.axes, page_mask=page_write_mask,
                               exclude=exclude)
        for name, val in row.host.items():
            self.host[name][slot] = val[0]
        return self

    def read_slot(self, slot: int) -> Dict[str, torch.Tensor]:
        """Dense logical kv row (batch size 1) of slot ``slot``, read
        through the layout (paged: through the slot's own table row,
        adopted prefix-shared pages included; int8: dequantized).  The
        chunked admission seeds its row cache from it, so tail chunks
        attend the resident KV.  Admission path only."""
        return self.layout.read_slot(self.kv, self.bookkeeping, self.axes,
                                     slot)

    def write_span(self, slot: int, fields: Dict[str, torch.Tensor],
                   length_axes: Dict[str, int], start: int,
                   min_page: Optional[int] = None) -> "DecodeState":
        """Chunk-granular slot write, IN PLACE: positions ``[start, start
        + C)`` of the length-axis ``fields`` (dense logical, batch 1) go
        into the slot through the layout (paged: exactly the covered
        pages of its table row, those below ``min_page`` -- adopted
        shared pages -- sent to TRASH; int8: quantized on write)."""
        self.layout.write_span(self.kv, self.bookkeeping, slot, fields,
                               length_axes, self.axes, start,
                               min_page=min_page)
        return self

    def snapshot_slot(self, slot: int) -> Dict[str, Dict[str, Any]]:
        """Everything slot ``slot`` owns, in the PHYSICAL representation,
        as new tensors: ``{"bookkeeping": <non-layout rows, batch dim 1>,
        "kv": <layout snapshot>}``.  Dense and int8 kv snapshots are
        batch-axis rows (int8 stays ``__q`` / ``__scale``: compressed on
        the host); paged kv snapshots gather exactly the slot's table
        row out of the pools.  Layout-owned bookkeeping (the page table)
        is not captured: a restore binds the snapshot to the destination
        slot's own pages."""
        bk = {name: leaf.narrow(self.axes[name], slot, 1).clone()
              for name, leaf in self.bookkeeping.items()
              if not name.startswith(LT.LAYOUT_BK_PREFIX)}
        return {"bookkeeping": bk,
                "kv": self.layout.snapshot_slot(self.kv, self.bookkeeping,
                                                self.axes, slot)}

    def restore_slot(self, slot: int, snap: Dict[str, Dict[str, Any]]
                     ) -> "DecodeState":
        """Inverse of :meth:`snapshot_slot`, IN PLACE; returns self.  The
        snapshot goes into slot ``slot`` (ANY slot: it carries no slot
        identity) bit-exactly, each tensor by its bits (the host form of
        bfloat16 is int16), nothing re-quantized or re-paged.  Paged
        layouts write through the slot's CURRENT table row, which the
        caller has pointed at exclusively owned pages.  The host mirrors
        (``gen_len``) take the restored rows too: the decode loop decides
        the slot's next resync from them."""
        for name, val in snap["bookkeeping"].items():
            ax = self.axes[name]
            dst = self.bookkeeping[name]
            dst.narrow(ax, slot, 1).copy_(LT.bits_as(val, dst.dtype))
            if name in self.host:
                self.host[name][slot] = val.select(ax, 0).item()
        self.layout.restore_slot(self.kv, self.bookkeeping, self.axes, slot,
                                 snap["kv"])
        return self

    def where_rows(self, rows: torch.Tensor, other: "DecodeState"
                   ) -> "DecodeState":
        """Per-slot select (a new state): self where ``rows`` (B,) is True,
        else ``other`` -- the JAX package's way to freeze rows.  The decode
        loop masks its writes instead; the tests hold the two equal."""
        bk = {n: where_rows(rows, t, other.bookkeeping[n], self.axes[n])
              for n, t in self.bookkeeping.items()}
        kv = self.layout.where_rows(rows, self.kv, other.kv,
                                    self.bookkeeping, self.axes)
        host_rows = rows.cpu().numpy()
        host = {n: np.where(host_rows, v, other.host[n])
                for n, v in self.host.items()}
        return DecodeState(kv, bk, self.axes, host, self.layout)


# ---------------------------------------------------------------------------
# Sampling + chunked decode
# ---------------------------------------------------------------------------


def sample_tokens(logits: torch.Tensor, temperature: np.ndarray,
                  generators: Optional[Sequence[Optional[torch.Generator]]]
                  = None, rows: Optional[np.ndarray] = None
                  ) -> torch.Tensor:
    """Per-slot sampling.  logits (B, V); temperature (B,) host floats,
    <= 0 meaning greedy.  A row with temperature > 0 draws from its own
    ``generators[b]`` (one per session: a session's draws depend on its
    own progress only); ``rows`` (B,) bool restricts which rows draw.
    Returns (B,) int32 on logits' device."""
    out = logits.argmax(dim=-1).to(torch.int32)
    temperature = np.asarray(temperature, np.float64).reshape(-1)
    hot = temperature > 0.0
    if rows is not None:
        hot = hot & np.asarray(rows, bool)
    for b in np.nonzero(hot)[0]:
        probs = torch.softmax(logits[b].float() /
                              max(float(temperature[b]), 1e-6), dim=-1)
        out[b] = torch.multinomial(probs, 1, generator=generators[b])[0]
    return out


class DecodeAPI(Protocol):
    """The serving protocol the scheduler and the engine drive (the JAX
    package's ``DecodeAPI``, eager): :class:`TConstDecode` and
    :class:`DenseDecode` implement it."""

    cfg: ModelConfig
    device: torch.device
    layout: LT.LayoutSpec

    def prepare_params(self, params: Any) -> Any: ...

    def init_state(self, slots: int, max_len: int) -> DecodeState: ...

    def prefill(self, params, batch: Dict[str, Any], max_len: int
                ) -> Tuple[torch.Tensor, DecodeState]: ...

    def prefill_into_slot(self, params, state: DecodeState, slot: int,
                          tokens: Any,
                          extras: Optional[Dict[str, Any]] = None,
                          page_write_mask: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, DecodeState]: ...

    def raw_step(self, params, state: DecodeState, token: torch.Tensor,
                 live: Optional[torch.Tensor] = None,
                 active: Optional[np.ndarray] = None
                 ) -> Tuple[torch.Tensor, DecodeState]: ...

    def sync_candidates(self, state: DecodeState,
                        active: Optional[np.ndarray] = None
                        ) -> np.ndarray: ...

    def sync_rows(self, params, state: DecodeState, rows: np.ndarray
                  ) -> DecodeState: ...

    def refresh_host(self, state: DecodeState) -> None: ...

    def stable_prefix_len(self, prompt_len: int) -> int: ...

    def sync_anticipated(self, state: DecodeState, n_steps: int
                         ) -> np.ndarray: ...

    def supports_chunked_prefill(self, extras: Optional[Dict[str, Any]]
                                 = None) -> bool: ...

    def chunked_prefill_fits(self, prompt_len: int, resident_len: int,
                             chunk: int, max_len: int) -> bool: ...

    def prefill_into_slot_chunked(
            self, params, state: DecodeState, slot: int, tokens: Any,
            extras: Optional[Dict[str, Any]] = None,
            page_write_mask: Optional[torch.Tensor] = None,
            resident_len: int = 0, chunk: int = 32
    ) -> Tuple[torch.Tensor, DecodeState, Dict[str, int]]: ...

    def admission_key(self, tokens: Any,
                      extras: Optional[Dict[str, Any]] = None
                      ) -> Optional[bytes]:
        """Content digest under which this request's POST-ADMISSION slot
        state may be stored and reused, or None when admission is not a
        pure function of (params, prompt ids).  A scheduler with a tier
        store turns re-admission of a known prompt into an O(1) restore
        with zero forward compute."""
        ...


def decode_chunk(decode: DecodeAPI, params: Any, state: DecodeState,
                 token: torch.Tensor,
                 generators: Sequence[Optional[torch.Generator]],
                 temperature: np.ndarray, active: np.ndarray, n_steps: int,
                 eos: Optional[np.ndarray] = None
                 ) -> Tuple[torch.Tensor, DecodeState, np.ndarray]:
    """Run ``n_steps`` decode steps eagerly.  Before each step the rows
    whose generation window is full resync (compacted: only those rows,
    chosen from the host mirror of ``gen_len`` -- no device read per
    token).  token (B,): each slot's last sampled token.  active (B,)
    host bool: inactive slots are frozen bit-identically and echo their
    token.  eos: optional (B,) host int32 ids (< 0 disables); a slot that
    samples its EOS sets the device ``done`` flag and is frozen for the
    rest of the chunk.  Returns (tokens (B, n_steps), state, resyncs (B,)
    host int -- the resyncs the host scheduled per slot)."""
    dev = token.device
    active = np.asarray(active, bool)
    active_t = torch.as_tensor(active, device=dev)
    eos_t = None if eos is None else torch.as_tensor(
        np.asarray(eos, np.int32), device=dev)
    resyncs = np.zeros(active.shape, np.int64)
    toks: List[torch.Tensor] = []
    for _ in range(n_steps):
        rows = decode.sync_candidates(state, active)
        if rows.any():
            state = decode.sync_rows(params, state, rows)
            resyncs += rows
        done = state.bookkeeping["done"]
        live = active_t & ~done
        logits, state = decode.raw_step(params, state, token, live=live,
                                        active=active)
        nxt = sample_tokens(logits, temperature, generators, rows=active)
        nxt = torch.where(live, nxt, token)
        if eos_t is not None:
            hit = live & (eos_t >= 0) & (nxt == eos_t)
            done |= hit
        toks.append(nxt)
        token = nxt
    if eos_t is not None:
        # EOS-frozen rows stop advancing on device: the decode re-aligns
        # its host mirrors (one read per chunk)
        decode.refresh_host(state)
    out = torch.stack(toks, dim=1) if toks else \
        torch.zeros((token.shape[0], 0), dtype=torch.int32, device=dev)
    return out, state, resyncs


def _check_prefill_layout(layout: Any, cache: Dict[str, torch.Tensor]
                          ) -> None:
    """A full-batch prefill cannot place rows in an under-sized paged pool
    -- but only when the cache has paged fields."""
    if isinstance(layout, LT.PagedLayout) and not layout.preallocated \
            and layout.pages_anything(cache):
        raise ValueError(
            "full-batch prefill cannot place rows in an under-sized paged "
            "pool (pool_pages < slots * pages_per_slot); use the "
            "scheduler's page allocator via prefill_into_slot, or leave "
            "pool_pages=None")


# ---------------------------------------------------------------------------
# Chunked, KV-conditioned admission (the generic chunk loop)
# ---------------------------------------------------------------------------


class ChunkedAdmission:
    """The generic chunked-admission loop (JAX's ``DecodeAPI``
    defaults), mixed into a decode dataclass that defines the hooks
    ``_LENGTH_AXES``, ``_state_max_len``, ``_chunk_seed_row``,
    ``_chunk_fn`` and ``_wrap``.  :class:`TConstDecode` overrides the
    loop itself with the bucketed admission."""

    def supports_chunked_prefill(self, extras: Optional[Dict[str, Any]]
                                 = None) -> bool:
        """True when this family (with these per-request extras) can admit
        through :meth:`prefill_into_slot_chunked`."""
        return True

    def _chunk_resident_start(self, resident_len: int) -> int:
        """Where the chunk loop may start given a resident shared prefix:
        after the adopted pages (tail-only compute).  A family carrying
        recurrent state overrides it: that state is a function of the
        whole prompt and cannot be rebuilt from adopted KV."""
        return resident_len

    def chunked_prefill_fits(self, prompt_len: int, resident_len: int,
                             chunk: int, max_len: int) -> bool:
        """True when the chunk grid over this prompt stays inside the
        ``max_len`` buffers.  The last chunk's padding runs up to
        ``chunk - 1`` positions past the prompt (overwritten by decode
        appends, masked meanwhile), but never past ``max_len``.  For the
        rare prompt this excludes, the scheduler admits in one shot."""
        start0 = min(self._chunk_resident_start(resident_len),
                     (prompt_len - 1) // chunk * chunk)
        n_chunks = -(-(prompt_len - start0) // chunk)
        return start0 + n_chunks * chunk <= max_len

    def prefill_into_slot_chunked(
            self, params, state: DecodeState, slot: int, tokens: Any,
            extras: Optional[Dict[str, Any]] = None,
            page_write_mask: Optional[torch.Tensor] = None,
            resident_len: int = 0, chunk: int = 32
    ) -> Tuple[torch.Tensor, DecodeState, Dict[str, int]]:
        """Chunked, KV-conditioned admission of prompt ``tokens`` (L,)
        into ``slot``, IN PLACE: the prompt runs in fixed chunks of
        ``chunk`` tokens, each attending the KV already in the slot's row
        cache -- earlier chunks and, when ``resident_len > 0``, the
        prefix-shared pages the scheduler adopted into the slot's table
        row -- so the forward covers the unshared tail only, and every
        chunk has one shape whatever the prompt's length.

        Seed a batch-1 row cache (from the request's ``extras`` where the
        family needs them: the enc-dec's encoder runs there), copy the
        resident prefix into it from the slot (``read_slot``), then per
        chunk: the forward
        (``_chunk_fn``) and the chunk's length-axis KV into the slot
        (``write_span``); then the bookkeeping and the other state
        (``_chunk_finalize``).  ``resident_len`` is page-aligned (adopted
        pages x page size).  When it covers the whole prompt the last
        chunk is still forwarded, for the admission's logits, and its
        writes to adopted pages go to TRASH (``min_page``), as every
        write below ``resident_len`` does.  ``page_write_mask`` is not
        needed: ``min_page`` protects the same pages.  Returns (logits
        (V,), state, {"forward_tokens": positions forwarded, padded to
        the chunk grid, "chunks": chunks run})."""
        del page_write_mask
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        L = int(tokens.shape[0])
        if L < 1:
            raise ValueError("cannot admit an empty prompt")
        chunk = int(chunk)
        # one chunk is forwarded for the admission logits even when the
        # page-aligned resident prefix covers the whole prompt
        start0 = min(self._chunk_resident_start(resident_len),
                     (L - 1) // chunk * chunk)
        n_chunks = -(-(L - start0) // chunk)
        buf = np.zeros((1, n_chunks * chunk), np.int32)
        buf[0, :L - start0] = tokens[start0:]
        buf = torch.as_tensor(buf, device=self.device)
        row = self._chunk_seed_row(params, extras,
                                   self._state_max_len(state))
        min_page = None
        if resident_len > 0 and isinstance(state.layout, LT.PagedLayout):
            min_page = resident_len // state.layout.page
        if start0 > 0:
            row = self._chunk_gather_resident(state, slot, row,
                                              resident_len)
        for j in range(n_chunks):
            start = start0 + j * chunk
            last = j == n_chunks - 1
            logits, row, chunk_kv = self._chunk_fn(
                params, row, buf[:, j * chunk:(j + 1) * chunk], start, L,
                logits_at=(L - 1) - start if last else None)
            if chunk_kv:
                state = self._chunk_span_write(state, slot, chunk_kv, start,
                                               min_page)
        state = self._chunk_finalize(state, slot, row, L)
        return logits[0], state, {"forward_tokens": n_chunks * chunk,
                                  "chunks": n_chunks}

    def _chunk_gather_resident(self, state: DecodeState, slot: int,
                               row: Dict[str, torch.Tensor],
                               resident_len: int
                               ) -> Dict[str, torch.Tensor]:
        """Copy positions ``[0, resident_len)`` of the slot's resident KV
        (adopted prefix-shared pages included, read through the layout)
        into the row cache, IN PLACE, so tail chunks attend them."""
        dense = state.read_slot(slot)
        for f, la in self._LENGTH_AXES.items():
            if f in row:
                row[f].narrow(la, 0, resident_len).copy_(
                    dense[f].narrow(la, 0, resident_len))
        return row

    def _chunk_span_write(self, state: DecodeState, slot: int,
                          chunk_kv: Dict[str, torch.Tensor], start: int,
                          min_page: Optional[int]) -> DecodeState:
        return state.write_span(slot, chunk_kv, self._LENGTH_AXES, start,
                                min_page=min_page)

    def _chunk_finalize(self, state: DecodeState, slot: int,
                        row: Dict[str, torch.Tensor], n_valid: int
                        ) -> DecodeState:
        """Write the row's bookkeeping and its kv without a length axis
        (the recurrent state); the length-axis KV went in chunk by
        chunk."""
        row["len"].fill_(n_valid)
        row["done"].fill_(False)
        return state.with_slot(slot, self._wrap(row),
                               exclude=tuple(self._LENGTH_AXES))


# ---------------------------------------------------------------------------
# TConstDecode
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TConstDecode:
    """Paper §4 serving on any cache layout: O(1) cache-hit steps (tlin:
    plus the O(N) history read) and a periodic O(N) resync of the rows
    whose window is full (an MoE config's batch padded as JAX pads it).

    Layout-native: ``raw_step`` hands the step ``state.decode_views()`` --
    the physical buffers plus page-table / scale metadata -- so the hit
    step never densifies the cache.  ``sync_rows`` reruns the resync of
    the listed rows at their compacted batch size and writes the fresh
    ctx (tlin: and history) KV back THROUGH the layout (paged: the rows'
    own pages; int8: quantized on write)."""

    cfg: ModelConfig
    device: torch.device
    layout: LT.LayoutSpec = LT.DENSE_SPEC
    # the scheduler's default chunk of chunked admission (None: one-shot)
    prefill_chunk: Optional[int] = None

    def __post_init__(self):
        TC._check_mode(self.cfg.attention_mode)

    @property
    def mode(self) -> str:
        return self.cfg.attention_mode

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    def prepare_params(self, params: Any) -> Any:
        """Weights on this decode's device, matrices cast once to the
        activation dtype (what every layer would cast them to per call)."""
        return to_device(params, self.device, self.dtype)

    def bind(self, slots: int, max_len: int) -> Any:
        """The bound layout of a ``slots`` x ``max_len`` state."""
        return LT.bind_layout(self.layout, slots=slots, max_len=max_len,
                              length_axes=TC.LENGTH_AXES,
                              quant_fields=TC.QUANT_FIELDS,
                              dtype=self.cfg.dtype)

    def _wrap(self, cache: Dict[str, torch.Tensor], gen_len: np.ndarray,
              layout: Any = None) -> DecodeState:
        st = DecodeState.from_dense(cache, TC.KV_KEYS, TC.CACHE_BATCH_AXES,
                                    layout)
        st.host["gen_len"] = np.array(gen_len, np.int64)
        return st

    def init_state(self, slots: int, max_len: int) -> DecodeState:
        cache = TC.init_tconst_cache(self.cfg, slots, max_len, self.mode,
                                     device=self.device)
        return self._wrap(cache, np.zeros((slots,), np.int64),
                          self.bind(slots, max_len))

    def _prefill(self, params, tokens: Any, max_len: int
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], int]:
        tokens = torch.as_tensor(np.asarray(tokens),
                                 device=self.device).to(torch.int32)
        logits, cache = TC.prefill(params, tokens, self.cfg, max_len,
                                   mode=self.mode)
        g0 = ((tokens.shape[1] - 1) % self.cfg.tconst.w_og) + 1
        return logits, cache, g0

    def prefill(self, params, batch: Dict[str, Any], max_len: int
                ) -> Tuple[torch.Tensor, DecodeState]:
        """Full-batch prefill (same-length prompts) into this decode's
        layout (a paged layout needs its full pool)."""
        logits, cache, g0 = self._prefill(params, batch["tokens"], max_len)
        B = cache["done"].shape[0]
        layout = self.bind(B, max_len)
        _check_prefill_layout(layout, cache)
        return logits, self._wrap(cache, np.full((B,), g0), layout)

    def prefill_into_slot(self, params, state: DecodeState, slot: int,
                          tokens: Any,
                          extras: Optional[Dict[str, Any]] = None,
                          page_write_mask: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, DecodeState]:
        """Admit one request: prefill prompt ``tokens`` (L,) as a dense
        batch-1 row and write it into ``slot`` through the state's layout
        (in place; paged: the slot's own pages, which the scheduler has
        assigned, only those ``page_write_mask`` selects).  ``extras`` are
        not read (JAX's TConst admission reads none).  Returns (logits
        (V,), state)."""
        del extras
        max_len = state.bookkeeping["tokens"].shape[1]
        logits, cache, g0 = self._prefill(
            params, np.asarray(tokens, np.int32).reshape(1, -1), max_len)
        return logits[0], state.with_slot(slot, self._wrap(cache, [g0]),
                                          page_write_mask=page_write_mask)

    # chunked admission: the TConst prefill is a resync (one max_len-wide
    # pass already) plus a generation-window pass, so chunking it means
    # BUCKETING: the prompt padded into the token buffer, the window pass
    # padded to W_og -- one set of shapes for every prompt length.  The
    # forward is not tail-only: the paper's resync rebuilds the compressed
    # context from the whole history by construction.
    def supports_chunked_prefill(self, extras: Optional[Dict[str, Any]]
                                 = None) -> bool:
        return True

    def chunked_prefill_fits(self, prompt_len: int, resident_len: int,
                             chunk: int, max_len: int) -> bool:
        """One max_len-wide admission: it always fits."""
        return True

    def prefill_into_slot_chunked(
            self, params, state: DecodeState, slot: int, tokens: Any,
            extras: Optional[Dict[str, Any]] = None,
            page_write_mask: Optional[torch.Tensor] = None,
            resident_len: int = 0, chunk: int = 32
    ) -> Tuple[torch.Tensor, DecodeState, Dict[str, int]]:
        """The bucketed admission (:func:`~repro_torch.core.tconst.
        prefill_bucketed`): the prompt zero-padded into a (1, max_len)
        buffer, written into ``slot`` as :meth:`prefill_into_slot` writes
        its row.  ``extras``, ``resident_len`` and ``chunk`` do not apply
        (see the comment above).  Returns (logits (V,), state,
        {"forward_tokens": max_len, "chunks": 1})."""
        del extras, resident_len, chunk
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        L = int(tokens.shape[0])
        max_len = state.bookkeeping["tokens"].shape[1]
        buf = np.zeros((1, max_len), np.int32)
        buf[0, :L] = tokens
        logits, cache = TC.prefill_bucketed(
            params, torch.as_tensor(buf, device=self.device),
            torch.full((1,), L, dtype=torch.int32, device=self.device),
            self.cfg, mode=self.mode)
        g0 = ((L - 1) % self.cfg.tconst.w_og) + 1
        state = state.with_slot(slot, self._wrap(cache, [g0]),
                                page_write_mask=page_write_mask)
        return logits[0], state, {"forward_tokens": max_len, "chunks": 1}

    def stable_prefix_len(self, prompt_len: int) -> int:
        """The prompt prefix whose paged KV admission writes and which is
        a function of the prompt ids alone: the trailing 1..W_og tokens
        live in the dense generation window, not the paged history,
        until the first resync."""
        g0 = ((prompt_len - 1) % self.cfg.tconst.w_og) + 1
        return prompt_len - g0

    def admission_key(self, tokens, extras=None):
        """TConst admission is a resync plus a generation-window pass,
        both pure functions of the prompt ids (``TC.RESYNC_INPUT_KEYS``),
        so the admitted slot is content-addressable by prompt digest and
        re-admitting a known prompt becomes an O(1) restore instead of
        the O(N) resync.  None with extras (JAX's rule)."""
        if extras:
            return None
        return TC.admission_digest(np.asarray(tokens), self.mode,
                                   self.cfg.tconst.w_og)

    def sync_anticipated(self, state: DecodeState, n_steps: int
                         ) -> np.ndarray:
        """(B,) host bool: slots whose resync may fire within the next
        ``n_steps`` steps.  ``gen_len`` grows by at most one a step, so
        ``gen_len + n_steps >= W_og`` bounds every resync of the chunk.
        Read from the host mirror, the same one ``sync_candidates``
        reads, never from the device.  JAX also leaves out EOS-finished
        rows; here they are anticipated too (an early fork loses some
        sharing, never correctness), and the scheduler releases them at
        the chunk boundary, before its copy-on-write pass."""
        return state.host["gen_len"] + n_steps >= self.cfg.tconst.w_og

    def raw_step(self, params, state: DecodeState, token: torch.Tensor,
                 live: Optional[torch.Tensor] = None,
                 active: Optional[np.ndarray] = None
                 ) -> Tuple[torch.Tensor, DecodeState]:
        """One cache-hit step over the state's KVViews, no sync check, IN
        PLACE.  ``live`` (B,) device bool masks the writes; ``active``
        (B,) host bool says which rows the host mirror advances (default:
        all)."""
        logits, views = TC.decode_step_views(params, state.decode_views(),
                                             token, self.cfg, mode=self.mode,
                                             live=live)
        state.absorb(views)
        if active is None:
            state.host["gen_len"] += 1
        else:
            state.host["gen_len"] += np.asarray(active, np.int64)
        return logits, state

    def sync_mask(self, state: DecodeState) -> torch.Tensor:
        """(B,) device bool: rows that must resync before the next step."""
        return TC.pending_resync_rows(state.bookkeeping, self.cfg)

    def sync_candidates(self, state: DecodeState,
                        active: Optional[np.ndarray] = None) -> np.ndarray:
        """(B,) host bool from the host mirror: active rows whose window
        is full.  (An EOS-finished row may be listed; ``sync_rows`` leaves
        it untouched.)"""
        rows = state.host["gen_len"] >= self.cfg.tconst.w_og
        if active is not None:
            rows = rows & np.asarray(active, bool)
        return rows

    def sync_rows(self, params, state: DecodeState, rows: np.ndarray
                  ) -> DecodeState:
        """Compacted row-wise resync: gather only the resynced rows'
        ``RESYNC_INPUT_KEYS`` bookkeeping, run one O(N) resync at that
        batch size, and write the results back IN PLACE -- the KV through
        the layout's views (``scatter_rows``), the rest per field.  Rows
        that are not pending on device (EOS-finished) get their own
        values back, bit-identical.

        Dense FFNs resync exactly the listed rows: a row's result does not
        depend on the others.  MoE FFNs route in groups that span rows,
        so the batch is JAX's (``compacted_rows_switch``): the pending
        rows (window full, not ``done``; read from the device), ascending,
        padded with the lowest non-pending rows up to the bucket of
        :func:`~repro_torch.core.tconst.resync_buckets`.  A pending row
        that is not listed in ``rows`` (a slot the scheduler paused for
        copy-on-write) rides in that batch as JAX's does, but its result
        is masked out of the write-back like the padding's, so it keeps
        every page it shares bit-identical."""
        idx_np = np.nonzero(np.asarray(rows, bool))[0]
        if not len(idx_np):
            return state
        bk = state.bookkeeping
        axes = state.axes
        if self.cfg.is_moe:
            pending = TC.pending_resync_rows(bk, self.cfg).cpu().numpy()
            count = int(pending.sum())
            kb = min(b for b in TC.resync_buckets(len(pending))
                     if b >= count)
            order = np.argsort(~pending, kind="stable")[:kb]
            idx = torch.as_tensor(order, device=self.device)
            listed = np.asarray(rows, bool)[order]
            sel = torch.as_tensor((np.arange(kb) < count) & listed,
                                  device=self.device)
        else:
            idx = torch.as_tensor(idx_np, device=self.device)
            sel = (take_rows(bk["gen_len"], idx, axes["gen_len"]) >=
                   self.cfg.tconst.w_og) & \
                ~take_rows(bk["done"], idx, axes["done"])
        if len(idx):
            row_in = {f: take_rows(bk[f], idx, axes[f])
                      for f in TC.RESYNC_INPUT_KEYS}
            new = TC.resync(params, row_in, self.cfg, self.mode)
            views = state.kv_views()
            for f, val in new.items():
                if f in views:
                    views[f].scatter_rows(idx, sel, val)
                    continue
                dst = bk[f]
                old = take_rows(dst, idx, axes[f])
                put_rows(dst, idx, where_rows(sel, val.to(dst.dtype), old,
                                              axes[f]), axes[f])
        state.host["gen_len"][idx_np] = 0
        return state

    def refresh_host(self, state: DecodeState) -> None:
        """Re-align the host mirror of ``gen_len`` with the device after
        EOS froze rows (a copy: on the CPU, .numpy() would alias the
        device tensor)."""
        state.host["gen_len"] = \
            state.bookkeeping["gen_len"].cpu().numpy().astype(np.int64)


# ---------------------------------------------------------------------------
# DenseDecode: the decoder-only LM families
# ---------------------------------------------------------------------------

VISION_KEYS = ("vision_embeds", "vision_mask")


def _vision(extras: Optional[Dict[str, Any]], batched: bool
            ) -> Dict[str, Any]:
    """A VLM request's ``vision_embeds`` / ``vision_mask`` as
    ``LM.lm_prefill`` takes them (a batch axis added to a session's
    extras unless ``batched``); an empty dict without them."""
    extras = extras or {}
    return {k: extras[k] if batched else extras[k][None]
            for k in VISION_KEYS if k in extras}


@dataclasses.dataclass(frozen=True)
class DenseDecode(ChunkedAdmission):
    """Decoder-only LM families, served through the same protocol, with
    no periodic sync.  The attention LMs (dense, MoE -- mixtral, deepseek
    -- and the VLM) hold a growing K/V buffer (``k`` / ``v`` of (layers,
    B, max_len, KV, hd), and DeepSeek's leading dense layers' ``dense_k``
    / ``dense_v``: paged by the paged layouts on one shared page table,
    int8 under the int8 ones); the SSM family (mamba2) an O(1) recurrent
    state (``ssm`` / ``conv`` per layer) that has no length axis and is
    never quantized, so every layout holds it dense; the hybrid (hymba)
    both.  A VLM request carries ``extras={"vision_embeds": (Tv,
    frontend_dim), "vision_mask": (L,) bool}``, read at admission (one
    shot).  ``raw_step`` updates the cache IN PLACE; rows that are not
    ``live`` keep it bit-identical (an MoE step still routes them: they
    take expert capacity, as in JAX)."""

    cfg: ModelConfig
    device: torch.device
    layout: LT.LayoutSpec = LT.DENSE_SPEC
    # the scheduler's default chunk of chunked admission (None: one-shot)
    prefill_chunk: Optional[int] = None

    _LENGTH_AXES = LM.LENGTH_AXES

    def __post_init__(self):
        LM.check_family(self.cfg)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    def prepare_params(self, params: Any) -> Any:
        return LM.prepare_params(params, self.device, self.dtype)

    def bind(self, slots: int, max_len: int) -> Any:
        return LT.bind_layout(self.layout, slots=slots, max_len=max_len,
                              length_axes=LM.LENGTH_AXES,
                              quant_fields=LM.QUANT_FIELDS,
                              dtype=self.cfg.dtype)

    def _wrap(self, cache: Dict[str, torch.Tensor], layout: Any = None
              ) -> DecodeState:
        return DecodeState.from_dense(cache, LM.KV_KEYS,
                                      LM.CACHE_BATCH_AXES, layout)

    def init_state(self, slots: int, max_len: int) -> DecodeState:
        cache = LM.init_kv_cache(self.cfg, slots, max_len,
                                 device=self.device)
        return self._wrap(cache, self.bind(slots, max_len))

    def _tokens(self, tokens: Any) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens),
                               device=self.device).to(torch.int32)

    def prefill(self, params, batch: Dict[str, Any], max_len: int
                ) -> Tuple[torch.Tensor, DecodeState]:
        """Full-batch prefill (same-length prompts; a VLM batch's
        ``vision_embeds`` / ``vision_mask`` read) into this decode's
        layout."""
        logits, cache = LM.lm_prefill(params, self._tokens(batch["tokens"]),
                                      self.cfg, max_len,
                                      **_vision(batch, batched=True))
        layout = self.bind(cache["done"].shape[0], max_len)
        _check_prefill_layout(layout, cache)
        return logits, self._wrap(cache, layout)

    @staticmethod
    def _max_len(state: DecodeState, fallback: int) -> int:
        """The length of the state's K/V buffers (JAX's ``_max_len``);
        ``fallback`` for the SSM state, which has no positional buffer."""
        views = state.kv_views()
        return LT.field_length(views["k"]) if "k" in views else fallback

    def prefill_into_slot(self, params, state: DecodeState, slot: int,
                          tokens: Any,
                          extras: Optional[Dict[str, Any]] = None,
                          page_write_mask: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, DecodeState]:
        """Admit one request: prefill prompt ``tokens`` (L,) as a batch-1
        row as long as the state's K/V buffers and write it into ``slot``
        through the state's layout (in place; paged: the slot's own pages,
        which the scheduler has assigned, only those ``page_write_mask``
        selects).  A VLM's ``extras`` give its vision inputs (JAX reads no
        other).  Returns (logits (V,), state)."""
        toks = self._tokens(tokens).reshape(1, -1)
        logits, cache = LM.lm_prefill(params, toks, self.cfg,
                                      self._max_len(state, toks.shape[1]),
                                      **_vision(extras, batched=False))
        return logits[0], state.with_slot(slot, self._wrap(cache),
                                          page_write_mask=page_write_mask)

    def stable_prefix_len(self, prompt_len: int) -> int:
        """Admission writes the K/V of every prompt position, a function
        of the prompt ids alone: the whole prompt is stable."""
        return prompt_len

    def admission_key(self, tokens, extras=None):
        """None, JAX's default for this family: its admissions are not
        cached by prompt."""
        return None

    def sync_anticipated(self, state: DecodeState, n_steps: int
                         ) -> np.ndarray:
        """No periodic sync rewrites resident pages: nothing is
        anticipated."""
        return np.zeros((state.bookkeeping["done"].shape[0],), bool)

    def raw_step(self, params, state: DecodeState, token: torch.Tensor,
                 live: Optional[torch.Tensor] = None,
                 active: Optional[np.ndarray] = None
                 ) -> Tuple[torch.Tensor, DecodeState]:
        """One decode step over the state's KVViews, IN PLACE.  ``live``
        (B,) device bool masks the writes; ``active`` is not needed (no
        host mirror)."""
        logits, views = LM.lm_decode_step_views(
            params, state.decode_views(), token, self.cfg, live=live)
        return logits, state.absorb(views)

    def sync_candidates(self, state: DecodeState,
                        active: Optional[np.ndarray] = None) -> np.ndarray:
        """No periodic sync: no row is ever a candidate."""
        return np.zeros((state.bookkeeping["done"].shape[0],), bool)

    def sync_rows(self, params, state: DecodeState, rows: np.ndarray
                  ) -> DecodeState:
        return state

    def refresh_host(self, state: DecodeState) -> None:
        """No host mirror to re-align."""

    # chunked admission: the hooks of the generic chunk loop
    def supports_chunked_prefill(self, extras: Optional[Dict[str, Any]]
                                 = None) -> bool:
        """False for a request with ``vision_embeds`` (JAX's rule: its
        vision positions come from a prompt-length mask); such a request
        is admitted one-shot, a text-only one in chunks."""
        return not (extras and "vision_embeds" in extras)

    def _chunk_resident_start(self, resident_len: int) -> int:
        """The ssm / conv state is a function of the whole prompt, not of
        adopted KV: an SSM or hybrid row forwards from position 0 (its
        adopted pages still save writes: those below ``resident_len`` go
        to TRASH)."""
        if self.cfg.arch_type == "ssm" or self.cfg.hybrid_parallel:
            return 0
        return resident_len

    def _state_max_len(self, state: DecodeState) -> int:
        return self._max_len(state, 0)

    def _chunk_seed_row(self, params, extras: Optional[Dict[str, Any]],
                        max_len: int) -> Dict[str, torch.Tensor]:
        """A fresh dense batch-1 row cache (no vision request reaches the
        chunk loop)."""
        del params, extras
        return LM.init_kv_cache(self.cfg, 1, max_len, device=self.device)

    def _chunk_fn(self, params, row: Dict[str, torch.Tensor],
                  tokens: torch.Tensor, start: int, n_valid: int,
                  logits_at: Optional[int] = None):
        return LM.lm_prefill_chunk(params, row, tokens, start, n_valid,
                                   self.cfg, logits_at=logits_at)

    def supports_speculative(self) -> bool:
        """False for the SSM and hybrid families (speculative decoding
        itself is ROADMAP Queue 1 item 8): the recurrent ssm/conv state
        advances through verified-but-rejected tokens and cannot be
        rolled back by a length decrement."""
        return self.cfg.arch_type != "ssm" and not self.cfg.hybrid_parallel


# ---------------------------------------------------------------------------
# EncDecDecode: the encoder-decoder (whisper-small)
# ---------------------------------------------------------------------------

AUDIO_MISSING = ("encoder-decoder sessions need extras={'audio_feats': "
                 "(T_enc, frontend_dim)} at submission")


def _audio_feats(extras: Optional[Dict[str, Any]]) -> Any:
    """The request's ``audio_feats``; JAX's ValueError without them."""
    if not extras or "audio_feats" not in extras:
        raise ValueError(AUDIO_MISSING)
    return extras["audio_feats"]


@dataclasses.dataclass(frozen=True)
class EncDecDecode(DenseDecode):
    """Encoder-decoder: each session's encoder memory is pre-projected at
    admission into the per-layer cross K/V (``cross_k`` / ``cross_v`` of
    (layers, B, encoder_seq, KV, hd): no length axis, so dense under the
    paged layouts, int8 under the int8 ones), beside the decoder's growing
    ``k`` / ``v`` (paged by the paged layouts).  No periodic sync: the
    sync, prefix and chunk-grid hooks are :class:`DenseDecode`'s.  A
    request carries ``extras={"audio_feats": (encoder_seq,
    frontend_dim)}``; the chunked admission runs the encoder once in its
    seed row, then the decoder chunk by chunk."""

    _LENGTH_AXES = ED.LENGTH_AXES

    def __post_init__(self):
        ED.check_family(self.cfg)

    def prepare_params(self, params: Any) -> Any:
        return ED.prepare_params(params, self.device, self.dtype)

    def bind(self, slots: int, max_len: int) -> Any:
        return LT.bind_layout(self.layout, slots=slots, max_len=max_len,
                              length_axes=ED.LENGTH_AXES,
                              quant_fields=ED.QUANT_FIELDS,
                              dtype=self.cfg.dtype)

    def _wrap(self, cache: Dict[str, torch.Tensor], layout: Any = None
              ) -> DecodeState:
        return DecodeState.from_dense(cache, ED.KV_KEYS,
                                      ED.CACHE_BATCH_AXES, layout)

    def init_state(self, slots: int, max_len: int) -> DecodeState:
        cache = ED.init_encdec_cache(self.cfg, slots, max_len,
                                     device=self.device)
        return self._wrap(cache, self.bind(slots, max_len))

    def _feats(self, feats: Any) -> torch.Tensor:
        return torch.as_tensor(np.asarray(feats), device=self.device)

    def prefill(self, params, batch: Dict[str, Any], max_len: int
                ) -> Tuple[torch.Tensor, DecodeState]:
        """Full-batch prefill (same-length prompts, ``batch["audio_feats"]``
        (B, encoder_seq, frontend_dim)) into this decode's layout."""
        logits, cache = ED.encdec_prefill(
            params, self._tokens(batch["tokens"]),
            self._feats(batch["audio_feats"]), self.cfg, max_len)
        layout = self.bind(cache["done"].shape[0], max_len)
        _check_prefill_layout(layout, cache)
        return logits, self._wrap(cache, layout)

    def prefill_into_slot(self, params, state: DecodeState, slot: int,
                          tokens: Any,
                          extras: Optional[Dict[str, Any]] = None,
                          page_write_mask: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, DecodeState]:
        """Admit one request: encode its ``extras["audio_feats"]``, prefill
        prompt ``tokens`` (L,) as a batch-1 row and write it into
        ``slot`` through the state's layout (in place; paged: the slot's
        own pages, only those ``page_write_mask`` selects).  Returns
        (logits (V,), state)."""
        feats = self._feats(_audio_feats(extras))[None]
        toks = self._tokens(tokens).reshape(1, -1)
        logits, cache = ED.encdec_prefill(params, toks, feats, self.cfg,
                                          self._state_max_len(state))
        return logits[0], state.with_slot(slot, self._wrap(cache),
                                          page_write_mask=page_write_mask)

    def raw_step(self, params, state: DecodeState, token: torch.Tensor,
                 live: Optional[torch.Tensor] = None,
                 active: Optional[np.ndarray] = None
                 ) -> Tuple[torch.Tensor, DecodeState]:
        """One decode step over the state's KVViews, IN PLACE (``live`` as
        :meth:`DenseDecode.raw_step`)."""
        logits, views = ED.encdec_decode_step_views(
            params, state.decode_views(), token, self.cfg, live=live)
        return logits, state.absorb(views)

    def _chunk_seed_row(self, params, extras: Optional[Dict[str, Any]],
                        max_len: int) -> Dict[str, torch.Tensor]:
        """The encoder run once on the request's audio and each layer's
        cross K/V pre-projected into a fresh batch-1 row cache."""
        feats = self._feats(_audio_feats(extras))[None]
        return ED.encdec_seed_cache(params, feats, self.cfg, max_len)

    def _chunk_fn(self, params, row: Dict[str, torch.Tensor],
                  tokens: torch.Tensor, start: int, n_valid: int,
                  logits_at: Optional[int] = None):
        return ED.encdec_prefill_chunk(params, row, tokens, start, n_valid,
                                       self.cfg, logits_at=logits_at)

    # supports_speculative: DenseDecode's True, JAX's answer
    def verify_chunk(self, params, state: DecodeState, feed: Any):
        raise NotImplementedError(
            f"{self.cfg.name}: verify_chunk (speculative decoding) is not "
            f"ported yet: ROADMAP Queue 1 item 8")


def build_decode(cfg: ModelConfig, layout: Any = None,
                 device: Any = None, prefill_chunk: Optional[int] = None
                 ) -> DecodeAPI:
    """The decode protocol for ``cfg`` on ``device`` (default ``cuda``)
    with cache layout ``layout`` ("dense" | "paged" | "int8" |
    "paged_int8" | LayoutSpec | None).  ``prefill_chunk`` is the default
    chunk of chunked admission (None: one-shot), which the scheduler
    reads unless given its own.  Every family of the JAX package: the
    TConst family (tconst and tlin modes), the SSM family, the dense
    attention LMs (a TConst config in ``full`` or ``sliding`` mode among
    them), the MoE family, the hybrid, the VLM and the
    encoder-decoder."""
    spec = LT.as_spec(layout)
    if prefill_chunk is not None and prefill_chunk < 1:
        raise ValueError("prefill_chunk must be positive (or None for "
                         "one-shot admission)")
    dev = runtime.resolve_device(device)
    if _is_tconst(cfg):
        return TConstDecode(cfg, dev, spec, prefill_chunk)
    if cfg.is_encdec:
        return EncDecDecode(cfg, dev, spec, prefill_chunk)
    return DenseDecode(cfg, dev, spec, prefill_chunk)


@dataclasses.dataclass
class ModelAPI:
    """Facade: the seeded init, the training forward and loss, and the
    decode protocol, on one device."""

    cfg: ModelConfig
    device: torch.device

    def init(self, seed: int = 0,
             param_dtype: Optional[torch.dtype] = None) -> Any:
        """The port's seeded init.  ``param_dtype`` is the dtype the MoE
        family's weights are kept in: None (serving) the activation
        dtype; ``torch.float32`` for training, JAX's ``param_dtype`` (the
        same draws, unrounded: the serving weights are these rounded to
        the activation dtype).  Every other family's weights are float32
        either way."""
        if _is_tconst(self.cfg):
            return TC.init_tconst_lm(self.cfg, seed, self.device,
                                     param_dtype)
        if self.cfg.is_encdec:
            return ED.init_encdec(self.cfg, seed, self.device)
        return LM.init_lm(self.cfg, seed, self.device, param_dtype)

    # -- training -----------------------------------------------------------
    def forward(self, params, batch: Dict[str, Any]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced forward of ``batch["tokens"]`` (B, L) (the
        enc-dec: and ``batch["audio_feats"]``; a VLM: and its
        ``vision_embeds`` / ``vision_mask`` where given): (logits (B, L,
        V) f32, aux loss).  It reads what JAX's ``ModelAPI.forward``
        reads; M-RoPE positions other than the text ones go through
        ``LM.lm_forward(..., positions3=)``.  Differentiable for every
        family."""
        cfg = self.cfg
        tokens = batch["tokens"]
        if _is_tconst(cfg):
            return TC.tconst_forward(params, tokens, cfg,
                                     mode=cfg.attention_mode)
        if cfg.is_encdec:
            return ED.encdec_forward(params, tokens, batch["audio_feats"],
                                     cfg)
        return LM.lm_forward(params, tokens, cfg,
                             **_vision(batch, batched=True))

    def loss(self, params, batch: Dict[str, Any]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token CE plus ``router_aux_coef`` times the aux loss:
        (total, {"ce", "aux"}).  Trains every family: the TConst family,
        the dense attention LMs, the MoE family (the summed Switch aux of
        its MoE layers, as LMs and inside the TConst core), the SSM
        family and the hybrid (K4 and its backward), the enc-dec
        (``batch["audio_feats"]``) and the VLM (``vision_embeds`` /
        ``vision_mask``)."""
        cfg = self.cfg
        logits, aux = self.forward(params, batch)
        tokens = batch["tokens"]
        ce = cross_entropy(logits[:, :-1], tokens[:, 1:])
        total = ce + cfg.router_aux_coef * aux
        return total, {"ce": ce, "aux": aux}

    @property
    def decode(self) -> DecodeAPI:
        """The dense-layout decode (``build_decode`` takes a layout)."""
        return build_decode(self.cfg, device=self.device)

    def input_specs(self, shape: Any) -> Dict[str, torch.Tensor]:
        """Meta-tensor stand-ins (no allocation; the JAX package's
        ``ShapeDtypeStruct``) for every model input of ``shape``
        (a ``ShapeConfig``): ``tokens``; for the VLM, ``vision_embeds``
        (B, frontend_tokens, frontend_dim) and ``vision_mask`` (B, L);
        for the enc-dec, ``audio_feats`` (B, encoder_seq,
        frontend_dim)."""
        cfg = self.cfg
        B, L = shape.global_batch, shape.seq_len
        meta = torch.device("meta")
        specs = {"tokens": torch.empty((B, L), dtype=torch.int32,
                                       device=meta)}
        if cfg.arch_type == "vlm":
            specs["vision_embeds"] = torch.empty(
                (B, cfg.frontend_tokens, cfg.frontend_dim),
                dtype=getattr(torch, cfg.dtype), device=meta)
            specs["vision_mask"] = torch.empty((B, L), dtype=torch.bool,
                                               device=meta)
        if cfg.is_encdec:
            specs["audio_feats"] = torch.empty(
                (B, cfg.encoder_seq, cfg.frontend_dim),
                dtype=getattr(torch, cfg.dtype), device=meta)
        return specs


def build_model(cfg: ModelConfig, device: Any = None) -> ModelAPI:
    cfg.validate()
    dev = runtime.resolve_device(device)
    build_decode(cfg, device=dev)         # checks the family
    return ModelAPI(cfg, dev)
