"""Model facade and the decode-side serving protocol.

Port of ``src/repro/models/api.py`` for the TConst family (tconst and
tlin modes) and the decoder-only LM's SSM family, dense attention LMs
(among them the paper's base transformer, ``tconst-41m`` with
``attention_mode="full"``) and MoE family: the typed
:class:`DecodeState` (explicit kv / bookkeeping partition, a pluggable
physical layout from :mod:`repro_torch.models.layouts`, slot surgery
through the layout), per-slot sampling, the :class:`DecodeAPI` protocol,
:func:`decode_chunk`, :class:`TConstDecode`, :class:`DenseDecode` (a
growing KV cache or an O(1) recurrent state, no periodic resync),
``build_decode`` and ``build_model``; and the training side of the
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

    def with_slot(self, slot: int, row: "DecodeState") -> "DecodeState":
        """Write a single-row state (batch size 1) into slot ``slot``, IN
        PLACE; returns self.  Bookkeeping is a per-field row write; kv
        goes through the layout (paged: only the slot's own pages)."""
        for name, val in row.bookkeeping.items():
            if name.startswith(LT.LAYOUT_BK_PREFIX):
                continue
            ax = self.axes[name]
            self.bookkeeping[name].select(ax, slot).copy_(val.select(ax, 0))
        dense_row = row.layout.unpack(row.kv, row.bookkeeping, row.axes)
        self.layout.write_slot(self.kv, self.bookkeeping, slot, dense_row,
                               self.axes)
        for name, val in row.host.items():
            self.host[name][slot] = val[0]
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
                          tokens: Any) -> Tuple[torch.Tensor,
                                                DecodeState]: ...

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
                          tokens: Any) -> Tuple[torch.Tensor, DecodeState]:
        """Admit one request: prefill prompt ``tokens`` (L,) as a dense
        batch-1 row and write it into ``slot`` through the state's layout
        (in place; paged: the slot's own pages, which the scheduler has
        assigned).  Returns (logits (V,), state)."""
        max_len = state.bookkeeping["tokens"].shape[1]
        logits, cache, g0 = self._prefill(
            params, np.asarray(tokens, np.int32).reshape(1, -1), max_len)
        return logits[0], state.with_slot(slot, self._wrap(cache, [g0]))

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
        :func:`~repro_torch.core.tconst.resync_buckets`."""
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
            sel = torch.as_tensor(np.arange(kb) < count, device=self.device)
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
# DenseDecode: the decoder-only LM family (SSM and dense attention LMs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DenseDecode:
    """Decoder-only LM family, served through the same protocol, with no
    periodic sync.  Ported so far: the dense attention LMs and the MoE
    family (mixtral, deepseek), whose cache is a growing K/V buffer (``k``
    / ``v`` of (layers, B, max_len, KV, hd), and DeepSeek's leading dense
    layers' ``dense_k`` / ``dense_v``: paged by the paged layouts on one
    shared page table, int8 under the int8 ones), and the SSM family
    (mamba2), whose O(1) recurrent state (``ssm`` / ``conv`` per layer)
    has no length axis and is never quantized, so every layout holds it
    dense.  ``raw_step`` updates the cache IN PLACE; rows that are not
    ``live`` keep it bit-identical (an MoE step still routes them: they
    take expert capacity, as in JAX)."""

    cfg: ModelConfig
    device: torch.device
    layout: LT.LayoutSpec = LT.DENSE_SPEC

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
        """Full-batch prefill (same-length prompts) into this decode's
        layout."""
        logits, cache = LM.lm_prefill(params, self._tokens(batch["tokens"]),
                                      self.cfg, max_len)
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
                          tokens: Any) -> Tuple[torch.Tensor, DecodeState]:
        """Admit one request: prefill prompt ``tokens`` (L,) as a batch-1
        row as long as the state's K/V buffers and write it into ``slot``
        through the state's layout (in place; paged: the slot's own pages,
        which the scheduler has assigned).  Returns (logits (V,), state)."""
        toks = self._tokens(tokens).reshape(1, -1)
        logits, cache = LM.lm_prefill(params, toks, self.cfg,
                                      self._max_len(state, toks.shape[1]))
        return logits[0], state.with_slot(slot, self._wrap(cache))

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

    def supports_speculative(self) -> bool:
        """False for SSM (speculative decoding itself is ROADMAP Queue 1
        item 8): the recurrent ssm/conv state advances through verified-
        but-rejected tokens and cannot be rolled back by a length
        decrement."""
        return self.cfg.arch_type != "ssm" and not self.cfg.hybrid_parallel


def build_decode(cfg: ModelConfig, layout: Any = None,
                 device: Any = None) -> DecodeAPI:
    """The decode protocol for ``cfg`` on ``device`` (default ``cuda``)
    with cache layout ``layout`` ("dense" | "paged" | "int8" |
    "paged_int8" | LayoutSpec | None).  Ported: the TConst family
    (tconst and tlin modes), the SSM family, the dense attention LMs (a
    TConst config in ``full`` or ``sliding`` mode among them) and the MoE
    family."""
    spec = LT.as_spec(layout)
    if _is_tconst(cfg):
        return TConstDecode(cfg, runtime.resolve_device(device), spec)
    # DenseDecode raises for the families not ported yet
    return DenseDecode(cfg, runtime.resolve_device(device), spec)


@dataclasses.dataclass
class ModelAPI:
    """Facade: the seeded init, the training forward and loss, and the
    decode protocol, on one device."""

    cfg: ModelConfig
    device: torch.device

    def init(self, seed: int = 0) -> Any:
        if _is_tconst(self.cfg):
            return TC.init_tconst_lm(self.cfg, seed, self.device)
        return LM.init_lm(self.cfg, seed, self.device)

    # -- training -----------------------------------------------------------
    def forward(self, params, batch: Dict[str, Any]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced forward of ``batch["tokens"]`` (B, L):
        (logits (B, L, V) f32, aux loss); differentiable for the TConst
        family and the dense attention LMs."""
        cfg = self.cfg
        tokens = batch["tokens"]
        if _is_tconst(cfg):
            return TC.tconst_forward(params, tokens, cfg,
                                     mode=cfg.attention_mode)
        return LM.lm_forward(params, tokens, cfg)

    def loss(self, params, batch: Dict[str, Any]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token CE plus ``router_aux_coef`` times the aux loss:
        (total, {"ce", "aux"}).  The MoE and SSM families raise (their
        training is not ported)."""
        cfg = self.cfg
        if cfg.is_moe:
            raise NotImplementedError(
                f"{cfg.name}: MoE training (the router aux loss through "
                f"the expert routing) is not ported yet: ROADMAP Queue 1 "
                f"item 10b")
        if cfg.arch_type == "ssm":
            raise NotImplementedError(
                f"{cfg.name}: SSM training is not ported yet (K4 has no "
                f"backward; JAX differentiates its scan): ROADMAP Queue 1 "
                f"item 10c")
        logits, aux = self.forward(params, batch)
        tokens = batch["tokens"]
        ce = cross_entropy(logits[:, :-1], tokens[:, 1:])
        total = ce + cfg.router_aux_coef * aux
        return total, {"ce": ce, "aux": aux}

    @property
    def decode(self) -> DecodeAPI:
        """The dense-layout decode (``build_decode`` takes a layout)."""
        return build_decode(self.cfg, device=self.device)


def build_model(cfg: ModelConfig, device: Any = None) -> ModelAPI:
    cfg.validate()
    dev = runtime.resolve_device(device)
    build_decode(cfg, device=dev)         # raises for unported families
    return ModelAPI(cfg, dev)
