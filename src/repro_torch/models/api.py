"""Model facade and the decode-side serving protocol (TConst, dense layout).

Port of the dense parts of ``src/repro/models/api.py``: the typed
:class:`DecodeState` (explicit kv / bookkeeping partition, slot surgery),
per-slot sampling, :func:`decode_chunk`, :class:`TConstDecode`,
``build_decode`` and ``build_model``.  The cache layouts (paged / int8)
and KVViews are not ported (ROADMAP Queue 1 item 6).

Where the JAX package scans a decode chunk on device and decides each
resync there, the port runs eagerly: the resync is decided from a
host-side mirror of ``gen_len`` (``DecodeState.host``), which advances by
one per step of every active slot, so no device value is read per token.
The cache tensors are updated in place; rows that are not live keep
every entry bit-identical because their writes are masked.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import runtime
from repro_torch.config import ModelConfig
from repro_torch.core import tconst as TC
from repro_torch.layers.common import put_rows, take_rows, where_rows


def _is_tconst(cfg: ModelConfig) -> bool:
    return cfg.attention_mode in ("tconst", "tlin") and \
        cfg.arch_type not in ("ssm", "audio")


# ---------------------------------------------------------------------------
# DecodeState
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DecodeState:
    """Decode cache with an explicit kv / bookkeeping partition.

    ``kv`` holds the true KV buffers; ``bookkeeping`` the token-id buffer,
    lengths, phase counters and the EOS ``done`` mask (not KV cache).
    ``axes`` maps every field to its batch ("slot") axis.  ``host`` holds
    host-side mirrors of the counters the decode loop branches on (here
    ``gen_len``), kept in step with the device without reading it.
    """

    kv: Dict[str, torch.Tensor]
    bookkeeping: Dict[str, torch.Tensor]
    axes: Dict[str, int]
    host: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dense(cls, cache: Dict[str, torch.Tensor],
                   kv_keys: Sequence[str], axes: Dict[str, int]
                   ) -> "DecodeState":
        kv = {k: v for k, v in cache.items() if k in kv_keys}
        bk = {k: v for k, v in cache.items() if k not in kv_keys}
        return cls(kv, bk, {k: axes[k] for k in cache})

    def merged(self) -> Dict[str, torch.Tensor]:
        """The dense logical cache dict (tensors alias the state's)."""
        return {**self.bookkeeping, **self.kv}

    def field(self, name: str) -> torch.Tensor:
        return self.kv[name] if name in self.kv else self.bookkeeping[name]

    def kv_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.kv.values())

    def with_slot(self, slot: int, row: "DecodeState") -> "DecodeState":
        """Write a single-row state (batch size 1) into slot ``slot``, IN
        PLACE; returns self."""
        for part, src in ((self.kv, row.kv), (self.bookkeeping,
                                                row.bookkeeping)):
            for name, val in src.items():
                ax = self.axes[name]
                part[name].select(ax, slot).copy_(val.select(ax, 0))
        for name, val in row.host.items():
            self.host[name][slot] = val[0]
        return self

    def where_rows(self, rows: torch.Tensor, other: "DecodeState"
                   ) -> "DecodeState":
        """Per-slot select (a new state): self where ``rows`` (B,) is True,
        else ``other`` -- the JAX package's way to freeze rows.  The decode
        loop masks its writes instead; the tests hold the two equal."""
        kv = {n: where_rows(rows, t, other.kv[n], self.axes[n])
              for n, t in self.kv.items()}
        bk = {n: where_rows(rows, t, other.bookkeeping[n], self.axes[n])
              for n, t in self.bookkeeping.items()}
        host_rows = rows.cpu().numpy()
        host = {n: np.where(host_rows, v, other.host[n])
                for n, v in self.host.items()}
        return DecodeState(kv, bk, self.axes, host)


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


def decode_chunk(decode: "TConstDecode", params: Any, state: DecodeState,
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
        # EOS-frozen rows stop advancing on device: one read per chunk
        # re-aligns the host mirror (a copy: on the CPU, .numpy() would
        # alias the device tensor)
        state.host["gen_len"] = \
            state.bookkeeping["gen_len"].cpu().numpy().astype(np.int64)
    out = torch.stack(toks, dim=1) if toks else \
        torch.zeros((token.shape[0], 0), dtype=torch.int32, device=dev)
    return out, state, resyncs


# ---------------------------------------------------------------------------
# TConstDecode
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TConstDecode:
    """Paper §4 serving on the dense layout: O(1) cache-hit steps and a
    periodic O(N) resync of exactly the rows whose window is full."""

    cfg: ModelConfig
    device: torch.device

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
        return TC.to_device(params, self.device, self.dtype)

    def _wrap(self, cache: Dict[str, torch.Tensor], gen_len: np.ndarray
              ) -> DecodeState:
        st = DecodeState.from_dense(cache, TC.KV_KEYS, TC.CACHE_BATCH_AXES)
        st.host["gen_len"] = np.asarray(gen_len, np.int64)
        return st

    def init_state(self, slots: int, max_len: int) -> DecodeState:
        cache = TC.init_tconst_cache(self.cfg, slots, max_len, self.mode,
                                     device=self.device)
        return self._wrap(cache, np.zeros((slots,), np.int64))

    def prefill(self, params, batch: Dict[str, Any], max_len: int
                ) -> Tuple[torch.Tensor, DecodeState]:
        """Full-batch prefill (same-length prompts)."""
        tokens = torch.as_tensor(np.asarray(batch["tokens"]),
                                 device=self.device).to(torch.int32)
        logits, cache = TC.prefill(params, tokens, self.cfg, max_len,
                                   mode=self.mode)
        g0 = ((tokens.shape[1] - 1) % self.cfg.tconst.w_og) + 1
        return logits, self._wrap(cache, np.full((tokens.shape[0],), g0))

    def prefill_into_slot(self, params, state: DecodeState, slot: int,
                          tokens: Any) -> Tuple[torch.Tensor, DecodeState]:
        """Admit one request: prefill prompt ``tokens`` (L,) at batch 1 and
        write the row into ``slot`` (in place).  Returns (logits (V,),
        state)."""
        max_len = state.bookkeeping["tokens"].shape[1]
        logits, row = self.prefill(params, {"tokens": np.asarray(
            tokens, np.int32).reshape(1, -1)}, max_len)
        return logits[0], state.with_slot(slot, row)

    def raw_step(self, params, state: DecodeState, token: torch.Tensor,
                 live: Optional[torch.Tensor] = None,
                 active: Optional[np.ndarray] = None
                 ) -> Tuple[torch.Tensor, DecodeState]:
        """One cache-hit step, no sync check, IN PLACE.  ``live`` (B,)
        device bool masks the writes; ``active`` (B,) host bool says which
        rows the host mirror advances (default: all)."""
        logits, _ = TC.decode_step(params, state.merged(), token, self.cfg,
                                   mode=self.mode, live=live)
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
        """Compacted row-wise resync: gather only the listed rows'
        ``RESYNC_INPUT_KEYS`` bookkeeping, run one O(N) resync at that
        batch size, and write the results back IN PLACE.  Rows not listed
        are never computed; listed rows that are not pending on device
        (EOS-finished) get their own values back, bit-identical."""
        idx_np = np.nonzero(np.asarray(rows, bool))[0]
        if not len(idx_np):
            return state
        idx = torch.as_tensor(idx_np, device=self.device)
        bk = state.bookkeeping
        axes = state.axes
        row_in = {f: take_rows(bk[f], idx, axes[f])
                  for f in TC.RESYNC_INPUT_KEYS}
        sel = (row_in["gen_len"] >= self.cfg.tconst.w_og) & \
            ~take_rows(bk["done"], idx, axes["done"])
        new = TC.resync(params, row_in, self.cfg, self.mode)
        for f, val in new.items():
            dst = state.field(f)
            old = take_rows(dst, idx, axes[f])
            put_rows(dst, idx, where_rows(sel, val.to(dst.dtype), old,
                                          axes[f]), axes[f])
        state.host["gen_len"][idx_np] = 0
        return state


def build_decode(cfg: ModelConfig, layout: Any = None,
                 device: Any = None) -> TConstDecode:
    """The decode protocol for ``cfg`` on ``device`` (default ``cuda``).
    Only the TConst family on the dense layout is ported."""
    if layout not in (None, "dense"):
        raise NotImplementedError(
            f"cache layout {layout!r} is not ported yet (ROADMAP Queue 1 "
            f"item 6); the port serves the dense layout")
    if not _is_tconst(cfg):
        raise NotImplementedError(
            f"{cfg.name}: only the TConst family is ported (the dense-LM "
            f"and enc-dec families are ROADMAP Queue 1 items 7 and 9)")
    return TConstDecode(cfg, runtime.resolve_device(device))


@dataclasses.dataclass
class ModelAPI:
    """Facade: the seeded init and the decode protocol, on one device."""

    cfg: ModelConfig
    device: torch.device

    def init(self, seed: int = 0) -> Any:
        return TC.init_tconst_lm(self.cfg, seed, self.device)

    @property
    def decode(self) -> TConstDecode:
        return build_decode(self.cfg, device=self.device)


def build_model(cfg: ModelConfig, device: Any = None) -> ModelAPI:
    cfg.validate()
    dev = runtime.resolve_device(device)
    build_decode(cfg, device=dev)         # raises for unported families
    return ModelAPI(cfg, dev)
