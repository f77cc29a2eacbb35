"""Host-side content-addressed tier store: the memory hierarchy below the
card's memory.  (A copy of the JAX package's ``serving/tier_store.py``,
numpy only; the port imports nothing of it, and a spill directory written
by either store reads back in the other.)

The serving stack keeps every *active* session's cache state in the
scheduler's fixed-shape device ``DecodeState``.  This module is where
everything else lives: a capacity-bounded, LRU-evictable, host-RAM store
of content-addressed blobs, with an optional mmap'd disk directory as
the tier below that.  One mechanism serves three kinds of state:

* **Session snapshots** -- a spilled/preempted session's entire slot
  state (``DecodeState.snapshot_slot``: bookkeeping rows + kv in the
  PHYSICAL representation, so int8 snapshots stay compressed on host
  and paged snapshots hold only the slot's live pages).  Keyed by a
  digest of the session content (prompt + extras + generated ids) and
  PINNED while the session is spilled: a pinned entry may demote to the
  disk tier but is never dropped -- the session must be restorable.
* **Retired prefix pages** -- refcount-0 prefix-sharing pages retire
  INTO the store under the same page-aligned rolling-hash chunk keys
  the resident prefix map uses, so a later admission with the same
  prompt prefix re-adopts their content (one page upload) instead of
  re-forwarding it: residency in the memory hierarchy, not refcount,
  decides reuse.
* **Admission snapshots** -- for families whose post-admission slot
  state is a pure function of the prompt ids (the tconst/tlin resync
  rebuilds ctx/hist KV from raw tokens -- ``tconst.admission_digest``),
  the cold admission's slot snapshot (+ prefill logits) is stored by
  prompt digest, turning re-admission of a known prompt into an O(1)
  restore with zero forward compute.

Arrays are numpy.  The scheduler hands a bfloat16 tensor over as its
int16 bit pattern (numpy has no bfloat16), so ``Blob.nbytes`` is the
physical byte count in every dtype.

Capacity is enforced over the RAM tier in bytes; eviction is LRU.  With
``spill_dir`` set, evicted entries DEMOTE to ``spill_dir/<key-hex>/``
(one ``.npy`` per array, loaded back with ``np.load(mmap_mode="r")`` so
promotion reads lazily through the page cache: the arrays come back
read-only) instead of being dropped; a ``get`` that misses RAM promotes
from disk.  The disk index is rebuilt on construction, so a spill
directory outlives the process.  Without a disk tier, unpinned entries
are dropped at eviction (their loss costs recompute, never correctness)
and pinned entries are kept even over capacity (pins are a correctness
obligation).
"""
from __future__ import annotations

import collections
import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np

_BK = "bk."          # flattened-snapshot prefixes (field names never
_KV = "kv."          # contain "." -- kv/bookkeeping names are identifiers)
_META_FILE = "meta.json"


@dataclasses.dataclass
class Blob:
    """One store entry: named host arrays + a small JSON-able meta dict."""

    arrays: Dict[str, np.ndarray]
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def nbytes(self) -> int:
        return int(sum(a.nbytes for a in self.arrays.values()))


def flatten_slot_snapshot(snap: Dict[str, Dict[str, np.ndarray]],
                          meta: Dict[str, Any]) -> Blob:
    """Flatten a host ``DecodeState.snapshot_slot`` result (the
    ``{"bookkeeping": ..., "kv": ...}`` two-dict form) into one Blob."""
    arrays: Dict[str, np.ndarray] = {}
    for name, v in snap["bookkeeping"].items():
        arrays[_BK + name] = np.asarray(v)
    for name, v in snap["kv"].items():
        arrays[_KV + name] = np.asarray(v)
    return Blob(arrays, dict(meta))


def unflatten_slot_snapshot(blob: Blob) -> Tuple[Dict[str, np.ndarray],
                                                 Dict[str, np.ndarray],
                                                 Dict[str, Any]]:
    """Inverse of :func:`flatten_slot_snapshot`:
    ``(bookkeeping_rows, kv_rows, meta)``.  Extra arrays without a
    partition prefix (e.g. an admission blob's ``logits``) are left out
    -- read them from ``blob.arrays`` directly."""
    bk: Dict[str, np.ndarray] = {}
    kv: Dict[str, np.ndarray] = {}
    for name, v in blob.arrays.items():
        if name.startswith(_BK):
            bk[name[len(_BK):]] = v
        elif name.startswith(_KV):
            kv[name[len(_KV):]] = v
    return bk, kv, dict(blob.meta)


class TierStore:
    """Content-addressed LRU blob store: bounded host RAM over an
    optional mmap'd disk directory (see module docstring)."""

    def __init__(self, capacity_bytes: Optional[int] = None,
                 spill_dir: Optional[str] = None):
        if capacity_bytes is not None and capacity_bytes < 0:
            raise ValueError("capacity_bytes must be >= 0 (or None for "
                             "an unbounded RAM tier)")
        self.capacity_bytes = capacity_bytes
        self.spill_dir = Path(spill_dir) if spill_dir is not None else None
        self._ram: "collections.OrderedDict[bytes, Blob]" = \
            collections.OrderedDict()
        self._ram_bytes = 0
        self._pins: Dict[bytes, int] = {}
        self._disk: Dict[bytes, int] = {}        # key -> stored nbytes
        self.stats = {"puts": 0, "hits": 0, "misses": 0, "evictions": 0,
                      "demotions": 0, "promotions": 0}
        if self.spill_dir is not None:
            self.spill_dir.mkdir(parents=True, exist_ok=True)
            for d in self.spill_dir.iterdir():   # a spill dir is durable:
                meta_p = d / _META_FILE          # re-index existing entries
                if d.is_dir() and meta_p.exists():
                    with open(meta_p) as f:
                        meta = json.load(f)
                    self._disk[bytes.fromhex(d.name)] = int(
                        meta.get("__nbytes", 0))

    # -- introspection ------------------------------------------------------
    def __len__(self) -> int:
        return len(self._ram) + sum(1 for k in self._disk
                                    if k not in self._ram)

    def __contains__(self, key: bytes) -> bool:
        """Residency test (RAM or disk) WITHOUT touching LRU order --
        admission planning probes many keys it may not fetch."""
        return key in self._ram or key in self._disk

    @property
    def occupancy_bytes(self) -> int:
        return self._ram_bytes

    @property
    def disk_bytes(self) -> int:
        return int(sum(self._disk.values()))

    def pinned_keys(self) -> Iterable[bytes]:
        return tuple(self._pins)

    # -- pinning ------------------------------------------------------------
    def pin(self, key: bytes) -> None:
        """A pinned entry may demote to disk but is NEVER dropped (kept
        over capacity if there is no disk tier) -- the contract that
        makes spilled sessions restorable.  Counted: pin/unpin nest."""
        assert key in self, "cannot pin a key the store does not hold"
        self._pins[key] = self._pins.get(key, 0) + 1

    def unpin(self, key: bytes) -> None:
        n = self._pins.get(key, 0) - 1
        if n <= 0:
            self._pins.pop(key, None)
            # an entry kept over capacity ONLY by its pin loses that
            # excuse now -- evict eagerly instead of letting it squat in
            # RAM until the next unrelated put
            self._evict_to_capacity()
        else:
            self._pins[key] = n

    # -- core ---------------------------------------------------------------
    def put(self, key: bytes, blob: Blob, pin: bool = False) -> None:
        """Insert/refresh ``key``.  Content-addressed: a re-put of a
        resident key carries identical content, so any disk copy stays
        valid (demotion skips the rewrite).  ``pin=True`` registers the
        pin BEFORE capacity enforcement -- a put-then-pin pair could
        otherwise lose the entry to its own eviction pass when the blob
        alone exceeds capacity and there is no disk tier."""
        old = self._ram.pop(key, None)
        if old is not None:
            self._ram_bytes -= old.nbytes
        self._ram[key] = blob
        self._ram_bytes += blob.nbytes
        self.stats["puts"] += 1
        if pin:
            self._pins[key] = self._pins.get(key, 0) + 1
        self._evict_to_capacity()

    def get(self, key: bytes) -> Optional[Blob]:
        """Fetch (and LRU-touch) ``key``; a RAM miss promotes from the
        disk tier.  None when the content is in neither tier."""
        blob = self._ram.get(key)
        if blob is not None:
            self._ram.move_to_end(key)
            self.stats["hits"] += 1
            return blob
        if key in self._disk:
            blob = self._disk_read(key)
            self._ram[key] = blob
            self._ram_bytes += blob.nbytes
            self.stats["promotions"] += 1
            self.stats["hits"] += 1
            self._evict_to_capacity(keep=key)
            return blob
        self.stats["misses"] += 1
        return None

    def pop(self, key: bytes) -> Optional[Blob]:
        """Remove ``key`` from every tier (pins are cleared too)."""
        self._pins.pop(key, None)
        blob = self._ram.pop(key, None)
        if blob is not None:
            self._ram_bytes -= blob.nbytes
        if key in self._disk:
            disk_blob = self._disk_read(key) if blob is None else None
            self._disk_remove(key)
            blob = blob if blob is not None else disk_blob
        return blob

    def _evict_to_capacity(self, keep: Optional[bytes] = None) -> None:
        if self.capacity_bytes is None:
            return
        # LRU walk; an entry survives in RAM only if it is pinned AND
        # there is no disk tier to demote it to (or it is `keep`, the
        # entry a promotion is currently returning a reference to)
        skipped = []
        while self._ram_bytes > self.capacity_bytes and self._ram:
            key, blob = next(iter(self._ram.items()))
            if key == keep or (key in self._pins and
                               self.spill_dir is None):
                self._ram.move_to_end(key)
                skipped.append(key)
                if len(skipped) >= len(self._ram):
                    break                    # everything left must stay
                continue
            del self._ram[key]
            self._ram_bytes -= blob.nbytes
            if self.spill_dir is not None:
                self._disk_write(key, blob)
                self.stats["demotions"] += 1
            else:
                self.stats["evictions"] += 1

    # -- disk tier ----------------------------------------------------------
    def _entry_dir(self, key: bytes) -> Path:
        return self.spill_dir / key.hex()

    def _disk_write(self, key: bytes, blob: Blob) -> None:
        if key in self._disk:
            return                  # content-addressed: copy already valid
        d = self._entry_dir(key)
        d.mkdir(parents=True, exist_ok=True)
        for name, arr in blob.arrays.items():
            np.save(d / f"{name}.npy", np.ascontiguousarray(arr))
        meta = dict(blob.meta)
        meta["__nbytes"] = blob.nbytes
        meta["__arrays"] = sorted(blob.arrays)
        with open(d / _META_FILE, "w") as f:
            json.dump(meta, f)
        self._disk[key] = blob.nbytes

    def _disk_read(self, key: bytes) -> Blob:
        d = self._entry_dir(key)
        with open(d / _META_FILE) as f:
            meta = json.load(f)
        names = meta.pop("__arrays")
        meta.pop("__nbytes", None)
        arrays = {name: np.load(d / f"{name}.npy", mmap_mode="r")
                  for name in names}
        return Blob(arrays, meta)

    def _disk_remove(self, key: bytes) -> None:
        self._disk.pop(key, None)
        d = self._entry_dir(key)
        if d.exists():
            for p in d.iterdir():
                p.unlink()
            d.rmdir()
