"""Physical cache layouts behind :class:`repro_torch.models.api.DecodeState`.

Port of ``src/repro/models/layouts.py``.  The decode step consumes the
cache through **KVViews** -- per-field descriptors (:class:`DenseView` /
:class:`QuantView` / :class:`PagedView`) made by ``layout.view(kv, bk,
axes)``.  A view holds the PHYSICAL buffers plus the index and scale
metadata needed to read or append one token in that representation: the
kernels walk the page table (K3) or dequantise per vector (K1's int8
variant) themselves, and nothing on the decode hot path materialises the
dense ``slots x max_len`` logical cache.  The dense logical dict
(``DecodeState.merged`` through :meth:`pack` / :meth:`unpack`) is the
test oracle and the admission path's currency.

Layouts:

* :class:`DenseLayout`     -- physical == logical.
* :class:`QuantizedLayout` -- int8 KV with per-vector (last axis) float32
  scales (``f`` -> ``f__q`` / ``f__scale``); symmetric round-to-nearest,
  a zero scale becomes 1.
* :class:`PagedLayout`     -- every length-axis field is split into pages
  of a shared pool ``(..., pool_pages + 1, page, ...)`` with a per-slot
  int32 page table in bookkeeping.  The extra last page is TRASH:
  unassigned table entries point at it, so writes to unassigned regions
  land there and reads of them are masked by the attention's valid
  length.  With ``quant_fields`` set ("paged_int8") the pool pages hold
  int8 vectors and their scales ride in a parallel scale pool.

Writes go IN PLACE (the port's dense decode path already updates its
cache in place): ``write_token``, ``scatter_rows``, ``set_layer`` and
``write_slot`` mutate the physical tensors the views alias and return
the view (or the kv dict) for symmetry with the JAX functions, which
return new arrays.  ``pack`` / ``unpack`` / ``dense`` build new tensors.

Not ported yet (ROADMAP Queue 1 item 8, serving features): ``read_slot``,
``write_span``, ``snapshot_slot`` / ``restore_slot`` and
``gather_pages`` / ``scatter_pages`` / ``fork_pages`` -- chunked prefill,
session tiering and prefix sharing.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.layers.common import put_rows, take_rows, where_rows

LAYOUT_BK_PREFIX = "layout__"
PAGE_TABLE = LAYOUT_BK_PREFIX + "page_table"

_QUANT_SUFFIXES = ("__q", "__scale")


def _base_name(field: str) -> str:
    for suffix in _QUANT_SUFFIXES:
        if field.endswith(suffix):
            return field[: -len(suffix)]
    return field


# ---------------------------------------------------------------------------
# Spec (user-facing knob) and binding
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayoutSpec:
    """User-facing layout choice, before shapes are known.

    kind: "dense" | "paged" | "int8" | "paged_int8".  page_size: tokens
    per page.  pool_pages: pages in the shared pool; None = the full
    ``slots * pages_per_slot`` (needed by the uniform-batch prefill); a
    smaller pool needs the scheduler's page allocator.
    """

    kind: str = "dense"
    page_size: int = 64
    pool_pages: Optional[int] = None

    def __post_init__(self):
        if self.kind not in ("dense", "paged", "int8", "paged_int8"):
            raise ValueError(f"unknown cache layout kind: {self.kind!r}")
        if self.page_size < 1:
            raise ValueError("page_size must be positive")
        if self.pool_pages is not None and self.pool_pages < 1:
            raise ValueError("pool_pages must be positive (or None for "
                             "the full slots * pages_per_slot pool)")


DENSE_SPEC = LayoutSpec()


def as_spec(layout) -> LayoutSpec:
    if layout is None:
        return DENSE_SPEC
    if isinstance(layout, LayoutSpec):
        return layout
    if isinstance(layout, str):
        return LayoutSpec(kind=layout)
    raise TypeError(f"layout must be LayoutSpec | str | None, got {layout!r}")


def bind_layout(spec: LayoutSpec, *, slots: int, max_len: int,
                length_axes: Dict[str, int], quant_fields: Tuple[str, ...],
                dtype: str) -> "DenseLayout":
    """Turn a shape-free spec into a bound layout instance."""
    spec = as_spec(spec)
    if spec.kind == "dense":
        return DenseLayout()
    if spec.kind == "int8":
        return QuantizedLayout(fields=tuple(sorted(quant_fields)),
                               dtype=dtype)
    pps = -(-max_len // spec.page_size)
    pool = slots * pps if spec.pool_pages is None else spec.pool_pages
    quant = tuple(sorted(quant_fields)) if spec.kind == "paged_int8" else ()
    return PagedLayout(page=spec.page_size, pool_pages=pool, max_len=max_len,
                       slots=slots, fields=tuple(sorted(length_axes.items())),
                       quant_fields=quant, dtype=dtype)


# ---------------------------------------------------------------------------
# int8 primitives
# ---------------------------------------------------------------------------


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-vector (last axis) int8 quantization: (int8 values,
    float32 scales with a trailing 1).  ``torch.round`` rounds half to
    even, as ``jnp.round`` does."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    return torch.round(xf / scale).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# KVView: per-field physical descriptors the decode step consumes
# ---------------------------------------------------------------------------


class FieldView:
    """Base class of the per-field cache views.

    After peeling the leading layer axes with :meth:`layer`, the LOGICAL
    field is (B, S, KV, D) -- batch axis 0, length axis 1 -- and token
    writes and attends are defined.  :meth:`dense` works at any level
    and is the oracle's escape hatch."""

    def layer(self, i: int) -> "FieldView":
        raise NotImplementedError

    def set_layer(self, i: int, sub: "FieldView") -> "FieldView":
        raise NotImplementedError

    def dense(self) -> torch.Tensor:
        raise NotImplementedError

    def write_token(self, pos: torch.Tensor, vec: torch.Tensor,
                    write: Optional[torch.Tensor] = None) -> "FieldView":
        """Write one (B, KV, D) vector at per-slot position ``pos`` (B,),
        IN PLACE, only in rows where ``write`` (B,) is True (other rows'
        entries are rewritten with their own values).  Per-layer level."""
        raise NotImplementedError

    def scatter_rows(self, idx: torch.Tensor, sel: torch.Tensor,
                     rows: torch.Tensor) -> "FieldView":
        """Write dense logical ``rows`` (k rows along the batch axis) into
        slots ``idx`` (k,), IN PLACE, only where ``sel`` (k,) is True --
        unselected slots come through bit-identical.  Stacked level."""
        raise NotImplementedError


def _put_selected(arr: torch.Tensor, idx: torch.Tensor, sel: torch.Tensor,
                  rows: torch.Tensor, axis: int) -> torch.Tensor:
    old = take_rows(arr, idx, axis)
    return put_rows(arr, idx, where_rows(sel, rows.to(arr.dtype), old, axis),
                    axis)


def _masked_put(arr: torch.Tensor, index: Tuple[torch.Tensor, ...],
                val: torch.Tensor, write: Optional[torch.Tensor]) -> None:
    """``arr[index] = val`` where ``write`` (B,) is True (leading dim of
    ``val``); elsewhere the old values are written back."""
    val = val.to(arr.dtype)
    if write is not None:
        w = write.reshape((-1,) + (1,) * (val.ndim - 1))
        val = torch.where(w, val, arr[index])
    arr[index] = val


@dataclasses.dataclass
class DenseView(FieldView):
    """Physical == logical: one dense tensor."""

    data: torch.Tensor
    batch_axis: int = 0

    def layer(self, i):
        return DenseView(self.data[i], max(0, self.batch_axis - 1))

    def set_layer(self, i, sub):
        dst = self.data[i]
        if sub.data.data_ptr() != dst.data_ptr():
            dst.copy_(sub.data)
        return self

    def dense(self):
        return self.data

    def write_token(self, pos, vec, write=None):
        rows = torch.arange(vec.shape[0], device=vec.device)
        _masked_put(self.data, (rows, pos.long()), vec, write)
        return self

    def scatter_rows(self, idx, sel, rows):
        _put_selected(self.data, idx, sel, rows, self.batch_axis)
        return self


@dataclasses.dataclass
class QuantView(FieldView):
    """int8 values + per-vector (last axis) float32 scales."""

    q: torch.Tensor
    scale: torch.Tensor
    batch_axis: int = 0
    dtype: str = "float32"

    def layer(self, i):
        return QuantView(self.q[i], self.scale[i],
                         max(0, self.batch_axis - 1), self.dtype)

    def set_layer(self, i, sub):
        for dst, src in ((self.q[i], sub.q), (self.scale[i], sub.scale)):
            if src.data_ptr() != dst.data_ptr():
                dst.copy_(src)
        return self

    def dense(self):
        return dequantize_int8(self.q, self.scale, _dtype(self.dtype))

    def write_token(self, pos, vec, write=None):
        rows = torch.arange(vec.shape[0], device=vec.device)
        qv, sv = quantize_int8(vec)
        _masked_put(self.q, (rows, pos.long()), qv, write)
        _masked_put(self.scale, (rows, pos.long()), sv, write)
        return self

    def scatter_rows(self, idx, sel, rows):
        qr, sr = quantize_int8(rows)
        _put_selected(self.q, idx, sel, qr, self.batch_axis)
        _put_selected(self.scale, idx, sel, sr, self.batch_axis)
        return self


@dataclasses.dataclass
class PagedView(FieldView):
    """A length-axis field as a shared page pool + per-slot page table.

    ``storage`` is the pool in its element representation: a
    :class:`DenseView` (float pool ``(..., pool + 1, page, KV, D)``) or a
    :class:`QuantView` (int8 pool + float32 scale pool).  ``lead`` counts
    the leading layer axes still stacked on the pool; the page table
    (B, pages_per_slot) is shared across them.  The decode step hands
    the pool and the table to K3 (``repro_torch.kernels.ops.paged_decode``).
    """

    storage: FieldView
    page_table: torch.Tensor
    page: int = 0
    max_len: int = 0
    trash: int = 0
    lead: int = 0

    @property
    def pages_per_slot(self) -> int:
        return self.page_table.shape[-1]

    @property
    def quant(self) -> bool:
        return isinstance(self.storage, QuantView)

    def pools(self) -> Tuple[torch.Tensor, ...]:
        if self.quant:
            return (self.storage.q, self.storage.scale)
        return (self.storage.data,)

    def _rebuild(self, pools, lead: int) -> "PagedView":
        if self.quant:
            st: FieldView = QuantView(pools[0], pools[1],
                                      self.storage.batch_axis,
                                      self.storage.dtype)
        else:
            st = DenseView(pools[0], self.storage.batch_axis)
        return PagedView(st, self.page_table, self.page, self.max_len,
                         self.trash, lead)

    def layer(self, i):
        return self._rebuild(tuple(p[i] for p in self.pools()),
                             self.lead - 1)

    def set_layer(self, i, sub):
        for dst, src in zip((p[i] for p in self.pools()), sub.pools()):
            if src.data_ptr() != dst.data_ptr():
                dst.copy_(src)
        return self

    def dense(self):
        """Gather pages into the dense logical tensor -- ORACLE only
        (exactly the densification the kernels avoid)."""
        la = self.lead + 1
        B, pps = self.page_table.shape
        out = []
        for p in self.pools():
            g = p.index_select(self.lead, self.page_table.reshape(-1).long())
            g = g.reshape(p.shape[:self.lead] + (B, pps * self.page)
                          + p.shape[la + 1:])
            out.append(g.narrow(la, 0, self.max_len))
        if self.quant:
            return dequantize_int8(out[0], out[1],
                                   _dtype(self.storage.dtype))
        return out[0]

    def _to_pages(self, x: torch.Tensor, la: int) -> torch.Tensor:
        """(..., k, L, rest) -> (..., k, pps, page, rest), zero-padded."""
        return _to_pages(x, la, self.pages_per_slot, self.page)

    def write_token(self, pos, vec, write=None):
        """Append through the page table: physical page ``pt[b, pos //
        page]``, offset ``pos % page`` -- only the owning page is
        touched."""
        assert self.lead == 0, "write_token needs a per-layer view"
        rows = torch.arange(vec.shape[0], device=vec.device)
        pos = pos.long()
        pidx = self.page_table[rows, pos // self.page].long()
        off = pos % self.page
        parts = quantize_int8(vec) if self.quant else (vec,)
        for pool, val in zip(self.pools(), parts):
            _masked_put(pool, (pidx, off), val, write)
        return self

    def scatter_rows(self, idx, sel, rows):
        """Write k dense logical rows through the rows' own pages (page-
        map surgery: other slots' pages are never touched)."""
        la = self.lead + 1                     # length axis at this level
        pt_rows = self.page_table.index_select(0, idx).long()    # (k, pps)
        parts = quantize_int8(rows) if self.quant else (rows,)
        ix = (slice(None),) * self.lead + (pt_rows,)
        for pool, vals in zip(self.pools(), parts):
            pages = self._to_pages(vals.to(pool.dtype), la)
            pool[ix] = where_rows(sel, pages, pool[ix], self.lead)
        return self


def _to_pages(x: torch.Tensor, la: int, pps: int, page: int
              ) -> torch.Tensor:
    pad = pps * page - x.shape[la]
    if pad:
        shape = list(x.shape)
        shape[la] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim=la)
    return x.reshape(x.shape[:la] + (pps, page) + x.shape[la + 1:])


def absorb_views(views: Dict[str, FieldView]) -> Dict[str, torch.Tensor]:
    """Inverse of ``layout.view``: unwrap views back into the physical
    ``DecodeState.kv`` dict (pure unwrapping: views alias the buffers)."""
    kv: Dict[str, torch.Tensor] = {}
    for f, v in views.items():
        st = v.storage if isinstance(v, PagedView) else v
        if isinstance(st, QuantView):
            kv[f + "__q"], kv[f + "__scale"] = st.q, st.scale
        else:
            kv[f] = st.data
    return kv


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _paged_assigned_bytes(v: PagedView) -> int:
    """Bytes of the unique assigned pages of one paged field (+ scale
    pages).  Host-side: reads the page table."""
    pt = v.page_table.cpu().numpy()
    assigned = int(np.sum(np.unique(pt) != v.trash))
    total = 0
    for pool in v.pools():
        per_page = int(np.prod(pool.shape[v.lead + 1:])) * \
            pool.element_size()
        lead = int(np.prod(pool.shape[:v.lead], dtype=np.int64)) \
            if v.lead else 1
        total += lead * assigned * per_page
    return total


def _view_bytes(v: FieldView) -> int:
    children = (v.q, v.scale) if isinstance(v, QuantView) else (v.data,)
    return sum(_nbytes(c) for c in children)


def view_touched_bytes(views: Dict[str, FieldView]) -> int:
    """Device bytes a layout-native decode step touches: assigned pages
    (+ scale pages + the table) for paged fields, the physical buffers
    for the rest.  Host-side accounting (reads the page table)."""
    total = 0
    for v in views.values():
        if isinstance(v, PagedView):
            total += _paged_assigned_bytes(v) + _nbytes(v.page_table)
        else:
            total += _view_bytes(v)
    return total


def assigned_kv_bytes(views: Dict[str, FieldView]) -> int:
    """KV bytes referenced by the live page tables: paged fields count
    their unique assigned pages, the other fields their physical
    buffers."""
    return sum(_paged_assigned_bytes(v) if isinstance(v, PagedView)
               else _view_bytes(v) for v in views.values())


def field_length(view: FieldView) -> int:
    """The logical length of a length-axis field's view at any level: a
    paged view's ``max_len``, else the axis after the batch axis."""
    if isinstance(view, PagedView):
        return view.max_len
    data = view.q if isinstance(view, QuantView) else view.data
    return data.shape[view.batch_axis + 1]


# ---------------------------------------------------------------------------
# Dense (base: pack-through + per-field slot surgery)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DenseLayout:
    """Physical == logical.  Also the base class with the per-field slot
    surgery the other layouts use for their pass-through fields."""

    name = "dense"

    def pack(self, dense: Dict[str, Any], bk: Dict[str, Any],
             axes: Dict[str, int]) -> Dict[str, Any]:
        return dict(dense)

    def unpack(self, kv: Dict[str, Any], bk: Dict[str, Any],
               axes: Dict[str, int]) -> Dict[str, Any]:
        return dict(kv)

    def view(self, kv: Dict[str, Any], bk: Dict[str, Any],
             axes: Dict[str, int]) -> Dict[str, FieldView]:
        return {f: DenseView(v, axes[f]) for f, v in kv.items()}

    def init_bookkeeping(self, slots: int, device: Any = None
                         ) -> Dict[str, Any]:
        return {}

    def bookkeeping_axes(self) -> Dict[str, int]:
        return {}

    def _axis(self, field: str, axes: Dict[str, int]) -> int:
        return axes[_base_name(field)]

    def where_rows(self, rows: torch.Tensor, new_kv: Dict[str, Any],
                   old_kv: Dict[str, Any], bk: Dict[str, Any],
                   axes: Dict[str, int]) -> Dict[str, Any]:
        return {f: where_rows(rows, new_kv[f], old_kv[f],
                              self._axis(f, axes)) for f in new_kv}

    def write_slot(self, kv: Dict[str, Any], bk: Dict[str, Any], slot: int,
                   dense_row: Dict[str, Any], axes: Dict[str, int]
                   ) -> Dict[str, Any]:
        """Scatter a 1-slot dense row into physical slot ``slot``, IN
        PLACE.  Returns ``kv``."""
        packed = self.pack(dense_row, bk, axes)
        for f, dst in kv.items():
            ax = self._axis(f, axes)
            dst.select(ax, slot).copy_(packed[f].select(ax, 0))
        return kv


# ---------------------------------------------------------------------------
# int8 with per-vector scales
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QuantizedLayout(DenseLayout):
    """int8 KV + float32 per-vector scales (``f`` -> ``f__q`` /
    ``f__scale``).  The decode step reads the int8 buffers through a
    :class:`QuantView`; K1's int8 variant dequantises inside its QK and
    PV loops."""

    fields: Tuple[str, ...] = ()
    dtype: str = "float32"
    name = "int8"

    def pack(self, dense, bk, axes):
        out = {}
        for f, v in dense.items():
            if f in self.fields:
                out[f + "__q"], out[f + "__scale"] = quantize_int8(v)
            else:
                out[f] = v
        return out

    def unpack(self, kv, bk, axes):
        out = {}
        for f, v in kv.items():
            if f.endswith("__q"):
                base = f[:-3]
                out[base] = dequantize_int8(v, kv[base + "__scale"],
                                            _dtype(self.dtype))
            elif not f.endswith("__scale"):
                out[f] = v
        return out

    def view(self, kv, bk, axes):
        out: Dict[str, FieldView] = {}
        for f, v in kv.items():
            if f.endswith("__q"):
                base = f[:-3]
                out[base] = QuantView(v, kv[base + "__scale"], axes[base],
                                      self.dtype)
            elif not f.endswith("__scale"):
                out[f] = DenseView(v, axes[f])
        return out


# ---------------------------------------------------------------------------
# Paged (optionally with int8 pages: the "paged_int8" composition)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PagedLayout(DenseLayout):
    """Length-axis KV buffers as fixed-size pages in a shared pool.

    A paged field's dense (..., B, max_len, ...) buffer becomes a
    physical (..., pool_pages + 1, page, ...) pool; the last page is
    TRASH.  One int32 page table ``layout__page_table`` (slots,
    pages_per_slot) in bookkeeping is shared by all paged fields.  With
    ``quant_fields`` (paged_int8) those fields are quantized first; the
    ones with a length axis are then paged (int8 pages + a scale pool),
    the others stay dense int8 + scales as in :class:`QuantizedLayout`.
    A paged field's batch axis must immediately precede its length
    axis.  Fields absent from the cache (``hist_k`` in pure-tconst mode)
    are skipped: the layout is then a no-op for caches already O(1).
    """

    page: int = 64
    pool_pages: int = 0
    max_len: int = 0
    slots: int = 0
    fields: Tuple[Tuple[str, int], ...] = ()
    quant_fields: Tuple[str, ...] = ()
    dtype: str = "float32"

    @property
    def name(self) -> str:                             # type: ignore[override]
        return "paged_int8" if self.quant_fields else "paged"

    @property
    def pages_per_slot(self) -> int:
        return -(-self.max_len // self.page)

    @property
    def trash(self) -> int:
        return self.pool_pages

    @property
    def preallocated(self) -> bool:
        """Full pool: the identity page table works with no allocator."""
        return self.pool_pages >= self.slots * self.pages_per_slot

    def _length_axis(self, field: str) -> Optional[int]:
        base = _base_name(field)
        for f, la in self.fields:
            if f == base:
                return la
        return None

    def pages_anything(self, kv_keys) -> bool:
        """True if any physical kv field is actually stored in pages."""
        return any(self._length_axis(f) is not None for f in kv_keys)

    def _quant_pack(self, dense: Dict[str, Any]) -> Dict[str, Any]:
        out = {}
        for f, v in dense.items():
            if f in self.quant_fields:
                out[f + "__q"], out[f + "__scale"] = quantize_int8(v)
            else:
                out[f] = v
        return out

    def init_bookkeeping(self, slots, device=None):
        pps = self.pages_per_slot
        if self.preallocated:
            pt = torch.arange(slots * pps, dtype=torch.int32,
                              device=device).reshape(slots, pps)
        else:
            pt = torch.full((slots, pps), self.trash, dtype=torch.int32,
                            device=device)
        return {PAGE_TABLE: pt}

    def bookkeeping_axes(self):
        return {PAGE_TABLE: 0}

    def pack(self, dense, bk, axes):
        pt = bk[PAGE_TABLE].long()
        out = {}
        for f, v in self._quant_pack(dense).items():
            la = self._length_axis(f)
            if la is None:
                out[f] = v
                continue
            assert self._axis(f, axes) == la - 1, (f, axes, la)
            pages = _to_pages(v, la, self.pages_per_slot, self.page)
            pool = v.new_zeros(v.shape[:la - 1] + (self.pool_pages + 1,
                                                   self.page)
                               + v.shape[la + 1:])
            pool[(slice(None),) * (la - 1) + (pt,)] = pages
            out[f] = pool
        return out

    def unpack(self, kv, bk, axes):
        pt = bk[PAGE_TABLE].long()
        B, pps = pt.shape
        staged = {}
        for f, v in kv.items():
            la = self._length_axis(f)
            if la is None:
                staged[f] = v
                continue
            g = v.index_select(la - 1, pt.reshape(-1))
            g = g.reshape(v.shape[:la - 1] + (B, pps * self.page)
                          + v.shape[la + 1:])
            staged[f] = g.narrow(la, 0, self.max_len)
        out = {}
        for f, v in staged.items():
            if f.endswith("__q"):
                out[f[:-3]] = dequantize_int8(v, staged[f[:-3] + "__scale"],
                                              _dtype(self.dtype))
            elif not f.endswith("__scale"):
                out[f] = v
        return out

    def view(self, kv, bk, axes):
        pt = bk[PAGE_TABLE]
        out: Dict[str, FieldView] = {}
        for f, v in kv.items():
            if f.endswith("__scale"):
                continue
            base = _base_name(f)
            if f.endswith("__q"):
                storage: FieldView = QuantView(v, kv[base + "__scale"],
                                               axes[base], self.dtype)
            else:
                storage = DenseView(v, axes[f])
            la = self._length_axis(f)
            if la is None:
                out[base] = storage
            else:
                out[base] = PagedView(storage, pt, self.page, self.max_len,
                                      self.trash, lead=la - 1)
        return out

    def where_rows(self, rows, new_kv, old_kv, bk, axes):
        pt = bk[PAGE_TABLE].long()
        # slot mask -> page mask over the pool (real pages are uniquely
        # owned; the trash page's pick is arbitrary and its content dead)
        page_rows = torch.zeros((self.pool_pages + 1,), dtype=torch.bool,
                                device=rows.device)
        page_rows[pt] = rows[:, None].expand(pt.shape)
        out = {}
        for f in new_kv:
            la = self._length_axis(f)
            if la is None:
                out[f] = where_rows(rows, new_kv[f], old_kv[f],
                                    self._axis(f, axes))
            else:
                out[f] = where_rows(page_rows, new_kv[f], old_kv[f], la - 1)
        return out

    def write_slot(self, kv, bk, slot, dense_row, axes):
        """Page-map surgery, IN PLACE: only the slot's own pages (its
        table row) are written; entries at TRASH take dead writes."""
        pt_row = bk[PAGE_TABLE][slot].long()                  # (pps,)
        packed = self._quant_pack(dense_row)
        for f, dst in kv.items():
            la = self._length_axis(f)
            src = packed[f].to(dst.dtype)
            if la is None:
                ax = self._axis(f, axes)
                dst.select(ax, slot).copy_(src.select(ax, 0))
                continue
            pages = _to_pages(src, la, self.pages_per_slot, self.page)
            dst[(slice(None),) * (la - 1) + (pt_row,)] = \
                pages.select(la - 1, 0)
        return kv
