"""Checkpoints in the JAX package's msgpack format (port of
``src/repro/training/checkpoint.py``).

A checkpoint is one msgpack map from each leaf's pytree path (dict keys
and list indices joined by ``/``) to ``{"dtype", "shape", "data"}``: the
numpy dtype name, the shape as a list of ints and the raw C-order bytes.
The train state is ``{"params": ..., "opt": {"step", "m", "v"}}`` in the
JAX tree layout, written as ``ckpt_{step:08d}.msgpack``.  A JAX
checkpoint restores into the port and the port's into JAX's
``restore_pytree``; leaves are written in JAX's flatten order, so the
same state gives the same bytes.

Neither ``jax`` nor ``msgpack`` is imported: the module carries its own
encoder and decoder for the subset of msgpack the format uses (maps,
arrays, str, bin and ints), producing the smallest encoding of each
value as ``msgpack.packb`` does.  bfloat16 leaves are stored under the
dtype name ``"bfloat16"`` (as ``ml_dtypes`` names it in JAX) and read
back through their 16-bit pattern.
"""
from __future__ import annotations

import os
import struct
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# msgpack subset
# ---------------------------------------------------------------------------


def packb(obj: Any) -> bytes:
    """msgpack bytes of ``obj`` (dict, list / tuple, str, bytes, int) in
    the smallest encoding of each value."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


def _head(n: int, fix: int, fix_max: int, codes: Tuple[int, ...],
          widths: Tuple[str, ...]) -> bytes:
    if fix >= 0 and n < fix_max:
        return bytes([fix | n])
    for code, w in zip(codes, widths):
        if n < 1 << (8 * struct.calcsize(w)):
            return bytes([code]) + struct.pack(">" + w, n)
    raise ValueError(f"msgpack length {n} too large")


def _pack(o: Any, out: List[bytes]) -> None:
    if isinstance(o, int) and not isinstance(o, bool):
        out.append(_pack_int(o))
    elif isinstance(o, str):
        b = o.encode("utf-8")
        out.append(_head(len(b), 0xa0, 32, (0xd9, 0xda, 0xdb),
                         ("B", "H", "I")))
        out.append(b)
    elif isinstance(o, (bytes, bytearray, memoryview)):
        b = bytes(o)
        out.append(_head(len(b), -1, 0, (0xc4, 0xc5, 0xc6),
                         ("B", "H", "I")))
        out.append(b)
    elif isinstance(o, (list, tuple)):
        out.append(_head(len(o), 0x90, 16, (0xdc, 0xdd), ("H", "I")))
        for x in o:
            _pack(x, out)
    elif isinstance(o, dict):
        out.append(_head(len(o), 0x80, 16, (0xde, 0xdf), ("H", "I")))
        for k, v in o.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack {type(o).__name__}")


def _pack_int(n: int) -> bytes:
    if 0 <= n < 128:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for code, w in ((0xcc, "B"), (0xcd, "H"), (0xce, "I"), (0xcf, "Q")):
            if n < 1 << (8 * struct.calcsize(w)):
                return bytes([code]) + struct.pack(">" + w, n)
    else:
        for code, w in ((0xd0, "b"), (0xd1, "h"), (0xd2, "i"), (0xd3, "q")):
            if n >= -(1 << (8 * struct.calcsize(w) - 1)):
                return bytes([code]) + struct.pack(">" + w, n)
    raise ValueError(f"msgpack int {n} out of range")


def unpackb(data: bytes) -> Any:
    """The value msgpack bytes encode (str as str, bin as bytes, arrays
    as lists): the subset :func:`packb` writes, in any of its widths;
    raises on any other type."""
    buf = memoryview(data)
    obj, end = _unpack(buf, 0)
    if end != len(buf):
        raise ValueError(f"msgpack: {len(buf) - end} trailing bytes")
    return obj


_INTS = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
         0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_LEN = {0xd9: ">B", 0xda: ">H", 0xdb: ">I", 0xc4: ">B", 0xc5: ">H",
        0xc6: ">I", 0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I"}


def _unpack(buf: memoryview, i: int) -> Tuple[Any, int]:
    c = buf[i]
    i += 1
    if c < 0x80:
        return c, i
    if c >= 0xe0:
        return c - 0x100, i
    if 0x80 <= c <= 0x8f:
        return _unpack_map(buf, i, c & 0x0f)
    if 0x90 <= c <= 0x9f:
        return _unpack_array(buf, i, c & 0x0f)
    if 0xa0 <= c <= 0xbf:
        n = c & 0x1f
        return str(buf[i:i + n], "utf-8"), i + n
    if c in _INTS:
        fmt = _INTS[c]
        return struct.unpack_from(fmt, buf, i)[0], i + struct.calcsize(fmt)
    if c in _LEN:
        fmt = _LEN[c]
        n = struct.unpack_from(fmt, buf, i)[0]
        i += struct.calcsize(fmt)
        if c in (0xd9, 0xda, 0xdb):
            return str(buf[i:i + n], "utf-8"), i + n
        if c in (0xc4, 0xc5, 0xc6):
            return bytes(buf[i:i + n]), i + n
        if c in (0xdc, 0xdd):
            return _unpack_array(buf, i, n)
        return _unpack_map(buf, i, n)
    raise ValueError(f"msgpack type byte 0x{c:02x} is not in the subset "
                     f"checkpoints use")


def _unpack_array(buf: memoryview, i: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        x, i = _unpack(buf, i)
        out.append(x)
    return out, i


def _unpack_map(buf: memoryview, i: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        v, i = _unpack(buf, i)
        out[k] = v
    return out, i


# ---------------------------------------------------------------------------
# pytrees of tensors
# ---------------------------------------------------------------------------


def _flatten_with_paths(tree: Any, prefix: str = ""
                        ) -> List[Tuple[str, Any]]:
    """(path, leaf) in JAX's flatten order: dict keys sorted, list indices
    in order, parts joined by ``/`` (``checkpoint._path_str``)."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), x) for i, x in enumerate(tree)]
    else:
        return [(prefix, tree)]
    return [x for k, v in items
            for x in _flatten_with_paths(v, f"{prefix}/{k}" if prefix
                                         else k)]


def _record(t: torch.Tensor) -> Dict[str, Any]:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        data, dtype = t.view(torch.int16).numpy().tobytes(), "bfloat16"
    else:
        arr = t.numpy()
        data, dtype = arr.tobytes(), str(arr.dtype)
    return {"dtype": dtype, "shape": list(t.shape), "data": data}


def _leaf(rec: Dict[str, Any], device: Any) -> torch.Tensor:
    if rec["dtype"] == "bfloat16":
        arr = np.frombuffer(rec["data"], dtype=np.int16)
        t = torch.from_numpy(arr.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.frombuffer(rec["data"],
                                           dtype=rec["dtype"]).copy())
    return t.reshape(rec["shape"]).to(device)


def save_pytree(tree: Any, path: str) -> None:
    """Write a tree of tensors (nested dicts / lists) to ``path``
    atomically (a temporary file, then a rename)."""
    blob = {p: _record(leaf) for p, leaf in _flatten_with_paths(tree)}
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(packb(blob))
    os.replace(tmp, path)


def restore_pytree(reference: Any, path: str) -> Any:
    """The tree stored at ``path``, in ``reference``'s structure (its
    leaves give each restored tensor's device; the dtype and shape are
    the stored ones)."""
    with open(path, "rb") as f:
        blob = unpackb(f.read())

    def go(ref, prefix):
        if isinstance(ref, dict):
            return {k: go(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in ref.items()}
        if isinstance(ref, (list, tuple)):
            return [go(v, f"{prefix}/{i}" if prefix else str(i))
                    for i, v in enumerate(ref)]
        return _leaf(blob[prefix], getattr(ref, "device", None))
    return go(reference, "")


def save_train_state(params: Any, opt_state: Any, step: int,
                     directory: str) -> str:
    """Write ``{"params", "opt"}`` as ``ckpt_{step:08d}.msgpack`` under
    ``directory``; returns the path."""
    path = os.path.join(directory, f"ckpt_{step:08d}.msgpack")
    save_pytree({"params": params, "opt": opt_state._asdict()
                 if hasattr(opt_state, "_asdict") else opt_state}, path)
    return path

