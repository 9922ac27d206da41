"""flax's msgpack state-dict format, written and read without flax or msgpack.

The JAX package writes its weights and checkpoints with
``flax.serialization.to_bytes`` (``save_weights``, ``save_checkpoint``, the
CLIs' ``{model}_best.weights`` and ``{model}_weights.bin``).  This module
carries its own codec of the subset that ``to_bytes`` writes, so the port
reads those files on a machine that has neither package:

* nil, bool, int, float32 and float64, str, bin, array and map;
* ext 1, an ndarray: the msgpack triple (shape, dtype name, C-order bytes)
  (``flax/serialization.py`` ``_ndarray_to_bytes``); ext 3, a numpy scalar,
  packed the same way.  ``bfloat16`` has no numpy dtype here: it is read as
  a ``torch.bfloat16`` tensor over the bytes' ``uint16`` view, and a bf16
  tensor is written under that name;
* an array of more than :data:`MAX_CHUNK_SIZE` bytes as flax's
  ``{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks":
  {"0": ..., ...}}`` (``_chunk`` / ``_unchunk``): a 104M-row table at dim 10
  is 4.2 GB, past msgpack's 4 GB object limit.

Ext 2 (a complex number) and any other extension are refused.
:func:`to_bytes` writes the bytes ``flax.serialization.to_bytes`` writes for
the same tree: a tuple or list is the ``{"0": ...}`` dict of
``flax.serialization.to_state_dict``, dict keys are ``str``-ed and keep their
order.  :func:`restore_file` reads a file through ``mmap``: every array that
is not chunked is an ``np.frombuffer`` view of the mapping (read-only), so a
multi-GB file is not held twice in host memory.
"""

from __future__ import annotations

import mmap
import struct
from typing import Any, List

import numpy as np
import torch

# flax's limit (its ``MAX_CHUNK_SIZE``): a test may lower it
MAX_CHUNK_SIZE = 2**30
CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


def is_msgpack_map(head: bytes) -> bool:
    """Whether a file's first byte opens a msgpack map, as every file that
    ``to_bytes`` writes of a dict does (fixmap, map16, map32)."""
    return len(head) > 0 and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))


# ------------------------------------------------------------------ writing


def _int(v: int, out: List) -> None:
    """msgpack-python's integer forms: the smallest that holds ``v``."""
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        out.append(struct.pack("b" if v < 0 else "B", v))
    elif 0 <= v <= 0xFF:
        out.append(struct.pack("BB", 0xCC, v))
    elif -0x80 <= v < 0:
        out.append(struct.pack(">Bb", 0xD0, v))
    elif 0 <= v <= 0xFFFF:
        out.append(struct.pack(">BH", 0xCD, v))
    elif -0x8000 <= v < 0:
        out.append(struct.pack(">Bh", 0xD1, v))
    elif 0 <= v <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xCE, v))
    elif -0x80000000 <= v < 0:
        out.append(struct.pack(">Bi", 0xD2, v))
    elif 0 <= v <= 0xFFFFFFFFFFFFFFFF:
        out.append(struct.pack(">BQ", 0xCF, v))
    elif -0x8000000000000000 <= v < 0:
        out.append(struct.pack(">Bq", 0xD3, v))
    else:
        raise OverflowError(f"integer {v} does not fit msgpack's 64 bits")


def _header(n: int, fix: int, fix_max: int, codes, out: List) -> None:
    """A str, bin, array or map header: ``fix | n`` below ``fix_max``, else
    the 8-, 16- or 32-bit length form (``codes``, None where absent)."""
    if fix is not None and n < fix_max:
        out.append(bytes([fix | n]))
        return
    for code, fmt, limit in zip(codes, (">BB", ">BH", ">BI"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            out.append(struct.pack(fmt, code, n))
            return
    raise ValueError(f"an object of {n} entries or bytes is past msgpack's limit")


def _str(s: str, out: List) -> None:
    b = s.encode("utf-8")
    _header(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
    out.append(b)


def _bin(b, n: int, out: List) -> None:
    _header(n, None, 0, (0xC4, 0xC5, 0xC6), out)
    out.append(b)


def _array_parts(arr) -> tuple:
    """(shape, dtype name, a C-order buffer, its byte count) of an array
    leaf: an ndarray, or a tensor (moved to the host; bf16 as its ``uint16``
    bits under the name ``bfloat16``)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return tuple(t.shape), "bfloat16", t.view(torch.int16).numpy(), t.numel() * 2
        arr = t.numpy()
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError(f"dtype {arr.dtype} cannot be written: only plain arrays")
    arr = np.asarray(arr, order="C")  # keeps a 0-d array 0-d
    return arr.shape, arr.dtype.name, arr, arr.nbytes


def _ext_array(code: int, arr, out: List) -> None:
    """Ext ``code`` over msgpack's (shape, dtype name, bytes) triple."""
    shape, name, buf, nbytes = _array_parts(arr)
    inner: List = [b"\x93"]
    _header(len(shape), 0x90, 16, (None, 0xDC, 0xDD), inner)
    for d in shape:
        _int(int(d), inner)
    _str(name, inner)
    _header(nbytes, None, 0, (0xC4, 0xC5, 0xC6), inner)
    n = sum(len(p) for p in inner) + nbytes
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(bytes([fixed[n]]))
    elif n <= 0xFF:
        out.append(struct.pack(">BB", 0xC7, n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", 0xC8, n))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xC9, n))
    else:
        raise ValueError(f"an array of {nbytes} bytes is past msgpack's 4 GB: chunk it")
    out.append(struct.pack("b", code))
    out.extend(inner)
    out.append(memoryview(buf.reshape(-1).view(np.uint8)) if nbytes else b"")


def _nbytes(arr) -> int:
    return arr.numel() * arr.element_size() if isinstance(arr, torch.Tensor) else arr.nbytes


def _chunk(arr) -> dict:
    """flax's ``_chunk``: the flat array in pieces of MAX_CHUNK_SIZE bytes."""
    itemsize = arr.element_size() if isinstance(arr, torch.Tensor) else arr.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = arr.reshape(-1)
    n = flat.numel() if isinstance(arr, torch.Tensor) else flat.size
    return {CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[lo : lo + size] for i, lo in enumerate(range(0, n, size))}}


def _pack(obj, out: List) -> None:
    if isinstance(obj, np.generic):  # before float: np.float64 is one
        _ext_array(_EXT_NPSCALAR, np.asarray(obj), out)
    elif obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _int(obj, out)
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        _str(obj, out)
    elif isinstance(obj, (bytes, bytearray)):
        _bin(bytes(obj), len(obj), out)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        if _nbytes(obj) > MAX_CHUNK_SIZE:
            _pack(_chunk(obj), out)
        else:
            _ext_array(_EXT_NDARRAY, obj, out)
    elif isinstance(obj, dict):
        _header(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _str(str(k), out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):  # to_state_dict's {"0": ...}
        _pack({str(i): v for i, v in enumerate(obj)}, out)
    elif isinstance(obj, complex):
        raise ValueError("a complex leaf (msgpack ext 2) is not supported")
    else:
        raise TypeError(f"cannot serialize a {type(obj).__name__}")


def _parts(tree) -> List:
    out: List = []
    _pack(tree, out)
    return out


def msgpack_serialize(tree) -> bytes:
    """``flax.serialization.msgpack_serialize``: ``tree`` (dicts, lists and
    tuples of arrays, tensors and Python scalars) as msgpack bytes, an array
    over MAX_CHUNK_SIZE bytes split into chunks."""
    return b"".join(_parts(tree))


def to_bytes(tree) -> bytes:
    """``flax.serialization.to_bytes`` of a tree of dicts (a tuple or list
    becomes its ``{"0": ...}`` dict): e.g. ``to_bytes(model.get_weights())``
    is a file that the JAX package's ``load_weights`` reads."""
    return msgpack_serialize(tree)


def save_file(path, tree) -> None:
    """Write ``to_bytes(tree)`` to ``path`` piece by piece (no copy of the
    arrays is joined in memory)."""
    with open(path, "wb") as f:
        for part in _parts(tree):
            f.write(part)


# ------------------------------------------------------------------ reading


# type byte -> struct format: the fixed-size scalars, the length of a str,
# bin, array, map or ext, and the fixext sizes
_SCALARS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i",
            0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
_LENGTHS = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xDC: ">H",
            0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    """A msgpack decoder over a buffer (bytes, or a memoryview of a
    mapping); arrays are views of it."""

    def __init__(self, buf):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        lo = self.pos
        if lo + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        self.pos = lo + n
        return self.buf[lo : lo + n]

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self._unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self._take(b & 0x1F), "utf-8")
        if b in _SCALARS:
            v = self._unpack(_SCALARS[b])
            return float(v) if b in (0xCA, 0xCB) else v
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXEXT:
            return self._ext(_FIXEXT[b])
        if b not in _LENGTHS:
            raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")
        n = self._unpack(_LENGTHS[b])
        if b in (0xD9, 0xDA, 0xDB):
            return str(self._take(n), "utf-8")
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self._take(n))
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self._map(n)
        return self._ext(n)

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, n: int):
        code = self._unpack("b")
        end = self.pos + n
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            what = "a complex number (ext 2)" if code == _EXT_COMPLEX else f"ext type {code}"
            raise ValueError(f"the file holds {what}, which flax weights never hold")
        # the (shape, dtype name, bytes) triple; the bytes stay a view
        if self._unpack("B") != 0x93:
            raise ValueError("malformed ndarray extension")
        shape, name = self.read(), self.read()
        b = self._unpack("B")
        if b not in (0xC4, 0xC5, 0xC6):
            raise ValueError("malformed ndarray extension")
        data = self._take(self._unpack(_LENGTHS[b]))
        if self.pos != end:
            raise ValueError("malformed ndarray extension")
        arr = _array(data, name, tuple(shape))
        return arr[()] if code == _EXT_NPSCALAR and isinstance(arr, np.ndarray) else arr


def _array(data: memoryview, name: str, shape: tuple):
    if name == "bfloat16":
        bits = np.frombuffer(data, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(data, dtype=np.dtype(name)).reshape(shape)


def _join(chunks):
    parts = [chunks[str(i)] for i in range(len(chunks))]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts)
    return np.concatenate(parts)


def _unchunk(tree):
    """flax's ``_unchunk_array_leaves_in_place``: chunked leaves joined."""
    if isinstance(tree, dict):
        if tree.get(CHUNKED) is True:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            return _join(tree["chunks"]).reshape(shape)
        for k, v in tree.items():
            tree[k] = _unchunk(v)
    return tree


def msgpack_restore(data):
    """``flax.serialization.msgpack_restore``: the tree of ``data`` (bytes
    or any buffer), arrays as numpy (views of ``data``), chunked arrays
    joined, a bf16 array as a ``torch.bfloat16`` tensor."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes follow the msgpack object")
    return _unchunk(tree)


def restore_file(path):
    """:func:`msgpack_restore` of a file through ``mmap``: the arrays are
    read-only views of the mapping, which lives as long as they do."""
    with open(path, "rb") as f:
        mapped = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    return msgpack_restore(mapped)
