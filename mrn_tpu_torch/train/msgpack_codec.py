"""A pure-Python reader and writer for the msgpack subset that
``flax.serialization.msgpack_serialize`` and ``msgpack_restore`` use, so the
port opens and writes the JAX package's checkpoint files without ``flax``
or ``msgpack``.

What a tree may hold: dicts with str keys (written with their keys sorted,
as flax's ``jax.tree_util.tree_map`` copy sorts them), lists, str, bytes,
int, float (always float64), bool, None, complex (ext 2), numpy arrays and
torch tensors (ext 1), numpy scalars (ext 3).  Types are checked exactly, as
msgpack's ``strict_types=True`` does: a ``np.float64`` is a Python ``float``
subclass but is written as an ext-3 scalar, a ``bool`` is not an ``int``,
and a tuple is refused.  Each form is the smallest msgpack-python picks, so
the bytes equal flax's for the same tree.

An array's ext payload is itself msgpack: ``(shape, dtype name, C-order
bytes)``.  Arrays above ``MAX_CHUNK_SIZE`` bytes that sit at the top or
under dicts are split, as flax splits them, into
``{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks":
{"0": ...}}``.

``bfloat16`` needs ``ml_dtypes`` in numpy, which the port does not assume:
such leaves are read as ``torch.bfloat16`` tensors, and a ``torch.bfloat16``
tensor (or a numpy ``bfloat16`` array, where numpy has one) is written with
the dtype name ``bfloat16``.  Every other array is read as a numpy array.
"""

from __future__ import annotations

import struct
from typing import Any, List

import numpy as np
import torch

__all__ = ["MAX_CHUNK_SIZE", "msgpack_restore", "msgpack_serialize"]

# flax's limit per leaf (msgpack caps one object at 2**31 - 1 bytes)
MAX_CHUNK_SIZE = 2 ** 30

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Array:
    """An array leaf on its way out: C-order data (bfloat16 as a uint16
    view) and the dtype name written beside it."""

    __slots__ = ("data", "name")

    def __init__(self, data: np.ndarray, name: str):
        self.data, self.name = data, name

    @property
    def nbytes(self) -> int:
        return self.data.size * self.data.dtype.itemsize


def _array(x) -> _Array:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return _Array(t.contiguous().view(torch.uint16).numpy(), "bfloat16")
        x = t.numpy()
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serializable")
    return _Array(x, x.dtype.name)


# ------------------------------------------------------------------ writer
def _canonical(x):
    """A copy of the tree with every dict's keys sorted and every array leaf
    an ``_Array`` (flax's ``tree_map`` copy, then ``_np_convert_in_place``)."""
    if type(x) is dict:
        return {k: _canonical(x[k]) for k in sorted(x)}
    if type(x) is list:
        return [_canonical(v) for v in x]
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return _array(x)
    return x


def _chunk(arr: _Array) -> dict:
    flat = arr.data.reshape(-1)
    size = max(1, int(MAX_CHUNK_SIZE / flat.dtype.itemsize))
    chunks = [_Array(flat[i:i + size], arr.name) for i in range(0, flat.size, size)]
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(arr.data.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _chunk_leaves(x):
    """flax's ``_chunk_array_leaves_in_place``: arrays at the top or under
    dicts (not under lists) above ``MAX_CHUNK_SIZE`` bytes."""
    if isinstance(x, dict):
        for k, v in x.items():
            if isinstance(v, (dict, _Array)):
                x[k] = _chunk_leaves(v)
        return x
    if isinstance(x, _Array) and x.nbytes > MAX_CHUNK_SIZE:
        return _chunk(x)
    return x


def _head(out: List[bytes], n: int, small: int, small_max: int, codes) -> None:
    """A length-prefixed header: ``small | n`` below ``small_max`` (when the
    format has a fix form), else the 8/16/32-bit form of ``codes``."""
    if small is not None and n < small_max:
        out.append(bytes((small | n,)))
    elif codes[0] is not None and n < 0x100:
        out.append(bytes((codes[0], n)))
    elif n < 0x10000:
        out.append(bytes((codes[1],)) + struct.pack(">H", n))
    elif n < 0x100000000:
        out.append(bytes((codes[2],)) + struct.pack(">I", n))
    else:
        raise ValueError(f"msgpack object of length {n} is too large")


def _pack_int(n: int, out: List[bytes]) -> None:
    if 0 <= n < 0x80:
        out.append(bytes((n,)))
    elif -0x20 <= n < 0:
        out.append(struct.pack(">b", n))
    elif 0 < n <= 0xFF:
        out.append(b"\xcc" + struct.pack(">B", n))
    elif -0x80 <= n < 0:
        out.append(b"\xd0" + struct.pack(">b", n))
    elif 0 < n <= 0xFFFF:
        out.append(b"\xcd" + struct.pack(">H", n))
    elif -0x8000 <= n < 0:
        out.append(b"\xd1" + struct.pack(">h", n))
    elif 0 < n <= 0xFFFFFFFF:
        out.append(b"\xce" + struct.pack(">I", n))
    elif -0x80000000 <= n < 0:
        out.append(b"\xd2" + struct.pack(">i", n))
    elif 0 < n <= 0xFFFFFFFFFFFFFFFF:
        out.append(b"\xcf" + struct.pack(">Q", n))
    elif -0x8000000000000000 <= n < 0:
        out.append(b"\xd3" + struct.pack(">q", n))
    else:
        raise OverflowError(f"integer {n} does not fit msgpack's 64 bits")


def _pack_str(s: str, out: List[bytes]) -> None:
    b = s.encode("utf-8")
    _head(out, len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB))
    out.append(b)


def _pack_bin(b, out: List[bytes]) -> None:
    _head(out, len(b), None, 0, (0xC4, 0xC5, 0xC6))
    out.append(bytes(b))


def _pack_ext(code: int, data: bytes, out: List[bytes]) -> None:
    n = len(data)
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(n)
    if fix is not None:
        out.append(bytes((fix, code)))
    else:
        _head(out, n, None, 0, (0xC7, 0xC8, 0xC9))
        out.append(bytes((code,)))
    out.append(data)


def _array_payload(data: np.ndarray, name: str) -> bytes:
    """``msgpack.packb((shape, dtype name, C-order bytes), use_bin_type=True)``."""
    out: List[bytes] = []
    _head(out, 3, 0x90, 16, (None, 0xDC, 0xDD))
    _head(out, data.ndim, 0x90, 16, (None, 0xDC, 0xDD))
    for d in data.shape:
        _pack_int(int(d), out)
    _pack_str(name, out)
    _pack_bin(data.tobytes("C"), out)
    return b"".join(out)


def _pack(x, out: List[bytes]) -> None:
    t = type(x)
    if x is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if x else b"\xc2")
    elif t is int:
        _pack_int(x, out)
    elif t is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif t is bytes or t is bytearray:
        _pack_bin(x, out)
    elif t is str:
        _pack_str(x, out)
    elif t is list:
        _head(out, len(x), 0x90, 16, (None, 0xDC, 0xDD))
        for v in x:
            _pack(v, out)
    elif t is dict:
        _head(out, len(x), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif t is _Array:
        _pack_ext(_EXT_NDARRAY, _array_payload(x.data, x.name), out)
    elif isinstance(x, np.generic):
        arr = np.asarray(x)
        _pack_ext(_EXT_NPSCALAR, _array_payload(arr, arr.dtype.name), out)
    elif t is complex:
        payload: List[bytes] = [b"\x92"]
        _pack(x.real, payload)
        _pack(x.imag, payload)
        _pack_ext(_EXT_COMPLEX, b"".join(payload), out)
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def msgpack_serialize(tree: Any) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize(tree)`` gives.  The
    tree is not modified."""
    out: List[bytes] = []
    _pack(_chunk_leaves(_canonical(tree)), out)
    return b"".join(out)


# ------------------------------------------------------------------ reader
_CONSTANTS = {0xC0: None, 0xC2: False, 0xC3: True}
_SIZED = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",        # bin 8/16/32
          0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}        # str 8/16/32
_EXT_SIZES = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}    # ext 8/16/32
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_CONTAINERS = {0xDC: (">H", False), 0xDD: (">I", False),  # array 16/32
               0xDE: (">H", True), 0xDF: (">I", True)}    # map 16/32


class _Reader:
    """``views``: bin objects come back as memoryviews of the data (an
    array payload's buffer, copied once into its array) instead of bytes."""

    def __init__(self, data, views: bool = False):
        self.buf = memoryview(data).cast("B")
        self.pos = 0
        self.views = views

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        view = self.buf[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b in _CONSTANTS:
            return _CONSTANTS[b]
        if b in _SIZED:
            raw = self.take(self.unpack(_SIZED[b]))
            if b > 0xC6:
                return str(raw, "utf-8")
            return raw if self.views else bytes(raw)
        if b in _EXT_SIZES:
            n = self.unpack(_EXT_SIZES[b])
            return self.ext(self.unpack(">b"), self.take(n))
        if 0xD4 <= b <= 0xD8:
            code = self.unpack(">b")
            return self.ext(code, self.take(1 << (b - 0xD4)))
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if b in _CONTAINERS:
            fmt, is_map = _CONTAINERS[b]
            n = self.unpack(fmt)
            return self.map(n) if is_map else self.array(n)
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def ext(self, code: int, data: memoryview):
        if code == _EXT_NDARRAY:
            return _array_from_payload(data)
        if code == _EXT_NPSCALAR:
            return _array_from_payload(data)[()]
        if code == _EXT_COMPLEX:
            real, imag = _Reader(data).read()
            return complex(real, imag)
        raise ValueError(f"msgpack ext type {code} is not supported")


def _array_from_payload(data: memoryview):
    shape, name, buf = _Reader(data, views=True).read()
    if name == "bfloat16":
        flat = torch.from_numpy(np.frombuffer(buf, np.uint16).copy())
        return flat.view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape).copy()


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(x):
    """flax's ``_unchunk_array_leaves_in_place``."""
    if isinstance(x, dict):
        if _CHUNKED in x:
            return _unchunk(x)
        for k, v in x.items():
            if isinstance(v, dict):
                x[k] = _unchunk_leaves(v)
    return x


def msgpack_restore(data) -> Any:
    """The tree ``flax.serialization.msgpack_restore(data)`` gives: arrays
    as numpy arrays (``bfloat16`` as ``torch.bfloat16`` tensors), numpy
    scalars as numpy scalars, lists as lists."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk_leaves(tree)
