"""LMDB crop files without liblmdb (the port's copy of
``mrn_tpu/data/lmdb_store.py``): ``LmdbReader`` and ``LmdbWriter`` over the
native store ``native/lmdbx/lmdbx.cpp``, which both packages compile as it
is, so each reads the other's files and those of liblmdb tools.

The library is built with ``g++`` at first use into ``build/mrn_tpu_torch/``
(``data._host_build``); a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

from mrn_tpu_torch.data import _host_build

__all__ = ["LmdbReader", "LmdbWriter"]

SOURCE = _host_build.ROOT / "native" / "lmdbx" / "lmdbx.cpp"


def _lib() -> ctypes.CDLL:
    lib = _host_build.load("lmdbx", SOURCE)
    if not getattr(lib, "_typed", False):
        lib.lmdbx_open.restype = ctypes.c_void_p
        lib.lmdbx_open.argtypes = [ctypes.c_char_p]
        lib.lmdbx_entries.restype = ctypes.c_long
        lib.lmdbx_entries.argtypes = [ctypes.c_void_p]
        lib.lmdbx_get.restype = ctypes.c_int
        lib.lmdbx_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
                                  ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                                  ctypes.POINTER(ctypes.c_size_t)]
        lib.lmdbx_close.argtypes = [ctypes.c_void_p]
        lib.lmdbx_close.restype = None
        lib.lmdbx_writer_new.argtypes = []
        lib.lmdbx_writer_new.restype = ctypes.c_void_p
        lib.lmdbx_writer_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
                                         ctypes.c_char_p, ctypes.c_size_t]
        lib.lmdbx_writer_put.restype = None
        lib.lmdbx_writer_write.restype = ctypes.c_int
        lib.lmdbx_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
        lib.lmdbx_writer_free.argtypes = [ctypes.c_void_p]
        lib.lmdbx_writer_free.restype = None
        lib._typed = True
    return lib


class LmdbReader:
    """A read-only LMDB environment: ``get`` by key over the main
    database, ``len`` its entries."""

    def __init__(self, path: str):
        self._lib = _lib()
        self._env = self._lib.lmdbx_open(path.encode())
        if not self._env:
            raise IOError(f"cannot open lmdb at {path}")

    def __len__(self) -> int:
        return self._lib.lmdbx_entries(self._env)

    def get(self, key: bytes) -> Optional[bytes]:
        val = ctypes.POINTER(ctypes.c_uint8)()
        vlen = ctypes.c_size_t()
        if self._lib.lmdbx_get(self._env, key, len(key), ctypes.byref(val),
                               ctypes.byref(vlen)) != 0:
            return None
        return ctypes.string_at(val, vlen.value)

    def close(self) -> None:
        if self._env:
            self._lib.lmdbx_close(self._env)
            self._env = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class LmdbWriter:
    """Bulk writer: ``put`` pairs, then ``commit`` writes one complete LMDB
    file (``data.mdb``) under ``path``."""

    def __init__(self, path: str, map_size: int = 1 << 30):
        self._lib = _lib()
        self._w = self._lib.lmdbx_writer_new()
        self.path = path
        self.map_size = map_size
        os.makedirs(path, exist_ok=True)

    def put(self, key: bytes, value: bytes) -> None:
        self._lib.lmdbx_writer_put(self._w, key, len(key), value, len(value))

    def write_batch(self, cache: dict) -> None:
        """The reference's ``writeCache``: a dict of str or bytes pairs."""
        for k, v in cache.items():
            self.put(k.encode() if isinstance(k, str) else k,
                     v.encode() if isinstance(v, str) else v)

    def commit(self) -> None:
        rc = self._lib.lmdbx_writer_write(self._w, self.path.encode(), self.map_size)
        if rc != 0:
            raise IOError(f"lmdbx write failed: {rc}")

    def close(self) -> None:
        if self._w:
            self._lib.lmdbx_writer_free(self._w)
            self._w = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
