"""Builds the port's host C++ (the LMDB store of ``native/lmdbx/lmdbx.cpp``,
the image codec of ``data/csrc/imagecodec.cpp``, the WebP decoder of
``data/csrc/webpcodec.cpp``, the TIFF decoder of ``data/csrc/tiffcodec.cpp``)
with ``g++`` at first use and loads it with ctypes.

A library is named by a hash of its source and flags and lives in
``build/mrn_tpu_torch`` at the root of the checkout (listed in
``.gitignore``), so an edited source is never served by a stale build.  A
failed build raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

__all__ = ["BUILD_DIR", "ROOT", "load"]

ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = ROOT / "build" / "mrn_tpu_torch"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def load(name: str, source: Path, flags: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library of ``source`` (``g++`` with ``GXX_FLAGS`` and
    ``flags``), built into ``BUILD_DIR/<name>-<sha>.so`` when missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        cmd_flags = [*GXX_FLAGS, *flags]
        digest = hashlib.sha1(source.read_bytes() + " ".join(cmd_flags).encode())
        out = BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            proc = subprocess.run(["g++", *cmd_flags, str(source), "-o", str(tmp)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ build of {source} failed (exit {proc.returncode}):\n"
                                   + proc.stdout + proc.stderr)
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
        return lib
