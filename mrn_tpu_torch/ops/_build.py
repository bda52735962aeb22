"""Builds the port's CUDA sources (``csrc/*.cu``) at first use and loads them
with ctypes.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, named by a hash of the source and of the shared headers
(``csrc/*.cuh``) so an edited source or header is never served by a stale
build.  The build directory is ``build/mrn_tpu_torch``
at the root of the checkout (listed in ``.gitignore``).  A failed build
raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

__all__ = ["BUILD_DIR", "CSRC", "build_all", "load", "ptxas_report", "sass"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mrn_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "from source on the machine with the card")
    return nvcc


def _target(name: str) -> Path:
    digest = hashlib.sha1()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def build_all(names: List[str] = None) -> Dict[str, Path]:
    """Compile every named source (default: all of ``csrc/*.cu``) that has no
    current build, one ``nvcc`` per source, all started together.  The
    compiler's output (``-Xptxas -v``: registers, shared memory, spills) is
    kept beside each library as ``<name>.log``.  Returns name -> library."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{name}.log", "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                      tmp, out, log)
    failed = []
    for name, (proc, tmp, out, log) in jobs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name}: nvcc exited {rc}\n"
                          + (BUILD_DIR / f"{name}.log").read_text())
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return {name: _target(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            _libs[name] = lib
        return lib


def sass(name: str) -> Dict[str, str]:
    """{kernel's mangled name: its SASS} of the built ``csrc/<name>.cu``,
    from ``cuobjdump -sass`` (on the PATH or beside ``nvcc``)."""
    lib = build_all([name])[name]
    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)", text)
    return dict(zip(parts[1::2], parts[2::2]))


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """{kernel's mangled name: {"registers", "spill_stores", "spill_loads"}}
    from the ``-Xptxas -v`` output kept beside the build of
    ``csrc/<name>.cu`` (empty if the log is missing)."""
    log = BUILD_DIR / f"{name}.log"
    if not log.exists():
        return {}
    report: Dict[str, Dict[str, int]] = {}
    current = None
    for line in log.read_text().splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = report.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current is not None:
            current["spill_stores"], current["spill_loads"] = int(m.group(1)), int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            current["registers"] = int(m.group(1))
            current = None
    return report
