"""``mrn_tpu_torch.ops._build``'s background build on the CPU, with a
stand-in for ``nvcc`` (a shell script that writes its ``-o`` file after a
pause, or fails): every source is compiled once, ``load`` serves a library
already loaded while the build runs, and a failed build is raised by
``wait``."""

import os
import stat
import threading
import time

import pytest

from mrn_tpu_torch.ops import _build

PAUSE = 0.5


@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    for name in ("alpha", "beta"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    calls = tmp_path / "calls.txt"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {calls}\n'
        'case "$*" in *fail*) echo "error: no" ; exit 1 ;; esac\n'
        f"sleep {PAUSE}\n"
        'while [ "$1" != "-o" ]; do shift; done\n'
        'echo lib > "$2"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_libs", {})
    return csrc, calls


def test_background_build_compiles_each_source_once(fake_tree, monkeypatch):
    csrc, calls = fake_tree
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: f"lib {path}")
    _build._libs["loaded"] = "already loaded"
    build = _build.BackgroundBuild()
    t0 = time.perf_counter()
    assert _build.load("loaded") == "already loaded"      # not held by the build
    assert time.perf_counter() - t0 < PAUSE / 2
    loaded = []
    worker = threading.Thread(target=lambda: loaded.append(_build.load("alpha")))
    worker.start()                      # waits for the build, then loads its file
    libs = build.wait()
    worker.join()
    assert sorted(libs) == ["alpha", "beta"]
    assert all(path.exists() for path in libs.values())
    assert loaded == [f"lib {libs['alpha']}"]
    lines = calls.read_text().splitlines()
    for name in ("alpha", "beta"):
        assert sum(str(csrc / f"{name}.cu") in line for line in lines) == 1


def test_background_build_raises_a_failed_source(fake_tree):
    csrc, _ = fake_tree
    (csrc / "fail.cu").write_text("// fail\n")
    build = _build.BackgroundBuild(["alpha", "fail"])
    with pytest.raises(RuntimeError, match="fail: nvcc exited 1"):
        build.wait()
    assert not os.path.exists(_build._target("fail"))
