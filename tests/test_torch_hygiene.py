"""Import hygiene and device policy of the PyTorch port: no module of
``mrn_tpu_torch``, nor ``chip_smoke.py``, ``scripts/torch_step_reading.py``
or ``torch_loop_reading.py``, imports JAX, flax, optax, msgpack (the card's machine has none of them) or
the JAX package, and entry points never fall back to the CPU on their own."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mrn_tpu_torch import resolve_device

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "optax", "msgpack", "mrn_tpu")


def _port_files():
    files = sorted((ROOT / "mrn_tpu_torch").rglob("*.py"))
    assert len(files) >= 10
    return files + [ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_step_reading.py",
                    ROOT / "torch_loop_reading.py"]


def test_scan_covers_every_subpackage():
    package = ROOT / "mrn_tpu_torch"
    parts = {p.relative_to(package).parts[0] for p in _port_files() if package in p.parents}
    assert {"models", "ops", "train", "data", "utils"} <= parts
    learners = ROOT / "mrn_tpu_torch" / "train" / "learners"
    assert set(learners.glob("*.py")) <= set(_port_files())


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_port_imports_no_jax(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {name}"


def test_server_without_device_raises_without_cuda(monkeypatch):
    from mrn_tpu_torch.config import default_options
    from mrn_tpu_torch.serve import Server

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Server(default_options(FeatureExtraction="SVTR", SequenceModeling="None"),
               {}, {}, ["a"])
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_fails_without_cuda_or_repo(tmp_path):
    """Without a card the script exits non-zero and prints no result; a copy
    of the script alone (no port beside it) fails too."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    runs = [subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                           cwd=ROOT, env=env, capture_output=True, text=True,
                           timeout=120)]
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    runs.append(subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                               env=dict(env, PYTHONPATH=""), capture_output=True,
                               text=True, timeout=120))
    for run in runs:
        assert run.returncode != 0
        assert '"ok"' not in run.stdout
