"""The campaign's overlap suite (``--shared N``) against the JAX script's
``build_source(shared=N)`` at smoke size, on the CPU: the task alphabets,
the rendered bank, the views and the first batches of a base-strategy
stream bitwise, and the cache tag (the port writes the cache, the JAX
script finds it under its own tag and loads it).  The record of a smoke
run writes ``shared_glyphs``, and ``--skip_done`` leaves a record that
exists alone."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from mrn_tpu.config import default_options as jax_options
from mrn_tpu.data.manager import DatasetManager as JaxManager
from mrn_tpu_torch import campaign
from mrn_tpu_torch.config import default_options
from mrn_tpu_torch.data.manager import DatasetManager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARED = 30
SMOKE_TRAIN = [max(8, n // 80) for n in campaign.N_TRAIN]
SMOKE_TEST = [max(8, n // 80) for n in campaign.N_TEST]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch's CPU ops on one thread beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_accuracy_campaign", os.path.join(ROOT, "scripts", "accuracy_campaign.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def suites(jax_script):
    """The port's and the JAX script's smoke-size overlap suites, rendered
    (the JAX script's globals cut as its ``--smoke`` cuts them, its test
    sizes too)."""
    opt = default_options(imgH=32, imgW=256)
    port = campaign.build_source(opt, 111, None, SMOKE_TRAIN, SMOKE_TEST, shared=SHARED)
    saved = jax_script.N_TRAIN, jax_script.GEN_PARAMS
    jax_script.N_TRAIN = SMOKE_TRAIN
    jax_script.GEN_PARAMS = dict(saved[1], n_test=SMOKE_TEST)
    try:
        ref = jax_script.build_source(jax_options(imgH=32, imgW=256), seed=111, shared=SHARED)
    finally:
        jax_script.N_TRAIN, jax_script.GEN_PARAMS = saved
    return port, ref


def test_shared_alphabets_bank_and_views_match_jax(suites):
    port, ref = suites
    alphabets = campaign.task_alphabets(SHARED)
    shared = alphabets[0][:SHARED]
    assert all(a[:SHARED] == shared for a in alphabets)
    assert all(0x3000 <= ord(c) < 0x4E00 for c in shared) and len(set(shared)) == SHARED
    assert [a[SHARED:] for a in alphabets] == campaign.task_alphabets()
    assert port.bank.tobytes() == ref.bank.tobytes()
    for store, want in ((port.trains, ref.trains), (port.tests, ref.tests)):
        for lan in campaign.LANS:
            assert (store[lan].start, list(store[lan].labels)) == (want[lan].start,
                                                                  list(want[lan].labels))
    for t in range(len(campaign.LANS)):
        assert port.cumulative_character(t) == ref.cumulative_character(t)
    labels = "".join(port.trains["Latin"].labels)
    assert sum(c in shared for c in labels) > len(labels) // 4   # the top Zipf ranks


@pytest.mark.parametrize("taski", [0, 3])
def test_shared_base_stream_matches_jax(suites, taski):
    port, ref = suites
    common = dict(il="base", memory=None, batch_size=16, manual_seed=111, imgH=32, imgW=256,
                  select_data=["synth_train"], lan_list=campaign.LANS)
    opt, jopt = default_options(**common), jax_options(**common)
    got = DatasetManager(opt, dataset_factory=port.train_factory)
    want = JaxManager(jopt, dataset_factory=ref.train_factory)
    got.init_start(opt, opt.select_data, None, taski)
    want.init_start(jopt, jopt.select_data, None, taski)
    for _ in range(5):
        (gi, gl), (wi, wl) = got.get_batch(), want.get_batch()
        assert gi.dtype == np.int32 and gi.tobytes() == np.asarray(wi, np.int32).tobytes()
        assert list(gl) == list(wl)


def test_shared_cache_tag_matches_jax(jax_script, tmp_path, capsys):
    """The port's tag names the JAX script's cache file: the JAX
    ``build_source`` loads the port's cache rather than rendering."""
    opt = default_options(imgH=32, imgW=256)
    tag = campaign.suite_tag(111, SMOKE_TRAIN, 32, 256, SHARED)
    assert tag != campaign.suite_tag(111, SMOKE_TRAIN, 32, 256)
    assert campaign.suite_tag(111, SMOKE_TRAIN, 32, 256, 0).endswith(
        campaign.suite_tag(111, SMOKE_TRAIN, 32, 256)[-8:])
    port = campaign.build_source(opt, 111, str(tmp_path), SMOKE_TRAIN, SMOKE_TEST, SHARED)
    assert os.listdir(tmp_path) == [f"suite_{tag}.npz"]
    saved = jax_script.N_TRAIN
    jax_script.N_TRAIN = SMOKE_TRAIN
    try:
        ref = jax_script.build_source(jax_options(imgH=32, imgW=256), seed=111,
                                      cache_dir=str(tmp_path), shared=SHARED)
    finally:
        jax_script.N_TRAIN = saved
    assert "suite loaded from cache" in capsys.readouterr().out
    assert os.listdir(tmp_path) == [f"suite_{tag}.npz"]
    assert ref.bank.tobytes() == port.bank.tobytes()
    assert ref.cumulative_character(5) == port.cumulative_character(5)


def test_shared_record_and_skip_done(tmp_path, monkeypatch):
    out = str(tmp_path / "overlap")
    args = ["--arch", "crnn", "--il", "base", "--shared", str(SHARED), "--smoke", "--tasks",
            "2", "--num_iter", "2", "--batch_size", "8", "--device", "cpu", "--out", out]
    record = campaign.main(args)
    assert record["shared_glyphs"] == SHARED and record["il"] == "base"
    assert record["arch"] == "crnn" and len(record["acc_matrix"]) == 2
    with open(os.path.join(out, "base.json"), encoding="utf-8") as f:
        assert json.load(f) == record

    def refuse(*_args, **_kw):
        raise AssertionError("--skip_done ran a campaign")

    monkeypatch.setattr(campaign, "build_source", refuse)
    assert campaign.main(args + ["--skip_done"]) == record
