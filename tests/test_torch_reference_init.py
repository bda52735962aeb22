"""The port's ``apply_reference_init`` (``mrn_tpu_torch/models/surgery.py``)
against the JAX package's on the same flax-layout trees of a tiny SVTR and
a tiny TRBA recognizer (``models.init.random_recognizer``, whose layout
``tests/test_torch_mrn_slice.py`` holds against flax's): the same leaves
left as they were, zeroed and set to one, bitwise; every kaiming leaf with
the JAX rule's std, its empirical std within 5% on leaves of 4096
elements or more; per-slice fan-in under ``stacked``.  The draws
themselves differ (numpy against JAX's PRNG).  Also: the MRN learner's
task-0 expert gets the pass, later experts do not."""

import jax
import numpy as np
import pytest
import torch

from mrn_tpu.models.surgery import _kaiming_for as jax_kaiming_for
from mrn_tpu.models.surgery import apply_reference_init as jax_reference_init
from mrn_tpu_torch.config import load_config
from mrn_tpu_torch.models.init import random_recognizer
from mrn_tpu_torch.models.surgery import apply_reference_init, kaiming_std
from mrn_tpu_torch.train.learners.mrn import MRN

SVTR = dict(embed_dim=(16, 32, 64), depth=(1, 2, 1), num_heads=(2, 2, 4))
STD_RTOL = 0.05      # empirical std of >= 4096 normal draws: ~1.1% one sigma
MIN_LEAF = 4096


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch's CPU ops on one thread here: beside the other test workers,
    more threads oversubscribe the cores (these runs took 15x longer with
    8 threads in each of two processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaves(tree, path=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], path + (k,))
        else:
            yield path + (k,), np.asarray(tree[k])


def _noise(tree, rng):
    """Every leaf redrawn N(0, 1), so each rule's effect shows."""
    return {k: _noise(v, rng) if isinstance(v, dict)
            else rng.standard_normal(np.shape(v)).astype(np.float32) for k, v in tree.items()}


def _trees():
    svtr = load_config("configs/svtr_mrn.py", svtr=SVTR, imgW=128, output_channel=64,
                       hidden_size=32)
    trba = load_config("configs/trba_mrn.py", imgW=64, output_channel=32, hidden_size=16)
    rng = np.random.default_rng(0)
    return {"svtr": _noise(random_recognizer(rng, svtr, 40)[0], rng),
            "trba": _noise(random_recognizer(rng, trba, 40)[0], rng)}


TREES = _trees()


def _kind(before, after):
    if before.tobytes() == after.tobytes():
        return "kept"
    if not after.any():
        return "zeros"
    if np.all(after == 1):
        return "ones"
    return "kaiming"


@pytest.mark.parametrize("name", sorted(TREES))
def test_each_leaf_gets_the_jax_rule(name):
    tree = TREES[name]
    got = dict(_leaves(apply_reference_init(tree, np.random.default_rng(1))))
    ref = dict(_leaves(jax.tree_util.tree_map(
        np.asarray, jax_reference_init(tree, jax.random.PRNGKey(1)))))
    before = dict(_leaves(tree))
    assert got.keys() == ref.keys() == before.keys()
    kinds = {}
    for path, x in before.items():
        kind = _kind(x, ref[path])
        assert _kind(x, got[path]) == kind, path
        assert got[path].dtype == x.dtype and got[path].shape == x.shape
        kinds[kind] = kinds.get(kind, 0) + 1
        if kind != "kaiming":
            assert got[path].tobytes() == ref[path].tobytes(), path
            continue
        std = jax_kaiming_for(list(path), x.shape)
        assert kaiming_std(path, x.shape) == std, path
        if x.size >= MIN_LEAF:
            for y in (got[path], ref[path]):
                assert abs(float(y.std()) / std - 1) < STD_RTOL, path
    assert kinds.get("kaiming", 0) > 0 and kinds.get("zeros", 0) > 0
    assert kinds.get("ones", 0) > 0 and kinds.get("kept", 0) > 0
    if name == "trba":   # the fiducial regressor and the LSTM layouts
        loc = ("extractor", "transformation", "localization", "localization_fc2")
        assert all(_kind(before[loc + (k,)], got[loc + (k,)]) == "kept" for k in ("bias",
                                                                                 "kernel"))
        assert any(p[-1] == "w_ih" for p in before) and any(p[-1] == "char_embeddings"
                                                            for p in before)
    else:                # pos_embed is left as it was
        pos = ("extractor", "feature", "pos_embed")
        assert got[pos].tobytes() == before[pos].tobytes()


def test_stacked_subtrees_read_the_per_slice_fan_in():
    rng = np.random.default_rng(3)
    tree = {"extractors": {"rnn": {"w_ih": rng.standard_normal((3, 64, 96), np.float32),
                                   "b_ih": rng.standard_normal((3, 64), np.float32)},
                           "conv": {"kernel": rng.standard_normal((3, 3, 3, 24, 32),
                                                                  np.float32)},
                           "fc": {"kernel": rng.standard_normal((3, 128, 48), np.float32)}},
            "head": {"kernel": rng.standard_normal((128, 48), np.float32)}}
    stacked = ("extractors",)
    got = dict(_leaves(apply_reference_init(tree, np.random.default_rng(4), stacked)))
    ref = dict(_leaves(jax.tree_util.tree_map(np.asarray, jax_reference_init(
        tree, jax.random.PRNGKey(4), stacked))))
    for path, x in _leaves(tree):
        if path[-1] == "b_ih":
            assert not got[path].any() and not ref[path].any()
            continue
        shape = x.shape[1:] if path[0] in stacked else x.shape
        std = jax_kaiming_for(list(path), shape)
        assert kaiming_std(path, shape) == std
        for y in (got[path], ref[path]):
            assert abs(float(y.std()) / std - 1) < STD_RTOL, path
    # the stack axis is not read as fan-in: w_ih's is 96, not 64
    assert kaiming_std(("extractors", "rnn", "w_ih"), (64, 96)) == pytest.approx(
        np.sqrt(2 / 96))


def test_task0_expert_gets_the_pass_and_later_experts_do_not(tmp_path):
    opt = load_config("configs/svtr_mrn.py", svtr=SVTR, imgW=128, output_channel=64,
                      hidden_size=32, output_dir=str(tmp_path),
                      data_log=str(tmp_path / "d.txt"))
    learner = MRN(opt, device="cpu")
    learner.character = list("abcdef")
    learner.converter = learner.build_converter()
    learner.build_model()
    first = learner.model.state_dict()
    learner.change_model()
    later = learner.model.state_dict()
    bias = "extractor.feature.blocks1.0.norm1_bias"
    assert not first[bias].any() and bool((later[bias] == 1).all())   # LN bias 0 vs 1
    qkv = "extractor.feature.blocks3.0.qkv_kernel"
    assert abs(float(first[qkv].std()) / np.sqrt(2 / first[qkv].shape[0]) - 1) < STD_RTOL
    assert abs(float(later[qkv].std()) / (0.02 * 0.8796) - 1) < STD_RTOL  # N(0, .02) cut at 2 sigma
