"""The training-time augmentations of the port (TextAugment, the ABINet
chain, MoCoAugment) against the JAX package's, on the CPU: the port's
transforms draw from a ``random.Random`` and an ``np.random.RandomState``
seeded s, JAX's from the globals after ``random.seed(s);
np.random.seed(s)``.  Normalised, the port's uint8 crops equal JAX's
float32 ones, and both sides leave their generators in the same state.

The ABINet chain runs OpenCV's CUBIC warps and resizes and its
``minAreaRect``, which the port holds at a bound (tests/
test_torch_augment_ops.py, ROADMAP.md §3).  Carried through the chain's
jitter and final bicubic resize, a CUBIC pixel off by 1 becomes a few
values off by a few levels: a crop may differ by at most ``LEVELS`` in 255
on at most ``SHARE`` of its values (observed: 5 levels, 0.1%, over 768
crops), and at most one crop in 64 more widely (its geometry drew a
near-tie rectangle and came out a pixel larger or smaller).  The LMDB
stream under ``Aug`` (``DatasetManager`` without the prefetcher, two task
builds) is held the same way."""

import random

import numpy as np
import PIL.Image
import pytest
import torch

from mrn_tpu.config import default_options as jax_options
from mrn_tpu.data import dataset as jax_dataset
from mrn_tpu.data.manager import DatasetManager as JaxManager
from mrn_tpu.data.transform import MoCoAugment as JaxMoCo
from mrn_tpu.data.transform import build_transform as jax_build
from mrn_tpu_torch.config import default_options
from mrn_tpu_torch.data import augment_fixtures, dataset
from mrn_tpu_torch.data.manager import DatasetManager
from mrn_tpu_torch.data.transform import MoCoAugment, build_transform
from mrn_tpu_torch.tools import create_lmdb

IMG_H, IMG_W = 32, 128
N_CROPS = 64
LEVELS, SHARE = augment_fixtures.BOUNDS["chain"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _crops(seed, n=N_CROPS):
    """Word-crop-sized RGBA crops: noise, a third with a varying alpha."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = int(rng.integers(16, 64)), int(rng.integers(24, 260))
        img = rng.integers(0, 256, (h, w, 4), np.uint8)
        if i % 3:
            img[..., 3] = 255
        out.append(img)
    return out


def _normed(u8):
    return ((u8.astype(np.float32) / 255.0) - 0.5) / 0.5


def _held(got, want, bounded):
    """The number of crops that differ (beyond the chain bound when
    ``bounded``)."""
    outside = 0
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == w.shape
        diff = np.abs(_normed(g).astype(np.float64) - w.astype(np.float64)) * 127.5
        n_diff = int((diff > 1e-3).sum())
        if n_diff == 0:
            continue
        if not bounded:
            outside += 1
        elif diff.max() > LEVELS + 1e-3 or n_diff > SHARE * diff.size:
            outside += 1
    return outside


def _same_generators(rng, np_rng):
    assert rng.getstate() == random.getstate()
    a, b = np_rng.get_state(), np.random.get_state()
    assert a[0] == b[0] and np.array_equal(a[1], b[1]) and a[2:] == b[2:]


@pytest.mark.parametrize("aug,seed", [("Blur5-Crop90-Rot15", 0), ("Blur5-Crop90-Rot15", 1),
                                      ("Rot15-Blur2.5", 2), ("Crop80", 3), ("ABINet", 0),
                                      ("ABINet", 1), ("ABINet", 2)])
def test_chain_matches_jax(aug, seed):
    crops = _crops(10 + seed)
    random.seed(seed)
    np.random.seed(seed)
    ref_t = jax_build(jax_options(Aug=aug, imgH=IMG_H, imgW=IMG_W), "train")
    want = [ref_t(PIL.Image.fromarray(c)) for c in crops]
    rng, np_rng = random.Random(seed), np.random.RandomState(seed)
    got_t = build_transform(default_options(Aug=aug, imgH=IMG_H, imgW=IMG_W), "train", rng=rng,
                            np_rng=np_rng)
    got = [got_t(c) for c in crops]
    assert all(g.shape == (IMG_H, IMG_W, 4) for g in got)
    outside = _held(got, want, bounded=aug == "ABINet")
    assert outside <= (1 if aug == "ABINet" else 0), f"{outside} crops differ"
    _same_generators(rng, np_rng)


@pytest.mark.parametrize("aug", ["Blur5-Crop90-Rot15", "ABINet"])
def test_tiny_crops_match_jax(aug):
    """Crops of 1-8 pixels a side: TextAugment's crop may leave an empty
    image, which Pillow blurs, rotates and resizes to zeros, and the port
    too.  ABINet (seed 0 draws its perspective branch) matches except on
    a crop 1 pixel wide or high but longer the other way, whose perspective
    system is singular: OpenCV solves it another way than the port's least
    squares (ROADMAP.md §3); the draws stay the same."""
    rng = np.random.default_rng(7)
    shapes = [(1, 1), (1, 5), (5, 1), (2, 2), (3, 7), (4, 4), (2, 30), (30, 2), (8, 8)]
    crops = [rng.integers(0, 256, s + (4,), np.uint8) for s in shapes for _ in range(4)]
    random.seed(0)
    np.random.seed(0)
    ref_t = jax_build(jax_options(Aug=aug, imgH=IMG_H, imgW=IMG_W), "train")
    want = [ref_t(PIL.Image.fromarray(c)) for c in crops]
    rng_, np_rng = random.Random(0), np.random.RandomState(0)
    got_t = build_transform(default_options(Aug=aug, imgH=IMG_H, imgW=IMG_W), "train",
                            rng=rng_, np_rng=np_rng)
    got = [got_t(c) for c in crops]
    regular = [i for i, c in enumerate(crops) if aug != "ABINet" or min(c.shape[:2]) > 1
               or c.shape[:2] == (1, 1)]
    assert len(regular) >= len(crops) - 8
    assert _held([got[i] for i in regular], [want[i] for i in regular],
                 bounded=aug == "ABINet") == 0
    assert all(g.shape == (IMG_H, IMG_W, 4) for g in got)
    _same_generators(rng_, np_rng)


@pytest.mark.parametrize("seed", [0, 1])
def test_moco_views_match_jax(seed):
    crops = _crops(20 + seed)
    random.seed(seed)
    np.random.seed(seed)
    ref = JaxMoCo(jax_options(imgH=IMG_H, imgW=IMG_W))
    want = [v for c in crops for v in ref(PIL.Image.fromarray(c))]
    rng = random.Random(seed)
    moco = MoCoAugment(default_options(imgH=IMG_H, imgW=IMG_W), rng)
    got = [v for c in crops for v in moco(c)]
    assert _held(got, want, bounded=False) == 0
    assert rng.getstate() == random.getstate()


# ------------------------------------------------------------ the LMDB stream
@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("aug_tree")
    for i, (lan, alphabet) in enumerate((("T0", "abcde"), ("T1", "fghij"))):
        create_lmdb.create_synthetic_dataset(str(root / lan), alphabet, 24, 30 + i,
                                             heights=(20, 40), widths=(40, 160))
    return root


def _stream_opts(aug):
    common = dict(il="mrn", batch_size=8, imgH=IMG_H, imgW=IMG_W, manual_seed=111,
                  batch_max_length=8, lan_list=["T0", "T1"], Aug=aug)
    return default_options(**common), jax_options(**common)


def _two_builds(manager, opt, root, steps=2):
    """Task 0's stream (``init_start``) and task 1's (``get_dataset``),
    ``steps`` batches each."""
    manager.init_start(opt, [root], None, 0)
    batches = [manager.get_batch() for _ in range(steps)]
    manager.get_dataset(1, memory=None)
    return batches + [manager.get_batch() for _ in range(steps)]


@pytest.mark.parametrize("aug", ["ABINet", "Blur5-Crop90-Rot15"])
def test_lmdb_stream_under_aug_matches_jax(tree, aug):
    opt, jopt = _stream_opts(aug)
    random.seed(jopt.manual_seed)
    np.random.seed(jopt.manual_seed)
    want = _two_builds(JaxManager(jopt), jopt, str(tree))
    manager = DatasetManager(opt)
    got = _two_builds(manager, opt, str(tree))
    crops_got, crops_want = [], []
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gl == wl and gi.dtype == np.uint8 and gi.shape == (8, IMG_H, IMG_W, 4)
        crops_got += list(gi)
        crops_want += list(wi)
    assert _held(crops_got, crops_want, bounded=aug == "ABINet") <= (1 if aug == "ABINet" else 0)
    _same_generators(manager.aug_rng, manager.aug_np_rng)


def test_lmdb_items_under_aug_are_natural_size(tree):
    """Training items keep their own size (JAX's PIL image, unresized); a
    test-mode set and no ``Aug`` keep the fused decode and resize."""
    opt, jopt = _stream_opts("ABINet")
    got = dataset.LmdbDataset(str(tree / "T0"), opt)
    ref = jax_dataset.LmdbDataset(str(tree / "T0"), jopt)
    for i in range(6):
        np.testing.assert_array_equal(got[i][0], np.asarray(ref[i][0]))
    assert dataset.LmdbDataset(str(tree / "T0"), opt, mode="test")[0][0].shape == (IMG_H, IMG_W,
                                                                                  4)
    assert dataset.LmdbDataset(str(tree / "T0"), opt.replace(Aug="None"))[0][0].shape == \
        (IMG_H, IMG_W, 4)
