"""The port's data stream against the JAX package's, bitwise, on the CPU:
the synthetic suite (``make_task_suite``, ``SyntheticSource`` and its
``.npz`` cache), ``EpochLoader``'s training form, ``DatasetManager`` (its
batches, router targets in both ``router_labels`` modes, ``skip_batches``
and ``rng_state_at_build``) and MRN's rehearsal-memory draw, with and
without the port's prefetcher; plus the growing image bank and the
prefetcher's own contract.

Only numpy-level functions run on the JAX side: the memory draw is the JAX
``MRN.build_rehearsal_memory`` called unbound on a stub holding ``opt``,
``np_rng`` and ``memory_index``, so no JAX learner is built and nothing is
compiled."""

import threading
import time

import numpy as np
import pytest
import torch

from mrn_tpu.config import default_options as jax_options
from mrn_tpu.data.dataset import BankDataset as JaxBankDataset
from mrn_tpu.data.manager import DatasetManager as JaxManager
from mrn_tpu.data.manager import EpochLoader as JaxEpochLoader
from mrn_tpu.data.synthetic import SyntheticSource as JaxSource
from mrn_tpu.data.synthetic import make_task_suite as jax_suite
from mrn_tpu.train.learners.base import BaseLearner as JaxBase
from mrn_tpu.train.learners.mrn import MRN as JaxMRN
from mrn_tpu_torch.config import default_options
from mrn_tpu_torch.data.dataset import ArrayDataset, BankDataset, DeviceImageBank
from mrn_tpu_torch.data.manager import DatasetManager, EpochLoader
from mrn_tpu_torch.data.prefetch import Prefetcher
from mrn_tpu_torch.data.synthetic import SyntheticSource, make_task_suite
from mrn_tpu_torch.train.learners.mrn import MRN

ALPHABETS = ["abcde", "fghij", "klmnopq", "rstu"]
LANS = ["T0", "T1", "T2", "T3"]
N_TRAIN, N_TEST = [40, 120, 64, 52], [12, 16, 9, 10]
IMG_H, IMG_W, BATCH, SEED = 32, 64, 8, 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch's CPU ops on one thread here: beside the other test workers,
    more threads oversubscribe the cores (these runs took 15x longer with
    8 threads in each of two processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _suite_kw(renderer, zipf):
    return dict(img_h=IMG_H, img_w=IMG_W, seed=SEED, min_len=1, max_len=6,
                renderer=renderer, zipf=zipf)


@pytest.mark.parametrize("renderer,zipf", [("bands", 0.0), ("bits", 1.0), ("bits", 0.0),
                                           ("bands", 1.0)])
def test_task_suite_matches_jax_bitwise(renderer, zipf):
    got = make_task_suite(ALPHABETS, N_TRAIN, N_TEST, **_suite_kw(renderer, zipf))
    ref = jax_suite(ALPHABETS, N_TRAIN, N_TEST, **_suite_kw(renderer, zipf))
    for split in (0, 1):
        for g, r in zip(got[split], ref[split]):
            assert g.labels == r.labels
            assert all(a.dtype == np.uint8 and a.tobytes() == b.tobytes()
                       for a, b in zip(g.images, r.images))
    assert got[2] == ref[2]


def test_shared_alphabet_and_pretransformed_match_jax():
    kw = dict(_suite_kw("bits", 1.0), shared_alphabet="0123", pretransformed=True)
    got = make_task_suite(ALPHABETS[:2], 6, 4, **kw)
    ref = jax_suite(ALPHABETS[:2], 6, 4, **kw)
    assert got[2] == ref[2]
    for g, r in zip(got[0] + got[1], ref[0] + ref[1]):
        assert g.labels == r.labels
        assert all(a.dtype == np.float32 and a.tobytes() == b.tobytes()
                   for a, b in zip(g.images, r.images))


def _sources():
    kw = dict(n_train=N_TRAIN, n_test=N_TEST, device_bank=True, **_suite_kw("bits", 1.0))
    return (SyntheticSource(ALPHABETS, LANS, **kw), JaxSource(ALPHABETS, LANS, **kw))


@pytest.fixture(scope="module")
def sources():
    return _sources()


def test_source_bank_and_views_match_jax(sources):
    port, jax_src = sources
    assert port.bank.tobytes() == jax_src.bank.tobytes()
    for store, ref in ((port.trains, jax_src.trains), (port.tests, jax_src.tests)):
        for lan in LANS:
            assert (store[lan].start, list(store[lan].labels)) == (ref[lan].start,
                                                                  list(ref[lan].labels))
    for t in range(4):
        assert port.cumulative_character(t) == jax_src.cumulative_character(t)
    assert port.val_factory("synth_test/T2").start == jax_src.val_factory("synth_test/T2").start
    bank = port.device_bank("cpu")
    assert bank.dtype == torch.uint8 and bank.shape == port.bank.shape
    assert port.device_bank("cpu") is bank


def test_source_cache_round_trip_both_ways(sources, tmp_path):
    port, jax_src = sources
    port.save(str(tmp_path / "port"))
    jax_src.save(str(tmp_path / "jax"))
    for path in ("port.npz", "jax.npz"):
        for cls in (SyntheticSource, JaxSource):
            got = cls.load(str(tmp_path / path), LANS, ALPHABETS)
            assert got.bank.tobytes() == port.bank.tobytes()
            for lan in LANS:
                assert got.trains[lan].start == port.trains[lan].start
                assert list(got.tests[lan].labels) == list(port.tests[lan].labels)
            assert got.dicts == port.dicts


def test_epoch_loader_orders_match_jax_across_epochs(sources):
    port, jax_src = sources
    ds, jds = port.trains["T1"], jax_src.trains["T1"]
    got = EpochLoader(ds, BATCH, shuffle=True, rng=np.random.default_rng(9))
    ref = JaxEpochLoader(jds, BATCH, lambda x: x, shuffle=True, rng=np.random.default_rng(9))
    for _ in range(3 * len(got)):        # three epochs, the last batch of each short
        (gi, gl), (ri, rl) = got.next_batch(), ref.next_batch()
        assert gi.dtype == np.int32 and gi.tobytes() == ri.astype(np.int32).tobytes()
        assert gl == rl
    assert got.rng.bit_generator.state == ref.rng.bit_generator.state


def test_crop_of_another_size_raises():
    """A uint8 crop of another size is resized as Pillow's bicubic resizes
    it (JAX's ``ResizeNormalize``); a crop that is not an image raises."""
    import PIL.Image

    opt = default_options(imgH=IMG_H, imgW=IMG_W, batch_size=2, select_data=["r"])
    crop = np.random.default_rng(0).integers(0, 256, (IMG_H + 3, IMG_W + 1, 4), np.uint8)
    crops = ArrayDataset([crop] * 2, ["a", "b"])
    manager = DatasetManager(opt, dataset_factory=lambda root, taski, mode: crops)
    manager.init_start(opt, ["r"], None, 0)
    images, _ = manager.get_batch()
    want = np.asarray(PIL.Image.fromarray(crop).resize((IMG_W, IMG_H), PIL.Image.BICUBIC))
    assert images.dtype == np.uint8 and (images == want).all()
    bad = ArrayDataset([np.zeros((IMG_H, IMG_W + 1, 2), np.uint8)] * 2, ["a", "b"])
    manager = DatasetManager(opt, dataset_factory=lambda root, taski, mode: bad)
    manager.init_start(opt, ["r"], None, 0)
    with pytest.raises(ValueError, match="RGBA crop"):
        manager.get_batch()


# ------------------------------------------------------------ the manager
def _opts(**kw):
    common = dict(dict(il="mrn", memory="random", batch_size=BATCH, manual_seed=SEED,
                       select_data=["synth_train"], lan_list=LANS, imgH=IMG_H, imgW=IMG_W), **kw)
    return default_options(**common), jax_options(**common)


class _JaxStub:
    """What the JAX ``MRN.build_rehearsal_memory`` reads of its learner."""
    build_random_current_memory = JaxBase.build_random_current_memory
    reduce_samplers = JaxBase.reduce_samplers

    def __init__(self, opt):
        self.opt, self.np_rng, self.memory_index = opt, np.random.default_rng(opt.manual_seed), []


def _port_learner(opt, tmp_path):
    return MRN(opt.replace(output_dir=str(tmp_path), data_log=str(tmp_path / "d.txt")),
               device="cpu")


def _draws(manager, n, indexed):
    get = manager.get_batch2 if indexed else manager.get_batch
    return [get() for _ in range(n)]


def _assert_same_batches(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g[0].dtype == np.int32 and g[0].tobytes() == np.asarray(r[0], np.int32).tobytes()
        assert list(g[1]) == list(r[1])
        if len(r) > 2:
            assert g[2].dtype == np.int32 and g[2].tobytes() == r[2].tobytes()


def _mrn_stream(manager, learner_build, n_tasks, steps, prefetch):
    """MRN's stream calls for tasks 0..n_tasks-1 (no training): step 0's
    ``get_dataset(taski, memory=None)`` and ``steps`` batches, then the
    memory build and ``steps // 2`` indexed batches; batches come through
    a prefetcher asked for exactly that many when ``prefetch``."""
    out = []

    def take(get, n):
        if not prefetch:
            return [get() for _ in range(n)]
        p = Prefetcher(get, n)
        try:
            return [p() for _ in range(n)]
        finally:
            p.close()

    for taski in range(n_tasks):
        if taski > 0:
            manager.get_dataset(taski, memory=None)
        out.append(("step0", take(manager.get_batch, steps)))
        if taski > 0:
            learner_build(manager, taski)
            out.append(("step1", take(manager.get_batch2, steps // 2)))
    return out


@pytest.mark.parametrize("labels", ["reference", "task"])
@pytest.mark.parametrize("prefetch", [False, True])
def test_mrn_stream_matches_jax(sources, tmp_path, labels, prefetch):
    """Four tasks of MRN's stream: batch indices, labels, router targets
    and memory indices bitwise; targets binary under "reference"."""
    port, jax_src = sources
    opt, jopt = _opts(memory_num=12, router_labels=labels)
    learner = _port_learner(opt, tmp_path)
    stub = _JaxStub(jopt)
    got_m = DatasetManager(opt, dataset_factory=port.train_factory)
    ref_m = JaxManager(jopt, dataset_factory=jax_src.train_factory)
    got_m.init_start(opt, opt.select_data, None, 0)
    ref_m.init_start(jopt, jopt.select_data, None, 0)
    got = _mrn_stream(got_m, learner.build_rehearsal_memory, 4, 6, prefetch)
    ref = _mrn_stream(ref_m, lambda m, t: JaxMRN.build_rehearsal_memory(stub, m, t), 4, 6, False)
    for (gk, g), (rk, r) in zip(got, ref):
        assert gk == rk
        _assert_same_batches(g, r)
        if gk == "step1":
            targets = np.concatenate([b[2] for b in g])
            assert set(targets.tolist()) <= ({0, 1} if labels == "reference" else {0, 1, 2, 3})
    assert len(learner.memory_index) == len(stub.memory_index) == 3
    for a, b in zip(learner.memory_index, stub.memory_index):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    assert [len(ix) for ix in learner.memory_index] == [4, 4, 4]   # int(12 / 3), reduced
    assert got_m.rng.bit_generator.state == ref_m.rng.bit_generator.state
    assert learner.np_rng.bit_generator.state == stub.np_rng.bit_generator.state


def _bank_factory(cls, sizes):
    starts = np.cumsum([0] + sizes[:-1])
    sets = [cls(int(s), [f"w{t}_{i}" for i in range(n)])
            for t, (s, n) in enumerate(zip(starts, sizes))]
    return lambda root, taski, mode: sets[taski]


@pytest.mark.parametrize("memory_num", [30, 5000, 5500])
def test_memory_indices_after_tasks_1_to_3_match_jax(tmp_path, memory_num):
    """Below 5000 the memories are cut to ``memory_num / taski``; at or
    above, every task keeps ``memory_num`` samples."""
    sizes = [6000, 5800, 7000, 6500]
    opt, jopt = _opts(memory_num=memory_num)
    learner, stub = _port_learner(opt, tmp_path), _JaxStub(jopt)
    got_m = DatasetManager(opt, dataset_factory=_bank_factory(BankDataset, sizes))
    ref_m = JaxManager(jopt, dataset_factory=_bank_factory(JaxBankDataset, sizes))
    got_m.init_start(opt, opt.select_data, None, 0)
    ref_m.init_start(jopt, jopt.select_data, None, 0)
    for taski in (1, 2, 3):
        learner.build_rehearsal_memory(got_m, taski)
        JaxMRN.build_rehearsal_memory(stub, ref_m, taski)
        assert len(learner.memory_index) == taski
        for a, b in zip(learner.memory_index, stub.memory_index):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
        want = memory_num if memory_num >= 5000 else int(memory_num / taski)
        assert [len(ix) for ix in learner.memory_index] == [want] * taski
        _assert_same_batches(_draws(got_m, 3, True), _draws(ref_m, 3, True))
    assert got_m.rng_state_at_build == ref_m.rng_state_at_build


def test_current_task_stream_two_epochs_and_skip(sources):
    """``memory=None``: two epochs of batches as JAX's; ``skip_batches(n)``
    leaves the stream where n consumed rounds do; ``rng_state_at_build`` is
    the generator before the build."""
    port, jax_src = sources
    opt, jopt = _opts(memory=None)
    got_m = DatasetManager(opt, dataset_factory=port.train_factory)
    ref_m = JaxManager(jopt, dataset_factory=jax_src.train_factory)
    for m, o in ((got_m, opt), (ref_m, jopt)):
        m.init_start(o, o.select_data, None, 0)
        before = m.rng.bit_generator.state
        m.get_dataset(2, memory=None)
        assert m.rng_state_at_build == before
    n = 2 * len(got_m.loaders[0])
    _assert_same_batches(_draws(got_m, n, False), _draws(ref_m, n, False))

    a = DatasetManager(opt, dataset_factory=port.train_factory)
    b = DatasetManager(opt, dataset_factory=port.train_factory)
    for m in (a, b):
        m.init_start(opt, opt.select_data, None, 1)
    _draws(a, 7, False)
    b.skip_batches(7)
    assert a.rng.bit_generator.state == b.rng.bit_generator.state
    _assert_same_batches(_draws(a, 5, False), _draws(b, 5, False))


def test_other_memory_policies_raise(sources):
    """The other learners' memory policies and ``joint_start`` build the
    JAX manager's loaders (their streams are held against it bitwise in
    ``tests/test_torch_memory_policies.py``); the LMDB factory raises as
    JAX's does for a root without an LMDB."""
    port, jax_src = sources
    for il in ("wa", "der", "base"):
        opt, jopt = _opts(il=il)
        m = DatasetManager(opt, dataset_factory=port.train_factory)
        j = JaxManager(jopt, dataset_factory=jax_src.train_factory)
        m.init_start(opt, opt.select_data, None, 0)
        j.init_start(jopt, jopt.select_data, None, 0)
        for policy in ("random", "test_ch", "large", "total"):
            m.get_dataset(1, memory=policy, index_list=[np.arange(4)])
            j.get_dataset(1, memory=policy, index_list=[np.arange(4)])
            assert [(len(lo.dataset), lo.batch_size) for lo in m.loaders] == \
                [(len(lo.dataset), lo.batch_size) for lo in j.loaders]
            _assert_same_batches(_draws(m, 3, False), _draws(j, 3, False))
    for il in ("joint_mix", "joint_loader"):
        opt, jopt = _opts(il=il)
        m = DatasetManager(opt, dataset_factory=port.train_factory)
        m.joint_start(opt, opt.select_data, None, 0, 2)
        m.joint_start(opt, opt.select_data, None, 1, 2)
        assert len(m.loaders) == (1 if il == "joint_mix" else 2)
    with pytest.raises(OSError, match="cannot open lmdb at root/T0"):
        DatasetManager(opt).create_dataset(["root"], 0)


# ------------------------------------------------------------ the bank
def test_growing_bank_is_seen_by_the_learner(tmp_path):
    """A bank that grows by a chunk between two batches serves the new
    chunk's crops to the second one."""
    opt, _ = _opts()
    rng = np.random.default_rng(0)
    first = rng.integers(0, 256, (5, IMG_H, IMG_W, 4), dtype=np.uint8)
    second = rng.integers(0, 256, (3, IMG_H, IMG_W, 4), dtype=np.uint8)
    bank = DeviceImageBank()
    assert bank.add(first) == 0
    learner = _port_learner(opt.replace(image_bank=bank), tmp_path)
    learner.opt.image_bank = bank     # replace() copied it: hold the same object

    def norm(x):
        return (torch.as_tensor(x).float() / 255.0 - 0.5) / 0.5

    torch.testing.assert_close(learner._device_images(np.array([4, 0], np.int32)),
                               norm(first[[4, 0]]), rtol=0, atol=0)
    assert bank.add(second) == 5 and len(bank) == 8
    torch.testing.assert_close(learner._device_images(np.array([6, 1], np.int32)),
                               norm(np.stack([second[1], first[1]])), rtol=0, atol=0)
    # a numpy bank swapped for a longer one is copied again as well
    learner.opt.image_bank = first
    learner._device_images(np.array([0], np.int32))
    learner.opt.image_bank = np.concatenate([first, second])
    torch.testing.assert_close(learner._device_images(np.array([7], np.int32)),
                               norm(second[[2]]), rtol=0, atol=0)


# ------------------------------------------------------------ the prefetcher
def test_prefetcher_draws_exactly_its_count_and_joins():
    drawn = []

    def get():
        drawn.append(len(drawn))
        return drawn[-1]

    p = Prefetcher(get, 5, depth=2)
    assert [p() for _ in range(5)] == list(range(5))
    time.sleep(0.05)
    p.close()
    assert drawn == list(range(5)) and not p._thread.is_alive()
    with pytest.raises(RuntimeError):
        p()


def test_prefetcher_close_mid_stream_joins_the_thread():
    release = threading.Event()

    def get():
        release.wait(1.0)
        return 1

    p = Prefetcher(get, 100, depth=2)
    assert p() == 1
    release.set()
    p.close()
    assert not p._thread.is_alive()


def test_prefetcher_surfaces_a_producer_exception():
    calls = []

    def get():
        calls.append(1)
        if len(calls) == 3:
            raise KeyError("bad crop")
        return len(calls)

    p = Prefetcher(get, 10, depth=2)
    assert (p(), p()) == (1, 2)
    with pytest.raises(KeyError, match="bad crop"):
        p()
    p.close()
    assert len(calls) == 3
