"""The port's memory policies and joint streams against the JAX package's
``DatasetManager``, bitwise, on the CPU: ``test_ch``, ``large``,
``total``, the two half-batch loaders of the other strategies (with the
base learner's memory draw), ``joint_start`` in both joint modes and
``skip_batches`` over two loaders.  Each stream is drawn over two epochs
of its largest loader; batch indices, labels, the generator's state and
``rng_state_at_build`` must be equal.  Only numpy-level code runs on the
JAX side (the memory draw is ``BaseLearner.build_rehearsal_memory``
called unbound on a stub), so nothing is compiled."""

import numpy as np
import pytest
import torch

from mrn_tpu.config import default_options as jax_options
from mrn_tpu.data.manager import DatasetManager as JaxManager
from mrn_tpu.data.synthetic import SyntheticSource as JaxSource
from mrn_tpu.train.learners.base import BaseLearner as JaxBase
from mrn_tpu_torch.config import default_options
from mrn_tpu_torch.data.manager import DatasetManager
from mrn_tpu_torch.data.synthetic import SyntheticSource
from mrn_tpu_torch.train.learners.wa import WA

ALPHABETS = ["abcde", "fghij", "klmnopq", "rstu"]
LANS = ["T0", "T1", "T2", "T3"]
N_TRAIN, N_TEST = [40, 120, 64, 52], [12, 16, 9, 10]
IMG_H, IMG_W, BATCH, SEED = 32, 64, 8, 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch's CPU ops on one thread here: beside the other test workers,
    more threads oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sources():
    kw = dict(n_train=N_TRAIN, n_test=N_TEST, device_bank=True, img_h=IMG_H, img_w=IMG_W,
              seed=SEED, min_len=1, max_len=6, renderer="bits", zipf=1.0)
    return SyntheticSource(ALPHABETS, LANS, **kw), JaxSource(ALPHABETS, LANS, **kw)


def _opts(**kw):
    common = dict(dict(il="wa", memory="random", memory_num=12, batch_size=BATCH,
                       manual_seed=SEED, select_data=["synth_train"], lan_list=LANS,
                       imgH=IMG_H, imgW=IMG_W), **kw)
    return default_options(**common), jax_options(**common)


def _managers(sources, opt, jopt, taski=0):
    port, jax_src = sources
    got = DatasetManager(opt, dataset_factory=port.train_factory)
    ref = JaxManager(jopt, dataset_factory=jax_src.train_factory)
    got.init_start(opt, opt.select_data, None, taski)
    ref.init_start(jopt, jopt.select_data, None, taski)
    return got, ref


def _epochs(manager, epochs=2):
    """Enough ``get_batch`` rounds for ``epochs`` epochs of the largest
    loader, plus one."""
    return epochs * max(len(loader) for loader in manager.loaders) + 1


def _same_stream(got, ref, n):
    for _ in range(n):
        (gi, gl), (ri, rl) = got.get_batch(), ref.get_batch()
        assert gi.dtype == np.int32 and gi.tobytes() == np.asarray(ri, np.int32).tobytes()
        assert list(gl) == list(rl)
    assert got.rng.bit_generator.state == ref.rng.bit_generator.state


def _memory(n_tasks, rng):
    """Stored memory indices of tasks 0..n_tasks-1 (within each task)."""
    return [np.sort(rng.choice(N_TRAIN[t], 6, replace=False)) for t in range(n_tasks)]


@pytest.mark.parametrize("policy", ["test_ch", "large", "total", "random"])
def test_policy_stream_matches_jax(sources, policy):
    """Task 2 of each policy: the loaders (one mixed stream, or the two
    half-batch loaders of ``"random"``), two epochs of batches and the
    generator, bitwise."""
    opt, jopt = _opts()
    got, ref = _managers(sources, opt, jopt)
    memory = _memory(2, np.random.default_rng(1))
    before = got.rng.bit_generator.state
    got.get_dataset(2, memory=policy, index_list=memory)
    ref.get_dataset(2, memory=policy, index_list=memory)
    assert got.rng_state_at_build == ref.rng_state_at_build == before
    assert [(len(lo.dataset), lo.batch_size) for lo in got.loaders] == \
        [(len(lo.dataset), lo.batch_size) for lo in ref.loaders]
    if policy == "random":
        assert [lo.batch_size for lo in got.loaders] == [BATCH // 2] * 2
        assert len(got.loaders[0].dataset) == 12   # the memory alone, first
    else:
        assert [lo.batch_size for lo in got.loaders] == [BATCH]
    _same_stream(got, ref, _epochs(got))


class _JaxStub:
    """What the JAX ``BaseLearner.build_rehearsal_memory`` reads."""
    build_random_current_memory = JaxBase.build_random_current_memory
    reduce_samplers = JaxBase.reduce_samplers
    build_rehearsal_memory = JaxBase.build_rehearsal_memory

    def __init__(self, opt):
        self.opt, self.np_rng, self.memory_index = opt, np.random.default_rng(opt.manual_seed), []


def test_half_batch_loaders_with_the_base_memory_draw(sources, tmp_path):
    """Tasks 1-3 as WA and DER build them: the base learner's memory draw
    (``memory_num / taski`` of the last task, earlier memories cut), then
    the memory loader and the current loader of ``batch_size // 2`` each;
    every batch is the memory's half then the current task's."""
    opt, jopt = _opts()
    learner = WA(opt.replace(output_dir=str(tmp_path), data_log=str(tmp_path / "d.txt")),
                 device="cpu")
    stub = _JaxStub(jopt)
    got, ref = _managers(sources, opt, jopt)
    port, _ = sources
    for taski in (1, 2, 3):
        learner.build_rehearsal_memory(got, taski)
        stub.build_rehearsal_memory(ref, taski)
        assert [ix.tobytes() for ix in learner.memory_index] == \
            [np.asarray(ix).tobytes() for ix in stub.memory_index]
        assert [len(ix) for ix in learner.memory_index] == [int(12 / taski)] * taski
        memory_bank = {port.trains[LANS[t]].start + int(i)
                       for t, ix in enumerate(learner.memory_index) for i in ix}
        images, _ = got.get_batch()
        assert set(images[:BATCH // 2].tolist()) <= memory_bank
        start = port.trains[LANS[taski]].start
        assert all(start <= i < start + N_TRAIN[taski] for i in images[BATCH // 2:].tolist())
        ref.get_batch()
        _same_stream(got, ref, _epochs(got))
    assert learner.np_rng.bit_generator.state == stub.np_rng.bit_generator.state


def test_skip_batches_over_two_loaders(sources):
    """``skip_batches(n)`` over the two half-batch loaders leaves the
    stream where n consumed rounds leave it, across the memory loader's
    epochs, as JAX's does."""
    port, jax_src = sources
    opt, jopt = _opts()
    memory = _memory(3, np.random.default_rng(2))
    a = DatasetManager(opt, dataset_factory=port.train_factory)
    b = DatasetManager(opt, dataset_factory=port.train_factory)
    c = JaxManager(jopt, dataset_factory=jax_src.train_factory)
    for m, o in ((a, opt), (b, opt), (c, jopt)):
        m.init_start(o, o.select_data, None, 0)
        m.get_dataset(3, memory="random", index_list=memory)
    n = 3 * len(a.loaders[0]) + 2    # three epochs of the memory loader
    for _ in range(n):
        a.get_batch()
    b.skip_batches(n)
    c.skip_batches(n)
    assert a.rng.bit_generator.state == b.rng.bit_generator.state == c.rng.bit_generator.state
    for _ in range(5):
        (ai, al), (bi, bl), (ci, cl) = a.get_batch(), b.get_batch(), c.get_batch()
        assert ai.tobytes() == bi.tobytes() == np.asarray(ci, np.int32).tobytes()
        assert al == bl == cl


@pytest.mark.parametrize("il", ["joint_mix", "joint_loader"])
def test_joint_start_matches_jax(sources, il):
    """``joint_start`` over four tasks: joint_mix gathers ``data_list`` and
    builds one loader after the last task, joint_loader one loader of
    ``batch_size // 4`` a task; two epochs of batches bitwise."""
    port, jax_src = sources
    opt, jopt = _opts(il=il)
    got = DatasetManager(opt, dataset_factory=port.train_factory)
    ref = JaxManager(jopt, dataset_factory=jax_src.train_factory)
    for taski in range(len(LANS)):
        got.joint_start(opt, opt.select_data, None, taski, len(LANS))
        ref.joint_start(jopt, jopt.select_data, None, taski, len(LANS))
        assert len(got.loaders) == len(ref.loaders)
        assert got.rng.bit_generator.state == ref.rng.bit_generator.state
    if il == "joint_mix":
        assert len(got.data_list) == len(LANS) and len(got.loaders) == 1
        assert got.loaders[0].batch_size == BATCH
    else:
        assert got.data_list == [] and [lo.batch_size for lo in got.loaders] == \
            [BATCH // len(LANS)] * len(LANS)
    _same_stream(got, ref, _epochs(got))
