"""Full-state resume of the port's SVTR-MRN campaign on the CPU, float32, at
a narrow width (embed 16/32/64, depth 1/2/1, img 32x128, batch 4, 2
tasks, ``num_iter`` 8, ``val_interval`` 2, ``full_ckpt``), through
``campaign.run_incremental`` with the prefetcher on: a run that crashes in
step 0 of task 0, or in routed step 3 of task 1, and is resumed with
``resume_full`` (and ``start_task=1.5`` for the second) ends bitwise where
the uninterrupted run ends (as ``tests/test_full_ckpt.py`` checks the JAX
learner): parameters, BatchNorm statistics, Adam state, the DropPath
generator, the numpy generators, the memory indices and the batches
drawn after the crash and after the run.  A snapshot's ``opt_state`` loads
into optax's state of the JAX optimizer built for the same parameters.
Also: the weight draws leave ``np_rng`` to the memory draw alone."""

import os

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from mrn_tpu.config import default_options as jax_options
from mrn_tpu.train.checkpoint import deep_merge
from mrn_tpu.train.optim import build_optimizer as jax_build_optimizer
from mrn_tpu.train.optim import build_schedule as jax_build_schedule
from mrn_tpu_torch.bridge import to_flax
from mrn_tpu_torch.campaign import LANS, campaign_options, run_incremental
from mrn_tpu_torch.data.manager import DatasetManager
from mrn_tpu_torch.data.synthetic import SyntheticSource
from mrn_tpu_torch.models.init import random_recognizer
from mrn_tpu_torch.train.checkpoint import load_train_state
from mrn_tpu_torch.train.learners.mrn import MRN

SVTR = dict(embed_dim=(16, 32, 64), depth=(1, 2, 1), num_heads=(2, 2, 4))
ALPHABETS = ["abcdefghij", "klmnop"]
SOURCE = SyntheticSource(ALPHABETS, LANS[:2], n_train=[24, 20], n_test=[6, 6], img_h=32,
                         img_w=128, seed=3, device_bank=True, renderer="bits", max_len=5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch's CPU ops on one thread here: beside the other test workers,
    more threads oversubscribe the cores (these runs took 15x longer with
    8 threads in each of two processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Crash(Exception):
    pass


def _opt(out, tasks=2, **kw):
    opt = campaign_options(tasks=tasks, num_iter=8, batch_size=4, seed=3, out=str(out),
                           **dict(dict(svtr=SVTR, output_channel=32, hidden_size=16, imgW=128,
                                       val_interval=2, memory_num=8, full_ckpt=True), **kw))
    opt.image_bank = SOURCE.device_bank("cpu")
    return opt


def _drive(out, crash_after=None, routed_only=False, **kw):
    """A campaign run recording each step's (task, phase, batch indices);
    it raises after ``crash_after`` steps (routed steps only if
    ``routed_only``) and the crash is swallowed."""
    opt = _opt(out, **kw)
    learner = MRN(opt, device="cpu")
    manager = DatasetManager(opt, dataset_factory=SOURCE.train_factory)
    seen, calls = [], [0]
    step = learner.train_step

    def train_step(fetched):
        if crash_after is not None and (not routed_only or learner._phase == "routed"):
            calls[0] += 1
            if calls[0] > crash_after:
                raise _Crash()
        seen.append((learner._cur_task, learner._phase, np.asarray(fetched[0]).copy(),
                     np.asarray(fetched[2]).copy() if len(fetched) > 2 else None))
        return step(fetched)

    learner.train_step = train_step
    try:
        run_incremental(opt, SOURCE, learner=learner, manager=manager)
    except _Crash:
        pass
    return learner, manager, seen


def _snapshot(out, name):
    return os.path.join(str(out), "saved", "acc_svtr_mrn", f"{name}_train_state.msgpack")


def _same_tensors(a, b):
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


def _same_adam(a, b):
    assert a.count == b.count
    for x, y in zip(a.mu + a.nu, b.mu + b.nu):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def _same_steps(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g[:2] == r[:2] and g[2].tobytes() == r[2].tobytes()
        assert (g[3] is None and r[3] is None) or g[3].tobytes() == r[3].tobytes()


def _jax_tx(params, mask, num_iter, the=1):
    jopt = jax_options(num_iter=num_iter)
    return jax_build_optimizer(jopt, jax_build_schedule(jopt, the=the), mask)


def _leaves(tree):
    return jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, tree))


def test_resume_in_step0_of_task0_is_bitwise(tmp_path):
    ref, ref_m, ref_seen = _drive(tmp_path / "a", tasks=1, eval_from=1)
    _drive(tmp_path / "b", tasks=1, eval_from=1, crash_after=5)  # snapshots at 2, 4
    path = _snapshot(tmp_path / "b", "Chinese_0_0")
    payload = load_train_state(path)
    assert payload["iteration"] == 4

    # the snapshot's opt_state is optax's state of the JAX optimizer
    params = payload["params"]
    tx = _jax_tx(params, jax.tree_util.tree_map(lambda _: True, params), 8)
    template = tx.init(params)
    restored = flax.serialization.from_state_dict(template, payload["opt_state"])
    assert jax.tree_util.tree_structure(restored) == jax.tree_util.tree_structure(template)
    adam = restored[1][1][0]
    assert int(adam.count) == 4 and int(restored[1][1][1].count) == 4
    for got, want in ((adam.mu, payload["opt_state"]["1"]["1"]["0"]["mu"]),
                      (adam.nu, payload["opt_state"]["1"]["1"]["0"]["nu"])):
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(params)
        for x, y in zip(_leaves(got), _leaves(want)):
            assert x.dtype == np.float32 and x.tobytes() == y.tobytes()

    res, res_m, res_seen = _drive(tmp_path / "b", tasks=1, eval_from=1, resume_full=True)
    assert not os.path.exists(path)      # the completed stage dropped its snapshot
    _same_steps(res_seen, ref_seen[4:])
    _same_tensors(res.expert_states[0], ref.expert_states[0])   # params and BN statistics
    _same_adam(res.state.opt, ref.state.opt)
    assert torch.equal(res.generator.get_state(), ref.generator.get_state())
    assert [r["loss"] for r in res.history] == [r["loss"] for r in ref.history[4:]]
    assert res_m.rng.bit_generator.state == ref_m.rng.bit_generator.state
    for a, b in zip(res_m.get_batch(), ref_m.get_batch()):
        assert list(a) == list(b)


def test_resume_in_routed_step3_of_task1_is_bitwise(tmp_path):
    """Every run after the first replays task 0 and task 1's step 0 from the
    first run's best checkpoints (``start_task=1.5``): a replay freezes task
    1's step-0 best expert where an unbroken run freezes its last iterate
    (in the JAX learner as here), so the reference replays as well."""
    _drive(tmp_path)
    ref, ref_m, ref_seen = _drive(tmp_path, start_task=1.5, eval_from=2)
    crashed, _, _ = _drive(tmp_path, start_task=1.5, eval_from=2, crash_after=2,
                           routed_only=True)
    path = _snapshot(tmp_path, "Latin_1_1")
    payload = load_train_state(path)
    assert payload["iteration"] == 2 and payload["batch_stats"] == {}
    assert set(payload["params"]) == {"dm_router", "channel_route", "route"}

    # the router-only opt_state merges into optax's state of the whole
    # routed tree, as the JAX learner's resume merges it
    params, _ = to_flax(crashed.mrn_model)
    mask = {k: jax.tree_util.tree_map(lambda _: k != "experts", v) for k, v in params.items()}
    tx = _jax_tx(params, mask, 8, the=2)
    state_dict = flax.serialization.to_state_dict(tx.init(params))
    deep_merge(state_dict, payload["opt_state"])
    restored = flax.serialization.from_state_dict(tx.init(params), state_dict)
    mu = restored[1][1][0].mu
    for k in ("dm_router", "channel_route", "route"):
        for x, y in zip(_leaves(mu[k]), _leaves(payload["opt_state"]["1"]["1"]["0"]["mu"][k])):
            assert x.tobytes() == y.tobytes()
    assert not any(x.any() for x in _leaves(mu["experts"]))

    res, res_m, res_seen = _drive(tmp_path, start_task=1.5, eval_from=2, resume_full=True)
    assert not os.path.exists(path)
    assert [s[1] for s in ref_seen] == ["routed"] * 4
    _same_steps(res_seen, ref_seen[2:])
    assert set(np.concatenate([s[3] for s in ref_seen]).tolist()) <= {0, 1}
    _same_tensors(res.router_state, ref.router_state)
    _same_tensors(res.expert_states[1], ref.expert_states[1])
    _same_adam(res.state.opt, ref.state.opt)
    assert torch.equal(res.generator.get_state(), ref.generator.get_state())
    assert res.np_rng.bit_generator.state == ref.np_rng.bit_generator.state
    assert res.weight_rng.bit_generator.state == ref.weight_rng.bit_generator.state
    assert [ix.tobytes() for ix in res.memory_index] == [ix.tobytes()
                                                         for ix in ref.memory_index]
    assert [r["loss"] for r in res.history] == [r["loss"] for r in ref.history[2:]]
    assert res_m.rng.bit_generator.state == ref_m.rng.bit_generator.state
    got, want = res_m.get_batch2(), ref_m.get_batch2()
    assert got[0].tobytes() == want[0].tobytes() and got[2].tobytes() == want[2].tobytes()


def test_weight_draws_leave_np_rng_alone(tmp_path):
    """Tasks 0 and 1 build their experts and router from ``weight_rng``:
    ``np_rng`` is left as a fresh generator of the seed, for the memory."""
    opt = _opt(tmp_path)
    learner = MRN(opt, device="cpu")
    learner.character = list(ALPHABETS[0])
    learner.converter = learner.build_converter()
    learner.build_model()
    learner._freeze_newest()
    learner.character = list("".join(ALPHABETS))
    learner.converter = learner.build_converter()
    learner.change_model()
    learner._freeze_newest()
    learner.start_router_phase()
    fresh = np.random.default_rng(opt.manual_seed)
    assert learner.np_rng.bit_generator.state == fresh.bit_generator.state
    # the experts came from weight_rng's stream
    draws = np.random.default_rng(np.random.SeedSequence(opt.manual_seed, spawn_key=(1,)))
    params, _ = random_recognizer(draws, opt, 4 + len(ALPHABETS[0]))
    assert not np.array_equal(params["fc"]["kernel"],
                              learner.expert_states[0]["fc.kernel"].numpy())  # reference init
    assert learner.weight_rng.bit_generator.state != draws.bit_generator.state
