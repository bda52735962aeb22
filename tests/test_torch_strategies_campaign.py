"""The port's strategies end to end on the CPU, float32, at a narrow width
(embed 16/32/64, depth 1/2/1, img 32x128, batch 4, 2 tasks, ``num_iter`` 4
or 8), through ``campaign.run_incremental`` / ``run_joint`` with the
prefetcher on:

- every strategy writes every field of ``ACCURACY_RUNS/t6/svtr_*.json``
  (plus the device) and runs its own terms (KD, the align, the Fisher
  penalty, DER's second extractor, the joint tests);
- base, LwF, WA, EWC and MRN end task 0 with the same model, bitwise;
- a WA run and a DER run that crash in task 1 and resume (``start_task=1``
  replaying task 0, ``resume_full`` restoring the snapshot) end bitwise
  where the unbroken run ends, on the same batches;
- an EWC ``start_task=1`` replay has the unbroken run's Fisher and mean
  (read from the file beside the best checkpoint; without it the Fisher is
  recomputed as the JAX learner does)."""

import json
import os

import numpy as np
import pytest
import torch

from mrn_tpu_torch.bridge import to_flax
from mrn_tpu_torch.campaign import (LANS, campaign_options, campaign_record, run_incremental,
                                    run_joint)
from mrn_tpu_torch.data.synthetic import SyntheticSource
from mrn_tpu_torch.train.learners import build_learner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SVTR = dict(embed_dim=(16, 32, 64), depth=(1, 2, 1), num_heads=(2, 2, 4))
ALPHABETS = ["abcdefghij", "klmnop"]
SOURCE = SyntheticSource(ALPHABETS, LANS[:2], n_train=[24, 20], n_test=[6, 6], img_h=32,
                         img_w=128, seed=3, device_bank=True, renderer="bits", max_len=5)
ILS = ["base", "lwf", "wa", "ewc", "der", "joint_mix", "joint_loader"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch's CPU ops on one thread here: beside the other test workers,
    more threads oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _opt(out, il, tasks=2, num_iter=4, **kw):
    opt = campaign_options(tasks=tasks, num_iter=num_iter, batch_size=4, seed=3, out=str(out),
                           il=il, **dict(dict(svtr=SVTR, output_channel=32, hidden_size=16,
                                              imgW=128, val_interval=2, memory_num=8), **kw))
    opt.image_bank = SOURCE.device_bank("cpu")
    return opt


def _trees(model):
    params, stats = to_flax(model)
    return {"params": params, "stats": stats}


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    else:
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


class _Crash(Exception):
    pass


def _drive(opt, crash_after=None):
    """A campaign run recording each task-1 step's batch; it raises after
    ``crash_after`` task-1 steps and the crash is swallowed.  Returns the
    learner, the batches, the result and task 0's model at its end."""
    learner = build_learner(opt, device="cpu")
    seen, task0 = [], {}
    step, after = learner.train_step, learner.after_task

    def train_step(fetched):
        if learner._cur_task == 1:
            if crash_after is not None and len(seen) >= crash_after:
                raise _Crash()
            seen.append(np.asarray(fetched[0]).copy())
        return step(fetched)

    def after_task():
        if learner._cur_task == 0:
            task0.update(_trees(learner.model))
            task0["fisher"] = {k: v.clone() for k, v in (getattr(learner, "fisher", None)
                                                         or {}).items()}
        after()

    learner.train_step, learner.after_task = train_step, after_task
    run = run_joint if opt.il.startswith("joint") else run_incremental
    result = None
    try:
        result = run(opt, SOURCE, learner=learner)[1:]
    except _Crash:
        pass
    return learner, seen, result, task0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each strategy's 2-task run, and MRN's task 0."""
    out = {}
    for il in ILS:
        opt = _opt(tmp_path_factory.mktemp(il), il)
        out[il] = (opt,) + _drive(opt)
    opt = _opt(tmp_path_factory.mktemp("mrn"), "mrn", tasks=1)
    out["mrn"] = (opt,) + _drive(opt)
    return out


@pytest.mark.parametrize("il", ILS)
def test_strategy_writes_the_t6_record(runs, il):
    opt, learner, _, (aia, matrix, seconds), _ = runs[il]
    record = campaign_record(il, opt.num_iter, False, opt.batch_size, opt.manual_seed,
                             [24, 20], [6, 6], aia, matrix, seconds, sum(seconds), "cpu")
    with open(os.path.join(ROOT, "ACCURACY_RUNS", "t6", "svtr_wa.json"), encoding="utf-8") as f:
        t6 = json.load(f)
    assert set(t6) | {"device", "tf32"} == set(record) and record["il"] == il
    json.dumps(record)
    if il.startswith("joint"):
        assert [len(r) for r in matrix] == [2] and record["avg_forgetting"] is None
        best, ned = learner._joint_scores
        # test() at iterations 2 and 4 in the loop, then run_joint's own
        assert len(best) == len(ned) == 3
        # one task on every task's characters
        assert learner._cur_task == 0 and learner._total_classes == runs["base"][1]._total_classes
        assert len(learner.history) == opt.num_iter
    else:
        assert [len(r) for r in matrix] == [1, 2] and len(seconds) == 2
        assert record["avg_forgetting"] == round(matrix[0][0] - matrix[1][0], 2)
        assert len(learner.history) == 2 * opt.num_iter
    assert all(np.isfinite(r["loss"]) for r in learner.history)
    task1 = [r for r in learner.history if r["task"] == 1]
    log = open(os.path.join(opt.output_dir, opt.exp_name, "log_train.txt"),
               encoding="utf-8").read()
    if il in ("lwf", "wa"):
        assert all(r["kd"] > 0 and np.isfinite(r["kd"]) for r in task1)
        assert learner._old_model is not None and learner._known_classes == \
            learner._total_classes
    if il in ("wa", "der"):
        # WA: end of task 1's loop, then after_task; DER: end of the loop
        assert log.count("alignweights,gamma=") == (2 if il == "wa" else 1)
        assert learner.memory_index and len(learner.memory_index[0]) == 8
    if il == "ewc":
        assert all(r["ewc"] >= 0 and np.isfinite(r["ewc"]) for r in task1)
        assert learner.fisher["fc.kernel"].shape == learner.model.fc.kernel.shape
        assert max(float(f.max()) for f in learner.fisher.values()) <= 1e-4
    if il == "der":
        assert learner.n_experts == 2 and all("aux" in r for r in task1)
        assert learner.model.fc.kernel.shape[0] == 2 * opt.hidden_size
    if il in ("base", "lwf", "ewc"):
        assert learner.memory_index == []


def test_task0_is_the_same_model_for_base_lwf_wa_ewc_and_mrn(runs):
    ref = runs["mrn"][4]
    for il in ("base", "lwf", "wa", "ewc"):
        got = runs[il][4]
        _assert_same({k: got[k] for k in ("params", "stats")},
                     {k: ref[k] for k in ("params", "stats")})
    assert runs["base"][3][1][0] == runs["mrn"][3][1][0]   # the same stage-0 score


@pytest.mark.parametrize("il", ["wa", "der"])
def test_crash_in_task1_resumes_bitwise(tmp_path, il):
    kw = dict(num_iter=8, full_ckpt=True)
    ref, ref_seen, _, _ = _drive(_opt(tmp_path, il, **kw))
    _drive(_opt(tmp_path / "crashed", il, **kw), crash_after=5)
    snapshot = os.path.join(str(tmp_path / "crashed"), "saved", f"acc_svtr_{il}",
                            f"{LANS[1]}_1_train_state.msgpack")
    assert os.path.exists(snapshot)
    res, res_seen, _, _ = _drive(_opt(tmp_path / "crashed", il, start_task=1,
                                      resume_full=True, **kw))
    assert not os.path.exists(snapshot)
    assert len(res_seen) == 8 - 4    # resumed after the snapshot of iteration 4
    for g, r in zip(res_seen, ref_seen[4:]):
        assert g.tobytes() == r.tobytes()
    _assert_same(_trees(res.model), _trees(ref.model))
    assert res.state.opt.count == ref.state.opt.count == 8
    for key in res.state.opt.MOMENTS:
        for a, b in zip(getattr(res.state.opt, key), getattr(ref.state.opt, key)):
            assert torch.equal(a, b)
    assert torch.equal(res.generator.get_state(), ref.generator.get_state())
    assert [ix.tobytes() for ix in res.memory_index] == [ix.tobytes() for ix in ref.memory_index]
    if il == "der":
        assert list(res.state.params) == list(ref.state.params)
        assert not any(k.startswith("extractors.0.") for k in res.state.params)


def test_ewc_replay_has_the_unbroken_fisher(tmp_path):
    opt = _opt(tmp_path, "ewc")
    _, _, _, task0 = _drive(opt)
    assert task0["fisher"]
    _, _, _, replayed = _drive(_opt(tmp_path, "ewc", start_task=1, eval_from=1))
    for k, v in task0["fisher"].items():
        assert torch.equal(replayed["fisher"][k], v)
    os.remove(os.path.join(opt.output_dir, opt.exp_name, f"{LANS[0]}_0_ewc.msgpack"))
    _, _, _, recomputed = _drive(_opt(tmp_path, "ewc", start_task=1, eval_from=1))
    assert recomputed["fisher"].keys() == task0["fisher"].keys()
    for k, v in recomputed["fisher"].items():
        assert v.shape == task0["fisher"][k].shape and torch.isfinite(v).all()
        assert float(v.max()) <= 1e-4
