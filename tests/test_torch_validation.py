"""The port's validation, ``test`` and best-checkpoint learner loop against
the JAX package's (``mrn_tpu/train/evaluate.py``, the validation half of
``mrn_tpu/train/learners/base.py`` and MRN's composite checkpoints), float32
on the CPU, at the narrow SVTR of ``tests/test_torch_train_step.py`` (embed
16/32/64, depth 2/4/2, imgW 128), same weights through the bridge and the
same seeded crops.

The JAX side evaluates on its composed XLA Block (exact erf, max-subtract
softmax); the port on its fused inference Block's plain version, its GELU
set to the degree-15 erf fit (as ``tests/test_torch_mrn_slice.py`` does):
logits agree to float32 noise through 8 Blocks (about 1e-5 here)."""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

import mrn_tpu.models.composer as jax_composer
import mrn_tpu.models.svtr as jax_svtr
from mrn_tpu.config import load_config as jax_load_config
from mrn_tpu.data.dataset import ArrayDataset as JaxArrayDataset
from mrn_tpu.data.manager import ValDataset as JaxValDataset
from mrn_tpu.ops.ctc import ctc_loss_per_sample as jax_ctc_per_sample
from mrn_tpu.train.checkpoint import load_model as jax_load_model
from mrn_tpu.train.learners.mrn import MRN as JaxMRN
from mrn_tpu.utils import Averager as JaxAverager
from mrn_tpu_torch.bridge import from_flax, recognizer_state, state_to_flax, to_flax
from mrn_tpu_torch.config import load_config
from mrn_tpu_torch.data.manager import ValDataset
from mrn_tpu_torch.data.synthetic import (SyntheticTaskLoader, alphabet_of_size,
                                          synthetic_val_set)
from mrn_tpu_torch.models.composer import build_recognizer
from mrn_tpu_torch.models.svtr import Block
from mrn_tpu_torch.ops.ctc import ctc_loss_per_sample
from mrn_tpu_torch.serve import Server
from mrn_tpu_torch.train.checkpoint import load_model
from mrn_tpu_torch.train.learners import base as port_base
from mrn_tpu_torch.train.learners.mrn import MRN, tree_hash

SVTR = dict(embed_dim=(16, 32, 64), depth=(2, 4, 2), num_heads=(2, 2, 4),
            drop_path_rate=0.0)
IMG_W, BATCH, N_VAL = 128, 6, 10        # 10 crops: a full batch and a padded one
ALPHABETS = [alphabet_of_size(10), alphabet_of_size(6, 0x4E00 + 10)]
LANS = ["T0", "T1"]
# the validation loss is a mean over the batch of per-sample CTC over
# max(length, 1): each a log-sum over paths of the logits, which agree to
# float32 noise (degree-15 erf fit against the exact erf, clamp-exp against
# max-subtract softmax; max |diff| 1.6e-5 measured); the loss measured 0
# (FF) and 4.4e-8 (TF) relative: bound 1e-5
LOSS_RTOL = 1e-5
# confidences: a product of T = 32 max-softmax values, each to float32
# noise (measured 2.0e-5 relative at most)
CONF_RTOL = 1e-4
# a greedy pick may differ only where JAX's top-2 logit margin is below this
# (6x the logits' measured noise; the smallest margin here is 1.7e-3)
TIE = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch's CPU ops on one thread here: beside the other test workers,
    more threads oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def narrow():
    """The JAX package with the narrow SVTR; every port Block with the
    degree-15 erf fit."""

    class NarrowSVTR(jax_svtr.SVTRExtractor):
        embed_dim: tuple = SVTR["embed_dim"]
        depth: tuple = SVTR["depth"]
        num_heads: tuple = SVTR["num_heads"]
        drop_path_rate: float = SVTR["drop_path_rate"]

    block_init = Block.__init__

    def init15(self, *args, **kwargs):
        block_init(self, *args, **kwargs)
        self.gelu_degree = 15

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_composer, "SVTRExtractor", NarrowSVTR)
    mp.setattr(Block, "__init__", init15)
    jax_svtr.set_attention_impl("xla")
    jax_svtr.set_train_gelu("erf")
    yield
    jax_svtr.set_train_gelu("auto")
    jax_svtr.set_attention_impl("auto")
    mp.undo()


def _options(out, **kw):
    common = dict(dict(imgW=IMG_W, output_channel=32, hidden_size=16, batch_size=BATCH,
                       num_iter=2, val_interval=2, manual_seed=3, memory=None,
                       lan_list=LANS, output_dir=str(out),
                       data_log=str(out / "data_any.txt")), **kw)
    jopt = jax_load_config("configs/svtr_mrn.py", prefetch=False, **common)
    topt = load_config("configs/svtr_mrn.py", svtr=SVTR, **common)
    return jopt, topt


def _chars(taski):
    return "".join(ALPHABETS[:taski + 1])


def _loader(taski):
    return SyntheticTaskLoader(ALPHABETS, taski, BATCH, 8, img_w=IMG_W, max_len=5, seed=taski)


# two test sets per task (the MLT17 / MLT19 pair), own seeds
_SETS = {f"{year}/{lan}": synthetic_val_set(ALPHABETS, t, N_VAL, img_w=IMG_W, max_len=5,
                                            seed=100 * (k + 1) + t)
         for t, lan in enumerate(LANS) for k, year in enumerate(("17", "19"))}


def _valid_datas(taski):
    return [f"{y}/{lan}" for lan in LANS[:taski + 1] for y in ("17", "19")]


def _jax_set(name):
    """The same crops, normalised on the host as the port's device does."""
    ds = _SETS[name]
    return JaxArrayDataset(list((ds.images.astype(np.float32) / 255.0 - 0.5) / 0.5), ds.labels)


def _port_set(name):
    return _SETS[name]


class _JaxStream:
    """The synthetic loader with the ``DatasetManager`` calls the JAX MRN
    learner makes (no rehearsal memory: ``memory=None``)."""

    def __init__(self, loader):
        self.loader = loader

    def get_dataset(self, taski, memory=None, index_list=None):
        pass

    def get_batch(self):
        return self.loader.get_batch()

    def get_batch2(self):
        return self.loader.get_batch2()


# ------------------------------------------------------------ helpers
def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _assert_bitwise(got, ref, what):
    got, ref = dict(_leaves(got)), dict(_leaves(jax.tree_util.tree_map(np.asarray, ref)))
    assert got.keys() == ref.keys(), what
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, f"{what}: {k}"
        assert got[k].tobytes() == ref[k].tobytes(), f"{what}: {k}"


def _assert_results_match(got, ref):
    """Scores, NED and words exactly; loss and confidences to float32
    noise."""
    assert got.length_of_data == ref.length_of_data
    assert got.labels == ref.labels
    assert got.preds == ref.preds
    assert got.score == ref.score and got.ned == ref.ned
    np.testing.assert_allclose(got.loss, ref.loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got.confidences, ref.confidences, rtol=CONF_RTOL, atol=1e-30)


def _assert_picks(got_logits, ref_logits):
    """Greedy picks equal, except where JAX's top-2 margin is a near-tie."""
    top2 = np.sort(ref_logits, axis=-1)[..., -2:]
    flips = got_logits.argmax(-1) != ref_logits.argmax(-1)
    assert np.all((top2[..., 1] - top2[..., 0])[flips] < TIE)


def _spread_experts(jopt, counts, seed):
    """Init experts with their fc spread (init weights give near-equal
    logits), as flax trees."""
    rng = np.random.default_rng(seed)
    experts = []
    for i, count in enumerate(counts):
        model = jax_composer.build_recognizer(jopt, count)
        v = jax.jit(lambda k, m=model: m.init({"params": k}, np.zeros((2, 32, IMG_W, 4),
                                                                      np.float32),
                                              train=False))(jax.random.PRNGKey(seed + i))
        v = jax.tree_util.tree_map(np.asarray, v)
        v["params"]["fc"]["kernel"] = 3 * rng.standard_normal(
            v["params"]["fc"]["kernel"].shape).astype(np.float32)
        experts.append((v["params"], v["batch_stats"]))
    return experts


# ------------------------------------------------------------ run_validation
@pytest.fixture(scope="module")
def learners(narrow, tmp_path_factory):
    """A JAX and a port learner holding the same two experts and router;
    the port's under the bf16 policy, whose TF validation runs a float32
    copy of the experts."""
    out = tmp_path_factory.mktemp("val")
    jopt, topt = _options(out)
    counts = (4 + len(ALPHABETS[0]), 4 + len(_chars(1)))
    experts = _spread_experts(jopt, counts, 21)
    jl = JaxMRN(jopt)
    jl.character = _chars(1)
    jl.converter = jl.build_converter()
    jl.expert_params = [p for p, _ in experts]
    jl.expert_stats = [s for _, s in experts]
    jl.class_counts = list(counts)
    jl._build_mrn_module(n_experts=2, counts=counts)
    router = jax.tree_util.tree_map(np.asarray, jl._init_router_params())
    rng = np.random.default_rng(4)
    for key in ("channel_route", "route"):   # routing that varies per sample
        router[key]["kernel"] = rng.standard_normal(router[key]["kernel"].shape).astype(np.float32)

    tl = MRN(topt.replace(train_dtype="bf16"), device="cpu")
    tl.character = list(_chars(1))
    tl.converter = tl.build_converter()
    for (p, s), count in zip(experts, counts):
        tl.add_expert(p, s, count)
    tl.start_router_phase(router)
    return dict(jl=jl, tl=tl, experts=experts, router=router, jopt=jopt, topt=topt)


def _jax_loader(jl, names):
    return JaxValDataset(names, jl.opt, dataset_factory=_jax_set).create_list_dataset()


def _port_loader(tl, names):
    return ValDataset(names, tl.opt, _port_set).create_list_dataset()


def test_run_validation_ff_matches_jax(learners):
    jl, tl = learners["jl"], learners["tl"]
    params, stats = learners["experts"][1]
    jl._phase, tl._phase = "standalone", "standalone"
    jl.model = jax_composer.build_recognizer(jl.opt, jl._total_classes)
    jl.params, jl.batch_stats = params, stats
    tl.model = build_recognizer(tl.opt, tl._total_classes)
    tl.model.load_state_dict(from_flax(params, stats), strict=True)
    names = ["17/T1"]
    ref = jl.run_validation(_jax_loader(jl, names), "FF")
    got = tl.run_validation(_port_loader(tl, names), "FF")
    assert got.length_of_data == N_VAL
    _assert_results_match(got, ref)


def test_run_validation_tf_matches_jax(learners):
    jl, tl = learners["jl"], learners["tl"]
    jl._phase, tl._phase = "routed", "routed"
    jl.params, jl.batch_stats = jl._routed_variables(learners["router"])
    names = _valid_datas(1)
    ref = jl.run_validation(_jax_loader(jl, names), "TF")
    got = tl.run_validation(_port_loader(tl, names), "TF")
    assert got.length_of_data == 4 * N_VAL
    _assert_results_match(got, ref)
    # float32 experts, the training ensemble's router modules, built once
    ens = tl._eval_ensemble()
    assert ens is not tl.mrn_model and ens is tl._eval_ensemble()
    assert all(p.dtype == torch.float32 for p in ens.experts.parameters())
    assert all(p.dtype == torch.bfloat16 for p in tl.mrn_model.experts.parameters())
    assert ens.route is tl.mrn_model.route and ens.dm_router is tl.mrn_model.dm_router


def test_eval_logits_and_picks_match_jax(learners):
    """TF logits on one padded batch, and each pick (near-ties aside)."""
    jl, tl = learners["jl"], learners["tl"]
    jl._phase, tl._phase = "routed", "routed"
    jl.params, jl.batch_stats = jl._routed_variables(learners["router"])
    images = _jax_set("19/T1").images[:BATCH]
    ref = np.asarray(jl.mrn_model.apply({"params": jl.params, "batch_stats": jl.batch_stats},
                                        np.stack(images), cross=True, train=False,
                                        is_train=False)["logits"])
    with torch.no_grad():
        got = tl._eval_logits(tl._device_images(_SETS["19/T1"].images[:BATCH]), "TF").numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    _assert_picks(got, ref)


def test_eval_batch_image_forms_agree(learners):
    """uint8 crops, normalised float crops and bank indices give the same
    outputs."""
    tl = learners["tl"]
    tl._phase = "routed"
    u8 = _SETS["17/T0"].images[:BATCH]
    labels, lengths = tl.converter.encode(_SETS["17/T0"].labels[:BATCH],
                                          batch_max_length=tl.opt.batch_max_length)
    outs = [tl.eval_batch(u8, labels, lengths, "TF"),
            tl.eval_batch((u8.astype(np.float32) / 255.0 - 0.5) / 0.5, labels, lengths, "TF")]
    tl.opt = tl.opt.replace(image_bank=u8)
    outs.append(tl.eval_batch(np.arange(BATCH, dtype=np.int32), labels, lengths, "TF"))
    for out in outs[1:]:
        for k in outs[0]:
            np.testing.assert_array_equal(out[k], outs[0][k])


def test_ctc_per_sample_matches_jax_on_feasible_labels(rng):
    b, t, c, n = 6, 8, 7, 10
    logits = rng.standard_normal((b, t, c)).astype(np.float32)
    labels = rng.integers(1, c, (b, n)).astype(np.int32)
    lengths = np.array([3, 6, 0, 8, 2, 5], np.int32)
    labels[1, :6] = [2, 2, 2, 2, 3, 3]        # 6 + 4 repeats > T: infeasible
    ref = np.asarray(jax_ctc_per_sample(logits, labels, lengths))
    got = ctc_loss_per_sample(torch.from_numpy(logits), torch.from_numpy(labels),
                              torch.from_numpy(lengths)).numpy()
    within = np.arange(1, n)[None, :] < lengths[:, None]
    repeats = np.sum((labels[:, 1:] == labels[:, :-1]) & within, axis=1)
    feasible = lengths + repeats <= t
    assert feasible.any() and not feasible.all()
    np.testing.assert_allclose(got[feasible], ref[feasible], rtol=1e-5)
    # infeasible: inf here (zeroed by the validation), optax's ~1e5 in JAX
    assert np.all(np.isinf(got[~feasible])) and np.all(ref[~feasible] > 1e4)


# ------------------------------------------------------------ the loop
def _port_learner(out, **kw):
    _, topt = _options(out, **kw)
    loader = _loader(0)
    learner = MRN(topt.replace(image_bank=loader.bank), device="cpu")
    return learner, loader


def test_run_loop_validates_and_averages_losses(narrow, tmp_path, monkeypatch):
    """Validation at iteration 1, every val_interval and the last
    iteration; the logged train loss is the mean of the window's step
    losses (JAX's ``Averager`` over the same values), read back through at
    most MAX_IN_FLIGHT losses in flight."""
    monkeypatch.setattr(port_base, "MAX_IN_FLIGHT", 1)
    learner, loader = _port_learner(tmp_path, num_iter=4, val_interval=3)
    seen = []
    val = learner.val

    def spy(valid_loader, opt, best_score, start_time, iteration, avg, taski, **kw):
        seen.append((iteration, avg.val(), avg.n_count))
        return val(valid_loader, opt, best_score, start_time, iteration, avg, taski, **kw)

    learner.val = spy
    learner.incremental_train(0, _chars(0), loader,
                              ValDataset(["17/T0"], learner.opt, _port_set))
    assert [s[0] for s in seen] == [1, 3, 4]
    losses = [r["loss"] for r in learner.history]
    assert all(isinstance(v, float) and np.isfinite(v) for v in losses)
    for (iteration, mean, count), window in zip(seen, ([0], [1, 2], [3])):
        ref = JaxAverager()
        for i in window:
            ref.add(np.float32(losses[i]))
        assert count == len(window) and mean == ref.val()
        assert all(learner.history[i]["seconds"] > 0 for i in window)
    log = open(os.path.join(tmp_path, "SVTR_MRN", "log_train.txt")).read()
    assert log.count("Current_score:") == 3 and "Total parameters:" in log
    assert os.path.exists(learner._best_path(0, 0))


def test_task0_freezes_the_best_checkpoint(narrow, tmp_path):
    """The best score is forced at iteration 1: ``test`` reloads that
    checkpoint and ``after_task`` freezes it, not the last iteration's
    expert."""
    learner, loader = _port_learner(tmp_path, num_iter=3, val_interval=5)
    run = learner.run_validation

    def first_is_best(loader, val_choose="val"):
        res = run(loader, val_choose)
        res.score = 100.0 - len(learner.history)
        return res

    learner.run_validation = first_is_best
    names = ["17/T0"]
    learner.incremental_train(0, _chars(0), loader, ValDataset(names, learner.opt, _port_set))
    last = {k: v.clone() for k, v in learner.model.state_dict().items()}
    learner.test(names, [], [], 0,
                 val_dataset_builder=lambda v: ValDataset([v], learner.opt, _port_set)
                 .create_dataset())
    learner.after_task()
    payload = load_model(learner._best_path(0, 0))
    _assert_bitwise(state_to_flax(learner.expert_states[0])[0], payload["params"], "frozen")
    assert not torch.equal(learner.expert_states[0]["fc.kernel"], last["fc.kernel"])


# ------------------------------------------------------------ 2-task runs
def _jax_run(out):
    jopt, _ = _options(out)
    jl = JaxMRN(jopt)
    best, ned = [], []
    for taski in (0, 1):
        loader = _loader(taski)
        jl.opt.image_bank = loader.bank
        valid = _valid_datas(taski)
        jl.incremental_train(taski, _chars(taski), _JaxStream(loader),
                             JaxValDataset(valid, jl.opt, dataset_factory=_jax_set))
        best, ned = jl.test(valid, best, ned, taski, val_dataset_builder=lambda v: JaxValDataset(
            [v], jl.opt, dataset_factory=_jax_set).create_dataset())
        jl.after_task()
    return jl, best, ned


def _port_test(learner, taski, best, ned):
    return learner.test(_valid_datas(taski), best, ned, taski,
                        val_dataset_builder=lambda v: ValDataset([v], learner.opt, _port_set)
                        .create_dataset())


def _port_run(out):
    _, topt = _options(out)
    learner, best, ned = None, [], []
    for taski in (0, 1):
        loader = _loader(taski)
        if learner is None:
            learner = MRN(topt, device="cpu")
        learner.opt = learner.opt.replace(image_bank=loader.bank)
        learner.incremental_train(taski, _chars(taski), loader,
                                  ValDataset(_valid_datas(taski), learner.opt, _port_set))
        best, ned = _port_test(learner, taski, best, ned)
        learner.after_task()
    return learner, best, ned


@pytest.fixture(scope="module")
def runs(narrow, tmp_path_factory):
    root = tmp_path_factory.mktemp("runs")
    jl, jbest, jned = _jax_run(root / "jax")
    tl, tbest, tned = _port_run(root / "port")
    return dict(root=root, jl=jl, jbest=jbest, jned=jned, tl=tl, tbest=tbest, tned=tned)


FILES = ["T0_0_0_best_score.msgpack", "T1_1_0_best_score.msgpack", "T1_1_1_best_score.msgpack"]


def _exp(root, side):
    return root / side / "SVTR_MRN"


def test_both_runs_write_the_same_files(runs):
    for side in ("jax", "port"):
        names = sorted(os.listdir(_exp(runs["root"], side)))
        assert names == sorted(FILES + ["experts", "log_train.txt"]), side
        assert len(os.listdir(_exp(runs["root"], side) / "experts")) == 2, side
    for name in FILES:
        j = jax_load_model(str(_exp(runs["root"], "jax") / name))
        t = load_model(str(_exp(runs["root"], "port") / name))
        assert sorted(j) == sorted(t) == sorted(["params", "batch_stats", "expert_refs",
                                                 "expert_stats", "router"]), name
        assert len(j["expert_refs"]) == len(t["expert_refs"]), name
        assert sorted(j["params"]) == sorted(t["params"]), name


@pytest.mark.parametrize("name", FILES)
def test_port_restores_jax_checkpoints_bitwise(runs, name):
    exp = _exp(runs["root"], "jax")
    ref = JaxMRN(runs["jl"].opt)
    ref.restore_composite(jax_load_model(str(exp / name)), expert_dir=str(exp / "experts"))
    _, topt = _options(runs["root"] / "port_reads")
    tl = MRN(topt, device="cpu")
    tl._total_classes = 4 + len(_chars(int(name[1])))
    tl.restore_composite(load_model(str(exp / name)), expert_dir=str(exp / "experts"))
    assert tl.class_counts == [int(np.shape(p["fc"]["kernel"])[1]) for p in ref.expert_params]
    assert tl._expert_hashes == ref._expert_hashes
    for i, state in enumerate(tl.expert_states):
        params, stats = state_to_flax(state)
        _assert_bitwise(params, ref.expert_params[i], f"{name} expert {i}")
        _assert_bitwise(stats, ref.expert_stats[i], f"{name} expert {i} stats")
    if ref.router_params:
        _assert_bitwise(state_to_flax(tl.router_state)[0], ref.router_params, f"{name} router")
    if "dm_router" not in ref.params:   # a step-0 file: the standalone expert
        _assert_bitwise(to_flax(tl.model)[0], ref.params, f"{name} params")
        _assert_bitwise(to_flax(tl.model)[1], ref.batch_stats, f"{name} stats")


@pytest.mark.parametrize("name", FILES)
def test_jax_restores_port_checkpoints_bitwise(runs, name):
    exp = _exp(runs["root"], "port")
    payload = load_model(str(exp / name))
    ref = JaxMRN(runs["jl"].opt)
    ref.restore_composite(jax_load_model(str(exp / name)), expert_dir=str(exp / "experts"))
    _assert_bitwise(payload["params"], ref.params, name)
    experts = [load_model(str(exp / "experts" / f"{r}.msgpack")) for r in payload["expert_refs"]]
    for i, blob in enumerate(experts):
        _assert_bitwise(blob["params"], ref.expert_params[i], f"{name} expert {i}")
        _assert_bitwise(payload["expert_stats"][i], ref.expert_stats[i], f"{name} stats {i}")
    if payload["router"]:
        _assert_bitwise(payload["router"], ref.router_params, f"{name} router")
    # the port's last state, as trained and reloaded, is what it wrote
    if name == FILES[-1]:
        tl = runs["tl"]
        for i, state in enumerate(tl.expert_states):
            _assert_bitwise(state_to_flax(state)[0], ref.expert_params[i], f"expert {i}")


def test_blob_names_equal_on_both_sides(runs):
    for side in ("jax", "port"):
        exp = _exp(runs["root"], side)
        payload = jax_load_model(str(exp / FILES[-1]))
        for ref in payload["expert_refs"]:
            blob = jax_load_model(str(exp / "experts" / f"{ref}.msgpack"))
            assert JaxMRN._tree_hash(blob["params"], blob["batch_stats"]) == ref, side
            port_blob = load_model(str(exp / "experts" / f"{ref}.msgpack"))
            assert tree_hash(port_blob["params"], port_blob["batch_stats"]) == ref, side
    tl = runs["tl"]
    assert tl._expert_hashes == [tree_hash(*state_to_flax(s)) for s in tl.expert_states]


def test_test_on_jax_checkpoints_matches_jax(runs, tmp_path):
    """The port's ``test`` (task 0 FF, task 1 TF with ``double_write``) on
    the JAX run's files gives its accuracies, AIA and data-log lines."""
    shutil.copytree(_exp(runs["root"], "jax"), tmp_path / "SVTR_MRN")
    _, topt = _options(tmp_path)
    tl = MRN(topt.replace(data_log=str(tmp_path / "port_data.txt")), device="cpu")
    best, ned = [], []
    for taski in (0, 1):
        tl._cur_task = taski
        tl.character = list(_chars(taski))
        tl.converter = tl.build_converter()
        best, ned = _port_test(tl, taski, best, ned)
        tl.after_task()
    assert (best, ned) == (runs["jbest"], runs["jned"])
    assert open(tmp_path / "port_data.txt").read() == \
        open(runs["root"] / "jax" / "data_any.txt").read()
    assert "Avg Incremental Acc: 17:" in open(tmp_path / "SVTR_MRN" / "log_train.txt").read()


def test_legacy_inline_layout(runs, tmp_path):
    """A checkpoint with the experts inline (no ``expert_refs``) restores
    the same experts on both sides."""
    exp = _exp(runs["root"], "jax")
    ref = JaxMRN(runs["jl"].opt)
    ref.restore_composite(jax_load_model(str(exp / FILES[-1])), expert_dir=str(exp / "experts"))
    from mrn_tpu.train.checkpoint import save_model as jax_save_model
    path = str(tmp_path / "legacy.msgpack")
    jax_save_model(path, ref.params, {}, extra={"experts": ref.expert_params,
                                                "expert_stats": ref.expert_stats,
                                                "router": ref.router_params})
    _, topt = _options(tmp_path)
    tl = MRN(topt, device="cpu")
    tl._total_classes = 4 + len(_chars(1))
    tl.restore_composite(load_model(path))
    assert tl._expert_hashes == [None, None]
    for i, state in enumerate(tl.expert_states):
        params, stats = state_to_flax(state)
        _assert_bitwise(params, ref.expert_params[i], f"expert {i}")
        _assert_bitwise(stats, ref.expert_stats[i], f"expert {i} stats")
    _assert_bitwise(state_to_flax(tl.router_state)[0], ref.router_params, "router")


def test_server_from_jax_checkpoint(runs):
    """``Server.from_checkpoint`` serves the JAX run's files: task 1's
    router over the blobs (the learner's TF logits, bitwise: same weights,
    same code) and task 0's recognizer."""
    exp = _exp(runs["root"], "jax")
    _, topt = _options(runs["root"] / "serve")
    images = _SETS["19/T1"].images[:BATCH]
    srv = Server.from_checkpoint(topt, str(exp / FILES[-1]), _chars(1), 1, device="cpu")
    tl = MRN(topt, device="cpu")
    tl._total_classes = 4 + len(_chars(1))
    tl._phase = "routed"
    tl.restore_composite(load_model(str(exp / FILES[-1])), expert_dir=str(exp / "experts"))
    with torch.no_grad():
        ref = tl._eval_logits(tl._device_images(images), "TF")
    torch.testing.assert_close(srv.forward(images)["logits"], ref, atol=0, rtol=0)
    assert srv.model.class_counts == tuple(tl.class_counts)

    srv0 = Server.from_checkpoint(topt, str(exp / FILES[0]), _chars(0), 0, device="cpu")
    payload = jax_load_model(str(exp / FILES[0]))
    model = build_recognizer(topt, 4 + len(_chars(0)))
    model.load_state_dict(recognizer_state(payload["params"], payload["batch_stats"]))
    with torch.no_grad():
        ref0 = model(torch.as_tensor((images.astype(np.float32) / 255.0 - 0.5) / 0.5))["predict"]
    torch.testing.assert_close(srv0.forward(images)["logits"], ref0, atol=0, rtol=0)
