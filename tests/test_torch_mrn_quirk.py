"""MRN's drifting-statistics mode (``mrn_pin_expert_stats=False``, the
reference's quirk as the JAX learner runs it) against the JAX package and
against the pinned default, float32 on the CPU, CRNN narrow (output_channel
64, hidden 32, 32x64 crops, batch 4): one router step's drifted expert
statistics and losses against JAX's, the pinned mode's statistics bitwise
unchanged, the write-back into the frozen experts with their blob hashes
invalidated after the router phase, a router-phase snapshot that carries
the drifted statistics and a resume that restores them, a best payload's
statistics superseding its blobs', the bf16 policy's TF ensemble reading
the drifting statistics, and SVTR experts drawing DropPath in that mode."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrn_tpu.config import load_config as jax_load_config
from mrn_tpu.train.learners.mrn import MRN as JaxMRN
from mrn_tpu_torch.bridge import flax_tree, recognizer_state, to_flax
from mrn_tpu_torch.config import load_config
from mrn_tpu_torch.data.manager import ValDataset
from mrn_tpu_torch.data.synthetic import (SyntheticTaskLoader, alphabet_of_size,
                                          synthetic_val_set)
from mrn_tpu_torch.models.common import BatchNorm
from mrn_tpu_torch.models.init import random_recognizer, random_router
from mrn_tpu_torch.train.checkpoint import load_model, load_train_state, save_model
from mrn_tpu_torch.train.learners.mrn import MRN

IMG = (32, 64, 4)
OC, HID, BATCH, BML = 64, 32, 4, 6
ALPHABETS = [alphabet_of_size(10), alphabet_of_size(6, 0x4E00 + 10)]
ROUTER_KEYS = ("dm_router", "channel_route", "route")
# One router step with the experts in train mode: each expert's two
# BatchNorms (bn4, bn5) move by 0.1 of the batch moments over 4 x 4 x 16
# values, float32 in both frameworks: 1e-5 absolute plus relative
# (measured 2.4e-7 absolute); the losses to float32 rounding, 1e-5 relative; the
# router gradients as tests/test_torch_crnn.py holds the pinned step's
STATS_TOL = 1e-5
LOSS_RTOL = 1e-5
ROUTER_GRAD_SCALE, ROUTER_GRAD_FLOOR = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _options(tmp, config="configs/crnn_mrn.py", **kw):
    common = dict(imgW=IMG[1], output_channel=OC, hidden_size=HID, batch_size=BATCH,
                  batch_max_length=BML, num_iter=4, val_interval=2, manual_seed=3,
                  output_dir=str(tmp), data_log=str(tmp / "data_any.txt"))
    common.update(kw)
    return jax_load_config(config, **common), load_config(config, **common)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float32)


def _assert_trees(got, ref, atol, rtol, what, scale=0.0):
    got, ref = dict(_leaves(got)), dict(_leaves(jax.tree_util.tree_map(np.asarray, ref)))
    assert got.keys() == ref.keys(), what
    for k in ref:
        leaf_atol = atol + scale * float(np.abs(ref[k]).max(initial=0.0))
        np.testing.assert_allclose(got[k], ref[k], atol=leaf_atol, rtol=rtol,
                                   err_msg=f"{what}: {k}")


def _perturb(tree, rng, scale=0.05):
    def f(path, leaf):
        leaf = np.asarray(leaf)
        noise = scale * rng.standard_normal(leaf.shape).astype(np.float32)
        if path[-1].key == "var":
            return np.abs(leaf + noise) + 0.5
        return leaf + noise
    return jax.tree_util.tree_map_with_path(f, tree)


def _loader(taski):
    return SyntheticTaskLoader(ALPHABETS, taski, BATCH, 8, img_w=IMG[1], max_len=5,
                               seed=taski)


def _float_images(loader, idx):
    images = (loader.bank[idx].astype(np.float32) / 255.0 - 0.5) / 0.5
    images[..., 3] = np.random.default_rng(int(idx[0])).uniform(
        -1, 1, images.shape[:3]).astype(np.float32)
    return images


def _experts(topt, rng):
    counts = (4 + len(ALPHABETS[0]), 4 + len(ALPHABETS[0]) + len(ALPHABETS[1]))
    experts = []
    for count in counts:
        params, stats = random_recognizer(rng, topt, count)
        v = _perturb({"params": params, "batch_stats": stats}, rng)
        v["params"]["fc"]["kernel"] = 3 * rng.standard_normal(
            v["params"]["fc"]["kernel"].shape).astype(np.float32)
        experts.append((v["params"], v["batch_stats"]))
    return counts, experts


def _port_routed(topt, counts, experts, router):
    tl = MRN(topt, device="cpu")
    tl.character = ALPHABETS[0] + ALPHABETS[1]
    tl.converter = tl.build_converter()
    tl._cur_task = 1
    for (p, s), count in zip(experts, counts):
        tl.add_expert(p, s, count)
    tl.start_router_phase(router)
    return tl


def _steps(learner, n=1):
    """``n`` router steps on task 1's bank-index rehearsal batches."""
    loader = _loader(1)
    learner.opt.image_bank = loader.bank
    for _ in range(n):
        learner.train_step(loader.get_batch2())


def _expert_stats(learner):
    return {k: v.clone() for k, v in learner.mrn_model.named_buffers()
            if k.startswith("experts.")}


# ------------------------------------------------------------ one router step
@pytest.fixture(scope="module")
def quirk_step(tmp_path_factory):
    """One router step in the drifting mode on both sides."""
    rng = np.random.default_rng(21)
    jopt, topt = _options(tmp_path_factory.mktemp("quirk_step"), mrn_pin_expert_stats=False)
    counts, experts = _experts(topt, rng)
    router = random_router(rng, topt, 2)
    jl = JaxMRN(jopt)
    jl.character = ALPHABETS[0] + ALPHABETS[1]
    jl.converter = jl.build_converter()
    jl.expert_params = [p for p, _ in experts]
    jl.expert_stats = [s for _, s in experts]
    jl.class_counts = list(counts)
    jl._build_mrn_module(n_experts=2, counts=counts)
    jl._phase = "routed"
    jl.params, jl.batch_stats = jl._routed_variables(router)
    jl.build_optimizer(scale=1.0, the=2)
    tl = _port_routed(topt, counts, experts, router)
    grads = {}

    def capture(g):
        grads.update({k: v.detach().clone() for k, v in g.items()})
        return g

    tl.grad_transform = lambda: capture
    loader = _loader(1)
    idx, words, task_ids = loader.get_batch2()
    images = _float_images(loader, idx)
    batch = jl._encode_batch(images, words)
    batch["dataset_idx"] = jnp.asarray(task_ids)
    (_, (new_stats, jmetrics)), jgrads = jax.jit(
        jax.value_and_grad(jl.loss_fn, has_aux=True), static_argnums=(4,))(
        jl.params, jl.batch_stats, batch, jax.random.PRNGKey(0), None)
    before = _expert_stats(tl)
    metrics = tl.train_step((images, words, task_ids))
    return dict(jax_stats=jax.tree_util.tree_map(np.asarray, new_stats),
                jax_metrics=jmetrics, jax_grads={k: jgrads[k] for k in ROUTER_KEYS},
                before=before, after=_expert_stats(tl), stats_tree=tl._expert_stats_tree(),
                metrics=metrics, grads=flax_tree(grads.items()))


def test_router_step_drifts_the_expert_stats_as_jax_does(quirk_step):
    _assert_trees(quirk_step["stats_tree"], quirk_step["jax_stats"], STATS_TOL, STATS_TOL,
                  "drifted batch_stats")
    moved = [k for k, v in quirk_step["before"].items()
             if not torch.equal(v, quirk_step["after"][k])]
    assert len(moved) == len(quirk_step["before"]) == 2 * 2 * 2   # 2 experts x 2 BNs x 2


def test_router_step_losses_and_grads_match_jax_in_drifting_mode(quirk_step):
    for key in ("clf", "router"):
        np.testing.assert_allclose(float(quirk_step["metrics"][key]),
                                   float(quirk_step["jax_metrics"][key]), rtol=LOSS_RTOL)
    ref = quirk_step["jax_grads"]
    largest = max(float(np.abs(g).max()) for _, g in _leaves(ref))
    _assert_trees(quirk_step["grads"], ref, ROUTER_GRAD_FLOOR * largest, 0.0, "router grads",
                  ROUTER_GRAD_SCALE)


def test_pinned_mode_keeps_the_expert_stats_bitwise(tmp_path):
    rng = np.random.default_rng(21)
    _, topt = _options(tmp_path)
    counts, experts = _experts(topt, rng)
    tl = _port_routed(topt, counts, experts, random_router(rng, topt, 2))
    before = _expert_stats(tl)
    _steps(tl, 2)
    after = _expert_stats(tl)
    assert all(torch.equal(v, after[k]) for k, v in before.items())
    assert tl._snapshot_trees()[1] == {}


# ------------------------------------------------------------ the router phase
def _run_task1(tmp, pinned, **kw):
    """Task 1 of a 2-task CRNN-MRN run (task 0's expert given), step 0 and
    the router phase, validated on one synthetic set a task."""
    _, topt = _options(tmp, mrn_pin_expert_stats=pinned, **kw)
    rng = np.random.default_rng(5)
    count = 4 + len(ALPHABETS[0])
    params, stats = random_recognizer(rng, topt, count)
    tl = MRN(topt, device="cpu")
    tl.add_expert(params, _perturb(stats, rng), count)
    tl._cur_task = 0
    tl.character = ALPHABETS[0]
    tl.converter = tl.build_converter()
    tl._ensure_expert_blobs()
    loader = _loader(1)
    topt.image_bank = loader.bank
    sets = {name: synthetic_val_set(ALPHABETS, t, 8, IMG[0], IMG[1], seed=40 + t)
            for t, name in enumerate(("val0", "val1"))}
    valid = ValDataset(["val0", "val1"], topt, sets.__getitem__)
    seen = {}
    original = MRN._run_loop

    def run_loop(self, taski, *args, **kwargs):
        if kwargs.get("step") == 1:
            seen["hashes"] = list(self._expert_hashes)
            seen["stats"] = [{k: v.clone() for k, v in s.items()} for s in self.expert_states]
        return original(self, taski, *args, **kwargs)

    tl._run_loop = run_loop.__get__(tl)
    tl.incremental_train(1, ALPHABETS[0] + ALPHABETS[1], loader, valid)
    return tl, seen


def _stat_keys(state):
    return [k for k in state if k.rsplit(".", 1)[-1] in ("mean", "var")]


@pytest.mark.parametrize("pinned", [True, False])
def test_router_phase_writes_back_drifted_stats_and_invalidates_hashes(tmp_path, pinned):
    tl, seen = _run_task1(tmp_path, pinned)
    assert len(tl.expert_states) == 2 and len(seen["stats"]) == 2
    for i, (state, start) in enumerate(zip(tl.expert_states, seen["stats"])):
        keys = _stat_keys(state)
        assert len(keys) == 4
        same = [torch.equal(state[k], start[k]) for k in keys]
        if pinned:
            assert all(same), i
        else:
            assert not any(same), i
            live = dict(tl.mrn_model.experts[i].named_buffers())
            assert all(torch.equal(state[k], live[k]) for k in keys)
    if pinned:
        assert tl._expert_hashes == seen["hashes"]
        return
    assert tl._expert_hashes == [None, None] and all(seen["hashes"])
    refs = tl._ensure_expert_blobs()   # the next best save writes new blobs
    assert not set(refs) & set(seen["hashes"])
    blob = load_model(os.path.join(tl._expert_dir(), f"{refs[0]}.msgpack"))
    state = recognizer_state(blob["params"], blob["batch_stats"])
    assert all(torch.equal(state[k], tl.expert_states[0][k]) for k in _stat_keys(state))

    # the router phase's best file: its blobs and the statistics the phase
    # started from, which supersede any blob's on load
    tl._load_best(1, step=1)
    assert tl._expert_hashes == seen["hashes"]
    for state, start in zip(tl.expert_states, seen["stats"]):
        assert all(torch.equal(state[k], start[k]) for k in _stat_keys(state))
    path = tl._best_path(1, 1)
    payload = load_model(path)
    save_model(path, payload["params"], payload["batch_stats"],
               extra={"expert_refs": refs, "router": payload["router"],
                      "expert_stats": payload["expert_stats"]})
    tl._load_best(1, step=1)
    assert tl._expert_hashes == refs
    for state, start in zip(tl.expert_states, seen["stats"]):
        assert all(torch.equal(state[k], start[k]) for k in _stat_keys(state))


@pytest.mark.parametrize("pinned", [True, False])
def test_router_snapshot_carries_and_resume_restores_the_stats(tmp_path, pinned):
    rng = np.random.default_rng(21)
    _, topt = _options(tmp_path, mrn_pin_expert_stats=pinned)
    counts, experts = _experts(topt, rng)
    router = random_router(rng, topt, 2)
    tl = _port_routed(topt, counts, experts, router)
    _steps(tl, 2)
    tl._save_full_state(1, 1, 2)
    payload = load_train_state(tl._train_state_path(1, 1))
    live_params, live_stats = to_flax(tl.mrn_model)
    if pinned:
        assert payload["batch_stats"] == {}
    else:
        _assert_trees(payload["batch_stats"], {"experts": live_stats["experts"]}, 0.0, 0.0,
                      "snapshot stats")

    topt.resume_full = True
    fresh = _port_routed(topt, counts, experts, random_router(np.random.default_rng(9),
                                                              topt, 2))
    assert fresh._maybe_resume_full(1, 1, None) == 2
    got_params, got_stats = to_flax(fresh.mrn_model)
    _assert_trees({k: got_params[k] for k in ROUTER_KEYS},
                  {k: live_params[k] for k in ROUTER_KEYS}, 0.0, 0.0, "router")
    expect = live_stats if not pinned else to_flax(
        _port_routed(topt, counts, experts, router).mrn_model)[1]
    _assert_trees(got_stats, expect, 0.0, 0.0, "restored stats")


def test_bf16_tf_ensemble_reads_the_drifting_stats(tmp_path):
    rng = np.random.default_rng(21)
    _, topt = _options(tmp_path, mrn_pin_expert_stats=False, train_dtype="bf16")
    counts, experts = _experts(topt, rng)
    tl = _port_routed(topt, counts, experts, random_router(rng, topt, 2))
    ensemble = tl._eval_ensemble()
    assert ensemble is not tl.mrn_model
    _steps(tl)
    pairs = [(m, live) for m, live in zip(ensemble.experts.modules(),
                                          tl.mrn_model.experts.modules())
             if isinstance(m, BatchNorm)]
    assert len(pairs) == 4
    for mine, live in pairs:
        assert mine.mean is live.mean and mine.var is live.var
        assert mine.mean.dtype == torch.float32
    assert next(ensemble.experts.parameters()).dtype == torch.float32


@pytest.mark.parametrize("pinned", [True, False])
def test_svtr_experts_draw_droppath_only_when_drifting(tmp_path, pinned):
    """SVTR experts in train mode draw their DropPath keep masks from the
    learner's generator (JAX's ``droppath`` rng); pinned, nothing draws."""
    _, topt = _options(tmp_path, config="configs/svtr_mrn.py", mrn_pin_expert_stats=pinned,
                       svtr=dict(embed_dim=(16, 32, 64), depth=(1, 2, 1),
                                 num_heads=(2, 2, 4)))
    rng = np.random.default_rng(3)
    counts, experts = _experts(topt, rng)
    tl = _port_routed(topt, counts, experts, random_router(rng, topt, 2))
    state = tl.generator.get_state().clone()
    before = _expert_stats(tl)
    _steps(tl)
    assert torch.equal(tl.generator.get_state(), state) == pinned
    after = _expert_stats(tl)
    assert all(torch.equal(v, after[k]) for k, v in before.items()) == pinned
