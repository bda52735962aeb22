"""The port's SVTR-MRN training step against the JAX package's, float32 on
the CPU, from the same weights on the same seeded batches.

The JAX side runs its own learner (``mrn_tpu.train.learners.mrn.MRN``:
``loss_fn``, ``build_optimizer``, ``get_train_step``) on its composed XLA
path with the exact-erf GELU.  Both sides build a narrow SVTR (embed
16/32/64, depth 2/4/2, drop-path 0, imgW 128) that keeps the three attention
paths: banded stage-1 Local (qb 32, width 128), masked stage-2 Local (no
band plan) and Global stage 3 (mixers go by absolute Block index).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mrn_tpu.models.composer as jax_composer
import mrn_tpu.models.svtr as jax_svtr
from mrn_tpu.config import load_config as jax_load_config
from mrn_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from mrn_tpu.ops.losses import cross_entropy_dense as jax_ce_dense
from mrn_tpu.ops.losses import cross_entropy_ignore as jax_ce_ignore
from mrn_tpu.ops.schedules import onecycle_schedule as jax_onecycle
from mrn_tpu.train.learners.mrn import MRN as JaxMRN
from mrn_tpu.train.optim import build_optimizer as jax_build_optimizer
from mrn_tpu.train.optim import build_schedule as jax_build_schedule
from mrn_tpu.train.steps import TrainState as JaxTrainState
from mrn_tpu_torch.bridge import flax_tree, from_flax, to_flax
from mrn_tpu_torch.config import load_config
from mrn_tpu_torch.data.manager import ValDataset
from mrn_tpu_torch.data.synthetic import (SyntheticTaskLoader, alphabet_of_size,
                                          synthetic_val_set)
from mrn_tpu_torch.models.composer import build_recognizer
from mrn_tpu_torch.models.svtr import configure_blocks
from mrn_tpu_torch.ops.ctc import ctc_loss
from mrn_tpu_torch.ops.losses import cross_entropy_dense, cross_entropy_ignore
from mrn_tpu_torch.ops.schedules import onecycle_schedule
from mrn_tpu_torch.ops.svtr_block import _band_spec
from mrn_tpu_torch.train.learners.mrn import MRN, PI
from mrn_tpu_torch.train.optim import Adam, build_schedule

SVTR = dict(embed_dim=(16, 32, 64), depth=(2, 4, 2), num_heads=(2, 2, 4),
            drop_path_rate=0.0)
IMG_W, BATCH = 128, 6
ALPHABETS = [alphabet_of_size(10), alphabet_of_size(6, 0x4E00 + 10)]

# Step 0, float32: the two frameworks differ only in summation order (convs,
# matmuls, reductions) through 8 Blocks: loss and BN statistics to 1e-5
# relative.  A gradient element to 2e-5 plus 1e-5 of its leaf's largest
# |grad| (a float32 sum of terms that large carries that much noise; the
# conv biases in front of BatchNorm have a true gradient of 0, so theirs is
# all noise).  Adam moves a parameter by about lr * sign(g) whatever |g| is,
# so updated parameters are not compared across the frameworks: the port's
# own captured grads go through optax (clip + Adam over OneCycle) from the
# port's own parameters, and the port's update must agree with that to
# float32 rounding (UPDATE_ATOL, UPDATE_RTOL, as in the Adam-alone test).
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_SCALE = 2e-5, 1e-5
STATS_TOL = 1e-5
UPDATE_ATOL, UPDATE_RTOL = 1e-7, 1e-6
# Step 1: the experts run the port's fused-Block plain version (degree-15 erf,
# clamp-exp softmax) against the JAX composed eval path: served logits agree
# to 1e-4 (tests/test_torch_mrn_slice.py), which bounds the losses and,
# relative to each leaf's largest |grad|, the router grads.  The route bias's true gradient is 0 (the
# routing softmax is shift-invariant), so its value is the float32 noise of
# sums that cancel: a floor of 1e-6 of the largest router gradient covers it.
ROUTED_LOSS_RTOL = 1e-4
ROUTER_GRAD_FLOOR, ROUTER_GRAD_SCALE = 1e-6, 1e-4
# bf16 policy: operands rounded to 8 mantissa bits at different points in
# the two frameworks (torch keeps softmax/GELU internals in float32): the
# loss agrees to ~1%.
BF16_LOSS_RTOL = 2e-2


def _options(tmp, **kw):
    common = dict(imgW=IMG_W, output_channel=32, hidden_size=16,
                  batch_size=BATCH, num_iter=4, manual_seed=3, output_dir=str(tmp),
                  data_log=str(tmp / "data_any.txt"), **kw)
    jopt = jax_load_config("configs/svtr_mrn.py", **common)
    topt = load_config("configs/svtr_mrn.py", svtr=SVTR, **common)
    return jopt, topt


@pytest.fixture(scope="module")
def narrow_jax(tmp_path_factory):
    """The JAX package built with the narrow SVTR and the exact-erf GELU."""

    class NarrowSVTR(jax_svtr.SVTRExtractor):
        embed_dim: tuple = SVTR["embed_dim"]
        depth: tuple = SVTR["depth"]
        num_heads: tuple = SVTR["num_heads"]
        drop_path_rate: float = SVTR["drop_path_rate"]

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_composer, "SVTRExtractor", NarrowSVTR)
    jax_svtr.set_attention_impl("xla")
    jax_svtr.set_train_gelu("erf")
    yield tmp_path_factory.mktemp("jax_mrn")
    jax_svtr.set_train_gelu("auto")
    jax_svtr.set_attention_impl("auto")
    mp.undo()


def _loader(taski):
    return SyntheticTaskLoader(ALPHABETS, taski, BATCH, 8, img_w=IMG_W, max_len=5,
                               seed=taski)


def _float_images(loader, idx):
    """The crops, normalised, with the constant alpha channel replaced by
    seeded noise: a constant input makes conv1's alpha taps bias-like, with
    pure-noise gradients whose Adam signs differ between the frameworks and
    would then move the second step's BatchNorm statistics."""
    images = (loader.bank[idx].astype(np.float32) / 255.0 - 0.5) / 0.5
    images[..., 3] = np.random.default_rng(int(idx[0])).uniform(
        -1, 1, images.shape[:3]).astype(np.float32)
    return images


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float32)


def _assert_trees(got, ref, atol, rtol, what, scale=0.0):
    """Leaf by leaf: |got - ref| <= atol + scale * max|ref leaf| + rtol * |ref|."""
    got, ref = dict(_leaves(got)), dict(_leaves(jax.tree_util.tree_map(np.asarray, ref)))
    assert got.keys() == ref.keys(), what
    for k in ref:
        leaf_atol = atol + scale * float(np.abs(ref[k]).max(initial=0.0))
        np.testing.assert_allclose(got[k], ref[k], atol=leaf_atol, rtol=rtol,
                                   err_msg=f"{what}: {k}")


def _capture_grads(learner):
    grads = {}

    def transform(g):
        grads.clear()
        grads.update({k: v.detach().clone() for k, v in g.items()})
        return g

    learner.grad_transform = lambda: transform
    return grads


class _OptaxReplay:
    """optax's clip + Adam (the JAX package's ``build_optimizer``) fed the
    port's captured grads from the port's parameters before each step."""

    def __init__(self, jopt, schedule, params):
        self.tx = jax_build_optimizer(jopt, schedule)
        self.state = self.tx.init(params)

    def __call__(self, params, grads):
        updates, self.state = self.tx.update(grads, self.state, params)
        return jax.tree_util.tree_map(np.asarray, optax.apply_updates(params, updates))


def _jax_learner(jopt, character):
    jl = JaxMRN(jopt)
    jl.character = character
    jl.converter = jl.build_converter()
    return jl


def _port_learner(topt, character):
    tl = MRN(topt, device="cpu")
    tl.character = character
    tl.converter = tl.build_converter()
    return tl


# ------------------------------------------------------------ ops
def test_geometry_keeps_all_attention_paths():
    assert _band_spec(8, 32, 7, 11)[:2] == (32, 128)   # stage 1 banded
    assert _band_spec(4, 32, 7, 11) is None            # stage 2 masked full
    assert sum(SVTR["depth"]) > 6                      # a Global Block


def test_ctc_matches_jax_including_infeasible_rows(rng):
    b, t, c, n = 6, 8, 7, 10
    logits = rng.standard_normal((b, t, c)).astype(np.float32)
    labels = rng.integers(1, c, (b, n)).astype(np.int32)
    labels[1, :6] = [2, 2, 2, 2, 3, 3]        # 6 + 4 repeats > T: infeasible
    lengths = np.array([3, 6, 0, 8, 9, 5], np.int32)   # 9 > T: infeasible
    ref, ref_grad = jax.value_and_grad(jax_ctc_loss)(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(lengths))
    x = torch.from_numpy(logits).requires_grad_()
    got = ctc_loss(x, torch.from_numpy(labels), torch.from_numpy(lengths))
    (grad,) = torch.autograd.grad(got, x)
    # float32 forward-backward lattices summed in another order
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), atol=1e-6, rtol=1e-4)
    assert not grad[1].any() and not grad[4].any()     # infeasible: zero grad


def test_cross_entropies_match_jax(rng):
    logits = rng.standard_normal((5, 4)).astype(np.float32)
    targets = np.array([0, 3, 1, 1, 2], np.int32)
    for jfn, tfn in ((jax_ce_dense, cross_entropy_dense),
                     (lambda l, t: jax_ce_ignore(l, t, 1),
                      lambda l, t: cross_entropy_ignore(l, t, 1))):
        ref, ref_grad = jax.value_and_grad(jfn)(jnp.asarray(logits), jnp.asarray(targets))
        x = torch.from_numpy(logits).requires_grad_()
        got = tfn(x, torch.from_numpy(targets))
        (grad,) = torch.autograd.grad(got, x)
        np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-6)
        np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize("total", [10, 7, 2])
def test_onecycle_matches_jax_at_every_step(total):
    ref, got = jax_onecycle(5e-4, total), onecycle_schedule(5e-4, total)
    for step in range(total + 2):
        # JAX evaluates in float32, the port in float64
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6)


@pytest.mark.parametrize("schedule,scale,the", [("super", 1.0, 2), ([0.5, 0.75], 0.5, 1),
                                                ([0.25], 1.0, 1)])
def test_build_schedule_matches_jax_at_every_step(schedule, scale, the):
    opt = SimpleNamespace(schedule=schedule, lr=5e-4, num_iter=8, milestones=[2000, 4000],
                          lr_drop_rate=0.1)
    ref = jax_build_schedule(opt, scale=scale, the=the)
    got = build_schedule(opt, scale=scale, the=the)
    for step in range(8 * the + 2):
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6)


def test_clip_and_adam_match_optax(rng):
    shapes = [(3, 4), (5,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    sched = onecycle_schedule(5e-4, 8)
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(jax_onecycle(5e-4, 8)))
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    adam = Adam(tp, sched, 5.0)
    for scale in (0.1, 10.0, 1.0):   # under, over and near the clip norm
        grads = [scale * rng.standard_normal(s).astype(np.float32) for s in shapes]
        updates, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, updates)
        adam.step([torch.from_numpy(g) for g in grads])
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7, rtol=1e-6)


# ------------------------------------------------------------ step 0
@pytest.fixture(scope="module")
def step0(narrow_jax):
    """Two step-0 steps of a new expert on both sides."""
    jopt, topt = _options(narrow_jax)
    character = ALPHABETS[0] + ALPHABETS[1]
    jl = _jax_learner(jopt, character)
    jl.change_model()
    jl.build_optimizer()
    tl = _port_learner(topt, character)
    tl.model = build_recognizer(topt, tl._total_classes)
    tl.model.load_state_dict(from_flax(jl.params, jl.batch_stats), strict=True)
    tl.build_optimizer()
    grads = _capture_grads(tl)
    loader = _loader(1)
    value_and_grad = jax.jit(jax.value_and_grad(jl.loss_fn, has_aux=True),
                             static_argnums=(4,))
    step = jl.get_train_step()
    state = JaxTrainState(jl.params, jl.batch_stats, jl.opt_state, jnp.asarray(0))
    replay = _OptaxReplay(jopt, jax_build_schedule(jopt), to_flax(tl.model)[0])
    runs = []
    for _ in range(2):
        idx, words = loader.get_batch()
        images = _float_images(loader, idx)
        batch = jl._encode_batch(images, words)
        rng = jax.random.PRNGKey(0)
        (loss, _), jgrads = value_and_grad(state.params, state.batch_stats, batch, rng, None)
        state, _ = step(state, batch, rng, None)
        before = to_flax(tl.model)[0]
        metrics = tl.train_step((images, words))
        host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        port_grads = flax_tree(grads.items())
        runs.append(dict(jax_loss=float(loss), jax_grads=host(jgrads),
                         jax_stats=host(state.batch_stats),
                         loss=float(metrics["loss"]), grads=port_grads,
                         state=to_flax(tl.model), optax_params=replay(before, port_grads)))
    return runs


@pytest.mark.parametrize("i", [0, 1])
def test_step0_loss_and_grads_match_jax(step0, i):
    run = step0[i]
    np.testing.assert_allclose(run["loss"], run["jax_loss"], rtol=LOSS_RTOL)
    _assert_trees(run["grads"], run["jax_grads"], GRAD_ATOL, 0.0, "grads", GRAD_SCALE)


@pytest.mark.parametrize("i", [0, 1])
def test_step0_updates_and_stats_match_jax(step0, i):
    run = step0[i]
    _assert_trees(run["state"][0], run["optax_params"], UPDATE_ATOL, UPDATE_RTOL, "params")
    _assert_trees(run["state"][1], run["jax_stats"], STATS_TOL, STATS_TOL, "batch_stats")


def test_step0_bf16_policy_tracks_jax(narrow_jax):
    jopt, topt = _options(narrow_jax, train_dtype="bf16")
    character = ALPHABETS[0] + ALPHABETS[1]
    jl = _jax_learner(jopt, character)
    jl.change_model()
    jl.build_optimizer()
    tl = _port_learner(topt, character)
    tl.model = build_recognizer(topt, tl._total_classes)
    tl.model.load_state_dict(from_flax(jl.params, jl.batch_stats), strict=True)
    tl.build_optimizer()
    loader = _loader(1)
    idx, words = loader.get_batch()
    images = _float_images(loader, idx)
    batch = jl._encode_batch(images, words)
    state = JaxTrainState(jl.params, jl.batch_stats, jl.opt_state, jnp.asarray(0))
    _, jm = jl.get_train_step()(state, batch, jax.random.PRNGKey(0), None)
    metrics = tl.train_step((images, words))
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]),
                               rtol=BF16_LOSS_RTOL)
    # master weights, moments and BN statistics stay float32
    assert all(p.dtype == torch.float32 for p in tl.model.parameters())
    assert all(b.dtype == torch.float32 for b in tl.model.buffers())


# ------------------------------------------------------------ step 1
ROUTER_KEYS = ("dm_router", "channel_route", "route")


@pytest.fixture(scope="module")
def step1(narrow_jax):
    """One router step over two frozen experts on both sides."""
    rng = np.random.default_rng(21)
    jopt, topt = _options(narrow_jax)
    counts = (4 + len(ALPHABETS[0]), 4 + len(ALPHABETS[0]) + len(ALPHABETS[1]))
    experts = []
    for count, seed in zip(counts, (1, 2)):
        model = jax_composer.build_recognizer(jopt, count)
        v = jax.jit(lambda k, m=model: m.init({"params": k}, jnp.zeros((2, 32, IMG_W, 4)),
                                             train=False))(jax.random.PRNGKey(seed))
        v = jax.tree_util.tree_map(np.asarray, v)
        # spread the logits so the two experts disagree
        v["params"]["fc"]["kernel"] = 3 * rng.standard_normal(
            v["params"]["fc"]["kernel"].shape).astype(np.float32)
        experts.append((v["params"], v["batch_stats"]))
    character = ALPHABETS[0] + ALPHABETS[1]
    jl = _jax_learner(jopt, character)
    jl.expert_params = [p for p, _ in experts]
    jl.expert_stats = [s for _, s in experts]
    jl.class_counts = list(counts)
    jl._build_mrn_module(n_experts=2, counts=counts)
    jl._phase = "routed"
    router = jax.tree_util.tree_map(np.asarray, jl._init_router_params())
    params, stats = jl._routed_variables(router)
    experts_before = jax.tree_util.tree_map(np.asarray, params["experts"])
    jl.params, jl.batch_stats = params, stats
    jl.build_optimizer(scale=1.0, the=2)

    tl = _port_learner(topt, character)
    for (p, s), count in zip(experts, counts):
        tl.add_expert(p, s, count)
    tl.start_router_phase(router)
    configure_blocks(tl.mrn_model, gelu_degree=15)
    grads = _capture_grads(tl)

    loader = _loader(1)
    idx, words, task_ids = loader.get_batch2()
    images = _float_images(loader, idx)
    batch = jl._encode_batch(images, words)
    batch["dataset_idx"] = jnp.asarray(task_ids)
    rng_key = jax.random.PRNGKey(0)
    value_and_grad = jax.jit(jax.value_and_grad(jl.loss_fn, has_aux=True),
                             static_argnums=(4,))
    (_, (_, jmetrics)), jgrads = value_and_grad(params, stats, batch, rng_key, None)
    jgrads = {k: jax.tree_util.tree_map(np.asarray, jgrads[k]) for k in ROUTER_KEYS}
    new_state, _ = jl.get_train_step()(
        JaxTrainState(params, stats, jl.opt_state, jnp.asarray(0)), batch, rng_key, None)
    before = {k: v for k, v in to_flax(tl.mrn_model)[0].items() if k in ROUTER_KEYS}
    replay = _OptaxReplay(jopt, jax_build_schedule(jopt, scale=1.0, the=2), before)
    metrics = tl.train_step((images, words, task_ids))
    got_params, _ = to_flax(tl.mrn_model)
    port_grads = flax_tree(grads.items())
    return dict(task_ids=task_ids, metrics=metrics, jax_metrics=jmetrics,
                grads=port_grads, jax_grads=jgrads,
                params=got_params, optax_router=replay(before, port_grads),
                jax_params=jax.tree_util.tree_map(np.asarray, new_state.params),
                experts_before=experts_before)


def test_step1_loss_split_matches_jax(step1):
    assert len(set(step1["task_ids"].tolist())) == 2
    for key in ("clf", "router"):
        np.testing.assert_allclose(float(step1["metrics"][key]),
                                   float(step1["jax_metrics"][key]), rtol=ROUTED_LOSS_RTOL)
    np.testing.assert_allclose(
        float(step1["metrics"]["loss"]),
        PI * float(step1["metrics"]["clf"]) + float(step1["metrics"]["router"]), rtol=1e-6)


def test_step1_router_grads_match_jax(step1):
    ref = step1["jax_grads"]
    largest = max(float(np.abs(g).max()) for _, g in _leaves(ref))
    _assert_trees(step1["grads"], ref, ROUTER_GRAD_FLOOR * largest, 0.0,
                  "router grads", ROUTER_GRAD_SCALE)


def test_step1_router_update_matches_jax(step1):
    got = step1["params"]
    _assert_trees({k: got[k] for k in ROUTER_KEYS}, step1["optax_router"],
                  UPDATE_ATOL, UPDATE_RTOL, "router params")


def test_step1_experts_stay_frozen(step1):
    got = {"experts": step1["params"]["experts"]}
    _assert_trees(got, {"experts": step1["experts_before"]}, 0, 0, "frozen experts")
    _assert_trees(got, {"experts": step1["jax_params"]["experts"]}, 0, 0, "frozen experts")


# ------------------------------------------------------------ entry point
def test_incremental_train_runs_a_two_task_sequence(tmp_path):
    """``MRN.incremental_train`` on bank indices: task 0 (step 0 only, the
    expert frozen by ``after_task``), then task 1 (step 0 for the new
    expert, step 1 over both frozen experts with OneCycle over 2 num_iter);
    step 1 leaves every expert as it was."""
    _, topt = _options(tmp_path)   # num_iter 4
    val_sets = {f"v{t}": synthetic_val_set(ALPHABETS, t, 4, img_w=IMG_W, seed=50 + t)
                for t in (0, 1)}
    learner = None
    for taski in (0, 1):
        loader = _loader(taski)
        if learner is None:
            learner = MRN(topt.replace(image_bank=loader.bank), device="cpu")
        learner.opt = learner.opt.replace(image_bank=loader.bank)
        valid = ValDataset([f"v{t}" for t in range(taski + 1)], learner.opt,
                           val_sets.__getitem__)
        learner.incremental_train(taski, "".join(ALPHABETS[:taski + 1]), loader, valid)
        learner.after_task()
        if taski == 0:
            first = {k: v.clone() for k, v in learner.expert_states[0].items()}
    steps = [(r["task"], r["step"]) for r in learner.history]
    assert steps == [(0, 0)] * 4 + [(1, 0)] * 4 + [(1, 1)] * 2
    assert all(np.isfinite(r["loss"]) for r in learner.history)
    assert learner.class_counts == [4 + 10, 4 + 16]
    assert learner.state.opt.count == 2
    assert learner.history[-1]["lr"] == pytest.approx(onecycle_schedule(topt.lr, 8)(1),
                                                      rel=1e-6)
    for key, value in first.items():
        torch.testing.assert_close(learner.expert_states[0][key], value, atol=0, rtol=0)
        torch.testing.assert_close(
            learner.mrn_model.state_dict()[f"experts.0.{key}"][..., :value.shape[-1]]
            if key.startswith("fc.") else learner.mrn_model.state_dict()[f"experts.0.{key}"],
            value, atol=0, rtol=0)
    assert set(learner.router_state) == {k for k in learner.mrn_model.state_dict()
                                         if not k.startswith("experts.")}
