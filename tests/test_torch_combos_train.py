"""Training steps of stage combinations the port did not build before,
against the JAX package's MRN learner, float32 on the CPU, narrow (32x64
crops, output_channel 32, hidden 16, SVTR embed 16/32/64 and depth 2/4/2
with drop-path 0, batch 4, ``batch_max_length`` 6).

Step 0 (a new expert alone, train mode) of TPS/VGG/None/Attn,
TPS/RCNN/None/CTC, TPS/SVTR/BiLSTM/Attn (composed and under
``MRN_FUSED_TRAIN=1``), None/ResNet/None/CTC and None/VGG/None/Attn: the
loss, every gradient (a TPS's localization net too: its gradient comes
back through the whole backbone, through every SVTR Block to the image),
the running statistics and Adam's update.  With SVTR, CRNN, GRCNN, TRBA and
RBA these cover every adjacent pair of stages.  Step 1 (the router over
two frozen experts, teacher-forced) of None/VGG/None/Attn, the combination
JAX's own MRN test runs.  The JAX side runs its CPU routes (the XLA
attention, the gathering warp, the exact-erf GELU); the port its kernels'
plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mrn_tpu.models.composer as jax_composer
import mrn_tpu.models.svtr as jax_svtr
import mrn_tpu.models.tps as jax_tps
from mrn_tpu.config import default_options as jax_default_options
from mrn_tpu.models.composer import build_recognizer as jax_build_recognizer
from mrn_tpu.ops.grid_sample import grid_sample_gather
from mrn_tpu.train.learners.mrn import MRN as JaxMRN
from mrn_tpu.train.optim import build_optimizer as jax_build_optimizer
from mrn_tpu.train.optim import build_schedule as jax_build_schedule
from mrn_tpu_torch.bridge import flax_tree, to_flax
from mrn_tpu_torch.config import default_options
from mrn_tpu_torch.data.synthetic import SyntheticTaskLoader, alphabet_of_size
from mrn_tpu_torch.models import svtr, tps
from mrn_tpu_torch.models.init import random_recognizer, random_router
from mrn_tpu_torch.ops.grid_sample import grid_sample_train
from mrn_tpu_torch.train.learners.mrn import MRN, PI

IMG = (32, 64, 4)
OC, HID, BATCH, BML = 32, 16, 4, 6
SVTR = dict(embed_dim=(16, 32, 64), depth=(2, 4, 2), num_heads=(2, 2, 4), drop_path_rate=0.0)
ALPHABETS = [alphabet_of_size(10), alphabet_of_size(6, 0x4E00 + 10)]
STEP0 = {"tps-vgg-none-attn": (("TPS", "VGG", "None", "Attn"), False),
         "tps-rcnn-none-ctc": (("TPS", "RCNN", "None", "CTC"), False),
         "tps-svtr-bilstm-attn": (("TPS", "SVTR", "BiLSTM", "Attn"), False),
         "tps-svtr-bilstm-attn-fused": (("TPS", "SVTR", "BiLSTM", "Attn"), True),
         "none-resnet-none-ctc": (("None", "ResNet", "None", "CTC"), False),
         "none-vgg-none-attn": (("None", "VGG", "None", "Attn"), False)}
# Whole-learner steps, float32, on the same weights and batch, at the
# tolerances of the existing step tests of the same stages.  A TPS or a
# ResNet in train mode (tests/test_torch_trba_train.py): 29 train-mode
# BatchNorms with a cancelling variance and a warp whose gradient jumps
# where a tap crosses a pixel put both frameworks' gradients ~8.6e-3 of the
# largest |grad| from a float64 run and 5e-4 from each other, so a gradient
# element is held to JAX's within 2e-3 of the tree's largest |grad| plus
# 1e-3 relative; the running statistics at 1e-4 absolute plus relative.
# The other combinations (tests/test_torch_crnn.py): 1e-4 of the largest
# |grad| plus 1e-3 relative.  The losses to float32 rounding (1e-5
# relative); Adam's updates against optax fed the port's own gradients.
# A TPS grid comes from two float32 products that cancel terms far larger
# than the result (~6e-5 from the float64 product in each framework,
# tests/test_torch_tps.py): the port's train-mode grid is held to JAX's at
# GRID_TOL (tests/test_torch_trba_train.py) and its warp then samples at
# JAX's grid values, its gradient still reaching the port's grid
GRID_TOL = 2e-4
STEP_LOSS_RTOL = 1e-5
TRBA_GRAD_GLOBAL, CRNN_GRAD_GLOBAL, STEP_GRAD_RTOL = 2e-3, 1e-4, 1e-3
UPDATE_ATOL, UPDATE_RTOL = 1e-7, 1e-6
STEP_STATS_TOL = 1e-4
# step 1: the router grads to 1e-4 of each leaf's largest |grad| plus 1e-5
# of the largest router grad (the route bias's true gradient is 0;
# tests/test_torch_crnn.py)
ROUTER_GRAD_SCALE, ROUTER_GRAD_FLOOR = 1e-4, 1e-5
ROUTER_KEYS = ("dm_router", "channel_route", "route")


@pytest.fixture(autouse=True, scope="module")
def _narrow_jax():
    """The JAX composer's SVTR narrowed as the port's ``svtr=`` narrows it,
    its attention on the XLA route and its training GELU the exact erf;
    torch on one thread (beside the other test workers, more threads
    oversubscribe the cores)."""

    class NarrowSVTR(jax_svtr.SVTRExtractor):
        embed_dim: tuple = SVTR["embed_dim"]
        depth: tuple = SVTR["depth"]
        num_heads: tuple = SVTR["num_heads"]
        drop_path_rate: float = SVTR["drop_path_rate"]

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_composer, "SVTRExtractor", NarrowSVTR)
    jax_svtr.set_attention_impl("xla")
    jax_svtr.set_train_gelu("erf")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax_svtr.set_train_gelu("auto")
    jax_svtr.set_attention_impl("auto")
    mp.undo()


def _options(tmp, combo):
    t, f, s, p = combo
    common = dict(il="mrn", Transformation=t, FeatureExtraction=f, SequenceModeling=s,
                  Prediction=p, imgW=IMG[1], output_channel=OC, hidden_size=HID,
                  batch_size=BATCH, batch_max_length=BML, num_iter=4, manual_seed=3,
                  output_dir=str(tmp), data_log=str(tmp / "data_any.txt"))
    return jax_default_options(**common), default_options(svtr=SVTR, **common)


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


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb(tree, rng, scale=0.05):
    if isinstance(tree, dict):
        return {k: (_perturb(v, rng, scale) if k != "var" or isinstance(v, dict)
                    else np.abs(v + scale * rng.standard_normal(v.shape)).astype(np.float32)
                    + np.float32(0.5)) for k, v in tree.items()}
    return (tree + scale * rng.standard_normal(tree.shape)).astype(np.float32)


def _loader(taski):
    return SyntheticTaskLoader(ALPHABETS, taski, BATCH, 8, img_w=IMG[1], max_len=5,
                               seed=taski)


def _float_images(loader, idx):
    """The crops, normalised, with the constant alpha channel replaced by
    seeded noise (JAX reads an integer batch as bank indices)."""
    images = (loader.bank[idx].astype(np.float32) / 255.0 - 0.5) / 0.5
    images[..., 3] = np.random.default_rng(int(idx[0])).uniform(
        -1, 1, images.shape[:3]).astype(np.float32)
    return images


def _capture_grads(learner):
    grads = {}

    def transform(g):
        grads.clear()
        grads.update({k: v.detach().clone() for k, v in g.items()})
        return g

    learner.grad_transform = lambda: transform
    return grads


def _learners(jopt, topt):
    character = ALPHABETS[0] + ALPHABETS[1]
    jl, tl = JaxMRN(jopt), MRN(topt, device="cpu")
    for learner in (jl, tl):
        learner.character = character
        learner.converter = learner.build_converter()
    return jl, tl


def _optax_update(jopt, schedule, params, grads):
    tx = jax_build_optimizer(jopt, schedule)
    updates, _ = tx.update(grads, tx.init(params), params)
    return _host(optax.apply_updates(params, updates))


# ------------------------------------------------------------ step 0
@pytest.fixture(scope="module", params=sorted(STEP0))
def step0(request, tmp_path_factory):
    """One step-0 step of a new expert (as ``change_model`` draws it, its
    TPS ``localization_fc2`` moved off its zero kernel) on both sides."""
    combo, fused = STEP0[request.param]
    jopt, topt = _options(tmp_path_factory.mktemp(request.param), combo)
    jl, tl = _learners(jopt, topt)
    tl.change_model()
    if combo[0] == "TPS":   # a zero kernel gives every crop the same grid
        fc2 = tl.model.extractor.transformation.localization.localization_fc2
        with torch.no_grad():
            fc2.kernel.copy_(0.05 * torch.randn(fc2.kernel.shape,
                                                generator=torch.Generator().manual_seed(1)))
    tl.build_optimizer()
    jl.model = jax_build_recognizer(jopt, jl._total_classes)
    jl.params, jl.batch_stats = to_flax(tl.model)
    grads = _capture_grads(tl)
    loader = _loader(1)
    idx, words = loader.get_batch()
    images = _float_images(loader, idx)
    batch = jl._encode_batch(images, words)
    grids = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_tps, "grid_sample", _recording_warp(grids))
        (loss, (stats, _)), jgrads = jax.jit(jax.value_and_grad(jl.loss_fn, has_aux=True),
                                             static_argnums=(4,))(
            jl.params, jl.batch_stats, batch, jax.random.PRNGKey(0), None)
        jax.effects_barrier()   # the grid's callback has run before the port reads it
    before = to_flax(tl.model)[0]
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        if combo[0] == "TPS":
            def warp(image, grid):
                grids["port"] = grid.detach().numpy().copy()
                return grid_sample_train(image, grid + (torch.tensor(grids["jax"])
                                                        - grid).detach())

            mp.setattr(tps, "grid_sample_train", warp)
        if fused:
            mp.setenv("MRN_FUSED_TRAIN", "1")
            fused_train = svtr.fused_block_train
            mp.setattr(svtr, "fused_block_train",
                       lambda *a, **k: calls.append(1) or fused_train(*a, **k))
        metrics = tl.train_step((images, words))
    port_grads = flax_tree(grads.items())
    return dict(combo=combo, fused=fused, fused_calls=len(calls), grids=grids,
                jax_loss=float(loss),
                jax_grads=_host(jgrads), jax_stats=_host(stats), loss=float(metrics["loss"]),
                grads=port_grads, state=to_flax(tl.model),
                optax_params=_optax_update(jopt, jax_build_schedule(jopt), before, port_grads))


def _recording_warp(grids):
    """JAX's training warp, its grid recorded into ``grids["jax"]`` from
    inside the jitted step."""

    def warp(image, grid, inference=False):
        assert not inference
        jax.debug.callback(lambda g: grids.__setitem__("jax", np.array(g)), grid)
        return grid_sample_gather(image, grid)

    return warp


def _grad_global(combo):
    return TRBA_GRAD_GLOBAL if "TPS" in combo or "ResNet" in combo else CRNN_GRAD_GLOBAL


def test_step0_loss_and_grads_match_jax(step0):
    np.testing.assert_allclose(step0["loss"], step0["jax_loss"], rtol=STEP_LOSS_RTOL)
    largest = max(float(np.abs(g).max()) for _, g in _leaves(step0["jax_grads"]))
    _assert_trees(step0["grads"], step0["jax_grads"], _grad_global(step0["combo"]) * largest,
                  STEP_GRAD_RTOL, "grads")
    # the fused variant went through the fused training Block (Global Blocks
    # and Local ones with a band plan: 2 of stage 3 at least)
    assert step0["fused_calls"] >= (2 if step0["fused"] else 0)


def test_step0_update_and_stats_match_jax(step0):
    _assert_trees(step0["state"][0], step0["optax_params"], UPDATE_ATOL, UPDATE_RTOL, "params")
    _assert_trees(step0["state"][1], step0["jax_stats"], STEP_STATS_TOL, STEP_STATS_TOL,
                  "batch_stats")
    if step0["combo"][0] == "TPS":   # the gradient came back through the backbone
        np.testing.assert_allclose(step0["grids"]["port"], step0["grids"]["jax"],
                                   atol=GRID_TOL, rtol=0)
        loc = step0["grads"]["extractor"]["transformation"]["localization"]
        for name in ("localization_fc2", "localization_fc1"):
            assert np.abs(loc[name]["kernel"]).max() > 0, name
        assert np.abs(loc["conv0"]["Conv_0"]["kernel"]).max() > 0


# ------------------------------------------------------------ step 1
@pytest.fixture(scope="module")
def step1(tmp_path_factory):
    """One router step over two frozen None/VGG/None/Attn experts
    (teacher-forced, soft-routed) on both sides."""
    rng = np.random.default_rng(21)
    jopt, topt = _options(tmp_path_factory.mktemp("step1"), ("None", "VGG", "None", "Attn"))
    counts = (5 + len(ALPHABETS[0]), 5 + len(ALPHABETS[0]) + len(ALPHABETS[1]))
    experts = []
    for count in counts:
        params, stats = random_recognizer(rng, topt, count)
        params, stats = _perturb(params, rng), _perturb(stats, rng)
        params["fc"]["kernel"] = 3 * rng.standard_normal(
            params["fc"]["kernel"].shape).astype(np.float32)
        experts.append((params, stats))
    jl, tl = _learners(jopt, topt)
    jl.expert_params = [p for p, _ in experts]
    jl.expert_stats = [s for _, s in experts]
    jl.class_counts = list(counts)
    jl._build_mrn_module(n_experts=2, counts=counts)
    jl._phase = "routed"
    router = random_router(rng, topt, 2)
    params, stats = jl._routed_variables(router)
    jl.params, jl.batch_stats = params, stats
    jl.build_optimizer(scale=1.0, the=2)

    for (p, s), count in zip(experts, counts):
        tl.add_expert(p, s, count)
    tl.start_router_phase(router)
    grads = _capture_grads(tl)
    experts_before = {k: v.clone() for k, v in tl.mrn_model.experts.state_dict().items()}
    loader = _loader(1)
    idx, words, task_ids = loader.get_batch2()
    images = _float_images(loader, idx)
    batch = jl._encode_batch(images, words)
    batch["dataset_idx"] = jnp.asarray(task_ids)
    (_, (_, jmetrics)), jgrads = jax.jit(jax.value_and_grad(jl.loss_fn, has_aux=True),
                                         static_argnums=(4,))(
        params, stats, batch, jax.random.PRNGKey(0), None)
    before = {k: v for k, v in to_flax(tl.mrn_model)[0].items() if k in ROUTER_KEYS}
    metrics = tl.train_step((images, words, task_ids))
    port_grads = flax_tree(grads.items())
    return dict(task_ids=task_ids, metrics=metrics, jax_metrics=_host(jmetrics),
                grads=port_grads, jax_grads={k: _host(jgrads[k]) for k in ROUTER_KEYS},
                params=to_flax(tl.mrn_model)[0], experts_before=experts_before,
                experts_after=tl.mrn_model.experts.state_dict(),
                optax_router=_optax_update(jopt, jax_build_schedule(jopt, scale=1.0, the=2),
                                           before, port_grads))


def test_step1_loss_split_matches_jax(step1):
    assert len(set(step1["task_ids"].tolist())) == 2
    for key in ("clf", "router"):
        np.testing.assert_allclose(float(step1["metrics"][key]),
                                   float(step1["jax_metrics"][key]), rtol=STEP_LOSS_RTOL)
    np.testing.assert_allclose(
        float(step1["metrics"]["loss"]),
        PI * float(step1["metrics"]["clf"]) + float(step1["metrics"]["router"]), rtol=1e-6)


def test_step1_router_grads_and_update_match_jax(step1):
    ref = step1["jax_grads"]
    largest = max(float(np.abs(g).max()) for _, g in _leaves(ref))
    _assert_trees(step1["grads"], ref, ROUTER_GRAD_FLOOR * largest, 0.0, "router grads",
                  ROUTER_GRAD_SCALE)
    got = step1["params"]
    _assert_trees({k: got[k] for k in ROUTER_KEYS}, step1["optax_router"], UPDATE_ATOL,
                  UPDATE_RTOL, "router params")
    after = step1["experts_after"]   # the experts stay frozen, bitwise
    assert all(torch.equal(v, after[k]) for k, v in step1["experts_before"].items())
