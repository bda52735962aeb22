"""The port's CRNN (None/VGG/BiLSTM/CTC) and GRCNN (None/RCNN/BiLSTM/CTC)
against the JAX package's, float32 on the CPU, narrow (output_channel 64,
hidden 32, 32x64 crops, batch 4): the VGG and RCNN extractors and both
recognizers in eval and train mode with their running statistics, the
random trees against a JAX init and the reference init pass over them, a
CRNN and a GRCNN ensemble served through ``serve.Server`` against the JAX
``MRNNet``, the CTC ``DERNet`` over VGG, one CRNN MRN step 0 and step 1
and one GRCNN step 0 against the JAX learner's, every shipped CRNN and
GRCNN config's learner, and the configs through ``campaign --arch crnn``,
every strategy and ``train_cli`` / ``evaluate_cli`` / ``recognize_cli``."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mrn_tpu.config import load_config as jax_load_config
from mrn_tpu.models.composer import build_recognizer as jax_build_recognizer
from mrn_tpu.models.der import DERNet as JaxDERNet
from mrn_tpu.models.mrn import MRNNet as JaxMRNNet
from mrn_tpu.models.rcnn import RCNNExtractor as JaxRCNN
from mrn_tpu.models.surgery import apply_reference_init as jax_reference_init
from mrn_tpu.models.vgg import VGGExtractor as JaxVGG
from mrn_tpu.train.learners.mrn import MRN as JaxMRN
from mrn_tpu.train.optim import build_optimizer as jax_build_optimizer
from mrn_tpu.train.optim import build_schedule as jax_build_schedule
from mrn_tpu_torch.bridge import der_state, flax_tree, from_flax, to_flax
from mrn_tpu_torch.campaign import LANS, campaign_options, run_incremental, run_joint
from mrn_tpu_torch.config import load_config
from mrn_tpu_torch.data.synthetic import (SyntheticSource, SyntheticTaskLoader,
                                          alphabet_of_size)
from mrn_tpu_torch.models.composer import build_recognizer
from mrn_tpu_torch.models.der import DERNet
from mrn_tpu_torch.models.init import random_der, random_mrn, random_recognizer, random_router
from mrn_tpu_torch.models.rcnn import RCNNExtractor
from mrn_tpu_torch.models.surgery import apply_reference_init
from mrn_tpu_torch.models.vgg import VGGExtractor
from mrn_tpu_torch.serve import Server
from mrn_tpu_torch.train.learners.mrn import MRN, PI

IMG = (32, 64, 4)
OC, HID, BATCH, BML = 64, 32, 4, 6
ALPHABETS = [alphabet_of_size(10), alphabet_of_size(6, 0x4E00 + 10)]
CONFIGS = {"crnn": "configs/crnn_mrn.py", "grcnn": "configs/grcnn_mrn.py"}
# module by module, float32: summation order only
TOL = 1e-5
# Train-mode GRCNN normalises with 79 batch-statistics BatchNorms (26 a
# GRCL, each over 4 x 8 x 32 values or fewer) whose fast variance E[x^2] -
# E[x]^2 cancels and carries each framework's rounding through 15 of them
# in a row: its features are held at 1e-4 absolute plus relative (measured
# 9.0e-5 of features up to 3.2; VGG's 5.0e-6 of 3.8), its running
# statistics at 1e-5 (measured 1.2e-6)
GRCNN_TRAIN_TOL = 1e-4
# Whole-learner steps, float32, on the same weights and batch: the losses
# to float32 rounding (1e-5 relative; measured 8e-8 / 1.4e-7); a gradient
# element to JAX's within STEP_GRAD_GLOBAL of the tree's largest |grad|
# plus STEP_GRAD_RTOL relative (measured 1.7e-6 / 2.1e-6 of the largest
# for CRNN / GRCNN); Adam's updates against optax fed the port's own
# gradients (UPDATE_*); the running statistics after the step at 1e-4
# absolute plus 1e-4 relative (measured 3.0e-7)
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_GLOBAL, STEP_GRAD_RTOL = 1e-4, 1e-3
UPDATE_ATOL, UPDATE_RTOL = 1e-7, 1e-6
STEP_STATS_TOL = 1e-4
# step 1: the router grads to 1e-4 of each leaf's largest |grad| plus 1e-5
# of the largest router grad (the route bias's true gradient is 0)
ROUTER_GRAD_SCALE, ROUTER_GRAD_FLOOR = 1e-4, 1e-5
ROUTER_KEYS = ("dm_router", "channel_route", "route")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch's CPU ops on one thread here: beside the other test workers,
    more threads oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _options(tmp, arch="crnn", **kw):
    common = dict(imgW=IMG[1], output_channel=OC, hidden_size=HID, batch_size=BATCH,
                  batch_max_length=BML, num_iter=4, manual_seed=3, output_dir=str(tmp),
                  data_log=str(tmp / "data_any.txt"))
    common.update(kw)
    return (jax_load_config(CONFIGS[arch], **common), load_config(CONFIGS[arch], **common))


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


def _perturb(variables, rng, scale=0.05):
    def f(path, leaf):
        leaf = np.asarray(leaf)
        noise = scale * rng.standard_normal(leaf.shape).astype(np.float32)
        if path[-1].key == "var":
            return np.abs(leaf + noise) + 0.5
        return leaf + noise
    return jax.tree_util.tree_map_with_path(f, variables)


def _shapes(tree, prefix=""):
    out = {}
    for k, x in tree.items():
        out.update(_shapes(x, f"{prefix}{k}/") if isinstance(x, dict)
                   else {prefix + k: tuple(np.shape(x))})
    return out


# ------------------------------------------------------------ the extractors
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("arch", ["crnn", "grcnn"])
def test_extractor_and_running_stats_match_jax(rng, arch, train):
    """VGG (T = W/4 - 1) and RCNN (T = W/4 + 1) on perturbed weights and
    statistics; train mode moves the running statistics as flax does, eval
    mode leaves them alone."""
    jm, port = ((JaxVGG(OC), VGGExtractor(IMG[2], OC)) if arch == "crnn"
                else (JaxRCNN(OC), RCNNExtractor(IMG[2], OC)))
    x = rng.standard_normal((BATCH, *IMG)).astype(np.float32)
    v = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False), rng)
    port.load_state_dict(from_flax(v["params"], v["batch_stats"]), strict=True)
    ref, mutated = jm.apply(v, jnp.asarray(x), train=train, mutable=["batch_stats"])
    with torch.no_grad():
        got = port(torch.from_numpy(x), train=train).numpy()
    t = IMG[1] // 4 - 1 if arch == "crnn" else IMG[1] // 4 + 1
    assert got.shape == ref.shape == (BATCH, 1, t, OC)
    tol = GRCNN_TRAIN_TOL if (train and arch == "grcnn") else TOL
    np.testing.assert_allclose(got, np.asarray(ref), atol=tol, rtol=tol)
    stats_tol = TOL if train else 0.0
    _assert_trees(to_flax(port)[1], mutated["batch_stats"], stats_tol, stats_tol,
                  "batch_stats")


@pytest.mark.parametrize("arch", ["crnn", "grcnn"])
def test_random_trees_match_a_jax_init_and_the_reference_pass(tmp_path, arch):
    """``random_recognizer``'s trees leaf for leaf (names and shapes)
    against a JAX ``Recognizer.init``, in the torch-default bounds (every
    conv kernel and bias within 1/sqrt(fan_in)), BatchNorm 1 / 0 / 0 / 1;
    ``apply_reference_init`` gives the same leaves as JAX's pass the same
    rule (zero biases, unit scales, kaiming-normal kernels)."""
    jopt, topt = _options(tmp_path, arch)
    jm = jax_build_recognizer(jopt, 13)
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((2, *IMG)),
                                       train=False))
    params, stats = random_recognizer(np.random.default_rng(0), topt, 13)
    assert _shapes(params) == _shapes(v["params"])
    assert _shapes(stats) == _shapes(v["batch_stats"])
    for name, leaf in _leaves(params["extractor"]["feature"]):
        if "Conv_0" in name:
            kernel = params["extractor"]["feature"]
            for key in name.split("/")[:-2]:
                kernel = kernel[key]
            fan_in = int(np.prod(kernel["Conv_0"]["kernel"].shape[:3]))
            assert np.abs(leaf).max() <= 1.0 / np.sqrt(fan_in), name
        elif name.endswith("scale"):
            assert (leaf == 1).all(), name
        else:
            assert (leaf == 0).all(), name
    for name, leaf in _leaves(stats):
        assert (leaf == (1 if name.endswith("var") else 0)).all(), name

    ours = dict(_leaves(apply_reference_init(params, np.random.default_rng(1))))
    theirs = dict(_leaves(_host(jax_reference_init(params, jax.random.PRNGKey(1)))))
    assert ours.keys() == theirs.keys()
    for k in ours:
        if (theirs[k] == 0).all() or (theirs[k] == 1).all():
            np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
        elif theirs[k].size >= 1024:   # the same kaiming std, to sampling error
            np.testing.assert_allclose(ours[k].std(), theirs[k].std(), rtol=0.15, err_msg=k)


@pytest.mark.parametrize("arch", ["crnn", "grcnn"])
def test_recognizer_and_mrn_server_match_jax(tmp_path, rng, arch):
    """The recognizer (``build_recognizer`` of the config, eval and train
    mode) and a 2-expert ensemble served by ``serve.Server`` (the hard pick,
    ones-padded logits) against the JAX modules on the same trees."""
    jopt, topt = _options(tmp_path, arch)
    params, stats = random_recognizer(rng, topt, 13)
    stats = _perturb(stats, rng)
    jm = jax_build_recognizer(jopt, 13)
    port = build_recognizer(topt, 13)
    port.load_state_dict(from_flax(params, stats), strict=True)
    x = rng.standard_normal((BATCH, *IMG)).astype(np.float32)
    for train in (False, True):
        ref = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=train,
                       mutable=["batch_stats"])[0]
        with torch.no_grad():
            got = port(torch.from_numpy(x), train=train)
        tol = GRCNN_TRAIN_TOL if (train and arch == "grcnn") else TOL
        for key in ("predict", "feature"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), atol=tol,
                                       rtol=tol, err_msg=f"{key} train={train}")

    character = "".join(ALPHABETS)[:12]
    counts = (12, 16)   # the CTC converter's 4 specials and 8 / 12 characters
    mparams, mstats = random_mrn(rng, topt, counts)
    mparams["experts"]["fc"]["kernel"] *= 20.0   # picks away from ties
    jmrn = JaxMRNNet(n_experts=2, num_classes=16, class_counts=counts, prediction="CTC",
                     transformation="None", feature_extraction=topt.FeatureExtraction,
                     sequence_modeling="BiLSTM", output_channel=OC, hidden_size=HID,
                     img_size=IMG[:2])
    ref = jmrn.apply({"params": mparams, "batch_stats": mstats}, jnp.asarray(x), cross=True,
                     train=False, is_train=False)
    server = Server(topt, mparams, mstats, character, class_counts=counts, device="cpu")
    out = server.forward(x)
    np.testing.assert_array_equal(out["index"].numpy(), np.asarray(ref["index"]))
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(ref["logits"]), atol=TOL,
                               rtol=TOL)
    assert len(server.recognize(x)) == BATCH


def test_ctc_dernet_over_vgg_matches_jax(tmp_path, rng):
    """Two VGG extractors: main and aux logits in eval mode."""
    _, topt = _options(tmp_path, il="der")
    jm = JaxDERNet(n_experts=2, num_classes=13, prediction="CTC", transformation="None",
                   feature_extraction="VGG", sequence_modeling="BiLSTM",
                   output_channel=OC, hidden_size=HID, img_size=IMG[:2])
    params, stats = random_der(np.random.default_rng(1), topt, 2, 13)
    stats = _perturb(stats, rng)
    net = DERNet(2, 13, "CTC", "None", "VGG", "BiLSTM", IMG[2], OC, HID, IMG[:2])
    net.load_state_dict(der_state(params, stats), strict=True)
    x = rng.standard_normal((BATCH, *IMG)).astype(np.float32)
    ref = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = net(torch.from_numpy(x), train=False)
    for k in ("logits", "aux_logits"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=TOL, rtol=TOL,
                                   err_msg=k)


# ------------------------------------------------------------ the learners' steps
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


def _learners(jopt, topt, character):
    jl = JaxMRN(jopt)
    tl = MRN(topt, device="cpu")
    for learner in (jl, tl):
        learner.character = character
        learner.converter = learner.build_converter()
    return jl, tl


def _optax_update(jopt, schedule, params, grads):
    tx = jax_build_optimizer(jopt, schedule)
    updates, _ = tx.update(grads, tx.init(params), params)
    return _host(optax.apply_updates(params, updates))


def _step0(tmp, arch):
    jopt, topt = _options(tmp, arch)
    jl, tl = _learners(jopt, topt, ALPHABETS[0] + ALPHABETS[1])
    tl.change_model()
    tl.build_optimizer()
    jl.model = jax_build_recognizer(jopt, jl._total_classes)
    jl.params, jl.batch_stats = to_flax(tl.model)
    grads = _capture_grads(tl)
    loader = _loader(1)
    idx, words = loader.get_batch()
    images = _float_images(loader, idx)
    batch = jl._encode_batch(images, words)
    (loss, (stats, _)), jgrads = jax.jit(jax.value_and_grad(jl.loss_fn, has_aux=True),
                                         static_argnums=(4,))(
        jl.params, jl.batch_stats, batch, jax.random.PRNGKey(0), None)
    before = to_flax(tl.model)[0]
    metrics = tl.train_step((images, words))
    port_grads = flax_tree(grads.items())
    return dict(jax_loss=float(loss), jax_grads=_host(jgrads), jax_stats=_host(stats),
                loss=float(metrics["loss"]), grads=port_grads, state=to_flax(tl.model),
                optax_params=_optax_update(jopt, jax_build_schedule(jopt), before, port_grads))


@pytest.fixture(scope="module", params=["crnn", "grcnn"])
def step0(request, tmp_path_factory):
    """One step-0 step of a new CRNN / GRCNN expert on both sides."""
    return _step0(tmp_path_factory.mktemp(f"{request.param}_step0"), request.param)


def test_step0_loss_and_grads_match_jax(step0):
    np.testing.assert_allclose(step0["loss"], step0["jax_loss"], rtol=STEP_LOSS_RTOL)
    largest = max(float(np.abs(g).max()) for _, g in _leaves(step0["jax_grads"]))
    _assert_trees(step0["grads"], step0["jax_grads"], STEP_GRAD_GLOBAL * largest,
                  STEP_GRAD_RTOL, "grads")


def test_step0_update_and_stats_match_jax(step0):
    _assert_trees(step0["state"][0], step0["optax_params"], UPDATE_ATOL, UPDATE_RTOL, "params")
    _assert_trees(step0["state"][1], step0["jax_stats"], STEP_STATS_TOL, STEP_STATS_TOL,
                  "batch_stats")


def _two_experts(rng, topt):
    counts = (1 + len(ALPHABETS[0]), 1 + len(ALPHABETS[0]) + len(ALPHABETS[1]))
    experts = []
    for count in counts:
        params, stats = random_recognizer(rng, topt, count)
        v = _perturb({"params": params, "batch_stats": stats}, rng)
        v["params"]["fc"]["kernel"] = 3 * rng.standard_normal(
            v["params"]["fc"]["kernel"].shape).astype(np.float32)
        experts.append((v["params"], v["batch_stats"]))
    return counts, experts


def routed_pair(tmp, pinned=True, arch="crnn"):
    """A JAX and a port MRN learner in the router phase over the same two
    frozen experts and router, and one rehearsal batch (float images)."""
    rng = np.random.default_rng(21)
    jopt, topt = _options(tmp, arch, mrn_pin_expert_stats=pinned)
    counts, experts = _two_experts(rng, topt)
    jl, tl = _learners(jopt, topt, ALPHABETS[0] + ALPHABETS[1])
    jl.expert_params = [p for p, _ in experts]
    jl.expert_stats = [s for _, s in experts]
    jl.class_counts = list(counts)
    jl._build_mrn_module(n_experts=2, counts=counts)
    jl._phase = "routed"
    router = random_router(rng, topt, 2)
    jl.params, jl.batch_stats = jl._routed_variables(router)
    jl.build_optimizer(scale=1.0, the=2)
    for (p, s), count in zip(experts, counts):
        tl.add_expert(p, s, count)
    tl.start_router_phase(router)
    loader = _loader(1)
    idx, words, task_ids = loader.get_batch2()
    images = _float_images(loader, idx)
    batch = jl._encode_batch(images, words)
    batch["dataset_idx"] = jnp.asarray(task_ids)
    return jl, tl, (images, words, task_ids), batch


@pytest.fixture(scope="module")
def step1(tmp_path_factory):
    """One router step over two frozen CRNN experts on both sides."""
    jl, tl, fetched, batch = routed_pair(tmp_path_factory.mktemp("crnn_step1"))
    grads = _capture_grads(tl)
    experts_before = {k: v.clone() for k, v in tl.mrn_model.experts.state_dict().items()}
    (_, (_, jmetrics)), jgrads = jax.jit(jax.value_and_grad(jl.loss_fn, has_aux=True),
                                         static_argnums=(4,))(
        jl.params, jl.batch_stats, batch, jax.random.PRNGKey(0), None)
    before = {k: v for k, v in to_flax(tl.mrn_model)[0].items() if k in ROUTER_KEYS}
    metrics = tl.train_step(fetched)
    port_grads = flax_tree(grads.items())
    return dict(metrics=metrics, jax_metrics=_host(jmetrics), grads=port_grads,
                jax_grads={k: _host(jgrads[k]) for k in ROUTER_KEYS},
                params=to_flax(tl.mrn_model)[0], experts_before=experts_before,
                experts_after=tl.mrn_model.experts.state_dict(),
                optax_router=_optax_update(jl.opt, jax_build_schedule(jl.opt, scale=1.0,
                                                                      the=2), before,
                                           port_grads))


def test_step1_loss_split_matches_jax(step1):
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
    after = step1["experts_after"]   # pinned: nothing of an expert moves
    assert all(torch.equal(v, after[k]) for k, v in step1["experts_before"].items())


# ------------------------------------------------------------ the entry points
@pytest.mark.parametrize("config", ["crnn_base", "crnn_der", "crnn_ewc", "crnn_joint",
                                    "crnn_lwf", "crnn_mrn", "crnn_wa", "grcnn_mrn"])
def test_every_crnn_and_grcnn_config_builds_its_learner(tmp_path, rng, config):
    """Each shipped CRNN / GRCNN config loads, builds its strategy's learner
    and a recognizer of its stages, narrowed, that reads a batch."""
    from mrn_tpu_torch.train.learners import build_learner
    opt = load_config(f"configs/{config}.py", output_dir=str(tmp_path), imgW=IMG[1],
                      output_channel=OC, hidden_size=HID)
    learner = build_learner(opt, device="cpu")
    assert type(learner).__name__ == {"base": "BaseLearner", "der": "DER", "ewc": "EWC",
                                      "joint_mix": "JointLearner", "lwf": "LwF", "mrn": "MRN",
                                      "wa": "WA"}[opt.il]
    model = build_recognizer(opt, 13)
    model.load_state_dict(from_flax(*random_recognizer(rng, opt, 13)), strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(rng.standard_normal((2, *IMG)).astype(np.float32)))
    t = IMG[1] // 4 - 1 if opt.FeatureExtraction == "VGG" else IMG[1] // 4 + 1
    assert out["predict"].shape == (2, t, 13) and bool(torch.isfinite(out["predict"]).all())


SOURCE = SyntheticSource(ALPHABETS, LANS[:2], n_train=[12, 10], n_test=[4, 4], img_h=IMG[0],
                         img_w=IMG[1], seed=3, device_bank=True, renderer="bits", max_len=5)


@pytest.mark.parametrize("il", ["mrn", "base", "lwf", "wa", "ewc", "der", "joint_mix"])
def test_crnn_campaign_runs_every_strategy(tmp_path, il):
    """``campaign --arch crnn`` at a narrow width, 2 tasks of 2 steps:
    finite scores and the files named as the JAX script names them (no
    ``crnn_`` prefix)."""
    opt = campaign_options(tasks=2, num_iter=2, batch_size=BATCH, seed=3, out=str(tmp_path),
                           il=il, arch="crnn", output_channel=OC, hidden_size=HID,
                           imgW=IMG[1], batch_max_length=BML, val_interval=1, memory_num=4,
                           fisher_num_iter=1)
    assert (opt.Transformation, opt.FeatureExtraction, opt.SequenceModeling,
            opt.Prediction) == ("None", "VGG", "BiLSTM", "CTC")
    assert opt.exp_name == f"acc_{il}"
    opt.image_bank = SOURCE.device_bank("cpu")
    run = run_joint if il.startswith("joint") else run_incremental
    _, aia, matrix, _ = run(opt, SOURCE, device="cpu")
    assert all(np.isfinite(a) for a in aia) and all(np.isfinite(x) for r in matrix for x in r)
    assert len(matrix[-1]) == 2
    assert os.path.exists(os.path.join(str(tmp_path), "saved", f"acc_{il}", "log_train.txt"))
    assert os.path.exists(os.path.join(str(tmp_path), f"data_{il}.txt"))


def test_campaign_main_writes_the_crnn_record(tmp_path, monkeypatch):
    from mrn_tpu_torch import campaign
    monkeypatch.setattr(campaign, "build_source", lambda *a, **k: SOURCE)
    monkeypatch.setattr(campaign, "campaign_options",
                        lambda *a, **k: campaign_options(*a, **dict(k, imgW=IMG[1],
                                                                    batch_max_length=BML,
                                                                    memory_num=4)))
    record = campaign.main(["--arch", "crnn", "--smoke", "--tasks", "2", "--num_iter", "2",
                            "--batch_size", str(BATCH), "--device", "cpu",
                            "--out", str(tmp_path)])
    with open(os.path.join(str(tmp_path), "mrn.json"), encoding="utf-8") as f:
        assert json.load(f) == record
    assert record["arch"] == "crnn" and np.isfinite(record["final_aia"])
    assert record["tf32"] == {"cudnn_conv": torch.backends.cudnn.allow_tf32,
                              "matmul": torch.backends.cuda.matmul.allow_tf32}


@pytest.mark.parametrize("arch", ["crnn", "grcnn"])
def test_cli_entry_points_run_the_configs(tmp_path, arch):
    """The config's stages through ``train_cli`` on an LMDB tree (MRN over 2
    tasks: both best files and the AIA line), ``evaluate_cli`` on the
    routed file and with ``--int8`` on task 0's, and ``recognize_cli`` on a
    folder of crops, each with no flag of its own."""
    from mrn_tpu_torch import evaluate_cli, recognize_cli, train_cli
    from mrn_tpu_torch.tools import create_lmdb

    index = {ch: i for i, ch in enumerate("".join(ALPHABETS))}
    for split, n, seed in (("train", 12, 0), ("test", 4, 50)):
        for t, lan in enumerate(LANS[:2]):
            create_lmdb.create_synthetic_dataset(str(tmp_path / split / lan), ALPHABETS[t], n,
                                                 seed + t, heights=(20, 40), widths=(40, 160),
                                                 max_len=5, char_to_idx=index)
    base = load_config(CONFIGS[arch])
    model = {k: base.get(k) for k in ("model_name", "Transformation", "FeatureExtraction",
                                      "SequenceModeling", "Prediction", "input_channel")}
    model.update(output_channel=OC, hidden_size=HID)
    common = dict(exp_name=f"{arch}_cli", il="mrn", memory="random", memory_num=4,
                  batch_max_length=BML, imgH=IMG[0], imgW=IMG[1], manual_seed=111,
                  output_dir=str(tmp_path / "saved"), data_log=str(tmp_path / "data_any.txt"))
    train = dict(lan_list=LANS[:2], select_data=[str(tmp_path / "train")],
                 valid_datas=[str(tmp_path / "test")], batch_size=BATCH, NED=True, workers=0,
                 num_iter=2, val_interval=2)
    cfg = tmp_path / f"{arch}.py"
    cfg.write_text(f"common = {common!r}\nmodel = {model!r}\ntrain = {train!r}\n",
                   encoding="utf-8")
    run = train_cli.main(["--config", str(cfg), "--device", "cpu"])
    exp = tmp_path / "saved" / f"{arch}_cli"
    assert {"Chinese_0_0_best_score.msgpack", "Latin_1_1_best_score.msgpack"} <= {
        p.name for p in exp.iterdir()}
    assert len(run.best_scores) == 2 and all(np.isfinite(run.best_scores))
    assert run.learner.opt.FeatureExtraction == base.FeatureExtraction
    assert len(run.learner.expert_states) == 2

    test = str(tmp_path / "test")
    result = evaluate_cli.main(["--config", str(cfg), "--saved_model",
                                str(exp / "Latin_1_1_best_score.msgpack"), "--eval_data", test,
                                "--device", "cpu", "--result_dir", str(tmp_path / "result")])
    assert result is not None
    learner = evaluate_cli.load_learner(load_config(str(cfg)),
                                        str(exp / "Chinese_0_0_best_score.msgpack"), 0,
                                        device="cpu")
    assert learner.opt.FeatureExtraction == base.FeatureExtraction
    evaluate_cli.main(["--config", str(cfg), "--saved_model",
                       str(exp / "Chinese_0_0_best_score.msgpack"), "--eval_data", test,
                       "--taski", "0", "--int8", "--device", "cpu",
                       "--result_dir", str(tmp_path / "result8")])

    folder = tmp_path / "crops"
    folder.mkdir()
    from mrn_tpu_torch.data.image import encode_png
    for i, img in enumerate(SOURCE.bank[:3]):
        (folder / f"{i}.png").write_bytes(encode_png(np.asarray(img)))
    words = recognize_cli.main(["--config", str(cfg), "--saved_model",
                                str(exp / "Latin_1_1_best_score.msgpack"), "--image_folder",
                                str(folder), "--taski", "1", "--device", "cpu"])
    assert len(words) == 3
