"""The port's TRBA (TPS/ResNet/BiLSTM/Attn) training path against the JAX
package's, float32 on the CPU, narrow (output_channel 32, hidden 16, 32x64
crops, batch 4, ``batch_max_length`` 6; the localization net keeps its
fixed widths): the teacher-forced decoder, the training warp, train-mode
TPS and ResNet with their running statistics, one MRN step-0 step and one
step-1 step against the JAX learner's, LwF's and WA's distillation with the
teacher-forced old network and KD from index 1, the Attn ``DERNet``, the
``MRN._routed_model`` decode length, ``change_model``'s fresh decoder, and
every strategy through ``campaign.run_incremental`` / ``run_joint`` with
``--arch trba``.  JAX's train-mode TPS gathers on the CPU (its training
warp); its eval-mode TPS too, as the port's plain warp does."""

import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

import mrn_tpu.models.tps as jax_tps
from mrn_tpu.config import load_config as jax_load_config
from mrn_tpu.models.attention import AttentionDecoder as JaxDecoder
from mrn_tpu.models.common import TorchDense as JaxDense
from mrn_tpu.models.composer import build_recognizer as jax_build_recognizer
from mrn_tpu.models.der import DERNet as JaxDERNet
from mrn_tpu.models.resnet import ResNetExtractor as JaxResNet
from mrn_tpu.ops.grid_sample import grid_sample_gather
from mrn_tpu.train.learners.der import DER as JaxDER
from mrn_tpu.train.learners.lwf import LwF as JaxLwF
from mrn_tpu.train.learners.mrn import MRN as JaxMRN
from mrn_tpu.train.learners.wa import WA as JaxWA
from mrn_tpu.train.optim import build_optimizer as jax_build_optimizer
from mrn_tpu.train.optim import build_schedule as jax_build_schedule
from mrn_tpu_torch.bridge import der_state, flax_tree, from_flax, to_flax
from mrn_tpu_torch.campaign import LANS, campaign_options, run_incremental, run_joint
from mrn_tpu_torch.config import load_config
from mrn_tpu_torch.data.synthetic import (SyntheticSource, SyntheticTaskLoader,
                                          alphabet_of_size)
from mrn_tpu_torch.models import tps
from mrn_tpu_torch.models.attention import AttentionDecoder
from mrn_tpu_torch.models.common import Dense
from mrn_tpu_torch.models.composer import build_recognizer
from mrn_tpu_torch.models.der import DERNet
from mrn_tpu_torch.models.init import random_der, random_recognizer, random_router
from mrn_tpu_torch.models.resnet import ResNetExtractor
from mrn_tpu_torch.ops import grid_sample
from mrn_tpu_torch.ops.losses import kd_loss
from mrn_tpu_torch.train.learners.base import BaseLearner
from mrn_tpu_torch.train.learners.der import DER
from mrn_tpu_torch.train.learners.lwf import LwF, T
from mrn_tpu_torch.train.learners.mrn import MRN, PI
from mrn_tpu_torch.train.learners.wa import WA

IMG = (32, 64, 4)
OC, HID, BATCH, BML = 32, 16, 4, 6
ALPHABETS = [alphabet_of_size(10), alphabet_of_size(6, 0x4E00 + 10)]
# module by module, float32: summation order only
TOL = 1e-5
# the TPS grid: two 23-term float32 products that cancel terms far larger
# than the result, so each framework's grid is ~6e-5 from the float64
# product of its own fiducials (tests/test_torch_tps.py)
GRID_TOL = 2e-4
# the warp on the same grid: the same taps and weights, float32 ulps
WARP_TOL = 1e-6
# train-mode ResNet: the deep BatchNorms normalise over 4 x 1 x 17 values
# with the fast variance E[x^2] - E[x]^2, which cancels and amplifies each
# framework's float32 rounding: on the test's input JAX's output reads
# 3.3e-4 from a float64 run of the same network and the port's 4.3e-5, so
# the port is held to JAX at 1e-3 and to its float64 run at 1e-4
RESNET_TRAIN_TOL, RESNET_F64_TOL = 1e-3, 1e-4
# Whole-learner steps, float32, on the same weights and batch.  The losses
# agree to float32 rounding (measured: 7.5e-8 relative at step 0, equal at
# step 1): 1e-5.  The step-0 gradients of a train-mode TRBA are
# ill-conditioned in float32: 29 train-mode BatchNorms normalise with a
# cancelling variance (E[x^2] - E[x]^2) and the warp's gradient jumps where
# a tap crosses a pixel, so both frameworks' gradients read ~8.6e-3 of the
# largest |grad| from a float64 run of the port (measured: the port 8.6e-3,
# JAX 8.8e-3) and 5.0e-4 from each other.  A gradient element is held to
# JAX's within 2e-3 of the largest |grad| of the tree plus 1e-3 relative.
# Adam moves a parameter by about lr * sign(g) whatever |g| is, so updates
# are held against optax fed the port's own grads from the port's own
# parameters, to float32 rounding (UPDATE_ATOL, UPDATE_RTOL).  The running
# statistics after one train-mode step read 1.3e-5 of each leaf's largest
# value (measured, the batch moments through the same cancelling
# BatchNorms): 1e-4 absolute plus 1e-4 relative.
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_GLOBAL, STEP_GRAD_RTOL = 2e-3, 1e-3
UPDATE_ATOL, UPDATE_RTOL = 1e-7, 1e-6
STEP_STATS_TOL = 1e-4
# Step 1 runs the frozen experts in eval mode without gradients: the router
# grads agree to 7e-6 of each leaf's largest |grad| (measured), the route
# bias aside, whose true gradient is 0 (the routing softmax is
# shift-invariant) and reads 5.2e-7 of the largest router gradient: each
# leaf to 1e-4 of its largest |grad| plus 1e-5 of the largest router grad
ROUTER_GRAD_SCALE, ROUTER_GRAD_FLOOR = 1e-4, 1e-5
# LwF's KD and DER's loss: float32 rounding of the same chain, 1e-5 relative


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch's CPU ops on one thread here: beside the other test workers,
    more threads oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _options(tmp, **kw):
    common = dict(imgW=IMG[1], output_channel=OC, hidden_size=HID, batch_size=BATCH,
                  batch_max_length=BML, num_iter=4, manual_seed=3, output_dir=str(tmp),
                  data_log=str(tmp / "data_any.txt"))
    common.update(kw)
    return (jax_load_config("configs/trba_mrn.py", **common),
            load_config("configs/trba_mrn.py", **common))


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


# ------------------------------------------------------------ the decoder
class _JaxHead(fnn.Module):
    """The JAX decoder with its ``fc`` generator, as a Recognizer builds them."""

    num_classes: int

    def setup(self):
        self.fc = JaxDense(self.num_classes, name="fc")
        self.prediction = JaxDecoder(input_size=HID, hidden_size=HID,
                                     num_classes=self.num_classes, generator=self.fc,
                                     batch_max_length=BML, name="prediction")

    def __call__(self, batch_H, text, class_count=None):
        return self.prediction(batch_H, text, is_train=True, class_count=class_count)


@pytest.mark.parametrize("class_count", [None, 12])
def test_teacher_forced_decoder_and_grads_match_jax(rng, class_count):
    """Logits and the VJP (features and every parameter), with OOV ids in
    the text clamped to 0 against ``class_count``."""
    n = 20
    jm = _JaxHead(n)
    h = rng.standard_normal((BATCH, 17, HID)).astype(np.float32)
    text = rng.integers(0, n, (BATCH, BML + 1)).astype(np.int32)
    if class_count:
        text[:, 2] = class_count + 3      # OOV for a padded expert
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(h), jnp.asarray(text))["params"]
    ref, vjp = jax.vjp(lambda p, x: jm.apply({"params": p}, x, jnp.asarray(text), class_count),
                       params, jnp.asarray(h))
    cot = rng.standard_normal(ref.shape).astype(np.float32)
    ref_grads, ref_dh = vjp(jnp.asarray(cot))

    port = nn.ModuleDict({"fc": Dense(HID, n), "prediction": AttentionDecoder(HID, HID, n, BML)})
    port.load_state_dict(from_flax(_host(params)), strict=True)
    x = torch.from_numpy(h).requires_grad_()
    got = port["prediction"](x, torch.from_numpy(text), port["fc"], class_count, is_train=True)
    assert got.shape == ref.shape == (BATCH, BML + 1, n)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    names = [k for k, _ in port.named_parameters()]
    grads = torch.autograd.grad((got * torch.from_numpy(cot)).sum(),
                                [x] + [p for _, p in port.named_parameters()])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(ref_dh), atol=TOL, rtol=TOL)
    _assert_trees(flax_tree(zip(names, grads[1:])), ref_grads, TOL, TOL, "decoder grads")
    if class_count:   # the clamped column reads char_embeddings row 0, never its own
        emb = dict(zip(names, grads[1:]))["prediction.char_embeddings"]
        assert not emb[class_count + 3].any()


# ------------------------------------------------------------ the training warp
def test_train_warp_and_grads_match_jax_gather(rng):
    """Values and the image / grid gradients, on a grid in [-1.3, 1.3]
    (clamped borders) kept off exact ties (JAX's clip splits a tie's
    gradient, torch's clamp passes it)."""
    image = rng.standard_normal((2, 8, 12, 3)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 5, 7, 2)).astype(np.float32)
    ref, vjp = jax.vjp(grid_sample_gather, jnp.asarray(image), jnp.asarray(grid))
    cot = rng.standard_normal(ref.shape).astype(np.float32)
    ref_di, ref_dg = vjp(jnp.asarray(cot))
    x, g = torch.from_numpy(image).requires_grad_(), torch.from_numpy(grid).requires_grad_()
    before = grid_sample.launches
    got = grid_sample.grid_sample_train(x, g)
    di, dg = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), [x, g])
    assert grid_sample.launches == before          # plain PyTorch, never counted
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=WARP_TOL,
                               rtol=WARP_TOL)
    np.testing.assert_allclose(di.numpy(), np.asarray(ref_di), atol=WARP_TOL, rtol=WARP_TOL)
    np.testing.assert_allclose(dg.numpy(), np.asarray(ref_dg), atol=1e-5, rtol=1e-5)
    clamped = np.abs(grid) > 1.0
    assert clamped.any() and not dg.numpy()[clamped].any()   # the border clamp: no gradient


def test_train_warp_keeps_the_kernels_rounding_in_bf16(rng):
    """A bfloat16 image: float32 arithmetic, one rounding to bfloat16, as
    the kernel's plain version; the image gradient reaches the bf16 leaf."""
    image = torch.from_numpy(rng.standard_normal((2, 8, 12, 4)).astype(np.float32))
    image = image.to(torch.bfloat16).requires_grad_()
    grid = torch.from_numpy(rng.uniform(-1, 1, (2, 8, 12, 2)).astype(np.float32))
    out = grid_sample.grid_sample_train(image, grid)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, grid_sample.grid_sample_reference(image, grid))
    (grad,) = torch.autograd.grad(out.float().sum(), image)
    assert grad.dtype == torch.bfloat16 and grad.abs().sum() > 0


# ------------------------------------------------------------ train-mode TPS and ResNet
def _perturb(variables, rng, scale=0.05):
    def f(path, leaf):
        leaf = np.asarray(leaf)
        noise = scale * rng.standard_normal(leaf.shape).astype(np.float32)
        if path[-1].key == "var":
            return np.abs(leaf + noise) + 0.5
        return leaf + noise
    return jax.tree_util.tree_map_with_path(f, variables)


def test_train_mode_resnet_and_stats_match_jax(rng):
    jm = JaxResNet(OC)
    x = rng.standard_normal((BATCH, *IMG)).astype(np.float32)
    v = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False), rng)
    ref, mutated = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    state = from_flax(v["params"], v["batch_stats"])
    port, port64 = ResNetExtractor(IMG[2], OC), ResNetExtractor(IMG[2], OC).double()
    port.load_state_dict(state, strict=True)
    port64.load_state_dict({k: t.double() for k, t in state.items()}, strict=True)
    got = port(torch.from_numpy(x), train=True).detach().numpy()
    got64 = port64(torch.from_numpy(x).double(), train=True).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=RESNET_TRAIN_TOL,
                               rtol=RESNET_TRAIN_TOL)
    np.testing.assert_allclose(got, got64, atol=RESNET_F64_TOL, rtol=RESNET_F64_TOL)
    _assert_trees(to_flax(port)[1], mutated["batch_stats"], TOL, TOL, "batch_stats")
    # eval mode leaves the statistics alone
    stats = to_flax(port)[1]
    port(torch.from_numpy(x))
    _assert_trees(to_flax(port)[1], stats, 0.0, 0.0, "eval-mode batch_stats")


def test_train_mode_tps_warp_and_stats_match_jax(rng, monkeypatch):
    """Train-mode TPS: the localization net's BatchNorms on batch statistics
    (running statistics moved as flax's), the grid within GRID_TOL of
    JAX's, the training warp (no kernel launch) on it, and a grid gradient
    that reaches the localization net."""
    model = jax_tps.TPSTransformer(num_fiducial=20, out_size=IMG[:2])
    x = rng.standard_normal((BATCH, *IMG)).astype(np.float32)
    v = _perturb(model.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False), rng)
    jax_grids, port_grids = [], []

    def jax_warp(image, grid, inference=False):
        assert not inference                      # train mode: the differentiable warp
        jax_grids.append(np.asarray(grid))
        return grid_sample_gather(image, grid)

    monkeypatch.setattr(jax_tps, "grid_sample", jax_warp)
    ref, mutated = model.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])

    def port_warp(image, grid):
        port_grids.append(grid.detach().numpy().copy())
        return grid_sample.grid_sample_train(image, grid)

    monkeypatch.setattr(tps, "grid_sample_train", port_warp)
    port = tps.TPSTransformer(20, IMG[:2], IMG[2])
    port.load_state_dict(from_flax(v["params"], v["batch_stats"]), strict=True)
    before = grid_sample.launches
    xt = torch.from_numpy(x).requires_grad_()
    got = port(xt, train=True)
    assert grid_sample.launches == before
    np.testing.assert_allclose(port_grids[0], jax_grids[0], atol=GRID_TOL, rtol=0)
    expect = np.asarray(grid_sample_gather(jnp.asarray(x), jnp.asarray(port_grids[0])))
    np.testing.assert_allclose(got.detach().numpy(), expect, atol=WARP_TOL, rtol=WARP_TOL)
    assert np.abs(got.detach().numpy() - np.asarray(ref)).max() > 0   # two grids
    _assert_trees(to_flax(port)[1], mutated["batch_stats"], TOL, TOL, "batch_stats")
    got.square().sum().backward()
    fc2 = port.localization.localization_fc2
    assert torch.isfinite(fc2.kernel.grad).all() and fc2.kernel.grad.abs().sum() > 0
    assert xt.grad.abs().sum() > 0


# ------------------------------------------------------------ the learners' steps
def _loader(taski):
    return SyntheticTaskLoader(ALPHABETS, taski, BATCH, 8, img_w=IMG[1], max_len=5,
                               seed=taski)


def _float_images(loader, idx):
    """The crops, normalised, with the constant alpha channel replaced by
    seeded noise (as tests/test_torch_train_step.py does)."""
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


def _jax_learner(cls, jopt, character):
    jl = cls(jopt)
    jl.character = character
    jl.converter = jl.build_converter()
    return jl


def _port_learner(cls, topt, character):
    tl = cls(topt, device="cpu")
    tl.character = character
    tl.converter = tl.build_converter()
    return tl


def _optax_update(jopt, schedule, params, grads):
    tx = jax_build_optimizer(jopt, schedule)
    updates, _ = tx.update(grads, tx.init(params), params)
    return _host(optax.apply_updates(params, updates))


@pytest.fixture(scope="module")
def step0(tmp_path_factory):
    """One step-0 step of a new TRBA expert on both sides."""
    jopt, topt = _options(tmp_path_factory.mktemp("trba_step0"))
    character = ALPHABETS[0] + ALPHABETS[1]
    jl = _jax_learner(JaxMRN, jopt, character)
    tl = _port_learner(MRN, topt, character)
    # a new expert as change_model draws it (zero localization_fc2 kernel)
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
                optax_params=_optax_update(jopt, jax_build_schedule(jopt), before, port_grads),
                pad=int(tl.converter.pad_id), label=np.asarray(batch["label"]))


def test_step0_loss_and_grads_match_jax(step0):
    assert (step0["label"][:, 1:] == step0["pad"]).any()   # [PAD] targets to ignore
    np.testing.assert_allclose(step0["loss"], step0["jax_loss"], rtol=STEP_LOSS_RTOL)
    largest = max(float(np.abs(g).max()) for _, g in _leaves(step0["jax_grads"]))
    _assert_trees(step0["grads"], step0["jax_grads"], STEP_GRAD_GLOBAL * largest,
                  STEP_GRAD_RTOL, "grads")


def test_step0_update_and_stats_match_jax(step0):
    _assert_trees(step0["state"][0], step0["optax_params"], UPDATE_ATOL, UPDATE_RTOL, "params")
    _assert_trees(step0["state"][1], step0["jax_stats"], STEP_STATS_TOL, STEP_STATS_TOL,
                  "batch_stats")
    # the TPS grid's gradient reached the localization net
    assert np.abs(step0["grads"]["extractor"]["transformation"]["localization"]
                  ["localization_fc2"]["kernel"]).max() > 0


ROUTER_KEYS = ("dm_router", "channel_route", "route")


@pytest.fixture(scope="module")
def step1(tmp_path_factory):
    """One router step over two frozen TRBA experts (teacher-forced,
    soft-routed) on both sides."""
    rng = np.random.default_rng(21)
    jopt, topt = _options(tmp_path_factory.mktemp("trba_step1"))
    counts = (5 + len(ALPHABETS[0]), 5 + len(ALPHABETS[0]) + len(ALPHABETS[1]))
    experts = []
    for count in counts:
        params, stats = random_recognizer(rng, topt, count)
        v = _perturb({"params": params, "batch_stats": stats}, rng)
        v["params"]["fc"]["kernel"] = 3 * rng.standard_normal(
            v["params"]["fc"]["kernel"].shape).astype(np.float32)
        experts.append((v["params"], v["batch_stats"]))
    character = ALPHABETS[0] + ALPHABETS[1]
    jl = _jax_learner(JaxMRN, jopt, character)
    jl.expert_params = [p for p, _ in experts]
    jl.expert_stats = [s for _, s in experts]
    jl.class_counts = list(counts)
    jl._build_mrn_module(n_experts=2, counts=counts)
    jl._phase = "routed"
    router = random_router(rng, topt, 2)
    params, stats = jl._routed_variables(router)
    jl.params, jl.batch_stats = params, stats
    jl.build_optimizer(scale=1.0, the=2)

    tl = _port_learner(MRN, topt, character)
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
    launches = grid_sample.launches
    metrics = tl.train_step((images, words, task_ids))
    port_grads = flax_tree(grads.items())
    return dict(task_ids=task_ids, metrics=metrics, jax_metrics=_host(jmetrics),
                grads=port_grads, jax_grads={k: _host(jgrads[k]) for k in ROUTER_KEYS},
                params=to_flax(tl.mrn_model)[0], experts_before=experts_before,
                experts_after=tl.mrn_model.experts.state_dict(),
                launches=grid_sample.launches - launches,
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


def test_step1_experts_stay_frozen_in_eval_mode(step1):
    """Bitwise: no parameter moves and no BatchNorm statistic drifts
    (JAX's pinned mode); on the CPU the eval-mode warps count no launch."""
    after = step1["experts_after"]
    assert all(torch.equal(v, after[k]) for k, v in step1["experts_before"].items())
    assert step1["launches"] == 0


# ------------------------------------------------------------ LwF and WA
def _task1_kd(tmp_path, jcls, tcls, il):
    """A JAX and a port learner of strategy ``il`` at task 1 with the same
    old network (task 0's expert, perturbed) and the same new model."""
    jopt, topt = _options(tmp_path, il=il)
    rng = np.random.default_rng(5)
    old_count = 5 + len(ALPHABETS[0])
    old = _perturb(dict(zip(("params", "batch_stats"), random_recognizer(rng, topt, old_count))),
                   rng)
    old_params, old_stats = old["params"], old["batch_stats"]
    jl, tl = _jax_learner(jcls, jopt, ALPHABETS[0]), _port_learner(tcls, topt, ALPHABETS[0])
    jl.model = jax_build_recognizer(jopt, old_count)
    jl.params, jl.batch_stats = old_params, old_stats
    tl.model = build_recognizer(topt, old_count)
    tl.model.load_state_dict(from_flax(old_params, old_stats), strict=True)
    for learner in (jl, tl):
        learner._cur_task = 0
        learner.after_task()
        learner._cur_task = 1
        learner.character = ALPHABETS[0] + ALPHABETS[1]
        learner.converter = learner.build_converter()
    tl.change_model()
    jl.model = jax_build_recognizer(jopt, jl._total_classes)
    jl.params, jl.batch_stats = to_flax(tl.model)
    assert tl._known_classes == jl._known_classes == old_count
    return jl, tl


def test_kd_from_index_1_with_teacher_forced_old_network(tmp_path):
    """Task 1 of LwF: the old network (task 0's expert, eval mode,
    teacher-forced on label[:, :-1]) distilled over classes 1..known, and
    the total ``3 * KD + CE`` against the JAX learner's; WA's total is the
    same terms at weight 2, as in JAX."""
    jl, tl = _task1_kd(tmp_path, JaxLwF, LwF, "lwf")
    loader = _loader(1)
    idx, words = loader.get_batch()
    images = _float_images(loader, idx)
    batch = jl._encode_batch(images, words)
    loss, (_, jmetrics) = jax.jit(jl.loss_fn)(jl.params, jl.batch_stats, batch,
                                              jax.random.PRNGKey(0), jl.train_aux())
    tbatch = tl._encode_batch(images, words)
    params = dict(tl.model.named_parameters())
    launches = grid_sample.launches
    got, metrics = tl.loss_fn(params, tbatch, tl.train_aux())
    assert grid_sample.launches == launches         # the CPU warps count nothing
    np.testing.assert_allclose(float(metrics["kd"]), float(jmetrics["kd"]),
                               rtol=STEP_LOSS_RTOL)
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=STEP_LOSS_RTOL)
    # the KD window starts at index 1, the [GO] column left out
    known = tl._known_classes
    old = tl._old_forward(tbatch, tl._old_model)
    preds = tl._apply_train(params, tbatch).detach()
    flat = lambda t: t.reshape(-1, t.shape[-1])  # noqa: E731
    from1 = float(kd_loss(flat(preds)[:, 1:known], flat(old)[:, 1:known], T))
    np.testing.assert_allclose(float(metrics["kd"]), from1, rtol=1e-5)
    assert abs(from1 - float(kd_loss(flat(preds)[:, :known], flat(old)[:, :known], T))) > 1e-4
    # the old network decoded teacher-forced: its logits equal a forced pass
    with torch.no_grad():
        forced = tl._old_model(tbatch["image"], tbatch["label"][:, :-1], train=False,
                               is_train=True)["predict"]
    assert torch.equal(old, forced.float())

    _, wa = _task1_kd(tmp_path / "wa", JaxWA, WA, "wa")
    assert WA.kd_weight == JaxWA.kd_weight == 2.0
    got_wa, metrics_wa = wa.loss_fn(dict(wa.model.named_parameters()), tbatch, wa.train_aux())
    clf = tl._recognition_loss(preds, tbatch)
    np.testing.assert_allclose(float(metrics_wa["kd"]), float(metrics["kd"]), rtol=1e-6)
    np.testing.assert_allclose(float(got_wa.detach()), 2.0 * from1 + float(clf), rtol=1e-5)


# ------------------------------------------------------------ DER
def test_random_der_trees_match_a_jax_dernet_init(tmp_path):
    """The Attn DERNet's trees leaf for leaf (names and shapes) against a
    JAX ``DERNet.init`` at two extractors, and the bridge both ways."""
    _, topt = _options(tmp_path, il="der")
    jm = JaxDERNet(n_experts=2, num_classes=13, prediction="Attn", transformation="TPS",
                   feature_extraction="ResNet", sequence_modeling="BiLSTM",
                   output_channel=OC, hidden_size=HID, img_size=IMG[:2], batch_max_length=BML)
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((2, *IMG)),
                                       jnp.zeros((2, BML + 1), jnp.int32), train=False))
    params, stats = random_der(np.random.default_rng(0), topt, 2, 13)
    def shapes(tree, prefix=""):
        out = {}
        for k, x in tree.items():
            out.update(shapes(x, f"{prefix}{k}/") if isinstance(x, dict)
                       else {prefix + k: tuple(x.shape)})
        return out

    assert shapes(params) == shapes(v["params"])
    assert shapes(stats) == shapes(v["batch_stats"])
    net = DERNet(2, 13, "Attn", "TPS", "ResNet", "BiLSTM", IMG[2], OC, HID, IMG[:2],
                 batch_max_length=BML)
    net.load_state_dict(der_state(params, stats), strict=True)
    back_p, back_s = to_flax(net)
    _assert_trees(back_p, params, 0.0, 0.0, "params")
    _assert_trees(back_s, stats, 0.0, 0.0, "stats")


def test_attn_dernet_forward_and_loss_match_jax(tmp_path, rng):
    """Two TRBA extractors: eval-mode teacher-forced and greedy logits of
    both heads, and the DER learner's loss (CE of the main head; the aux
    head's logged, not in the total) against the JAX learner's."""
    jopt, topt = _options(tmp_path, il="der")
    n = 5 + len(ALPHABETS[0]) + len(ALPHABETS[1])
    jm = JaxDERNet(n_experts=2, num_classes=n, prediction="Attn", transformation="TPS",
                   feature_extraction="ResNet", sequence_modeling="BiLSTM",
                   output_channel=OC, hidden_size=HID, img_size=IMG[:2], batch_max_length=BML)
    params, stats = random_der(np.random.default_rng(1), topt, 2, n)
    stats = _perturb(stats, rng)
    net = DERNet(2, n, "Attn", "TPS", "ResNet", "BiLSTM", IMG[2], OC, HID, IMG[:2],
                 batch_max_length=BML)
    net.load_state_dict(der_state(params, stats), strict=True)
    x = rng.standard_normal((BATCH, *IMG)).astype(np.float32)
    text = rng.integers(0, n + 2, (BATCH, BML + 1)).astype(np.int32)
    v = {"params": params, "batch_stats": stats}
    for is_train in (True, False):
        ref = jm.apply(v, jnp.asarray(x), jnp.asarray(text), train=False, is_train=is_train)
        with torch.no_grad():
            got = net(torch.from_numpy(x), torch.from_numpy(text), train=False,
                      is_train=is_train)
        assert got["logits"].shape == (BATCH, BML + 1, n)
        for k in ("logits", "aux_logits"):
            # each framework samples its own grid (GRID_TOL apart)
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-3,
                                       rtol=1e-3, err_msg=f"{k} is_train={is_train}")

    character = ALPHABETS[0] + ALPHABETS[1]
    jl = _jax_learner(JaxDER, jopt, character)
    jl.n_experts, jl.model, jl.params, jl.batch_stats = 2, jm, params, stats
    tl = _port_learner(DER, topt, character)
    tl.n_experts = 2
    tl._set_model(params, stats)
    loader = _loader(1)
    idx, words = loader.get_batch()
    images = _float_images(loader, idx)
    batch = jl._encode_batch(images, words)
    loss, (_, jmetrics) = jax.jit(jl.loss_fn, static_argnums=(4,))(
        params, stats, batch, jax.random.PRNGKey(0), None)
    got, metrics = tl.loss_fn(dict(tl.model.named_parameters()),
                              tl._encode_batch(images, words), tl.train_aux())
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=STEP_LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["aux"]), float(jmetrics["aux"]),
                               rtol=STEP_LOSS_RTOL)


def test_der_change_model_grows_the_generator_and_draws_fresh_decoders(tmp_path):
    _, topt = _options(tmp_path, il="der")
    tl = _port_learner(DER, topt, ALPHABETS[0])
    tl.build_model()
    old_p, _ = to_flax(tl.model)
    tl.character = ALPHABETS[0] + ALPHABETS[1]
    tl.converter = tl.build_converter()
    tl.change_model()
    new_p, _ = to_flax(tl.model)
    old_n = old_p["fc"]["kernel"].shape[1]
    assert new_p["fc"]["kernel"].shape == (HID, tl._total_classes)
    np.testing.assert_array_equal(new_p["fc"]["kernel"][:, :old_n], old_p["fc"]["kernel"])
    assert new_p["prediction"]["attention_cell"]["i2h"]["kernel"].shape == (2 * HID, HID)
    np.testing.assert_array_equal(new_p["extractors"]["seq0"]["linear"]["kernel"][1],
                                  old_p["extractors"]["seq0"]["linear"]["kernel"][0])
    assert not np.array_equal(new_p["aux_prediction"]["char_embeddings"][:old_n],
                              old_p["aux_prediction"]["char_embeddings"])


# ------------------------------------------------------------ base and MRN learners
def test_change_model_carries_the_extractor_and_draws_a_fresh_decoder(tmp_path):
    _, topt = _options(tmp_path, il="base")
    tl = _port_learner(BaseLearner, topt, ALPHABETS[0])
    tl.build_model()
    old_p, old_s = to_flax(tl.model)
    tl.character = ALPHABETS[0] + ALPHABETS[1]
    tl.converter = tl.build_converter()
    tl.change_model()
    new_p, new_s = to_flax(tl.model)
    _assert_trees(new_p["extractor"], old_p["extractor"], 0.0, 0.0, "extractor")
    _assert_trees(new_s, old_s, 0.0, 0.0, "stats")
    old_n = old_p["fc"]["kernel"].shape[1]
    np.testing.assert_array_equal(new_p["fc"]["kernel"][:, :old_n], old_p["fc"]["kernel"])
    assert new_p["prediction"]["char_embeddings"].shape[0] == tl._total_classes
    assert not np.array_equal(new_p["prediction"]["attention_cell"]["w_hh"],
                              old_p["prediction"]["attention_cell"]["w_hh"])


def test_routed_model_decodes_batch_max_length_plus_one_steps(tmp_path, rng):
    """``_routed_model`` builds its MRNNet with the options' ``batch_max_length``
    (6 here, the class default 25): greedy and teacher-forced logits have 7
    steps and line up with ``label[:, 1:]``."""
    _, topt = _options(tmp_path)
    tl = _port_learner(MRN, topt, ALPHABETS[0] + ALPHABETS[1])
    wrng = np.random.default_rng(0)
    counts = (15, tl._total_classes)
    for count in counts:
        tl.add_expert(*random_recognizer(wrng, topt, count), count)
    model = tl._routed_model(random_router(wrng, topt, 2))
    x = torch.from_numpy(rng.standard_normal((BATCH, *IMG)).astype(np.float32))
    with torch.no_grad():
        greedy = model(x, tl._sos_column(x), is_train=False)["logits"]
        label = tl._encode_batch(np.zeros((BATCH, *IMG), np.float32), ["ab"] * BATCH)["label"]
        forced = model(x, label[:, :-1], is_train=True)["logits"]
    assert greedy.shape == forced.shape == (BATCH, BML + 1, tl._total_classes)
    assert forced.shape[1] == label[:, 1:].shape[1]


# ------------------------------------------------------------ every strategy, end to end
SOURCE = SyntheticSource(ALPHABETS, LANS[:2], n_train=[12, 10], n_test=[4, 4], img_h=IMG[0],
                         img_w=IMG[1], seed=3, device_bank=True, renderer="bits", max_len=5)


@pytest.mark.parametrize("il", ["mrn", "base", "lwf", "wa", "ewc", "der", "joint_mix",
                                "joint_loader"])
def test_trba_campaign_runs_every_strategy(tmp_path, il):
    """``configs/trba_mrn.py``'s stages through ``campaign`` (``--arch
    trba``) at a narrow width, 2 tasks of 2 steps: finite scores, the
    record's arch and the files named after it."""
    opt = campaign_options(tasks=2, num_iter=2, batch_size=BATCH, seed=3, out=str(tmp_path),
                           il=il, arch="trba", output_channel=OC, hidden_size=HID,
                           imgW=IMG[1], batch_max_length=BML, val_interval=1, memory_num=4,
                           fisher_num_iter=1)
    assert (opt.Transformation, opt.FeatureExtraction, opt.SequenceModeling,
            opt.Prediction) == ("TPS", "ResNet", "BiLSTM", "Attn")
    opt.image_bank = SOURCE.device_bank("cpu")
    run = run_joint if il.startswith("joint") else run_incremental
    _, aia, matrix, _ = run(opt, SOURCE, device="cpu")
    assert all(np.isfinite(a) for a in aia) and all(np.isfinite(x) for r in matrix for x in r)
    assert len(matrix[-1]) == 2
    assert os.path.exists(os.path.join(str(tmp_path), "saved", f"acc_trba_{il}",
                                       "log_train.txt"))
    assert os.path.exists(os.path.join(str(tmp_path), f"data_trba_{il}.txt"))


def test_campaign_main_writes_the_trba_record(tmp_path, monkeypatch):
    from mrn_tpu_torch import campaign
    monkeypatch.setattr(campaign, "build_source", lambda *a, **k: SOURCE)
    monkeypatch.setattr(campaign, "campaign_options",
                        lambda *a, **k: campaign_options(
                            *a, **dict(k, output_channel=OC, hidden_size=HID, imgW=IMG[1],
                                       batch_max_length=BML, memory_num=4)))
    record = campaign.main(["--arch", "trba", "--smoke", "--tasks", "2", "--num_iter", "2",
                            "--batch_size", str(BATCH), "--device", "cpu",
                            "--out", str(tmp_path)])
    with open(os.path.join(str(tmp_path), "trba_mrn.json"), encoding="utf-8") as f:
        assert json.load(f) == record
    assert record["arch"] == "trba" and np.isfinite(record["final_aia"])


def test_train_cli_trains_the_trba_config(tmp_path):
    """``configs/trba_mrn.py``'s stages through ``train_cli`` on an LMDB
    tree, narrow, MRN over 2 tasks: both best files, the routed one, and the
    AIA line, with no flag of its own."""
    from mrn_tpu_torch import train_cli
    from mrn_tpu_torch.tools import create_lmdb

    index = {ch: i for i, ch in enumerate("".join(ALPHABETS))}
    for split, n, seed in (("train", 12, 0), ("test", 4, 50)):
        for t, lan in enumerate(LANS[:2]):
            create_lmdb.create_synthetic_dataset(str(tmp_path / split / lan), ALPHABETS[t], n,
                                                 seed + t, heights=(20, 40), widths=(40, 160),
                                                 max_len=5, char_to_idx=index)
    base = load_config("configs/trba_mrn.py")
    model = {k: base.get(k) for k in ("model_name", "Transformation", "FeatureExtraction",
                                  "SequenceModeling", "Prediction", "num_fiducial",
                                  "input_channel")}
    model.update(output_channel=OC, hidden_size=HID)
    common = dict(exp_name="trba_cli", il="mrn", memory="random", memory_num=4,
                  batch_max_length=BML, imgH=IMG[0], imgW=IMG[1], manual_seed=111,
                  output_dir=str(tmp_path / "saved"), data_log=str(tmp_path / "data_any.txt"))
    train = dict(lan_list=LANS[:2], select_data=[str(tmp_path / "train")],
                 valid_datas=[str(tmp_path / "test")], batch_size=BATCH, NED=True, workers=0,
                 num_iter=2, val_interval=2)
    cfg = tmp_path / "trba.py"
    cfg.write_text(f"common = {common!r}\nmodel = {model!r}\ntrain = {train!r}\n",
                   encoding="utf-8")
    run = train_cli.main(["--config", str(cfg), "--device", "cpu"])
    exp = tmp_path / "saved" / "trba_cli"
    assert {"Chinese_0_0_best_score.msgpack", "Latin_1_1_best_score.msgpack"} <= {
        p.name for p in exp.iterdir()}
    assert len(run.best_scores) == 2 and all(np.isfinite(run.best_scores))
    assert run.learner.opt.Prediction == "Attn" and len(run.learner.expert_states) == 2
