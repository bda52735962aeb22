"""The port's incremental-learning strategies against the JAX package's,
float32 on the CPU, from the same bridged weights on the same batches:
``kd_loss``, the surgery rules (``grow_fc``, ``grow_fc_der``,
``weight_align``, ``reset_fc``, ``count_params``), one ``loss_fn`` each of
LwF, WA, EWC (a given Fisher and mean over a grown fc) and DER (2
extractors, the frozen one in eval mode), EWC's Fisher diagonal,
``DERNet.heads`` and the stacked DER bridge both ways.

Both sides build a narrow SVTR (embed 16/32/64, depth 1/2/1, img 32x128,
drop-path 0); the JAX side runs its composed XLA path with the exact-erf
GELU, its loss functions called eagerly (only EWC's Fisher is jitted, by
the JAX learner itself).  The port's eval-mode Blocks (LwF's and WA's old
network, DER's frozen extractor) run the inference Block's plain version
with its degree-15 erf fit, so the degree-9 serving fit (1e-4 on logits,
``tests/test_torch_svtr_block.py``) does not hide the strategies'
arithmetic: losses agree to 1e-5 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mrn_tpu.models.composer as jax_composer
import mrn_tpu.models.svtr as jax_svtr
from mrn_tpu.config import load_config as jax_load_config
from mrn_tpu.models.composer import build_recognizer as jax_build_recognizer
from mrn_tpu.models.der import DERNet as JaxDERNet
from mrn_tpu.models.surgery import count_params as jax_count_params
from mrn_tpu.models.surgery import grow_fc as jax_grow_fc
from mrn_tpu.models.surgery import grow_fc_der as jax_grow_fc_der
from mrn_tpu.models.surgery import weight_align as jax_weight_align
from mrn_tpu.ops.losses import kd_loss as jax_kd_loss
from mrn_tpu.train.learners.der import DER as JaxDER
from mrn_tpu.train.learners.ewc import EWC as JaxEWC
from mrn_tpu.train.learners.lwf import LwF as JaxLwF
from mrn_tpu.train.learners.wa import WA as JaxWA
from mrn_tpu_torch.bridge import flax_tree, from_flax, to_flax
from mrn_tpu_torch.config import load_config
from mrn_tpu_torch.models.der import DERNet
from mrn_tpu_torch.models.init import random_der
from mrn_tpu_torch.models.surgery import (count_params, grow_fc, grow_fc_der, reset_fc,
                                          weight_align)
from mrn_tpu_torch.models.svtr import configure_blocks
from mrn_tpu_torch.ops.losses import kd_loss
from mrn_tpu_torch.train.learners.der import DER
from mrn_tpu_torch.train.learners.ewc import EWC
from mrn_tpu_torch.train.learners.lwf import LwF
from mrn_tpu_torch.train.learners.wa import WA

SVTR = dict(embed_dim=(16, 32, 64), depth=(1, 2, 1), num_heads=(2, 2, 4),
            drop_path_rate=0.0)
IMG_W, BATCH = 128, 4
CHARS = ["abcdefghij", "abcdefghijklmnop"]   # tasks 0 and 1, cumulative
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch's CPU ops on one thread here: beside the other test workers,
    more threads oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def narrow_jax(tmp_path_factory):
    """The JAX package with the narrow SVTR, XLA attention, exact erf."""

    class NarrowSVTR(jax_svtr.SVTRExtractor):
        embed_dim: tuple = SVTR["embed_dim"]
        depth: tuple = SVTR["depth"]
        num_heads: tuple = SVTR["num_heads"]
        drop_path_rate: float = SVTR["drop_path_rate"]

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_composer, "SVTRExtractor", NarrowSVTR)
    jax_svtr.set_attention_impl("xla")
    jax_svtr.set_train_gelu("erf")
    yield tmp_path_factory.mktemp("jax_strategies")
    jax_svtr.set_train_gelu("auto")
    jax_svtr.set_attention_impl("auto")
    mp.undo()


def _options(tmp, il, **kw):
    common = dict(il=il, imgW=IMG_W, output_channel=32, hidden_size=16, batch_size=BATCH,
                  num_iter=4, manual_seed=3, output_dir=str(tmp),
                  data_log=str(tmp / "data_any.txt"), **kw)
    return (jax_load_config("configs/svtr_mrn.py", **common),
            load_config("configs/svtr_mrn.py", svtr=SVTR, **common))


def _perturb_stats(model, seed):
    """BatchNorm statistics away from 0 / 1, so eval mode reads them."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith(".mean"):
                buf.copy_(torch.as_tensor(rng.normal(0, 0.3, buf.shape), dtype=torch.float32))
            elif name.endswith(".var"):
                buf.copy_(torch.as_tensor(rng.uniform(0.5, 2.0, buf.shape),
                                          dtype=torch.float32))


def _batch(seed, n_chars):
    rng = np.random.default_rng(seed)
    images = rng.uniform(-1, 1, (BATCH, 32, IMG_W, 4)).astype(np.float32)
    alphabet = CHARS[1][:n_chars]
    labels = ["".join(rng.choice(list(alphabet), rng.integers(1, 6))) for _ in range(BATCH)]
    return images, labels


def _port_task1(cls, topt, seed=0):
    """A port learner at task 1: task 0's network built, kept as the old
    network (statistics perturbed), then grown for task 1."""
    tl = cls(topt, device="cpu")
    tl._cur_task, tl.character = 0, list(CHARS[0])
    tl.converter = tl.build_converter()
    tl.build_model()
    _perturb_stats(tl.model, seed)
    tl.after_task()
    tl._cur_task, tl.character = 1, list(CHARS[1])
    tl.converter = tl.build_converter()
    tl.change_model()
    _perturb_stats(tl.model, seed + 1)
    configure_blocks(tl.model, gelu_degree=15)
    if tl._old_model is not None:
        configure_blocks(tl._old_model, gelu_degree=15)
    return tl


def _jax_learner(cls, jopt, tl):
    jl = cls(jopt)
    jl._cur_task, jl.character = 1, list(CHARS[1])
    jl.converter = jl.build_converter()
    jl._known_classes = tl._known_classes
    jl.params, jl.batch_stats = to_flax(tl.model)
    return jl


def _losses(tl, jl, images, labels, aux_port=None):
    jbatch = jl._encode_batch(images, labels)
    jloss, (_, jmetrics) = jl.loss_fn(jl.params, jl.batch_stats, jbatch,
                                      jax.random.PRNGKey(0), jl.train_aux())
    tbatch = tl._encode_batch(images, labels)
    params = tl.trainable_params()
    aux = tl.train_aux() if aux_port is None else aux_port
    tloss, tmetrics = tl.loss_fn(params, tbatch, aux)
    return (float(tloss.detach()), {k: float(v) for k, v in tmetrics.items()},
            float(jloss), {k: float(v) for k, v in jmetrics.items()})


# ------------------------------------------------------------ functions
def test_kd_loss_matches_jax(rng):
    pred = rng.standard_normal((12, 7)).astype(np.float32)
    soft = rng.standard_normal((12, 7)).astype(np.float32)
    ref, ref_grad = jax.value_and_grad(jax_kd_loss)(jnp.asarray(pred), jnp.asarray(soft), 2.0)
    x = torch.from_numpy(pred).requires_grad_()
    got = kd_loss(x, torch.from_numpy(soft), 2.0)
    (grad,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), atol=1e-7, rtol=1e-5)


def _fc(rng, n_in, n_out):
    return {"kernel": rng.standard_normal((n_in, n_out)).astype(np.float32),
            "bias": rng.standard_normal(n_out).astype(np.float32)}


def test_grow_fc_and_grow_fc_der_match_jax(rng):
    old = {"fc": _fc(rng, 8, 5), "other": {"w": np.ones(3, np.float32)}}
    new = {"fc": _fc(rng, 8, 9), "other": {"w": np.zeros(3, np.float32)}}
    got, ref = grow_fc(new, old), jax_grow_fc(new, old)
    for k in ("kernel", "bias"):
        np.testing.assert_array_equal(got["fc"][k], np.asarray(ref["fc"][k]))
    np.testing.assert_array_equal(got["fc"]["kernel"][:, :5], old["fc"]["kernel"])
    np.testing.assert_array_equal(got["fc"]["kernel"][:, 5:], new["fc"]["kernel"][:, 5:])
    assert got["other"] is new["other"]
    new = {"fc": _fc(rng, 16, 9)}
    got, ref = grow_fc_der(new, old, out_dim=8), jax_grow_fc_der(new, old, out_dim=8)
    for k in ("kernel", "bias"):
        np.testing.assert_array_equal(got["fc"][k], np.asarray(ref["fc"][k]))
    np.testing.assert_array_equal(got["fc"]["kernel"][:8, :5], old["fc"]["kernel"])
    np.testing.assert_array_equal(got["fc"]["kernel"][8:], new["fc"]["kernel"][8:])


@pytest.mark.parametrize("increment", [3, 1])
def test_weight_align_matches_jax(rng, increment):
    params = {"fc": _fc(rng, 6, 7)}
    params["fc"]["kernel"][:, -increment:] *= 3.0
    got, gamma = weight_align(params, increment)
    ref, ref_gamma = jax_weight_align(params, increment)
    np.testing.assert_allclose(gamma, ref_gamma, rtol=1e-6)
    np.testing.assert_allclose(got["fc"]["kernel"], np.asarray(ref["fc"]["kernel"]), rtol=1e-6)
    np.testing.assert_array_equal(got["fc"]["bias"], params["fc"]["bias"])
    norms = np.linalg.norm(got["fc"]["kernel"], axis=0)
    np.testing.assert_allclose(norms[-increment:].mean(), norms[:-increment].mean(), rtol=1e-5)


def test_reset_fc_shapes_and_laws():
    rng = np.random.default_rng(0)
    h = 16
    params = {"fc": _fc(rng, 64, 300),
              "prediction": {"char_embeddings": np.zeros((300, 32), np.float32),
                             "attention_cell": {"w_ih": np.zeros((4 * h, 48), np.float32),
                                                "b_hh": np.zeros(4 * h, np.float32),
                                                "h2h": _fc(rng, h, h),
                                                "score": {"kernel": np.zeros((h, 1),
                                                                             np.float32)}},
                             "keep": np.full(3, 7.0, np.float32)},
              "extractor": {"w": np.ones(2, np.float32)}}
    fc_only = reset_fc(params, np.random.default_rng(1))
    assert fc_only["prediction"] is params["prediction"]
    out = reset_fc(params, np.random.default_rng(1), prediction_path=("prediction",))
    np.testing.assert_array_equal(out["fc"]["kernel"], fc_only["fc"]["kernel"])
    for a, b in ((out, params), (fc_only, params)):
        assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
        for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
            assert np.shape(x) == np.shape(y) and np.asarray(x).dtype == np.float32
    bound = 1 / np.sqrt(64)
    for leaf in (out["fc"]["kernel"], out["fc"]["bias"]):
        assert np.abs(leaf).max() <= bound and np.abs(leaf).max() > 0.9 * bound
    cell, hb = out["prediction"]["attention_cell"], 1 / np.sqrt(h)
    for leaf in (cell["w_ih"], cell["b_hh"], cell["h2h"]["kernel"], cell["score"]["kernel"]):
        assert 0.8 * hb < np.abs(leaf).max() <= hb
    emb = out["prediction"]["char_embeddings"]
    assert abs(emb.mean()) < 0.05 and abs(emb.std() - 1.0) < 0.05
    np.testing.assert_array_equal(out["prediction"]["keep"], params["prediction"]["keep"])
    assert out["extractor"] is params["extractor"]
    assert count_params(params) == jax_count_params(params) == 64 * 300 + 300 + 300 * 32 \
        + 4 * h * 48 + 4 * h + h * h + h + h + 3 + 2


# ------------------------------------------------------------ losses
@pytest.mark.parametrize("name", ["lwf", "wa"])
def test_lwf_and_wa_loss_match_jax(narrow_jax, name):
    port_cls, jax_cls = {"lwf": (LwF, JaxLwF), "wa": (WA, JaxWA)}[name]
    jopt, topt = _options(narrow_jax, name)
    tl = _port_task1(port_cls, topt)
    jl = _jax_learner(jax_cls, jopt, tl)
    jl._old_params, jl._old_batch_stats = to_flax(tl._old_model)
    jl._old_model_def = jax_build_recognizer(jopt, tl._known_classes)
    jl.model = jax_build_recognizer(jopt, tl._total_classes)
    images, labels = _batch(1, 16)
    got, got_m, ref, ref_m = _losses(tl, jl, images, labels)
    assert 0 < tl._known_classes < tl._total_classes and got_m["kd"] > 0
    np.testing.assert_allclose(got_m["kd"], ref_m["kd"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    assert abs(got - got_m["kd"] * port_cls.kd_weight) > 0   # CLF added
    assert port_cls.kd_weight == jax_cls.kd_weight


def test_ewc_loss_matches_jax(narrow_jax):
    jopt, topt = _options(narrow_jax, "ewc")
    tl = _port_task1(EWC, topt)
    rng = np.random.default_rng(7)
    mean, fisher = {}, {}
    known = tl._known_classes
    for k, p in tl.model.named_parameters():
        shape = {"fc.kernel": (p.shape[0], known), "fc.bias": (known,)}.get(k, p.shape)
        mean[k] = torch.as_tensor(rng.normal(0, 0.1, shape), dtype=torch.float32)
        fisher[k] = torch.as_tensor(rng.uniform(0, 1e-4, shape), dtype=torch.float32)
    assert tl.model.fc.kernel.shape[1] > mean["fc.kernel"].shape[1]   # a grown fc
    tl.fisher, tl.mean = fisher, mean
    jl = _jax_learner(JaxEWC, jopt, tl)
    jl.model = jax_build_recognizer(jopt, tl._total_classes)
    jl.fisher, jl.mean = flax_tree(fisher.items()), flax_tree(mean.items())
    images, labels = _batch(2, 16)
    got, got_m, ref, ref_m = _losses(tl, jl, images, labels)
    assert got_m["ewc"] > 0
    np.testing.assert_allclose(got_m["ewc"], ref_m["ewc"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)


class _Batches:
    """``get_batch`` over fixed batches, in order."""

    def __init__(self, batches):
        self.batches, self.i = batches, 0

    def get_batch(self):
        self.i += 1
        return self.batches[self.i - 1]


def test_ewc_fisher_matches_jax(narrow_jax):
    jopt, topt = _options(narrow_jax, "ewc", fisher_num_iter=2)
    tl = EWC(topt, device="cpu")
    tl._cur_task, tl.character = 0, list(CHARS[0])
    tl.converter = tl.build_converter()
    tl.build_model()
    _perturb_stats(tl.model, 3)
    with torch.no_grad():   # a small fc: gradients under the clamp
        tl.model.fc.kernel.mul_(0.05)
    jl = JaxEWC(jopt)
    jl._cur_task, jl.character = 0, list(CHARS[0])
    jl.converter = jl.build_converter()
    jl.model = jax_build_recognizer(jopt, tl._total_classes)
    jl.params, jl.batch_stats = to_flax(tl.model)
    batches = [_batch(10 + i, 10) for i in range(2)]
    stats = {k: v.clone() for k, v in tl.model.named_buffers()}
    got = tl.get_fisher_diagonal(_Batches(batches))
    ref = jl.get_fisher_diagonal(_Batches(batches))
    for k, v in tl.model.named_buffers():   # statistics left as they were
        torch.testing.assert_close(v, stats[k], rtol=0, atol=0)
    ref = from_flax(jax.tree_util.tree_map(np.asarray, ref))
    assert got.keys() == ref.keys()
    clamped = under = 0
    for k in ref:
        g = got[k].numpy()
        assert g.max() <= 1e-4
        np.testing.assert_allclose(g, ref[k].numpy(), atol=1e-10, rtol=1e-3, err_msg=k)
        clamped += int((g == 1e-4).sum())
        under += int(((g > 0) & (g < 1e-4)).sum())
    assert clamped > 0 and under > 0
    # the blend over a grown fc: alpha 0.5 over the shared prefix
    first = dict(got)
    tl.fisher = {k: v.clone() for k, v in first.items()}
    new = {k: torch.full_like(v, 2e-5) for k, v in first.items()}
    new["fc.kernel"] = torch.full((first["fc.kernel"].shape[0], 20), 2e-5)
    tl.get_fisher_diagonal = lambda loader: {k: v.clone() for k, v in new.items()}
    tl._update_fisher(None)
    n = first["fc.kernel"].shape[1]
    torch.testing.assert_close(tl.fisher["fc.kernel"][:, :n],
                               0.5 * first["fc.kernel"] + 0.5 * 2e-5)
    assert torch.all(tl.fisher["fc.kernel"][:, n:] == 2e-5)


def test_der_loss_matches_jax(narrow_jax):
    jopt, topt = _options(narrow_jax, "der")
    tl = _port_task1(DER, topt)
    assert tl.n_experts == 2 and tl._old_model is None
    assert not any(k.startswith("extractors.0.") for k in tl.trainable_params())
    jl = _jax_learner(JaxDER, jopt, tl)
    jl.n_experts = 2
    jl.model = jl._build_dernet(2)
    images, labels = _batch(3, 16)
    stats0 = {k: v.clone() for k, v in tl.model.named_buffers()}
    got, got_m, ref, ref_m = _losses(tl, jl, images, labels)
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got_m["aux"], ref_m["aux"], rtol=LOSS_RTOL)
    assert got == got_m["clf"]
    # the frozen extractor's statistics stay; the newest's moved
    moved = {k for k, v in tl.model.named_buffers() if not torch.equal(v, stats0[k])}
    assert moved and all(k.startswith("extractors.1.") for k in moved)


def test_dernet_heads_and_stacked_bridge(narrow_jax, rng):
    """Random DER trees (``random_der``, 3 extractors) load into the port's
    DERNet and come back bitwise, in the layout of the JAX DERNet's own
    init (its shapes, by ``jax.eval_shape``); the heads agree on the same
    features."""
    _, topt = _options(narrow_jax, "der")
    params, stats = random_der(np.random.default_rng(5), topt, 3, 11)
    jmodel = JaxDERNet(n_experts=3, num_classes=11, feature_extraction="SVTR",
                       sequence_modeling="None", output_channel=32, hidden_size=16,
                       img_size=(32, IMG_W))
    shapes = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.PRNGKey(1), "droppath": jax.random.PRNGKey(2)},
                            jnp.zeros((2, 32, IMG_W, 4), jnp.float32), train=False))
    port = DERNet(3, 11, svtr=SVTR, output_channel=32, hidden_size=16, img_size=(32, IMG_W))
    port.load_state_dict(from_flax(params, stats), strict=True)
    got_params, got_stats = to_flax(port)
    for got, ref, layout in ((got_params, params, shapes["params"]),
                             (got_stats, stats, shapes["batch_stats"])):
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(ref) \
            == jax.tree_util.tree_structure(layout)
        for x, y, z in zip(*(jax.tree_util.tree_leaves(t) for t in (got, ref, layout))):
            np.testing.assert_array_equal(x, y)
            assert x.shape == z.shape and x.dtype == z.dtype
    assert got_params["extractors"]["seq_linear"]["kernel"].shape == (3, 32, 16)
    assert [k for k, _ in port.named_parameters()][0].startswith("extractors.0.")
    feats = rng.standard_normal((3, 2, IMG_W // 4, 16)).astype(np.float32)
    ref = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(feats),
                       method="heads")
    got = port.heads(torch.from_numpy(feats))
    for k in ("logits", "aux_logits", "features"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(ref[k]), atol=1e-6,
                                   rtol=1e-5, err_msg=k)
