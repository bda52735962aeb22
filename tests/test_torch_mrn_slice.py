"""The port's SVTR-MRN serving slice against the JAX eval path: a JAX
``MRNNet`` with 3 SVTR experts at the real embed dims (imgW 128, so stage-1
banding engages), unequal class counts, bridged into ``serve.Server`` on the
CPU and run on the same seeded batch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import mrn_tpu.models.svtr as jax_svtr
from mrn_tpu.codec import CTCLabelConverter as JaxConverter
from mrn_tpu.models.mrn import MRNNet as JaxMRNNet
from mrn_tpu_torch.config import load_config
from mrn_tpu_torch.models.svtr import configure_blocks
from mrn_tpu_torch.ops import svtr_block
from mrn_tpu_torch.serve import Server

CHARS = list("abcdefghijklmnopqrstuv")
COUNTS = (14, 20, len(CHARS) + 4)
IMG = (32, 128, 4)
# logits: float32 noise through 12 Blocks (degree-15 erf fit and clamp-exp
# softmax on the port side vs exact erf and max-subtract in JAX); the
# confidence is a product of 32 max-softmax values, so its relative error is
# up to ~32x a per-step relative error.
LOGIT_TOL = 1e-4
CONF_RTOL = 1e-4


def _opt(**kw):
    return load_config("configs/svtr_mrn.py", imgW=IMG[1], output_channel=32,
                       hidden_size=16, **kw)


@pytest.fixture(scope="module")
def jax_slice():
    """JAX MRNNet, its (perturbed) variables, a batch and the eval outputs."""
    jax_svtr.set_attention_impl("xla")
    rng = np.random.default_rng(5)
    num_classes = COUNTS[-1]
    model = JaxMRNNet(n_experts=len(COUNTS), num_classes=num_classes,
                      class_counts=COUNTS, feature_extraction="SVTR",
                      sequence_modeling="None", output_channel=32,
                      hidden_size=16, img_size=IMG[:2])
    images = rng.integers(0, 256, (6, *IMG), dtype=np.uint8)
    x = (images.astype(np.float32) / 255.0 - 0.5) / 0.5
    v = jax.jit(lambda k: model.init({"params": k, "droppath": k},
                                     jnp.asarray(x), train=False))(
        jax.random.PRNGKey(3))
    v = jax.tree_util.tree_map(np.asarray, v)
    # spread the route scores and logits so that samples pick different
    # experts and words differ (init weights route everything one way)
    for key in ("channel_route", "route"):
        v["params"][key]["kernel"] = rng.standard_normal(
            v["params"][key]["kernel"].shape).astype(np.float32)
    fc = v["params"]["experts"]["fc"]
    fc["kernel"] = 3 * rng.standard_normal(fc["kernel"].shape).astype(np.float32)
    out = jax.jit(lambda v, x: model.apply(v, x, cross=True, train=False,
                                           is_train=False))(v, jnp.asarray(x))
    logits = out["logits"]
    probs = jax.nn.softmax(logits, axis=2)   # make_eval_batch
    preds = np.asarray(jnp.argmax(logits, 2).astype(jnp.int32))
    max_probs = np.asarray(jnp.max(probs, 2))
    conv = JaxConverter(CHARS)               # recognize_cli.recognize
    words = conv.decode(preds, np.full((preds.shape[0],), preds.shape[1]))
    confs = [float(np.prod(p)) for p in max_probs]
    jax_svtr.set_attention_impl("auto")
    return dict(variables=v, images=images, logits=np.asarray(logits),
                index=np.asarray(out["index"]), preds=preds, words=words,
                confs=confs)


def _server(jax_slice, **kw):
    v = jax_slice["variables"]
    srv = Server(_opt(**kw), v["params"], v["batch_stats"], CHARS,
                 class_counts=COUNTS, device="cpu")
    configure_blocks(srv.model, gelu_degree=15)
    return srv


def test_mrn_slice_matches_jax_eval(jax_slice):
    assert svtr_block._band_spec(8, 32, 7, 11) is not None  # stage 1 bands
    assert len(set(jax_slice["index"].tolist())) > 1        # routing varies
    srv = _server(jax_slice)
    out = srv.forward(jax_slice["images"])
    np.testing.assert_array_equal(out["index"].numpy(), jax_slice["index"])
    np.testing.assert_allclose(out["logits"].numpy(), jax_slice["logits"],
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    res = srv.eval_batch(jax_slice["images"])
    np.testing.assert_array_equal(res["preds_index"], jax_slice["preds"])
    rec = srv.recognize(jax_slice["images"])
    assert [w for w, _ in rec] == jax_slice["words"]
    np.testing.assert_allclose([c for _, c in rec], jax_slice["confs"],
                               rtol=CONF_RTOL, atol=0)


def test_ones_padding_of_old_experts(jax_slice):
    """Columns past an old expert's class count are exactly 1.0 wherever
    that expert was picked."""
    srv = _server(jax_slice)
    out = srv.forward(jax_slice["images"])
    for b, i in enumerate(out["index"].tolist()):
        pad = out["logits"][b, :, COUNTS[i]:]
        assert bool((pad == 1.0).all())


def test_float_and_uint8_images_agree(jax_slice):
    srv = _server(jax_slice)
    u8 = jax_slice["images"]
    f32 = (u8.astype(np.float32) / 255.0 - 0.5) / 0.5
    torch.testing.assert_close(srv.forward(u8)["logits"],
                               srv.forward(f32)["logits"], atol=0, rtol=0)


def test_bf16_server_runs_on_cpu(jax_slice):
    """compute_dtype=bfloat16 casts weights and images; the result stays
    finite and near the float32 logits (bf16 keeps ~3 significant digits
    through 12 Blocks: a loose sanity bound, not parity)."""
    srv = _server(jax_slice, compute_dtype="bfloat16")
    out = srv.forward(jax_slice["images"])
    assert out["logits"].dtype == torch.bfloat16
    logits = out["logits"].float()
    assert bool(torch.isfinite(logits).all())
    same = out["index"].numpy() == jax_slice["index"]
    assert same.mean() >= 0.5
    np.testing.assert_allclose(logits.numpy()[same], jax_slice["logits"][same],
                               atol=0.5, rtol=0.1)


def test_wrong_image_shape_raises(jax_slice):
    srv = _server(jax_slice)
    with pytest.raises(ValueError):
        srv.forward(np.zeros((2, 32, 64, 4), np.uint8))


def test_chip_smoke_random_tree_matches_jax_layout(jax_slice):
    """The numpy weights chip_smoke serves have the JAX MRNNet's tree layout
    (same paths and shapes), so the card runs what a real checkpoint holds."""
    rng = np.random.default_rng(0)
    params, stats = chip_smoke.random_mrn(rng, _opt(), COUNTS)
    shapes = lambda t: jax.tree_util.tree_map(np.shape, t)  # noqa: E731
    ref = jax_slice["variables"]
    assert shapes(params) == shapes(ref["params"])
    assert shapes(stats) == shapes(ref["batch_stats"])
