"""The port's TRBA (TPS/ResNet/BiLSTM/Attn) eval path against the JAX
package's on the CPU, narrow (output_channel 32, hidden 16, 32x64 crops,
the localization net at its fixed widths): ResNet, BiLSTM and the greedy
Attn decoder module by module, one Recognizer, the bridge both ways, and a
3-expert TRBA MRNNet with unequal class counts served through
``serve.Server``.  The JAX TPS warp runs the Pallas kernel in interpret mode
(patched in by the tests; the JAX package's CPU dispatch would gather)."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import chip_smoke
import mrn_tpu.models.tps as jax_tps
from mrn_tpu.codec import AttnLabelConverter as JaxAttnConverter
from mrn_tpu.models.attention import AttentionDecoder as JaxDecoder
from mrn_tpu.models.common import TorchDense as JaxDense
from mrn_tpu.models.composer import Recognizer as JaxRecognizer
from mrn_tpu.models.lstm import BidirectionalLSTM as JaxBiLSTM
from mrn_tpu.models.mrn import MRNNet as JaxMRNNet
from mrn_tpu.models.mrn import pad_expert_tree
from mrn_tpu.models.resnet import ResNetExtractor as JaxResNet
from mrn_tpu.ops.grid_sample import grid_sample_pallas
from mrn_tpu_torch.bridge import from_flax, pad_expert_state, recognizer_state, to_flax
from mrn_tpu_torch.codec import AttnLabelConverter
from mrn_tpu_torch.config import load_config
from mrn_tpu_torch.models.attention import AttentionDecoder
from mrn_tpu_torch.models.common import Dense
from mrn_tpu_torch.models.composer import Recognizer
from mrn_tpu_torch.models.lstm import BidirectionalLSTM
from mrn_tpu_torch.models.resnet import ResNetExtractor
from mrn_tpu_torch.serve import Server

CHARS = list("abcdefghijklmnopqrstuv")
COUNTS = (14, 20, len(CHARS) + 5)
IMG = (32, 64, 4)
OC, HID = 32, 16
SOS = 2  # [UNK] [PAD] [SOS] [EOS] ' '
# module by module, float32: summation order only
RESNET_TOL = 1e-5
LSTM_TOL = 1e-5
DECODER_TOL = 1e-5
# end to end: the TPS grid comes from two float32 products that cancel
# terms far larger than the result, so the two frameworks' grids differ by
# up to ~1.2e-4 (tests/test_torch_tps.py), moving taps by ~4e-3 px at W = 64
# and the warped noise image by up to ~1e-2; the ResNet, the BiLSTMs and
# the decoder carry that to the logits (measured: 2.3e-4 at most)
E2E_TOL = 1e-3
# a confidence is a product of up to 26 max-softmax values, each within
# ~E2E_TOL relative
CONF_RTOL = 3e-2


def _opt(**kw):
    return load_config("configs/trba_mrn.py", imgW=IMG[1], output_channel=OC,
                       hidden_size=HID, **kw)


def _pallas_warp(image, grid, inference=False):
    assert inference
    return grid_sample_pallas(image, grid.astype(jnp.float32), row_block=4, batch_block=4,
                              interpret=True)


def _perturb(variables, rng, scale=0.05):
    def f(path, leaf):
        leaf = np.asarray(leaf)
        noise = scale * rng.standard_normal(leaf.shape).astype(np.float32)
        if path[-1].key == "var":
            return np.abs(leaf + noise) + 0.5
        return leaf + noise
    return jax.tree_util.tree_map_with_path(f, variables)


def _load(module, variables):
    module.load_state_dict(from_flax(variables["params"], variables.get("batch_stats")),
                           strict=True)
    return module.eval()


def _images(rng, b):
    return rng.integers(0, 256, (b, *IMG), dtype=np.uint8)


def _normed(images):
    return (images.astype(np.float32) / 255.0 - 0.5) / 0.5


def _calibrate(v, images, counts=None):
    """``chip_smoke.calibrate_random_trba`` on this batch through the port
    (BatchNorm statistics, and the router biases of an ensemble, so that
    random weights tell crops apart); the trees back in the JAX layout."""
    srv = Server(_opt(), v["params"], v["batch_stats"], CHARS, class_counts=counts,
                 device="cpu")
    x = srv.images(images)
    chip_smoke.calibrate_random_trba(srv.model, x, torch.full((x.shape[0], 1), SOS))
    params, stats = to_flax(srv.model)
    return {"params": params, "batch_stats": stats}


def _check_greedy(got, ref, counts, tol):
    """``chip_smoke.check_greedy`` (atol = rtol = tol) on numpy logits
    [B, S, C] against JAX's: each crop's steps up to its first flipped
    pick, flips only at a near-tie.  Returns the per-crop flip mask."""
    _, flipped = chip_smoke.check_greedy("greedy logits vs JAX", torch.tensor(got),
                                         torch.tensor(ref), torch.tensor(counts), tol, tol)
    return flipped.tolist()


# ------------------------------------------------------------ module by module
def test_resnet_matches_jax(rng):
    jm = JaxResNet(OC)
    x = rng.standard_normal((2, *IMG)).astype(np.float32)
    v = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False), rng)
    ref = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    assert ref.shape == (2, 1, IMG[1] // 4 + 1, OC)
    port = _load(ResNetExtractor(IMG[2], OC), v)
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=RESNET_TOL, rtol=RESNET_TOL)


def test_bilstm_matches_jax(rng):
    jm = JaxBiLSTM(HID, HID)
    x = rng.standard_normal((3, 17, OC)).astype(np.float32)
    v = _perturb(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)), rng)
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    port = BidirectionalLSTM(OC, HID, HID)
    port.load_state_dict(recognizer_state(v["params"]), strict=True)
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=LSTM_TOL, rtol=LSTM_TOL)


class _JaxHead(fnn.Module):
    """The JAX decoder with the shared ``fc`` generator, as a Recognizer
    builds them."""

    num_classes: int

    def setup(self):
        self.fc = JaxDense(self.num_classes, name="fc")
        self.prediction = JaxDecoder(input_size=HID, hidden_size=HID,
                                     num_classes=self.num_classes, generator=self.fc,
                                     name="prediction")

    def __call__(self, batch_H, text, class_count=None):
        return self.prediction(batch_H, text, is_train=False, class_count=class_count)


@pytest.mark.parametrize("class_count", [None, 12])
def test_greedy_decoder_matches_jax(rng, class_count):
    """Both class-count rules: OOV ids clamp to 0 and the argmax stays
    below ``class_count``."""
    n = 20
    jm = _JaxHead(n)
    h = rng.standard_normal((4, 17, HID)).astype(np.float32)
    text = jnp.full((4, 1), SOS, jnp.int32)
    v = _perturb(jm.init(jax.random.PRNGKey(2), jnp.asarray(h), text), rng)
    # wide logit margins, so greedy picks are far from ties
    v["params"]["fc"]["kernel"] = 3 * rng.standard_normal((HID, n)).astype(np.float32)
    ref = np.asarray(jm.apply(v, jnp.asarray(h), text, class_count))
    port = nn.ModuleDict({"fc": Dense(HID, n), "prediction": AttentionDecoder(HID, HID, n)})
    port.load_state_dict(recognizer_state(v["params"]), strict=True)
    with torch.inference_mode():
        got = port["prediction"](torch.from_numpy(h), torch.full((4, 1), SOS), port["fc"],
                                 class_count).numpy()
    assert got.shape == ref.shape == (4, 26, n)
    count = class_count or n
    if class_count:  # some steps' unmasked argmax lies past the count
        assert (ref.argmax(-1) >= class_count).any()
    assert not any(_check_greedy(got, ref, [count] * 4, DECODER_TOL))


# ------------------------------------------------------------ one recognizer
@pytest.fixture(scope="module")
def jax_recognizer():
    rng = np.random.default_rng(21)
    n = len(CHARS) + 5
    jm = JaxRecognizer(num_classes=n, prediction="Attn", transformation="TPS",
                       feature_extraction="ResNet", sequence_modeling="BiLSTM",
                       output_channel=OC, hidden_size=HID, img_size=IMG[:2])
    images = _images(rng, 4)
    x, text = jnp.asarray(_normed(images)), jnp.full((4, 1), SOS, jnp.int32)
    v = jax.jit(lambda k: jm.init({"params": k}, x, text=text, train=False,
                                  is_train=False))(jax.random.PRNGKey(4))
    v = _perturb(v, rng)
    v["params"]["fc"]["kernel"] = 3 * rng.standard_normal((HID, n)).astype(np.float32)
    v = _calibrate(v, images)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_tps, "grid_sample", _pallas_warp)
    try:
        out = jax.jit(lambda v, x: jm.apply(v, x, text=text, train=False, is_train=False))(v, x)
    finally:
        mp.undo()
    return dict(variables=v, images=images, predict=np.asarray(out["predict"]),
                feature=np.asarray(out["feature"]))


def test_recognizer_matches_jax_eval(jax_recognizer):
    opt = _opt()
    v = jax_recognizer["variables"]
    srv = Server(opt, v["params"], v["batch_stats"], CHARS, device="cpu")
    with torch.inference_mode():
        x = srv.images(jax_recognizer["images"])
        out = srv.model(x, torch.full((4, 1), SOS))
    np.testing.assert_allclose(out["feature"].numpy(), jax_recognizer["feature"],
                               atol=E2E_TOL, rtol=E2E_TOL)
    ref = jax_recognizer["predict"]
    flipped = _check_greedy(srv.forward(jax_recognizer["images"])["logits"].numpy(), ref,
                            [ref.shape[-1]] * 4, E2E_TOL)
    assert sum(flipped) <= 1


def test_bridge_round_trip(jax_recognizer):
    """from_flax -> to_flax gives back every leaf of the JAX trees."""
    v = jax_recognizer["variables"]
    port = _load(Recognizer(len(CHARS) + 5, "Attn", "TPS", "ResNet", "BiLSTM", IMG[2], OC,
                            HID, IMG[:2]), v)
    params, stats = to_flax(port)
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])  # noqa: E731
    for ref, got in ((v["params"], params), (v["batch_stats"], stats)):
        ref, got = flat(ref), flat(got)
        assert set(got) == set(ref)
        for key, leaf in ref.items():
            np.testing.assert_array_equal(got[key], np.asarray(leaf))
    # the conv kernels sit in the flax child scope Conv_0, HWIO both ways
    conv = v["params"]["extractor"]["feature"]["conv0_1"]["Conv_0"]["kernel"]
    weight = port.extractor.feature.conv0_1.Conv_0.weight.detach().numpy()
    np.testing.assert_array_equal(weight, np.asarray(conv).transpose(3, 2, 0, 1))


def test_pad_expert_state_pads_char_embeddings(jax_recognizer):
    """The port's padding of an Attn expert against ``pad_expert_tree``:
    fc columns and char_embeddings rows, zeros."""
    v = jax_recognizer["variables"]
    n = len(CHARS) + 5
    padded = pad_expert_tree(v["params"], n + 7, "Attn")
    state = pad_expert_state(recognizer_state(v["params"]), n + 7)
    for key in ("fc.kernel", "fc.bias", "prediction.char_embeddings"):
        ref = recognizer_state(padded)[key]
        assert state[key].shape == ref.shape
        torch.testing.assert_close(state[key], ref, atol=0, rtol=0)


# -------------------------------------------------------- 3-expert TRBA MRN
@pytest.fixture(scope="module")
def jax_mrn():
    """JAX TRBA MRNNet (3 experts, unequal class counts) on a seeded batch:
    variables, images and the eval outputs as served (make_eval_batch +
    train/evaluate.py's [EOS] pruning)."""
    rng = np.random.default_rng(5)
    num_classes = COUNTS[-1]
    model = JaxMRNNet(n_experts=len(COUNTS), num_classes=num_classes, class_counts=COUNTS,
                      prediction="Attn", transformation="TPS",
                      feature_extraction="ResNet", sequence_modeling="BiLSTM",
                      output_channel=OC, hidden_size=HID, img_size=IMG[:2])
    images = _images(rng, 8)
    x, text = jnp.asarray(_normed(images)), jnp.full((8, 1), SOS, jnp.int32)
    v = jax.jit(lambda k: model.init({"params": k}, x, text, train=False))(
        jax.random.PRNGKey(3))
    v = jax.tree_util.tree_map(np.asarray, v)
    experts = v["params"]["experts"]
    # each crop its own grid (the init fc2 kernel is zero), and wide logit
    # margins; the router's kernels spread (init weights route everything
    # one way), its biases centred on the batch by _calibrate
    loc = experts["extractor"]["transformation"]["localization"]["localization_fc2"]
    loc["kernel"] = 0.05 * rng.standard_normal(loc["kernel"].shape).astype(np.float32)
    for key in ("channel_route", "route"):
        v["params"][key]["kernel"] = rng.standard_normal(
            v["params"][key]["kernel"].shape).astype(np.float32)
    experts["fc"]["kernel"] = 3 * rng.standard_normal(
        experts["fc"]["kernel"].shape).astype(np.float32)
    v = _calibrate(v, images, COUNTS)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_tps, "grid_sample", _pallas_warp)
    try:
        out = jax.jit(lambda v, x: model.apply(v, x, text, cross=True, train=False,
                                               is_train=False))(v, x)
    finally:
        mp.undo()
    logits = np.asarray(out["logits"])
    preds = logits.argmax(2)
    max_probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=2).max(2))
    words, confs = [], []
    for w, p in zip(JaxAttnConverter(CHARS).decode(preds, np.full(8, preds.shape[1])),
                    max_probs):
        eos = w.find("[EOS]")
        if eos >= 0:
            w, p = w[:eos], p[:eos]
        words.append(w)
        confs.append(float(np.prod(p)) if len(p) else 0.0)
    return dict(variables=v, images=images, logits=logits, index=np.asarray(out["index"]),
                words=words, confs=confs)


def test_trba_mrn_served_matches_jax(jax_mrn):
    v = jax_mrn["variables"]
    srv = Server(_opt(), v["params"], v["batch_stats"], CHARS, class_counts=COUNTS,
                 device="cpu")
    out = srv.forward(jax_mrn["images"])
    index = jax_mrn["index"]
    assert len(set(index.tolist())) > 1                     # routing varies
    np.testing.assert_array_equal(out["index"].numpy(), index)
    logits = out["logits"].numpy()
    assert logits.shape == (8, 26, COUNTS[-1])
    counts = [COUNTS[i] for i in index]
    for b, i in enumerate(index):                            # ones-padding
        assert (logits[b, :, COUNTS[i]:] == 1.0).all()
    flipped = _check_greedy(logits, jax_mrn["logits"], counts, E2E_TOL)
    rec = srv.recognize(jax_mrn["images"])
    for (word, conf), ref_word, ref_conf, flip in zip(rec, jax_mrn["words"], jax_mrn["confs"],
                                                      flipped):
        if not flip:
            assert word == ref_word
            np.testing.assert_allclose(conf, ref_conf, rtol=CONF_RTOL, atol=0)
    assert sum(flipped) <= 2       # most crops decode to the end unflipped


def test_chip_smoke_random_trba_tree_matches_jax_layout(jax_mrn):
    """The numpy TRBA weights chip_smoke serves have the JAX MRNNet's tree
    layout (same paths and shapes)."""
    params, stats = chip_smoke.random_mrn(np.random.default_rng(0), _opt(), COUNTS)
    shapes = lambda t: jax.tree_util.tree_map(np.shape, t)  # noqa: E731
    ref = jax_mrn["variables"]
    assert shapes(params) == shapes(ref["params"])
    assert shapes(stats) == shapes(ref["batch_stats"])


def test_attn_converter_matches_jax():
    words = ["abc", "", "zz?", "v" * 25]
    ref, got = JaxAttnConverter(CHARS), AttnLabelConverter(CHARS)
    assert got.character == ref.character and got.num_classes == ref.num_classes
    for a, b in zip(got.encode(words, 25), ref.encode(words, 25)):
        np.testing.assert_array_equal(a, b)
    idx, lengths = ref.encode(words, 25)
    assert got.decode(idx, lengths) == ref.decode(idx, lengths)


def test_recognize_cuts_words_at_eos_as_evaluate_does(monkeypatch):
    """Words and their max-softmax rows are cut at the first "[EOS]" of the
    decoded string, at its string index as ``train/evaluate.py`` cuts them
    (a multi-character token before it shifts the cut of the
    probabilities); a word that is cut to nothing has confidence 0."""
    from mrn_tpu_torch.models.init import random_recognizer

    opt = _opt()
    params, stats = random_recognizer(np.random.default_rng(0), opt, len(CHARS) + 5)
    srv = Server(opt, params, stats, CHARS, device="cpu")
    a, b, unk, eos = 5, 6, 0, 3   # 'a', 'b', [UNK], [EOS]
    preds = np.array([[a, unk, b, eos, a, b], [a, b, b, a, a, b], [eos, a, a, b, b, a]],
                     np.int32)
    probs = np.random.default_rng(1).uniform(0.5, 1.0, preds.shape).astype(np.float32)
    monkeypatch.setattr(srv, "eval_batch", lambda images: {"preds_index": preds,
                                                           "max_probs": probs})
    ref = []
    for w, p in zip(JaxAttnConverter(CHARS).decode(preds, np.full(3, 6)), probs):
        eos_at = w.find("[EOS]")
        if eos_at >= 0:
            w, p = w[:eos_at], p[:eos_at]
        ref.append((w, float(np.prod(p)) if len(p) else 0.0))
    assert srv.recognize(None) == ref
    assert [w for w, _ in ref] == ["a[UNK]b", "abbaab", ""] and ref[2][1] == 0.0
