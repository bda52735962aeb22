"""The port's w8a8 conv path (``ops.int8``: ``quantize_act``, ``conv_int8``,
``conv_w8a8``, ``quantize_variables``; ``models.common.TorchConv``'s
``quant`` modes; ``serve.quantize_int8`` of a conv recognizer) against the
JAX package's (``mrn_tpu/ops/int8.py``, ``TorchConv(quant=...)``), on the
CPU, narrow (output_channel 64, hidden 32, 32x64 crops): integer results and
int8 trees bitwise, calibrated ranges and features within stated
tolerances.  The card's ``torch._int_mm`` route is
``tests/test_torch_cuda_int8_conv.py``'s; its im2col is held here against
JAX's conv in exact integer arithmetic."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrn_tpu.config import load_config as jax_load_config
from mrn_tpu.models.composer import build_recognizer as jax_build_recognizer
from mrn_tpu.ops import int8 as jax_int8
from mrn_tpu_torch.bridge import from_flax, quant_tree, to_flax
from mrn_tpu_torch.codec import build_converter
from mrn_tpu_torch.config import load_config
from mrn_tpu_torch.models.common import TorchConv
from mrn_tpu_torch.models.composer import build_recognizer
from mrn_tpu_torch.models.init import random_mrn, random_recognizer
from mrn_tpu_torch.ops import int8
from mrn_tpu_torch.serve import Server, quantize_int8

IMG = (32, 64, 4)
OC, HID = 64, 32
CONFIGS = {"crnn": "configs/crnn_mrn.py", "grcnn": "configs/grcnn_mrn.py",
           "trba": "configs/trba_mrn.py"}
N_CONVS = {"crnn": 7, "grcnn": 14, "trba": 32}
# Calibrated ranges: CRNN's and GRCNN's conv0 reads the image itself
# (bitwise); later
# convs read float32 activations whose summation order differs between the
# frameworks (CRNN / GRCNN: 1e-6 relative; measured 2.7e-7), and TRBA's
# warp samples each framework's own TPS grid (GRID_TOL 2e-4 apart,
# tests/test_torch_tps.py), so its ranges are held at 1e-3 relative
# (measured 5.2e-5)
AMAX_RTOL = {"crnn": 1e-6, "grcnn": 1e-6, "trba": 1e-3}
# int8 features on the same int8 trees: the integer convs are exact and the
# epilogue is JAX's operation for operation, so an element differs only
# where a float32 activation a few ulps apart rounds across a .5 boundary
# and flips one int8 value, which moves that image's later activations.
# Measured: 5.2e-8 (CRNN) and 3.9e-7 (TRBA) of features up to 0.21, no
# flip; GRCNN 2.5e-5 (a flip).  Held at FEATURE_TOL, with at most
# FLIP_SHARE of the elements beyond it (a flip's image)
FEATURE_TOL = 1e-5
FLIP_SHARE = 0.05
# the same int8 model served in bfloat16: the epilogue's bf16 cast and the
# BiLSTMs in bf16, held to the float32 features at 5e-2 (measured 1.9e-3)
BF16_TOL = 5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _same_trees(got, ref, what):
    got = dict(_leaves(got))
    ref = dict(_leaves(jax.tree_util.tree_map(np.asarray, ref)))
    assert got.keys() == ref.keys(), what
    for k in ref:
        assert got[k].dtype == ref[k].dtype, f"{what}: {k}"
        np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{what}: {k}")


# ------------------------------------------------------------ the conv
# every kernel / stride / padding of the VGG, ResNet and RCNN convs:
# (kernel, stride, padding, cin, cout)
GEOMETRIES = {
    "3x3 on the image (K = 36)": ((3, 3), (1, 1), (1, 1), 4, 8),
    "3x3": ((3, 3), (1, 1), (1, 1), 16, 24),
    "2x2 (VGG conv6, ResNet conv4_2, RCNN conv1)": ((2, 2), (1, 1), (0, 0), 16, 16),
    "2x2 stride (2, 1) over one zero column (ResNet conv4_1)": ((2, 2), (2, 1), (0, 1), 16, 16),
    "1x1 (ResNet down_conv, GRCL gates)": ((1, 1), (1, 1), (0, 0), 24, 8),
}


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_conv_int8_matches_jax_bitwise(rng, geometry):
    """int32 results: the plain version (float64 conv) and the card's im2col
    (here in int64) against ``jax.lax.conv_general_dilated``'s exact int32,
    at the extremes of int8 too."""
    kernel, stride, padding, cin, cout = GEOMETRIES[geometry]
    x = rng.integers(-127, 128, (3, 7, 10, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (*kernel, cin, cout)).astype(np.int8)
    x[0] = 127
    w[..., 0] = -127
    ref = np.asarray(jax_int8.conv_int8(jnp.asarray(x), jnp.asarray(w), stride,
                                        [(p, p) for p in padding]))
    got = int8.conv_int8(torch.from_numpy(x), torch.from_numpy(w), stride, padding)
    assert got.dtype == torch.int32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    cols = int8._im2col(torch.from_numpy(x), kernel, stride, padding)
    mm = (cols.long() @ torch.from_numpy(w).reshape(-1, cout).long()).view(ref.shape)
    np.testing.assert_array_equal(mm.numpy(), ref)


def test_conv_int8_takes_int8_operands_only():
    with pytest.raises(TypeError, match="int8"):
        int8.conv_int8(torch.zeros((1, 4, 4, 8)), torch.zeros((1, 1, 8, 8), dtype=torch.int8))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quantize_act_matches_jax_bitwise(rng, dtype):
    """The division form ``round(x / scale)`` (half to even) clamped to
    +-127, on values at and around the .5 boundaries and beyond amax."""
    amax = np.float32(2.5)
    scale = np.float32(amax) / np.float32(127.0)
    k = rng.integers(-130, 130, 4000).astype(np.float32)
    x = np.concatenate([(k + 0.5) * scale, (k + 0.5) * scale * (1 + 1e-7),
                        rng.uniform(-3.0, 3.0, 4000).astype(np.float32)])
    if dtype == "bfloat16":
        xt = torch.from_numpy(x).bfloat16()
        xj = jnp.asarray(x).astype(jnp.bfloat16)
    else:
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
    ref_q, ref_s = jax_int8.quantize_act(xj, jnp.asarray(amax))
    got_q, got_s = int8.quantize_act(xt, torch.tensor(amax))
    assert got_q.dtype == torch.int8 and int(got_q.abs().max()) == 127
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(ref_q))
    assert float(got_s) == float(ref_s)


def test_conv_w8a8_epilogue_matches_jax_bitwise(rng):
    """One w8a8 conv with a bias: quantize, integer conv, ``y * (a_scale *
    w_scale) + bias``, the same float32 bits as the JAX TorchConv's int8
    branch (NCHW here, NHWC there)."""
    x = rng.standard_normal((2, 8, 12, 16)).astype(np.float32)
    w = rng.standard_normal((3, 3, 16, 24)).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    amax = np.float32(np.abs(x).max() * 0.9)      # some inputs clamp
    wq, ws = jax_int8.quantize_kernel(jnp.asarray(w))
    xq, a_scale = jax_int8.quantize_act(jnp.asarray(x), jnp.asarray(amax))
    y = jax_int8.conv_int8(xq, wq, (1, 1), [(1, 1), (1, 1)]).astype(jnp.float32)
    ref = np.asarray(y * (a_scale * ws) + bias)
    got = int8.conv_w8a8(torch.from_numpy(x).permute(0, 3, 1, 2),
                         torch.from_numpy(np.array(wq)).permute(3, 2, 0, 1),
                         torch.from_numpy(np.array(ws)), torch.tensor(amax),
                         torch.from_numpy(bias), (1, 1), (1, 1))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)


# ------------------------------------------------------------ whole recognizers
def _calibrated(arch, rng):
    """The same float trees, calibrated on one batch on both sides."""
    kw = dict(imgW=IMG[1], output_channel=OC, hidden_size=HID)
    jopt, topt = jax_load_config(CONFIGS[arch], **kw), load_config(CONFIGS[arch], **kw)
    params, stats = random_recognizer(rng, topt, 11)
    x = rng.standard_normal((3, *IMG)).astype(np.float32)
    text = np.zeros((3, 1), np.int32) if topt.Prediction == "Attn" else None
    jkw = {} if text is None else {"text": jnp.asarray(text)}
    _, upd = jax_build_recognizer(jopt, 11, quant="calib").apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), train=False, is_train=False,
        mutable=["quant"], **jkw)
    calib = build_recognizer(topt, 11, quant="calib")
    calib.load_state_dict(from_flax(params, stats), strict=True)
    with torch.no_grad():
        calib(torch.from_numpy(x), None if text is None else torch.from_numpy(text).long())
    return dict(jopt=jopt, topt=topt, params=params, stats=stats, x=x, text=text, jkw=jkw,
                jax_quant=jax.tree_util.tree_map(np.asarray, dict(upd["quant"])),
                quant=quant_tree(calib))


@pytest.fixture(scope="module", params=["crnn", "grcnn", "trba"])
def calibrated(request):
    return dict(_calibrated(request.param, np.random.default_rng(7)), arch=request.param)


def test_calibrated_ranges_of_every_conv_match_jax(calibrated):
    arch = calibrated["arch"]
    got, ref = dict(_leaves(calibrated["quant"])), dict(_leaves(calibrated["jax_quant"]))
    assert got.keys() == ref.keys() and len(ref) == N_CONVS[arch]
    assert all(k.endswith("act_amax") for k in ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=AMAX_RTOL[arch], atol=0, err_msg=k)
    if arch != "trba":   # conv0 reads the image itself: bitwise
        key = "extractor/feature/conv0/act_amax"
        assert got[key] == ref[key]


def test_quantize_variables_matches_jax_bitwise(calibrated):
    """The int8 kernels (per output channel) and the quant collection
    (``act_amax`` beside the new ``w_scale``) from JAX's calibration, leaf
    for leaf; every other leaf passes through."""
    c = calibrated
    ref = jax_int8.quantize_variables({"params": c["params"], "batch_stats": c["stats"],
                                       "quant": c["jax_quant"]})
    got = int8.quantize_variables({"params": c["params"], "quant": c["jax_quant"]})
    _same_trees(jax.tree_util.tree_map(np.asarray, got["params"]), ref["params"], "params")
    _same_trees(jax.tree_util.tree_map(np.asarray, got["quant"]), ref["quant"], "quant")
    assert sum(k.endswith("w_scale") for k, _ in _leaves(got["quant"])) == N_CONVS[c["arch"]]


def test_int8_recognizer_matches_jax_and_bridges_both_ways(calibrated):
    """The int8 model on JAX's quantized trees: features against JAX's int8
    apply (near-tie flips allowed), and ``to_flax`` / ``quant_tree`` give
    the trees back bitwise."""
    c = calibrated
    qv = jax_int8.quantize_variables({"params": c["params"], "batch_stats": c["stats"],
                                      "quant": c["jax_quant"]})
    qv = jax.tree_util.tree_map(np.asarray, qv)
    ref = jax_build_recognizer(c["jopt"], 11, quant="int8").apply(
        {"params": qv["params"], "batch_stats": c["stats"], "quant": qv["quant"]},
        jnp.asarray(c["x"]), train=False, is_train=False, **c["jkw"])
    model = build_recognizer(c["topt"], 11, quant="int8")
    model.load_state_dict(from_flax(qv["params"], c["stats"], qv["quant"]), strict=True)
    text = None if c["text"] is None else torch.from_numpy(c["text"]).long()
    with torch.no_grad():
        got = model(torch.from_numpy(c["x"]), text)
    feat, ref_feat = got["feature"].numpy(), np.asarray(ref["feature"])
    bad = np.abs(feat - ref_feat) > FEATURE_TOL * (1 + np.abs(ref_feat))
    assert bad.mean() <= FLIP_SHARE, f"{bad.mean():.3%} of the features past {FEATURE_TOL}"
    params, stats = to_flax(model)
    _same_trees(params, qv["params"], "params")
    _same_trees(quant_tree(model), qv["quant"], "quant")
    convs = [m for m in model.modules() if isinstance(m, TorchConv) and m.quant == "int8"]
    assert len(convs) == N_CONVS[c["arch"]]

    # served in bfloat16: int8 weights stay int8, scales float32
    model.to(torch.bfloat16)
    assert all(m.Conv_0.weight.dtype == torch.int8 and m.w_scale.dtype == torch.float32
               and m.act_amax.dtype == torch.float32 for m in convs)
    with torch.no_grad():
        got16 = model(torch.from_numpy(c["x"]).bfloat16(), text)
    assert got16["feature"].dtype == torch.bfloat16
    np.testing.assert_allclose(got16["feature"].float().numpy(), feat, atol=BF16_TOL,
                               rtol=BF16_TOL)


@pytest.mark.parametrize("arch", ["crnn", "trba"])
def test_server_quantize_int8_serves_a_conv_recognizer(rng, arch):
    """``serve.quantize_int8`` on a float32 server: calibrates every conv
    (an Attn head decoding from [SOS]), quantizes as JAX does and serves
    int8 convs; the calibrated int8 trees equal ``quantize_variables`` of
    the server's own calibration; an MRN ensemble is refused."""
    opt = load_config(CONFIGS[arch], imgW=IMG[1], output_channel=OC, hidden_size=HID)
    character = "abcdefg"
    n = build_converter(opt.Prediction, character).num_classes
    server = Server(opt, *random_recognizer(rng, opt, n), character, device="cpu")
    images = rng.integers(0, 256, (2, 3, *IMG)).astype(np.uint8)
    quantize_int8(server, iter(images))
    assert server.quantized
    convs = [m for m in server.model.modules() if isinstance(m, TorchConv)]
    assert sum(m.quant == "int8" for m in convs) == N_CONVS[arch]
    assert all(float(m.act_amax) > 0 for m in convs if m.quant == "int8")
    words = server.recognize(images[0])
    assert len(words) == 3 and all(np.isfinite(conf) for _, conf in words)

    counts = (n - 3, n)
    mrn = Server(opt, *random_mrn(rng, opt, counts), character, class_counts=counts,
                 device="cpu")
    with pytest.raises(ValueError, match="single-recognizer"):
        quantize_int8(mrn, iter(images))
