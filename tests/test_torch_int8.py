"""The port's w8a8 int8 serving path against the JAX package's, on the CPU:
quantization ops bit for bit, calibration amaxes, the w8a8 Block's plain
version against the Pallas kernel in interpret mode, the calibrated int8
recognizer against the JAX int8 recognizer, the bridge round trip, the
server's dtype rules and refusals, the score envelope and the text metrics.
Inputs come from numpy seeds; weights are bridged from JAX."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mrn_tpu.models.svtr as jax_svtr
from mrn_tpu.config import default_options as jax_default_options
from mrn_tpu.models.composer import build_recognizer as jax_build_recognizer
from mrn_tpu.models.svtr import Block as JaxBlock
from mrn_tpu.models.svtr import SVTRExtractor as JaxSVTRExtractor
from mrn_tpu.models.svtr import local_attention_mask_col_major as jax_col_mask
from mrn_tpu.ops import int8 as jax_int8
from mrn_tpu.ops import metrics as jax_metrics
from mrn_tpu.ops.svtr_block import _band_spec as jax_band_spec
from mrn_tpu.ops.svtr_block import fused_block as jax_fused_block
from mrn_tpu_torch.bridge import from_flax, quant_tree, to_flax
from mrn_tpu_torch.config import load_config
from mrn_tpu_torch.models import svtr as port_svtr
from mrn_tpu_torch.models.composer import build_recognizer
from mrn_tpu_torch.models.init import random_mrn
from mrn_tpu_torch.models.svtr import Block, SVTRExtractor, score_envelope
from mrn_tpu_torch.ops import int8, metrics, svtr_block
from mrn_tpu_torch.ops.svtr_train_block import PARAM_KEYS
from mrn_tpu_torch.serve import Server, quantize_int8

# The JAX test's own tolerance for the fused int8 kernel against the
# composed int8 path (tests/test_svtr_block.py): float32 summation order.
BLOCK_TOL = 5e-5
AMAX_RTOL = 1e-5
TINY = dict(img_size=(16, 32), embed_dim=(32, 32, 32), depth=(1, 2, 1),
            num_heads=(2, 2, 2))      # 4 Blocks, c = 32, stage 1 hw (4, 8)


@pytest.fixture(autouse=True)
def xla_impl():
    jax_svtr.set_attention_impl("xla")
    yield
    jax_svtr.set_attention_impl("auto")
    jax_svtr.set_attention_int8(False)


def _perturb(tree, rng, scale=0.1):
    """Every float leaf moved off its init value (norm and bias leaves
    matter to the LN affine and the epilogues)."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(np.shape(a)).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, tree))


def _tensors(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _calibrated_block(rng, mixer, hw=(4, 8), heads=2, c=32, batch=3):
    """A JAX Block's (x, perturbed variables, calibrated quant)."""
    kw = dict(dim=c, num_heads=heads, mixer=mixer, hw=hw, drop_path=0.0, col_major=True)
    x = rng.standard_normal((batch, hw[0] * hw[1], c)).astype(np.float32)
    v = JaxBlock(**kw).init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), train=False)
    v = {"params": _perturb(v["params"], rng, 0.05)}
    _, upd = JaxBlock(**kw, quant="calib").apply(v, jnp.asarray(x), train=False,
                                                  mutable=["quant"])
    return x, v, jax.tree_util.tree_map(np.asarray, upd["quant"])


# ------------------------------------------------------------ quantization ops
def test_quantize_kernel_matches_jax_bitwise(rng):
    """int8 kernels equal, scales to 1e-7 relative; a column whose scale is
    exactly 1 puts values on .5 boundaries (half to even in both), and an
    all-zero column takes the 1e-12 floor."""
    for shape in [(32, 96), (3, 3, 4, 8)]:
        w = (0.05 * rng.standard_normal(shape)).astype(np.float32)
        w[..., 0] = 0.0
        w[..., 1] = 0.5 + rng.integers(-4, 4, shape[:-1])
        w.reshape(-1, shape[-1])[0, 1] = 127.0
        jq, js = jax_int8.quantize_kernel(jnp.asarray(w))
        tq, ts = int8.quantize_kernel(w)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7, atol=0)


def test_q8_multiplies_by_the_reciprocal_and_rounds_half_to_even(rng):
    """The w8a8 Block's activation quantization is the Pallas kernel's
    ``clip(round(h * inv), -127, 127)`` (a multiply by ``1 / scale``, half
    to even), which differs from the composed path's ``round(h / scale)``
    near .5 boundaries: some of the values (k + .5) * scale land on the
    other side."""
    amax = np.float32(2.7)
    s = amax / np.float32(127.0)
    inv = np.float32(1.0) / s
    h = np.concatenate([rng.standard_normal(4096).astype(np.float32) * 3.0,
                        (np.arange(-127, 127) + 0.5).astype(np.float32) * s])
    h[:8] = np.arange(8) - 3.5                 # exact .5 boundaries at inv 1
    h[8:12] = [200.0, -200.0, 126.5, -127.5]   # the clip
    ref = np.asarray(jnp.clip(jnp.round(jnp.asarray(h) * inv), -127.0, 127.0))
    got = svtr_block._q8(torch.from_numpy(h), torch.tensor(inv)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(svtr_block._q8(torch.from_numpy(h[:12]), torch.tensor(1.0)),
                                  [-4, -2, -2, -0, 0, 2, 2, 4, 127, -127, 126, -127])
    divided = np.asarray(jax_int8.quantize_act(jnp.asarray(h), jnp.asarray(amax))[0])
    assert (divided != got).any()


def test_int_matmul_refuses_inexact_depth():
    with pytest.raises(ValueError):
        int8.int_matmul(torch.ones((2, int8.MAX_EXACT_K + 1)),
                        torch.ones((int8.MAX_EXACT_K + 1, 3)))


# ------------------------------------------------------------------ calibration
@pytest.mark.parametrize("mixer", ["Global", "Local"])
def test_block_calib_amax_matches_jax(rng, mixer):
    x, v, jq = _calibrated_block(rng, mixer)
    blk = Block(32, 2, mixer, (4, 8), col_major=True, quant="calib")
    blk.load_state_dict(_tensors(v["params"]), strict=True)
    with torch.inference_mode():
        blk(torch.from_numpy(x))
    got = quant_tree(blk)
    assert sorted(got) == sorted(jq) and len(got) == 7
    for key in jq:
        np.testing.assert_allclose(got[key], jq[key], rtol=AMAX_RTOL, atol=0, err_msg=key)


def test_extractor_calib_amax_matches_jax(rng):
    """A 4-Block SVTR: 7 amaxes per Block, each within 1e-5 relative."""
    x = rng.standard_normal((2, 16, 32, 4)).astype(np.float32)
    jm = JaxSVTRExtractor(out_channels=24, **TINY)
    v = jm.init({"params": jax.random.PRNGKey(1)}, jnp.asarray(x), train=False)
    v = {"params": _perturb(v["params"], rng, 0.05), "batch_stats": v["batch_stats"]}
    _, upd = JaxSVTRExtractor(out_channels=24, quant="calib", **TINY).apply(
        v, jnp.asarray(x), train=False, mutable=["quant"])
    port = SVTRExtractor(in_channels=4, out_channels=24, quant="calib", **TINY)
    port.load_state_dict(from_flax(v["params"], v["batch_stats"]), strict=True)
    with torch.inference_mode():
        port.eval()(torch.from_numpy(x))
    ref = dict(jax.tree_util.tree_flatten_with_path(upd["quant"])[0])
    ref = {".".join(p.key for p in path): np.asarray(val) for path, val in ref.items()}
    got = {f"{blk}.{k}": val for blk, leaves in quant_tree(port).items()
           for k, val in leaves.items()}
    assert sorted(got) == sorted(ref) and len(got) == 4 * 7
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=AMAX_RTOL, atol=0, err_msg=key)


# ------------------------------------------------------------ the w8a8 Block
def _run_block_pair(rng, mixer, attn_int8, dt):
    x, v, jq = _calibrated_block(rng, mixer)
    qv = jax_int8.quantize_variables(dict(v, quant=jq))
    mask = jax_col_mask(4, 8) if mixer == "Local" else None
    scale = 16 ** -0.5
    jdt, tdt = (jnp.float32, torch.float32) if dt == "f32" else (jnp.bfloat16, torch.bfloat16)
    jax_svtr.set_attention_int8(attn_int8)
    ref = jax_fused_block(jnp.asarray(x, jdt), qv["params"], mask, 2, scale, interpret=True,
                          quant=qv["quant"])
    jax_svtr.set_attention_int8(False)
    weights = svtr_block.prepare_int8(_tensors(qv["params"]), _tensors(qv["quant"]))
    got = svtr_block.fused_block_int8(torch.from_numpy(x).to(tdt), weights, mask, 2, scale,
                                      attn_int8=attn_int8)
    assert got.dtype == tdt and got.shape == x.shape
    return got.float().numpy(), np.asarray(ref).astype(np.float32)


@pytest.mark.parametrize("attn_int8", [False, True])
@pytest.mark.parametrize("mixer", ["Global", "Local"])
def test_int8_block_matches_jax_interpret_f32(rng, mixer, attn_int8):
    got, ref = _run_block_pair(rng, mixer, attn_int8, "f32")
    np.testing.assert_allclose(got, ref, atol=BLOCK_TOL, rtol=BLOCK_TOL)


@pytest.mark.parametrize("attn_int8", [False, True])
def test_int8_block_matches_jax_interpret_bf16(rng, attn_int8):
    """bf16 input: both sides round q, k, v, P and the output at the same
    points; two bf16 ulps of the output's largest |value|."""
    got, ref = _run_block_pair(rng, "Local", attn_int8, "bf16")
    top = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, atol=2 * 2.0 ** (np.floor(np.log2(top)) - 7), rtol=0)


def test_cpu_int8_block_takes_plain_version_and_counts_nothing(rng):
    x, v, jq = _calibrated_block(rng, "Global")
    qv = int8.quantize_variables(dict(v, quant=jq))
    w = svtr_block.prepare_int8(_tensors(qv["params"]), _tensors(qv["quant"]))
    before = (svtr_block.int8_launches, svtr_block.launches)
    xt = torch.from_numpy(x)
    out = svtr_block.fused_block_int8(xt, w, None, 2, 0.25)
    ref = svtr_block.fused_block_int8_reference(xt, w, None, 2, 0.25)
    assert (svtr_block.int8_launches, svtr_block.launches) == before
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    with pytest.raises(ValueError):
        svtr_block.fused_block_int8(xt.to("meta"), w, None, 2, 0.25)


def test_block_int8_weights_follow_load_and_cast(rng):
    """The Block's kernel operands are derived on load and again on each
    cast: LN rows and biases become float32 copies of the bf16 values,
    the scales, dequant rows and int8 kernels do not change."""
    x, v, jq = _calibrated_block(rng, "Global")
    qv = int8.quantize_variables(dict(v, quant=jq))
    blk = Block(32, 2, "Global", (4, 8), quant="int8")
    blk.load_state_dict({**_tensors(qv["params"]), **_tensors(qv["quant"])}, strict=True)
    ref = svtr_block.prepare_int8(_tensors(qv["params"]), _tensors(qv["quant"]))
    for got_t, ref_t in zip(jax.tree_util.tree_leaves(tuple(blk.int8_weights)),
                            jax.tree_util.tree_leaves(tuple(ref))):
        torch.testing.assert_close(got_t, ref_t, atol=0, rtol=0)
    blk.to(torch.bfloat16)
    w = blk.int8_weights
    assert all(t.dtype == torch.float32 for t in (*w.norms, *w.biases, *w.deqs, w.inv))
    torch.testing.assert_close(w.norms[0], blk.norm1_scale.float(), atol=0, rtol=0)
    torch.testing.assert_close(w.biases[2], blk.fc1_bias.float(), atol=0, rtol=0)
    assert not torch.equal(w.biases[2], ref.biases[2])
    for got_t, ref_t in zip((*w.kernels, *w.deqs, w.inv), (*ref.kernels, *ref.deqs, ref.inv)):
        torch.testing.assert_close(got_t, ref_t, atol=0, rtol=0)


def test_prepare_int8_transposed_kernels_follow_load_and_cast(rng):
    """``prepare_int8``'s k-contiguous copies, which the CUDA kernel streams,
    are the int8 kernels transposed; a Block derives them anew on
    ``load_state_dict`` and on casts, and they enter neither its state dict
    nor the bridge's trees."""
    x, v, jq = _calibrated_block(rng, "Local")
    qv = int8.quantize_variables(dict(v, quant=jq))
    blk = Block(32, 2, "Local", (4, 8), col_major=True, quant="int8")
    state = {**_tensors(qv["params"]), **_tensors(qv["quant"])}
    blk.load_state_dict(state, strict=True)

    def check(expected):
        kernels_t = blk.int8_weights.kernels_t
        assert len(kernels_t) == 4
        for kt, name in zip(kernels_t, ("qkv", "proj", "fc1", "fc2")):
            assert kt.dtype == torch.int8 and kt.is_contiguous()
            torch.testing.assert_close(kt, expected[f"{name}_kernel"].t(), atol=0, rtol=0)

    check(state)
    state = dict(state, fc1_kernel=torch.flip(state["fc1_kernel"], [0]),
                 qkv_kernel=-state["qkv_kernel"])
    blk.load_state_dict(state, strict=True)
    check(state)
    blk.to(torch.bfloat16)
    check(state)
    keys = set(blk.state_dict())
    assert keys == set(PARAM_KEYS) | set(quant_tree(blk)) and len(keys) == 12 + 11
    params, _ = to_flax(blk)
    assert sorted(params) == sorted(PARAM_KEYS)
    for name in ("qkv", "proj", "fc1", "fc2"):
        np.testing.assert_array_equal(params[f"{name}_kernel"],
                                      state[f"{name}_kernel"].numpy())


@pytest.mark.parametrize("hw,plan", [((8, 64), (128, 256)), ((4, 64), (64, 128)),
                                     ((8, 32), (32, 128)), ((4, 128), (128, 256))])
def test_int8_band_windows_hold_every_visible_key(hw, plan):
    """The CUDA kernel attends a Local Block's query blocks only to their band
    windows (``_band_spec``, the JAX package's plan for the float Block),
    while the Pallas kernel and the plain version attend over the full mask.
    They compute the same function: in the JAX package's full column-major
    mask every key visible to a query block lies inside its window, the band
    mask is the full mask's window, and every key outside carries -inf, so
    its p = exp(-inf - max) is exactly 0, and so is rint(p * 127).  (8, 64)
    and (4, 64) are SVTR's Local Blocks (stages 1 and 2)."""
    full = jax_col_mask(*hw)
    qb, width, starts, band_mask = svtr_block._band_spec(*hw, 7, 11)
    jqb, jwidth, jstarts, jband = jax_band_spec(*hw, 7, 11)
    assert (qb, width) == (jqb, jwidth) == plan
    assert tuple(starts) == tuple(jstarts) and len(starts) * qb == full.shape[0]
    np.testing.assert_array_equal(band_mask, np.asarray(jband))
    for a, st in enumerate(starts):
        rows = full[a * qb:(a + 1) * qb]
        assert 0 <= st <= full.shape[1] - width
        np.testing.assert_array_equal(band_mask[a * qb:(a + 1) * qb], rows[:, st:st + width])
        outside = np.concatenate([rows[:, :st], rows[:, st + width:]], axis=1)
        assert np.isneginf(outside).all()
        assert (rows[:, st:st + width] == 0).any(axis=1).all()


def test_quant_block_refuses_train_mode():
    blk = Block(32, 2, "Global", (4, 8), quant="int8")
    with pytest.raises(ValueError):
        blk(torch.zeros((1, 32, 32)), train=True)


# -------------------------------------------------------------- whole slice
IMG = (32, 64, 4)
CHARS = list("abcdefghij")
# Both sides serve the Pallas kernel's arithmetic: the JAX int8 recognizer
# runs its fused int8 Block (the Pallas kernel in interpret mode), the port
# its plain version.  The integer products are exact, but the port's
# calibration amaxes differ from JAX's by float32 summation order (<= 1e-5
# relative), and LayerNorm, softmax and the convs sum in another order too:
# an activation within that distance of a .5 boundary rounds to the other
# int8 value, and the flip moves its image's later activations across
# further boundaries.  Over 12 Blocks the logits then differ by a share of
# the int8 noise itself.  Measured at this seed: max |diff| 7.4e-3, mean
# 2.0e-3, against an int8-vs-float32 gap of 1.24e-2 max and 2.95e-3 mean;
# bounds 2x the max and 2.5x the mean, picks agreeing outside near-ties.
# These cannot tell int8 from float, so each served Block is also held to
# the Pallas kernel on its own served input (no cascade): within BLOCK_TOL
# but for a flip's image, at most SERVED_FLIP_SHARE of the elements beyond
# it and none beyond SERVED_FLIP_MAX of the largest |output|.  Measured: 8
# of 12 Blocks within 2.4e-7; 4 with one flipped image, up to 2.7% of the
# elements (10.7% of that image) and 1.0e-3 of the largest |output|.  The
# control, the same Blocks with float products in place of the int8 ones
# (activations scaled but not rounded), moves 96-99% of the elements.
LOGIT_ATOL = 1.5e-2
LOGIT_MEAN_ATOL = 5e-3
SERVED_FLIP_SHARE = 0.10
SERVED_FLIP_MAX = 0.02


@pytest.fixture(scope="module")
def int8_slice():
    """JAX SVTR recognizer at full embed dims (imgW 64), calibrated on two
    batches and quantized; its int8 logits on a third batch through the
    fused Pallas int8 Block in interpret mode."""
    import mrn_tpu.ops.svtr_block as jax_block_ops

    jax_svtr.set_attention_impl("xla")
    rng = np.random.default_rng(9)
    jopt = jax_default_options(Transformation="None", FeatureExtraction="SVTR",
                               SequenceModeling="None", Prediction="CTC",
                               output_channel=32, hidden_size=16, imgH=IMG[0], imgW=IMG[1])
    n = len(CHARS) + 4
    images = [rng.integers(0, 256, (4, *IMG), dtype=np.uint8) for _ in range(3)]
    norm = [jnp.asarray((b.astype(np.float32) / 255.0 - 0.5) / 0.5) for b in images]
    model = jax_build_recognizer(jopt, n)
    v = jax.jit(lambda k: model.init({"params": k}, norm[0], train=False))(jax.random.PRNGKey(4))
    v = {"params": _perturb(v["params"], rng, 0.02), "batch_stats": jax.tree_util.tree_map(
        np.asarray, v["batch_stats"])}
    calib = jax.jit(lambda v, x: jax_build_recognizer(jopt, n, quant="calib").apply(
        v, x, train=False, mutable=["quant"])[1]["quant"])
    quant = None
    for x in norm[:2]:
        quant = calib(dict(v, quant=quant) if quant is not None else v, x)
    qv = jax_int8.quantize_variables(dict(v, quant=quant))
    i8 = jax_build_recognizer(jopt, n, quant="int8")
    fused = jax_block_ops.fused_block
    jax_block_ops.fused_block = functools.partial(fused, interpret=True)
    jax_svtr.set_attention_impl("pallas")
    try:
        logits = jax.jit(lambda qv, x: i8.apply(qv, x, train=False)["predict"])(qv, norm[2])
    finally:
        jax_block_ops.fused_block = fused
        jax_svtr.set_attention_impl("auto")
    qv = jax.tree_util.tree_map(np.asarray, qv)
    return dict(variables=v, quantized=qv, images=images, logits=np.asarray(logits))


def _port_opt(**kw):
    return load_config("configs/svtr_mrn.py", imgW=IMG[1], output_channel=32, hidden_size=16,
                       **kw)


def _int8_server(int8_slice, **kw):
    v = int8_slice["variables"]
    srv = Server(_port_opt(**kw), v["params"], v["batch_stats"], CHARS, device="cpu")
    quantize_int8(srv, iter(int8_slice["images"][:2]))
    return srv


def test_int8_recognizer_matches_jax(int8_slice):
    srv = _int8_server(int8_slice)
    # the same int8 kernels and w scales, amaxes to float32 noise
    params, _ = to_flax(srv.model)
    flat = lambda t: {".".join(p.key for p in path): np.asarray(a)  # noqa: E731
                      for path, a in jax.tree_util.tree_flatten_with_path(t)[0]}
    ref_p, got_p = flat(int8_slice["quantized"]["params"]), flat(params)
    kernels = [k for k, a in ref_p.items() if a.dtype == np.int8]
    assert len(kernels) == 12 * 4
    for key in kernels:
        np.testing.assert_array_equal(got_p[key], ref_p[key], err_msg=key)
    ref_q, got_q = flat(int8_slice["quantized"]["quant"]), flat(quant_tree(srv.model))
    assert sorted(ref_q) == sorted(got_q) and len(got_q) == 12 * 11
    for key in ref_q:
        np.testing.assert_allclose(got_q[key], ref_q[key], rtol=AMAX_RTOL, atol=0, err_msg=key)
    # logits and greedy picks
    logits = srv.forward(int8_slice["images"][2])["logits"].numpy()
    ref = int8_slice["logits"]
    assert logits.shape == ref.shape
    diff = np.abs(logits - ref)
    assert diff.max() <= LOGIT_ATOL and diff.mean() <= LOGIT_MEAN_ATOL, (diff.max(), diff.mean())
    top2 = np.sort(ref, axis=-1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > 2 * diff.max()
    assert decided.mean() > 0.5
    np.testing.assert_array_equal(logits.argmax(-1)[decided], ref.argmax(-1)[decided])


def _flip_share(got, ref):
    err = np.abs(got - ref)
    return float((err > BLOCK_TOL + BLOCK_TOL * np.abs(ref)).mean()), float(err.max())


def test_served_int8_blocks_match_pallas_kernel(int8_slice, monkeypatch):
    """Each of the 12 int8 Blocks of the port's calibrated server, on the
    input it was served, against the JAX Pallas int8 kernel in interpret
    mode with the same operands; the control (float products) fails."""
    srv = _int8_server(int8_slice)
    blocks = [m for m in srv.model.modules() if isinstance(m, Block)]
    served = []
    hooks = [b.register_forward_hook(lambda m, a, o: served.append((m, a[0], o)))
             for b in blocks]
    srv.forward(int8_slice["images"][2])
    for h in hooks:
        h.remove()
    assert len(served) == 12
    refs = []
    for blk, x, out in served:
        params = {k: getattr(blk, k).detach().numpy() for k in PARAM_KEYS}
        quant = {k: v.numpy() for k, v in blk.named_buffers() if port_svtr.is_quant_scale(k)}
        mask = None if blk.mask is None else blk.mask.numpy()
        ref = np.asarray(jax_fused_block(jnp.asarray(x.numpy()), params, mask, blk.num_heads,
                                         blk.scale, interpret=True, quant=quant))
        share, mx = _flip_share(out.numpy(), ref)
        assert share <= SERVED_FLIP_SHARE and mx <= SERVED_FLIP_MAX * np.abs(ref).max(), \
            (tuple(x.shape), share, mx)
        refs.append(ref)
    monkeypatch.setattr(svtr_block, "_q8", lambda h, inv: torch.clamp(h * inv, -127.0, 127.0))
    with torch.inference_mode():
        for (blk, x, _), ref in zip(served, refs):
            assert _flip_share(blk(x).numpy(), ref)[0] > 5 * SERVED_FLIP_SHARE


def test_bridge_round_trip_of_int8_kernels_and_quant(int8_slice):
    qv = int8_slice["quantized"]
    model = build_recognizer(_port_opt(), len(CHARS) + 4, quant="int8")
    model.load_state_dict(from_flax(qv["params"], int8_slice["variables"]["batch_stats"],
                                    qv["quant"]), strict=True)
    params, stats = to_flax(model)
    for got, ref in ((params, qv["params"]), (quant_tree(model), qv["quant"]),
                     (stats, int8_slice["variables"]["batch_stats"])):
        got_l = jax.tree_util.tree_leaves_with_path(got)
        ref_l = jax.tree_util.tree_leaves_with_path(ref)
        assert [p for p, _ in got_l] == [p for p, _ in ref_l]
        for (path, a), (_, b) in zip(got_l, ref_l):
            assert a.dtype == np.asarray(b).dtype, path
            np.testing.assert_array_equal(a, b)


def test_scale_buffers_stay_f32_under_bf16_server(int8_slice):
    srv = _int8_server(int8_slice, compute_dtype="bfloat16")
    buffers = dict(srv.model.named_buffers())
    scales = [k for k in buffers if port_svtr.is_quant_scale(k)]
    assert len(scales) == 12 * 11
    assert all(buffers[k].dtype == torch.float32 for k in scales)
    assert all(buffers[k].dtype == torch.int8 for k in buffers if k.endswith("_kernel"))
    assert all(p.dtype == torch.bfloat16 for p in srv.model.parameters())
    out = srv.forward(int8_slice["images"][2])["logits"]
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out.float()).all())
    assert (out.float().numpy().argmax(-1) == int8_slice["logits"].argmax(-1)).mean() >= 0.9


def test_int8_refuses_mrn_and_empty_calibration(int8_slice):
    opt = _port_opt(svtr=dict(embed_dim=(16, 32, 64), depth=(1, 1, 1), num_heads=(2, 2, 4)))
    params, stats = random_mrn(np.random.default_rng(0), opt, (8, 14))
    mrn = Server(opt, params, stats, CHARS, class_counts=(8, 14), device="cpu")
    with pytest.raises(ValueError, match="single-recognizer"):
        quantize_int8(mrn, int8_slice["images"])
    v = int8_slice["variables"]
    srv = Server(_port_opt(), v["params"], v["batch_stats"], CHARS, device="cpu")
    with pytest.raises(ValueError, match="no batches"):
        quantize_int8(srv, [])
    with pytest.raises(ValueError):
        from_flax(params, stats, quant={"x": np.zeros(())})


# ------------------------------------------------------------ score envelope
def test_score_envelope_matches_jax(rng):
    x = rng.standard_normal((2, 16, 32, 4)).astype(np.float32)
    jm = JaxSVTRExtractor(out_channels=24, **TINY)
    v = jm.init({"params": jax.random.PRNGKey(2)}, jnp.asarray(x), train=False)
    v = {"params": _perturb(v["params"], rng, 0.2), "batch_stats": v["batch_stats"]}
    ref = jax_svtr.score_envelope(jm, v, jnp.asarray(x), train=False)
    port = SVTRExtractor(in_channels=4, out_channels=24, **TINY)
    port.load_state_dict(from_flax(v["params"], v["batch_stats"]), strict=True)
    got = score_envelope(port.eval(), torch.from_numpy(x))
    assert ref > 0.5
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert all(b.score_max is None for b in port.modules() if isinstance(b, Block))


def test_score_envelope_warns_and_skips_int8(int8_slice, monkeypatch, capsys):
    v = int8_slice["variables"]
    srv = Server(_port_opt(), v["params"], v["batch_stats"], CHARS, device="cpu")
    mx = srv.check_score_envelope(int8_slice["images"][0])
    assert 0 < mx < svtr_block.SCORE_CLAMP
    assert "score envelope" in capsys.readouterr().out
    monkeypatch.setattr(port_svtr, "SCORE_CLAMP", 0.5 * mx)
    assert score_envelope(srv.model, srv.images(int8_slice["images"][0])) == mx
    assert "VIOLATED" in capsys.readouterr().err
    quantize_int8(srv, int8_slice["images"][:1])
    assert srv.check_score_envelope(int8_slice["images"][0]) is None


# ------------------------------------------------------------------- metrics
def test_metrics_match_jax():
    pairs = [("", ""), ("abc", "abc"), ("abc", "abd"), ("kitten", "sitting"),
             ("", "abc"), ("abcdef", "ab"), ("ab", "abcdef"), ("一丁", "一")]
    for a, b in pairs:
        assert metrics.edit_distance(a, b) == jax_metrics.edit_distance(a, b)
        assert metrics.ned_score(a, b) == jax_metrics.ned_score(a, b)
    preds, gts = [a for a, _ in pairs], [b for _, b in pairs]
    assert metrics.word_accuracy(preds, gts) == jax_metrics.word_accuracy(preds, gts)

