"""The tanh-GELU serving mode (the JAX package's ``set_gelu_approximate``)
in the port, on the CPU, against the JAX package on the same seeded inputs
and weights:

- the tanh form of the fused Block (row 4) and of the w8a8 Block (row 3),
  plain versions against the Pallas kernels in interpret mode under JAX's
  switch;
- int8 calibration under the switch (fc2's amax recorded after the tanh
  GELU);
- a small-depth SVTR-MRN served with the switch on, against JAX's eval on
  its fused Pallas Blocks in interpret mode;
- the switch's scope: Block MLPs only, over ``gelu_degree``, never
  PatchEmbed nor the fused training Block.

Every JAX call runs outside any jit cache kept across switch states."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mrn_tpu.models.composer as jax_composer
import mrn_tpu.models.svtr as jax_svtr
import mrn_tpu.ops.svtr_block as jax_block_ops
from mrn_tpu.models.mrn import MRNNet as JaxMRNNet
from mrn_tpu.models.svtr import Block as JaxBlock
from mrn_tpu.models.svtr import local_attention_mask as jax_local_mask
from mrn_tpu.models.svtr import local_attention_mask_col_major as jax_col_mask
from mrn_tpu.ops import int8 as jax_int8
from mrn_tpu_torch.bridge import quant_tree
from mrn_tpu_torch.config import load_config
from mrn_tpu_torch.models import svtr as port_svtr
from mrn_tpu_torch.models.init import random_mrn
from mrn_tpu_torch.models.svtr import Block, PatchEmbed
from mrn_tpu_torch.ops import svtr_block, svtr_train_block
from mrn_tpu_torch.serve import Server

# tests/test_torch_svtr_block.py's tolerances for row 4's plain version
# against the Pallas kernel: float32 summation order; bf16 one output ulp
# at |out| < 8 plus 1% relative
F32_TOL = 2e-5
BF16_ATOL, BF16_RTOL = 2 ** -5, 1e-2
# tests/test_torch_int8.py's: the w8a8 Block against the Pallas int8 kernel,
# and calibration amaxes (float32 summation order)
BLOCK_TOL = 5e-5
AMAX_RTOL = 1e-5
# served logits after 4 Blocks per expert, both sides on the fused Block's
# arithmetic with the tanh form: float32 noise (tests/test_torch_mrn_slice.py)
LOGIT_TOL = 1e-4

NARROW = dict(embed_dim=(16, 32, 64), depth=(1, 2, 1), num_heads=(2, 2, 4),
              drop_path_rate=0.0)


@pytest.fixture(autouse=True)
def switches():
    """Both packages' GELU switches off and their attention on the composed
    XLA path before and after each test; torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)

    def reset():
        jax_svtr.set_gelu_approximate(False)
        jax_svtr.set_train_gelu("auto")
        jax_svtr.set_attention_impl("xla")
        port_svtr.set_gelu_approximate(False)
    reset()
    yield
    reset()
    jax_svtr.set_attention_impl("auto")
    torch.set_num_threads(threads)


def _block_params(rng, c):
    """Block leaves with a non-trivial LN affine (exercises the fold)."""
    hidden = 4 * c
    shapes = dict(norm1_scale=(c,), norm1_bias=(c,), qkv_kernel=(c, 3 * c),
                  qkv_bias=(3 * c,), proj_kernel=(c, c), proj_bias=(c,),
                  norm2_scale=(c,), norm2_bias=(c,), fc1_kernel=(c, hidden),
                  fc1_bias=(hidden,), fc2_kernel=(hidden, c), fc2_bias=(c,))
    out = {}
    for name, shape in shapes.items():
        base = 1.0 if "norm" in name else 0.0
        std = 0.1 if ("norm" in name or "bias" in name) else 0.05
        out[name] = (base + std * rng.standard_normal(shape)).astype(np.float32)
    return out


def _perturb(tree, rng, scale):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(np.shape(a)).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, tree))


def _tensors(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


# ------------------------------------------------------------ the tanh form
def test_gelu_tanh_matches_jax_nn_gelu():
    """The plain tanh form against ``jax.nn.gelu(approximate=True)`` on a
    dense grid, float32, and it is not the erf GELU."""
    x = np.linspace(-12.0, 12.0, 200001, dtype=np.float32)
    got = svtr_block.gelu_tanh(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True))
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)
    assert np.abs(got - np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=False))).max() > 1e-4


# ------------------------------------------------------------------ row 4
def _row4_pair(rng, mixer, hw, heads, c, dt):
    n = hw[0] * hw[1]
    params = _block_params(rng, c)
    x = rng.standard_normal((2, n, c)).astype(np.float32)
    band, mask = None, None
    if mixer == "Local":
        mask = jax_local_mask(*hw)
    elif mixer == "Local-band":
        mask = jax_col_mask(*hw)
        band = (hw[0], hw[1], 7, 11)
    scale = (c // heads) ** -0.5
    jdt, tdt = (jnp.float32, torch.float32) if dt == "f32" else (jnp.bfloat16, torch.bfloat16)
    jax_svtr.set_gelu_approximate(True)
    ref = jax_block_ops.fused_block(jnp.asarray(x, jdt),
                                    {k: jnp.asarray(v, jdt) for k, v in params.items()},
                                    mask, heads, scale, interpret=True, band=band)
    jax_svtr.set_gelu_approximate(False)
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in params.items()}
    got = svtr_block.fused_block(torch.from_numpy(x).to(tdt), tp, mask, heads, scale,
                                 band=band, gelu=svtr_block.GELU_TANH)
    poly = svtr_block.fused_block(torch.from_numpy(x).to(tdt), tp, mask, heads, scale,
                                  band=band)
    assert got.dtype == tdt and got.shape == x.shape
    return got.float().numpy(), np.asarray(ref).astype(np.float32), poly.float().numpy()


ROW4_CASES = [("Global", (4, 8), 2, 32), ("Local", (4, 8), 4, 32),
              ("Local-band", (8, 32), 2, 32)]


@pytest.mark.parametrize("mixer,hw,heads,c", ROW4_CASES)
def test_tanh_block_matches_pallas_f32(rng, mixer, hw, heads, c):
    if mixer == "Local-band":   # banding engages: qb 32, width 128 < N 256
        assert svtr_block._band_spec(*hw, 7, 11)[:2] == (32, 128)
    got, ref, poly = _row4_pair(rng, mixer, hw, heads, c, "f32")
    np.testing.assert_allclose(got, ref, atol=F32_TOL, rtol=F32_TOL)
    assert not np.allclose(poly, ref, atol=F32_TOL, rtol=F32_TOL)   # the form is seen


@pytest.mark.parametrize("mixer,hw,heads,c", ROW4_CASES)
def test_tanh_block_matches_pallas_bf16(rng, mixer, hw, heads, c):
    got, ref, _ = _row4_pair(rng, mixer, hw, heads, c, "bf16")
    np.testing.assert_allclose(got, ref, atol=BF16_ATOL, rtol=BF16_RTOL)


# ------------------------------------------------------------------ row 3
def _calibrated_block(rng, mixer, approx, hw=(4, 8), heads=2, c=32, batch=3):
    """A JAX Block's (x, perturbed variables, quant calibrated with the
    switch at ``approx``)."""
    kw = dict(dim=c, num_heads=heads, mixer=mixer, hw=hw, drop_path=0.0, col_major=True)
    x = rng.standard_normal((batch, hw[0] * hw[1], c)).astype(np.float32)
    v = JaxBlock(**kw).init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), train=False)
    v = {"params": _perturb(v["params"], rng, 0.05)}
    jax_svtr.set_gelu_approximate(approx)
    _, upd = JaxBlock(**kw, quant="calib").apply(v, jnp.asarray(x), train=False,
                                                  mutable=["quant"])
    jax_svtr.set_gelu_approximate(False)
    return x, v, jax.tree_util.tree_map(np.asarray, upd["quant"])


@pytest.mark.parametrize("mixer", ["Global", "Local"])
def test_calib_amax_under_switch_matches_jax(rng, mixer):
    """Calibration with the switch on: every amax within AMAX_RTOL of JAX's,
    and fc2's (recorded after the tanh GELU) off the erf calibration's."""
    x, v, jq = _calibrated_block(rng, mixer, True)
    blk = Block(32, 2, mixer, (4, 8), col_major=True, quant="calib")
    blk.load_state_dict(_tensors(v["params"]), strict=True)
    port_svtr.set_gelu_approximate(True)
    with torch.inference_mode():
        blk(torch.from_numpy(x))
    port_svtr.set_gelu_approximate(False)
    got = quant_tree(blk)
    assert sorted(got) == sorted(jq) and len(got) == 7
    for key in jq:
        np.testing.assert_allclose(got[key], jq[key], rtol=AMAX_RTOL, atol=0, err_msg=key)
    _, _, erf = _calibrated_block(np.random.default_rng(111), mixer, False)
    assert not np.allclose(erf["act_amax_fc2"], jq["act_amax_fc2"], rtol=AMAX_RTOL, atol=0)


@pytest.mark.parametrize("attn_int8", [False, True])
@pytest.mark.parametrize("mixer", ["Global", "Local"])
def test_tanh_int8_block_matches_pallas(rng, mixer, attn_int8):
    """Row 3's plain version in the tanh form against the Pallas int8 kernel
    under JAX's switch, the Block calibrated under it, on its own input."""
    x, v, jq = _calibrated_block(rng, mixer, True)
    qv = jax_int8.quantize_variables(dict(v, quant=jq))
    mask = jax_col_mask(4, 8) if mixer == "Local" else None
    scale = 16 ** -0.5
    jax_svtr.set_gelu_approximate(True)
    jax_svtr.set_attention_int8(attn_int8)
    try:
        ref = np.asarray(jax_block_ops.fused_block(jnp.asarray(x), qv["params"], mask, 2, scale,
                                                   interpret=True, quant=qv["quant"]))
    finally:
        jax_svtr.set_attention_int8(False)
        jax_svtr.set_gelu_approximate(False)
    weights = svtr_block.prepare_int8(_tensors(qv["params"]), _tensors(qv["quant"]))
    got = svtr_block.fused_block_int8(torch.from_numpy(x), weights, mask, 2, scale,
                                      attn_int8=attn_int8, gelu=svtr_block.GELU_TANH).numpy()
    np.testing.assert_allclose(got, ref, atol=BLOCK_TOL, rtol=BLOCK_TOL)
    poly = svtr_block.fused_block_int8(torch.from_numpy(x), weights, mask, 2, scale,
                                       attn_int8=attn_int8).numpy()
    assert not np.allclose(poly, ref, atol=BLOCK_TOL, rtol=BLOCK_TOL)


# ------------------------------------------------------- the served ensemble
COUNTS = (14, 20)
CHARS = list("abcdefghijklmnop")
IMG = (32, 128, 4)


def _scale_leaves(tree, name, factor):
    """``tree`` with every leaf called ``name`` times ``factor``."""
    if isinstance(tree, dict):
        return {k: (v * factor if k == name else _scale_leaves(v, name, factor))
                for k, v in tree.items()}
    return tree


def test_served_mrn_under_switch_matches_jax(rng):
    """A 2-expert SVTR-MRN of 4 narrow Blocks an expert (imgW 128: stage 1
    bands; the port's random trees in the JAX layout, fc1 kernels scaled so
    the GELU inputs are of order 1), served by the port with the switch on,
    against JAX's eval on its fused Pallas Blocks in interpret mode with
    JAX's switch on (the path of ``tests/test_torch_cli.py``'s int8 check),
    traced afresh: route picks equal, logits within float32 noise and ten
    times closer than the erf form's."""

    class NarrowSVTR(jax_svtr.SVTRExtractor):
        embed_dim: tuple = NARROW["embed_dim"]
        depth: tuple = NARROW["depth"]
        num_heads: tuple = NARROW["num_heads"]
        drop_path_rate: float = NARROW["drop_path_rate"]

    opt = load_config("configs/svtr_mrn.py", imgW=IMG[1], output_channel=32, hidden_size=16,
                      svtr=NARROW)
    params, stats = random_mrn(rng, opt, COUNTS)
    params = _scale_leaves(params, "fc1_kernel", 10.0)
    for key in ("channel_route", "route"):
        params[key]["kernel"] = rng.standard_normal(params[key]["kernel"].shape).astype(np.float32)
    images = rng.integers(0, 256, (4, *IMG), dtype=np.uint8)
    x = jnp.asarray((images.astype(np.float32) / 255.0 - 0.5) / 0.5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_composer, "SVTRExtractor", NarrowSVTR)
        mp.setattr(jax_block_ops, "fused_block",
                   functools.partial(jax_block_ops.fused_block, interpret=True))
        model = JaxMRNNet(n_experts=len(COUNTS), num_classes=COUNTS[-1], class_counts=COUNTS,
                          feature_extraction="SVTR", sequence_modeling="None",
                          output_channel=32, hidden_size=16, img_size=IMG[:2])
        jax_svtr.set_attention_impl("pallas")
        jax_svtr.set_gelu_approximate(True)
        out = jax.jit(lambda v, x: model.apply(v, x, cross=True, train=False, is_train=False))(
            {"params": params, "batch_stats": stats}, x)
        ref_logits, ref_index = np.asarray(out["logits"]), np.asarray(out["index"])
    srv = Server(opt, params, stats, CHARS, class_counts=COUNTS, device="cpu")
    port_svtr.set_gelu_approximate(True)
    got = srv.forward(images)
    port_svtr.set_gelu_approximate(False)
    erf = srv.forward(images)
    np.testing.assert_array_equal(got["index"].numpy(), ref_index)
    np.testing.assert_allclose(got["logits"].numpy(), ref_logits, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    gap = np.abs(got["logits"].numpy() - ref_logits).max()
    assert np.abs(erf["logits"].numpy() - ref_logits).max() > 10 * gap


# ------------------------------------------------------------ the scope
def test_composed_mlp_gelu_forms():
    """The composed Block MLP's GELU: the exact erf without the switch, the
    tanh form with it."""
    x = torch.linspace(-6.0, 6.0, 4001)
    assert torch.equal(port_svtr._mlp_gelu(x), torch.nn.functional.gelu(x))
    port_svtr.set_gelu_approximate(True)
    assert torch.equal(port_svtr._mlp_gelu(x), svtr_block.gelu_tanh(x))


def test_switch_scope(rng):
    """The switch is read at forward time and takes precedence over
    ``gelu_degree``; PatchEmbed's GELUs and the fused training Block ignore
    it."""
    c, hw = 32, (4, 8)
    blk = Block(c, 2, "Global", hw)
    blk.load_state_dict(_tensors(_block_params(rng, c)), strict=True)
    blk.gelu_degree = 15
    x = torch.from_numpy(rng.standard_normal((2, 32, c)).astype(np.float32))
    params = {k: getattr(blk, k) for k in svtr_train_block.PARAM_KEYS}
    with torch.no_grad():
        deg15 = blk(x)
        tanh = svtr_block.fused_block_reference(x, params, None, 2, blk.scale,
                                                gelu=svtr_block.GELU_TANH)
        port_svtr.set_gelu_approximate(True)
        assert torch.equal(blk(x), tanh) and not torch.equal(tanh, deg15)
        ones = torch.ones((2, 1))
        train_on = svtr_train_block.fused_block_train(x, params, ones, ones, num_heads=2,
                                                      scale=blk.scale, plain=True)
        embed = PatchEmbed(4, 16).eval()
        image = torch.from_numpy(rng.standard_normal((2, 16, 32, 4)).astype(np.float32))
        embed_on = embed(image)
        port_svtr.set_gelu_approximate(False)
        assert torch.equal(blk(x), deg15)
        train_off = svtr_train_block.fused_block_train(x, params, ones, ones, num_heads=2,
                                                       scale=blk.scale, plain=True)
        assert torch.equal(train_on, train_off) and torch.equal(embed(image), embed_on)
    with pytest.raises(ValueError):
        svtr_block.fused_block(x, params, None, 2, blk.scale, gelu=7)
