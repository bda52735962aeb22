"""The port's fused SVTR Block (plain version, CPU) against the JAX Pallas
kernel run in interpret mode, on the same seeded inputs and weights."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrn_tpu.models.svtr import (local_attention_mask as jax_local_mask,
                                 local_attention_mask_col_major as jax_col_mask)
from mrn_tpu.ops import svtr_block as jax_block
from mrn_tpu_torch.models.svtr import (local_attention_mask,
                                       local_attention_mask_col_major)
from mrn_tpu_torch.ops import svtr_block

F32_TOL = 2e-5
# bf16: both sides round at the same points, so they differ only where a
# float32 summation-order ulp flips a bf16 rounding: allow one output ulp
# at |out| < 8 (2^-5) plus 1% relative.
BF16_ATOL, BF16_RTOL = 2 ** -5, 1e-2


def _block_params(rng, c):
    """Block leaves with non-trivial LN affine (exercises the host fold)."""
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


def _run_both(rng, mixer, hw, heads, c, degree, monkeypatch, dt="float32"):
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
    if degree == 15:
        monkeypatch.setenv("SVTR_GELU_DEG", "15")
    jdt = jnp.float32 if dt == "float32" else jnp.bfloat16
    tdt = torch.float32 if dt == "float32" else torch.bfloat16
    jp = {k: jnp.asarray(v, jdt) for k, v in params.items()}
    ref = jax_block.fused_block(jnp.asarray(x, jdt), jp, mask, heads, scale,
                                interpret=True, band=band)
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in params.items()}
    got = svtr_block.fused_block(torch.from_numpy(x).to(tdt), tp, mask, heads,
                                 scale, band=band, gelu_degree=degree)
    assert got.dtype == tdt and got.shape == x.shape
    return got.float().numpy(), np.asarray(ref).astype(np.float32)


@pytest.mark.parametrize("degree", [9, 15])
@pytest.mark.parametrize("mixer,hw,heads,c", [
    ("Global", (4, 8), 2, 32),
    ("Local", (4, 8), 4, 32),
    ("Local-band", (8, 32), 2, 32),
])
def test_fused_block_matches_jax_f32(rng, mixer, hw, heads, c, degree,
                                     monkeypatch):
    if mixer == "Local-band":  # banding engages: qb 32, width 128 < N 256
        assert svtr_block._band_spec(*hw, 7, 11)[:2] == (32, 128)
    got, ref = _run_both(rng, mixer, hw, heads, c, degree, monkeypatch)
    np.testing.assert_allclose(got, ref, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("mixer,hw,heads,c", [
    ("Global", (4, 8), 2, 32),
    ("Local-band", (8, 32), 2, 32),
])
def test_fused_block_matches_jax_bf16(rng, mixer, hw, heads, c, monkeypatch):
    got, ref = _run_both(rng, mixer, hw, heads, c, 9, monkeypatch, dt="bfloat16")
    np.testing.assert_allclose(got, ref, atol=BF16_ATOL, rtol=BF16_RTOL)


@pytest.mark.parametrize("hw", [(8, 64), (4, 64), (8, 32), (4, 8)])
def test_band_spec_matches_jax(hw):
    ours = svtr_block._band_spec(*hw, 7, 11)
    theirs = jax_block._band_spec(*hw, 7, 11)
    if theirs is None:
        assert ours is None
        return
    assert ours[:3] == theirs[:3]
    np.testing.assert_array_equal(ours[3], theirs[3])


def test_band_plans_of_svtr_stages():
    assert svtr_block._band_spec(8, 64, 7, 11)[:2] == (128, 256)
    assert svtr_block._band_spec(4, 64, 7, 11)[:2] == (64, 128)


@pytest.mark.parametrize("hw", [(4, 8), (8, 32)])
def test_local_masks_match_jax(hw):
    np.testing.assert_array_equal(local_attention_mask(*hw), jax_local_mask(*hw))
    np.testing.assert_array_equal(local_attention_mask_col_major(*hw),
                                  jax_col_mask(*hw))


@pytest.mark.parametrize("degree", [9, 15])
def test_erf_poly_matches_jax(degree):
    z = np.linspace(-6.0, 6.0, 4001, dtype=np.float32)
    coefs = svtr_block._GELU_COEFS[degree]
    jcoefs = jax_block._ERF9_COEFS if degree == 9 else jax_block._ERF_COEFS
    assert coefs == jcoefs
    got = svtr_block._erf_poly(torch.from_numpy(z), coefs).numpy()
    ref = np.asarray(jax_block._erf_poly(jnp.asarray(z), jcoefs))
    np.testing.assert_allclose(got, ref, atol=1e-7, rtol=0)


def test_cpu_tensor_takes_plain_version_and_counts_nothing(rng):
    params = {k: torch.from_numpy(v) for k, v in _block_params(rng, 32).items()}
    x = torch.from_numpy(rng.standard_normal((1, 32, 32)).astype(np.float32))
    before = svtr_block.launches
    out = svtr_block.fused_block(x, params, None, 2, 0.25)
    ref = svtr_block.fused_block_reference(x, params, None, 2, 0.25)
    assert svtr_block.launches == before
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


def test_unsupported_device_raises(rng):
    params = {k: torch.from_numpy(v).to("meta")
              for k, v in _block_params(rng, 32).items()}
    x = torch.empty((1, 32, 32), device="meta")
    with pytest.raises(ValueError):
        svtr_block.fused_block(x, params, None, 2, 0.25)


# ------------------------------------------------ folded weights, once per set
def _cpu_block(rng, c=32, heads=2, hw=(4, 8)):
    from mrn_tpu_torch.models.svtr import Block

    blk = Block(c, heads, "Global", hw).eval()
    with torch.no_grad():
        for key, val in _block_params(rng, c).items():
            getattr(blk, key).copy_(torch.from_numpy(val))
    x = torch.from_numpy(rng.standard_normal((2, hw[0] * hw[1], c)).astype(np.float32))
    return blk, x


def _leaves(blk):
    return {k: getattr(blk, k) for k in svtr_block.PARAM_KEYS}


def _assert_fresh(blk, x, params=None):
    """The Block's cached operands are bitwise a fresh ``_fold`` of the
    weights it ran with, and its output is the plain version's."""
    params = _leaves(blk) if params is None else params
    fresh = svtr_block._fold(params, blk.scale, x.dtype)
    cached = blk.fold_cache.weights
    assert len(cached) == len(fresh)
    for a, b in zip(cached, fresh):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_fold_cache_matches_fresh_fold(rng):
    blk, x = _cpu_block(rng)
    with torch.no_grad():
        for key in ("norm1_scale", "norm1_bias", "norm2_scale", "norm2_bias"):
            getattr(blk, key).add_(0.1)   # a non-trivial LN affine to fold
        out = blk(x)
    _assert_fresh(blk, x)
    ref = svtr_block.fused_block_reference(x, _leaves(blk), None, blk.num_heads, blk.scale)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


def test_fold_cache_folds_once_for_unchanged_weights(rng):
    blk, x = _cpu_block(rng)
    with torch.no_grad():
        first = blk(x)
        before = svtr_block.folds
        second = blk(x)
        with torch.inference_mode():
            third = blk(x)
    assert svtr_block.folds == before
    torch.testing.assert_close(second, first, atol=0, rtol=0)
    torch.testing.assert_close(third, first, atol=0, rtol=0)


@pytest.mark.parametrize("change", ["add_", "data_swap", "load_state_dict", "module_to",
                                    "functional_call"])
def test_fold_cache_sees_weight_changes(rng, change):
    """Each way the port changes a Block's weights folds anew: the cached
    operands equal a fresh fold of the new weights and the output the plain
    version's on them."""
    blk, x = _cpu_block(rng)
    with torch.no_grad():
        blk(x)
    stale = [t.clone() for t in blk.fold_cache.weights]
    params = None
    with torch.no_grad():
        if change == "add_":
            blk.qkv_kernel.add_(0.01)
        elif change == "data_swap":
            blk.fc1_kernel.data = blk.fc1_kernel.data.to(torch.bfloat16)
        elif change == "load_state_dict":
            state = {k: v + 0.01 if v.is_floating_point() else v
                     for k, v in blk.state_dict().items()}
            blk.load_state_dict(state)
        elif change == "module_to":
            blk.to(torch.bfloat16)
            x = x.to(torch.bfloat16)
        before = svtr_block.folds
        if change == "functional_call":
            params = {k: v + 0.01 for k, v in _leaves(blk).items()}
            out = torch.func.functional_call(blk, params, (x,))
        else:
            out = blk(x)
    assert svtr_block.folds == before + 1
    assert any(a.dtype != b.dtype or not torch.equal(a, b)
               for a, b in zip(blk.fold_cache.weights, stale))
    _assert_fresh(blk, x, params)
    ref = svtr_block.fused_block_reference(x, params or _leaves(blk), None, blk.num_heads,
                                           blk.scale)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    if change == "functional_call":   # back on its own weights: folded again
        with torch.no_grad():
            blk(x)
        _assert_fresh(blk, x)


def test_warm_request_runs_no_fold():
    """A warm serving request (an MRN ensemble of SVTR experts on the CPU)
    runs ``_fold`` zero times: every Block folded its weights at the first
    request."""
    from mrn_tpu_torch.config import load_config
    from mrn_tpu_torch.models.init import random_mrn
    from mrn_tpu_torch.serve import Server

    opt = load_config("configs/svtr_mrn.py", imgW=64, output_channel=32, hidden_size=16,
                      svtr=dict(embed_dim=(16, 32, 64), depth=(1, 1, 1),
                                num_heads=(2, 2, 4)))
    counts = (8, 12)
    rng = np.random.default_rng(3)
    params, stats = random_mrn(rng, opt, counts)
    chars = [chr(0x61 + i) for i in range(max(counts) - 4)]
    srv = Server(opt, params, stats, chars, class_counts=counts, device="cpu")
    images = rng.integers(0, 256, (2, opt.imgH, opt.imgW, opt.input_channel), dtype=np.uint8)
    before = svtr_block.folds
    first = srv.recognize(images)
    assert svtr_block.folds - before == 3 * len(counts)   # one per Block
    before = svtr_block.folds
    second = srv.recognize(images)
    assert svtr_block.folds == before
    assert first == second
