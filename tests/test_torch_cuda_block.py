"""The fused SVTR Block CUDA kernel against its plain PyTorch version, on
the card, at small and ragged shapes (head dims 8-64, partial query tiles,
full-mask and banded Local, unmasked Global).  Needs a CUDA card; imports no
JAX, so it also runs without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_block.py
"""

import re

import numpy as np
import pytest
import torch

from mrn_tpu_torch.models.svtr import (local_attention_mask,
                                       local_attention_mask_col_major)
from mrn_tpu_torch.ops import _build, svtr_block

# float32: summation order and CUDA exp/rsqrt ulps only; bfloat16: a flipped
# rounding of an intermediate or of the output (a few bf16 ulps)
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (5e-2, 2e-2)}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _params(rng, c, device, dt):
    hidden = 4 * c
    shapes = dict(norm1_scale=(c,), norm1_bias=(c,), qkv_kernel=(c, 3 * c),
                  qkv_bias=(3 * c,), proj_kernel=(c, c), proj_bias=(c,),
                  norm2_scale=(c,), norm2_bias=(c,), fc1_kernel=(c, hidden),
                  fc1_bias=(hidden,), fc2_kernel=(hidden, c), fc2_bias=(c,))
    out = {}
    for name, shape in shapes.items():
        base = 1.0 if "norm" in name else 0.0
        std = 0.1 if "norm" in name or "bias" in name else 0.05
        val = base + std * rng.standard_normal(shape)
        out[name] = torch.from_numpy(val.astype(np.float32)).to(device, dt)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mixer,hw,c,heads", [
    ("Global", (3, 8), 64, 8),      # N=24: one partial query tile, d=8
    ("Global", (2, 40), 64, 4),     # N=80: ragged last tile, d=16
    ("Global", (2, 64), 256, 8),    # d=32
    ("Global", (4, 16), 128, 2),    # d=64
    ("Local", (4, 8), 32, 2),       # full [N, N] mask (no band plan)
    ("Local-band", (8, 32), 64, 2),  # banded: qb 32, width 128
    ("Local-band", (8, 64), 64, 2),  # banded: qb 128, width 256
])
def test_kernel_matches_plain(device, dt, mixer, hw, c, heads):
    rng = np.random.default_rng(7)
    n = hw[0] * hw[1]
    params = _params(rng, c, device, dt)
    x = torch.from_numpy(rng.standard_normal((3, n, c)).astype(np.float32)).to(device, dt)
    band = None
    mask = None
    if mixer == "Local":
        mask = local_attention_mask(*hw)
    elif mixer == "Local-band":
        mask = local_attention_mask_col_major(*hw)
        band = (hw[0], hw[1], 7, 11)
    scale = (c // heads) ** -0.5
    for degree in (9, 15):
        before = svtr_block.launches
        got = svtr_block.fused_block(x, params, mask, heads, scale, band=band,
                                     gelu_degree=degree)
        torch.cuda.synchronize()
        assert svtr_block.launches == before + 1
        ref = svtr_block.fused_block_reference(x, params, mask, heads, scale,
                                               band=band, gelu_degree=degree)
        atol, rtol = TOL[dt]
        torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_kernel_rejects_unsupported_dtype(device):
    rng = np.random.default_rng(0)
    params = _params(rng, 32, device, torch.float16)
    x = torch.zeros((1, 8, 32), device=device, dtype=torch.float16)
    with pytest.raises(TypeError):
        svtr_block.fused_block(x, params, None, 2, 0.25)


# The four Block shapes of SVTR (imgW 256): (grid (h, w), C, heads, Local);
# the Local ones banded (stage 1: qb 128, width 256; stage 2: qb 64, width 128)
MAIN_SHAPES = [((8, 64), 64, 2, True), ((4, 64), 128, 4, True),
               ((4, 64), 128, 4, False), ((2, 64), 256, 8, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,c,heads,local", MAIN_SHAPES)
def test_two_launches_bitwise_equal(device, dt, hw, c, heads, local):
    """No split-K and no atomics: the same inputs give the same bits, and
    the main-path plan takes the one-pass attention kernel."""
    rng = np.random.default_rng(3)
    n = hw[0] * hw[1]
    params = _params(rng, c, device, dt)
    x = torch.from_numpy(rng.standard_normal((4, n, c)).astype(np.float32)).to(device, dt)
    mask = local_attention_mask_col_major(*hw) if local else None
    band = (hw[0], hw[1], 7, 11) if local else None
    scale = (c // heads) ** -0.5
    cache = svtr_block.FoldCache()
    first = svtr_block.fused_block(x, params, mask, heads, scale, band=band, cache=cache)
    torch.cuda.synchronize()
    second = svtr_block.fused_block(x, params, mask, heads, scale, band=band, cache=cache)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    plan = svtr_block._Plan(n, mask, band, device)
    assert (plan.qb, plan.width) == ((128, 256) if c == 64 else (64, 128) if local else (n, n))
    kplan = svtr_block._kernel_plan(dt, n, c, heads, 4 * c, plan.qb, plan.width)
    assert kplan[2:4] == (1, 1) and 8 * kplan[1] == plan.width   # one segment, one pass
    ref = svtr_block.fused_block_reference(x, params, mask, heads, scale, band=band)
    atol, rtol = TOL[dt]
    torch.testing.assert_close(first.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("local", [False, True])
def test_clamped_scores_match_plain(device, dt, local):
    """Scores past SCORE_CLAMP: p = exp(60) ~ 1.1e26 for many keys of a row
    (the bf16 P fragments and the float32 PV sums hold it), against the
    plain version."""
    rng = np.random.default_rng(13)
    hw, c, heads = ((4, 64), 128, 4) if local else ((2, 64), 256, 8)
    n = hw[0] * hw[1]
    params = _params(rng, c, device, torch.float32)
    params["qkv_kernel"][:, :2 * c] *= 25.0      # large q and k
    params = {k: v.to(dt) for k, v in params.items()}
    x = torch.from_numpy(rng.standard_normal((4, n, c)).astype(np.float32)).to(device, dt)
    mask = local_attention_mask_col_major(*hw) if local else None
    band = (hw[0], hw[1], 7, 11) if local else None
    scale = (c // heads) ** -0.5
    # the plain path's scores reach the clamp
    w = svtr_block._fold(params, scale, dt)
    qkv = (svtr_block._ln_bare(x.float()) @ w[0].float() + w[1]).to(dt).float()
    q, k = (qkv[..., i * c:(i + 1) * c].view(4, n, heads, c // heads).transpose(1, 2)
            for i in (0, 1))
    top = float((q @ k.transpose(-1, -2)).max())
    assert top > 2 * svtr_block.SCORE_CLAMP, top
    got = svtr_block.fused_block(x, params, mask, heads, scale, band=band)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    ref = svtr_block.fused_block_reference(x, params, mask, heads, scale, band=band)
    atol, rtol = TOL[dt]
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_bf16_kernels_run_on_tensor_cores(device):
    """The bf16 forms of the Block's projections and attention have
    tensor-core products (HMMA, or HGMMA for warpgroup MMA) in their SASS;
    the float32 forms stay on the CUDA cores."""
    funcs = {name: body for name, body in _build.sass("svtr_block").items()
             if "proj_kernel" in name or "attention_tc_" in name}
    bf16 = {n: b for n, b in funcs.items() if "13__nv_bfloat16" in n}
    f32 = {n: b for n, b in funcs.items() if n not in bf16}
    # projections: 4 x 2 tile widths; attention: 4 head dims
    # x (one pass over 128 or 256 keys, or segments)
    assert sum("proj_kernel" in n for n in bf16) == 8, sorted(funcs)
    assert sum("proj_kernel" in n for n in f32) == 8, sorted(funcs)
    assert sum("attention_tc_" in n for n in bf16) == sum("attention_tc_" in n for n in f32) == 12
    for name, body in bf16.items():
        assert re.search(r"\bH(G)?MMA\b", body), f"{name}: no HMMA/HGMMA"
    for name, body in f32.items():
        assert not re.search(r"\bH(G)?MMA\b", body), f"{name}: tensor-core products in float32"
        assert "FFMA" in body
