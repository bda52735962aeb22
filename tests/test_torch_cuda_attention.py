"""The SVTR training attention CUDA kernels (full and banded) against their
plain PyTorch versions, on the card, at small and ragged shapes.  Needs a
CUDA card; imports no JAX, so it also runs without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_attention.py
"""

import re

import numpy as np
import pytest
import torch

from mrn_tpu_torch.models.svtr import (local_attention_mask,
                                       local_attention_mask_col_major)
from mrn_tpu_torch.ops import svtr_attention as attn

# float32: summation order and the CUDA exp ulps; bfloat16: a P rounding
# flipped by a float32 ulp, and the output rounding (one bf16 ulp at |o| < 2)
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1.6e-2, 1e-2)}
# dq/dk/dv through the autograd Functions: the same plain backward on both
# sides, fed forwards that differ by the tolerance above
GRAD_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (5e-2, 5e-2)}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _qkv(rng, b, h, n, d, device, dt, requires_grad=False):
    out = []
    for _ in range(3):
        t = torch.from_numpy(rng.standard_normal((b, h, n, d)).astype(np.float32))
        t = t.to(device, dt)
        out.append(t.requires_grad_(requires_grad))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,hw,heads,d", [
    ("Global", (3, 8), 2, 8),        # N=24: one partial query tile
    ("Global", (2, 40), 3, 16),      # N=80: ragged last tile
    ("Global", (2, 64), 4, 32),      # stage-3 geometry
    ("Global", (4, 16), 2, 64),
    ("Local", (4, 8), 2, 32),        # masked full attention (no band plan)
    ("Local-band", (8, 32), 2, 32),  # banded: qb 32, width 128
    ("Local-band", (8, 64), 2, 32),  # banded: qb 128, width 256
    ("Local-band", (4, 64), 2, 32),  # banded: qb 64, width 128
])
def test_kernel_matches_plain(device, dt, kind, hw, heads, d):
    rng = np.random.default_rng(11)
    n = hw[0] * hw[1]
    q, k, v = _qkv(rng, 3, heads, n, d, device, dt)
    mask = band = None
    if kind == "Local":
        mask = torch.from_numpy(local_attention_mask(*hw)).to(device)
    elif kind == "Local-band":
        band = (hw[0], hw[1], 7, 11)
    key = "banded" if band else "full"
    before = attn.launches[key]
    with torch.no_grad():
        got = attn.mha_small_n(q, k, v, mask, band=band)
        torch.cuda.synchronize()
        assert attn.launches[key] == before + 1
        if band:
            ref = attn.banded_attention_reference(q, k, v, band)
            full = attn.attention_reference(
                q, k, v, torch.from_numpy(local_attention_mask_col_major(*hw)).to(device))
        else:
            ref = full = attn.attention_reference(q, k, v, mask)
    assert got.dtype == dt and got.shape == q.shape
    atol, rtol = TOL[dt]
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(got.float(), full.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("band", [None, (4, 64, 7, 11)])
def test_grads_through_functions(device, dt, band):
    """The autograd Functions launch the kernel forward and take the plain
    backward; the same Functions forced plain give the same grads."""
    rng = np.random.default_rng(12)
    shape = (2, 2, 256, 32)
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dt)
    grads = []
    for plain in (False, True):
        q, k, v = _qkv(np.random.default_rng(13), *shape, device, dt, True)
        out = attn.mha_small_n(q, k, v, band=band, plain=plain)
        grads.append(torch.autograd.grad(out, (q, k, v), g))
    atol, rtol = GRAD_TOL[dt]
    for a, b in zip(*grads):
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(device, monkeypatch):
    q, k, v = (torch.zeros((1, 2, 64, 32), device=device, dtype=torch.float16)
               for _ in range(3))
    with pytest.raises(TypeError):
        attn.attention_forward(q, k, v)
    q, k, v = (torch.zeros((1, 2, 64, 48), device=device) for _ in range(3))
    with pytest.raises(ValueError, match="head_dim"):
        attn.attention_forward(q, k, v)
    q, k, v = (torch.zeros((1, 2, 64, 32), device=device) for _ in range(3))
    with pytest.raises(ValueError, match="contiguous"):
        attn.attention_forward(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="no plan"):
        attn.banded_attention_forward(q, k, v, (8, 8, 7, 11))
    # a plan whose query blocks are not a multiple of the 32-row query tile
    q, k, v = (torch.zeros((1, 2, 256, 32), device=device) for _ in range(3))
    plan = attn._band_spec(4, 64, 7, 11)
    monkeypatch.setattr(attn, "_band_spec", lambda *band: (48,) + plan[1:])
    with pytest.raises(ValueError, match="multiple"):
        attn.banded_attention_forward(q, k, v, (4, 64, 7, 11))


def _mask(kind, hw, n, rng, device):
    if kind == "local":
        return torch.from_numpy(local_attention_mask(*hw)).to(device)
    if kind == "random":   # a finite additive mask
        return torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)).to(device)
    return None


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,d,mask_kind", [
    ((3, 8), 8, None),          # N=24: one partial 16-row tile, D padded to 16
    ((5, 5), 32, "local"),      # N=25: odd width, scalar mask loads
    ((2, 40), 16, "random"),    # N=80: key tiles beyond the window
    ((5, 40), 32, "local"),     # N=200: two query spans, partial key pair
    ((5, 40), 64, None),
    ((8, 64), 32, None),        # N=512: two key segments
    ((8, 64), 32, "local"),
    ((8, 64), 64, "random"),
    ((8, 64), 8, None),
])
def test_full_kernel_ragged_shapes(device, dt, hw, d, mask_kind):
    """Full attention at query spans, key windows and head dims that do not
    fill the kernel's tiles, against the plain version."""
    rng = np.random.default_rng(14)
    n = hw[0] * hw[1]
    q, k, v = _qkv(rng, 2, 3, n, d, device, dt)
    mask = _mask(mask_kind, hw, n, rng, device)
    with torch.no_grad():
        got = attn.attention_forward(q, k, v, mask)
        ref = attn.attention_reference(q, k, v, mask)
    atol, rtol = TOL[dt]
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("band,d", [((8, 32, 7, 11), 8),     # qb 32
                                    ((8, 32, 7, 11), 64),
                                    ((4, 64, 7, 11), 16)])   # qb 64
def test_banded_kernel_head_dims(device, dt, band, d):
    rng = np.random.default_rng(15)
    q, k, v = _qkv(rng, 2, 2, band[0] * band[1], d, device, dt)
    with torch.no_grad():
        got = attn.banded_attention_forward(q, k, v, band)
        ref = attn.banded_attention_reference(q, k, v, band)
    atol, rtol = TOL[dt]
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,band,mask_kind", [(256, None, None), (512, None, "random"),
                                              (512, (8, 64, 7, 11), None),
                                              (256, (4, 64, 7, 11), None)])
def test_two_launches_bitwise_equal(device, dt, n, band, mask_kind):
    """No atomics: the same inputs give the same bits."""
    rng = np.random.default_rng(16)
    q, k, v = _qkv(rng, 4, 2, n, 32, device, dt)
    mask = _mask(mask_kind, None, n, rng, device)
    with torch.no_grad():
        if band:
            outs = [attn.banded_attention_forward(q, k, v, band) for _ in range(2)]
        else:
            outs = [attn.attention_forward(q, k, v, mask) for _ in range(2)]
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_views_at_unaligned_offsets(device, dt):
    """Contiguous views whose data is not 16-byte aligned are taken (the
    kernel stages rows with 16-byte copies)."""
    rng = np.random.default_rng(17)
    shape = (2, 2, 80, 16)
    q, k, v = (torch.from_numpy(rng.standard_normal(int(np.prod(shape)) + 1)
                                .astype(np.float32)).to(device, dt)[1:].view(shape)
               for _ in range(3))
    assert q.data_ptr() % 16 and q.is_contiguous()
    with torch.no_grad():
        got = attn.attention_forward(q, k, v)
        ref = attn.attention_reference(q, k, v)
    atol, rtol = TOL[dt]
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


# (n, qb, width) of every call the card runs: the four SVTR training shapes,
# the full windows of these tests and of int8 calibration (N 24..512) and
# the band plans with qb 32, 64 and 128
_PLAN_CASES = ([(n, n, n) for n in (24, 25, 64, 80, 128, 200, 256, 512)]
               + [(b[0] * b[1],) + attn._band_spec(*b)[:2]
                  for b in ((8, 64, 7, 11), (4, 64, 7, 11), (8, 32, 7, 11))])
_MAX_SMEM = 232448   # 227 KB, the most shared memory a block may opt into


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,qb,width", _PLAN_CASES)
def test_kernel_plan_fits_and_keeps_band_blocks_whole(device, dt, n, qb, width):
    """The library's launch plan (``svtr_attention_plan``) fits in shared
    memory, keeps a block's query rows inside one band query block, covers
    the window with its key segments, and takes one pass over the keys
    exactly for windows of 128 or 256 keys, which include every SVTR
    training shape."""
    for d in (8, 16, 32, 64):
        span, key_tiles, segments, passes, smem = attn._kernel_plan(dt, n, d, qb, width)
        assert smem <= _MAX_SMEM
        assert span <= 128 and (qb == n or qb % span == 0)
        assert segments * 8 * key_tiles >= width
        assert (passes == 1) == (width in (128, 256)) and passes in (1, 3)
        assert passes == 3 or (segments == 1 and 8 * key_tiles == width)


def _sass_functions():
    """{function name: SASS text} of the built attention library."""
    from mrn_tpu_torch.ops import _build

    return _build.sass("svtr_attention")


@pytest.mark.cuda
def test_bf16_kernel_runs_on_tensor_cores(device):
    """The bf16 kernels' SASS has tensor-core products (HMMA, or HGMMA for
    warpgroup MMA); the float32 kernels stay on the CUDA cores."""
    funcs = {name: body for name, body in _sass_functions().items()
             if "attention_tc_" in name}
    bf16 = {n: b for n, b in funcs.items() if "13__nv_bfloat16" in n}
    f32 = {n: b for n, b in funcs.items() if n not in bf16}
    # 4 head dims x (one pass over 128 or 256 keys, or three passes)
    assert len(bf16) == len(f32) == 12, sorted(funcs)
    for name, body in bf16.items():
        assert re.search(r"\bH(G)?MMA\b", body), f"{name}: no HMMA/HGMMA"
    for name, body in f32.items():
        assert not re.search(r"\bH(G)?MMA\b", body), f"{name}: tensor-core products in float32"
        assert "FFMA" in body
