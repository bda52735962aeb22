"""The w8a8 SVTR Block CUDA kernel against its plain PyTorch version, on the
card: small and ragged shapes and the full-width shapes of SVTR's stages at
batch 16-64 -- Global with N a multiple of 128 or not (one key segment or
three passes over two), Local banded (N 512 at qb 128 / width 256, N 256 at
qb 64 / width 128) and Local over its full mask -- head dims 8 to 64,
float32 and bfloat16, float and int8 attention, each Block calibrated on its
input and quantized first; two launches must be bitwise equal, and the plain
version with float products (``chip_smoke.float_products_q8``) must fail the
check (the Blocks, the float noise and the largest error are
``chip_smoke.py``'s).  The SASS test finds the int8 tensor-core products
(IMMA) in the projections and the int8 attention, bf16 ones (HMMA) in the
bf16 float attention, and no SIMT int8 dot product (IDP4A) anywhere.  Needs
a CUDA card; imports no JAX, so it also runs without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_block_int8.py
"""

import re

import numpy as np
import pytest
import torch

from unittest import mock

from chip_smoke import INT8_FLIP_MAX, INT8_NOISE, float_products_q8, int8_block
from mrn_tpu_torch.ops import _build, svtr_block

# chip_smoke.py bounds the share of elements a rounding flip moves at batch
# 256 (INT8_FLIP_SHARE); here a batch is 2 to 64 images, and one flipped
# image is 1.6-50% of the elements.  Measured on an H100 at batch 16: up to
# 2.7% moved.
SMALL_BATCH_FLIP_SHARE = 0.05

SHAPES = [
    # (mixer, grid (h, w), C, heads, batch)
    ("Global", (3, 12), 64, 8, 5),       # N=36: a partial query tile, d=8
    ("Global", (3, 10), 32, 2, 3),       # N=30, not a multiple of 4, d=16
    ("Local", (4, 8), 32, 2, 3),         # no band plan: the full [N, N] mask, d=16
    ("Global", (5, 40), 64, 4, 4),       # N=200: one key segment, not a multiple of 128
    ("Global", (3, 100), 64, 2, 2),      # N=300: three passes over two key segments
    ("Global", (4, 16), 128, 2, 8),      # d=64
    ("Local", (8, 64), 64, 2, 64),       # stage 1: N=512 banded, qb 128 / width 256, d=32
    ("Local", (4, 64), 128, 4, 16),      # stage 2: N=256 banded, qb 64 / width 128
    ("Global", (2, 64), 256, 8, 64),     # stage 3: hidden 1024
]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _check(got, ref, control, dt, x):
    """The int8 check of chip_smoke.py at a small batch, with its control."""
    assert got.dtype == dt and got.shape == x.shape
    assert bool(torch.isfinite(got.float()).all())
    atol, rtol = INT8_NOISE[dt]          # the float noise of chip_smoke.py, reasons there

    def share_beyond_noise(out):
        return float(((out.float() - ref.float()).abs()
                      > atol + rtol * ref.float().abs()).float().mean())

    assert share_beyond_noise(got) <= SMALL_BATCH_FLIP_SHARE
    assert float((got.float() - ref.float()).abs().max()) <= \
        INT8_FLIP_MAX * float(ref.float().abs().max())
    assert share_beyond_noise(control) > SMALL_BATCH_FLIP_SHARE


@pytest.mark.cuda
@pytest.mark.parametrize("attn_int8", [False, True])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mixer,hw,c,heads,batch", SHAPES)
def test_int8_kernel_matches_plain(device, attn_int8, dt, mixer, hw, c, heads, batch):
    rng = np.random.default_rng(11)
    n = hw[0] * hw[1]
    x32 = torch.from_numpy(rng.standard_normal((batch, n, c)).astype(np.float32)).to(device)
    blk = int8_block(rng, c, heads, mixer, hw, x32, device, dt)
    blk.attn_int8 = attn_int8
    x = x32.to(dt)
    with torch.inference_mode():
        before = svtr_block.int8_launches
        got = blk(x)
        again = blk(x)
        torch.cuda.synchronize()
        assert svtr_block.int8_launches == before + 2
        blk.plain = True
        ref = blk(x)
        with mock.patch.object(svtr_block, "_q8", float_products_q8):
            control = blk(x)
    assert torch.equal(got, again), "two launches differ"
    _check(got, ref, control, dt, x)


@pytest.mark.cuda
@pytest.mark.parametrize("attn_int8", [False, True])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,c,heads,qb,width", [((8, 64), 64, 2, 128, 256),
                                                 ((4, 64), 128, 4, 64, 128)])
def test_local_blocks_band_and_full_mask_agree(device, attn_int8, dt, hw, c, heads, qb, width):
    """A served Local Block attends banded (its plan engages at SVTR's two
    Local shapes); the same kernel over the full mask (no band) agrees with
    the plain version too."""
    rng = np.random.default_rng(5)
    n = hw[0] * hw[1]
    x32 = torch.from_numpy(rng.standard_normal((16, n, c)).astype(np.float32)).to(device)
    blk = int8_block(rng, c, heads, "Local", hw, x32, device, dt)
    plan = svtr_block._Plan(n, blk.mask, blk.band, device)
    assert (plan.qb, plan.width) == (qb, width)
    assert svtr_block._int8_kernel_plan(dt, attn_int8, n, c, heads, 4 * c, qb, width)[0] == qb
    x = x32.to(dt)
    w, args = blk.int8_weights, (blk.mask, heads, blk.scale)
    kw = dict(attn_int8=attn_int8, gelu=blk.gelu_degree)
    with torch.inference_mode():
        banded = svtr_block.fused_block_int8(x, w, *args, band=blk.band, **kw)
        full = svtr_block.fused_block_int8(x, w, *args, **kw)
        ref = svtr_block.fused_block_int8_reference(x, w, *args, **kw)
        with mock.patch.object(svtr_block, "_q8", float_products_q8):
            control = svtr_block.fused_block_int8_reference(x, w, *args, **kw)
    _check(banded, ref, control, dt, x)
    _check(full, ref, control, dt, x)


@pytest.mark.cuda
def test_int8_kernel_rejects_what_it_does_not_take(device):
    rng = np.random.default_rng(0)
    x32 = torch.from_numpy(rng.standard_normal((2, 30, 40)).astype(np.float32)).to(device)
    blk = int8_block(rng, 40, 5, "Global", (3, 10), x32, device, torch.float32)
    with pytest.raises(ValueError):    # C = 40: the kernel takes multiples of 16
        blk(x32)
    x32 = torch.from_numpy(rng.standard_normal((2, 30, 32)).astype(np.float32)).to(device)
    blk = int8_block(rng, 32, 2, "Global", (3, 10), x32, device, torch.float32)
    with pytest.raises(TypeError):
        blk.to(torch.float16)(x32.half())


@pytest.mark.cuda
def test_int8_block_runs_on_tensor_cores(device):
    """Every projection form (f32 and bf16) and the int8 attention multiply
    on the int8 tensor cores (IMMA); the bf16 float attention on the bf16
    ones (HMMA), the f32 float attention on the CUDA cores; no IDP4A."""
    funcs = _build.sass("svtr_block_int8")
    assert not [n for n, b in funcs.items() if re.search(r"\bIDP4A\b", b)]
    proj = {n: b for n, b in funcs.items() if "proj_i8_kernel" in n}
    attn8 = {n: b for n, b in funcs.items() if "attention_i8_kernel" in n}
    attn = {n: b for n, b in funcs.items() if "attention_tc_" in n}
    bf16 = {n: b for n, b in attn.items() if "13__nv_bfloat16" in n}
    # projections, each at 2 tile widths: qkv in 2 dtypes x 2 attention
    # modes, proj and fc2 in 2 dtypes, fc1 in one (it reads float32 x1 and
    # writes int8 g); int8 attention: 4 head dims x 2 key-tile counts; float
    # attention: 4 head dims x 3 kernel forms per dtype
    assert len(proj) == 18 and len(attn8) == 8, sorted(funcs)
    assert len(attn) == 24 and len(bf16) == 12, sorted(funcs)
    for name, body in {**proj, **attn8}.items():
        assert re.search(r"\bIMMA\b", body), f"{name}: no IMMA"
    for name, body in attn.items():
        has_hmma = bool(re.search(r"\bH(G)?MMA\b", body))
        assert has_hmma == (name in bf16), f"{name}: HMMA {has_hmma}"
