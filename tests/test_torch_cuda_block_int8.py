"""The w8a8 SVTR Block CUDA kernel against its plain PyTorch version, on the
card: small ragged shapes and the full-width shapes of SVTR's stages at batch
64, Global and Local (full mask), float32 and bfloat16, float and int8
attention, each Block calibrated on its input and quantized first; two
launches must be bitwise equal, and the plain version with float products
(``chip_smoke.float_products_q8``) must fail the check (the Blocks, the
float noise and the largest error are ``chip_smoke.py``'s).  Needs a CUDA card; imports no JAX, so it also runs
without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_block_int8.py
"""

import numpy as np
import pytest
import torch

from unittest import mock

from chip_smoke import INT8_FLIP_MAX, INT8_NOISE, float_products_q8, int8_block
from mrn_tpu_torch.ops import svtr_block

# chip_smoke.py bounds the share of elements a rounding flip moves at batch
# 256 (INT8_FLIP_SHARE); here a batch is 3 to 64 images, and one flipped
# image is 1.6-33% of the elements.  Measured on an H100 at batch 16: up to
# 2.7% moved.
SMALL_BATCH_FLIP_SHARE = 0.05


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("attn_int8", [False, True])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mixer,hw,c,heads,batch", [
    ("Global", (3, 12), 64, 8, 5),       # N=36: a partial query tile, d=8
    ("Local", (4, 8), 32, 2, 3),         # full [N, N] mask, d=16
    ("Local", (8, 64), 64, 2, 64),       # stage 1: N=512, d=32
    ("Global", (2, 64), 256, 8, 64),     # stage 3: hidden 1024
])
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
    assert got.dtype == dt and got.shape == x.shape
    assert torch.equal(got, again), "two launches differ"
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
def test_int8_kernel_rejects_what_it_does_not_take(device):
    rng = np.random.default_rng(0)
    x32 = torch.from_numpy(rng.standard_normal((2, 30, 32)).astype(np.float32)).to(device)
    blk = int8_block(rng, 32, 2, "Global", (3, 10), x32, device, torch.float32)
    blk.attn_int8 = True           # N = 30: int8 attention needs N % 4 == 0
    with pytest.raises(ValueError):
        blk(x32)
    with pytest.raises(TypeError):
        blk.to(torch.float16)(x32.half())
