"""The fused SVTR Block CUDA kernel against its plain PyTorch version, on
the card, at small and ragged shapes (head dims 8-64, partial query tiles,
full-mask and banded Local, unmasked Global).  Needs a CUDA card; imports no
JAX, so it also runs without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_block.py
"""

import numpy as np
import pytest
import torch

from mrn_tpu_torch.models.svtr import (local_attention_mask,
                                       local_attention_mask_col_major)
from mrn_tpu_torch.ops import svtr_block

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
