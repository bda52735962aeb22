"""The SVTR training attention CUDA kernels (full and banded) against their
plain PyTorch versions, on the card, at small and ragged shapes.  Needs a
CUDA card; imports no JAX, so it also runs without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_attention.py
"""

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
