"""The tanh-GELU form (``models.svtr.set_gelu_approximate(True)``) of the
fused SVTR Block (row 4) and of the w8a8 Block (row 3) on the card, against
their plain versions, and the serving custom ops through ``torch.export``
on the card.  Needs a CUDA card; imports no JAX, so it also runs without
the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_gelu_tanh.py
"""

import types
from unittest import mock

import numpy as np
import pytest
import torch

from chip_smoke import INT8_FLIP_MAX, INT8_NOISE, float_products_q8, int8_block
from mrn_tpu_torch.config import load_config
from mrn_tpu_torch.export_cli import export_inference
from mrn_tpu_torch.models import svtr as port_svtr
from mrn_tpu_torch.models.init import random_recognizer
from mrn_tpu_torch.models.svtr import (Block, local_attention_mask,
                                       local_attention_mask_col_major)
from mrn_tpu_torch.ops import svtr_block
from mrn_tpu_torch.serve import Server

# tests/test_torch_cuda_block.py's: float32 summation order and the CUDA
# exp / rsqrt / tanhf ulps; bfloat16 a flipped rounding (a few bf16 ulps)
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (5e-2, 2e-2)}
# the w8a8 Block: tests/test_torch_cuda_block_int8.py's flip check (a
# float32 ulp can move an activation across a .5 boundary of its int8
# rounding), with chip_smoke.py's noise and largest error
SMALL_BATCH_FLIP_SHARE = 0.05


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda", 0)
    port_svtr.set_gelu_approximate(False)


def _params(rng, c, device, dt):
    hidden = 4 * c
    shapes = dict(norm1_scale=(c,), norm1_bias=(c,), qkv_kernel=(c, 3 * c),
                  qkv_bias=(3 * c,), proj_kernel=(c, c), proj_bias=(c,),
                  norm2_scale=(c,), norm2_bias=(c,), fc1_kernel=(c, hidden),
                  fc1_bias=(hidden,), fc2_kernel=(hidden, c), fc2_bias=(c,))
    out = {}
    for name, shape in shapes.items():
        base = 1.0 if "norm" in name else 0.0
        # fc1 wide enough that the GELU inputs span the tanh form's range
        std = 0.1 if "norm" in name or "bias" in name else 0.2 if name == "fc1_kernel" else 0.05
        val = base + std * rng.standard_normal(shape)
        out[name] = torch.from_numpy(val.astype(np.float32)).to(device, dt)
    return out


SHAPES = [("Global", (3, 8), 64, 8, 3),        # N=24: a partial query tile, d=8
          ("Local", (4, 8), 32, 2, 3),         # the full [N, N] mask
          ("Local-band", (8, 64), 64, 2, 4),   # stage 1: qb 128, width 256
          ("Local-band", (4, 64), 128, 4, 4),  # stage 2: qb 64, width 128
          ("Global", (2, 64), 256, 8, 4)]      # stage 3


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mixer,hw,c,heads,batch", SHAPES)
def test_tanh_kernel_matches_plain(device, dt, mixer, hw, c, heads, batch):
    rng = np.random.default_rng(17)
    n = hw[0] * hw[1]
    params = _params(rng, c, device, dt)
    x = torch.from_numpy(rng.standard_normal((batch, n, c)).astype(np.float32)).to(device, dt)
    mask = band = None
    if mixer == "Local":
        mask = local_attention_mask(*hw)
    elif mixer == "Local-band":
        mask = local_attention_mask_col_major(*hw)
        band = (hw[0], hw[1], 7, 11)
    scale = (c // heads) ** -0.5
    before = svtr_block.launches
    tanh = svtr_block.GELU_TANH
    got = svtr_block.fused_block(x, params, mask, heads, scale, band=band, gelu=tanh)
    again = svtr_block.fused_block(x, params, mask, heads, scale, band=band, gelu=tanh)
    poly = svtr_block.fused_block(x, params, mask, heads, scale, band=band)
    torch.cuda.synchronize()
    assert svtr_block.launches == before + 3
    assert torch.equal(got, again)
    ref = svtr_block.fused_block_reference(x, params, mask, heads, scale, band=band, gelu=tanh)
    atol, rtol = TOL[dt]
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)
    if dt == torch.float32:   # the form is seen: the degree-9 kernel fails the check
        assert not torch.allclose(poly, ref, atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("attn_int8", [False, True])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mixer,hw,c,heads,batch", [("Global", (3, 12), 64, 8, 5),
                                                    ("Local", (8, 64), 64, 2, 16),
                                                    ("Local", (4, 64), 128, 4, 16),
                                                    ("Global", (2, 64), 256, 8, 16)])
def test_tanh_int8_kernel_matches_plain(device, attn_int8, dt, mixer, hw, c, heads, batch):
    """A Block calibrated and served with the switch on: the kernel against
    the plain version, beside the float-products control, which must fail;
    two launches bitwise equal."""
    rng = np.random.default_rng(19)
    n = hw[0] * hw[1]
    x32 = torch.from_numpy(rng.standard_normal((batch, n, c)).astype(np.float32)).to(device)
    port_svtr.set_gelu_approximate(True)
    blk = int8_block(rng, c, heads, mixer, hw, x32, device, dt)
    blk.attn_int8 = attn_int8
    x = x32.to(dt)
    with torch.inference_mode():
        before = svtr_block.int8_launches
        got, again = blk(x), blk(x)
        torch.cuda.synchronize()
        assert svtr_block.int8_launches == before + 2
        blk.plain = True
        ref = blk(x)
        with mock.patch.object(svtr_block, "_q8", float_products_q8):
            control = blk(x)
        direct = svtr_block.fused_block_int8_reference(x, blk.int8_weights, blk.mask, heads,
                                                       blk.scale, attn_int8, svtr_block.GELU_TANH)
    assert torch.equal(got, again) and torch.equal(ref, direct)
    atol, rtol = INT8_NOISE[dt]

    def share_beyond_noise(out):
        return float(((out.float() - ref.float()).abs()
                      > atol + rtol * ref.float().abs()).float().mean())

    assert bool(torch.isfinite(got.float()).all())
    assert share_beyond_noise(got) <= SMALL_BATCH_FLIP_SHARE
    assert float((got.float() - ref.float()).abs().max()) <= \
        INT8_FLIP_MAX * float(ref.float().abs().max())
    assert share_beyond_noise(control) > SMALL_BATCH_FLIP_SHARE


@pytest.mark.cuda
def test_block_reads_switch_at_forward_time(device):
    rng = np.random.default_rng(23)
    blk = Block(64, 2, "Local", (8, 64), col_major=True)
    with torch.no_grad():
        for k, v in _params(rng, 64, "cpu", torch.float32).items():
            getattr(blk, k).copy_(v)
    blk = blk.to(device).eval()
    x = torch.from_numpy(rng.standard_normal((4, 512, 64)).astype(np.float32)).to(device)
    params = {k: getattr(blk, k) for k in svtr_block.PARAM_KEYS}
    with torch.inference_mode():
        port_svtr.set_gelu_approximate(True)
        on = blk(x)
        port_svtr.set_gelu_approximate(False)
        off = blk(x)
        tanh = svtr_block.fused_block(x, params, blk.mask, 2, blk.scale, band=blk.band,
                                      gelu=svtr_block.GELU_TANH)
    assert torch.equal(on, tanh) and not torch.equal(on, off)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_exported_program_on_the_card_equals_eager(device, dtype, tmp_path):
    """A narrow SVTR recognizer exported on the card: the loaded program
    launches the kernels (one row-4 launch per Block) and its logits equal
    the eager model's bitwise (the same kernels on the same operands in
    the same order)."""
    rng = np.random.default_rng(29)
    opt = load_config("configs/svtr_mrn.py", imgW=128, output_channel=32, hidden_size=16,
                      svtr=dict(embed_dim=(16, 32, 64), depth=(1, 2, 1), num_heads=(2, 2, 4)))
    params, stats = random_recognizer(rng, opt, 12)
    srv = Server(opt, params, stats, list("abcdefgh"), device=device)
    learner = types.SimpleNamespace(opt=opt, model=srv.model, _cur_task=0,
                                    converter=srv.converter, device=device)
    program, _ = export_inference(learner, opt, 8, dtype)
    torch.export.save(program, str(tmp_path / "svtr.pt2"))
    module = torch.export.load(str(tmp_path / "svtr.pt2")).module()
    x = torch.from_numpy(rng.standard_normal((8, 32, 128, 4)).astype(np.float32)).to(device)
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    with torch.inference_mode():
        before = svtr_block.launches
        got = module(x)
        torch.cuda.synchronize()
        assert svtr_block.launches == before + 4
        eager = srv.model.to(dt)(x.to(dt))["predict"].float()
    assert torch.equal(got, eager)
