"""The int8 conv's card route (``ops.int8.conv_int8``: an int8 im2col
through ``torch._int_mm``) against its plain version (an exact float64
conv) bitwise, at every kernel, stride and padding of the VGG, ResNet and
RCNN convs (K padded to a multiple of 8 where it is not one), over several
batch chunks, with ``_int_mm``'s shape limits raising; and one w8a8
``TorchConv`` on the card against the same module on the CPU, bitwise.
Needs a CUDA card; imports no JAX, so it also runs without the repo's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_int8_conv.py
"""

import numpy as np
import pytest
import torch

from mrn_tpu_torch.models.common import TorchConv
from mrn_tpu_torch.ops import int8

# (kernel, stride, padding, cin, cout, H, W): the VGG, ResNet and RCNN conv
# geometries at full width, small spatial sizes
SHAPES = {
    "VGG conv0 (K = 36 -> 40)": ((3, 3), (1, 1), (1, 1), 4, 64, 32, 64),
    "VGG conv5 (K = 4608)": ((3, 3), (1, 1), (1, 1), 512, 512, 4, 16),
    "VGG conv6": ((2, 2), (1, 1), (0, 0), 512, 512, 2, 16),
    "ResNet conv4_1": ((2, 2), (2, 1), (0, 1), 512, 512, 4, 17),
    "ResNet down_conv / GRCL gate": ((1, 1), (1, 1), (0, 0), 256, 512, 4, 17),
    "GRCL wr_x": ((3, 3), (1, 1), (1, 1), 64, 64, 16, 32),
}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHAPES))
def test_int_mm_conv_equals_the_float64_conv(device, name, monkeypatch):
    kernel, stride, padding, cin, cout, h, w = SHAPES[name]
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-127, 128, (5, h, w, cin), generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (*kernel, cin, cout), generator=g, dtype=torch.int8)
    ref = int8.conv_int8_reference(x.to(device), wq.to(device), stride, padding)
    before = int8.int_mm_convs
    got = int8.conv_int8(x.to(device), wq.to(device), stride, padding)
    assert int8.int_mm_convs == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, ref)
    assert torch.equal(got.cpu(), int8.conv_int8(x, wq, stride, padding))
    # the fewest images a chunk that keep more than 16 rows
    monkeypatch.setattr(int8, "IM2COL_BYTES", 1)
    assert torch.equal(int8.conv_int8(x.to(device), wq.to(device), stride, padding), ref)


@pytest.mark.cuda
def test_int_mm_limits_raise(device):
    x = torch.zeros((1, 4, 4, 8), dtype=torch.int8, device=device)
    with pytest.raises(ValueError, match="out % 8"):
        int8.conv_int8(x, torch.zeros((1, 1, 8, 12), dtype=torch.int8, device=device))
    with pytest.raises(ValueError, match="more than 16 rows"):
        int8.conv_int8(x, torch.zeros((1, 1, 8, 8), dtype=torch.int8, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [False, True])
def test_w8a8_torch_conv_on_the_card_equals_the_cpu(device, bias):
    """Quantize, the integer conv and the epilogue: IEEE operations on the
    same values, so the card's output equals the CPU's bit for bit."""
    rng = np.random.default_rng(1)
    conv = TorchConv(64, 128, (3, 3), padding=(1, 1), bias=bias, quant="int8")
    w = torch.from_numpy(rng.standard_normal((3, 3, 64, 128)).astype(np.float32))
    wq, scale = int8.quantize_kernel(w)
    state = {"Conv_0.weight": wq.permute(3, 2, 0, 1).contiguous(), "w_scale": scale,
             "act_amax": torch.tensor(2.5)}
    if bias:
        state["Conv_0.bias"] = torch.from_numpy(rng.standard_normal(128).astype(np.float32))
    conv.load_state_dict(state, strict=True)
    x = torch.from_numpy(rng.standard_normal((8, 64, 8, 32)).astype(np.float32))
    with torch.no_grad():
        cpu = conv(x)
        card = conv.to(device)(x.to(device))
    assert torch.equal(card.cpu(), cpu)
