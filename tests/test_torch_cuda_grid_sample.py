"""The TPS warp CUDA kernel against its plain PyTorch version, on the card:
the TRBA shape and odd shapes (any B, H, W, C, Ho, Wo), random grids beyond
[-1, 1] and the identity grid, float32 and bfloat16 images, and an image
whose pixels are not 16-byte aligned (the kernel's channel-loop form).
Needs a CUDA card; imports no JAX, so it also runs without the repo's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_grid_sample.py
"""

import numpy as np
import pytest
import torch

from mrn_tpu_torch.ops import grid_sample

# the same IEEE float32 operations in the same order (the kernel's are
# rounded, never contracted): float32 ulps; a bfloat16 image rounds the same
# float32 value once, so one bf16 ulp at most
TOL = {torch.float32: (1e-6, 1e-6), torch.bfloat16: (0.0, 2.0 ** -7)}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _grid(kind, b, ho, wo, rng, device):
    if kind == "random":
        g = rng.uniform(-1.3, 1.3, (b, ho, wo, 2))
    else:
        xs, ys = np.linspace(-1, 1, wo), np.linspace(-1, 1, ho)
        g = np.broadcast_to(np.stack(np.meshgrid(xs, ys), -1), (b, ho, wo, 2))
    return torch.tensor(g, dtype=torch.float32, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["random", "identity"])
@pytest.mark.parametrize("shape,out", [
    ((256, 32, 256, 4), (32, 256)),   # the TRBA warp
    ((3, 7, 10, 4), (5, 9)),          # no Pallas tiling
    ((2, 5, 6, 3), (4, 7)),           # C = 3: the channel loop
    ((1, 32, 100, 1), (16, 300)),     # C = 1, upsampled width
])
def test_kernel_matches_plain(device, dt, kind, shape, out):
    rng = np.random.default_rng(11)
    img = torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=device).to(dt)
    grid = _grid(kind, shape[0], *out, rng, device)
    before = grid_sample.launches
    got = grid_sample.grid_sample(img, grid)
    torch.cuda.synchronize()
    assert grid_sample.launches == before + 1
    assert got.dtype == dt and tuple(got.shape) == (shape[0], *out, shape[3])
    ref = grid_sample.grid_sample_reference(img, grid)
    atol, rtol = TOL[dt]
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_unaligned_image_takes_the_channel_loop(device, dt):
    """C = 4 at an image address that is not a multiple of 4 elements."""
    rng = np.random.default_rng(12)
    shape = (4, 8, 12, 4)
    flat = torch.tensor(rng.standard_normal(int(np.prod(shape)) + 1), dtype=torch.float32,
                        device=device).to(dt)
    img = flat[1:].view(shape)
    assert img.is_contiguous() and img.data_ptr() % (4 * img.element_size())
    grid = _grid("random", 4, 6, 9, rng, device)
    got = grid_sample.grid_sample(img, grid)
    torch.cuda.synchronize()
    atol, rtol = TOL[dt]
    torch.testing.assert_close(got.float(), grid_sample.grid_sample_reference(img, grid).float(),
                               atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(device):
    img = torch.zeros((2, 6, 9, 4), device=device)
    grid = torch.zeros((2, 4, 5, 2), device=device)
    with pytest.raises(TypeError, match="float32"):
        grid_sample.grid_sample(img, grid.to(torch.bfloat16))
    with pytest.raises(TypeError):
        grid_sample.grid_sample(img.to(torch.float16), grid)
    with pytest.raises(ValueError, match="contiguous"):
        grid_sample.grid_sample(img.transpose(1, 2), grid)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_tps_warps_on_the_kernel_in_eval_mode_and_differentiably_in_train_mode(device, dt):
    """TRBA's TPS at 32x256: an eval-mode forward launches the kernel once,
    a train-mode forward none (the training warp, which equals the kernel's
    output on the same grid and gives the localization net a gradient)."""
    from mrn_tpu_torch.models.tps import TPSTransformer

    torch.manual_seed(0)
    model = TPSTransformer(20, (32, 256), 4).to(device)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    model.to(dt)
    img = torch.randn((8, 32, 256, 4), device=device).to(dt)
    before = grid_sample.launches
    with torch.no_grad():
        grid = model.grid(img)
        out_eval = model(img)
    torch.cuda.synchronize()
    assert grid_sample.launches == before + 1
    out_train = grid_sample.grid_sample_train(img, grid)
    atol, rtol = TOL[dt]
    torch.testing.assert_close(out_eval.float(), out_train.float(), atol=atol, rtol=rtol)
    before = grid_sample.launches
    out = model(img, train=True)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert grid_sample.launches == before
    grad = model.localization.localization_fc2.kernel.grad
    assert bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0
