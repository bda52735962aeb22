"""The port's plain TPS warp (``ops.grid_sample.grid_sample_reference``,
the CUDA kernel's arithmetic) against the JAX package's Pallas kernel in
interpret mode and its gather form, on seeded grids that cross the border
(clamped taps) and on the identity grid (taps within float32 ulps of
integer pixels, ``fx = 0`` exactly at the last column); float32 and
bfloat16 images, float32 grids."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrn_tpu.ops.grid_sample import grid_sample_gather, grid_sample_pallas
from mrn_tpu_torch.ops import grid_sample as port

# float32: the same taps and weights; XLA's CPU dot may fuse a tap's
# product into the sum (one float32 rounding), so allow a few ulps of
# values of order 1
F32_TOL = 1e-6
# identity grid against the image itself: linspace coordinates in float32
# land within a few float32 ulps of an integer pixel (W * 2^-23 at most), so
# a tap can take up to ~1e-5 of its neighbour (|neighbour - tap| < 8)
IDENTITY_TOL = 1e-4
# bfloat16 image: both round the same float32 value once, so they differ
# only where the float32 values sit on either side of a rounding boundary:
# one bf16 ulp (at most 2^-7 of the value)
BF16_RTOL = 2.0 ** -7

# (image [B, H, W, C], output (Ho, Wo)): the first two tile the Pallas
# kernel (row_block 4, batch_block 4); the third does not (the JAX kernel
# would fall back to its einsum form), the port has no tiling limit
SHAPES = [((4, 8, 16, 4), (8, 12)), ((4, 32, 64, 4), (32, 64)), ((3, 7, 10, 3), (5, 9))]


def _grid(kind, b, ho, wo, rng):
    if kind == "random":
        return rng.uniform(-1.3, 1.3, (b, ho, wo, 2)).astype(np.float32)
    xs, ys = np.linspace(-1, 1, wo), np.linspace(-1, 1, ho)
    return np.broadcast_to(np.stack(np.meshgrid(xs, ys), -1), (b, ho, wo, 2)).astype(np.float32)


def _tiles(b, ho):
    return b % 4 == 0 and ho % 4 == 0


@pytest.mark.parametrize("kind", ["random", "identity"])
@pytest.mark.parametrize("shape,out", SHAPES, ids=["8x16", "32x64", "odd"])
def test_plain_matches_pallas_and_gather_f32(kind, shape, out):
    rng = np.random.default_rng(3)
    img = rng.standard_normal(shape).astype(np.float32)
    grid = _grid(kind, shape[0], *out, rng)
    got = port.grid_sample_reference(torch.from_numpy(img), torch.from_numpy(grid)).numpy()
    gather = np.asarray(grid_sample_gather(jnp.asarray(img), jnp.asarray(grid)))
    np.testing.assert_allclose(got, gather, atol=F32_TOL, rtol=F32_TOL)
    if _tiles(shape[0], out[0]):
        pallas = np.asarray(grid_sample_pallas(jnp.asarray(img), jnp.asarray(grid), row_block=4,
                                               batch_block=4, interpret=True))
        np.testing.assert_allclose(got, pallas, atol=F32_TOL, rtol=F32_TOL)
    if kind == "identity" and out == shape[1:3]:
        np.testing.assert_allclose(got, img, atol=IDENTITY_TOL, rtol=0)


@pytest.mark.parametrize("shape,out", SHAPES[1:], ids=["32x64", "odd"])
def test_plain_matches_pallas_bf16_image(shape, out):
    """bfloat16 image, float32 grid: float32 arithmetic, one rounding."""
    rng = np.random.default_rng(4)
    img = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    grid = _grid("random", shape[0], *out, rng)
    img_t = torch.tensor(np.asarray(img.astype(jnp.float32))).to(torch.bfloat16)
    got = port.grid_sample_reference(img_t, torch.from_numpy(grid))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    # the gather form promotes to float32: round it to bfloat16 once
    ref = np.asarray(grid_sample_gather(img, jnp.asarray(grid)).astype(jnp.bfloat16)
                     .astype(jnp.float32))
    np.testing.assert_allclose(got, ref, atol=0, rtol=BF16_RTOL)
    if _tiles(shape[0], out[0]):
        pallas = grid_sample_pallas(img, jnp.asarray(grid), row_block=4, batch_block=4,
                                    interpret=True)
        assert pallas.dtype == jnp.bfloat16
        np.testing.assert_allclose(got, np.asarray(pallas.astype(jnp.float32)), atol=0,
                                   rtol=BF16_RTOL)


def test_wrapper_runs_plain_version_on_cpu():
    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.standard_normal((2, 6, 9, 4)).astype(np.float32))
    grid = torch.from_numpy(_grid("random", 2, 4, 5, rng))
    before = port.launches
    torch.testing.assert_close(port.grid_sample(img, grid),
                               port.grid_sample_reference(img, grid), atol=0, rtol=0)
    assert port.launches == before


def test_wrapper_refuses_what_the_kernel_does_not_take():
    img = torch.zeros((2, 6, 9, 4))
    with pytest.raises(TypeError, match="float32"):
        port.grid_sample(img, torch.zeros((2, 4, 5, 2), dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        port.grid_sample(img, torch.zeros((3, 4, 5, 2)))
    with pytest.raises(ValueError, match="device"):
        port.grid_sample(img.to("meta"), torch.zeros((2, 4, 5, 2), device="meta"))
