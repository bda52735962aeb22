"""The port's TPS transformer against the JAX package's, eval mode, on the
CPU: the host constants exactly, then the grid and the warped image of
``TPSTransformer`` under bridged, perturbed weights, with the JAX warp run
through the Pallas kernel in interpret mode (patched in here; the JAX
package's CPU dispatch would gather)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mrn_tpu.models.tps as jax_tps
from mrn_tpu.ops.grid_sample import grid_sample_pallas
from mrn_tpu_torch.bridge import recognizer_state
from mrn_tpu_torch.models import tps

IMG = (4, 32, 64, 4)
# grid: the fiducials agree to ~1e-6, but the two 23-term float32 products
# cancel terms far larger than the result (|inv_delta_C| up to 17.6,
# |P_hat| up to 8), so each framework's grid is ~6e-5 from the float64
# product of its own fiducials, in its own summation order (measured on
# the CPU: JAX 5.5e-5, the port 6.3e-5)
GRID_TOL = 2e-4
# the warp itself, on the same grid: the same taps and weights, float32 ulps
WARP_TOL = 1e-6


@pytest.mark.parametrize("f", [4, 20])
@pytest.mark.parametrize("size", [(32, 64), (32, 256)])
def test_host_constants_equal_jax(f, size):
    C = tps.build_C(f)
    np.testing.assert_array_equal(C, jax_tps.build_C(f))
    np.testing.assert_array_equal(tps.build_inv_delta_C(f, C), jax_tps.build_inv_delta_C(f, C))
    np.testing.assert_array_equal(tps.build_P_hat(f, C, size), jax_tps.build_P_hat(f, C, size))
    np.testing.assert_array_equal(tps._fc2_bias(f), jax_tps._fc2_bias(f))


def _perturb(variables, rng):
    """Every leaf off its init value (variances stay positive); the zero
    ``localization_fc2`` kernel becomes small and random, so that each crop
    gets its own grid with fractional taps and clamped borders."""
    def f(path, leaf):
        leaf = np.asarray(leaf)
        noise = 0.05 * rng.standard_normal(leaf.shape).astype(np.float32)
        if path[-1].key == "var":
            return np.abs(leaf + noise) + 0.5
        return leaf + noise
    return jax.tree_util.tree_map_with_path(f, variables)


@pytest.fixture(scope="module")
def jax_tps_run():
    """JAX TPSTransformer (eval) with its warp through the Pallas kernel in
    interpret mode: variables, image, the grid it sampled and its output."""
    rng = np.random.default_rng(9)
    model = jax_tps.TPSTransformer(num_fiducial=20, out_size=IMG[1:3])
    x = rng.standard_normal(IMG).astype(np.float32)
    v = model.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    v = _perturb(v, rng)
    grids = []

    def pallas_warp(image, grid, inference=False):
        assert inference
        grids.append(grid)
        return grid_sample_pallas(image, grid.astype(jnp.float32), row_block=4,
                                  batch_block=4, interpret=True)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_tps, "grid_sample", pallas_warp)
    try:
        out = model.apply(v, jnp.asarray(x), train=False)
    finally:
        mp.undo()
    return dict(variables=v, x=x, grid=np.asarray(grids[0]), out=np.asarray(out))


def _port(run, dtype=torch.float32):
    m = tps.TPSTransformer(20, IMG[1:3], IMG[3])
    v = run["variables"]
    m.load_state_dict(recognizer_state(v["params"], v["batch_stats"]), strict=True)
    return m.to(dtype).eval()


def test_tps_matches_jax_eval(jax_tps_run):
    m = _port(jax_tps_run)
    x = torch.from_numpy(jax_tps_run["x"])
    grid = jax_tps_run["grid"]
    # the perturbed fiducials give each crop its own grid, fractional taps
    # and clamped borders
    assert np.abs(grid).max() > 1.0 and np.ptp(grid[:, ..., 0], axis=0).max() > 1e-2
    with torch.inference_mode():
        got_grid = m.grid(x)
        out = m(x)
    assert got_grid.dtype == torch.float32
    np.testing.assert_allclose(got_grid.numpy(), grid, atol=GRID_TOL, rtol=0)
    # the port's warp on JAX's grid: float32 noise only
    warped = tps.grid_sample(x, torch.tensor(grid))
    np.testing.assert_allclose(warped.numpy(), jax_tps_run["out"], atol=WARP_TOL, rtol=WARP_TOL)
    # end to end: a coordinate GRID_TOL apart moves a tap by GRID_TOL * (size
    # - 1) / 2 pixels, which changes the output by that share of the largest
    # difference between neighbouring pixels
    step = max(np.abs(np.diff(jax_tps_run["x"], axis=a)).max() for a in (1, 2))
    tol = GRID_TOL * (max(IMG[1:3]) - 1) / 2 * step
    np.testing.assert_allclose(out.numpy(), jax_tps_run["out"], atol=tol, rtol=0)


def test_grid_stays_float32_under_bf16(jax_tps_run):
    """``Module.to(bfloat16)`` casts the weights but not the TPS constants;
    the grid is float32 from bf16 fiducials, the warped image bf16.  The
    grid's distance from the float32 model's is that of bf16 fiducials
    (2^-8 relative through the 23-term products), far below a pixel."""
    m = _port(jax_tps_run, torch.bfloat16)
    assert m.P_hat.dtype == m.inv_delta_C.dtype == torch.float32
    x = torch.from_numpy(jax_tps_run["x"]).to(torch.bfloat16)
    with torch.inference_mode():
        grid = m.grid(x)
        out = m(x)
    assert grid.dtype == torch.float32 and out.dtype == torch.bfloat16
    np.testing.assert_allclose(grid.numpy(), jax_tps_run["grid"], atol=0.1, rtol=0)
