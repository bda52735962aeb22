"""Port modules against their JAX counterparts under bridged weights, eval
mode, float32 on the CPU.  The JAX side runs its composed path (exact-erf
GELU, max-subtract softmax); the port runs its fused Block's plain version
with the degree-15 erf fit (|erf err| < 1.9e-7) so the two agree to float32
noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mrn_tpu.models.svtr as jax_svtr
from mrn_tpu.models.composer import Recognizer as JaxRecognizer
from mrn_tpu.models.router import DMRouter as JaxDMRouter
from mrn_tpu.models.svtr import SVTRExtractor as JaxSVTRExtractor
from mrn_tpu_torch.bridge import from_flax, recognizer_state
from mrn_tpu_torch.models.composer import Recognizer
from mrn_tpu_torch.models.router import DMRouter
from mrn_tpu_torch.models.svtr import DropPath, SVTRExtractor, configure_blocks

# 12 pre-norm Blocks deep: float32 summation order plus the residual
# erf-fit error (degree 15) and the clamp-exp vs max-subtract softmax.
EXTRACTOR_TOL = 1e-4
ROUTER_TOL = 1e-5


@pytest.fixture(autouse=True)
def xla_impl():
    jax_svtr.set_attention_impl("xla")
    yield
    jax_svtr.set_attention_impl("auto")


def perturb(variables, rng):
    """Move every leaf off its init value (BN variances stay positive) so
    that a leaf bridged to the wrong place shows."""
    def f(path, leaf):
        leaf = np.asarray(leaf)
        noise = 0.05 * rng.standard_normal(leaf.shape).astype(np.float32)
        if path[-1].key == "var":
            return np.abs(leaf + noise) + 0.5
        return leaf + noise
    return jax.tree_util.tree_map_with_path(f, variables)


def _to_port(module, variables):
    module.load_state_dict(from_flax(variables["params"],
                                     variables.get("batch_stats")), strict=True)
    configure_blocks(module, gelu_degree=15)
    return module.eval()


def test_svtr_extractor_matches_jax(rng):
    cfg = dict(out_channels=24, img_size=(32, 128), embed_dim=(16, 32, 64),
               depth=(2, 3, 2), num_heads=(2, 2, 4))
    jm = JaxSVTRExtractor(**cfg)
    x = rng.standard_normal((2, 32, 128, 4)).astype(np.float32)
    v = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), train=False)
    v = perturb(v, rng)
    ref = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    port = _to_port(SVTRExtractor(in_channels=4, **cfg), v)
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 1, 32, 24)
    np.testing.assert_allclose(got, ref, atol=EXTRACTOR_TOL, rtol=EXTRACTOR_TOL)


def test_recognizer_matches_jax(rng):
    jm = JaxRecognizer(num_classes=11, feature_extraction="SVTR",
                       sequence_modeling="None", output_channel=24,
                       hidden_size=16, img_size=(32, 64))
    x = rng.standard_normal((2, 32, 64, 4)).astype(np.float32)
    v = jax.jit(lambda k: jm.init({"params": k}, jnp.asarray(x), train=False))(
        jax.random.PRNGKey(1))
    v = perturb(v, rng)
    ref = jm.apply(v, jnp.asarray(x), train=False)
    port = _to_port(Recognizer(11, output_channel=24, hidden_size=16,
                               img_size=(32, 64)), v)
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    for key in ("predict", "feature"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   atol=EXTRACTOR_TOL, rtol=EXTRACTOR_TOL)


def test_dm_router_matches_jax(rng):
    b, i, t, c = 3, 3, 8, 16
    jm = JaxDMRouter(channel=c, d_ffn=2 * c, patch=t, domain=i)
    x = rng.standard_normal((b, i, t, c)).astype(np.float32)
    v = perturb(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)), rng)
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    port = DMRouter(c, 2 * c, t, i)
    port.load_state_dict(recognizer_state(v["params"]), strict=True)
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=ROUTER_TOL, rtol=ROUTER_TOL)


def test_bridge_layouts(rng):
    """Conv kernels HWIO -> OIHW, Block leaves and Dense kernels [in, out]
    unchanged, stage Blocks into ModuleList slots, BN stats beside params."""
    params = {"extractor": {"feature": {
        "patch_embed": {"conv1": {"kernel": rng.standard_normal((3, 3, 4, 8)),
                                  "bias": np.zeros(8)},
                        "bn1": {"scale": np.ones(8), "bias": np.zeros(8)}},
        "blocks2_5": {"qkv_kernel": rng.standard_normal((4, 12))}},
        "seq_linear": {"kernel": rng.standard_normal((5, 3))}}}
    stats = {"extractor": {"feature": {"patch_embed": {"bn1": {
        "mean": np.arange(8.0), "var": np.ones(8)}}}}}
    state = from_flax(params, stats)
    conv = state["extractor.feature.patch_embed.conv1.weight"].numpy()
    np.testing.assert_array_equal(
        conv, params["extractor"]["feature"]["patch_embed"]["conv1"]["kernel"]
        .transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        state["extractor.feature.blocks2.5.qkv_kernel"].numpy(),
        params["extractor"]["feature"]["blocks2_5"]["qkv_kernel"])
    np.testing.assert_array_equal(state["extractor.seq_linear.kernel"].numpy(),
                                  params["extractor"]["seq_linear"]["kernel"])
    np.testing.assert_array_equal(
        state["extractor.feature.patch_embed.bn1.mean"].numpy(), np.arange(8.0))


def test_unsupported_stage_combination_raises():
    with pytest.raises(NotImplementedError):
        Recognizer(10, feature_extraction="VGG", sequence_modeling="BiLSTM")


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_droppath_keeps_one_minus_rate_and_rescales(rate):
    """Per-image keep masks from a seeded generator: about 1 - rate of the
    images kept, each scaled by 1 / keep, the rest zero; the same seed gives
    the same masks; eval mode and rate 0 are the identity."""
    n = 4000
    x = torch.ones((n, 3, 2))
    dp = DropPath(rate)
    dp.generator = torch.Generator().manual_seed(5)
    y = dp(x, train=True)
    per_image = y[:, 0, 0]
    kept = per_image != 0
    keep = 1.0 - rate
    assert abs(float(kept.float().mean()) - keep) < 4 * np.sqrt(keep * rate / n)
    torch.testing.assert_close(per_image[kept], torch.full((int(kept.sum()),), 1.0 / keep))
    assert bool((y == y[:, :1, :1]).all())          # one decision per image
    dp.generator = torch.Generator().manual_seed(5)
    torch.testing.assert_close(dp(x, train=True), y, atol=0, rtol=0)
    assert dp(x, train=False) is x
    assert DropPath(0.0)(x, train=True) is x
