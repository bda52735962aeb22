"""The port's fused SVTR training Block (``mrn_tpu_torch/ops/svtr_train_block``)
against the JAX package's (``mrn_tpu/ops/svtr_train_block``), on the CPU, from
the same seeded inputs: the plain forward, backward tail and head against the
Pallas bodies run with ``interpret=True``, the same pieces in the JAX
package's second backward form (``_bwd_xla``) against it, autograd through
``fused_block_train`` against ``jax.grad``; then the Block's dispatch under ``MRN_FUSED_TRAIN=1`` and one
SVTR-MRN step-0 step on the fused path against the JAX learner's.

Geometries are ``tests/test_svtr_train_block.py``'s: Global (4, 16) and the
banded Local (4, 64) (plan qb 64, width 128), width 32, 2 heads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mrn_tpu.models.composer as jax_composer
import mrn_tpu.models.svtr as jax_svtr
from mrn_tpu.config import load_config as jax_load_config
from mrn_tpu.ops import svtr_train_block as jtb
from mrn_tpu.ops.svtr_block import _band_spec as jax_band_spec
from mrn_tpu.train.learners.mrn import MRN as JaxMRN
from mrn_tpu_torch.bridge import flax_tree, from_flax
from mrn_tpu_torch.config import load_config
from mrn_tpu_torch.data.synthetic import SyntheticTaskLoader, alphabet_of_size
from mrn_tpu_torch.models import svtr as svtr_mod
from mrn_tpu_torch.models.composer import build_recognizer
from mrn_tpu_torch.models.svtr import Block
from mrn_tpu_torch.ops import svtr_train_block as tb
from mrn_tpu_torch.train.learners.mrn import MRN

C, HEADS, BATCH = 32, 2, 3
SCALE = (C // HEADS) ** -0.5
GEOMS = [pytest.param((4, 16), None, id="global"),
         pytest.param((4, 64), (4, 64, 7, 11), id="local_banded")]
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# float32: the same arithmetic summed in another order (matmuls, LN and
# softmax reductions, the batch sums of the weight grads): 1e-5 relative to
# each tensor's largest value.  bfloat16: that order can flip the rounding of
# an intermediate or of the result by one bf16 ulp; allow two ulps of the
# tensor's largest value.
F32_SHARE = 1e-5
BF16_ULPS = 2
# fused against composed autodiff (tests/test_svtr_train_block.py) and the
# port's fused step against the JAX learner's composed step: 3e-4
STEP_TOL = 3e-4


def _params(rng, c=C):
    hidden = 4 * c
    shapes = dict(norm1_scale=(c,), norm1_bias=(c,), qkv_kernel=(c, 3 * c),
                  qkv_bias=(3 * c,), proj_kernel=(c, c), proj_bias=(c,),
                  norm2_scale=(c,), norm2_bias=(c,), fc1_kernel=(c, hidden),
                  fc1_bias=(hidden,), fc2_kernel=(hidden, c), fc2_bias=(c,))
    out = {}
    for name, shape in shapes.items():
        base = 1.0 if name.endswith("scale") else 0.0     # non-trivial LN affine
        std = 0.2 if name == "qkv_kernel" else 0.1
        out[name] = (base + std * rng.standard_normal(shape)).astype(np.float32)
    return out


def _inputs(rng, hw, dt, batch=BATCH):
    """Seeded x, params, droppath scales (zeros included) for both sides."""
    tdt, jdt = DTYPES[dt]
    n = hw[0] * hw[1]
    params = _params(rng)
    x = rng.standard_normal((batch, n, C)).astype(np.float32)
    keep = 0.9
    dm_a = (np.array([1, 0, 1, 1][:batch], np.float32) / keep).reshape(batch, 1)
    dm_b = (np.array([0, 1, 1, 0][:batch], np.float32) / keep).reshape(batch, 1)
    torch_side = (torch.from_numpy(x).to(tdt), {k: torch.from_numpy(v).to(tdt)
                                                for k, v in params.items()},
                  torch.from_numpy(dm_a), torch.from_numpy(dm_b))
    jax_side = (jnp.asarray(x, jdt), {k: jnp.asarray(v, jdt) for k, v in params.items()},
                jnp.asarray(dm_a), jnp.asarray(dm_b))
    return torch_side, jax_side


def _assert_close(got, ref, dt, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    ref = np.asarray(ref).astype(np.float32)
    assert got.shape == ref.shape, what
    top = float(np.abs(ref).max())
    if dt == "float32":
        atol = F32_SHARE * top
    else:
        atol = BF16_ULPS * 2.0 ** (np.floor(np.log2(top)) - 7)
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0, err_msg=what)


def _to_torch(a, tdt):
    return torch.from_numpy(np.asarray(a).astype(np.float32)).to(tdt)


# ------------------------------------------------------------ kernel bodies
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("hw,band", GEOMS)
def test_plain_forward_matches_pallas_interpret(rng, hw, band, dt):
    (x, p, dm_a, dm_b), (jx, jp, jdm_a, jdm_b) = _inputs(rng, hw, dt)
    jout, jres = jtb._forward(jx, jp, jdm_a, jdm_b, HEADS, SCALE, band, True)
    out, res = tb.forward_reference(x, p, dm_a, dm_b, HEADS, SCALE, band)
    for name, got, ref in zip(("out", "qkv", "attn_cat", "y", "h1"), (out,) + res,
                              (jout,) + tuple(jres)):
        assert got.dtype == x.dtype, name
        _assert_close(got, ref, dt, name)
    # the route a CPU tensor takes is that plain version
    fwd, fres = tb.forward(x, p, dm_a, dm_b, HEADS, SCALE, band)
    torch.testing.assert_close(fwd, out, atol=0, rtol=0)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("hw,band", GEOMS)
def test_plain_tail_middle_head_match_pallas_interpret(rng, hw, band, dt):
    """Tail -> attention middle -> head from the same residuals and cotangent
    as ``_bwd_pallas``: dx and all 12 grads, cast to the params' dtype."""
    tdt = DTYPES[dt][0]
    (x, p, dm_a, dm_b), (jx, jp, jdm_a, jdm_b) = _inputs(rng, hw, dt)
    _, jres = jtb._forward(jx, jp, jdm_a, jdm_b, HEADS, SCALE, band, True)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jdx, jgrads = jtb._bwd_pallas(jx, jp, jdm_a, jdm_b, jres, jnp.asarray(g, jx.dtype),
                                  HEADS, SCALE, band, interpret=True)
    res = tuple(_to_torch(r, tdt) for r in jres)
    dx, grads = tb._bwd_split(x, p, dm_a, dm_b, res, _to_torch(g, tdt), HEADS, SCALE,
                              band, plain=True)
    assert dx.dtype == tdt
    _assert_close(dx, jdx, dt, "dx")
    assert set(grads) == set(tb.PARAM_KEYS)
    for key in tb.PARAM_KEYS:
        assert grads[key].shape == p[key].shape, key
        _assert_close(grads[key].to(tdt), jgrads[key], dt, key)


def _bwd_xla(x, params, dm_a, dm_b, res, g, num_heads, scale, band):
    """The JAX package's hand-written einsum backward (``_bwd_xla``, its
    ``MRN_FUSED_BWD=xla`` form) from the port's plain pieces: tail, middle
    and head with dy, dattn and dqkv kept in float32 between them."""
    qkv, attn_cat, y, h1 = res
    dy, dattn, grads = tb._tail(g, y, h1, attn_cat, params, dm_a, dm_b)
    dqkv = tb._attn_bwd(qkv, dattn, num_heads, scale, band, x.dtype)
    dx, head_grads = tb._head(x, dy, dqkv, params)
    return dx.to(x.dtype), dict(grads, **head_grads)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("hw,band", GEOMS)
def test_xla_backward_form_matches_jax(rng, hw, band, dt):
    tdt = DTYPES[dt][0]
    (x, p, dm_a, dm_b), (jx, jp, jdm_a, jdm_b) = _inputs(rng, hw, dt)
    _, jres = jtb._forward(jx, jp, jdm_a, jdm_b, HEADS, SCALE, band, True)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jdx, jgrads = jtb._bwd_xla(jx, jp, jdm_a, jdm_b, jres, jnp.asarray(g, jx.dtype),
                               HEADS, SCALE, band)
    res = tuple(_to_torch(r, tdt) for r in jres)
    dx, grads = _bwd_xla(x, p, dm_a, dm_b, res, _to_torch(g, tdt), HEADS, SCALE, band)
    _assert_close(dx, jdx, dt, "dx")
    for key in tb.PARAM_KEYS:
        _assert_close(grads[key].to(tdt), jgrads[key], dt, key)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("hw,band", GEOMS)
def test_autograd_matches_jax_grad(rng, hw, band, dt):
    """torch.autograd through ``fused_block_train`` against ``jax.grad`` of
    the JAX ``fused_block_train(interpret=True)`` (its Pallas backward), the
    grads in the params' dtype."""
    tdt = DTYPES[dt][0]
    (x, p, dm_a, dm_b), (jx, jp, jdm_a, jdm_b) = _inputs(rng, hw, dt, batch=2)
    w = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(params, x_):
        out = jtb.fused_block_train(x_, params, jdm_a, jdm_b, num_heads=HEADS,
                                    scale=SCALE, band=band, interpret=True)
        return jnp.sum(out * w)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    xl = x.clone().requires_grad_()
    out = tb.fused_block_train(xl, leaves, dm_a, dm_b, num_heads=HEADS, scale=SCALE,
                               band=band)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                [xl] + [leaves[k] for k in tb.PARAM_KEYS])
    _assert_close(grads[0], jgx, dt, "dx")
    for key, got in zip(tb.PARAM_KEYS, grads[1:]):
        assert got.dtype == tdt
        _assert_close(got, jgp[key], dt, key)


def test_bf16_grads_come_back_in_the_param_dtype(rng):
    (x, p, dm_a, dm_b), _ = _inputs(rng, (4, 16), "bfloat16", batch=2)
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    xl = x.clone().requires_grad_()
    out = tb.fused_block_train(xl, leaves, dm_a, dm_b, num_heads=HEADS, scale=SCALE)
    grads = torch.autograd.grad(out.float().sum(), [xl] + list(leaves.values()))
    assert all(g.dtype == torch.bfloat16 for g in grads)
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads)


def test_gelu15_grad_matches_autograd():
    x = torch.linspace(-8.0, 8.0, 4097, dtype=torch.float32).requires_grad_()
    (auto,) = torch.autograd.grad(tb._gelu15(x).sum(), x)
    manual = tb._gelu15_grad(x.detach())
    torch.testing.assert_close(manual, auto, atol=1e-6, rtol=1e-6)
    # and the JAX package's own form of it
    np.testing.assert_allclose(manual.numpy(),
                               np.asarray(jtb._gelu15_grad(jnp.asarray(x.detach().numpy()))),
                               atol=1e-6, rtol=1e-6)


def test_zero_masks_make_the_identity(rng):
    """Both branch masks zero: out is x and the cotangent passes through."""
    (x, p, _, _), _ = _inputs(rng, (4, 16), "float32", batch=2)
    zeros = torch.zeros((2, 1))
    xl = x.clone().requires_grad_()
    out = tb.fused_block_train(xl, p, zeros, zeros, num_heads=HEADS, scale=SCALE)
    torch.testing.assert_close(out, x, atol=0, rtol=0)
    (g,) = torch.autograd.grad((out * xl).sum(), xl)
    torch.testing.assert_close(g, 2 * x, atol=1e-5, rtol=1e-5)


def test_unbanded_local_band_raises(rng):
    (x, p, dm_a, dm_b), _ = _inputs(rng, (4, 8), "float32", batch=2)
    assert tb._band_spec(4, 8, 7, 11) is None
    with pytest.raises(ValueError):
        tb.fused_block_train(x, p, dm_a, dm_b, num_heads=HEADS, scale=SCALE,
                             band=(4, 8, 7, 11))


def test_cpu_tensors_never_launch(rng, monkeypatch):
    def no_build():
        raise AssertionError("a CPU tensor reached the CUDA library")

    monkeypatch.setattr(tb, "_lib", no_build)
    before = dict(tb.launches)
    for hw, band in (((4, 16), None), ((4, 64), (4, 64, 7, 11))):
        (x, p, dm_a, dm_b), _ = _inputs(rng, hw, "float32", batch=2)
        xl = x.clone().requires_grad_()
        out = tb.fused_block_train(xl, p, dm_a, dm_b, num_heads=HEADS, scale=SCALE,
                                   band=band)
        torch.autograd.grad(out.sum(), xl)
    assert tb.launches == before


# ------------------------------------------------------------------- Block
def _block(rng, mixer, hw, col_major, drop_path=0.0):
    blk = Block(C, HEADS, mixer, hw, drop_path=drop_path, col_major=col_major)
    with torch.no_grad():
        for key, val in _params(rng).items():
            getattr(blk, key).copy_(torch.from_numpy(val))
    return blk


@pytest.mark.parametrize("mixer,hw,col_major", [
    ("Global", (4, 16), False), ("Local", (4, 64), True),   # a band plan: fused
    ("Local", (4, 8), True), ("Local", (4, 64), False),     # none: composed
])
def test_block_dispatch_follows_jax_band_ok(rng, monkeypatch, mixer, hw, col_major):
    """Under ``MRN_FUSED_TRAIN=1`` the Block takes the fused path exactly
    where JAX's ``band_ok`` (``svtr.py:393-395``) holds; without it, never."""
    n = hw[0] * hw[1]
    band = (hw[0], hw[1], 7, 11) if (mixer == "Local" and col_major) else None
    expect = mixer == "Global" or (band is not None and jax_band_spec(*band) is not None
                                   and band[0] * band[1] == n)
    calls = []

    def recording(*args, **kwargs):
        calls.append(kwargs["band"])
        return tb.fused_block_train(*args, **kwargs)

    monkeypatch.setattr(svtr_mod, "fused_block_train", recording)
    blk = _block(rng, mixer, hw, col_major)
    x = torch.from_numpy(rng.standard_normal((2, n, C)).astype(np.float32))
    monkeypatch.delenv("MRN_FUSED_TRAIN", raising=False)
    composed = blk(x, train=True)
    assert calls == []
    monkeypatch.setenv("MRN_FUSED_TRAIN", "1")
    fused = blk(x, train=True)
    assert blk.fused_train_ok(n) == expect
    assert calls == ([band] if expect else [])
    # fused and composed differ in the GELU (degree-15 polynomial against the
    # exact erf, |erf error| < 1.9e-7) and in summation order only
    torch.testing.assert_close(fused, composed, atol=1e-5, rtol=1e-5)


def test_fused_and_composed_draw_the_same_masks(rng, monkeypatch):
    """From one generator state the fused Block's dm_a / dm_b are the
    composed DropPath's masks (attention branch first, then MLP), with as
    many draws: equal outputs and equal generator states afterwards."""
    blk = _block(rng, "Global", (4, 16), False, drop_path=0.5)
    x = torch.from_numpy(rng.standard_normal((8, 64, C)).astype(np.float32))
    gen = torch.Generator().manual_seed(3)
    blk.drop_path.generator = gen
    start = gen.get_state()
    masks = [blk.drop_path.keep_scale(8, "cpu") for _ in range(2)]
    assert all(bool((m == 0).any()) and bool((m > 0).any()) for m in masks)
    outs, states = [], []
    for fused in (False, True):
        gen.set_state(start)
        if fused:
            monkeypatch.setenv("MRN_FUSED_TRAIN", "1")
        outs.append(blk(x, train=True))
        states.append(gen.get_state())
    assert torch.equal(states[0], states[1])
    torch.testing.assert_close(outs[1], outs[0], atol=1e-5, rtol=1e-5)
    # and those masks, handed to the Function directly, give the same output
    direct = tb.fused_block_train(x, {k: getattr(blk, k) for k in tb.PARAM_KEYS},
                                  masks[0], masks[1], num_heads=HEADS, scale=blk.scale)
    torch.testing.assert_close(direct, outs[1], atol=0, rtol=0)
    # rate 0 draws nothing
    idle = Block(C, HEADS, "Global", (4, 16)).drop_path
    idle.generator = gen
    still = gen.get_state()
    torch.testing.assert_close(idle.keep_scale(4, "cpu"), torch.ones(4, 1))
    assert torch.equal(gen.get_state(), still)


# ------------------------------------------------------------ SVTR-MRN step
SVTR = dict(embed_dim=(16, 32, 64), depth=(2, 4, 2), num_heads=(2, 2, 4),
            drop_path_rate=0.0)
IMG_W, STEP_BATCH = 128, 4
ALPHABETS = [alphabet_of_size(10), alphabet_of_size(6, 0x4E00 + 10)]


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float32)


def test_fused_step0_matches_jax_learner(tmp_path, monkeypatch):
    """One SVTR-MRN step-0 step, float32, narrow SVTR (stage 1 banded Local
    and stage 3 Global on the fused path, stage 2's unbanded Local composed)
    against the JAX learner's composed step with the degree-15 GELU: the loss
    and every grad element within 3e-4 (absolute and relative, as JAX's own
    fused-against-composed test)."""

    class NarrowSVTR(jax_svtr.SVTRExtractor):
        embed_dim: tuple = SVTR["embed_dim"]
        depth: tuple = SVTR["depth"]
        num_heads: tuple = SVTR["num_heads"]
        drop_path_rate: float = SVTR["drop_path_rate"]

    monkeypatch.setattr(jax_composer, "SVTRExtractor", NarrowSVTR)
    jax_svtr.set_attention_impl("xla")
    jax_svtr.set_train_gelu("poly")
    try:
        common = dict(imgW=IMG_W, output_channel=32, hidden_size=16,
                      batch_size=STEP_BATCH, num_iter=4, manual_seed=3,
                      output_dir=str(tmp_path), data_log=str(tmp_path / "data_any.txt"))
        jopt = jax_load_config("configs/svtr_mrn.py", **common)
        topt = load_config("configs/svtr_mrn.py", svtr=SVTR, **common)
        character = ALPHABETS[0] + ALPHABETS[1]
        jl = JaxMRN(jopt)
        jl.character = character
        jl.converter = jl.build_converter()
        jl.change_model()
        loader = SyntheticTaskLoader(ALPHABETS, 1, STEP_BATCH, 8, img_w=IMG_W, max_len=5,
                                     seed=1)
        idx, words = loader.get_batch()
        images = (loader.bank[idx].astype(np.float32) / 255.0 - 0.5) / 0.5
        images[..., 3] = np.random.default_rng(0).uniform(-1, 1, images.shape[:3])
        batch = jl._encode_batch(images, words)
        value_and_grad = jax.jit(jax.value_and_grad(jl.loss_fn, has_aux=True),
                                 static_argnums=(4,))
        (jloss, _), jgrads = value_and_grad(jl.params, jl.batch_stats, batch,
                                            jax.random.PRNGKey(0), None)
    finally:
        jax_svtr.set_train_gelu("auto")
        jax_svtr.set_attention_impl("auto")

    monkeypatch.setenv("MRN_FUSED_TRAIN", "1")
    calls = []
    monkeypatch.setattr(svtr_mod, "fused_block_train",
                        lambda *a, **k: calls.append(k["band"]) or tb.fused_block_train(*a, **k))
    tl = MRN(topt, device="cpu")
    tl.character = character
    tl.converter = tl.build_converter()
    tl.model = build_recognizer(topt, tl._total_classes)
    tl.model.load_state_dict(from_flax(jl.params, jl.batch_stats), strict=True)
    tl.build_optimizer()
    grads = {}
    tl.grad_transform = lambda: (lambda g: grads.update(
        {k: v.detach().clone() for k, v in g.items()}) or g)
    metrics = tl.train_step((images, words))
    # stage 1's 2 banded Local Blocks and stage 3's 2 Global Blocks
    assert calls == [(8, 32, 7, 11)] * 2 + [None] * 2

    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=STEP_TOL)
    got = dict(_leaves(flax_tree(grads.items())))
    ref = dict(_leaves(jax.tree_util.tree_map(np.asarray, jgrads)))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=STEP_TOL, rtol=STEP_TOL, err_msg=k)
