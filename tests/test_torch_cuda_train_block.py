"""The fused SVTR training Block's CUDA kernels (forward, backward tail,
backward head) against their plain PyTorch versions, on the card, at small
and ragged shapes and at a full SVTR Block shape; gradients through the
autograd Function; bitwise-repeatable weight gradients.  Needs a CUDA card;
imports no JAX, so it also runs without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_train_block.py
"""

import re

import numpy as np
import pytest
import torch

from mrn_tpu_torch.ops import _build
from mrn_tpu_torch.ops import svtr_train_block as tb

# kernel vs plain on the same inputs, per tensor as a bound on |k - p| from
# its largest |p|.  float32: summation order and CUDA exp/rsqrt ulps, 2e-5 of
# the largest value.  bfloat16: a flipped rounding of an intermediate or of
# the result by one bf16 ulp; two ulps of the largest value (2^-7 of it
# rounded down to a power of two), so a missed rounding point fails.
F32_SHARE = 2e-5
BF16_ULPS = 2
SHAPES = [
    # (grid (h, w), C, heads, banded, batch)
    ((3, 8), 64, 8, False, 3),      # N=24: one partial query tile, d=8
    ((2, 40), 64, 4, False, 2),     # N=80: ragged last tile, d=16
    ((4, 16), 128, 2, False, 2),    # d=64
    ((8, 32), 64, 2, True, 2),      # banded: qb 32, width 128
    ((4, 64), 128, 4, True, 2),     # banded: qb 64, width 128 (stage 2)
    ((8, 64), 64, 2, True, 16),     # banded: qb 128, width 256 (stage 1), 8192 rows
]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(rng, hw, c, batch, device, dt):
    hidden = 4 * c
    shapes = dict(norm1_scale=(c,), norm1_bias=(c,), qkv_kernel=(c, 3 * c),
                  qkv_bias=(3 * c,), proj_kernel=(c, c), proj_bias=(c,),
                  norm2_scale=(c,), norm2_bias=(c,), fc1_kernel=(c, hidden),
                  fc1_bias=(hidden,), fc2_kernel=(hidden, c), fc2_bias=(c,))
    params = {}
    for name, shape in shapes.items():
        base = 1.0 if name.endswith("scale") else 0.0
        val = base + 0.1 * rng.standard_normal(shape)
        params[name] = torch.from_numpy(val.astype(np.float32)).to(device, dt)
    n = hw[0] * hw[1]
    x = torch.from_numpy(rng.standard_normal((batch, n, c)).astype(np.float32)).to(device, dt)
    keep = (rng.random((2, batch, 1)) < 0.7).astype(np.float32) / 0.7
    keep[:, 0] = 0.0                      # a dropped image on both branches
    dm_a, dm_b = (torch.from_numpy(k).to(device) for k in keep)
    return x, params, dm_a, dm_b


def _close(got, ref, dt, what):
    got, ref = got.float(), ref.float()
    assert got.shape == ref.shape, what
    assert bool(torch.isfinite(got).all()), what
    top = max(float(ref.abs().max()), 1e-6)
    err = float((got - ref).abs().max())
    bound = (F32_SHARE * top if dt == torch.float32
             else BF16_ULPS * 2.0 ** (np.floor(np.log2(top)) - 7))
    assert err <= bound, f"{what}: {err} vs largest {top} (bound {bound})"


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,c,heads,banded,batch", SHAPES)
def test_kernels_match_plain(device, dt, hw, c, heads, banded, batch):
    rng = np.random.default_rng(11)
    x, p, dm_a, dm_b = _inputs(rng, hw, c, batch, device, dt)
    band = (hw[0], hw[1], 7, 11) if banded else None
    if banded:
        assert tb._band_spec(*band) is not None
    scale = (c // heads) ** -0.5
    before = dict(tb.launches)
    out, res = tb.forward(x, p, dm_a, dm_b, heads, scale, band)
    torch.cuda.synchronize()
    ref_out, ref_res = tb.forward_reference(x, p, dm_a, dm_b, heads, scale, band)
    for name, a, b in zip(("out", "qkv", "attn", "y", "h1"), (out,) + res, (ref_out,) + ref_res):
        _close(a, b, dt, name)
    # the backward pieces on the same inputs as their plain versions
    qkv, attn, y, h1 = res
    g = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)).to(device, dt)
    dy, dattn, grads = tb.bwd_tail(g, y, h1, attn, p, dm_a, dm_b)
    torch.cuda.synchronize()
    rdy, rdattn, rgrads = tb.bwd_tail_reference(g, y, h1, attn, p, dm_a, dm_b)
    _close(dy, rdy, dt, "dy")
    _close(dattn, rdattn, dt, "dattn")
    for key, val in rgrads.items():
        _close(grads[key], val, dt, key)
    dqkv = tb._attn_bwd(qkv, dattn, heads, scale, band, dt).to(dt)
    dx, hgrads = tb.bwd_head(x, dy, dqkv, p)
    torch.cuda.synchronize()
    rdx, rhgrads = tb.bwd_head_reference(x, dy, dqkv, p)
    _close(dx, rdx, dt, "dx")
    for key, val in rhgrads.items():
        _close(hgrads[key], val, dt, key)
    assert set(grads) | set(hgrads) == set(tb.PARAM_KEYS)
    assert tb.launches == {k: before[k] + 1 for k in before}


@pytest.mark.cuda
@pytest.mark.parametrize("banded", [False, True])
def test_function_grads_match_plain(device, banded):
    """Grads of x and all 12 params through the autograd Function, kernels
    against plain versions, float32."""
    rng = np.random.default_rng(5)
    hw = (4, 64) if banded else (2, 64)
    x, p, dm_a, dm_b = _inputs(rng, hw, 128, 4, device, torch.float32)
    band = (4, 64, 7, 11) if banded else None
    w = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)).to(device)
    results = []
    for plain in (False, True):
        leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
        xl = x.clone().requires_grad_()
        out = tb.fused_block_train(xl, leaves, dm_a, dm_b, num_heads=4, scale=32 ** -0.5,
                                   band=band, plain=plain)
        results.append(torch.autograd.grad((out * w).sum(),
                                           [xl] + [leaves[k] for k in tb.PARAM_KEYS]))
    for name, a, b in zip(("x",) + tb.PARAM_KEYS, *results):
        _close(a, b, torch.float32, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_weight_grads_are_bitwise_repeatable(device, dt):
    rng = np.random.default_rng(9)
    x, p, dm_a, dm_b = _inputs(rng, (4, 64), 128, 8, device, dt)
    band = (4, 64, 7, 11)
    _, (qkv, attn, y, h1) = tb.forward(x, p, dm_a, dm_b, 4, 32 ** -0.5, band)
    g = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)).to(device, dt)
    dqkv = torch.from_numpy(rng.standard_normal(qkv.shape).astype(np.float32)).to(device, dt)
    runs = []
    for _ in range(2):
        dy, _, tail = tb.bwd_tail(g, y, h1, attn, p, dm_a, dm_b)
        _, head = tb.bwd_head(x, dy, dqkv, p)
        runs.append(dict(tail, **head))
    for key in tb.PARAM_KEYS:
        assert torch.equal(runs[0][key], runs[1][key]), key


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(device):
    rng = np.random.default_rng(0)
    x, p, dm_a, dm_b = _inputs(rng, (2, 16), 32, 2, device, torch.float16)
    with pytest.raises(TypeError):
        tb.forward(x, p, dm_a, dm_b, 2, 0.25, None)
    x, p, dm_a, dm_b = _inputs(rng, (2, 16), 96, 2, device, torch.float32)
    with pytest.raises(ValueError):     # head_dim 48
        tb.forward(x, p, dm_a, dm_b, 2, 48 ** -0.5, None)


# The four Block shapes of SVTR (imgW 256): (grid (h, w), C, heads, banded)
MAIN_SHAPES = [((8, 64), 64, 2, True), ((4, 64), 128, 4, True),
               ((4, 64), 128, 4, False), ((2, 64), 256, 8, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,c,heads,banded", MAIN_SHAPES)
def test_forward_two_launches_bitwise_equal(device, dt, hw, c, heads, banded):
    """The forward has no split-K and no atomics: the same inputs give the
    same bits in every output and residual; the main-path plan takes the
    one-pass attention kernel."""
    rng = np.random.default_rng(4)
    x, p, dm_a, dm_b = _inputs(rng, hw, c, 4, device, dt)
    band = (hw[0], hw[1], 7, 11) if banded else None
    scale = (c // heads) ** -0.5
    runs = []
    for _ in range(2):
        out, res = tb.forward(x, p, dm_a, dm_b, heads, scale, band)
        torch.cuda.synchronize()
        runs.append((out,) + tuple(res))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    n = hw[0] * hw[1]
    qb, width = tb._band_spec(*band)[:2] if banded else (n, n)
    kplan = tb._kernel_plan(dt, n, c, heads, 4 * c, qb, width)
    assert kplan[2:4] == (1, 1) and 8 * kplan[1] == width   # one segment, one pass


@pytest.mark.cuda
def test_bf16_forward_runs_on_tensor_cores(device):
    """The bf16 forms of the training Block's products -- the forward's
    projections and attention, the backward's data gradients (proj forms
    with the Dh1Epi / StoreEpi epilogues) and weight gradients
    (wgrad_kernel) -- have tensor-core products (HMMA, or HGMMA) in their
    SASS; the float32 forms have none and have FFMA."""
    funcs = _build.sass("svtr_train_block")
    fwd_epi, bwd_epi = ("QkvEpi", "ProjEpi", "Fc1Epi", "Fc2Epi"), ("Dh1Epi", "StoreEpi")
    fwd = {n: b for n, b in funcs.items() if "attention_tc_" in n
           or ("proj_kernel" in n and any(e in n for e in fwd_epi))}
    bwd = {n: b for n, b in funcs.items() if "wgrad_kernel" in n
           or ("proj_kernel" in n and any(e in n for e in bwd_epi))}
    assert {n for n in funcs if "proj_kernel" in n} <= set(fwd) | set(bwd), sorted(funcs)
    # forms (bf16, f32), two or four tile shapes per site: the backward's
    # sites with the same loaders and epilogue share a form (dz2 and dz1; in
    # float32 dattn too)
    for kind, forms, counts in (("forward", fwd, {"proj_kernel": (8, 8), "attention_tc_": (12, 12)}),
                                ("backward", bwd, {"proj_kernel": (6, 4), "wgrad_kernel": (16, 16)})):
        bf16 = {n: b for n, b in forms.items() if "13__nv_bfloat16" in n}
        f32 = {n: b for n, b in forms.items() if n not in bf16}
        for part, count in counts.items():
            assert (sum(part in n for n in bf16), sum(part in n for n in f32)) == count, \
                (kind, part, sorted(forms))
        for name, body in bf16.items():
            assert re.search(r"\bH(G)?MMA\b", body), f"{kind} {name}: no HMMA/HGMMA"
        for name, body in f32.items():
            assert not re.search(r"\bH(G)?MMA\b", body), \
                f"{kind} {name}: tensor-core products in float32"
            assert "FFMA" in body, f"{kind} {name}: no FFMA"


def _backward_inputs(seed, hw, c, heads, banded, batch, device, dt):
    """A Block's residuals from the forward kernel, a cotangent g and a
    dqkv [B, N, 3C] in dt, from a seed."""
    rng = np.random.default_rng(seed)
    x, p, dm_a, dm_b = _inputs(rng, hw, c, batch, device, dt)
    band = (hw[0], hw[1], 7, 11) if banded else None
    _, res = tb.forward(x, p, dm_a, dm_b, heads, (c // heads) ** -0.5, band)
    g = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)).to(device, dt)
    dqkv = torch.from_numpy(rng.standard_normal(res[0].shape).astype(np.float32)).to(device, dt)
    return x, p, dm_a, dm_b, res, g, dqkv


def _check_backward(x, p, dm_a, dm_b, res, g, dqkv, dt):
    """Tail and head kernels against their plain versions on the same
    inputs; returns the kernels' outputs."""
    _, attn, y, h1 = res
    dy, dattn, tail = tb.bwd_tail(g, y, h1, attn, p, dm_a, dm_b)
    dx, head = tb.bwd_head(x, dy, dqkv, p)
    torch.cuda.synchronize()
    rdy, rdattn, rtail = tb.bwd_tail_reference(g, y, h1, attn, p, dm_a, dm_b)
    rdx, rhead = tb.bwd_head_reference(x, dy, dqkv, p)
    for name, a, b in [("dy", dy, rdy), ("dattn", dattn, rdattn), ("dx", dx, rdx)] + [
            (k, tail[k], rtail[k]) for k in rtail] + [(k, head[k], rhead[k]) for k in rhead]:
        _close(a, b, dt, name)
    return (dy, dattn, dx), dict(tail, **head)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,c,heads,banded", MAIN_SHAPES)
def test_backward_matches_plain_at_main_shapes(device, dt, hw, c, heads, banded):
    """Rows 6 and 7 at the four SVTR Block shapes at batch 256 (32768 to
    131072 rows, several row chunks per weight gradient)."""
    _check_backward(*_backward_inputs(6, hw, c, heads, banded, 256, device, dt), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_backward_ragged_rows(device, dt):
    """M = 37 x 80 rows: not a multiple of 128 (the data gradients' row
    blocks) nor of any weight gradient's row chunk, so the last tile and the
    last chunk are partial."""
    hw, c, batch = (2, 40), 64, 37
    m = batch * hw[0] * hw[1]
    grads, _ = tb._bwd_plan(dt, m, c, 4 * c)
    assert m % 128 and all(count > 1 and m % chunk for _, _, count, chunk in grads.values())
    _check_backward(*_backward_inputs(8, hw, c, 4, False, batch, device, dt), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,c,heads,banded", MAIN_SHAPES)
def test_backward_two_launches_bitwise_equal(device, dt, hw, c, heads, banded):
    """No float atomics: the same inputs give the same bits in dy, dattn,
    dx and all 12 grads at the main shapes."""
    x, p, dm_a, dm_b, (_, attn, y, h1), g, dqkv = _backward_inputs(
        7, hw, c, heads, banded, 256, device, dt)
    runs = []
    for _ in range(2):
        dy, dattn, tail = tb.bwd_tail(g, y, h1, attn, p, dm_a, dm_b)
        dx, head = tb.bwd_head(x, dy, dqkv, p)
        torch.cuda.synchronize()
        runs.append(dict(tail, dy=dy, dattn=dattn, dx=dx, **head))
    for key in runs[0]:
        assert torch.equal(runs[0][key], runs[1][key]), key
