"""The port's SVTR training attention (plain versions, CPU) against the JAX
package's Pallas kernels run in interpret mode, at the real SVTR band
geometries, on the same seeded inputs; gradients through ``mha_small_n``
against the JAX custom VJPs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrn_tpu.ops import svtr_attention as jax_attn
from mrn_tpu_torch.models.svtr import (local_attention_mask,
                                       local_attention_mask_col_major)
from mrn_tpu_torch.ops import svtr_attention as attn
from mrn_tpu_torch.ops.svtr_block import _band_spec

# Stage 1 (8, 64) -> qb 128 / width 256, stage 2 (4, 64) -> qb 64 / width 128.
BAND_GEOMS = [(8, 64, 7, 11), (4, 64, 7, 11)]
F32_ATOL = F32_RTOL = 1e-5          # float32 summation order and exp ulps
BF16_RTOL = 1e-2                    # plus one output ulp (below)
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4   # the same float32 math, other sum order


def _inputs(rng, n, dt, b=2, h=2, d=32):
    qkv = [rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(3)]
    tdt = torch.float32 if dt == "float32" else torch.bfloat16
    jdt = jnp.float32 if dt == "float32" else jnp.bfloat16
    return ([torch.from_numpy(x).to(tdt) for x in qkv],
            [jnp.asarray(x, jdt) for x in qkv])


def _assert_close(got, ref, dt):
    got = got.float().numpy()
    ref = np.asarray(ref).astype(np.float32)
    if dt == "float32":
        np.testing.assert_allclose(got, ref, atol=F32_ATOL, rtol=F32_RTOL)
    else:
        ulp = 2.0 ** (np.ceil(np.log2(np.abs(ref).max())) - 8)  # bf16 ulp at the top
        np.testing.assert_allclose(got, ref, atol=ulp, rtol=BF16_RTOL)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("band", BAND_GEOMS)
def test_banded_plain_matches_pallas_interpret(rng, band, dt):
    assert _band_spec(*band) is not None
    (q, k, v), (jq, jk, jv) = _inputs(rng, band[0] * band[1], dt)
    ref = jax_attn._banded_forward(jq, jk, jv, band, interpret=True)
    got = attn.banded_attention_reference(q, k, v, band)
    assert got.dtype == q.dtype
    _assert_close(got, ref, dt)
    # the autograd Function's forward on a CPU tensor is that plain version
    torch.testing.assert_close(attn.mha_small_n(q, k, v, band=band), got,
                               atol=0, rtol=0)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,hw", [("Global", (4, 64)), ("Global", (2, 64)),
                                     ("Local", (2, 16))])
def test_full_plain_matches_pallas_interpret(rng, kind, hw, dt):
    n = hw[0] * hw[1]
    (q, k, v), (jq, jk, jv) = _inputs(rng, n, dt)
    mask = local_attention_mask(*hw) if kind == "Local" else None
    jmask = jnp.zeros((n, n), jnp.float32) if mask is None else jnp.asarray(mask)
    ref = jax_attn._mha_forward(jq, jk, jv, jmask, interpret=True)
    tmask = None if mask is None else torch.from_numpy(mask)
    _assert_close(attn.attention_reference(q, k, v, tmask), ref, dt)


@pytest.mark.parametrize("band", BAND_GEOMS + [None])
def test_grads_match_jax_custom_vjp(rng, band):
    n = 256 if band is None else band[0] * band[1]
    (q, k, v), (jq, jk, jv) = _inputs(rng, n, "float32", b=1, d=16)
    g = rng.standard_normal(q.shape).astype(np.float32)
    jg = jax.grad(lambda a, b, c: (jax_attn.mha_small_n(
        a, b, c, band=band, interpret=True) * g).sum(), argnums=(0, 1, 2))(jq, jk, jv)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = attn.mha_small_n(q, k, v, band=band)
    tg = torch.autograd.grad(out, (q, k, v), torch.from_numpy(g))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.mark.parametrize("band", BAND_GEOMS)
def test_plain_versions_agree_with_xla_forms(rng, band):
    """Banded plain == banded XLA form == full XLA attention with the full
    col-major mask (out-of-window keys are -inf there)."""
    (q, k, v), _ = _inputs(rng, band[0] * band[1], "float32", b=1)
    full = attn.xla_attention(q, k, v, torch.from_numpy(local_attention_mask_col_major(*band)))
    for got in (attn.banded_attention_reference(q, k, v, band),
                attn.banded_attention_xla(q, k, v, band)):
        np.testing.assert_allclose(got.numpy(), full.numpy(), atol=F32_ATOL, rtol=F32_RTOL)


def test_band_without_plan_takes_the_full_mask(rng):
    band = (8, 8, 7, 11)   # the window covers every key: no band plan
    assert _band_spec(*band) is None
    (q, k, v), _ = _inputs(rng, 64, "float32", b=1)
    mask = torch.from_numpy(local_attention_mask_col_major(*band))
    torch.testing.assert_close(attn.mha_small_n(q, k, v, mask, band=band),
                               attn.attention_reference(q, k, v, mask), atol=0, rtol=0)
    torch.testing.assert_close(attn.banded_attention_xla(q, k, v, band),
                               attn.xla_attention(q, k, v, mask), atol=0, rtol=0)


def test_cpu_tensors_never_launch(rng):
    before = dict(attn.launches)
    (q, k, v), _ = _inputs(rng, 256, "float32", b=1)
    attn.mha_small_n(q, k, v)
    attn.mha_small_n(q, k, v, band=(4, 64, 7, 11))
    assert attn.launches == before


def _fma32(a, b, c):
    """float32 fma(a, b, c), rounded once as the card's FFMA rounds: a b is
    exact in float64; the exact sum a b + c is s + e (TwoSum), rounded to odd
    in float64 (53 >= 24 + 2 bits) and then to nearest float32, which gives
    the correctly rounded result (Boldo and Melquiond, round-to-odd)."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = c.astype(np.float64)
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    even = (s.view(np.uint64) & 1) == 0
    s = np.where((e != 0) & even, np.nextafter(s, np.where(e > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def test_fma32_emulation_rounds_once():
    """Against exact rational arithmetic on a sample, including sums where
    rounding the float64 sum to float32 would round twice."""
    from fractions import Fraction

    rng = np.random.default_rng(5)
    a = rng.standard_normal(3000).astype(np.float32)
    b = rng.standard_normal(3000).astype(np.float32)
    c = (-a.astype(np.float64) * b * (1 + rng.standard_normal(3000) * 2.0 ** -20)
         ).astype(np.float32)
    # a b + c = 1 + 2^-24 + 2^-70: its float64 rounding 1 + 2^-24 is a float32
    # tie, which rounds to 1; rounded once, the sum is 1 + 2^-23
    a[0], b[0], c[0] = 1 - 2.0 ** -24, 1 + 2.0 ** -23, 2.0 ** -47 * (1 + 2.0 ** -23)
    twice = (a[:1].astype(np.float64) * b[:1] + c[:1]).astype(np.float32)
    assert twice[0] == 1 and _fma32(a[:1], b[:1], c[:1])[0] == np.float32(1 + 2.0 ** -23)
    got = _fma32(a, b, c)
    for i in range(3000):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        lo = np.float32(float(exact))
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda y: (abs(Fraction(float(y)) - exact),
                                         int(np.float32(y).view(np.uint32)) & 1))
        assert got[i] == best, (i, a[i], b[i], c[i])


def test_corrected_reciprocal_is_the_division(rng):
    """The kernels normalise with r = 1/l once per row and q = x r, q += (x -
    q l) r (two FMAs) per score (``normalise`` in csrc/svtr_attention.cu).
    That is the correctly rounded x / l -- the plain version's division --
    for every quotient >= 2^-100 (below, the residual underflows, and the
    quotient may be one float32 ulp off: p < 2^-100 moves no float32 o).
    The FMAs are emulated with one rounding each (``_fma32``); that the
    kernel computes these FMAs is the card tests' kernel-vs-plain check."""
    n = 2_000_000
    x = np.exp(-rng.exponential(8.0, n)).astype(np.float32)     # exp(s - max)
    l = (1 + rng.random(n) * rng.choice([1, 16, 255, 511], n)).astype(np.float32)
    r = np.float32(1) / l
    q = x * r
    got = _fma32(_fma32(-q, l, x), r, q)
    ref = x / l
    big = ref >= 2.0 ** -100
    assert big.mean() > 0.99
    np.testing.assert_array_equal(got[big], ref[big])
    ulp = np.maximum(np.spacing(ref[~big]), 2.0 ** -149)
    assert (np.abs(got[~big].astype(np.float64) - ref[~big]) <= ulp).all()
    assert (q[big] != ref[big]).mean() > 0.1   # the uncorrected product is not
