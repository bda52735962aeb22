"""Fused SVTR inference Block: hand-written CUDA kernel plus its plain
PyTorch version.

Computes, for ``x [B, N, C]`` in the working dtype ``dt`` (float32 or
bfloat16)::

    x1  = x + proj( softmax*( LN(x) @ Wqkv_f ) )
    out = x1 + fc2( gelu9( LN(x1) @ Wfc1_f ) )

exactly as the JAX package's Pallas kernel ``mrn_tpu/ops/svtr_block.py::
_make_kernel`` does:

- bare single-pass LayerNorm (``E[x^2] - mean^2``, eps 1e-6, float32); the LN
  scale/shift and the attention q-scale are folded into the qkv weights and
  LN2 into fc1 on the host side (``_fold``);
- matmul operands rounded to ``dt``, float32 accumulation;
- reduction-free softmax: ``exp(min(s, 60))`` without a max-subtract, P
  rounded to ``dt``, the row-sum taken over the rounded P (the Pallas
  kernel's ones-column of V), normalised after PV with ``+1e-30``;
- GELU through the degree-9 minimax erf polynomial (``gelu_degree=15`` gives
  the degree-15 fit, the JAX kernel's ``SVTR_GELU_DEG=15``);
- Local blocks on column-major tokens run banded: each ``qb``-row query
  block attends to its ``width``-key window (``_band_spec``).

``fused_block`` takes the plain version for a tensor on the CPU and launches
the CUDA kernel (``csrc/svtr_block.cu``) for a CUDA tensor; there is no
fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["SCORE_CLAMP", "fused_block", "fused_block_reference", "launches"]

# erf(z) = z * P(u), u an affine map of clamp(z^2): odd minimax polynomial in
# the shifted monomial basis, coefficients low -> high (copied from the JAX
# package).  Degree 15: |erf err| < 1.9e-7.
_ERF_Z0SQ = 3.7 * 3.7
_ERF_COEFS = (
    0.3821374773979187, -0.1904679834842682, 0.14079536497592926,
    -0.11263926327228546, 0.09052307158708572, -0.07047279179096222,
    0.0521380715072155, -0.03618001565337181, 0.023104503750801086,
    -0.013829714618623257, 0.008435077033936977, -0.004555193707346916,
    0.0014333085855469108, -0.0005751904682256281, 0.0007578228251077235,
    -0.0003343276330269873)

# Degree 9: |erf err| < 1.4e-4, GELU abs err < 3.5e-4 -- below the bf16
# rounding applied to the MLP hidden right after.
_ERF9_COEFS = (
    0.3821687211819126, -0.1906354404948208, 0.13926991905032793,
    -0.10986806700502608, 0.102285918252448, -0.08351699887774686,
    0.021168399249059538, -0.011215921240360423, 0.05439620276621701,
    -0.03381804338264774)

_GELU_COEFS = {9: _ERF9_COEFS, 15: _ERF_COEFS}

# Reduction-free-softmax score clamp: exp runs without the max-subtract,
# relying on every real checkpoint's attention scores staying below this.
SCORE_CLAMP = 60.0

# Count of CUDA launches of the fused Block (one per fused_block call on a
# CUDA tensor; the plain version never counts).
launches = 0


def _erf_poly(z: torch.Tensor, coefs=_ERF9_COEFS) -> torch.Tensor:
    """Transcendental-free minimax erf: a pure FMA chain; |z| > 3.7
    saturates via the clip."""
    u = (2.0 / _ERF_Z0SQ) * torch.clamp(z * z, max=_ERF_Z0SQ) - 1.0
    p = coefs[-1]
    for c in coefs[-2::-1]:
        p = p * u + c
    return torch.clamp(z * p, -1.0, 1.0)


def _gelu_poly(x: torch.Tensor, degree: int) -> torch.Tensor:
    return 0.5 * x * (1.0 + _erf_poly(x * (2.0 ** -0.5), _GELU_COEFS[degree]))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=None)
def _band_spec(h: int, w: int, hk: int, wk: int):
    """Banded-attention plan for a COLUMN-major Local mask: with token =
    col*h + row the hk x wk window lies inside a +/-bw band, bw = (wk//2)*h +
    hk//2.  Queries split into blocks of ``qb`` rows; each block's visible
    keys fit in a ``width``-key window (qb + 2*bw rounded up to 128), clipped
    into [0, N).  Per-block masks carry the exact in-window Local pattern, so
    banded == full masked attention.  Picks the largest qb in {128, 64, 32}
    with width < N (the JAX package's plan, kept identical so both packages
    compute the same windows).  Returns (qb, width, starts, band_mask[N,
    width]) or None when the window would cover all keys."""
    from mrn_tpu_torch.models.svtr import local_attention_mask_col_major

    n = h * w
    bw = (wk // 2) * h + hk // 2
    best = None
    for qb in (128, 64, 32):
        if n % qb:
            continue
        width = _round_up(qb + 2 * bw, 128)
        if width >= n:
            continue
        best = (qb, width)
        break
    if best is None:
        return None
    qb, width = best
    full = local_attention_mask_col_major(h, w, hk, wk)
    starts = tuple(min(max(a * qb - (width - qb) // 2, 0), n - width)
                   for a in range(n // qb))
    band_mask = np.empty((n, width), np.float32)
    for a, st in enumerate(starts):
        band_mask[a * qb:(a + 1) * qb] = full[a * qb:(a + 1) * qb,
                                              st:st + width]
    return qb, width, starts, band_mask


@functools.lru_cache(maxsize=None)
def _band_on_device(band: Tuple[int, int, int, int], device: torch.device):
    qb, width, starts, band_mask = _band_spec(*band)
    return (torch.tensor(starts, dtype=torch.int32, device=device),
            torch.from_numpy(band_mask).to(device))


class _Plan:
    """Attention geometry of one call: query-block rows ``qb``, key-window
    ``width``, per-block window starts (host tuple and device int32 tensor,
    None for the single full block) and the additive mask ``[N, width]``
    (float32, None when unmasked)."""

    def __init__(self, n, mask, band, device):
        self.starts_dev = None
        if band is not None and band[0] * band[1] == n and _band_spec(*band):
            self.qb, self.width, self.starts, _ = _band_spec(*band)
            self.starts_dev, self.mask = _band_on_device(tuple(band), device)
        else:
            self.qb, self.width, self.starts = n, n, (0,)
            self.mask = (None if mask is None else torch.as_tensor(
                mask, dtype=torch.float32, device=device))


def _fold(params: Dict[str, torch.Tensor], scale: float, dt: torch.dtype):
    """Epilogue folding in float32: LN scale/shift and the attention q-scale
    move into the qkv weights, LN2 into fc1, so the kernel runs bare
    LayerNorms:  LN(x)@W + b == normalize(x) @ (s[:,None]*W) + (b + ln_b@W)."""
    f32 = torch.float32

    def fold(kernel, bias, s_name, b_name, extra=None):
        w = params[kernel].to(f32)
        wf = params[s_name].to(f32)[:, None] * w
        bf = params[bias].to(f32) + params[b_name].to(f32) @ w
        if extra is not None:
            wf = wf * extra
            bf = bf * extra
        return wf.to(dt).contiguous(), bf.contiguous()

    c = params["qkv_kernel"].shape[0]
    dev = params["qkv_kernel"].device
    qscale = torch.cat([torch.full((c,), scale, dtype=f32, device=dev),
                        torch.ones((2 * c,), dtype=f32, device=dev)])
    qkv_w, qkv_b = fold("qkv_kernel", "qkv_bias", "norm1_scale", "norm1_bias",
                        extra=qscale)
    fc1_w, fc1_b = fold("fc1_kernel", "fc1_bias", "norm2_scale", "norm2_bias")
    return (qkv_w, qkv_b,
            params["proj_kernel"].to(dt).contiguous(),
            params["proj_bias"].to(f32).contiguous(),
            fc1_w, fc1_b,
            params["fc2_kernel"].to(dt).contiguous(),
            params["fc2_bias"].to(f32).contiguous())


def _ln_bare(x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = (x * x).mean(-1, keepdim=True) - mean * mean
    return (x - mean) * torch.rsqrt(var + 1e-6)


def _block_plain(x, weights, plan: _Plan, num_heads: int, gelu_degree: int):
    """The kernel's arithmetic in plain PyTorch (float32 with ``dt``
    rounding at the same points)."""
    qkv_w, qkv_b, proj_w, proj_b, fc1_w, fc1_b, fc2_w, fc2_b = weights
    dt = x.dtype
    b, n, c = x.shape
    d = c // num_heads

    def mm(a, w):  # dt operands, f32 accumulation
        return a.to(dt).float() @ w.float()

    xf = x.float()
    qkv = mm(_ln_bare(xf), qkv_w) + qkv_b
    heads = qkv.to(dt).float().view(b, n, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = heads[0], heads[1], heads[2]                     # [B, H, N, d]
    attn = torch.empty_like(q)
    qb, width = plan.qb, plan.width
    for a, st in enumerate(plan.starts):
        s = q[:, :, a * qb:(a + 1) * qb] @ k[:, :, st:st + width].transpose(-1, -2)
        if plan.mask is not None:
            s = s + plan.mask[a * qb:(a + 1) * qb]
        p = torch.exp(torch.clamp(s, max=SCORE_CLAMP)).to(dt).float()
        o = p @ v[:, :, st:st + width]
        attn[:, :, a * qb:(a + 1) * qb] = o * (1.0 / (p.sum(-1, keepdim=True)
                                                       + 1e-30))
    attn = attn.transpose(1, 2).reshape(b, n, c)
    x1 = xf + (mm(attn, proj_w) + proj_b)
    h = _gelu_poly(mm(_ln_bare(x1), fc1_w) + fc1_b, gelu_degree)
    out = x1 + (mm(h, fc2_w) + fc2_b)
    return out.to(dt)


_KERNEL_HEAD_DIMS = (8, 16, 32, 64)
_QUERY_TILE = 32  # must match QT in csrc/svtr_block.cu


@functools.lru_cache(maxsize=None)
def _lib():
    from mrn_tpu_torch.ops import _build

    lib = _build.load("svtr_block")
    p, i = ctypes.c_void_p, ctypes.c_int
    # dtype; x, 8 weights, mask, starts, 5 buffers; B N C heads hidden qb
    # width gelu_degree; stream
    lib.svtr_block_forward.argtypes = [i] + [p] * 16 + [i] * 8 + [p]
    lib.svtr_block_forward.restype = i
    lib.svtr_block_error_string.argtypes = [i]
    lib.svtr_block_error_string.restype = ctypes.c_char_p
    return lib


def _block_cuda(x, weights, plan: _Plan, num_heads: int, gelu_degree: int):
    global launches
    b, n, c = x.shape
    d = c // num_heads
    hidden = weights[4].shape[1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"svtr_block kernel takes float32/bfloat16, not {x.dtype}")
    if d * num_heads != c or d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"svtr_block kernel: head_dim {c}/{num_heads} not in "
                         f"{_KERNEL_HEAD_DIMS}")
    if plan.qb != n and plan.qb % _QUERY_TILE:
        raise ValueError(f"svtr_block kernel: band rows {plan.qb} not a "
                         f"multiple of {_QUERY_TILE}")
    if gelu_degree not in _GELU_COEFS:
        raise ValueError(f"gelu_degree must be 9 or 15, not {gelu_degree}")
    for t in weights:
        if t.device != x.device:
            raise ValueError("svtr_block kernel: weights and x on different devices")
    x = x.contiguous()
    dt, dev = x.dtype, x.device
    qkv = torch.empty((b, n, 3 * c), dtype=dt, device=dev)
    attn = torch.empty((b, n, c), dtype=dt, device=dev)
    x1 = torch.empty((b, n, c), dtype=torch.float32, device=dev)
    g = torch.empty((b, n, hidden), dtype=dt, device=dev)
    out = torch.empty_like(x)
    mask = plan.mask
    if mask is not None and mask.device != dev:
        raise ValueError("svtr_block kernel: mask on another device")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.svtr_block_forward(
            1 if dt == torch.bfloat16 else 0,
            ptr(x), *(ptr(t) for t in weights), ptr(mask), ptr(plan.starts_dev),
            ptr(qkv), ptr(attn), ptr(x1), ptr(g), ptr(out),
            b, n, c, num_heads, hidden, plan.qb, plan.width, gelu_degree,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("svtr_block kernel launch failed: "
                           + lib.svtr_block_error_string(rc).decode())
    launches += 1
    return out


def _prepare(x, params, mask, num_heads, scale, band):
    b, n, c = x.shape
    if c % num_heads:
        raise ValueError(f"dim {c} not divisible by {num_heads} heads")
    return _fold(params, scale, x.dtype), _Plan(n, mask, band, x.device)


def fused_block_reference(x: torch.Tensor, params: Dict[str, torch.Tensor],
                          mask, num_heads: int, scale: float,
                          band: Optional[tuple] = None,
                          gelu_degree: int = 9) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device.  Same arguments as
    ``fused_block``."""
    weights, plan = _prepare(x, params, mask, num_heads, scale, band)
    return _block_plain(x, weights, plan, num_heads, gelu_degree)


def fused_block(x: torch.Tensor, params: Dict[str, torch.Tensor], mask,
                num_heads: int, scale: float, band: Optional[tuple] = None,
                gelu_degree: int = 9) -> torch.Tensor:
    """x: [B, N, C]; params: the Block's parameters under the JAX names
    (kernels [in, out]); mask: additive [N, N] (tensor or numpy) or None;
    ``band`` (h, w, hk, wk): geometry of a COLUMN-major Local mask, which
    enables the banded path when ``_band_spec`` finds a plan.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (or raises).  Other devices raise."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_block: unsupported device {x.device}")
    weights, plan = _prepare(x, params, mask, num_heads, scale, band)
    if x.device.type == "cpu":
        return _block_plain(x, weights, plan, num_heads, gelu_degree)
    return _block_cuda(x, weights, plan, num_heads, gelu_degree)
