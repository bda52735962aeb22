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
  LN2 into fc1 on the host side (``_fold``), once per set of weights when the
  caller keeps a ``FoldCache`` (each ``models.svtr.Block`` does);
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

``fused_block_int8`` is the w8a8 Block (``_make_kernel_int8``): LN1/LN2 keep
their affine (no folding), each projection quantizes its input per tensor
(``clip(round(h * inv), -127, 127)``) and runs int8 x int8 -> int32 against a
per-channel int8 kernel, then ``acc * deq + bias`` in float32; the attention
takes the max-subtract softmax normalised before PV over the full mask, with
operands in x's dtype (or int8 with ``attn_int8``) and a float32 output;
the residual stream stays float32.  Its scales, dequant rows, float32 rows
and k-contiguous kernel copies come from ``prepare_int8``, once per set of
weights.  Its kernel is ``csrc/svtr_block_int8.cu``, with the same CPU /
CUDA rule; the kernel bands Local blocks with the same plan, which drops
only keys whose softmax weight is exactly 0.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = ["FoldCache", "Int8Weights", "PARAM_KEYS", "SCORE_CLAMP", "folds", "fused_block",
           "fused_block_int8", "fused_block_int8_reference", "fused_block_reference", "int8_launches", "launches",
           "prepare_int8"]

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
# CUDA tensor; the plain version never counts), and of the w8a8 Block (one
# per fused_block_int8 call on a CUDA tensor).
launches = 0
int8_launches = 0
# Count of host-side weight folds (``_fold`` calls): a warm request through
# Blocks with a FoldCache adds none.
folds = 0


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
    global folds
    folds += 1
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


# A Block's 12 parameters under the JAX names
PARAM_KEYS = ("norm1_scale", "norm1_bias", "qkv_kernel", "qkv_bias",
              "proj_kernel", "proj_bias", "norm2_scale", "norm2_bias",
              "fc1_kernel", "fc1_bias", "fc2_kernel", "fc2_bias")


def _leaf_key(t: torch.Tensor):
    """What identifies the values of a weight tensor while it stays alive:
    its storage address, its version counter (bumped by every in-place
    write through it or its views), dtype, device, shape and strides.
    Inference tensors have no version counter: None (never cached)."""
    if t.is_inference():
        return None
    return (t.data_ptr(), t._version, t.dtype, t.device, tuple(t.shape), t.stride())


class FoldCache:
    """A Block's folded operands (``_fold``), reused while its 12 weights are
    the same tensors with the same contents, folded again otherwise.

    The key holds each leaf's storage address, version counter, dtype,
    device, shape and strides, beside the scale and the working dtype; the
    cache keeps the keyed leaves alive, so no other tensor can take their
    addresses while the key stands.  So an in-place update (``add_``, an
    optimizer step, ``load_state_dict``'s copies), a swap of ``p.data``, a
    ``Module.to`` and ``functional_call`` with other tensors each fold anew.
    A write through a tensor obtained by ``.data`` bypasses the version
    counter and is not seen: the port writes weights only through the
    tensors themselves."""

    def __init__(self):
        self.key = self.leaves = self.weights = None

    def weights_for(self, params: Dict[str, torch.Tensor], scale: float, dt: torch.dtype):
        leaves = tuple(params[k] for k in PARAM_KEYS)
        key = (float(scale), dt) + tuple(_leaf_key(t) for t in leaves)
        if key != self.key or None in key:
            self.weights = _fold(params, scale, dt)
            self.key, self.leaves = key, leaves
        return self.weights


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
_QUERY_TILE = 32  # band query blocks: a multiple of QT in csrc/svtr_common.cuh


@functools.lru_cache(maxsize=None)
def _lib():
    from mrn_tpu_torch.ops import _build

    lib = _build.load("svtr_block")
    p, i = ctypes.c_void_p, ctypes.c_int
    # dtype; x, 8 weights, mask, starts, 5 buffers; B N C heads hidden qb
    # width gelu_degree; stream
    lib.svtr_block_forward.argtypes = [i] + [p] * 16 + [i] * 8 + [p]
    lib.svtr_block_forward.restype = i
    # dtype, N, C, heads, hidden, qb, width; int32 out[9]
    lib.svtr_block_plan.argtypes = [i] * 7 + [p]
    lib.svtr_block_plan.restype = i
    lib.svtr_block_error_string.argtypes = [i]
    lib.svtr_block_error_string.restype = ctypes.c_char_p
    return lib


def _kernel_plan(dtype, n, c, heads, hidden, qb, width):
    """The built library's launch plan for a ``[*, n, c]`` Block of
    ``dtype``: its attention's (query rows per block, key tiles held in
    registers, key segments, passes over the keys, dynamic shared bytes),
    then the output columns per 128-row block of the qkv, proj, fc1 and fc2
    projections."""
    out = (ctypes.c_int * 9)()
    _lib().svtr_block_plan(1 if dtype == torch.bfloat16 else 0, n, c, heads, hidden, qb,
                           width, out)
    return tuple(out)


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


def _prepare(x, params, mask, num_heads, scale, band, cache=None):
    b, n, c = x.shape
    if c % num_heads:
        raise ValueError(f"dim {c} not divisible by {num_heads} heads")
    weights = (_fold(params, scale, x.dtype) if cache is None
               else cache.weights_for(params, scale, x.dtype))
    return weights, _Plan(n, mask, band, x.device)


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
                gelu_degree: int = 9, cache: Optional[FoldCache] = None) -> torch.Tensor:
    """x: [B, N, C]; params: the Block's parameters under the JAX names
    (kernels [in, out]); mask: additive [N, N] (tensor or numpy) or None;
    ``band`` (h, w, hk, wk): geometry of a COLUMN-major Local mask, which
    enables the banded path when ``_band_spec`` finds a plan; ``cache``: the
    caller's ``FoldCache``, which folds the weights once per set of weights
    (None folds on every call).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (or raises).  Other devices raise."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_block: unsupported device {x.device}")
    weights, plan = _prepare(x, params, mask, num_heads, scale, band, cache)
    if x.device.type == "cpu":
        return _block_plain(x, weights, plan, num_heads, gelu_degree)
    return _block_cuda(x, weights, plan, num_heads, gelu_degree)


# ------------------------------------------------------------ w8a8 int8 Block
_PROJ_NAMES = ("qkv", "proj", "fc1", "fc2")


class Int8Weights(NamedTuple):
    """A w8a8 Block's operands as its kernel takes them (``prepare_int8``)."""
    norms: Tuple[torch.Tensor, ...]      # LN1 scale, bias, LN2 scale, bias: float32
    kernels: Tuple[torch.Tensor, ...]    # qkv, proj, fc1, fc2: int8 [in, out]
    biases: Tuple[torch.Tensor, ...]     # float32
    deqs: Tuple[torch.Tensor, ...]       # float32 dequant rows s * w_scale[out]
    inv: torch.Tensor                    # float32 [8]: 0-3 projections, 4-6 q, k, v
    kernels_t: Tuple[torch.Tensor, ...]  # the kernels transposed: int8 [out, in], contiguous


def prepare_int8(params: Dict[str, torch.Tensor],
                 quant: Dict[str, torch.Tensor]) -> Int8Weights:
    """Host prep of a w8a8 Block (``svtr_block.py:446-478``), done once per
    set of weights: per projection the activation scale ``s = max(amax,
    1e-12) / 127``, its multiplier ``1 / s`` and the dequant row ``s *
    w_scale[out]``; the q, k, v multipliers for the int8-attention mode; LN
    rows and biases as float32 copies of their values (in x's dtype); each
    int8 kernel also transposed into a contiguous ``[out, in]`` copy, whose
    rows the CUDA kernel streams ``in`` contiguous.  ``params``: the Block's
    leaves under the JAX names, the four projection kernels int8 ``[in,
    out]``; ``quant``: its ``act_amax_*`` and ``w_scale_*``."""
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=params["qkv_bias"].device)
    with torch.no_grad():
        inv, deqs = [], []
        for name in _PROJ_NAMES:
            s = torch.clamp(quant[f"act_amax_{name}"].to(f32), min=1e-12) / 127.0
            inv.append(1.0 / s)
            deqs.append((s * quant[f"w_scale_{name}"].to(f32)).contiguous())
        for name in ("q", "k", "v"):
            amax = quant.get(f"act_amax_{name}", zero).to(f32)
            inv.append(1.0 / (torch.clamp(amax, min=1e-12) / 127.0))
        inv.append(zero)
        norms = tuple(params[k].to(f32).contiguous()
                      for k in ("norm1_scale", "norm1_bias", "norm2_scale", "norm2_bias"))
        kernels = tuple(params[f"{n}_kernel"].contiguous() for n in _PROJ_NAMES)
        biases = tuple(params[f"{n}_bias"].to(f32).contiguous() for n in _PROJ_NAMES)
        return Int8Weights(norms, kernels, biases, tuple(deqs), torch.stack(inv),
                           tuple(k.t().contiguous() for k in kernels))


def _q8(h: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """``clip(round(h * inv), -127, 127)``: the Pallas kernel's activation
    quantization (a multiply by the reciprocal, rounding half to even), the
    int8 values held in float32."""
    return torch.clamp(torch.round(h * inv), -127.0, 127.0)


def _block_int8_plain(x, w: Int8Weights, mask, num_heads: int, scale: float,
                      attn_int8: bool, gelu_degree: int):
    """The w8a8 kernel's arithmetic in plain PyTorch (``_make_kernel_int8``):
    LN with affine, int8 products exact in float32, ``acc * deq + bias``,
    max-subtract softmax normalised before PV, float32 attention output."""
    from mrn_tpu_torch.ops.int8 import int_matmul

    (n1s, n1b, n2s, n2b), kernels, biases, deqs, inv, _ = w
    dt = x.dtype
    b, n, c = x.shape
    d = c // num_heads

    def proj(i, h):
        return int_matmul(_q8(h, inv[i]), kernels[i]) * deqs[i] + biases[i]

    xf = x.float()
    qkv = proj(0, _ln_bare(xf) * n1s + n1b)
    heads = qkv.view(b, n, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = heads[0] * scale, heads[1], heads[2]             # [B, H, N, d]
    if attn_int8:
        s = int_matmul(_q8(q, inv[4]), _q8(k, inv[5]).transpose(-1, -2)) \
            * (1.0 / (inv[4] * inv[5]))
    else:
        s = q.to(dt).float() @ k.to(dt).float().transpose(-1, -2)
    if mask is not None:
        s = s + mask
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    if attn_int8:
        o = int_matmul(torch.round(p * 127.0), _q8(v, inv[6])) * (1.0 / (inv[6] * 127.0))
    else:
        o = p.to(dt).float() @ v.to(dt).float()
    x1 = xf + proj(1, o.transpose(1, 2).reshape(b, n, c))
    h = _gelu_poly(proj(2, _ln_bare(x1) * n2s + n2b), gelu_degree)
    return (x1 + proj(3, h)).to(dt)


@functools.lru_cache(maxsize=None)
def _lib_int8():
    from mrn_tpu_torch.ops import _build

    lib = _build.load("svtr_block_int8")
    p, i = ctypes.c_void_p, ctypes.c_int
    # dtype attn_int8; x, 4 norms, 4 x (kernel^T, bias, deq), inv, mask,
    # starts, 5 buffers; B N C heads hidden qb width gelu_degree; scale; stream
    lib.svtr_block_int8_forward.argtypes = [i, i] + [p] * 25 + [i] * 8 + [ctypes.c_float, p]
    lib.svtr_block_int8_forward.restype = i
    # dtype attn_int8 N C heads hidden qb width; int32 out[9]
    lib.svtr_block_int8_plan.argtypes = [i] * 8 + [p]
    lib.svtr_block_int8_plan.restype = i
    lib.svtr_block_int8_error_string.argtypes = [i]
    lib.svtr_block_int8_error_string.restype = ctypes.c_char_p
    return lib


def _int8_kernel_plan(dtype, attn_int8, n, c, heads, hidden, qb, width):
    """The built library's launch plan for a ``[*, n, c]`` w8a8 Block: its
    attention's (query rows per block, key tiles held in registers, key
    segments, passes over the keys, dynamic shared bytes), then the output
    columns per 128-row block of the qkv, proj, fc1 and fc2 projections."""
    out = (ctypes.c_int * 9)()
    _lib_int8().svtr_block_int8_plan(1 if dtype == torch.bfloat16 else 0, int(attn_int8), n,
                                     c, heads, hidden, qb, width, out)
    return tuple(out)


def _block_int8_cuda(x, w: Int8Weights, plan: _Plan, num_heads: int, scale: float,
                     attn_int8: bool, gelu_degree: int):
    global int8_launches
    from mrn_tpu_torch.ops.int8 import MAX_EXACT_K

    norms, kernels, biases, deqs, inv, kernels_t = w
    b, n, c = x.shape
    d = c // num_heads
    hidden = kernels[2].shape[1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"svtr_block_int8 kernel takes float32/bfloat16, not {x.dtype}")
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"svtr_block_int8 kernel: head_dim {d} not in {_KERNEL_HEAD_DIMS}")
    if c % 16 or c > 256 or hidden % 16:
        raise ValueError(f"svtr_block_int8 kernel: dim {c} and hidden {hidden} must be "
                         "multiples of 16, dim at most 256")
    if hidden > MAX_EXACT_K:
        raise ValueError(f"svtr_block_int8 kernel: hidden {hidden} > {MAX_EXACT_K}")
    if plan.qb != n and plan.qb % _QUERY_TILE:
        raise ValueError(f"svtr_block_int8 kernel: band rows {plan.qb} not a "
                         f"multiple of {_QUERY_TILE}")
    if gelu_degree not in _GELU_COEFS:
        raise ValueError(f"gelu_degree must be 9 or 15, not {gelu_degree}")
    for wt, shape in zip(kernels_t, ((3 * c, c), (c, c), (hidden, c), (c, hidden))):
        if wt.dtype != torch.int8 or tuple(wt.shape) != shape or not wt.is_contiguous():
            raise ValueError(f"svtr_block_int8 kernel: transposed projection kernel "
                             f"{wt.dtype} {tuple(wt.shape)}, expected contiguous int8 {shape}")
    for t in (*norms, *kernels_t, *biases, *deqs, inv, plan.mask):
        if t is not None and t.device != x.device:
            raise ValueError("svtr_block_int8 kernel: tensors on different devices")
    if plan.mask is not None and (plan.mask.dtype != torch.float32 or not plan.mask.is_contiguous()
                                  or tuple(plan.mask.shape) != (n, plan.width)):
        raise ValueError(f"svtr_block_int8 kernel: the mask must be a contiguous float32 "
                         f"[N, {plan.width}]")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    dt, dev = x.dtype, x.device
    qkv = torch.empty((b, n, 3 * c), dtype=torch.int8 if attn_int8 else dt, device=dev)
    attn = torch.empty((b, n, c), dtype=torch.float32, device=dev)
    x1 = torch.empty((b, n, c), dtype=torch.float32, device=dev)
    g = torch.empty((b, n, hidden), dtype=torch.int8, device=dev)
    out = torch.empty_like(x)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    per_proj = [ptr(t) for trio in zip(kernels_t, biases, deqs) for t in trio]
    lib = _lib_int8()
    with torch.cuda.device(dev):
        rc = lib.svtr_block_int8_forward(
            1 if dt == torch.bfloat16 else 0, int(attn_int8), ptr(x),
            *(ptr(t) for t in norms), *per_proj, ptr(inv), ptr(plan.mask),
            ptr(plan.starts_dev), ptr(qkv), ptr(attn), ptr(x1), ptr(g), ptr(out),
            b, n, c, num_heads, hidden, plan.qb, plan.width, gelu_degree, scale,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("svtr_block_int8 kernel launch failed: "
                           + lib.svtr_block_int8_error_string(rc).decode())
    int8_launches += 1
    return out


def _int8_mask(x, mask, num_heads):
    if x.shape[2] % num_heads:
        raise ValueError(f"dim {x.shape[2]} not divisible by {num_heads} heads")
    return None if mask is None else torch.as_tensor(mask, dtype=torch.float32,
                                                     device=x.device)


def fused_block_int8_reference(x: torch.Tensor, weights: Int8Weights, mask,
                               num_heads: int, scale: float, attn_int8: bool = False,
                               gelu_degree: int = 9) -> torch.Tensor:
    """Plain PyTorch version of the w8a8 kernel, on any device, over the full
    mask as the Pallas kernel attends.  The arguments of
    ``fused_block_int8`` but ``band``."""
    mask = _int8_mask(x, mask, num_heads)
    return _block_int8_plain(x, weights, mask, num_heads, scale, attn_int8, gelu_degree)


def fused_block_int8(x: torch.Tensor, weights: Int8Weights, mask, num_heads: int,
                     scale: float, attn_int8: bool = False, gelu_degree: int = 9,
                     band: Optional[tuple] = None) -> torch.Tensor:
    """w8a8 inference Block (``_make_kernel_int8``).  x: [B, N, C] float32 or
    bfloat16; weights: the Block's ``prepare_int8`` operands; mask: the
    additive ``[N, N]`` mask or None; ``attn_int8`` also runs QK^T and PV
    int8 (``set_attention_int8``); ``band`` (h, w, hk, wk): geometry of a
    COLUMN-major Local mask, with which the kernel attends only to each
    query block's window (``_band_spec``; exact: the keys it skips have p =
    0).

    A CPU tensor takes the plain version over the full mask; a CUDA tensor
    launches the kernel (``csrc/svtr_block_int8.cu``) or raises.  Other
    devices raise."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_block_int8: unsupported device {x.device}")
    mask = _int8_mask(x, mask, num_heads)
    if x.device.type == "cpu":
        return _block_int8_plain(x, weights, mask, num_heads, scale, attn_int8, gelu_degree)
    plan = _Plan(x.shape[1], mask, band, x.device)
    return _block_int8_cuda(x, weights, plan, num_heads, scale, attn_int8, gelu_degree)
