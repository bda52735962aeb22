"""Fused SVTR training Block: hand-written CUDA kernels for its forward and
the two halves of its backward, plus their plain PyTorch versions (mirrors
``mrn_tpu/ops/svtr_train_block.py``).

For ``x [B, N, C]`` in the working dtype ``dt`` (float32 or bfloat16), the
Block's 12 parameters and per-image droppath scales ``dm_a``, ``dm_b``
``[B, 1]`` (keep mask / keep, float32)::

    y   = x + dm_a * proj( attention( LN1(x) @ Wqkv + bqkv ) )
    out = y + dm_b * fc2( gelu15( LN2(y) @ W1 + b1 ) )

with the JAX package's Pallas numerics:

- single-pass LayerNorm (``E[x^2] - mean^2``, eps 1e-6) with its affine
  applied in the kernel (not folded);
- every product takes both operands rounded to ``dt``, float32 accumulation;
- softmax: max-subtract, ``exp(s - m)`` rounded to ``dt`` before PV, the row
  sum over those rounded values (the Pallas kernel's ones-column of V) and
  the normalise after PV with ``+1e-30``;
- q is scaled from the float32 qkv accumulator before its rounding; ``y``
  and ``h1`` feed LN2 / the final residual and the GELU in float32;
- GELU through the degree-15 minimax erf polynomial (``_gelu15``), its
  derivative ``_gelu15_grad`` the same polynomial's.

The forward saves the residuals ``qkv [B, N, 3C]``, ``attn_cat``, ``y``
``[B, N, C]`` and ``h1 [B, N, 4C]`` in ``dt``.  The backward runs the tail
(MLP, LN2 and proj backward -> ``dy``, ``dattn`` and 8 weight grads), the
attention middle (vjp of the plain ``banded_attention_xla`` /
``xla_attention``, as the JAX package takes ``jax.vjp``) and the head (qkv
projection and LN1 backward -> ``dx`` and 4 grads).

``fused_block_train`` launches the CUDA kernels (``csrc/svtr_train_block.cu``;
the forward's projections and the backward's data gradients on
``csrc/svtr_gemm_tc.cuh``, the backward's weight gradients on
``csrc/svtr_wgrad_tc.cuh``, the forward's attention on
``csrc/svtr_attention_tc.cuh``) for CUDA tensors and runs the plain versions
for CPU tensors; there is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from mrn_tpu_torch.ops.svtr_attention import banded_attention_xla, xla_attention
from mrn_tpu_torch.ops.svtr_block import (PARAM_KEYS, _ERF_COEFS, _ERF_Z0SQ, _band_spec,
                                          _erf_poly, _ln_bare, _Plan)

__all__ = ["PARAM_KEYS", "bwd_head_reference", "bwd_tail_reference",
           "forward_reference", "fused_block_train", "launches"]

# CUDA launches per kernel (one per call of its C entry point on a CUDA
# tensor; the plain versions never count).
launches = {"train_fwd": 0, "train_bwd_tail": 0, "train_bwd_head": 0}

_KERNEL_HEAD_DIMS = (8, 16, 32, 64)
_QUERY_TILE = 32  # band query blocks: a multiple of QT in csrc/svtr_common.cuh


# ------------------------------------------------------------- host pieces
def _gelu15(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + _erf_poly(x * (2.0 ** -0.5), _ERF_COEFS))


def _gelu15_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx of ``_gelu15`` with the same polynomial and clip: with z =
    x/sqrt(2), u = (2/Z0) min(z^2, Z0) - 1, E(z) = clip(z P(u), -1, 1),
    E'(z) = P(u) + z P'(u) (4z/Z0) [z^2 < Z0] (0 where the clip binds) and
    gelu' = 0.5 (1 + E) + 0.5 x E'(z) / sqrt(2)."""
    inv_sqrt2 = 2.0 ** -0.5
    z = x * inv_sqrt2
    zsq = z * z
    u = (2.0 / _ERF_Z0SQ) * torch.clamp(zsq, max=_ERF_Z0SQ) - 1.0
    p = torch.full_like(u, _ERF_COEFS[-1])
    dp = torch.zeros_like(u)
    for c in _ERF_COEFS[-2::-1]:  # Horner for P and P' together
        dp = dp * u + p
        p = p * u + c
    e_raw = z * p
    du_dz = torch.where(zsq < _ERF_Z0SQ, (4.0 / _ERF_Z0SQ) * z, torch.zeros_like(z))
    de = p + z * dp * du_dz
    de = torch.where(e_raw.abs() < 1.0, de, torch.zeros_like(de))
    e = torch.clamp(e_raw, -1.0, 1.0)
    return 0.5 * (1.0 + e) + 0.5 * x * de * inv_sqrt2


def _ln_stats(t: torch.Tensor):
    """(normalised t, rstd), float32, from the single-pass statistics."""
    tf = t.float()
    mean = tf.mean(-1, keepdim=True)
    var = (tf * tf).mean(-1, keepdim=True) - mean * mean
    rstd = torch.rsqrt(var + 1e-6)
    return (tf - mean) * rstd, rstd


def _ln_bwd(d_norm, normed, rstd):
    """Backward of t -> (t - mean) / std given the normalised value and rstd:
    dt = rstd (d - mean(d) - normed mean(d normed))."""
    return rstd * (d_norm - d_norm.mean(-1, keepdim=True)
                   - normed * (d_norm * normed).mean(-1, keepdim=True))


def _mm(a, b, dt):
    """``a @ b`` with both operands rounded to ``dt``, float32 accumulation."""
    return a.to(dt).float() @ b.to(dt).float()


def _mm_tn(a, b, dt):
    """``a^T @ b`` over all rows of ``a [..., K1]`` and ``b [..., K2]``, both
    rounded to ``dt``: a weight gradient summed over the batch."""
    return _mm(a.reshape(-1, a.shape[-1]).t(), b.reshape(-1, b.shape[-1]), dt)


def _vec(params, name):
    return params[name].float()


def _row_scale(dm, b):
    return dm.float().reshape(b, 1, 1)


# ------------------------------------------------------------ plain versions
def forward_reference(x, params, dm_a, dm_b, num_heads: int, scale: float, band):
    """Plain version of the forward kernel (``_make_train_kernel``'s
    arithmetic).  Returns ``out`` and the residuals ``(qkv, attn_cat, y,
    h1)``, all in x's dtype."""
    dt = x.dtype
    b, n, c = x.shape
    d = c // num_heads
    plan = _Plan(n, None, band, x.device)   # banded Local, or one full window
    qb, width = plan.qb, plan.width
    xf = x.float()
    h = _ln_bare(xf) * _vec(params, "norm1_scale") + _vec(params, "norm1_bias")
    qkv = _mm(h, params["qkv_kernel"], dt) + _vec(params, "qkv_bias")
    heads = qkv.view(b, n, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    q = (heads[0] * scale).to(dt).float()
    k, v = heads[1].to(dt).float(), heads[2].to(dt).float()
    attn = torch.empty_like(q)
    for a, st in enumerate(plan.starts):
        rows = slice(a * qb, (a + 1) * qb)
        s = q[:, :, rows] @ k[:, :, st:st + width].transpose(-1, -2)
        if plan.mask is not None:
            s = s + plan.mask[rows]
        p = torch.exp(s - s.amax(-1, keepdim=True)).to(dt).float()
        o = p @ v[:, :, st:st + width]
        attn[:, :, rows] = o * (1.0 / (p.sum(-1, keepdim=True) + 1e-30))
    attn_cat = attn.transpose(1, 2).reshape(b, n, c)
    a_out = _mm(attn_cat, params["proj_kernel"], dt) + _vec(params, "proj_bias")
    y = xf + a_out * _row_scale(dm_a, b)
    h = _ln_bare(y) * _vec(params, "norm2_scale") + _vec(params, "norm2_bias")
    h1 = _mm(h, params["fc1_kernel"], dt) + _vec(params, "fc1_bias")
    h2 = _mm(_gelu15(h1), params["fc2_kernel"], dt) + _vec(params, "fc2_bias")
    out = y + h2 * _row_scale(dm_b, b)
    return out.to(dt), (qkv.to(dt), attn_cat.to(dt), y.to(dt), h1.to(dt))


def _tail(g, y, h1, attn_cat, params, dm_a, dm_b):
    """MLP + LN2 + proj backward in float32: (dy, dattn, 8 grads)."""
    dt = y.dtype
    b = g.shape[0]
    gg = g.float()
    dh2 = gg * _row_scale(dm_b, b)
    h1f = h1.float()
    d_w2 = _mm_tn(_gelu15(h1f), dh2, dt)
    d_b2 = dh2.sum((0, 1))
    dh1 = _mm(dh2, params["fc2_kernel"].t(), dt) * _gelu15_grad(h1f)
    y_norm, rstd2 = _ln_stats(y)
    z2 = y_norm * _vec(params, "norm2_scale") + _vec(params, "norm2_bias")
    d_w1 = _mm_tn(z2, dh1, dt)
    d_b1 = dh1.sum((0, 1))
    dz2 = _mm(dh1, params["fc1_kernel"].t(), dt)
    d_n2s = (dz2 * y_norm).sum((0, 1))
    d_n2b = dz2.sum((0, 1))
    dy = gg + _ln_bwd(dz2 * _vec(params, "norm2_scale"), y_norm, rstd2)
    da = dy * _row_scale(dm_a, b)
    d_wp = _mm_tn(attn_cat.float(), da, dt)
    d_bp = da.sum((0, 1))
    dattn = _mm(da, params["proj_kernel"].t(), dt)
    grads = dict(norm2_scale=d_n2s, norm2_bias=d_n2b, fc1_kernel=d_w1,
                 fc1_bias=d_b1, fc2_kernel=d_w2, fc2_bias=d_b2,
                 proj_kernel=d_wp, proj_bias=d_bp)
    return dy, dattn, grads


def _head(x, dy, dqkv, params):
    """qkv projection + LN1 backward in float32: (dx, 4 grads); ``dy`` and
    ``dqkv`` as the caller hands them over."""
    dt = x.dtype
    dqkv = dqkv.float()
    x_norm, rstd1 = _ln_stats(x)
    z1 = x_norm * _vec(params, "norm1_scale") + _vec(params, "norm1_bias")
    d_wqkv = _mm_tn(z1, dqkv, dt)
    d_bqkv = dqkv.sum((0, 1))
    dz1 = _mm(dqkv, params["qkv_kernel"].t(), dt)
    d_n1s = (dz1 * x_norm).sum((0, 1))
    d_n1b = dz1.sum((0, 1))
    dx = dy.float() + _ln_bwd(dz1 * _vec(params, "norm1_scale"), x_norm, rstd1)
    grads = dict(norm1_scale=d_n1s, norm1_bias=d_n1b, qkv_kernel=d_wqkv,
                 qkv_bias=d_bqkv)
    return dx, grads


def bwd_tail_reference(g, y, h1, attn_cat, params, dm_a, dm_b):
    """Plain version of the backward tail kernel
    (``_make_bwd_tail_kernel``): ``dy`` and ``dattn`` in the working dtype,
    8 float32 grads summed over the batch."""
    dy, dattn, grads = _tail(g, y, h1, attn_cat, params, dm_a, dm_b)
    return dy.to(y.dtype), dattn.to(y.dtype), grads


def bwd_head_reference(x, dy, dqkv, params):
    """Plain version of the backward head kernel
    (``_make_bwd_head_kernel``): ``dx`` in the working dtype, 4 float32
    grads summed over the batch."""
    dx, grads = _head(x, dy, dqkv, params)
    return dx.to(x.dtype), grads


def _attn_bwd(qkv, dattn, num_heads: int, scale: float, band, dt):
    """Attention-core backward (``_attn_bwd_xla``): the vjp of the plain
    banded / full formulation at the saved ``qkv [B, N, 3C]`` for the
    head-concatenated cotangent ``dattn [B, N, C]``; returns ``dqkv [B, N,
    3C]`` float32."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    qkvf = qkv.float().view(b, n, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    leaves = [t.to(dt).detach().requires_grad_()
              for t in (qkvf[0] * scale, qkvf[1], qkvf[2])]
    dattn_h = dattn.reshape(b, n, num_heads, d).transpose(1, 2).to(dt)
    with torch.enable_grad():
        out = (banded_attention_xla(*leaves, band) if band is not None
               else xla_attention(*leaves, None))
        dq, dk, dv = torch.autograd.grad(out, leaves, dattn_h)
    dqkv = torch.stack([dq.float() * scale, dk.float(), dv.float()])
    return dqkv.permute(1, 3, 0, 2, 4).reshape(b, n, c3)


# -------------------------------------------------------------- CUDA kernels
@functools.lru_cache(maxsize=None)
def _lib():
    from mrn_tpu_torch.ops import _build

    lib = _build.load("svtr_train_block")
    p, i = ctypes.c_void_p, ctypes.c_int
    # dtype; x, 12 params, mask, starts, dm_a, dm_b, 5 outputs, 4 scratch;
    # B N C heads hidden qb width; scale; stream
    lib.svtr_train_forward.argtypes = ([i] + [p] * 26 + [i] * 7
                                       + [ctypes.c_float, p])
    # dtype; g y h1 attn, n2s n2b w1 w2 wp, dm_a dm_b, dy dattn, 6 grads,
    # 5 scratch; B N C hidden; stream
    lib.svtr_train_bwd_tail.argtypes = [i] + [p] * 24 + [i] * 4 + [p]
    # dtype; x dy dqkv n1s n1b wqkv, dx, 3 grads, 3 scratch; B N C; stream
    lib.svtr_train_bwd_head.argtypes = [i] + [p] * 13 + [i] * 3 + [p]
    # dtype, N, C, heads, hidden, qb, width; int32 out[9]
    lib.svtr_train_plan.argtypes = [i] * 7 + [p]
    lib.svtr_train_plan.restype = i
    # dtype, M, C, hidden; int32 out[20]
    lib.svtr_train_bwd_plan.argtypes = [i] * 4 + [p]
    lib.svtr_train_bwd_plan.restype = i
    lib.svtr_train_workspace.argtypes = [i] * 4
    lib.svtr_train_workspace.restype = ctypes.c_longlong
    for fn in (lib.svtr_train_forward, lib.svtr_train_bwd_tail,
               lib.svtr_train_bwd_head):
        fn.restype = i
    lib.svtr_train_error_string.argtypes = [i]
    lib.svtr_train_error_string.restype = ctypes.c_char_p
    return lib


def _kernel_plan(dtype, n, c, heads, hidden, qb, width):
    """The built library's launch plan of the forward for a ``[*, n, c]``
    Block of ``dtype``: its attention's (query rows per block, key tiles held
    in registers, key segments, passes over the keys, dynamic shared bytes),
    then the output columns per 128-row block of the qkv, proj, fc1 and fc2
    projections."""
    out = (ctypes.c_int * 9)()
    _lib().svtr_train_plan(_dtype_code(dtype), n, c, heads, hidden, qb, width, out)
    return tuple(out)


def _bwd_plan(dtype, m, c, hidden):
    """The built library's launch plan of the backward for ``m`` rows of a
    Block of width ``c``: per weight gradient (dW2, dW1, dWp, dWqkv) its
    (k1 tile, k2 tile, row chunks, rows a chunk), then the output columns
    per 128-row block of the dh1, dz2, dattn and dz1 projections."""
    out = (ctypes.c_int * 20)()
    _lib().svtr_train_bwd_plan(_dtype_code(dtype), m, c, hidden, out)
    grads = {name: tuple(out[4 * i:4 * i + 4])
             for i, name in enumerate(("dW2", "dW1", "dWp", "dWqkv"))}
    return grads, dict(zip(("dh1", "dz2", "dattn", "dz1"), out[16:20]))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(x, tensors, what):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} kernel takes float32/bfloat16, not {x.dtype}")
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"{what} kernel: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel takes contiguous tensors")


def _mats(params, dt, names):
    out = []
    for name in names:
        t = params[name]
        if t.dtype != dt:
            raise TypeError(f"svtr_train_block kernel: {name} is {t.dtype}, "
                            f"the activations {dt}")
        out.append(t.contiguous())
    return out


def _vecs(params, names):
    return [params[name].float().contiguous() for name in names]


def _call(fn, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: "
                           + _lib().svtr_train_error_string(rc).decode())


def _dtype_code(dt):
    return 1 if dt == torch.bfloat16 else 0


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _forward_cuda(x, params, dm_a, dm_b, num_heads: int, scale: float, band):
    b, n, c = x.shape
    d = c // num_heads
    dt, dev = x.dtype, x.device
    hidden = params["fc1_kernel"].shape[1]
    if d * num_heads != c or d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"svtr_train_block kernel: head_dim {c}/{num_heads} not in "
                         f"{_KERNEL_HEAD_DIMS}")
    plan = _Plan(n, None, band, dev)
    if plan.starts_dev is not None and plan.qb % _QUERY_TILE:
        raise ValueError(f"svtr_train_block kernel: band rows {plan.qb} not a multiple "
                         f"of {_QUERY_TILE}")
    x = x.contiguous()
    w_qkv, w_p, w_1, w_2 = _mats(params, dt, ("qkv_kernel", "proj_kernel",
                                              "fc1_kernel", "fc2_kernel"))
    n1s, n1b, b_qkv, b_p, n2s, n2b, b_1, b_2 = _vecs(
        params, ("norm1_scale", "norm1_bias", "qkv_bias", "proj_bias",
                 "norm2_scale", "norm2_bias", "fc1_bias", "fc2_bias"))
    dm_a, dm_b = dm_a.float().contiguous(), dm_b.float().contiguous()
    _check(x, (w_qkv, w_p, w_1, w_2, n1s, dm_a, dm_b), "svtr_train_block")
    new = functools.partial(torch.empty, device=dev)
    out, attn, y = new((b, n, c), dtype=dt), new((b, n, c), dtype=dt), new((b, n, c), dtype=dt)
    qkv, h1 = new((b, n, 3 * c), dtype=dt), new((b, n, hidden), dtype=dt)
    q_scaled, gact = new((b, n, c), dtype=dt), new((b, n, hidden), dtype=dt)
    y32, stats = new((b, n, c), dtype=torch.float32), new((b * n, 2), dtype=torch.float32)
    lib = _lib()
    with torch.cuda.device(dev):
        _call(lib.svtr_train_forward, _dtype_code(dt),
              *(_ptr(t) for t in (x, n1s, n1b, w_qkv, b_qkv, w_p, b_p, n2s, n2b,
                                  w_1, b_1, w_2, b_2, plan.mask, plan.starts_dev, dm_a,
                                  dm_b, out, qkv, attn, y, h1, q_scaled, y32, gact, stats)),
              b, n, c, num_heads, hidden, plan.qb, plan.width, ctypes.c_float(scale),
              _stream(dev))
    launches["train_fwd"] += 1
    return out, (qkv, attn, y, h1)


def _workspace(kind: int, m: int, c: int, hidden: int, dev):
    return torch.empty(int(_lib().svtr_train_workspace(kind, m, c, hidden)),
                       dtype=torch.float32, device=dev)


def _bwd_tail_cuda(g, y, h1, attn_cat, params, dm_a, dm_b):
    b, n, c = y.shape
    dt, dev = y.dtype, y.device
    hidden = h1.shape[-1]
    g = g.to(dt).contiguous()
    w_1, w_2, w_p = _mats(params, dt, ("fc1_kernel", "fc2_kernel", "proj_kernel"))
    n2s, n2b = _vecs(params, ("norm2_scale", "norm2_bias"))
    dm_a, dm_b = dm_a.float().contiguous(), dm_b.float().contiguous()
    _check(y, (g, h1, attn_cat, w_1, w_2, w_p, dm_a, dm_b), "svtr_train_block tail")
    f32 = functools.partial(torch.empty, dtype=torch.float32, device=dev)
    dy, dattn = torch.empty_like(y), torch.empty_like(y)
    d_w2, d_b2, d_w1, d_b1 = f32((hidden, c)), f32((c,)), f32((c, hidden)), f32((hidden,))
    d_wp, vec3 = f32((c, c)), f32((3, c))
    m = b * n
    stats, dh1, dz2, da = f32((m, 2)), f32((m, hidden)), f32((m, c)), f32((m, c))
    work = _workspace(0, m, c, hidden, dev)
    lib = _lib()
    with torch.cuda.device(dev):
        _call(lib.svtr_train_bwd_tail, _dtype_code(dt),
              *(_ptr(t) for t in (g, y, h1, attn_cat, n2s, n2b, w_1, w_2, w_p, dm_a,
                                  dm_b, dy, dattn, d_w2, d_b2, d_w1, d_b1, d_wp, vec3,
                                  stats, dh1, dz2, da, work)),
              b, n, c, hidden, _stream(dev))
    launches["train_bwd_tail"] += 1
    grads = dict(norm2_scale=vec3[0], norm2_bias=vec3[1], fc1_kernel=d_w1,
                 fc1_bias=d_b1, fc2_kernel=d_w2, fc2_bias=d_b2,
                 proj_kernel=d_wp, proj_bias=vec3[2])
    return dy, dattn, grads


def _bwd_head_cuda(x, dy, dqkv, params):
    b, n, c = x.shape
    dt, dev = x.dtype, x.device
    (w_qkv,) = _mats(params, dt, ("qkv_kernel",))
    n1s, n1b = _vecs(params, ("norm1_scale", "norm1_bias"))
    dy, dqkv = dy.to(dt).contiguous(), dqkv.to(dt).contiguous()
    _check(x, (dy, dqkv, w_qkv), "svtr_train_block head")
    f32 = functools.partial(torch.empty, dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    d_wqkv, d_bqkv, vec2 = f32((c, 3 * c)), f32((3 * c,)), f32((2, c))
    m = b * n
    stats, dz1 = f32((m, 2)), f32((m, c))
    work = _workspace(1, m, c, 4 * c, dev)
    lib = _lib()
    with torch.cuda.device(dev):
        _call(lib.svtr_train_bwd_head, _dtype_code(dt),
              *(_ptr(t) for t in (x, dy, dqkv, n1s, n1b, w_qkv, dx, d_wqkv, d_bqkv,
                                  vec2, stats, dz1, work)),
              b, n, c, _stream(dev))
    launches["train_bwd_head"] += 1
    grads = dict(norm1_scale=vec2[0], norm1_bias=vec2[1], qkv_kernel=d_wqkv,
                 qkv_bias=d_bqkv)
    return dx, grads


# ---------------------------------------------------------------- dispatch
def _route(x: torch.Tensor, plain: bool) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"svtr_train_block: unsupported device {x.device}")
    return "plain" if plain or x.device.type == "cpu" else "cuda"


def bwd_tail(g, y, h1, attn_cat, params, dm_a, dm_b, plain: bool = False):
    """Backward tail: the plain version on the CPU (or with ``plain``), the
    CUDA kernel on the card (or raises)."""
    fn = bwd_tail_reference if _route(y, plain) == "plain" else _bwd_tail_cuda
    return fn(g, y, h1, attn_cat, params, dm_a, dm_b)


def bwd_head(x, dy, dqkv, params, plain: bool = False):
    """Backward head: the plain version on the CPU (or with ``plain``), the
    CUDA kernel on the card (or raises)."""
    fn = bwd_head_reference if _route(x, plain) == "plain" else _bwd_head_cuda
    return fn(x, dy, dqkv, params)


def forward(x, params, dm_a, dm_b, num_heads: int, scale: float, band,
            plain: bool = False):
    """Forward with residuals: the plain version on the CPU (or with
    ``plain``), the CUDA kernel on the card (or raises)."""
    fn = forward_reference if _route(x, plain) == "plain" else _forward_cuda
    return fn(x, params, dm_a, dm_b, num_heads, scale, band)


def _bwd_split(x, params, dm_a, dm_b, res, g, num_heads, scale, band, plain):
    """Tail -> attention middle -> head (``_bwd_pallas``)."""
    qkv, attn_cat, y, h1 = res
    dt = x.dtype
    dy, dattn, grads = bwd_tail(g, y, h1, attn_cat, params, dm_a, dm_b, plain)
    dqkv = _attn_bwd(qkv, dattn, num_heads, scale, band, dt).to(dt)
    dx, head_grads = bwd_head(x, dy, dqkv, params, plain)
    return dx, dict(grads, **head_grads)


class _FusedTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dm_a, dm_b, cfg, *params):
        num_heads, scale, band, plain = cfg
        p = dict(zip(PARAM_KEYS, params))
        out, res = forward(x, p, dm_a, dm_b, num_heads, scale, band, plain)
        ctx.save_for_backward(x, dm_a, dm_b, *res, *params)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, g):
        x, dm_a, dm_b, *rest = ctx.saved_tensors
        res, params = tuple(rest[:4]), dict(zip(PARAM_KEYS, rest[4:]))
        num_heads, scale, band, plain = ctx.cfg
        dx, grads = _bwd_split(x, params, dm_a, dm_b, res, g.contiguous(), num_heads,
                               scale, band, plain)
        return (dx, None, None, None,
                *(grads[k].to(params[k].dtype) for k in PARAM_KEYS))


def fused_block_train(x: torch.Tensor, params: Dict[str, torch.Tensor],
                      dm_a: torch.Tensor, dm_b: torch.Tensor, *, num_heads: int,
                      scale: float, band: Optional[Tuple[int, int, int, int]] = None,
                      plain: bool = False) -> torch.Tensor:
    """Fused training-mode SVTR Block with a residual-saving backward.

    x: [B, N, C]; params: the Block's 12 parameters under the JAX names
    (kernels [in, out]); dm_a / dm_b: [B, 1] droppath keep masks divided by
    keep (ones when droppath is off) for the attention / MLP branches;
    ``band = (h, w, hk, wk)`` for a column-major Local Block (banded in both
    directions) or None for a Global Block (full attention, no mask).  A
    Local band without a banded plan raises: None would drop the mask.
    ``plain`` runs the plain versions on any device (the card's reference in
    checks)."""
    if band is not None and (_band_spec(*band) is None
                             or band[0] * band[1] != x.shape[1]):
        raise ValueError(f"fused_block_train: Local band {band} has no banded plan "
                         f"for N={x.shape[1]}; use the composed path")
    if x.shape[-1] % num_heads:
        raise ValueError(f"dim {x.shape[-1]} not divisible by {num_heads} heads")
    cfg = (num_heads, float(scale), None if band is None else tuple(band), bool(plain))
    return _FusedTrain.apply(x, dm_a, dm_b, cfg, *(params[k] for k in PARAM_KEYS))
