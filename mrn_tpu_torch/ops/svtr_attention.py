"""SVTR training attention: hand-written CUDA forwards plus their plain
PyTorch versions (mirrors ``mrn_tpu/ops/svtr_attention.py``).

``mha_small_n(q, k, v, mask=None, band=None)`` takes q, k, v ``[B, H, N, D]``
(q pre-scaled) in the working dtype (float32 or bfloat16):

- ``band=(h, w, hk, wk)`` with a band plan (``svtr_block._band_spec``): the
  column-major Local window, computed banded (``_MHABanded``);
- otherwise full attention with the additive ``[N, N]`` ``mask`` or none
  (``_MHA``).

Each forward computes what the Pallas kernels compute: float32 scores from
operands in the working dtype, max-subtract, ``exp``, divide by the row sum,
P rounded to v's dtype, PV accumulated in float32, output in the working
dtype.  It launches the CUDA kernel (``csrc/svtr_attention.cu``) for CUDA
tensors and runs the plain version (``attention_reference`` /
``banded_attention_reference``) for CPU tensors; there is no fallback
between the two.  Each saves only q, k, v; its backward recomputes through
the plain differentiable math (``xla_attention`` / ``banded_attention_xla``,
ports of the JAX package's XLA formulations) and takes its vjp, exactly as
the JAX package's custom VJPs do.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from mrn_tpu_torch.ops.svtr_block import _band_on_device, _band_spec

__all__ = ["attention_reference", "banded_attention_reference",
           "banded_attention_xla", "launches", "mha_small_n", "xla_attention"]

# CUDA launches per kernel (the plain versions never count).
launches = {"full": 0, "banded": 0}

_KERNEL_HEAD_DIMS = (8, 16, 32, 64)
_QUERY_TILE = 32  # band query blocks: a multiple of QT in csrc/svtr_common.cuh


# ------------------------------------------------------------ plain versions
def xla_attention(q, k, v, mask=None):
    """The JAX package's ``xla_attention`` in the working dtype: q, k, v
    ``[B, H, N, D]`` (q pre-scaled); additive mask ``[N, N]`` or None."""
    attn = q @ k.transpose(-1, -2)
    if mask is not None:
        attn = attn + mask.to(attn.dtype)
    return torch.softmax(attn, dim=-1) @ v


def _col_major_mask(band, device):
    from mrn_tpu_torch.models.svtr import local_attention_mask_col_major

    return torch.from_numpy(local_attention_mask_col_major(*band)).to(device)


def banded_attention_xla(q, k, v, band: Tuple[int, int, int, int]):
    """The JAX package's ``banded_attention_xla``: the column-major Local
    window computed against a ``width``-key window per ``qb``-row query
    block; equal to ``xla_attention`` with the full col-major mask.  As in
    JAX, the float32 band mask promotes the scores (and softmax) to
    float32 and P is cast back to v's dtype for PV."""
    spec = _band_spec(*band)
    if spec is None:
        return xla_attention(q, k, v, _col_major_mask(band, q.device))
    qb, width, starts, _ = spec
    _, band_mask = _band_on_device(tuple(band), q.device)
    b, h, n, d = q.shape
    nq = n // qb
    qs = q.reshape(b, h, nq, qb, d)
    k_win = torch.stack([k[:, :, st:st + width] for st in starts], dim=2)
    v_win = torch.stack([v[:, :, st:st + width] for st in starts], dim=2)
    s = qs @ k_win.transpose(-1, -2) + band_mask.view(nq, qb, width)
    p = torch.softmax(s, dim=-1)
    return (p.to(v.dtype) @ v_win).reshape(b, h, n, d)


def _softmax_pv(s, v):
    """The kernels' softmax and PV on float32 scores ``s``."""
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return (p.to(v.dtype).float() @ v.float()).to(v.dtype)


def attention_reference(q, k, v, mask=None):
    """Plain version of the full kernel (``_make_kernel``'s arithmetic)."""
    s = q.float() @ k.float().transpose(-1, -2)
    if mask is not None:
        s = s + mask
    return _softmax_pv(s, v)


def banded_attention_reference(q, k, v, band):
    """Plain version of the banded kernel (``_make_banded_kernel``'s
    arithmetic): query block ``a`` against keys ``[starts[a], starts[a] +
    width)`` with its rows of the band mask."""
    qb, width, starts, _ = _band_spec(*band)
    _, band_mask = _band_on_device(tuple(band), q.device)
    out = torch.empty_like(q)
    for a, st in enumerate(starts):
        rows = slice(a * qb, (a + 1) * qb)
        s = (q[:, :, rows].float() @ k[:, :, st:st + width].float().transpose(-1, -2)
             + band_mask[rows])
        out[:, :, rows] = _softmax_pv(s, v[:, :, st:st + width])
    return out


# -------------------------------------------------------------- CUDA kernels
@functools.lru_cache(maxsize=None)
def _lib():
    from mrn_tpu_torch.ops import _build

    lib = _build.load("svtr_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    # dtype; q, k, v, mask, starts, out; BH N D qb width; stream
    lib.svtr_attention_forward.argtypes = [i] + [p] * 6 + [i] * 5 + [p]
    lib.svtr_attention_forward.restype = i
    # dtype, N, D, qb, width; int32 out[5]
    lib.svtr_attention_plan.argtypes = [i] * 5 + [p]
    lib.svtr_attention_plan.restype = i
    lib.svtr_attention_error_string.argtypes = [i]
    lib.svtr_attention_error_string.restype = ctypes.c_char_p
    return lib


def _kernel_plan(dtype, n, d, qb, width):
    """The built library's launch plan for ``[*, n, d]`` operands of
    ``dtype`` (full attention: ``qb == width == n``): query rows per block,
    key tiles of 8 held in registers, key segments, passes over the keys (1
    for a window of exactly 128 or 256 keys, else 3), dynamic shared
    bytes."""
    out = (ctypes.c_int * 5)()
    _lib().svtr_attention_plan(1 if dtype == torch.bfloat16 else 0, n, d, qb, width, out)
    return tuple(out)


def _check(q, k, v, mask):
    if not (q.shape == k.shape == v.shape) or q.ndim != 4:
        raise ValueError(f"svtr_attention: q, k, v must share one [B, H, N, D] "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"svtr_attention kernel takes float32/bfloat16, not {q.dtype}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("svtr_attention kernel: q, k, v must share one dtype")
    if q.shape[-1] not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"svtr_attention kernel: head_dim {q.shape[-1]} not in "
                         f"{_KERNEL_HEAD_DIMS}")
    for t in (k, v, mask):
        if t is not None and t.device != q.device:
            raise ValueError("svtr_attention kernel: tensors on different devices")
    for t in (q, k, v, mask):
        if t is not None and not t.is_contiguous():
            raise ValueError("svtr_attention kernel takes contiguous tensors")
    if mask is not None and mask.dtype != torch.float32:
        raise TypeError("svtr_attention kernel: the mask must be float32")


def _aligned(t):
    """``t``, or a copy of it when its data is not 16-byte aligned (a view
    at an odd offset): the kernel stages rows with 16-byte copies."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def _launch(kind, q, k, v, mask, starts, qb, width):
    b, h, n, d = q.shape
    q, k, v, mask = (_aligned(t) for t in (q, k, v, mask))
    out = torch.empty_like(q)
    lib = _lib()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(q.device):
        rc = lib.svtr_attention_forward(
            1 if q.dtype == torch.bfloat16 else 0, ptr(q), ptr(k), ptr(v),
            ptr(mask), ptr(starts), ptr(out), b * h, n, d, qb, width,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"svtr_attention {kind} kernel launch failed: "
                           + lib.svtr_attention_error_string(rc).decode())
    launches[kind] += 1
    return out


def _device_type(q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"svtr_attention: unsupported device {q.device}")
    return q.device.type


def attention_forward(q, k, v, mask=None):
    """Full-attention forward: the plain version on the CPU, the CUDA kernel
    on the card (or raises)."""
    if _device_type(q) == "cpu":
        return attention_reference(q, k, v, mask)
    _check(q, k, v, mask)
    if mask is not None and tuple(mask.shape) != (q.shape[2], q.shape[2]):
        raise ValueError(f"svtr_attention: mask {tuple(mask.shape)} is not [N, N]")
    n = q.shape[2]
    return _launch("full", q, k, v, mask, None, n, n)


def banded_attention_forward(q, k, v, band):
    """Banded forward: the plain version on the CPU, the CUDA kernel on the
    card (or raises)."""
    if _device_type(q) == "cpu":
        return banded_attention_reference(q, k, v, band)
    spec = _band_spec(*band)
    if spec is None or band[0] * band[1] != q.shape[2]:
        raise ValueError(f"svtr_attention: band {band} has no plan for N={q.shape[2]}")
    qb, width, _, _ = spec
    if qb % _QUERY_TILE:
        raise ValueError(f"svtr_attention kernel: band rows {qb} not a multiple "
                         f"of {_QUERY_TILE}")
    starts, band_mask = _band_on_device(tuple(band), q.device)
    _check(q, k, v, band_mask)
    return _launch("banded", q, k, v, band_mask, starts, qb, width)


# ---------------------------------------------------------------- autograd
class _MHA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, plain):
        ctx.save_for_backward(q, k, v)
        ctx.mask = mask
        return (attention_reference if plain else attention_forward)(q, k, v, mask)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = xla_attention(*qkv, ctx.mask)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None


class _MHABanded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, band, plain):
        ctx.save_for_backward(q, k, v)
        ctx.band = band
        fn = banded_attention_reference if plain else banded_attention_forward
        return fn(q, k, v, band)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = banded_attention_xla(*qkv, ctx.band)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None


def mha_small_n(q, k, v, mask=None, band: Optional[tuple] = None,
                plain: bool = False):
    """q, k, v ``[B, H, N, D]``, q pre-scaled; additive ``mask [N, N]``
    (tensor or numpy) or None.  ``band = (h, w, hk, wk)``: the mask is a
    column-major Local window and, when a band plan exists, both directions
    run banded (``mask`` is then ignored).  ``plain`` runs the forward's
    plain version on any device (the card's reference in checks)."""
    if band is not None and _band_spec(*band) is not None:
        return _MHABanded.apply(q, k, v, tuple(band), plain)
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=torch.float32, device=q.device)
    return _MHA.apply(q, k, v, mask, plain)
