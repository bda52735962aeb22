"""Post-training w8a8 quantization of the conv feature extractors (VGG,
ResNet, RCNN) and the SVTR Block projections (the port's copy of
``mrn_tpu/ops/int8.py``).

Scheme (standard w8a8 PTQ, as in the JAX package):

- kernels: symmetric per-output-channel int8, ``scale = max(amax, 1e-12) /
  127`` over the input axes ((kh, kw, cin) for convs, cin for dense);
- activations: symmetric per-tensor int8 with a calibrated absmax;
- the product runs int8 x int8 -> int32, dequantized by ``act_scale *
  w_scale[out]`` into a float epilogue.

Rounding is ``torch.round``, half to even like ``jnp.round``, so the int8
kernels equal the JAX package's bit for bit.

Flow: a model built with ``quant="calib"`` records each conv's input absmax
(``models.common.TorchConv``'s ``act_amax``) and each Block projection's
(and the post-scale q, k and v) in its ``act_amax_*`` buffers;
``quantize_variables`` rewrites the calibrated convs' kernels and Blocks'
four projection kernels to int8 and stores their scales beside the amaxes;
a model built with ``quant="int8"`` consumes both (``serve.quantize_int8``
runs the whole flow).  The trees are the JAX layout (``bridge.to_flax`` /
``quant_tree``): leaves are numpy arrays or tensors; the rewritten ones come
back as tensors.

The conv path is the JAX package's composed one: ``quantize_act`` in its
division form (``round(x / scale)``), ``conv_int8`` (int8 x int8 -> exact
int32, NHWC, symmetric zero padding) and the epilogue ``y * (a_scale *
w_scale) + bias`` cast to the input's dtype (``conv_w8a8``).  On a CUDA
tensor ``conv_int8`` is an int8 im2col of the input (K zero-padded to a
multiple of 8, chunked over the batch) through ``torch._int_mm``, counted
in ``int_mm_convs``; on the CPU it is its plain version
``conv_int8_reference``, an exact float64 conv.  The Block's activation
side is the w8a8 Block's own (``ops.svtr_block``: a multiply by ``1 /
scale``, as the Pallas kernel does).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["MAX_EXACT_K", "SVTR_PROJ_KERNELS", "conv_int8", "conv_int8_reference",
           "conv_w8a8", "int_matmul", "quantize_act", "quantize_kernel", "quantize_variables"]

# SVTR Block projections: params key -> quant scale key.
SVTR_PROJ_KERNELS = (("qkv_kernel", "qkv"), ("proj_kernel", "proj"),
                     ("fc1_kernel", "fc1"), ("fc2_kernel", "fc2"))

# An int8 x int8 product summed over K terms stays exact in float32 while
# K * 127^2 < 2^24: the int8 Block's plain version (``int_matmul``) computes
# its products that way.  Convs reach K = 4608 (VGG's conv5) and compute in
# float64 instead (``conv_int8_reference``).
MAX_EXACT_K = (1 << 24) // (127 * 127)

# the conv path's torch._int_mm calls on the card
int_mm_convs = 0
# the int8 im2col of one chunk of the batch stays below this many bytes
IM2COL_BYTES = 1 << 28


def quantize_kernel(w) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 for an ``[in, out]`` dense kernel
    (or an HWIO conv kernel).  Returns (int8 kernel, float32 scale[out])."""
    w = torch.as_tensor(w).float()
    amax = w.abs().amax(dim=tuple(range(w.ndim - 1)))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_act(x: torch.Tensor, amax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 in the JAX package's division form.
    Returns (int8 x, float32 scale)."""
    scale = torch.clamp(torch.as_tensor(amax).float(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def _out_size(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def _im2col(x: torch.Tensor, kernel: Tuple[int, int], stride: Tuple[int, int],
            padding: Tuple[int, int]) -> torch.Tensor:
    """NHWC ``x`` -> ``[B * Ho * Wo, kh * kw * C]`` patches (zero padding),
    the columns in HWIO's (kh, kw, cin) order."""
    b, h, w, c = x.shape
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, padding
    ho, wo = _out_size(h, kh, sh, ph), _out_size(w, kw, sw, pw)
    if ph or pw:
        x = F.pad(x, (0, 0, pw, pw, ph, ph))
    cols = [x[:, i:i + sh * (ho - 1) + 1:sh, j:j + sw * (wo - 1) + 1:sw, :]
            for i in range(kh) for j in range(kw)]
    return torch.stack(cols, dim=3).reshape(b * ho * wo, kh * kw * c)


def conv_int8_reference(x_q: torch.Tensor, w_q: torch.Tensor,
                        stride: Tuple[int, int] = (1, 1),
                        padding: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """``conv_int8``'s plain version: the conv of int8 NHWC ``x_q`` and HWIO
    ``w_q`` in float64, exact (every partial sum is an integer below
    K * 127^2 < 2^53), as int32 NHWC."""
    y = F.conv2d(x_q.permute(0, 3, 1, 2).double(), w_q.permute(3, 2, 0, 1).double(),
                 stride=tuple(stride), padding=tuple(padding))
    return y.permute(0, 2, 3, 1).to(torch.int32)


def conv_int8(x_q: torch.Tensor, w_q: torch.Tensor, stride: Tuple[int, int] = (1, 1),
              padding: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """int8 NHWC ``x_q`` [B, H, W, cin] x int8 HWIO ``w_q`` [kh, kw, cin,
    out] -> exact int32 NHWC, symmetric zero ``padding`` (rows, columns).
    On the card: ``torch._int_mm`` over an int8 im2col, K zero-padded to a
    multiple of 8 (zeros add nothing to an integer sum), chunked over the
    batch; ``_int_mm``'s shape limits (more than 16 rows, ``out`` a multiple
    of 8) raise.  On the CPU: ``conv_int8_reference``."""
    global int_mm_convs
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"conv_int8 takes int8 operands, got {x_q.dtype} and {w_q.dtype}")
    if not x_q.is_cuda:
        return conv_int8_reference(x_q, w_q, stride, padding)
    kh, kw, cin, cout = w_q.shape
    b, h, w, _ = x_q.shape
    ho, wo = _out_size(h, kh, stride[0], padding[0]), _out_size(w, kw, stride[1], padding[1])
    k = kh * kw * cin
    kp = -(-k // 8) * 8
    if cout % 8:
        raise ValueError(f"conv_int8: torch._int_mm needs out % 8 == 0, got out={cout}")
    wm = w_q.reshape(k, cout)
    if kp != k:
        wm = F.pad(wm, (0, 0, 0, kp - k))
    wm = wm.contiguous()
    per_image = ho * wo
    # images a chunk: the im2col under IM2COL_BYTES, but never 16 rows or
    # fewer while the batch has more; the chunks split the batch evenly
    chunk = max(1, IM2COL_BYTES // max(1, per_image * kp), -(-17 // per_image))
    n_chunks = max(1, b // chunk)
    bounds = [b * i // n_chunks for i in range(n_chunks + 1)]
    out = torch.empty((b * per_image, cout), dtype=torch.int32, device=x_q.device)
    for b0, b1 in zip(bounds, bounds[1:]):
        cols = _im2col(x_q[b0:b1], (kh, kw), stride, padding)
        if kp != k:
            cols = F.pad(cols, (0, kp - k))
        if cols.shape[0] <= 16:
            raise ValueError(f"conv_int8: torch._int_mm needs more than 16 rows, got "
                             f"{cols.shape[0]} ({b1 - b0} x {ho} x {wo})")
        out[b0 * per_image:b1 * per_image] = torch._int_mm(cols, wm)
    int_mm_convs += 1
    return out.view(b, ho, wo, cout)


def conv_w8a8(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
              amax: torch.Tensor, bias: Optional[torch.Tensor],
              stride: Tuple[int, int], padding: Tuple[int, int]) -> torch.Tensor:
    """The w8a8 conv of ``models.common.TorchConv(quant="int8")`` on an NCHW
    float ``x`` with an OIHW int8 weight: ``quantize_act`` with the
    calibrated ``amax``, ``conv_int8``, then ``y * (a_scale * w_scale)``,
    ``+ bias`` and the cast to ``x.dtype`` (the JAX epilogue's order)."""
    x_q, a_scale = quantize_act(x, amax)
    y = conv_int8(x_q.permute(0, 2, 3, 1), w_q.permute(2, 3, 1, 0), stride, padding)
    y = y.float() * (a_scale * w_scale.float())
    if bias is not None:
        y = y + bias
    return y.to(x.dtype).permute(0, 3, 1, 2)


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product of int8-valued tensors ``[..., K] @ [K, out]``
    as float32 (every partial sum is an integer below 2^24), for the int8
    Block's plain version; ``K`` above ``MAX_EXACT_K`` raises."""
    if a.shape[-1] > MAX_EXACT_K:
        raise ValueError(f"int8 product over K={a.shape[-1]} > {MAX_EXACT_K} is not "
                         "exact in float32")
    return a.float() @ b.float()


def _quantize_block(params: Mapping, quant: Mapping):
    """A calibrated SVTR Block scope: the four projection kernels go int8,
    ``w_scale_<name>`` lands next to ``act_amax_<name>``."""
    new_p, new_q = dict(params), dict(quant)
    for pkey, qname in SVTR_PROJ_KERNELS:
        new_p[pkey], new_q[f"w_scale_{qname}"] = quantize_kernel(params[pkey])
    return new_p, new_q


def _walk(params: Mapping, quant: Mapping, out_params: Dict, out_quant: Dict):
    """Rewrite every calibrated conv scope (``{"Conv_0": {"kernel": [kh, kw,
    in, out], ...}}`` in ``params`` beside ``act_amax`` in ``quant``: the
    kernel goes int8, ``w_scale`` lands next to ``act_amax``) and Block
    scope (projection kernels in ``params`` beside ``act_amax_qkv`` in
    ``quant``); recurse into the others."""
    for k, v in params.items():
        q = quant.get(k) if isinstance(quant, Mapping) else None
        inner = v.get("Conv_0") if isinstance(v, Mapping) else None
        if isinstance(q, Mapping) and "act_amax" in q and isinstance(inner, Mapping) \
                and getattr(inner.get("kernel"), "ndim", 0) == 4:
            kq, scale = quantize_kernel(inner["kernel"])
            out_params[k] = dict(v, Conv_0=dict(inner, kernel=kq))
            out_quant[k] = dict(q, w_scale=scale)
        elif isinstance(q, Mapping) and "act_amax_qkv" in q and isinstance(v, Mapping) \
                and "qkv_kernel" in v:
            out_params[k], out_quant[k] = _quantize_block(v, q)
        elif isinstance(v, Mapping):
            out_params[k] = {}
            out_quant[k] = dict(q) if isinstance(q, Mapping) else {}
            _walk(v, q if isinstance(q, Mapping) else {}, out_params[k], out_quant[k])
        else:
            out_params[k] = v


def quantize_variables(variables: Mapping) -> Dict:
    """``{"params", "quant", ...}`` -> the same with every calibrated conv's
    kernel and Block's projection kernels int8 in ``params`` and their
    ``w_scale`` / ``w_scale_*`` in ``quant``; every other entry passes
    through untouched."""
    params = variables["params"]
    quant = variables.get("quant") or {}
    if "act_amax_qkv" in quant and "qkv_kernel" in params:
        new_params, new_quant = _quantize_block(params, quant)   # a bare Block
    else:
        new_params, new_quant = {}, {}
        _walk(params, quant, new_params, new_quant)
    return dict(variables, params=new_params, quant=new_quant)
