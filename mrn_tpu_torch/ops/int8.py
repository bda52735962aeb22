"""Post-training w8a8 quantization of the SVTR Block projections (the port's
copy of ``mrn_tpu/ops/int8.py``, SVTR part).

Scheme (standard w8a8 PTQ, as in the JAX package):

- kernels: symmetric per-output-channel int8, ``scale = max(amax, 1e-12) /
  127`` over the input axes;
- activations: symmetric per-tensor int8 with a calibrated absmax;
- the product runs int8 x int8 -> int32, dequantized by ``act_scale *
  w_scale[out]`` into a float epilogue.

Rounding is ``torch.round``, half to even like ``jnp.round``, so the int8
kernels equal the JAX package's bit for bit.

Flow: a model built with ``quant="calib"`` records each Block projection's
input absmax (and the post-scale q, k and v) in its ``act_amax_*`` buffers;
``quantize_variables`` rewrites the calibrated Blocks' four projection
kernels to int8 and stores their scales beside the amaxes; a model built
with ``quant="int8"`` consumes both (``serve.quantize_int8`` runs the whole
flow).  The trees are the JAX layout (``bridge.to_flax`` / ``quant_tree``):
leaves are numpy arrays or tensors; the rewritten ones come back as
tensors.  The activation side is the w8a8 Block's own
(``ops.svtr_block``: a multiply by ``1 / scale``, as the Pallas kernel
does), so the JAX package's composed ``quantize_act`` / ``dense_w8a8`` have
no counterpart here.  The conv path (``conv_int8``, ``TorchConv(quant=...)``)
serves VGG/ResNet, which the port does not build yet.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

__all__ = ["MAX_EXACT_K", "SVTR_PROJ_KERNELS", "int_matmul", "quantize_kernel",
           "quantize_variables"]

# SVTR Block projections: params key -> quant scale key.
SVTR_PROJ_KERNELS = (("qkv_kernel", "qkv"), ("proj_kernel", "proj"),
                     ("fc1_kernel", "fc1"), ("fc2_kernel", "fc2"))

# An int8 x int8 product summed over K terms stays exact in float32 while
# K * 127^2 < 2^24: the plain versions compute integer products that way.
MAX_EXACT_K = (1 << 24) // (127 * 127)


def quantize_kernel(w) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 for an ``[in, out]`` dense kernel
    (or an HWIO conv kernel).  Returns (int8 kernel, float32 scale[out])."""
    w = torch.as_tensor(w).float()
    amax = w.abs().amax(dim=tuple(range(w.ndim - 1)))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product of int8-valued tensors ``[..., K] @ [K, out]``
    as float32 (every partial sum is an integer below 2^24)."""
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
    """Rewrite every calibrated Block scope (projection kernels in ``params``
    beside ``act_amax_qkv`` in ``quant``); recurse into the others."""
    for k, v in params.items():
        q = quant.get(k) if isinstance(quant, Mapping) else None
        if isinstance(q, Mapping) and "act_amax_qkv" in q and isinstance(v, Mapping) \
                and "qkv_kernel" in v:
            out_params[k], out_quant[k] = _quantize_block(v, q)
        elif isinstance(v, Mapping):
            out_params[k] = {}
            out_quant[k] = dict(q) if isinstance(q, Mapping) else {}
            _walk(v, q if isinstance(q, Mapping) else {}, out_params[k], out_quant[k])
        else:
            out_params[k] = v


def quantize_variables(variables: Mapping) -> Dict:
    """``{"params", "quant", ...}`` -> the same with every calibrated Block's
    projection kernels int8 in ``params`` and their ``w_scale_*`` in
    ``quant``; every other entry passes through untouched."""
    params = variables["params"]
    quant = variables.get("quant") or {}
    if "act_amax_qkv" in quant and "qkv_kernel" in params:
        new_params, new_quant = _quantize_block(params, quant)   # a bare Block
    else:
        new_params, new_quant = {}, {}
        _walk(params, quant, new_params, new_quant)
    return dict(variables, params=new_params, quant=new_quant)
