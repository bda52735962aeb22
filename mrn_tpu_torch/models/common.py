"""Shared building blocks, in the JAX package's layouts and numerics.

- ``Dense`` holds its kernel as ``[in, out]`` (the JAX layout, so the bridge
  copies it untransposed) and computes ``x @ kernel + bias`` (no bias with
  ``bias=False``).
- ``Conv2d`` holds its weight as ``[out, in, kh, kw]`` (the bridge transposes
  flax's HWIO) and runs ``F.conv2d`` on NCHW tensors; ``to_nchw``/``to_nhwc``
  convert at the boundaries, since public functions take NHWC images.
  ``TorchConv`` is the JAX package's ``TorchConv``: its ``Conv2d`` (with
  a bias where ``bias=True``) sits in a child named ``Conv_0``, the flax
  scope of the ``nn.Conv`` it creates, so its weight bridges by name.  Its
  ``quant`` mode is the w8a8 PTQ of ``ops.int8``: ``"calib"`` keeps a
  running max of ``|x|`` at the conv input in ``act_amax``; ``"int8"``
  holds an int8 weight and the ``act_amax`` / ``w_scale`` buffers (the JAX
  ``quant`` leaves, ``is_quant_scale``) and runs ``ops.int8.conv_w8a8``.
- ``max_pool`` pads with ``-inf`` (flax's ``max_pool`` with explicit
  padding, torch's ``MaxPool2d``); ``global_avg_pool`` is
  ``AdaptiveAvgPool2d(1)``, both on NCHW tensors.
- ``BatchNorm`` (eps 1e-5) and ``LayerNorm`` follow flax's arithmetic:
  statistics in float32, the variance as ``E[x^2] - E[x]^2`` clipped at 0
  (biased), ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, result cast
  back to the input dtype.  In train mode BatchNorm normalises with the batch
  statistics and moves its running stats as flax does (momentum 0.9, with
  the biased variance, so not ``F.batch_norm``); the update is in place.
  Under a data mesh (``parallel.mesh``) the train-mode moments ``E[x]`` and
  ``E[x^2]`` are the global batch's (``mesh.data_mean``, whose gradient is
  global too), as in JAX's partitioned program, so the running statistics
  move alike on every rank.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mrn_tpu_torch.ops.int8 import conv_w8a8
from mrn_tpu_torch.parallel import mesh

__all__ = ["BatchNorm", "Conv2d", "Dense", "LayerNorm", "QUANT_MODES", "TorchConv",
           "global_avg_pool", "is_quant_scale", "max_pool", "to_nchw", "to_nhwc"]

QUANT_MODES = ("none", "calib", "int8")


def is_quant_scale(name: str) -> bool:
    """Whether a buffer name (dotted or bare) belongs to the JAX ``quant``
    collection: a conv's ``act_amax`` / ``w_scale``, a Block's
    ``act_amax_*`` / ``w_scale_*``."""
    last = name.rsplit(".", 1)[-1]
    return last in ("act_amax", "w_scale") or last.startswith(("act_amax_", "w_scale_"))


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class Dense(nn.Module):
    """Linear layer with a ``[in, out]`` kernel."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel
        return y if self.bias is None else y + self.bias


class Conv2d(nn.Module):
    """Convolution on NCHW tensors with symmetric padding."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Tuple[int, int],
                 stride: Tuple[int, int], padding: Tuple[int, int], bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, *kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.stride, self.padding = tuple(stride), tuple(padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding)


class TorchConv(nn.Module):
    """A ``Conv2d`` in the child ``Conv_0`` on NCHW tensors, bias-free unless
    ``bias`` (every TPS, ResNet and GRCL conv of the JAX package is a
    ``TorchConv(use_bias=False)``; VGG's carry biases), in w8a8 mode
    ``quant``.  The quant scales stay float32 under ``Module.to``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Tuple[int, int],
                 stride: Tuple[int, int] = (1, 1), padding: Tuple[int, int] = (0, 0),
                 bias: bool = False, quant: str = "none"):
        super().__init__()
        if quant not in QUANT_MODES:
            raise ValueError(f"quant must be one of {QUANT_MODES}, not {quant!r}")
        self.Conv_0 = Conv2d(in_ch, out_ch, kernel, stride, padding, bias=bias)
        self.quant = quant
        if quant == "int8":
            del self.Conv_0.weight
            self.Conv_0.register_buffer("weight", torch.zeros((out_ch, in_ch, *kernel),
                                                              dtype=torch.int8))
            self.register_buffer("w_scale", torch.ones(out_ch))
        if quant != "none":
            self.register_buffer("act_amax", torch.zeros(()), persistent=quant == "int8")

    def _apply(self, fn, recurse=True):
        scales = {k: self._buffers.pop(k) for k in list(self._buffers) if is_quant_scale(k)}
        try:
            super()._apply(fn, recurse)
        finally:
            for key, t in scales.items():
                self._buffers[key] = t.to(fn(t).device)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.Conv_0
        if self.quant == "int8":
            return conv_w8a8(x, conv.weight, self.w_scale, self.act_amax, conv.bias,
                             conv.stride, conv.padding)
        if self.quant == "calib":
            self.act_amax = torch.maximum(self.act_amax, x.detach().abs().amax().float())
        return conv(x)


def max_pool(x: torch.Tensor, window: Tuple[int, int], strides: Tuple[int, int],
             padding: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """MaxPool2d on NCHW with ``padding`` (rows, columns) on both sides,
    padded with ``-inf`` so a pad never wins the max."""
    if any(padding):
        ph, pw = padding
        x = F.pad(x, (pw, pw, ph, ph), value=float("-inf"))
    return F.max_pool2d(x, window, strides)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d(1) of an NCHW tensor -> [B, C]."""
    return x.mean(dim=(2, 3))


class BatchNorm(nn.Module):
    """BatchNorm over axis 1 of an NCHW tensor: running stats in eval mode,
    batch stats (and a running-stat update) in train mode."""

    momentum = 0.9

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        xf = x.float()
        if train:
            mean, sq = xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))
            if mesh.get_mesh() is not None:   # the global batch's moments
                mean, sq = mesh.data_mean(torch.stack([mean, sq])).unbind(0)
            var = torch.clamp(sq - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean.float(), self.var.float()
        mul = torch.rsqrt(var + self.eps) * self.scale.float()
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.float().view(shape)
        return y.to(x.dtype)


class LayerNorm(nn.Module):
    """Affine LayerNorm over the last axis with flax's fast variance."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale.float()
        return ((xf - mean) * mul + self.bias.float()).to(x.dtype)
