"""Shared building blocks, in the JAX package's layouts and numerics.

- ``Dense`` holds its kernel as ``[in, out]`` (the JAX layout, so the bridge
  copies it untransposed) and computes ``x @ kernel + bias``.
- ``Conv2d`` holds its weight as ``[out, in, kh, kw]`` (the bridge transposes
  flax's HWIO) and runs ``F.conv2d`` on NCHW tensors; ``to_nchw``/``to_nhwc``
  convert at the boundaries, since public functions take NHWC images.
- ``BatchNorm`` (eval, eps 1e-5) and ``LayerNorm`` follow flax's arithmetic:
  statistics in float32, LayerNorm's variance as ``E[x^2] - E[x]^2`` clipped
  at 0, ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, result cast back
  to the input dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["BatchNorm", "Conv2d", "Dense", "LayerNorm", "to_nchw", "to_nhwc"]


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class Dense(nn.Module):
    """Linear layer with a ``[in, out]`` kernel."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


class Conv2d(nn.Module):
    """Convolution on NCHW tensors with symmetric padding."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Tuple[int, int],
                 stride: Tuple[int, int], padding: Tuple[int, int]):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, *kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.stride, self.padding = tuple(stride), tuple(padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding)


class BatchNorm(nn.Module):
    """Inference BatchNorm over axis 1 of an NCHW tensor (running stats)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(self.var.float() + self.eps) * self.scale.float()
        y = ((x.float() - self.mean.float().view(shape)) * mul.view(shape)
             + self.bias.float().view(shape))
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
