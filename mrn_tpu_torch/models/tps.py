"""RARE-style TPS spatial transformer (mirrors ``mrn_tpu/models/tps.py``),
eval mode only: the warp kernel has no backward, as in JAX.

- ``LocalizationNetwork``: four bias-free 3x3 convs (64, 128, 256, 512) with
  BatchNorm and ReLU, max-pooled after the first three, a global average
  pool, ``localization_fc1`` (512 -> 256, ReLU) and ``localization_fc2``
  (256 -> 2F), whose initial kernel is zero and bias the RARE fiducial
  layout (``_fc2_bias``).
- ``TPSTransformer``: the host constants ``inv_delta_C [F+3, F+3]`` and
  ``P_hat [H*W, F+3]`` (numpy, float64, as the JAX package builds them,
  then float32), the grid from two float32 products, and the warp
  ``ops.grid_sample``.

The grid stays float32 under a bfloat16 model, as in JAX (``tps.py:114-117``
takes both products with ``preferred_element_type=float32``): the constants
are plain attributes, which ``Module.to`` does not cast, the predicted
fiducials are promoted to float32 before the products, and the products run
without TF32.  A bfloat16 grid would move the taps by up to half a pixel at
W = 256.  The module is NHWC at its boundary and NCHW inside.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mrn_tpu_torch.models.common import (BatchNorm, Dense, TorchConv, global_avg_pool,
                                         max_pool, to_nchw)
from mrn_tpu_torch.ops.grid_sample import grid_sample

__all__ = ["LocalizationNetwork", "TPSTransformer", "build_C", "build_P_hat",
           "build_inv_delta_C"]


def build_C(num_fiducial: int) -> np.ndarray:
    """Fiducial points of the rectified image, [F, 2]."""
    f2 = num_fiducial // 2
    x = np.linspace(-1.0, 1.0, f2)
    top = np.stack([x, -np.ones(f2)], axis=1)
    bottom = np.stack([x, np.ones(f2)], axis=1)
    return np.concatenate([top, bottom], axis=0)


def build_inv_delta_C(num_fiducial: int, C: np.ndarray) -> np.ndarray:
    """The (F+3, F+3) inverse of the TPS system."""
    f = num_fiducial
    hat_C = np.zeros((f, f))
    for i in range(f):
        for j in range(i, f):
            r = np.linalg.norm(C[i] - C[j])
            hat_C[i, j] = hat_C[j, i] = r
    np.fill_diagonal(hat_C, 1.0)
    hat_C = (hat_C ** 2) * np.log(hat_C)
    delta_C = np.concatenate([
        np.concatenate([np.ones((f, 1)), C, hat_C], axis=1),
        np.concatenate([np.zeros((2, 3)), C.T], axis=1),
        np.concatenate([np.zeros((1, 3)), np.ones((1, f))], axis=1),
    ], axis=0)
    return np.linalg.inv(delta_C)


def build_P_hat(num_fiducial: int, C: np.ndarray, size: Tuple[int, int],
                eps: float = 1e-6) -> np.ndarray:
    """The (H*W, F+3) RBF expansion of the output grid."""
    h, w = size
    gx = (np.arange(-w, w, 2) + 1.0) / w
    gy = (np.arange(-h, h, 2) + 1.0) / h
    P = np.stack(np.meshgrid(gx, gy), axis=2).reshape(-1, 2)
    n = P.shape[0]
    diff = P[:, None, :] - C[None, :, :]
    norm = np.linalg.norm(diff, axis=2)
    rbf = (norm ** 2) * np.log(norm + eps)
    return np.concatenate([np.ones((n, 1)), P, rbf], axis=1)


def _fc2_bias(num_fiducial: int) -> np.ndarray:
    """RARE Fig. 6(a) initial fiducial layout, flattened."""
    f2 = num_fiducial // 2
    x = np.linspace(-1.0, 1.0, f2)
    top = np.stack([x, np.linspace(0.0, -1.0, f2)], axis=1)
    bottom = np.stack([x, np.linspace(1.0, 0.0, f2)], axis=1)
    return np.concatenate([top, bottom], axis=0).reshape(-1).astype(np.float32)


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class LocalizationNetwork(nn.Module):
    """NCHW image -> predicted fiducials [B, F, 2]."""

    def __init__(self, num_fiducial: int, input_channel: int):
        super().__init__()
        self.num_fiducial = num_fiducial
        chans = (input_channel, 64, 128, 256, 512)
        for i in range(4):
            setattr(self, f"conv{i}", TorchConv(chans[i], chans[i + 1], (3, 3), padding=(1, 1)))
            setattr(self, f"bn{i}", BatchNorm(chans[i + 1]))
        self.localization_fc1 = Dense(512, 256)
        self.localization_fc2 = Dense(256, 2 * num_fiducial)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(4):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
            if i < 3:
                x = max_pool(x, (2, 2), (2, 2))
        x = F.relu(self.localization_fc1(global_avg_pool(x)))
        return self.localization_fc2(x).reshape(-1, self.num_fiducial, 2)


class TPSTransformer(nn.Module):
    """NHWC image -> the rectified NHWC image of size ``out_size``."""

    def __init__(self, num_fiducial: int, out_size: Tuple[int, int], input_channel: int = 4):
        super().__init__()
        self.num_fiducial, self.out_size = num_fiducial, tuple(out_size)
        self.localization = LocalizationNetwork(num_fiducial, input_channel)
        C = build_C(num_fiducial)
        # plain attributes, not buffers: no checkpoint leaf, never cast
        self.inv_delta_C = torch.tensor(build_inv_delta_C(num_fiducial, C), dtype=torch.float32)
        self.P_hat = torch.tensor(build_P_hat(num_fiducial, C, self.out_size),
                                  dtype=torch.float32)

    def grid(self, image: torch.Tensor) -> torch.Tensor:
        """The float32 sampling grid [B, H, W, 2] for an NHWC image."""
        if self.P_hat.device != image.device:
            self.inv_delta_C = self.inv_delta_C.to(image.device)
            self.P_hat = self.P_hat.to(image.device)
        c_prime = self.localization(to_nchw(image)).float()
        b = c_prime.shape[0]
        c_prime_pad = torch.cat([c_prime, c_prime.new_zeros(b, 3, 2)], dim=1)
        with _no_tf32():
            T = torch.matmul(self.inv_delta_C, c_prime_pad)   # [B, F+3, 2]
            grid = torch.matmul(self.P_hat, T)                # [B, H*W, 2]
        return grid.reshape(b, *self.out_size, 2)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        return grid_sample(image.contiguous(), self.grid(image))
