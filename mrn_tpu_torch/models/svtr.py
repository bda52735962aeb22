"""SVTR backbone (mirrors ``mrn_tpu/models/svtr.py``): embed (64, 128, 256),
depth (3, 6, 3), heads (2, 4, 8), mixers Local x6 then Global x6, Conv patch
merging, drop-path rates ``linspace(0, 0.1, 12)``.

Every module takes ``train``:

- eval: each Block is one fused inference Block
  (``mrn_tpu_torch.ops.svtr_block``), its CUDA kernel for tensors on the
  card, its plain version on the CPU;
- train: each Block runs the JAX package's composed path (``svtr.py:412-448``)
  with the attention core ``ops.svtr_attention.mha_small_n`` (CUDA forwards,
  plain backward), ``DropPath`` on both residual branches and BatchNorm on
  batch statistics in ``PatchEmbed``.  With ``MRN_FUSED_TRAIN=1`` a Global
  Block, or a Local Block with a band plan, runs the fused training Block
  instead (``ops.svtr_train_block.fused_block_train``, ``svtr.py:373-410``),
  its droppath masks drawn as the composed path draws them.

Stages 1-2 run on column-major tokens, so the Local 7x11 window is a
diagonal band all kernels compute banded.  The composed path's GELU
(PatchEmbed and the Block MLP) is the exact erf, the reference's own; the
fused training Block's is the degree-15 erf polynomial, as in JAX.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mrn_tpu_torch.models.common import (BatchNorm, Conv2d, LayerNorm,
                                         to_nchw, to_nhwc)
from mrn_tpu_torch.ops.svtr_attention import mha_small_n
from mrn_tpu_torch.ops.svtr_block import _band_spec, fused_block, fused_block_reference
from mrn_tpu_torch.ops.svtr_train_block import PARAM_KEYS, fused_block_train

__all__ = ["Block", "DropPath", "PatchEmbed", "SVTRExtractor",
           "SubSampleConv", "configure_blocks", "local_attention_mask",
           "local_attention_mask_col_major", "set_droppath_generator"]


def _manual_layer_norm(x, scale, bias, eps=1e-6):
    """The composed Block's LayerNorm (``svtr.py:270-276``): float32
    statistics, ``E[x^2] - mean^2`` without a clamp, affine, cast back."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def local_attention_mask(h: int, w: int, hk: int = 7, wk: int = 11) -> np.ndarray:
    """Static additive mask [HW, HW]: 0 within the hk x wk window around each
    query position, -inf outside."""
    hw = h * w
    mask = np.ones((hw, h + hk - 1, w + wk - 1), dtype=np.float32)
    for i in range(h):
        for j in range(w):
            mask[i * w + j, i:i + hk, j:j + wk] = 0.0
    cropped = mask[:, hk // 2:h + hk // 2, wk // 2:w + wk // 2].reshape(hw, hw)
    return np.where(cropped < 1.0, 0.0, -np.inf).astype(np.float32)


def local_attention_mask_col_major(h: int, w: int, hk: int = 7,
                                   wk: int = 11) -> np.ndarray:
    """`local_attention_mask` with tokens in column-major order
    (token = col*h + row): on short-h, long-w grids the window becomes a
    narrow band around the diagonal."""
    m = local_attention_mask(h, w, hk, wk)
    perm = np.arange(h * w).reshape(h, w).T.reshape(-1)
    return np.ascontiguousarray(m[np.ix_(perm, perm)])


def _to_col_major(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, h*w, C] row-major tokens -> column-major (token = col*h + row)."""
    b, n, c = x.shape
    return x.reshape(b, h, w, c).transpose(1, 2).reshape(b, n, c)


def _to_row_major(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Inverse of `_to_col_major` for an (h, w) grid."""
    b, n, c = x.shape
    return x.reshape(b, w, h, c).transpose(1, 2).reshape(b, n, c)


class DropPath(nn.Module):
    """Stochastic depth: in train mode each image's branch is kept with
    probability ``1 - rate`` and scaled by ``1 / keep``.  The keep mask is
    drawn from ``generator`` (a ``torch.Generator`` on the tensor's device;
    None takes PyTorch's default one)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None

    def _draw(self, batch: int, device) -> torch.Tensor:
        """One keep decision per image, [B, 1] float32 of 0 and 1."""
        return torch.bernoulli(torch.full((batch, 1), 1.0 - self.rate, device=device),
                               generator=self.generator)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if self.rate == 0.0 or not train:
            return x
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = self._draw(x.shape[0], x.device).view(shape)
        return x * mask.to(x.dtype) / (1.0 - self.rate)

    def keep_scale(self, batch: int, device) -> torch.Tensor:
        """The fused training Block's form of the same draw: the [B, 1]
        float32 keep mask divided by keep; ones, drawing nothing, at rate 0."""
        if self.rate == 0.0:
            return torch.ones((batch, 1), device=device)
        return self._draw(batch, device) / (1.0 - self.rate)


def set_droppath_generator(model: nn.Module,
                           generator: Optional[torch.Generator]) -> None:
    """Draw every DropPath mask of ``model`` from ``generator``."""
    for m in model.modules():
        if isinstance(m, DropPath):
            m.generator = generator


class Block(nn.Module):
    """Pre-norm transformer Block (LN -> [masked] multi-head attention ->
    LN -> MLP).  Parameters carry the JAX names and layouts (kernels
    ``[in, out]``).

    ``plain`` runs the kernels' plain versions on any device (the card's
    reference in checks; the fused training Block's too) and
    ``gelu_degree`` picks the inference kernel's erf fit; both are set for
    a whole model with ``configure_blocks``."""

    def __init__(self, dim: int, num_heads: int, mixer: str,
                 hw: Tuple[int, int], mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, local_k: Tuple[int, int] = (7, 11),
                 col_major: bool = False):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        shapes = dict(norm1_scale=(dim,), norm1_bias=(dim,),
                      qkv_kernel=(dim, 3 * dim), qkv_bias=(3 * dim,),
                      proj_kernel=(dim, dim), proj_bias=(dim,),
                      norm2_scale=(dim,), norm2_bias=(dim,),
                      fc1_kernel=(dim, hidden), fc1_bias=(hidden,),
                      fc2_kernel=(hidden, dim), fc2_bias=(dim,))
        for name in PARAM_KEYS:
            self.register_parameter(name, nn.Parameter(torch.zeros(shapes[name])))
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.mask: Optional[torch.Tensor] = None  # plain attribute: stays f32
        self.band = None
        if mixer == "Local":
            build = (local_attention_mask_col_major if col_major
                     else local_attention_mask)
            self.mask = torch.from_numpy(build(hw[0], hw[1], *local_k))
            if col_major:
                self.band = (hw[0], hw[1], local_k[0], local_k[1])
        elif mixer != "Global":
            raise ValueError(mixer)
        self.drop_path = DropPath(drop_path)
        self.plain = False
        self.gelu_degree = 9

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.mask is not None and self.mask.device != x.device:
            self.mask = self.mask.to(x.device)
        if train:
            return self._forward_train(x)
        params = {name: getattr(self, name) for name in PARAM_KEYS}
        fn = fused_block_reference if self.plain else fused_block
        return fn(x, params, self.mask, self.num_heads, self.scale,
                  band=self.band, gelu_degree=self.gelu_degree)

    def fused_train_ok(self, n: int) -> bool:
        """Whether ``MRN_FUSED_TRAIN=1`` sends this Block to the fused
        training Block (``svtr.py:393-395``): Global, or Local with a band
        plan over ``n`` tokens."""
        band = self.band
        return self.mask is None or (band is not None and _band_spec(*band) is not None
                                     and band[0] * band[1] == n)

    def _forward_train(self, x: torch.Tensor) -> torch.Tensor:
        """The composed training path (``svtr.py:412-448``), or with
        ``MRN_FUSED_TRAIN=1`` the fused training Block where it applies
        (``svtr.py:373-410``)."""
        if os.environ.get("MRN_FUSED_TRAIN", "0") == "1" and self.fused_train_ok(x.shape[1]):
            b = x.shape[0]
            dm_a = self.drop_path.keep_scale(b, x.device)
            dm_b = self.drop_path.keep_scale(b, x.device)
            params = {name: getattr(self, name) for name in PARAM_KEYS}
            return fused_block_train(x, params, dm_a, dm_b, num_heads=self.num_heads,
                                     scale=self.scale, band=self.band, plain=self.plain)
        b, n, c = x.shape
        heads = self.num_heads
        h = _manual_layer_norm(x, self.norm1_scale, self.norm1_bias)
        qkv = (h @ self.qkv_kernel + self.qkv_bias).view(b, n, 3, heads, c // heads)
        qkv = qkv.permute(2, 0, 3, 1, 4)
        q = (qkv[0] * self.scale).contiguous()
        attn = mha_small_n(q, qkv[1].contiguous(), qkv[2].contiguous(), self.mask,
                           band=self.band, plain=self.plain)
        attn = attn.transpose(1, 2).reshape(b, n, c) @ self.proj_kernel + self.proj_bias
        x = x + self.drop_path(attn, True)
        h = _manual_layer_norm(x, self.norm2_scale, self.norm2_bias)
        h = F.gelu(h @ self.fc1_kernel + self.fc1_bias) @ self.fc2_kernel + self.fc2_bias
        return x + self.drop_path(h, True)


def configure_blocks(model: nn.Module, plain: Optional[bool] = None,
                     gelu_degree: Optional[int] = None) -> None:
    """Set ``plain`` and/or ``gelu_degree`` on every Block of ``model``."""
    for m in model.modules():
        if isinstance(m, Block):
            if plain is not None:
                m.plain = plain
            if gelu_degree is not None:
                m.gelu_degree = gelu_degree


class PatchEmbed(nn.Module):
    """Two stride-2 3x3 convs, each with BatchNorm and exact-erf GELU; NHWC image -> [B, H/4 * W/4, C]
    tokens."""

    def __init__(self, in_ch: int, embed_dim: int):
        super().__init__()
        self.conv1 = Conv2d(in_ch, embed_dim // 2, (3, 3), (2, 2), (1, 1))
        self.bn1 = BatchNorm(embed_dim // 2)
        self.conv2 = Conv2d(embed_dim // 2, embed_dim, (3, 3), (2, 2), (1, 1))
        self.bn2 = BatchNorm(embed_dim)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = to_nchw(x)
        x = F.gelu(self.bn1(self.conv1(x), train))
        x = F.gelu(self.bn2(self.conv2(x), train))
        b, c, h, w = x.shape
        return to_nhwc(x).reshape(b, h * w, c)


class SubSampleConv(nn.Module):
    """Conv patch merging, stride (2, 1), then LayerNorm (eps 1e-6); the
    same in train and eval mode."""

    def __init__(self, in_dim: int, out_dim: int, hw: Tuple[int, int]):
        super().__init__()
        self.hw = hw
        self.conv = Conv2d(in_dim, out_dim, (3, 3), (2, 1), (1, 1))
        self.norm = LayerNorm(out_dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        x = self.conv(to_nchw(x.reshape(b, self.hw[0], self.hw[1], c)))
        _, oc, h, w = x.shape
        return self.norm(to_nhwc(x).reshape(b, h * w, oc))


class SVTRExtractor(nn.Module):
    """NHWC image [B, H, W, in_ch] -> [B, 1, W/4, out_channels]."""

    def __init__(self, in_channels: int = 4, out_channels: int = 512,
                 img_size: Tuple[int, int] = (32, 256),
                 embed_dim: Sequence[int] = (64, 128, 256),
                 depth: Sequence[int] = (3, 6, 3),
                 num_heads: Sequence[int] = (2, 4, 8),
                 drop_path_rate: float = 0.1):
        super().__init__()
        h0, w0 = img_size[0] // 4, img_size[1] // 4
        self.h0, self.w0 = h0, w0
        mixers = ["Local"] * 6 + ["Global"] * 6
        d0, d1, d2 = depth
        dpr = np.linspace(0, drop_path_rate, sum(depth))
        self.patch_embed = PatchEmbed(in_channels, embed_dim[0])
        self.pos_embed = nn.Parameter(torch.zeros(1, h0 * w0, embed_dim[0]))
        self.blocks1 = nn.ModuleList(
            Block(embed_dim[0], num_heads[0], mixers[i], (h0, w0),
                  drop_path=dpr[i], col_major=True)
            for i in range(d0))
        self.sub_sample1 = SubSampleConv(embed_dim[0], embed_dim[1], (h0, w0))
        self.blocks2 = nn.ModuleList(
            Block(embed_dim[1], num_heads[1], mixers[d0 + i], (h0 // 2, w0),
                  drop_path=dpr[d0 + i], col_major=True) for i in range(d1))
        self.sub_sample2 = SubSampleConv(embed_dim[1], embed_dim[2], (h0 // 2, w0))
        self.blocks3 = nn.ModuleList(
            Block(embed_dim[2], num_heads[2], mixers[d0 + d1 + i], (h0 // 4, w0),
                  drop_path=dpr[d0 + d1 + i])
            for i in range(d2))
        self.sub_sample3 = SubSampleConv(embed_dim[2], out_channels, (h0 // 4, w0))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h0, w0 = self.h0, self.w0
        x = self.patch_embed(x, train) + self.pos_embed
        x = _to_col_major(x, h0, w0)
        for blk in self.blocks1:
            x = blk(x, train)
        x = self.sub_sample1(_to_row_major(x, h0, w0))
        x = _to_col_major(x, h0 // 2, w0)
        for blk in self.blocks2:
            x = blk(x, train)
        x = self.sub_sample2(_to_row_major(x, h0 // 2, w0))
        for blk in self.blocks3:
            x = blk(x, train)
        x = self.sub_sample3(x)
        b, n, c = x.shape
        return x.reshape(b, 1, n, c)
