"""SVTR backbone (mirrors ``mrn_tpu/models/svtr.py``): embed (64, 128, 256),
depth (3, 6, 3), heads (2, 4, 8), mixers Local x6 then Global x6, Conv patch
merging, drop-path rates ``linspace(0, 0.1, 12)``.

Every module takes ``train``:

- eval: each Block is one fused inference Block
  (``mrn_tpu_torch.ops.svtr_block``), its CUDA kernel for tensors on the
  card, its plain version on the CPU; a Block built with ``quant="int8"``
  is the w8a8 Block (``fused_block_int8``), one built with
  ``quant="calib"`` runs the composed path in eval mode and records each
  projection's input absmax (``svtr.py:347-360,421-426``), and
  ``score_envelope`` runs the same composed path to measure the largest
  attention score (``svtr.py:166-191``);
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
import sys
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mrn_tpu_torch.models.common import (BatchNorm, Conv2d, LayerNorm,
                                         to_nchw, to_nhwc)
from mrn_tpu_torch.ops.svtr_attention import attention_forward, attention_reference, mha_small_n
from mrn_tpu_torch.ops.svtr_block import (SCORE_CLAMP, FoldCache, Int8Weights, _band_spec,
                                          fused_block, fused_block_int8,
                                          fused_block_int8_reference, fused_block_reference,
                                          prepare_int8)
from mrn_tpu_torch.ops.svtr_train_block import PARAM_KEYS, fused_block_train

__all__ = ["Block", "DropPath", "PatchEmbed", "QUANT_MODES", "SVTRExtractor",
           "SubSampleConv", "configure_blocks", "is_quant_scale", "local_attention_mask",
           "local_attention_mask_col_major", "score_envelope", "set_droppath_generator"]

QUANT_MODES = ("none", "calib", "int8")
_PROJ = ("qkv", "proj", "fc1", "fc2")
# calibrated activation absmax per projection input, plus the post-scale q
# and k and v for the int8-attention mode
_AMAX_NAMES = _PROJ + ("q", "k", "v")


def is_quant_scale(name: str) -> bool:
    """Whether a buffer name (dotted or bare) is an ``act_amax_*`` or
    ``w_scale_*`` of the quant collection."""
    return name.rsplit(".", 1)[-1].startswith(("act_amax_", "w_scale_"))


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

    ``quant`` (the w8a8 PTQ of the four projections, ``ops.int8``):

    - ``"none"``: float weights; eval runs the fused inference Block;
    - ``"calib"``: eval runs the composed path and keeps the running
      maximum of each projection input's absmax, and of the post-scale q,
      k and v, in float32 buffers ``act_amax_*`` (not saved in the state
      dict: they are the calibration's output);
    - ``"int8"``: the four projection kernels are int8 buffers, beside
      float32 buffers ``act_amax_*`` and ``w_scale_*``; eval runs the w8a8
      Block.  Moving or casting the Block (``Module.to``) keeps those scales
      float32, as the JAX package's ``quant`` collection is.  The kernel's
      operands (``int8_weights``, ``ops.svtr_block.prepare_int8``) are
      derived once, and again after each ``load_state_dict`` and each move
      or cast.

    With ``quant="none"`` the fused inference Block's folded weights
    (``ops.svtr_block._fold``) are kept in a ``FoldCache`` and folded again
    only when a weight changes (an in-place write, a new tensor, a cast or
    move, ``functional_call`` with other tensors).

    ``plain`` runs the kernels' plain versions on any device (the card's
    reference in checks; the fused training Block's too),
    ``gelu_degree`` picks the inference kernels' erf fit and ``attn_int8``
    also runs the w8a8 Block's QK^T and PV int8 (the JAX package's
    ``set_attention_int8``); all three are set for a whole model with
    ``configure_blocks``.  ``score_max`` is set only while
    ``score_envelope`` records."""

    def __init__(self, dim: int, num_heads: int, mixer: str,
                 hw: Tuple[int, int], mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, local_k: Tuple[int, int] = (7, 11),
                 col_major: bool = False, quant: str = "none"):
        super().__init__()
        if quant not in QUANT_MODES:
            raise ValueError(f"quant must be one of {QUANT_MODES}, not {quant!r}")
        hidden = int(dim * mlp_ratio)
        shapes = dict(norm1_scale=(dim,), norm1_bias=(dim,),
                      qkv_kernel=(dim, 3 * dim), qkv_bias=(3 * dim,),
                      proj_kernel=(dim, dim), proj_bias=(dim,),
                      norm2_scale=(dim,), norm2_bias=(dim,),
                      fc1_kernel=(dim, hidden), fc1_bias=(hidden,),
                      fc2_kernel=(hidden, dim), fc2_bias=(dim,))
        for name in PARAM_KEYS:
            if quant == "int8" and name.endswith("_kernel"):
                self.register_buffer(name, torch.zeros(shapes[name], dtype=torch.int8))
            else:
                self.register_parameter(name, nn.Parameter(torch.zeros(shapes[name])))
        if quant != "none":
            for name in _AMAX_NAMES:
                self.register_buffer(f"act_amax_{name}", torch.zeros(()),
                                     persistent=quant == "int8")
        if quant == "int8":
            for name in _PROJ:
                self.register_buffer(f"w_scale_{name}",
                                     torch.ones(shapes[f"{name}_kernel"][1]))
        self.quant = quant
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
        self.attn_int8 = False
        self.score_max: Optional[torch.Tensor] = None
        self.int8_weights: Optional[Int8Weights] = None
        self.fold_cache = FoldCache()
        self._prepare_int8()

    def _prepare_int8(self) -> None:
        if self.quant == "int8":
            self.int8_weights = prepare_int8(
                {name: getattr(self, name) for name in PARAM_KEYS},
                {k: v for k, v in self._buffers.items() if is_quant_scale(k)})

    def _apply(self, fn, recurse=True):
        """``Module.to`` and friends: the quant scales follow the device but
        stay float32."""
        scales = {k: self._buffers.pop(k) for k in list(self._buffers) if is_quant_scale(k)}
        try:
            super()._apply(fn, recurse)
        finally:
            for key, t in scales.items():
                self._buffers[key] = t.to(fn(t).device)
        self._prepare_int8()
        return self

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self._prepare_int8()

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.mask is not None and self.mask.device != x.device:
            self.mask = self.mask.to(x.device)
        if train:
            if self.quant != "none":
                raise ValueError(f"a quant={self.quant!r} Block serves only (train=False)")
            return self._forward_train(x)
        if self.quant == "calib" or self.score_max is not None:
            return self._composed(x, train=False)
        if self.quant == "int8":
            args = (x, self.int8_weights, self.mask, self.num_heads, self.scale,
                    self.attn_int8, self.gelu_degree)
            if self.plain:
                return fused_block_int8_reference(*args)
            return fused_block_int8(*args, band=self.band)
        params = {name: getattr(self, name) for name in PARAM_KEYS}
        if self.plain:
            return fused_block_reference(x, params, self.mask, self.num_heads, self.scale,
                                         band=self.band, gelu_degree=self.gelu_degree)
        return fused_block(x, params, self.mask, self.num_heads, self.scale, band=self.band,
                           gelu_degree=self.gelu_degree, cache=self.fold_cache)

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
        return self._composed(x, train=True)

    def _record(self, name: str, h: torch.Tensor) -> None:
        """``quant="calib"``: raise ``act_amax_<name>`` to ``max |h|``."""
        if self.quant == "calib":
            key = f"act_amax_{name}"
            setattr(self, key, torch.maximum(getattr(self, key), h.abs().amax().float()))

    def _composed(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        """The composed path (``svtr.py:412-448``).  Training: DropPath on
        both branches and the training attention (banded where a plan
        exists).  Eval (calibration, score envelope): no DropPath, the full
        mask through the attention forward (kernel 1 on the card), and the
        calibration's absmax records."""
        b, n, c = x.shape
        heads = self.num_heads
        h = _manual_layer_norm(x, self.norm1_scale, self.norm1_bias)
        self._record("qkv", h)
        qkv = (h @ self.qkv_kernel + self.qkv_bias).view(b, n, 3, heads, c // heads)
        qkv = qkv.permute(2, 0, 3, 1, 4)
        q, k, v = (qkv[0] * self.scale).contiguous(), qkv[1].contiguous(), qkv[2].contiguous()
        if train:
            attn = mha_small_n(q, k, v, self.mask, band=self.band, plain=self.plain)
        else:
            for name, t in zip("qkv", (q, k, v)):
                self._record(name, t)
            if self.score_max is not None:
                self.score_max = torch.maximum(
                    self.score_max.to(x.device), (q @ k.transpose(-1, -2)).abs().amax().float())
            attn = (attention_reference if self.plain else attention_forward)(q, k, v, self.mask)
        attn = attn.transpose(1, 2).reshape(b, n, c)
        self._record("proj", attn)
        x = x + self.drop_path(attn @ self.proj_kernel + self.proj_bias, train)
        h = _manual_layer_norm(x, self.norm2_scale, self.norm2_bias)
        self._record("fc1", h)
        h = F.gelu(h @ self.fc1_kernel + self.fc1_bias)
        self._record("fc2", h)
        return x + self.drop_path(h @ self.fc2_kernel + self.fc2_bias, train)


def configure_blocks(model: nn.Module, plain: Optional[bool] = None,
                     gelu_degree: Optional[int] = None,
                     attn_int8: Optional[bool] = None) -> None:
    """Set ``plain``, ``gelu_degree`` and/or ``attn_int8`` on every Block of
    ``model``."""
    for m in model.modules():
        if isinstance(m, Block):
            if plain is not None:
                m.plain = plain
            if gelu_degree is not None:
                m.gelu_degree = gelu_degree
            if attn_int8 is not None:
                m.attn_int8 = attn_int8


def score_envelope(model: nn.Module, x: torch.Tensor) -> float:
    """Max |attention score| over one sample batch (``svtr.py:166-191``):
    ``model(x)`` runs once in eval mode with every Block on the composed
    path, each recording the largest |q k^T| (q post-scale, before the
    mask).  The fused inference Block's softmax takes exp without the
    max-subtract, clamped at ``SCORE_CLAMP``; a value at or above it means
    that kernel would flatten attention for these weights, which is
    reported loudly on stderr.  Returns the maximum (0.0 for a model
    without Blocks)."""
    blocks = [m for m in model.modules() if isinstance(m, Block)]
    for blk in blocks:
        blk.score_max = torch.zeros(())
    try:
        with torch.inference_mode():
            model(x)
        maxima = [float(blk.score_max) for blk in blocks]
    finally:
        for blk in blocks:
            blk.score_max = None
    mx = max(maxima, default=0.0)
    if mx >= SCORE_CLAMP:
        print(f"*** SVTR score envelope VIOLATED: max |attention score| {mx:.1f} >= clamp "
              f"{SCORE_CLAMP} -- the fused inference kernel would silently flatten "
              "attention for these weights ***", file=sys.stderr, flush=True)
    return mx


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
    """NHWC image [B, H, W, in_ch] -> [B, 1, W/4, out_channels]; ``quant``
    is every Block's (the convs stay float, as in JAX)."""

    def __init__(self, in_channels: int = 4, out_channels: int = 512,
                 img_size: Tuple[int, int] = (32, 256),
                 embed_dim: Sequence[int] = (64, 128, 256),
                 depth: Sequence[int] = (3, 6, 3),
                 num_heads: Sequence[int] = (2, 4, 8),
                 drop_path_rate: float = 0.1, quant: str = "none"):
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
                  drop_path=dpr[i], col_major=True, quant=quant)
            for i in range(d0))
        self.sub_sample1 = SubSampleConv(embed_dim[0], embed_dim[1], (h0, w0))
        self.blocks2 = nn.ModuleList(
            Block(embed_dim[1], num_heads[1], mixers[d0 + i], (h0 // 2, w0),
                  drop_path=dpr[d0 + i], col_major=True, quant=quant) for i in range(d1))
        self.sub_sample2 = SubSampleConv(embed_dim[1], embed_dim[2], (h0 // 2, w0))
        self.blocks3 = nn.ModuleList(
            Block(embed_dim[2], num_heads[2], mixers[d0 + d1 + i], (h0 // 4, w0),
                  drop_path=dpr[d0 + d1 + i], quant=quant)
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
