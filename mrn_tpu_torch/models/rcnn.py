"""RCNN (GRCNN) feature extractor, gated recurrent convolutions (mirrors
``mrn_tpu/models/rcnn.py``).

A ``GRCL`` runs its input convs ``wgf_u`` (1x1) and ``wf_u`` (3x3) once,
then ``num_iteration`` steps that share the recurrent convs ``wgr_x`` (1x1)
and ``wr_x`` (3x3) while each step ``i`` owns five BatchNorms
(``u{i}_bn_gfu``, ``u{i}_bn_grx``, ``u{i}_bn_rx``, ``u{i}_bn_fu``,
``u{i}_bn_gx``)::

    h = relu(bn_x_init(wf_u))
    gate = sigmoid(bn_gfu(wgf_u) + bn_grx(wgr_x(h)))
    h = relu(bn_fu(wf_u) + bn_gx(bn_rx(wr_x(h)) * gate))

Every conv is bias-free but ``conv0``.  ``RCNNExtractor``: ``conv0`` and a
2x2 pool, three GRCLs (the last two pools (2, 1)-strided over one ``-inf``
column each side), then ``conv1`` (2x2) and ``bn1``.  NHWC at the
boundary, NCHW inside: [B, 32, W, C] -> [B, 1, W/4 + 1, output_channel]
(T = 65 at W = 256, as ResNet's).  ``train`` drives the 26 BatchNorms of
each GRCL and ``bn1``; ``quant`` is every conv's w8a8 mode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mrn_tpu_torch.models.common import BatchNorm, TorchConv, max_pool, to_nchw, to_nhwc

__all__ = ["GRCL", "RCNNExtractor"]

_UNIT_BNS = ("gfu", "grx", "rx", "fu", "gx")


class GRCL(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, num_iteration: int = 5,
                 kernel_size: int = 3, quant: str = "none"):
        super().__init__()
        k, p = kernel_size, kernel_size // 2
        self.wgf_u = TorchConv(in_ch, out_ch, (1, 1), quant=quant)
        self.wf_u = TorchConv(in_ch, out_ch, (k, k), padding=(p, p), quant=quant)
        self.wgr_x = TorchConv(out_ch, out_ch, (1, 1), quant=quant)
        self.wr_x = TorchConv(out_ch, out_ch, (k, k), padding=(p, p), quant=quant)
        self.bn_x_init = BatchNorm(out_ch)
        for i in range(num_iteration):
            for name in _UNIT_BNS:
                setattr(self, f"u{i}_bn_{name}", BatchNorm(out_ch))
        self.num_iteration = num_iteration

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        wgf_u, wf_u = self.wgf_u(x), self.wf_u(x)
        h = F.relu(self.bn_x_init(wf_u, train))
        for i in range(self.num_iteration):
            bn = {name: getattr(self, f"u{i}_bn_{name}") for name in _UNIT_BNS}
            gate = torch.sigmoid(bn["gfu"](wgf_u, train) + bn["grx"](self.wgr_x(h), train))
            rx = bn["rx"](self.wr_x(h), train)
            h = F.relu(bn["fu"](wf_u, train) + bn["gx"](rx * gate, train))
        return h


class RCNNExtractor(nn.Module):
    def __init__(self, input_channel: int = 4, output_channel: int = 512, quant: str = "none"):
        super().__init__()
        oc = (output_channel // 8, output_channel // 4, output_channel // 2, output_channel)
        self.conv0 = TorchConv(input_channel, oc[0], (3, 3), padding=(1, 1), bias=True,
                               quant=quant)
        self.grcl0 = GRCL(oc[0], oc[0], quant=quant)
        self.grcl1 = GRCL(oc[0], oc[1], quant=quant)
        self.grcl2 = GRCL(oc[1], oc[2], quant=quant)
        self.conv1 = TorchConv(oc[2], oc[3], (2, 2), quant=quant)
        self.bn1 = BatchNorm(oc[3])

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = to_nchw(x)
        x = max_pool(F.relu(self.conv0(x)), (2, 2), (2, 2))                 # 16 x W/2
        x = max_pool(self.grcl0(x, train), (2, 2), (2, 2))                  # 8 x W/4
        x = max_pool(self.grcl1(x, train), (2, 2), (2, 1), (0, 1))          # 4 x W/4 + 1
        x = max_pool(self.grcl2(x, train), (2, 2), (2, 1), (0, 1))          # 2 x W/4 + 2
        return to_nhwc(F.relu(self.bn1(self.conv1(x), train)))              # 1 x W/4 + 1
