"""FAN-style ResNet feature extractor of TRBA (mirrors
``mrn_tpu/models/resnet.py``): BasicBlocks in layers (1, 2, 5, 3), late
strides asymmetric, every conv bias-free and followed by BatchNorm.

NHWC at the boundary, NCHW inside: [B, 32, W, C] -> [B, 1, W/4 + 1,
output_channel].  At 32x256 the spatial sizes run 32x256 -> 16x128 -> 8x64
-> 4x65 (the third pool's (2, 1) stride over one -inf column each side)
-> 2x66 (``conv4_1``, 2x2, stride (2, 1), padding (0, 1)) -> 1x65
(``conv4_2``): T = 65, ``composer.sequence_length``, the router's patch
count.  ``train`` puts every BatchNorm on batch statistics and moves its
running statistics (``common.BatchNorm``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mrn_tpu_torch.models.common import BatchNorm, TorchConv, max_pool, to_nchw, to_nhwc

__all__ = ["BasicBlock", "ResNetExtractor"]


def _conv3(cin: int, cout: int, quant: str) -> TorchConv:
    return TorchConv(cin, cout, (3, 3), padding=(1, 1), quant=quant)


class BasicBlock(nn.Module):
    """Two 3x3 convs; a 1x1 conv and BatchNorm on the shortcut when the
    width changes."""

    def __init__(self, inplanes: int, planes: int, quant: str = "none"):
        super().__init__()
        self.conv1, self.bn1 = _conv3(inplanes, planes, quant), BatchNorm(planes)
        self.conv2, self.bn2 = _conv3(planes, planes, quant), BatchNorm(planes)
        if inplanes != planes:
            self.down_conv = TorchConv(inplanes, planes, (1, 1), quant=quant)
            self.down_bn = BatchNorm(planes)
        else:
            self.down_conv = None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x), train))
        out = self.bn2(self.conv2(out), train)
        residual = x if self.down_conv is None else self.down_bn(self.down_conv(x), train)
        return F.relu(out + residual)


class _Layer(nn.Module):
    def __init__(self, inplanes: int, planes: int, blocks: int, quant: str = "none"):
        super().__init__()
        for i in range(blocks):
            setattr(self, f"block{i}", BasicBlock(inplanes if i == 0 else planes, planes,
                                                  quant))
        self.blocks = blocks

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(self.blocks):
            x = getattr(self, f"block{i}")(x, train)
        return x


class ResNetExtractor(nn.Module):
    def __init__(self, input_channel: int = 4, output_channel: int = 512,
                 layers: Sequence[int] = (1, 2, 5, 3), quant: str = "none"):
        super().__init__()
        oc = (output_channel // 4, output_channel // 2, output_channel, output_channel)
        inplanes = output_channel // 8
        self.conv0_1 = _conv3(input_channel, output_channel // 16, quant)
        self.bn0_1 = BatchNorm(output_channel // 16)
        self.conv0_2 = _conv3(output_channel // 16, inplanes, quant)
        self.bn0_2 = BatchNorm(inplanes)
        ins = (inplanes,) + oc[:3]
        for i in range(4):
            setattr(self, f"layer{i + 1}", _Layer(ins[i], oc[i], layers[i], quant))
            if i < 3:
                setattr(self, f"conv{i + 1}", _conv3(oc[i], oc[i], quant))
                setattr(self, f"bn{i + 1}", BatchNorm(oc[i]))
        self.conv4_1 = TorchConv(oc[3], oc[3], (2, 2), stride=(2, 1), padding=(0, 1),
                                 quant=quant)
        self.bn4_1 = BatchNorm(oc[3])
        self.conv4_2 = TorchConv(oc[3], oc[3], (2, 2), quant=quant)
        self.bn4_2 = BatchNorm(oc[3])

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = to_nchw(x)
        x = F.relu(self.bn0_1(self.conv0_1(x), train))
        x = F.relu(self.bn0_2(self.conv0_2(x), train))
        pools = (((2, 2), (0, 0)), ((2, 2), (0, 0)), ((2, 1), (0, 1)))
        for i, (stride, pad) in enumerate(pools, start=1):
            x = max_pool(x, (2, 2), stride, pad)
            x = getattr(self, f"layer{i}")(x, train)
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x), train))
        x = self.layer4(x, train)
        x = F.relu(self.bn4_1(self.conv4_1(x), train))
        x = F.relu(self.bn4_2(self.conv4_2(x), train))
        return to_nhwc(x)
