"""VGG feature extractor of CRNN (mirrors ``mrn_tpu/models/vgg.py``): seven
convs, ``conv0``-``conv3`` and ``conv6`` with biases, ``conv4``/``conv5``
bias-free and followed by BatchNorm, and (2, 1) pools that keep the width.

NHWC at the boundary, NCHW inside: [B, 32, W, C] -> [B, 1, W/4 - 1,
output_channel].  At 32x256 the spatial sizes run 32x256 -> 16x128 -> 8x64
-> 4x64 -> 2x64 -> 1x63 (``conv6``, 2x2 without padding): T = 63,
``composer.sequence_length``.  ``train`` puts ``bn4``/``bn5`` on batch
statistics and moves their running statistics (``common.BatchNorm``);
``quant`` is every conv's w8a8 mode (``common.TorchConv``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mrn_tpu_torch.models.common import BatchNorm, TorchConv, max_pool, to_nchw, to_nhwc

__all__ = ["VGGExtractor"]


class VGGExtractor(nn.Module):
    def __init__(self, input_channel: int = 4, output_channel: int = 512, quant: str = "none"):
        super().__init__()
        oc = (output_channel // 8, output_channel // 4, output_channel // 2, output_channel)

        def conv(name, cin, cout, kernel=(3, 3), padding=(1, 1), bias=True):
            setattr(self, name, TorchConv(cin, cout, kernel, padding=padding, bias=bias,
                                          quant=quant))

        conv("conv0", input_channel, oc[0])
        conv("conv1", oc[0], oc[1])
        conv("conv2", oc[1], oc[2])
        conv("conv3", oc[2], oc[2])
        conv("conv4", oc[2], oc[3], bias=False)
        self.bn4 = BatchNorm(oc[3])
        conv("conv5", oc[3], oc[3], bias=False)
        self.bn5 = BatchNorm(oc[3])
        conv("conv6", oc[3], oc[3], kernel=(2, 2), padding=(0, 0))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = to_nchw(x)
        x = max_pool(F.relu(self.conv0(x)), (2, 2), (2, 2))          # 16 x W/2
        x = max_pool(F.relu(self.conv1(x)), (2, 2), (2, 2))          # 8 x W/4
        x = F.relu(self.conv3(F.relu(self.conv2(x))))
        x = max_pool(x, (2, 1), (2, 1))                              # 4 x W/4
        x = F.relu(self.bn4(self.conv4(x), train))
        x = F.relu(self.bn5(self.conv5(x), train))
        x = max_pool(x, (2, 1), (2, 1))                              # 2 x W/4
        return to_nhwc(F.relu(self.conv6(x)))                        # 1 x W/4 - 1
