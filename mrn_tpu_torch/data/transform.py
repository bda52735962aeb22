"""The per-crop transform (the port's copy of ``ResizeNormalize`` and
``build_transform`` from ``mrn_tpu/data/transform.py``).

``ResizeNormalize((W, H))`` resizes a uint8 crop (gray, RGB or RGBA) to
RGBA ``[H, W, 4]`` uint8 as Pillow's ``resize(BICUBIC)`` does
(``data.image.resize``; a crop already at that size is returned as it is).
It does not normalise: the learner and the server normalise uint8 batches
on the device, ``(x / 255 - 0.5) / 0.5`` in float32, the same IEEE
arithmetic as the JAX package's host ``_to_array``, so the values equal
JAX's bit for bit and the host moves a quarter of the bytes.  float32
crops (already normalised) and integer bank indices pass as they are.

Augmentation (``opt.Aug`` other than ``"None"``: TextAugment's
Blur/Crop/Rot chains, ABINet's and MoCo's) is not ported and raises
(ROADMAP.md §1 item 6); no shipped config sets it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from mrn_tpu_torch.data import image as image_codec

__all__ = ["ResizeNormalize", "build_transform"]


class ResizeNormalize:
    def __init__(self, size: Tuple[int, int]):
        self.size = size  # (W, H)

    def __call__(self, image):
        if isinstance(image, (int, np.integer)):
            return image        # a bank index: the gather happens on the device
        if isinstance(image, np.ndarray) and image.dtype == np.float32:
            return image        # already normalised
        return image_codec.resize(image, self.size)


def build_transform(opt, mode: str = "train") -> ResizeNormalize:
    """The transform of ``mode`` (the reference's ``AlignCollate``)."""
    if opt.Aug == "None" or mode != "train":
        return ResizeNormalize((opt.imgW, opt.imgH))
    raise NotImplementedError(f"Aug={opt.Aug!r}: TextAugment, ABINet and MoCo augmentation "
                              "are not ported (ROADMAP.md §1 item 6)")
