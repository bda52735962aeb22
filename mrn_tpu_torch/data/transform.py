"""The per-crop transforms (the port's copies of ``ResizeNormalize``,
``TextAugment``, ``MoCoAugment`` and ``build_transform`` from
``mrn_tpu/data/transform.py``).

``ResizeNormalize((W, H))`` resizes a uint8 crop (gray, RGB or RGBA) to
RGBA ``[H, W, 4]`` uint8 as Pillow's ``resize(BICUBIC)`` does
(``data.image.resize``; a crop already at that size is returned as it is).
It does not normalise: the learner and the server normalise uint8 batches
on the device, ``(x / 255 - 0.5) / 0.5`` in float32, the same IEEE
arithmetic as the JAX package's host ``_to_array``, so the values equal
JAX's bit for bit and the host moves a quarter of the bytes.  float32
crops (already normalised) and integer bank indices pass as they are.

The training augmentations (``opt.Aug`` other than ``"None"``) work on the
crop at its natural size and end in the same resize, so they return uint8
RGBA ``[H, W, 4]`` too:

- ``TextAugment``: ``opt.Aug`` such as ``"Blur5-Crop90-Rot15"``, its steps
  in the string's order: a Gaussian blur of radius in ``[0.1, 5]`` half
  the time, an aspect-keeping random crop of 90-100%, a bicubic rotation
  in ``[-15, 15]`` degrees with the canvas expanded (each step's number
  read with ``str.strip``'s character-set quirk, as JAX reads it);
- ``"ABINet"``: ``data.abinet_aug.abinet_transform``;
- ``MoCoAugment``: two views (random resized crop, grayscale, colour
  jitter in a random order, horizontal flip), each uint8 RGBA.

JAX draws them from the global ``random`` and ``np.random``; the port's
take a ``random.Random`` and an ``np.random.RandomState`` (``DatasetManager``
owns one pair, seeded from ``opt.manual_seed``), so seeded alike they draw
JAX's values.  The pixel work is ``data.augment``'s, without Pillow or
OpenCV.
"""

from __future__ import annotations

import random
from typing import Optional, Tuple

import numpy as np

from mrn_tpu_torch.data import augment as ops
from mrn_tpu_torch.data import image as image_codec

__all__ = ["MoCoAugment", "ResizeNormalize", "TextAugment", "build_transform"]


class ResizeNormalize:
    def __init__(self, size: Tuple[int, int]):
        self.size = size  # (W, H)

    def __call__(self, image):
        if isinstance(image, (int, np.integer)):
            return image        # a bank index: the gather happens on the device
        if isinstance(image, np.ndarray) and image.dtype == np.float32:
            return image        # already normalised
        return image_codec.resize(image, self.size)


class TextAugment:
    """``Aug="Blur5-Crop90-Rot15"``-style chains; see the module doc."""

    def __init__(self, opt, rng: random.Random):
        self.rng = rng
        self.steps = []
        for aug in opt.Aug.split("-"):
            if aug.startswith("Blur"):
                maximum = float(aug.strip("Blur"))
                self.steps.append(lambda im, m=maximum: self._blur(im, m))
            elif aug.startswith("Crop"):
                scale = float(aug.strip("Crop")) / 100
                self.steps.append(lambda im, s=scale: self._crop(im, s))
            elif aug.startswith("Rot"):
                degree = int(aug.strip("Rot"))
                self.steps.append(lambda im, d=degree: ops.rotate(im, self.rng.uniform(-d, d)))
        self.resize = ResizeNormalize((opt.imgW, opt.imgH))

    def _blur(self, image, maximum):
        if self.rng.random() < 0.5:
            return ops.gaussian_blur(image, self.rng.uniform(0.1, maximum))
        return image

    def _crop(self, image, scale):
        height, width = image.shape[:2]
        ratio = self.rng.uniform(scale, 1.0)
        cw, ch = int(width * ratio), int(height * ratio)
        x0 = self.rng.randint(0, width - cw)
        y0 = self.rng.randint(0, height - ch)
        return ops.crop(image, (x0, y0, x0 + cw, y0 + ch))

    def __call__(self, image):
        if isinstance(image, (int, np.integer)):
            return image
        image = image_codec.to_rgba(image)
        for step in self.steps:
            image = step(image)
        return self.resize(image)


class MoCoAugment:
    """Two random views of one crop as ``[query, key]``, each uint8 RGBA
    ``[H, W, 4]`` (the reference's ``MoCo_augment``; no shipped config
    uses it)."""

    def __init__(self, opt, rng: random.Random):
        self.rng = rng
        self.size = (opt.imgW, opt.imgH)

    def _hue(self, image):
        hue = self.rng.uniform(-0.4, 0.4)
        if abs(hue) > 1e-3:
            return ops.shift_hue(image, hue)
        return image

    def _one_view(self, image):
        rng = self.rng
        height, width = image.shape[:2]
        area = width * height
        for _ in range(10):   # RandomResizedCrop(scale=(0.2, 1.0), ratio=(3/4, 4/3))
            target = area * rng.uniform(0.2, 1.0)
            ratio = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
            cw = int(round(np.sqrt(target * ratio)))
            ch = int(round(np.sqrt(target / ratio)))
            if 0 < cw <= width and 0 < ch <= height:
                x0 = rng.randint(0, width - cw)
                y0 = rng.randint(0, height - ch)
                image = ops.crop(image, (x0, y0, x0 + cw, y0 + ch))
                break
        else:   # torchvision's fallback: the ratio-clamped centre crop
            in_ratio = width / height
            if in_ratio < 3 / 4:
                cw, ch = width, min(height, int(round(width / (3 / 4))))
            elif in_ratio > 4 / 3:
                cw, ch = min(width, int(round(height * (4 / 3)))), height
            else:
                cw, ch = width, height
            x0, y0 = (width - cw) // 2, (height - ch) // 2
            image = ops.crop(image, (x0, y0, x0 + cw, y0 + ch))
        image = image_codec.resize(image, self.size)
        if rng.random() < 0.2:
            image = ops.grayscale(image)
        jitter = [lambda im: ops.brightness(im, rng.uniform(0.6, 1.4)),
                  lambda im: ops.contrast(im, rng.uniform(0.6, 1.4)),
                  lambda im: ops.color(im, rng.uniform(0.6, 1.4)),
                  self._hue]
        for op in rng.sample(jitter, len(jitter)):
            image = op(image)
        if rng.random() < 0.5:
            image = ops.flip_lr(image)
        return image

    def __call__(self, image):
        image = image_codec.to_rgba(image)
        return [self._one_view(image), self._one_view(image)]


def build_transform(opt, mode: str = "train", rng: Optional[random.Random] = None,
                    np_rng: Optional[np.random.RandomState] = None):
    """The transform of ``mode`` (the reference's ``AlignCollate``): the
    resize alone unless ``mode`` is ``"train"`` and ``opt.Aug`` names an
    augmentation, which then draws from ``rng`` and ``np_rng`` (both
    required)."""
    if opt.Aug == "None" or mode != "train":
        return ResizeNormalize((opt.imgW, opt.imgH))
    if rng is None or np_rng is None:
        raise ValueError(f"Aug={opt.Aug!r} draws from a random.Random and an "
                         "np.random.RandomState: pass rng= and np_rng=")
    if opt.Aug == "ABINet":
        from mrn_tpu_torch.data.abinet_aug import abinet_transform
        return abinet_transform(opt, rng, np_rng)
    return TextAugment(opt, rng)
