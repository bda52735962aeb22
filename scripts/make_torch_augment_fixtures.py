"""Regenerates ``tests/fixtures/torch_augment/``: a few word-crop PNGs at
their natural sizes and ``expected.npz`` with what Pillow, OpenCV and the
JAX package's augmentations give on them:

- ``<crop>:<op>:<k>``: one augmentation op (Pillow's GaussianBlur, rotate,
  ImageEnhance, the hue round trip; OpenCV's warpAffine, warpPerspective,
  resize, pyrDown, filter2D and the motion-blur kernel's warpAffine) on
  the crop, with its parameters under ``<crop>:<op>:<k>:args``;
- ``<crop>:<chain>``: the JAX package's TextAugment
  (``Blur5-Crop90-Rot15``), ABINet chain and MoCoAugment (two views)
  over every crop in file order, from ``random.seed(s); np.random.seed(s)``
  with ``s = SEEDS[chain]``, as uint8 (JAX's ``(x / 255 - 0.5) / 0.5``
  undone, exactly).

    python3 scripts/make_torch_augment_fixtures.py

Needs PIL and cv2 (this is the only place the port's augmentation fixtures
come from them); ``tests/test_torch_augment_fixtures.py`` checks that the
files still give these arrays and that the port gives them too, and
``chip_smoke.py`` holds the C++ augment library against them on the
machine with the card, which has neither.
"""

from __future__ import annotations

import os
import random
import sys

import cv2
import numpy as np
import PIL.Image
import PIL.ImageEnhance
import PIL.ImageFilter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "tests", "fixtures", "torch_augment")
IMG_H, IMG_W = 32, 128
SEEDS = {"text": 5, "abinet": 6, "moco": 7}
CROP_SIZES = [(24, 70), (30, 101), (19, 57), (27, 88)]


def crop(rng, h: int, w: int, alpha: bool) -> np.ndarray:
    """A word-crop-like RGBA image: dark strokes on a light, slightly
    graded ground, noise on everything, a soft alpha edge when ``alpha``."""
    y, x = np.mgrid[0:h, 0:w]
    ink = ((x // 5) % 3 == 0) & (np.abs(y - h / 2) < h / 3)
    img = np.where(ink[:, :, None], 50.0, 200.0 + 30.0 * x[:, :, None] / w)
    img = img + np.arange(3)[None, None, :] * 9.0 + rng.normal(0, 1.5, (h, w, 3))
    out = np.empty((h, w, 4), np.uint8)
    out[:, :, :3] = np.clip(img, 0, 255).astype(np.uint8)
    out[:, :, 3] = 255
    if alpha:
        out[:, :4, 3] = np.linspace(40, 220, 4).astype(np.uint8)[None, :]
    return out


def _u8(x: np.ndarray) -> np.ndarray:
    """JAX's normalised float crop back to uint8, checked exact."""
    u = np.rint((x * 0.5 + 0.5) * 255.0).astype(np.uint8)
    if not np.array_equal(((u.astype(np.float32) / 255.0) - 0.5) / 0.5, x):
        raise AssertionError("the normalisation does not invert exactly")
    return u


def op_cases(rng, img: np.ndarray):
    """(op, args, expected) of every op on ``img`` (RGBA uint8); the
    upscale goes to about 1.5 times the crop, the downscale back from its
    second pyrDown."""
    h, w = img.shape[:2]
    pil = PIL.Image.fromarray(img)
    cases = []
    radius = float(rng.uniform(0.1, 5.0))
    cases.append(("blur", [radius], np.asarray(pil.filter(PIL.ImageFilter.GaussianBlur(radius)))))
    angle = float(rng.uniform(-15, 15))
    cases.append(("rotate", [angle], np.asarray(pil.rotate(angle, PIL.Image.BICUBIC, expand=True))))
    for name, cls in (("brightness", PIL.ImageEnhance.Brightness),
                      ("contrast", PIL.ImageEnhance.Contrast), ("color", PIL.ImageEnhance.Color)):
        f = float(rng.uniform(0.5, 1.5))
        cases.append((name, [f], np.asarray(cls(pil).enhance(f))))
    f = float(rng.uniform(-0.1, 0.1))
    alpha = pil.getchannel("A")
    hh, ss, vv = pil.convert("RGB").convert("HSV").split()
    hh = hh.point(lambda px, f=f: (px + int(f * 255)) % 256)
    hue = PIL.Image.merge("HSV", (hh, ss, vv)).convert("RGB")
    hue.putalpha(alpha)
    cases.append(("hue", [f], np.asarray(hue)))
    for interp in range(4):
        m = cv2.getRotationMatrix2D((w / 2, h / 2), float(rng.uniform(-45, 45)),
                                    float(rng.uniform(0.5, 2.0)))
        dsize = (int(rng.integers(w // 2, 3 * w // 2)), int(rng.integers(h // 2, 3 * h // 2)))
        out = cv2.warpAffine(img, m, dsize, flags=interp, borderMode=cv2.BORDER_REPLICATE)
        cases.append((f"affine{interp}", list(m.ravel()) + list(dsize), out))
    for interp in range(4):
        oh = (rng.beta(1, 4, 4) * h / 4).astype(np.int64)
        ow = (rng.beta(1, 4, 4) * w / 4).astype(np.int64)
        end = np.array([(ow[0], oh[0]), (w - 1 - ow[1], oh[1]), (w - 1 - ow[2], h - 1 - oh[2]),
                        (ow[3], h - 1 - oh[3])], np.float32)
        start = np.array([(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)], np.float32)
        m = cv2.getPerspectiveTransform(start, end)
        out = cv2.warpPerspective(img, m, (w, h), flags=interp, borderMode=cv2.BORDER_REPLICATE)
        cases.append((f"perspective{interp}", list(m.ravel()) + [w, h], out))
        rect = cv2.minAreaRect(end)
        cases.append((f"boxpoints{interp}", list(end.ravel()),
                      cv2.boxPoints(rect).astype(np.int64)))
    for interp in range(4):
        size = (w + w // 2 + 3, h + h // 2 + 1)
        up = cv2.resize(img, size, interpolation=interp)
        cases.append((f"resize_up{interp}", list(size), up))
        down = cv2.pyrDown(cv2.pyrDown(up))
        cases.append((f"resize_down{interp}", list(size) + [w, h],
                      cv2.resize(down, (w, h), interpolation=interp)))
    cases.append(("pyrdown", [], cv2.pyrDown(img)))
    degree = int(rng.integers(2, 7))
    k_angle = float(rng.uniform(-90, 90))
    m = cv2.getRotationMatrix2D((degree // 2, degree // 2), k_angle, 1)
    kernel = np.zeros((degree, degree))
    kernel[degree // 2, :] = 1
    kernel = cv2.warpAffine(kernel, m, (degree, degree))
    cases.append(("kernel", [degree, k_angle], kernel))
    cases.append(("filter2d", [degree, k_angle], cv2.filter2D(img, -1, kernel / degree)))
    return cases


def chains(images):
    """The JAX package's three chains over ``images`` (PIL RGBA)."""
    from mrn_tpu.config import default_options
    from mrn_tpu.data.transform import MoCoAugment, build_transform

    out = {}
    for chain, aug in (("text", "Blur5-Crop90-Rot15"), ("abinet", "ABINet")):
        random.seed(SEEDS[chain])
        np.random.seed(SEEDS[chain])
        transform = build_transform(default_options(Aug=aug, imgH=IMG_H, imgW=IMG_W), "train")
        out[chain] = [_u8(transform(im)) for im in images]
    random.seed(SEEDS["moco"])
    np.random.seed(SEEDS["moco"])
    moco = MoCoAugment(default_options(imgH=IMG_H, imgW=IMG_W))
    out["moco"] = [np.stack([_u8(v) for v in moco(im)]) for im in images]
    return out


def main():
    os.makedirs(OUT, exist_ok=True)
    rng = np.random.default_rng(2026)
    expected = {}
    names = []
    for i, (h, w) in enumerate(CROP_SIZES):
        img = crop(rng, h, w, alpha=i % 2 == 1)
        name = f"crop{i}.png"
        PIL.Image.fromarray(img).save(os.path.join(OUT, name))
        names.append(name)
        decoded = np.asarray(PIL.Image.open(os.path.join(OUT, name)).convert("RGBA"))
        if not np.array_equal(decoded, img):
            raise AssertionError(f"{name} does not read back")
        for k, (op, args, want) in enumerate(op_cases(rng, img)):
            if k % 2 != i % 2 and not op.startswith("boxpoints"):
                continue    # each op on every other crop, to keep the files small
            expected[f"{name}:{op}:{k}"] = want
            expected[f"{name}:{op}:{k}:args"] = np.asarray(args, np.float64)
    images = [PIL.Image.open(os.path.join(OUT, n)).convert("RGBA") for n in names]
    for chain, outs in chains(images).items():
        for name, arr in zip(names, outs):
            expected[f"{name}:{chain}"] = arr
    np.savez_compressed(os.path.join(OUT, "expected.npz"), **expected)
    total = sum(os.path.getsize(os.path.join(OUT, f)) for f in os.listdir(OUT))
    print(f"wrote {len(names)} crops and {len(expected)} arrays to {OUT} ({total >> 10} KB)")


if __name__ == "__main__":
    main()
