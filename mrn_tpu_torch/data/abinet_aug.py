"""ABINet's augmentation suite (the port's copy of ``mrn_tpu/data/abinet_aug.py``,
the chain ``Aug="ABINet"`` runs): CVGeometry, CVDeterioration and
CVColorJitter on uint8 RGBA crops, then the bicubic resize.

The JAX package draws from the global ``random`` and ``np.random`` (which
its ``train.py`` seeds); here every transform takes its generators:
``rng`` a ``random.Random`` and ``np_rng`` a ``np.random.RandomState`` (the
legacy stream, which ``np.random.beta``, ``uniform`` and ``normal`` draw
from), and draws from them in the reference's order, the choices that
``CVGeometry`` and ``CVDeterioration`` freeze at construction included.
The pixel work is ``data.augment``'s (no OpenCV, no Pillow).
"""

from __future__ import annotations

import math
import random

import numpy as np

from mrn_tpu_torch.data import augment as ops
from mrn_tpu_torch.data import image as image_codec

__all__ = ["CVColorJitter", "CVDeterioration", "CVGaussianNoise", "CVGeometry", "CVMotionBlur",
           "CVRandomAffine", "CVRandomPerspective", "CVRandomRotation", "CVRescale",
           "abinet_transform"]


def sample_asym(np_rng: np.random.RandomState, magnitude, size=None):
    return np_rng.beta(1, 4, size) * magnitude


def sample_sym(np_rng: np.random.RandomState, magnitude, size=None):
    return (np_rng.beta(4, 4, size=size) - 0.5) * 2 * magnitude


def sample_uniform(np_rng: np.random.RandomState, low, high, size=None):
    return np_rng.uniform(low, high, size=size)


def get_interpolation(rng: random.Random) -> int:
    return rng.choice([ops.NEAREST, ops.LINEAR, ops.CUBIC, ops.AREA])


class CVRandomRotation:
    def __init__(self, rng, np_rng, degrees=15):
        self.rng, self.np_rng = rng, np_rng
        self.degrees = degrees

    def __call__(self, img):
        angle = sample_sym(self.np_rng, self.degrees)
        src_h, src_w = img.shape[:2]
        m = ops.get_rotation_matrix_2d((src_w / 2, src_h / 2), angle, 1.0)
        abs_cos, abs_sin = abs(m[0, 0]), abs(m[0, 1])
        dst_w = int(src_h * abs_sin + src_w * abs_cos)
        dst_h = int(src_h * abs_cos + src_w * abs_sin)
        m[0, 2] += (dst_w - src_w) / 2
        m[1, 2] += (dst_h - src_h) / 2
        return ops.warp_affine(img, m, (dst_w, dst_h), get_interpolation(self.rng))


class CVRandomAffine:
    def __init__(self, rng, np_rng, degrees, translate=None, scale=None, shear=None):
        self.rng, self.np_rng = rng, np_rng
        self.degrees = degrees
        self.translate = translate
        self.scale = scale
        self.shear = [shear] if isinstance(shear, (int, float)) else shear

    @staticmethod
    def _inverse_affine_matrix(center, angle, translate, scale, shear):
        if isinstance(shear, (int, float)):
            shear = [shear, 0]
        rot = math.radians(angle)
        sx, sy = [math.radians(s) for s in shear]
        cx, cy = center
        tx, ty = translate
        a = math.cos(rot - sy) / math.cos(sy)
        b = -math.cos(rot - sy) * math.tan(sx) / math.cos(sy) - math.sin(rot)
        c = math.sin(rot - sy) / math.cos(sy)
        d = -math.sin(rot - sy) * math.tan(sx) / math.cos(sy) + math.cos(rot)
        m = [d, -b, 0.0, -c, a, 0.0]
        m = [x / scale for x in m]
        m[2] += m[0] * (-cx - tx) + m[1] * (-cy - ty)
        m[5] += m[3] * (-cx - tx) + m[4] * (-cy - ty)
        m[2] += cx
        m[5] += cy
        return m

    def __call__(self, img):
        src_h, src_w = img.shape[:2]
        angle = sample_sym(self.np_rng, self.degrees)
        if self.translate is not None:
            translations = (np.round(sample_sym(self.np_rng, self.translate[0] * src_h)),
                            np.round(sample_sym(self.np_rng, self.translate[1] * src_h)))
        else:
            translations = (0, 0)
        scale = sample_uniform(self.np_rng, *self.scale) if self.scale is not None else 1.0
        if self.shear is not None:
            shear = [sample_sym(self.np_rng, self.shear[0]),
                     sample_sym(self.np_rng, self.shear[1]) if len(self.shear) == 2 else 0.0]
        else:
            shear = 0.0
        m = np.array(self._inverse_affine_matrix((src_w / 2, src_h / 2), angle, (0, 0), scale,
                                                 shear)).reshape(2, 3)
        startpoints = [(0, 0), (src_w - 1, 0), (src_w - 1, src_h - 1), (0, src_h - 1)]
        endpoints = [(int(m[0, 0] * x + m[0, 1] * y + m[0, 2]),
                      int(m[1, 0] * x + m[1, 1] * y + m[1, 2])) for x, y in startpoints]
        bbox = ops.box_points(ops.min_area_rect(endpoints)).astype(np.int64)
        dst_w = int(bbox[:, 0].max() - bbox[:, 0].min())
        dst_h = int(bbox[:, 1].max() - bbox[:, 1].min())
        m[0, 2] += (dst_w - src_w) / 2
        m[1, 2] += (dst_h - src_h) / 2
        dst_w += int(abs(translations[0]))
        dst_h += int(abs(translations[1]))
        if translations[0] < 0:
            m[0, 2] += abs(translations[0])
        if translations[1] < 0:
            m[1, 2] += abs(translations[1])
        return ops.warp_affine(img, m, (max(dst_w, 1), max(dst_h, 1)),
                               get_interpolation(self.rng))


class CVRandomPerspective:
    def __init__(self, rng, np_rng, distortion=0.5):
        self.rng, self.np_rng = rng, np_rng
        self.distortion = distortion

    def __call__(self, img):
        height, width = img.shape[:2]
        oh = sample_asym(self.np_rng, self.distortion * height / 2, size=4).astype(np.int64)
        ow = sample_asym(self.np_rng, self.distortion * width / 2, size=4).astype(np.int64)
        endpoints = np.array([(ow[0], oh[0]), (width - 1 - ow[1], oh[1]),
                              (width - 1 - ow[2], height - 1 - oh[2]),
                              (ow[3], height - 1 - oh[3])], dtype=np.float32)
        startpoints = np.array([(0, 0), (width - 1, 0), (width - 1, height - 1),
                                (0, height - 1)], dtype=np.float32)
        m = ops.get_perspective_transform(startpoints, endpoints)
        bbox = ops.box_points(ops.min_area_rect(endpoints)).astype(np.int64)
        max_x, max_y = int(bbox[:, 0].max()), int(bbox[:, 1].max())
        min_x, min_y = max(int(bbox[:, 0].min()), 0), max(int(bbox[:, 1].min()), 0)
        img = ops.warp_perspective(img, m, (max(max_x, 1), max(max_y, 1)),
                                   get_interpolation(self.rng))
        return np.ascontiguousarray(img[min_y:, min_x:])


class CVRescale:
    def __init__(self, rng, np_rng, factor=4, base_size=(128, 512)):
        self.rng, self.np_rng = rng, np_rng
        self.factor = round(sample_uniform(np_rng, 0, factor)) \
            if isinstance(factor, (int, float)) else round(sample_uniform(np_rng, *factor))
        self.base_h, self.base_w = base_size[:2]

    def __call__(self, img):
        if self.factor == 0:
            return img
        src_h, src_w = img.shape[:2]
        scale_img = ops.resize(img, (self.base_w, self.base_h), get_interpolation(self.rng))
        for _ in range(self.factor):
            scale_img = ops.pyr_down(scale_img)
        return ops.resize(scale_img, (src_w, src_h), get_interpolation(self.rng))


class CVGaussianNoise:
    """Gaussian noise on every channel, alpha too (as the reference's)."""

    def __init__(self, rng, np_rng, mean=0, var=20):
        self.rng, self.np_rng = rng, np_rng
        self.mean = mean
        self.var = max(int(sample_asym(np_rng, var)), 1) \
            if isinstance(var, (int, float)) else int(sample_uniform(np_rng, *var))

    def __call__(self, img):
        noise = self.np_rng.normal(self.mean, self.var ** 0.5, img.shape)
        return np.clip(img + noise, 0, 255).astype(np.uint8)


class CVMotionBlur:
    def __init__(self, rng, np_rng, degrees=12, angle=90):
        self.rng, self.np_rng = rng, np_rng
        self.degree = max(int(sample_asym(np_rng, degrees)), 1) \
            if isinstance(degrees, (int, float)) else int(sample_uniform(np_rng, *degrees))
        self.angle = sample_uniform(np_rng, -angle, angle)

    def __call__(self, img):
        m = ops.get_rotation_matrix_2d((self.degree // 2, self.degree // 2), self.angle, 1)
        kernel = np.zeros((self.degree, self.degree))
        kernel[self.degree // 2, :] = 1
        kernel = ops.warp_kernel(kernel, m, (self.degree, self.degree))
        kernel = kernel / self.degree
        return ops.filter2d(img, kernel)


class CVGeometry:
    def __init__(self, rng, np_rng, degrees=15, translate=(0.3, 0.3), scale=(0.5, 2.0),
                 shear=(45, 15), distortion=0.5, p=0.5):
        self.rng, self.np_rng = rng, np_rng
        self.p = p
        type_p = rng.random()  # frozen at construction (the reference's quirk)
        if type_p < 0.33:
            self.transforms = CVRandomRotation(rng, np_rng, degrees=degrees)
        elif type_p < 0.66:
            self.transforms = CVRandomAffine(rng, np_rng, degrees=degrees, translate=translate,
                                             scale=scale, shear=shear)
        else:
            self.transforms = CVRandomPerspective(rng, np_rng, distortion=distortion)

    def __call__(self, img):
        if self.rng.random() < self.p:
            return self.transforms(img)
        return img


class CVDeterioration:
    def __init__(self, rng, np_rng, var, degrees, factor, p=0.5):
        self.rng, self.np_rng = rng, np_rng
        self.p = p
        steps = []
        if var is not None:
            steps.append(CVGaussianNoise(rng, np_rng, var=var))
        if degrees is not None:
            steps.append(CVMotionBlur(rng, np_rng, degrees=degrees))
        if factor is not None:
            steps.append(CVRescale(rng, np_rng, factor=factor))
        rng.shuffle(steps)
        self.steps = steps

    def __call__(self, img):
        if self.rng.random() < self.p:
            for step in self.steps:
                img = step(img)
        return img


class CVColorJitter:
    """torchvision's ColorJitter on RGBA: a factor in ``[max(0, 1 - x), 1 +
    x]`` each, the hue in ``[-h, h]``, the ops in a shuffled order."""

    def __init__(self, rng, np_rng, brightness=0.5, contrast=0.5, saturation=0.5, hue=0.1,
                 p=0.5):
        self.rng, self.np_rng = rng, np_rng
        self.p = p
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def __call__(self, img):
        if self.rng.random() >= self.p:
            return img
        steps = []
        if self.brightness:
            f = self.rng.uniform(max(0, 1 - self.brightness), 1 + self.brightness)
            steps.append(lambda im, f=f: ops.brightness(im, f))
        if self.contrast:
            f = self.rng.uniform(max(0, 1 - self.contrast), 1 + self.contrast)
            steps.append(lambda im, f=f: ops.contrast(im, f))
        if self.saturation:
            f = self.rng.uniform(max(0, 1 - self.saturation), 1 + self.saturation)
            steps.append(lambda im, f=f: ops.color(im, f))
        if self.hue:
            f = self.rng.uniform(-self.hue, self.hue)
            steps.append(lambda im, f=f: ops.shift_hue(im, f))
        self.rng.shuffle(steps)
        for step in steps:
            img = step(img)
        return img


def abinet_transform(opt, rng: random.Random, np_rng: np.random.RandomState):
    """The ``Aug="ABINet"`` chain of a training loader: geometry,
    deterioration, colour, then the bicubic resize to ``(imgH, imgW)``
    RGBA uint8.  Its construction draws from the generators."""
    geometry = CVGeometry(rng, np_rng, degrees=45, translate=(0.0, 0.0), scale=(0.5, 2.0),
                          shear=(45, 15), distortion=0.5, p=0.5)
    deterioration = CVDeterioration(rng, np_rng, var=20, degrees=6, factor=4, p=0.25)
    color = CVColorJitter(rng, np_rng, brightness=0.5, contrast=0.5, saturation=0.5, hue=0.1,
                          p=0.25)
    size = (opt.imgW, opt.imgH)

    def apply(img):
        if isinstance(img, (int, np.integer)):
            return img          # a bank index, as ResizeNormalize passes it
        img = image_codec.to_rgba(img)
        img = geometry(img)
        img = deterioration(img)
        img = color(img)
        return image_codec.resize(img, size)

    return apply
