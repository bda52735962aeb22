"""The augmentations' image ops (``mrn_tpu_torch.data.augment``, the C++ of
``data/csrc/augment.cpp``) against Pillow and OpenCV on seeded random
crops at natural sizes, on the CPU.

Output sizes must always be equal.  Pixels are bit for bit, except:

- CUBIC ``warpAffine`` / ``warpPerspective`` / ``resize``: at most 1 in 255
  on at most 0.1% of values (OpenCV's float order there, Intel IPP's for
  the resize, is not known; observed about 1e-5 to 2e-4);
- ``minAreaRect`` + ``boxPoints``: a corner may land one pixel off where
  two sides bound rectangles of (nearly) equal area, on at most 0.3% of
  the ABINet draws (observed 0.1-0.16%).

ROADMAP.md §3 records both.
"""

import cv2
import numpy as np
import PIL.Image
import PIL.ImageEnhance
import PIL.ImageFilter
import pytest

from mrn_tpu.data.abinet_aug import CVRandomAffine as JaxAffine
from mrn_tpu_torch.data import augment as ops

SHARE = 1e-3          # the CUBIC bound: at most this share of values off by 1
BOX_SHARE = 3e-3      # minAreaRect: at most this share of draws with a corner off by 1


def _crops(seed, n):
    """Random RGBA crops of 12-63 x 16-259 px, a third with a varying alpha."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = int(rng.integers(12, 64)), int(rng.integers(16, 260))
        img = rng.integers(0, 256, (h, w, 4), np.uint8)
        if i % 3:
            img[..., 3] = 255
        out.append(img)
    return out


def _assert_bounded(got, want, share=0.0):
    assert got.shape == want.shape
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    if share == 0.0:
        assert (diff == 0).all(), f"{int((diff > 0).sum())} values differ"
    else:
        assert diff.max() <= 1 and (diff > 0).sum() <= share * diff.size, \
            f"{int((diff > 0).sum())} of {diff.size} values differ by up to {diff.max()}"


# ------------------------------------------------------------------ Pillow
@pytest.mark.parametrize("seed", [0, 1])
def test_gaussian_blur_matches_pillow(seed):
    rng = np.random.default_rng(100 + seed)
    for img in _crops(seed, 12):
        radius = float(rng.uniform(0.1, 5.0))
        want = np.asarray(PIL.Image.fromarray(img).filter(PIL.ImageFilter.GaussianBlur(radius)))
        _assert_bounded(ops.gaussian_blur(img, radius), want)
    tiny = _crops(seed, 1)[0][:3, :4]
    want = np.asarray(PIL.Image.fromarray(tiny).filter(PIL.ImageFilter.GaussianBlur(4.5)))
    _assert_bounded(ops.gaussian_blur(tiny, 4.5), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_rotate_bicubic_expand_matches_pillow(seed):
    rng = np.random.default_rng(200 + seed)
    angles = [0.0, 90.0, -180.0, 270.0] + [float(rng.uniform(-15, 15)) for _ in range(10)]
    for img, angle in zip(_crops(seed, len(angles)), angles):
        want = np.asarray(PIL.Image.fromarray(img).rotate(angle, PIL.Image.BICUBIC, expand=True))
        _assert_bounded(ops.rotate(img, angle), want)


@pytest.mark.parametrize("name", ["brightness", "contrast", "color"])
def test_image_enhance_matches_pillow(name):
    rng = np.random.default_rng(300)
    cls = getattr(PIL.ImageEnhance, name.capitalize())
    factors = [0.0, 1.0, 0.4, 1.6] + [float(rng.uniform(0.5, 1.5)) for _ in range(8)]
    for img, f in zip(_crops(3, len(factors)), factors):
        want = np.asarray(cls(PIL.Image.fromarray(img)).enhance(f))
        _assert_bounded(getattr(ops, name)(img, f), want)


def test_luma_grayscale_and_flip_match_pillow():
    """``convert("L")`` over every RGB triple, the gray-with-alpha and the
    left-right flip."""
    v = np.arange(1 << 24, dtype=np.uint32).reshape(4096, 4096)
    rgb = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8)
    assert np.array_equal(ops.to_l(rgb), np.asarray(PIL.Image.fromarray(rgb).convert("L")))
    img = _crops(4, 1)[0]
    pil = PIL.Image.fromarray(img)
    gray = pil.convert("L").convert("RGBA")
    gray.putalpha(pil.getchannel("A"))
    _assert_bounded(ops.grayscale(img), np.asarray(gray))
    _assert_bounded(ops.flip_lr(img), np.asarray(pil.transpose(PIL.Image.FLIP_LEFT_RIGHT)))
    box = (3, 2, 11, 9)
    _assert_bounded(ops.crop(img, box), np.asarray(pil.crop(box)))


@pytest.mark.parametrize("factor", [0.1, -0.3, 0.004, -0.0039])
def test_hue_shift_matches_pillow(factor):
    """The HSV round trip over a million random colours with alpha."""
    img = np.random.default_rng(5).integers(0, 256, (1024, 1024, 4), np.uint8)
    pil = PIL.Image.fromarray(img)
    h, s, v = pil.convert("RGB").convert("HSV").split()
    h = h.point(lambda px: (px + int(factor * 255)) % 256)
    want = PIL.Image.merge("HSV", (h, s, v)).convert("RGB")
    want.putalpha(pil.getchannel("A"))
    _assert_bounded(ops.shift_hue(img, factor), np.asarray(want))


# ------------------------------------------------------------------ OpenCV
def test_matrices_match_opencv():
    rng = np.random.default_rng(6)
    for _ in range(300):
        center, angle, scale = (rng.uniform(0, 300), rng.uniform(0, 60)), rng.uniform(-90, 90), \
            rng.uniform(0.5, 2)
        m = cv2.getRotationMatrix2D(center, angle, scale)
        assert ops.get_rotation_matrix_2d(center, angle, scale).tobytes() == m.tobytes()
        assert ops.invert_affine(m).tobytes() == cv2.invertAffineTransform(m).tobytes()
        h, w = int(rng.integers(2, 60)), int(rng.integers(2, 300))
        oh = (rng.beta(1, 4, 4) * h / 4).astype(np.int64)
        ow = (rng.beta(1, 4, 4) * w / 4).astype(np.int64)
        end = np.array([(ow[0], oh[0]), (w - 1 - ow[1], oh[1]), (w - 1 - ow[2], h - 1 - oh[2]),
                        (ow[3], h - 1 - oh[3])], np.float32)
        start = np.array([(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)], np.float32)
        p = cv2.getPerspectiveTransform(start, end)
        assert ops.get_perspective_transform(start, end).tobytes() == p.tobytes()
        assert (ops._invert3(p).astype(np.float32).tobytes()
                == cv2.invert(p)[1].astype(np.float32).tobytes())


@pytest.mark.parametrize("interp", [0, 1, 2, 3])
def test_warp_affine_matches_opencv(interp):
    rng = np.random.default_rng(7 + interp)
    for img in _crops(interp, 10):
        h, w = img.shape[:2]
        m = cv2.getRotationMatrix2D((w / 2, h / 2), rng.uniform(-45, 45), rng.uniform(0.5, 2))
        m[0, 2] += rng.uniform(-3, 3)
        dsize = (int(rng.integers(2, 2 * w)), int(rng.integers(2, 2 * h)))
        want = cv2.warpAffine(img, m, dsize, flags=interp, borderMode=cv2.BORDER_REPLICATE)
        _assert_bounded(ops.warp_affine(img, m, dsize, interp), want,
                        SHARE if interp == ops.CUBIC else 0.0)


@pytest.mark.parametrize("interp", [0, 1, 2, 3])
def test_warp_perspective_matches_opencv(interp):
    rng = np.random.default_rng(17 + interp)
    for img in _crops(10 + interp, 10):
        h, w = img.shape[:2]
        oh = (rng.beta(1, 4, 4) * h / 4).astype(np.int64)
        ow = (rng.beta(1, 4, 4) * w / 4).astype(np.int64)
        end = np.array([(ow[0], oh[0]), (w - 1 - ow[1], oh[1]), (w - 1 - ow[2], h - 1 - oh[2]),
                        (ow[3], h - 1 - oh[3])], np.float32)
        start = np.array([(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)], np.float32)
        m = cv2.getPerspectiveTransform(start, end)
        want = cv2.warpPerspective(img, m, (w, h), flags=interp, borderMode=cv2.BORDER_REPLICATE)
        _assert_bounded(ops.warp_perspective(img, m, (w, h), interp), want,
                        SHARE if interp == ops.CUBIC else 0.0)


@pytest.mark.parametrize("interp", [0, 1, 2, 3])
def test_resize_matches_opencv(interp):
    """Up to ABINet's 512x128 and back down from its pyramid, exact halves
    (the fast area path), other sizes, and sources under 4 pixels."""
    rng = np.random.default_rng(27 + interp)
    cases = []
    for img in _crops(20 + interp, 6):
        h, w = img.shape[:2]
        cases += [(img, (512, 128)), (img, (int(rng.integers(1, 300)), int(rng.integers(1, 90))))]
        even = img[:h // 2 * 2, :w // 2 * 2]
        cases.append((even, (even.shape[1] // 2, even.shape[0] // 2)))
        down = cv2.pyrDown(cv2.pyrDown(cv2.resize(img, (512, 128))))
        cases.append((down, (w, h)))
    for h, w in ((1, 40), (3, 3), (2, 9), (50, 1)):
        cases.append((_crops(30 + h, 1)[0][:h, :w], (int(rng.integers(1, 60)),
                                                      int(rng.integers(1, 40)))))
    for img, dsize in cases:
        want = cv2.resize(img, dsize, interpolation=interp)
        _assert_bounded(ops.resize(img, dsize, interp), want,
                        SHARE if interp == ops.CUBIC else 0.0)


def test_pyr_down_filter2d_and_kernel_match_opencv():
    rng = np.random.default_rng(40)
    for img in _crops(41, 10) + [_crops(42, 1)[0][:1, :7], _crops(43, 1)[0][:5, :1]]:
        _assert_bounded(ops.pyr_down(img), cv2.pyrDown(img))
    for img in _crops(44, 10):
        degree, angle = int(rng.integers(1, 7)), float(rng.uniform(-90, 90))
        m = cv2.getRotationMatrix2D((degree // 2, degree // 2), angle, 1)
        kernel = np.zeros((degree, degree))
        kernel[degree // 2, :] = 1
        want_k = cv2.warpAffine(kernel, m, (degree, degree))
        assert ops.warp_kernel(kernel, m, (degree, degree)).tobytes() == want_k.tobytes()
        _assert_bounded(ops.filter2d(img, want_k / degree), cv2.filter2D(img, -1, want_k / degree))


def _geometry_draws(n, seed):
    """CVRandomAffine's and CVRandomPerspective's point sets for ABINet's
    draws at crop-like sizes."""
    rng = np.random.default_rng(seed)
    for t in range(n):
        h, w = int(rng.integers(2, 80)), int(rng.integers(2, 400))
        if t % 2 == 0:
            angle = (rng.beta(4, 4) - 0.5) * 90
            shear = [(rng.beta(4, 4) - 0.5) * 90, (rng.beta(4, 4) - 0.5) * 30]
            m = np.array(JaxAffine._inverse_affine_matrix((w / 2, h / 2), angle, (0, 0),
                                                          rng.uniform(0.5, 2), shear)).reshape(2, 3)
            yield np.array([(int(m[0, 0] * x + m[0, 1] * y + m[0, 2]),
                             int(m[1, 0] * x + m[1, 1] * y + m[1, 2]))
                            for x, y in ((0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1))])
        else:
            oh = (rng.beta(1, 4, 4) * h / 4).astype(np.int64)
            ow = (rng.beta(1, 4, 4) * w / 4).astype(np.int64)
            yield np.array([(ow[0], oh[0]), (w - 1 - ow[1], oh[1]),
                            (w - 1 - ow[2], h - 1 - oh[2]), (ow[3], h - 1 - oh[3])], np.float32)


def test_min_area_rect_box_points_match_opencv():
    """Every rectangle's box, truncated as ABINet truncates it: equal, or a
    corner one pixel off on at most ``BOX_SHARE`` of the draws."""
    off, n = 0, 4000
    for pts in _geometry_draws(n, 50):
        want = cv2.boxPoints(cv2.minAreaRect(pts)).astype(np.int64)
        got = ops.box_points(ops.min_area_rect(pts)).astype(np.int64)
        assert np.abs(got - want).max() <= 1
        off += not np.array_equal(got, want)
    assert off <= BOX_SHARE * n, f"{off} of {n} boxes off"
    rect = ((12.5, 3.25), (20.0, 4.5), -33.0)
    assert ops.box_points(rect).tobytes() == cv2.boxPoints(rect).tobytes()


def test_empty_and_one_pixel_images():
    """Pillow blurs, rotates and resizes an empty image (a 90% crop of a
    1-pixel crop) to empty or zero images, and so does the port; a 1x1
    crop's singular perspective warps to its pixel, as OpenCV's does."""
    from mrn_tpu_torch.data import image as image_codec
    for h, w in ((0, 0), (0, 5), (5, 0)):
        empty = np.zeros((h, w, 4), np.uint8)
        pil = PIL.Image.new("RGBA", (w, h))
        _assert_bounded(ops.gaussian_blur(empty, 2.0),
                        np.asarray(pil.filter(PIL.ImageFilter.GaussianBlur(2.0))).reshape(h, w, 4))
        want = pil.rotate(9.1, PIL.Image.BICUBIC, expand=True)
        _assert_bounded(ops.rotate(empty, 9.1),
                        np.asarray(want).reshape(want.size[1], want.size[0], 4))
        _assert_bounded(image_codec.resize(empty, (128, 32)),
                        np.asarray(pil.resize((128, 32), PIL.Image.BICUBIC)))
    pixel = np.full((1, 1, 4), 77, np.uint8)
    start = np.zeros((4, 2), np.float32)
    m = cv2.getPerspectiveTransform(start, start)
    for interp in range(4):
        want = cv2.warpPerspective(pixel, m, (1, 1), flags=interp,
                                   borderMode=cv2.BORDER_REPLICATE)
        got = ops.warp_perspective(pixel, ops.get_perspective_transform(start, start), (1, 1),
                                   interp)
        _assert_bounded(got, want)
