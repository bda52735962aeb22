"""The augmentations' image operations without Pillow or OpenCV: each takes
and returns numpy uint8 arrays (RGBA ``[H, W, 4]`` unless it says
otherwise) and gives what the JAX package's call gives.

The per-pixel work is one call into the host library ``csrc/augment.cpp``
(built with ``g++`` at first use into ``build/mrn_tpu_torch/``); the
geometry stays here, in double precision as the libraries compute it:

- Pillow's: ``gaussian_blur`` (``ImageFilter.GaussianBlur``), ``rotate``
  (``Image.rotate(angle, BICUBIC, expand=True)``), ``crop``,
  ``brightness`` / ``contrast`` / ``color`` (``ImageEnhance``),
  ``to_l`` (``convert("L")``), ``grayscale`` (gray with the alpha kept),
  ``shift_hue`` (the HSV round trip of the jitters' hue step) and
  ``flip_lr``.
- OpenCV's: ``get_rotation_matrix_2d``, ``invert_affine``,
  ``get_perspective_transform``, ``min_area_rect`` + ``box_points``
  (float32, as ``cv2.minAreaRect`` / ``cv2.boxPoints``), ``warp_affine``
  and ``warp_perspective`` (BORDER_REPLICATE), ``warp_kernel``
  (``warpAffine`` of a float64 kernel, BORDER_CONSTANT), ``resize``,
  ``pyr_down`` and ``filter2d``.

Interpolation codes are OpenCV's: ``NEAREST`` 0, ``LINEAR`` 1, ``CUBIC``
2, ``AREA`` 3.  CUBIC warps and resizes agree with OpenCV's to 1 in 255 on
about 1 value in 10^5 (ROADMAP.md §3); every other operation is bit for
bit (``tests/test_torch_augment_ops.py``).
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

from mrn_tpu_torch.data import _host_build

__all__ = ["AREA", "CUBIC", "LINEAR", "NEAREST", "box_points", "brightness", "color",
           "contrast", "crop", "filter2d", "flip_lr", "gaussian_blur",
           "get_perspective_transform", "get_rotation_matrix_2d", "grayscale",
           "invert_affine", "min_area_rect", "pyr_down", "resize", "rotate", "shift_hue",
           "to_l", "warp_affine", "warp_kernel", "warp_perspective"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "augment.cpp"
# the float orders are the libraries': no contraction beyond the explicit fma calls
FLAGS = ("-ffp-contract=off",)
NEAREST, LINEAR, CUBIC, AREA = 0, 1, 2, 3


def _lib() -> ctypes.CDLL:
    lib = _host_build.load("augment", SOURCE, FLAGS)
    if not getattr(lib, "_typed", False):
        i, p, sz, f = ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_float
        lib.ag_gaussian_blur.argtypes = [p, i, i, f]
        lib.ag_affine_bicubic.argtypes = [p, i, i, p, i, i, p]
        lib.ag_blend.argtypes = [p, p, sz, f, p]
        lib.ag_blend.restype = None
        lib.ag_rgb_to_l.argtypes = [p, sz, i, p]
        lib.ag_rgb_to_l.restype = None
        lib.ag_rgb_to_hsv.argtypes = [p, sz, i, p]
        lib.ag_rgb_to_hsv.restype = None
        lib.ag_hsv_to_rgb.argtypes = [p, sz, p]
        lib.ag_hsv_to_rgb.restype = None
        lib.ag_warp.argtypes = [p, i, i, p, i, i, i, i, p]
        lib.ag_warp_kernel_f64.argtypes = [p, i, i, p, i, i, p]
        lib.ag_resize.argtypes = [p, i, i, i, i, i, p]
        lib.ag_pyr_down.argtypes = [p, i, i, p]
        lib.ag_filter2d.argtypes = [p, i, i, p, i, i, p]
        for fn in (lib.ag_gaussian_blur, lib.ag_affine_bicubic, lib.ag_warp,
                   lib.ag_warp_kernel_f64, lib.ag_resize, lib.ag_pyr_down, lib.ag_filter2d):
            fn.restype = i
        lib._typed = True
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _rgba(img: np.ndarray, empty_ok: bool = False) -> np.ndarray:
    """``img`` as a contiguous RGBA uint8 array; an empty one (which
    Pillow's ops take, OpenCV's refuse) only with ``empty_ok``."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 4:
        raise ValueError(f"expected an RGBA uint8 [H, W, 4] array, got {img.dtype} "
                         f"{img.shape}")
    if not empty_ok and (img.shape[0] < 1 or img.shape[1] < 1):
        raise ValueError(f"empty image {img.shape}")
    return img


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise ValueError(f"{what}: bad arguments (code {rc})")


# ------------------------------------------------------------------ Pillow
def gaussian_blur(img: np.ndarray, radius: float) -> np.ndarray:
    """``image.filter(ImageFilter.GaussianBlur(radius))``: every band."""
    out = _rgba(img, empty_ok=True).copy()
    h, w = out.shape[:2]
    _check(_lib().ag_gaussian_blur(_ptr(out), h, w, float(radius)), "gaussian_blur")
    return out


def _transpose(img: np.ndarray, angle: float) -> np.ndarray:
    k = {90.0: 1, 180.0: 2, 270.0: 3}[angle]
    return np.ascontiguousarray(np.rot90(img, k))


def rotate(img: np.ndarray, angle: float) -> np.ndarray:
    """``image.rotate(angle, BICUBIC, expand=True)`` (counter-clockwise
    degrees; the transparent black fill where no source pixel lands)."""
    img = _rgba(img, empty_ok=True)
    angle = angle % 360.0
    if angle == 0:
        return img.copy()
    if angle in (90.0, 180.0, 270.0):
        return _transpose(img, angle)
    h, w = img.shape[:2]
    center = (w / 2, h / 2)
    angle = -math.radians(angle)
    matrix = [round(math.cos(angle), 15), round(math.sin(angle), 15), 0.0,
              round(-math.sin(angle), 15), round(math.cos(angle), 15), 0.0]

    def transform(x, y, m):
        a, b, c, d, e, f = m
        return a * x + b * y + c, d * x + e * y + f

    matrix[2], matrix[5] = transform(-center[0], -center[1], matrix)
    matrix[2] += center[0]
    matrix[5] += center[1]
    xx, yy = [], []
    for x, y in ((0, 0), (w, 0), (w, h), (0, h)):
        tx, ty = transform(x, y, matrix)
        xx.append(tx)
        yy.append(ty)
    nw = math.ceil(max(xx)) - math.floor(min(xx))
    nh = math.ceil(max(yy)) - math.floor(min(yy))
    matrix[2], matrix[5] = transform(-(nw - w) / 2.0, -(nh - h) / 2.0, matrix)
    out = np.empty((nh, nw, 4), np.uint8)
    a = np.asarray(matrix, np.float64)
    _check(_lib().ag_affine_bicubic(_ptr(img), h, w, _ptr(a), nh, nw, _ptr(out)), "rotate")
    return out


def crop(img: np.ndarray, box: Tuple[int, int, int, int]) -> np.ndarray:
    """``image.crop((x0, y0, x1, y1))`` of a box inside the image."""
    x0, y0, x1, y1 = box
    return np.ascontiguousarray(img[y0:y1, x0:x1])


def flip_lr(img: np.ndarray) -> np.ndarray:
    """``image.transpose(FLIP_LEFT_RIGHT)``."""
    return np.ascontiguousarray(img[:, ::-1])


def _blend(degenerate: np.ndarray, img: np.ndarray, factor: float) -> np.ndarray:
    out = np.empty_like(img)
    _lib().ag_blend(_ptr(degenerate), _ptr(img), img.size, float(factor), _ptr(out))
    return out


def to_l(img: np.ndarray) -> np.ndarray:
    """``convert("L")`` of an RGB or RGBA array: ``[H, W]`` uint8."""
    img = np.ascontiguousarray(img)
    out = np.empty(img.shape[:2], np.uint8)
    _lib().ag_rgb_to_l(_ptr(img), out.size, img.shape[2], _ptr(out))
    return out


def grayscale(img: np.ndarray) -> np.ndarray:
    """``convert("LA").convert("RGBA")`` (= ``convert("L")`` to RGBA with
    the alpha put back): ``(L, L, L, A)``."""
    img = _rgba(img)
    out = np.repeat(to_l(img)[:, :, None], 4, axis=2)
    out[:, :, 3] = img[:, :, 3]
    return out


def brightness(img: np.ndarray, factor: float) -> np.ndarray:
    """``ImageEnhance.Brightness(image).enhance(factor)``."""
    img = _rgba(img)
    degenerate = np.zeros_like(img)
    degenerate[:, :, 3] = img[:, :, 3]
    return _blend(degenerate, img, factor)


def contrast(img: np.ndarray, factor: float) -> np.ndarray:
    """``ImageEnhance.Contrast(image).enhance(factor)``: toward the gray
    of the luma's mean, rounded as ``int(mean + 0.5)``."""
    img = _rgba(img)
    hist = np.bincount(to_l(img).ravel(), minlength=256)
    mean = int(float(np.dot(np.arange(256), hist)) / img.shape[0] / img.shape[1] + 0.5)
    degenerate = np.full_like(img, mean)
    degenerate[:, :, 3] = img[:, :, 3]
    return _blend(degenerate, img, factor)


def color(img: np.ndarray, factor: float) -> np.ndarray:
    """``ImageEnhance.Color(image).enhance(factor)``."""
    img = _rgba(img)
    return _blend(grayscale(img), img, factor)


def shift_hue(img: np.ndarray, factor: float) -> np.ndarray:
    """The jitters' hue step: ``convert("RGB").convert("HSV")``, the H band
    shifted by ``int(factor * 255)`` mod 256, back to RGB, the alpha put
    back."""
    img = _rgba(img)
    n = img.shape[0] * img.shape[1]
    hsv = np.empty((n, 3), np.uint8)
    lib = _lib()
    lib.ag_rgb_to_hsv(_ptr(img), n, 4, _ptr(hsv))
    hsv[:, 0] = (hsv[:, 0].astype(np.int64) + int(factor * 255)) % 256
    rgb = np.empty((n, 3), np.uint8)
    lib.ag_hsv_to_rgb(_ptr(hsv), n, _ptr(rgb))
    out = np.empty_like(img)
    out[:, :, :3] = rgb.reshape(img.shape[0], img.shape[1], 3)
    out[:, :, 3] = img[:, :, 3]
    return out


# ------------------------------------------------------------------ OpenCV
def get_rotation_matrix_2d(center: Tuple[float, float], angle: float,
                           scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: a 2x3 float64 matrix (the centre
    rounded to float32, as OpenCV's ``Point2f``)."""
    angle *= math.pi / 180
    alpha = math.cos(angle) * scale
    beta = math.sin(angle) * scale
    cx, cy = (float(np.float32(c)) for c in center)
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def invert_affine(m: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform`` of a 2x3 matrix."""
    m = np.asarray(m, np.float64).ravel()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = m[4] * d, m[0] * d, -m[1] * d, -m[3] * d
    b1 = -a11 * m[2] - a12 * m[5]
    b2 = -a21 * m[2] - a22 * m[5]
    return np.array([[a11, a12, b1], [a21, a22, b2]], np.float64)


def _invert3(m: np.ndarray) -> np.ndarray:
    """``cv::invert`` (DECOMP_LU) of a 3x3 float64 matrix: the cofactor
    form OpenCV takes for 3x3."""
    s = np.asarray(m, np.float64)
    d = (s[0, 0] * (s[1, 1] * s[2, 2] - s[1, 2] * s[2, 1])
         - s[0, 1] * (s[1, 0] * s[2, 2] - s[1, 2] * s[2, 0])
         + s[0, 2] * (s[1, 0] * s[2, 1] - s[1, 1] * s[2, 0]))
    if d == 0:
        return np.zeros((3, 3), np.float64)
    d = 1.0 / d
    t = [(s[1, 1] * s[2, 2] - s[1, 2] * s[2, 1]) * d,
         (s[0, 2] * s[2, 1] - s[0, 1] * s[2, 2]) * d,
         (s[0, 1] * s[1, 2] - s[0, 2] * s[1, 1]) * d,
         (s[1, 2] * s[2, 0] - s[1, 0] * s[2, 2]) * d,
         (s[0, 0] * s[2, 2] - s[0, 2] * s[2, 0]) * d,
         (s[0, 2] * s[1, 0] - s[0, 0] * s[1, 2]) * d,
         (s[1, 0] * s[2, 1] - s[1, 1] * s[2, 0]) * d,
         (s[0, 1] * s[2, 0] - s[0, 0] * s[2, 1]) * d,
         (s[0, 0] * s[1, 1] - s[0, 1] * s[1, 0]) * d]
    return np.array(t, np.float64).reshape(3, 3)


def _lu_solve(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """OpenCV's ``LU`` (Gaussian elimination, partial pivoting) of
    ``a x = b`` in float64; a singular system (a crop 1 pixel wide or
    high) gets its least-squares solution, where OpenCV takes another
    path (ROADMAP.md §3)."""
    a0, b0 = a.astype(np.float64), b.astype(np.float64)
    a, b = a0.copy(), b0.copy()
    m = a.shape[0]
    for i in range(m):
        k = i
        for j in range(i + 1, m):
            if abs(a[j, i]) > abs(a[k, i]):
                k = j
        if abs(a[k, i]) < np.finfo(np.float64).eps * 10:
            return np.linalg.lstsq(a0, b0, rcond=None)[0]
        if k != i:
            a[[i, k], i:] = a[[k, i], i:]
            b[[i, k]] = b[[k, i]]
        d = -1.0 / a[i, i]
        for j in range(i + 1, m):
            alpha = a[j, i] * d
            for c in range(i + 1, m):
                a[j, c] += alpha * a[i, c]
            b[j] += alpha * b[i]
    for i in range(m - 1, -1, -1):
        s = b[i]
        for c in range(i + 1, m):
            s -= a[i, c] * b[c]
        b[i] = s / a[i, i]
    return b


def get_perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """``cv2.getPerspectiveTransform`` of four float32 point pairs: 3x3
    float64."""
    src = np.asarray(src, np.float32)
    dst = np.asarray(dst, np.float32)
    a = np.zeros((8, 8), np.float64)
    b = np.zeros(8, np.float64)
    for i in range(4):
        sx, sy, dx, dy = src[i, 0], src[i, 1], dst[i, 0], dst[i, 1]
        a[i, 0] = a[i + 4, 3] = sx
        a[i, 1] = a[i + 4, 4] = sy
        a[i, 2] = a[i + 4, 5] = 1
        a[i, 6] = -(sx * dx)
        a[i, 7] = -(sy * dx)
        a[i + 4, 6] = -(sx * dy)
        a[i + 4, 7] = -(sy * dy)
        b[i] = dx
        b[i + 4] = dy
    x = _lu_solve(a, b)
    return np.append(x, 1.0).reshape(3, 3)


def warp_affine(img: np.ndarray, m: np.ndarray, dsize: Tuple[int, int],
                interp: int) -> np.ndarray:
    """``cv2.warpAffine(img, m, dsize, flags=interp,
    borderMode=BORDER_REPLICATE)``; ``dsize`` is ``(W, H)``."""
    return _warp(img, invert_affine(m), False, dsize, interp)


def warp_perspective(img: np.ndarray, m: np.ndarray, dsize: Tuple[int, int],
                     interp: int) -> np.ndarray:
    """``cv2.warpPerspective(img, m, dsize, flags=interp,
    borderMode=BORDER_REPLICATE)``."""
    return _warp(img, _invert3(m), True, dsize, interp)


def _warp(img, minv, persp, dsize, interp):
    img = _rgba(img)
    w, h = int(dsize[0]), int(dsize[1])
    out = np.empty((h, w, 4), np.uint8)
    minv = np.ascontiguousarray(minv, np.float64)
    _check(_lib().ag_warp(_ptr(img), img.shape[0], img.shape[1], _ptr(minv), int(persp), h, w,
                          int(interp), _ptr(out)), "warp")
    return out


def warp_kernel(kernel: np.ndarray, m: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.warpAffine(kernel, m, dsize)`` of a float64 ``[h, w]`` array
    (INTER_LINEAR, BORDER_CONSTANT 0)."""
    kernel = np.ascontiguousarray(kernel, np.float64)
    w, h = int(dsize[0]), int(dsize[1])
    out = np.empty((h, w), np.float64)
    minv = np.ascontiguousarray(invert_affine(m))
    _check(_lib().ag_warp_kernel_f64(_ptr(kernel), kernel.shape[0], kernel.shape[1], _ptr(minv),
                                     h, w, _ptr(out)), "warp_kernel")
    return out


def resize(img: np.ndarray, dsize: Tuple[int, int], interp: int) -> np.ndarray:
    """``cv2.resize(img, dsize, interpolation=interp)``."""
    img = _rgba(img)
    w, h = int(dsize[0]), int(dsize[1])
    out = np.empty((h, w, 4), np.uint8)
    _check(_lib().ag_resize(_ptr(img), img.shape[0], img.shape[1], h, w, int(interp),
                            _ptr(out)), "resize")
    return out


def pyr_down(img: np.ndarray) -> np.ndarray:
    """``cv2.pyrDown(img)``."""
    img = _rgba(img)
    h, w = img.shape[:2]
    out = np.empty(((h + 1) // 2, (w + 1) // 2, 4), np.uint8)
    _check(_lib().ag_pyr_down(_ptr(img), h, w, _ptr(out)), "pyr_down")
    return out


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(img, -1, kernel)`` of a float64 kernel (anchor at its
    centre, BORDER_REFLECT_101)."""
    img = _rgba(img)
    kernel = np.ascontiguousarray(kernel, np.float64)
    out = np.empty_like(img)
    _check(_lib().ag_filter2d(_ptr(img), img.shape[0], img.shape[1], _ptr(kernel),
                              kernel.shape[0], kernel.shape[1], _ptr(out)), "filter2d")
    return out


# ------------------------------------------------------- minAreaRect (float32)
_F = np.float32


def _cross(o, a, b) -> float:
    return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])


def _convex_hull(pts) -> list:
    """``cv2.convexHull(pts, clockwise=False, returnPoints=False)`` of a
    few points: the hull's indices from the largest ``(x, y)`` point on,
    counter-clockwise in a y-up frame, a repeated point by its first index,
    then OpenCV's cyclic shift toward a monotonic index sequence."""
    first = {}
    for i, p in enumerate(pts):
        first.setdefault(p, i)
    order = sorted(first.values(), key=lambda i: (pts[i][0], pts[i][1]))
    lower, upper = [], []
    for i in order:
        while len(lower) >= 2 and _cross(pts[lower[-2]], pts[lower[-1]], pts[i]) <= 0:
            lower.pop()
        lower.append(i)
    for i in reversed(order):
        while len(upper) >= 2 and _cross(pts[upper[-2]], pts[upper[-1]], pts[i]) <= 0:
            upper.pop()
        upper.append(i)
    hull = (lower[:-1] + upper[:-1]) or [order[0]]
    if order[-1] in hull:
        k = hull.index(order[-1])
        hull = hull[k:] + hull[:k]
    n = len(hull)
    if n < 3:
        return hull
    min_i = max_i = lt = 0
    for i in range(1, n):
        lt += hull[i - 1] < hull[i]
        if hull[i] < hull[min_i]:
            min_i = i
        if hull[i] > hull[max_i]:
            max_i = i
        if 1 < lt < i:
            break
    if abs(max_i - min_i) in (1, n - 1) and (lt <= 1 or lt >= n - 2):
        ascending = (max_i + 1) % n == min_i
        j = min_i if ascending else max_i
        if j > 0:
            shifted = []
            for i in range(n):
                cur, nxt = hull[j], hull[(j + 1) % n]
                shifted.append(cur)
                if i < n - 1 and ascending != (cur < nxt):
                    return hull
                j = (j + 1) % n
            return shifted
    return hull


def _rotating_calipers(p) -> list:
    """OpenCV's ``rotatingCalipers(..., CALIPERS_MINAREARECT)`` in float32
    over hull points ``p``: ``[corner, side 1, side 2]``."""
    n = len(p)
    vect, inv = [None] * n, [None] * n
    left = bottom = right = top = 0
    pt0 = p[0]
    left_x = right_x = pt0[0]
    top_y = bottom_y = pt0[1]
    for i in range(n):
        if pt0[0] < left_x:
            left_x, left = pt0[0], i
        if pt0[0] > right_x:
            right_x, right = pt0[0], i
        if pt0[1] > top_y:
            top_y, top = pt0[1], i
        if pt0[1] < bottom_y:
            bottom_y, bottom = pt0[1], i
        pt = p[i + 1 if i + 1 < n else 0]
        dx, dy = float(pt[0]) - float(pt0[0]), float(pt[1]) - float(pt0[1])
        vect[i] = (_F(dx), _F(dy))
        inv[i] = _F(1.0 / math.sqrt(dx * dx + dy * dy))
        pt0 = pt
    orientation = _F(0)
    ax, ay = float(vect[n - 1][0]), float(vect[n - 1][1])
    for i in range(n):
        bx, by = float(vect[i][0]), float(vect[i][1])
        convexity = ax * by - ay * bx
        if convexity != 0:
            orientation = _F(1) if convexity > 0 else _F(-1)
            break
        ax, ay = bx, by
    if orientation == 0:
        raise ValueError("degenerate hull")
    base_a, base_b = orientation, _F(0)
    seq = [bottom, right, top, left]
    minarea, buf = _F(np.finfo(np.float32).max), None
    for _ in range(n):
        dp = [base_a * vect[seq[0]][0] + base_b * vect[seq[0]][1],
              -base_b * vect[seq[1]][0] + base_a * vect[seq[1]][1],
              -base_a * vect[seq[2]][0] - base_b * vect[seq[2]][1],
              base_b * vect[seq[3]][0] - base_a * vect[seq[3]][1]]
        maxcos, main = dp[0] * inv[seq[0]], 0
        for i in range(1, 4):
            cosalpha = dp[i] * inv[seq[i]]
            if cosalpha > maxcos:
                main, maxcos = i, cosalpha
        k = seq[main]
        lead_x, lead_y = vect[k][0] * inv[k], vect[k][1] * inv[k]
        base_a, base_b = ((lead_x, lead_y), (lead_y, -lead_x), (-lead_x, -lead_y),
                          (-lead_y, lead_x))[main]
        seq[main] = 0 if seq[main] + 1 == n else seq[main] + 1
        dx, dy = p[seq[1]][0] - p[seq[3]][0], p[seq[1]][1] - p[seq[3]][1]
        width = dx * base_a + dy * base_b
        dx, dy = p[seq[2]][0] - p[seq[0]][0], p[seq[2]][1] - p[seq[0]][1]
        height = -dx * base_b + dy * base_a
        area = width * height
        if area <= minarea:
            minarea, buf = area, (seq[3], base_a, width, base_b, height, seq[0])
    a1, b1, a2, b2 = buf[1], buf[3], -buf[3], buf[1]
    c1 = a1 * p[buf[0]][0] + p[buf[0]][1] * b1
    c2 = a2 * p[buf[5]][0] + p[buf[5]][1] * b2
    idet = _F(1) / (a1 * b2 - a2 * b1)
    corner = ((c1 * b2 - c2 * b1) * idet, (a1 * c2 - a2 * c1) * idet)
    return [corner, (a1 * buf[2], b1 * buf[2]), (a2 * buf[4], b2 * buf[4])]


def min_area_rect(points) -> Tuple[Tuple[float, float], Tuple[float, float], float]:
    """``cv2.minAreaRect`` of a few points (float32, the angle in [-90,
    0)): ``((cx, cy), (w, h), angle)``.  Equal to OpenCV's but where two
    sides bound rectangles of equal area, when float rounding may pick the
    other (ROADMAP.md §3)."""
    pts = [(_F(x), _F(y)) for x, y in np.asarray(points, np.float64).tolist()]
    hp = [pts[i] for i in _convex_hull(pts)]
    if len(hp) > 2:
        o = _rotating_calipers(hp)
        cx = o[0][0] + (o[1][0] + o[2][0]) * _F(0.5)
        cy = o[0][1] + (o[1][1] + o[2][1]) * _F(0.5)
        v1, v2 = o[1], o[2]
    elif len(hp) == 2:
        cx, cy = (hp[0][0] + hp[1][0]) * _F(0.5), (hp[0][1] + hp[1][1]) * _F(0.5)
        v1, v2 = (hp[1][0] - hp[0][0], hp[1][1] - hp[0][1]), (_F(0), _F(0))
    else:
        return (float(hp[0][0]), float(hp[0][1])), (0.0, 0.0), 0.0
    w = _F(math.sqrt(float(v1[0]) * float(v1[0]) + float(v1[1]) * float(v1[1])))
    h = _F(math.sqrt(float(v2[0]) * float(v2[0]) + float(v2[1]) * float(v2[1])))
    angle = math.atan2(float(v1[1]), float(v1[0])) * 180 / math.pi
    while angle >= 0:
        angle -= 90
        w, h = h, w
    while angle < -90:
        angle += 90
        w, h = h, w
    return (float(cx), float(cy)), (float(w), float(h)), float(_F(angle))


def box_points(rect) -> np.ndarray:
    """``cv2.boxPoints(rect)``: 4x2 float32."""
    (cx, cy), (w, h), angle = rect
    cx, cy, w, h = _F(cx), _F(cy), _F(w), _F(h)
    rad = float(_F(angle)) * math.pi / 180.0
    b = _F(math.cos(rad)) * _F(0.5)
    a = _F(math.sin(rad)) * _F(0.5)
    return np.array([(cx - a * h - b * w, cy + b * h - a * w),
                     (cx + a * h - b * w, cy - b * h - a * w),
                     (cx + a * h + b * w, cy - b * h + a * w),
                     (cx - a * h + b * w, cy + b * h + a * w)], np.float32)
