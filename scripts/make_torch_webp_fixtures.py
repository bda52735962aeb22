"""Regenerates ``tests/fixtures/torch_webp/``: a small scene tree and word
crops in the WebP forms, with what Pillow, cv2 and the JAX package's
``crop_by_word`` make of them (``tests/fixtures/torch_forms/``'s layout).

- ``imgs/`` + ``gts/``: five WebP scenes of words from the campaign's
  first alphabet on noise (``make_torch_forms_fixtures``' scene writer),
  under the ``.jpg`` / ``.png`` names ``crop_by_word`` lists: lossy
  (Pillow), lossless (Pillow), lossy written by cv2, and lossy with an
  EXIF orientation 6 that cv2 applies (shown upright); and one under
  ``.webp``, which both tools pass over.
- ``crops/``: word crops: lossy at qualities 5-100 and methods 0-6, odd
  sizes (1x1, 1xN, Nx1, not multiples of 16); libwebp's own options
  (simple loop filter, sharpness, 2-8 token partitions, 1-4 segments,
  raw and filtered ALPH) through its ``WebPEncode``; lossless gradients
  and palettes of 2, 4, 16 and 256 colours; lossy with alpha at
  ``alpha_quality`` < 100; cv2's lossy and lossless; animations (Pillow's
  two frames, and a frame smaller than its canvas with a background
  colour); a VP8X file without the alpha flag over an ALPH chunk; two
  crops named ``.jpg`` (what ``RawDataset`` lists).  ``labels.txt``
  (``name word``).
- ``expected.npz``: the SHA-1 digests of Pillow's view and cv2's two
  views of every file, and the JAX ``crop_by_word`` run on the tree
  (``make_torch_forms_fixtures``' ``expected_views`` and ``jax_crops``).

    python3 scripts/make_torch_webp_fixtures.py

Needs Pillow, cv2 (with the libwebp Pillow bundles) and the JAX package's
tools, so it runs where the tests run.  ``tests/test_torch_webp_fixtures.py``
holds the committed files to what this script writes; ``chip_smoke.py``
holds the port's codec, ``crop_by_word``, ``create_lmdb`` and the CLIs
against them on the machine with the card, which has neither library.
"""

from __future__ import annotations

import ctypes
import glob
import importlib.util
import io
import os
import shutil
import struct
import sys
from typing import Dict, List, Tuple

import cv2
import numpy as np
import PIL
import PIL.Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_spec = importlib.util.spec_from_file_location(
    "make_torch_forms_fixtures", os.path.join(ROOT, "scripts", "make_torch_forms_fixtures.py"))
forms = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(forms)

OUT = os.path.join(ROOT, "tests", "fixtures", "torch_webp")
SEED = 2121
# VP8X flags
ALPHA, ANIMATION, EXIF = 0x10, 0x02, 0x08


# --------------------------------------------------------- libwebp's encoder
_CONFIG_FIELDS = ("lossless", "quality", "method", "image_hint", "target_size", "target_PSNR",
                  "segments", "sns_strength", "filter_strength", "filter_sharpness",
                  "filter_type", "autofilter", "alpha_compression", "alpha_filtering",
                  "alpha_quality", "pass", "show_compressed", "preprocessing", "partitions",
                  "partition_limit", "emulate_jpeg_size", "thread_level", "low_memory",
                  "near_lossless", "exact", "use_delta_palette", "use_sharp_yuv")
_ABI = 0x020F
_lib = None


def _libwebp() -> ctypes.CDLL:
    """The libwebp Pillow bundles (``pillow.libs/libwebp-*.so``)."""
    global _lib
    if _lib is None:
        libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
        for dep in glob.glob(os.path.join(libs, "libsharpyuv-*.so*")):
            ctypes.CDLL(dep, mode=ctypes.RTLD_GLOBAL)
        _lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libwebp-*.so*"))[0])
    return _lib


def webp_encode(rgba: np.ndarray, **options) -> bytes:
    """``WebPEncode`` of an RGBA uint8 array with ``WebPConfig`` fields set
    by name (the options Pillow does not expose: ``filter_type`` 0 is the
    simple loop filter, ``partitions`` log2 of the token partitions,
    ``segments``, ``alpha_compression`` 0 for a raw ALPH,
    ``alpha_filtering`` ...)."""
    lib = _libwebp()
    rgba = np.ascontiguousarray(rgba, np.uint8)
    h, w = rgba.shape[:2]
    config = (ctypes.c_int32 * 64)()
    if not lib.WebPConfigInitInternal(config, 0, ctypes.c_float(75.0), _ABI):
        raise RuntimeError("WebPConfigInit failed")
    floats = ctypes.cast(config, ctypes.POINTER(ctypes.c_float))
    for name, value in options.items():
        at = _CONFIG_FIELDS.index(name)
        if name in ("quality", "target_PSNR"):
            floats[at] = value
        else:
            config[at] = value
    if not lib.WebPValidateConfig(config):
        raise ValueError(f"libwebp refuses the options {options}")
    picture = (ctypes.c_uint8 * 512)()      # WebPPicture, 64-bit layout
    if not lib.WebPPictureInitInternal(picture, _ABI):
        raise RuntimeError("WebPPictureInit failed")
    ints = ctypes.cast(picture, ctypes.POINTER(ctypes.c_int32))
    ptrs = ctypes.cast(picture, ctypes.POINTER(ctypes.c_void_p))
    ints[0] = int(bool(options.get("lossless")))   # use_argb
    ints[2], ints[3] = w, h
    if not lib.WebPPictureImportRGBA(picture, rgba.ctypes.data_as(ctypes.c_void_p), w * 4):
        raise RuntimeError("WebPPictureImportRGBA failed")
    writer = (ctypes.c_uint8 * 64)()        # WebPMemoryWriter
    lib.WebPMemoryWriterInit(writer)
    ptrs[12] = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value   # writer
    ptrs[13] = ctypes.addressof(writer)                                  # custom_ptr
    try:
        if not lib.WebPEncode(config, picture):
            raise RuntimeError(f"WebPEncode failed (error {ints[34]})")
        mem = ctypes.cast(writer, ctypes.POINTER(ctypes.c_void_p))[0]
        size = ctypes.cast(writer, ctypes.POINTER(ctypes.c_size_t))[1]
        return ctypes.string_at(mem, size)
    finally:
        lib.WebPMemoryWriterClear(writer)
        lib.WebPPictureFree(picture)


# ------------------------------------------------------------ RIFF writing
def chunks(data: bytes) -> List[Tuple[bytes, bytes]]:
    """(fourcc, payload) of a WebP file's chunks."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        size = struct.unpack_from("<I", data, pos + 4)[0]
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def _pack(parts) -> bytes:
    return b"".join(c + struct.pack("<I", len(d)) + d + b"\0" * (len(d) & 1) for c, d in parts)


def riff(parts) -> bytes:
    body = _pack(parts)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def vp8x(flags: int, w: int, h: int) -> Tuple[bytes, bytes]:
    return b"VP8X", struct.pack("<I", flags) + (w - 1).to_bytes(3, "little") + \
        (h - 1).to_bytes(3, "little")


def anim(background=(0, 0, 0, 0), loops: int = 0) -> Tuple[bytes, bytes]:
    return b"ANIM", bytes(background) + loops.to_bytes(2, "little")


def anmf(x: int, y: int, w: int, h: int, parts, duration: int = 100,
         flags: int = 0) -> Tuple[bytes, bytes]:
    head = b"".join(v.to_bytes(3, "little") for v in (x // 2, y // 2, w - 1, h - 1, duration))
    return b"ANMF", head + bytes([flags]) + _pack(parts)


def exif_orientation(orientation: int) -> bytes:
    """A TIFF-structured EXIF block (no "Exif" prefix, as WebP keeps it)."""
    return (b"II*\x00" + struct.pack("<I", 8) + struct.pack("<H", 1) +
            struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack("<I", 0))


def with_exif(data: bytes, orientation: int) -> bytes:
    """A still WebP rewritten as VP8X with its EXIF flag and an EXIF chunk."""
    parts = [p for p in chunks(data) if p[0] != b"VP8X"]
    w, h = _size(data)
    flags = EXIF | (ALPHA if any(c == b"ALPH" for c, _ in parts) else 0)
    return riff([vp8x(flags, w, h)] + parts + [(b"EXIF", exif_orientation(orientation))])


def _size(data: bytes) -> Tuple[int, int]:
    return PIL.Image.open(io.BytesIO(data)).size


def pil_webp(array: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    PIL.Image.fromarray(array).save(buf, "WEBP", **kw)
    return buf.getvalue()


def cv_webp(bgr: np.ndarray, quality: int) -> bytes:
    """cv2's writer (quality above 100: lossless)."""
    ok, data = cv2.imencode(".webp", bgr, [cv2.IMWRITE_WEBP_QUALITY, quality])
    assert ok
    return data.tobytes()


# ----------------------------------------------------------------- content
def _opaque(rgb: np.ndarray) -> np.ndarray:
    return np.dstack([rgb, np.full(rgb.shape[:2], 255, np.uint8)])


def _rgba(rng, rgb: np.ndarray) -> np.ndarray:
    """The word with an alpha ramp and a transparent column."""
    h, w = rgb.shape[:2]
    alpha = np.clip(np.linspace(40, 300, w)[None, :] + rng.integers(-20, 20, (h, w)), 0, 255)
    alpha[:, :2] = 0
    return np.concatenate([rgb, alpha.astype(np.uint8)[:, :, None]], axis=2)


def scenes(rng) -> Dict[str, bytes]:
    """{"imgs/<name>": bytes, "gts/<name>.txt": bytes}, one scene a form."""
    files = {}

    def put(name, data, gt):
        files[f"imgs/{name}"] = data
        files[f"gts/{os.path.splitext(name)[0]}.txt"] = gt.encode("utf-8")

    img, gt = forms._scene(rng, 120, 170)
    put("w0_lossy.jpg", pil_webp(img, quality=80), gt)
    img, gt = forms._scene(rng, 70, 140)
    put("w1_lossless.png", pil_webp(img, lossless=True, method=4), gt)
    img, gt = forms._scene(rng, 110, 150)
    put("w2_cv2.jpg", cv_webp(img[:, :, ::-1], 85), gt)
    img, gt = forms._scene(rng, 130, 100)     # shown upright after orientation 6
    put("w3_exif6.jpg", with_exif(pil_webp(np.ascontiguousarray(np.rot90(img)), quality=75), 6),
        gt)
    img, gt = forms._scene(rng, 90, 110)      # a .webp name: both tools pass it over
    put("w4_skipped.webp", pil_webp(img, quality=60), gt)
    return files


def crops(rng) -> Tuple[Dict[str, bytes], str]:
    """{"crops/<name>": bytes} in every WebP form, and labels.txt."""
    files, labels = {}, []

    def put(name, data, word):
        files[f"crops/{name}"] = data
        labels.append(f"{name} {word}")

    def next_word(h=28):
        word = forms._word(rng, 2, 4)
        return word, forms._render(rng, word, h, h * len(word) + 6)

    for i, (quality, method) in enumerate(((5, 0), (50, 4), (90, 6), (100, 2))):
        word, rgb = next_word(27 + i)
        put(f"d{i:02d}_lossy_q{quality}_m{method}.webp",
            pil_webp(rgb, quality=quality, method=method), word)
    word, rgb = next_word()
    put("d04_lossy_1x1.webp", pil_webp(rgb[:1, :1].copy(), quality=70), word)
    put("d05_lossy_1xN.webp", pil_webp(rgb[:1].copy(), quality=70), word)
    put("d06_lossy_Nx1.webp", pil_webp(rgb[:, :1].copy(), quality=70), word)
    word, rgb = next_word(33)
    put("d07_simple_filter.webp", webp_encode(_opaque(rgb), quality=60, filter_type=0,
                                              filter_strength=70, filter_sharpness=3), word)
    word, rgb = next_word(31)
    put("d08_partitions8_segments1.webp", webp_encode(_opaque(rgb), quality=55, partitions=3,
                                                      segments=1), word)
    word, rgb = next_word(29)
    put("d09_partitions2_segments3.webp", webp_encode(_opaque(rgb), quality=65, partitions=1,
                                                      segments=3, filter_sharpness=7), word)
    word, rgb = next_word()
    put("d10_alpha_raw.webp", webp_encode(_rgba(rng, rgb), quality=70, alpha_compression=0),
        word)
    word, rgb = next_word()
    put("d11_alpha_filtered.webp", webp_encode(_rgba(rng, rgb), quality=70, alpha_filtering=2,
                                               alpha_quality=60), word)
    word, rgb = next_word()
    put("d12_alpha_quality30.webp", pil_webp(_rgba(rng, rgb), quality=75, alpha_quality=30),
        word)
    word, rgb = next_word()
    ramp = (np.linspace(0, 255, rgb.shape[1])[None, :, None] * 0.5 + rgb * 0.5).astype(np.uint8)
    put("d13_lossless_gradient.webp", pil_webp(ramp, lossless=True), word)
    for i, n in enumerate((2, 4, 16, 256)):
        word, rgb = next_word()
        pal = PIL.Image.fromarray(rgb).quantize(n, dither=PIL.Image.Dither.NONE)
        put(f"d{14 + i:02d}_lossless_palette{n}.webp",
            pil_webp(np.asarray(pal.convert("RGB")), lossless=True), word)
    word, rgb = next_word()
    put("d18_lossless_alpha.webp", pil_webp(_rgba(rng, rgb), lossless=True, exact=True), word)
    word, rgb = next_word()
    put("d19_cv2_lossy.webp", cv_webp(rgb[:, :, ::-1], 70), word)
    word, rgb = next_word()
    put("d20_cv2_lossless.webp", cv_webp(rgb[:, :, ::-1], 101), word)
    word, rgb = next_word()
    frames = [PIL.Image.fromarray(rgb), PIL.Image.fromarray(255 - rgb)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], duration=80,
                   quality=80)
    put("d21_animated.webp", buf.getvalue(), word)
    word, rgb = next_word()
    h, w = rgb.shape[:2]
    still = chunks(pil_webp(_rgba(rng, rgb)[: h - 6, : w - 10].copy(), quality=70))
    parts = [p for p in still if p[0] in (b"ALPH", b"VP8 ")]
    put("d22_animated_offset.webp",
        riff([vp8x(ALPHA | ANIMATION, w, h), anim((30, 60, 90, 255), 0),
              anmf(4, 2, w - 10, h - 6, parts),
              anmf(0, 0, w, h, chunks(pil_webp(rgb, lossless=True)))]), word)
    word, rgb = next_word()
    still = chunks(pil_webp(_rgba(rng, rgb), quality=70))
    put("d23_alph_without_flag.webp",
        riff([vp8x(0, *rgb.shape[1::-1])] + [p for p in still if p[0] != b"VP8X"]), word)
    word, rgb = next_word()
    put("d24_lossy_named.jpg", pil_webp(rgb, quality=85), word)
    word, rgb = next_word()
    put("d25_lossless_named.jpg", pil_webp(rgb, lossless=True), word)
    return files, "\n".join(labels) + "\n"


def build(out: str) -> None:
    rng = np.random.default_rng(SEED)
    files = scenes(rng)
    crop_files, labels = crops(rng)
    files.update(crop_files)
    files["crops/labels.txt"] = labels.encode("utf-8")
    if os.path.exists(out):
        shutil.rmtree(out)
    for name, data in files.items():
        os.makedirs(os.path.join(out, os.path.dirname(name)), exist_ok=True)
        with open(os.path.join(out, name), "wb") as f:
            f.write(data)
    expected = forms.expected_views(files)
    expected.update(forms.jax_crops(out))
    np.savez_compressed(os.path.join(out, "expected.npz"), **expected)


if __name__ == "__main__":
    build(OUT)
    total = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(OUT) for f in fs)
    print(f"wrote {OUT}: {total / 1024:.0f} KB")
