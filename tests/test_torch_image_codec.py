"""The port's PIL-free image codec (``mrn_tpu_torch/data/image.py`` over
``data/csrc/imagecodec.cpp``) against Pillow, bit for bit: PNG of every
colour type with and without tRNS (Pillow's adaptive filters, and a file
with every row filter), baseline JPEG gray / 4:4:4 / 4:2:2 / 4:2:0 at
several qualities, odd sizes and with restart markers (Pillow's
libjpeg-turbo, integer IDCT, fancy upsampling), and the bicubic resize at
0.3x-4x per axis and on RGBA with alpha below 255.  Bytes no decoder can
read raise ``CorruptImage`` (an ``OSError``, as Pillow's), the forms the
port does not decode raise ``UnsupportedImage``; the C++ path equals the
numpy version (``data.image_ref``); the committed fixtures still give
Pillow's arrays."""

import io
import os
import struct
import zlib

import cv2
import numpy as np
import PIL.Image
import pytest
import torch

from mrn_tpu_torch.data import image, image_ref


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch's CPU ops on one thread here: beside the other test workers,
    more threads oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "torch_codec")
SIZE = (256, 32)


def _crop(rng, h, w, channels):
    """Word-crop-like content with noise: strokes, a ramp per channel."""
    y, x = np.mgrid[0:h, 0:w]
    base = 128 + 100 * np.sin(x[..., None] / 7.0 + np.arange(channels)) * np.cos(y[..., None] / 5.0)
    return np.clip(base + rng.integers(-30, 30, (h, w, channels)), 0, 255).astype(np.uint8)


def _encode(im, fmt, **kw):
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def _pil_rgba(data):
    return np.asarray(PIL.Image.open(io.BytesIO(data)).convert("RGBA"))


def _fixture_names():
    return sorted(n for n in os.listdir(FIXTURES) if not n.endswith(".npz"))


# ------------------------------------------------------------------ fixtures
def test_fixtures_cover_every_form():
    names = _fixture_names()
    total = sum(os.path.getsize(os.path.join(FIXTURES, n)) for n in os.listdir(FIXTURES))
    assert len(names) >= 24 and total < 300_000
    for form in ("gray_q", "rgb444", "rgb422", "rgb420", "_rst", "L.png", "L_trns", "RGB.png",
                 "RGB_trns", "LA.png", "RGBA.png", "P.png", "P_trns", "L1.png", "filters"):
        assert any(form in n for n in names), form


@pytest.mark.parametrize("name", _fixture_names())
def test_fixture_decodes_as_pil(name):
    """The file still gives Pillow's arrays, and the C++ and numpy decoders
    give them too (decode and the 32x256 resize)."""
    expected = np.load(os.path.join(FIXTURES, "expected.npz"))
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    pil = PIL.Image.open(io.BytesIO(data)).convert("RGBA")
    np.testing.assert_array_equal(np.asarray(pil), expected[f"{name}:decode"])
    np.testing.assert_array_equal(np.asarray(pil.resize(SIZE, PIL.Image.BICUBIC)),
                                  expected[f"{name}:resize"])
    np.testing.assert_array_equal(image.decode(data), expected[f"{name}:decode"])
    np.testing.assert_array_equal(image.decode(data, SIZE), expected[f"{name}:resize"])
    np.testing.assert_array_equal(image_ref.decode(data), expected[f"{name}:decode"])


# ---------------------------------------------------------------------- JPEG
@pytest.mark.parametrize("mode,subsampling", [("L", 0), ("RGB", 0), ("RGB", 1), ("RGB", 2)])
def test_jpeg_matches_pil(mode, subsampling):
    rng = np.random.default_rng(subsampling)
    for quality in (50, 75, 95):
        for h, w in ((31, 57), (24, 48), (48, 320), (7, 3), (1, 1), (16, 2), (33, 5), (17, 4)):
            arr = _crop(rng, h, w, 1 if mode == "L" else 3)
            im = PIL.Image.fromarray(arr[:, :, 0] if mode == "L" else arr, mode)
            for rst in (0, 2):
                kw = dict(quality=quality, subsampling=subsampling)
                if rst:
                    kw["restart_marker_blocks"] = rst
                data = _encode(im, "JPEG", **kw)
                assert (b"\xff\xdd" in data) == bool(rst)
                np.testing.assert_array_equal(image.decode(data), _pil_rgba(data),
                                              err_msg=f"{mode} {subsampling} q{quality} "
                                                      f"{h}x{w} rst{rst}")


def test_jpeg_rgb_coded_matches_pil():
    """An Adobe-marked RGB JPEG takes no colour conversion, as in libjpeg."""
    arr = _crop(np.random.default_rng(5), 21, 45, 3)
    data = _encode(PIL.Image.fromarray(arr), "JPEG", quality=90, keep_rgb=True)
    assert b"Adobe" in data
    np.testing.assert_array_equal(image.decode(data), _pil_rgba(data))


# ----------------------------------------------------------------------- PNG
def _png_cases(rng, h, w):
    rgb, gray = _crop(rng, h, w, 3), _crop(rng, h, w, 1)[:, :, 0]
    pal = PIL.Image.fromarray(rgb).quantize(colors=200)
    return [
        ("L", PIL.Image.fromarray(gray, "L"), {}),
        ("L-trns", PIL.Image.fromarray(gray, "L"), {"transparency": int(gray[0, 0])}),
        ("RGB", PIL.Image.fromarray(rgb), {}),
        ("RGB-trns", PIL.Image.fromarray(rgb), {"transparency": tuple(int(v) for v in rgb[0, 0])}),
        ("LA", PIL.Image.fromarray(_crop(rng, h, w, 2), "LA"), {}),
        ("RGBA", PIL.Image.fromarray(_crop(rng, h, w, 4)), {}),
        ("P", pal, {}),
        ("P-trns-index", pal, {"transparency": 3}),
        ("P-trns-alphas", pal, {"transparency": bytes(rng.integers(0, 256, 150, np.uint8))}),
        ("P-4bit", PIL.Image.fromarray(rgb).quantize(colors=12), {}),
        ("P-1bit-trns", PIL.Image.fromarray(rgb).quantize(colors=2), {"transparency": 1}),
        ("1", PIL.Image.fromarray(gray > 128), {}),
        ("L-2bit", PIL.Image.fromarray(gray, "L"), {"bits": 2}),
        ("L-4bit", PIL.Image.fromarray(gray, "L"), {"bits": 4}),
    ]


@pytest.mark.parametrize("h,w", [(31, 57), (24, 48), (5, 3), (1, 1), (40, 200)])
def test_png_matches_pil(h, w):
    rng = np.random.default_rng(h * w)
    for name, im, kw in _png_cases(rng, h, w):
        data = _encode(im, "PNG", **kw)
        np.testing.assert_array_equal(image.decode(data), _pil_rgba(data),
                                      err_msg=f"{name} {h}x{w}")


def test_pil_filters_include_paeth():
    data = _encode(PIL.Image.fromarray(_crop(np.random.default_rng(0), 40, 200, 3)), "PNG")
    png = image.parse_png(data)
    stride = 200 * 3 + 1
    assert 4 in {png.raw[i * stride] for i in range(40)}


# -------------------------------------------------------------------- resize
def test_resize_matches_pil():
    rng = np.random.default_rng(7)
    checked = 0
    for trial in range(40):
        h, w = int(rng.integers(1, 60)), int(rng.integers(1, 300))
        arr = _crop(rng, h, w, 4)
        arr[:, :, 3] = 255 if trial % 2 else rng.integers(0, 256, (h, w))
        fx, fy = rng.uniform(0.3, 4.0, 2)
        for size in (SIZE, (max(1, int(w * fx)), max(1, int(h * fy))), (w, 32), (256, h)):
            np.testing.assert_array_equal(
                image.resize(arr, size),
                np.asarray(PIL.Image.fromarray(arr).resize(size, PIL.Image.BICUBIC)),
                err_msg=f"{h}x{w} -> {size}")
            checked += 1
    assert checked == 160


def test_resize_of_gray_and_rgb_arrays_is_pils():
    rng = np.random.default_rng(3)
    for arr in (_crop(rng, 20, 70, 1)[:, :, 0], _crop(rng, 20, 70, 3)):
        want = PIL.Image.fromarray(arr).convert("RGBA").resize(SIZE, PIL.Image.BICUBIC)
        np.testing.assert_array_equal(image.resize(arr, SIZE), np.asarray(want))
    same = _crop(rng, 32, 256, 4)
    np.testing.assert_array_equal(image.resize(same, SIZE), same)


# ------------------------------------------------------------ C++ vs numpy
def test_cpp_equals_numpy_version():
    rng = np.random.default_rng(11)
    datas = []
    for sub in (0, 1, 2):
        arr = _crop(rng, 23, 41, 3)
        datas.append(_encode(PIL.Image.fromarray(arr), "JPEG", quality=80, subsampling=sub,
                             restart_marker_blocks=2))
    datas.append(_encode(PIL.Image.fromarray(_crop(rng, 19, 33, 1)[:, :, 0], "L"), "JPEG"))
    for name, im, kw in _png_cases(rng, 13, 29):
        datas.append(_encode(im, "PNG", **kw))
    for data in datas:
        for size in (None, SIZE, (20, 40)):
            np.testing.assert_array_equal(image.decode(data, size), image_ref.decode(data, size))
    for _ in range(10):
        h, w = int(rng.integers(1, 40)), int(rng.integers(1, 120))
        arr = _crop(rng, h, w, 4)
        size = (int(rng.integers(1, 300)), int(rng.integers(1, 64)))
        np.testing.assert_array_equal(image.resize(arr, size), image_ref.resize(arr, size))


def test_encode_png_round_trips_through_pil():
    arr = _crop(np.random.default_rng(4), 17, 39, 4)
    data = image.encode_png(arr)
    np.testing.assert_array_equal(_pil_rgba(data), arr)
    np.testing.assert_array_equal(image.decode(data), arr)


@pytest.mark.parametrize("channels,ctype,mode", [(1, 0, "L"), (3, 2, "RGB"), (4, 6, "RGBA")])
def test_encode_png_writes_the_channels_given(channels, ctype, mode):
    """Gray, RGB and RGBA arrays become colour types 0, 2 and 6, read back
    by Pillow in that mode and by cv2's IMREAD_UNCHANGED in that shape."""
    arr = _crop(np.random.default_rng(channels), 9, 13, channels)
    data = image.encode_png(arr[:, :, 0] if channels == 1 else arr)
    assert image.parse_png(data).color_type == ctype
    pil = PIL.Image.open(io.BytesIO(data))
    assert pil.mode == mode
    np.testing.assert_array_equal(np.asarray(pil).reshape(arr.shape), arr)
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(bgr, image.imdecode(data, image.IMREAD_UNCHANGED))
    assert bgr.shape == ((9, 13) if channels == 1 else (9, 13, channels))


# -------------------------------------------------------------------- errors
def _pil_raises_oserror(data):
    with pytest.raises(OSError):
        PIL.Image.open(io.BytesIO(data)).convert("RGBA")


def test_unreadable_bytes_raise_corrupt_as_pil_does():
    rng = np.random.default_rng(9)
    jpeg = _encode(PIL.Image.fromarray(_crop(rng, 40, 120, 3)), "JPEG", quality=90)
    png = _encode(PIL.Image.fromarray(_crop(rng, 40, 120, 3)), "PNG")
    for data in (jpeg[:len(jpeg) // 2], png[:len(png) // 2], b"", b"not an image at all",
                 jpeg[:2] + b"\x00" * 50):
        _pil_raises_oserror(data)
        for decoder in (image.decode, image_ref.decode):
            with pytest.raises(image.CorruptImage):
                decoder(data)
    assert issubclass(image.CorruptImage, OSError)


def _set_interlace(png: bytes) -> bytes:
    ihdr = bytearray(png[16:29])
    ihdr[12] = 1
    crc = struct.pack(">I", zlib.crc32(bytes(ihdr), zlib.crc32(b"IHDR")))
    return png[:16] + bytes(ihdr) + crc + png[33:]


def _thunderscan_tiff(h=6, w=10):
    """A 4-bit gray ThunderScan TIFF (every sample a raw code), which Pillow
    reads and the port names and refuses."""
    data = bytes(0xC0 | v % 16 for v in range(h * w))
    tags = [(256, 3, w), (257, 3, h), (258, 3, 4), (259, 3, 32809), (262, 3, 1), (273, 4, 8),
            (277, 3, 1), (278, 3, h), (279, 4, len(data))]
    pad = b"\0" * (len(data) % 2)
    return (b"II" + struct.pack("<HI", 42, 8 + len(data) + len(pad)) + data + pad +
            struct.pack("<H", len(tags)) +
            b"".join(struct.pack("<HHII" if ty == 4 else "<HHIHH", tag, ty, 1, *(
                (v,) if ty == 4 else (v, 0))) for tag, ty, v in tags) + b"\0" * 4)


def test_unsupported_forms_raise_naming_the_form():
    """The forms the codec now decodes give Pillow's arrays (the numpy
    reference, which models the first forms only, still raises on them);
    ThunderScan TIFF and a JPEG form no library here writes raise in
    both."""
    rng = np.random.default_rng(10)
    rgb = PIL.Image.fromarray(_crop(rng, 30, 60, 3))
    gray16 = PIL.Image.fromarray(_crop(rng, 30, 60, 1)[:, :, 0].astype(np.uint16) * 257)
    decoded = {
        "progressive": _encode(rgb, "JPEG", progressive=True),
        "4-component": _encode(rgb.convert("CMYK"), "JPEG"),
        "16-bit": _encode(gray16, "PNG"),
        "interlaced": _set_interlace(_encode(PIL.Image.fromarray(_crop(rng, 1, 1, 3)), "PNG")),
        "GIF": _encode(rgb, "GIF"),
        "BMP": _encode(rgb, "BMP"),
        "WebP": _encode(rgb, "WEBP"),
        "TIFF": _encode(rgb, "TIFF", compression="tiff_lzw"),
        "ZSTD TIFF": _encode(rgb, "TIFF", compression="zstd"),
    }
    for form, data in decoded.items():
        np.testing.assert_array_equal(image.decode(data), _pil_rgba(data), err_msg=form)
        with pytest.raises(image.UnsupportedImage):
            image_ref.decode(data, key="root/image-000000007")
    jpeg = bytearray(_encode(rgb, "JPEG"))
    jpeg[jpeg.index(b"\xff\xc0") + 1] = 0xC9     # SOF9: arithmetic coding
    raising = {r"TIFF \(ThunderScan\)": _thunderscan_tiff(),
               "arithmetic-coded JPEG": bytes(jpeg)}
    for form, data in raising.items():
        for decoder in (image.decode, image_ref.decode):
            with pytest.raises(image.UnsupportedImage, match=form):
                decoder(data, key="root/image-000000007")
    with pytest.raises(image.UnsupportedImage, match="root/image-000000007"):
        image.decode(raising[r"TIFF \(ThunderScan\)"], key="root/image-000000007")
    assert not issubclass(image.UnsupportedImage, OSError)
