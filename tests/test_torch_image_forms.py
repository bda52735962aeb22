"""The port's codec on the image forms a scene tree brings, against Pillow
12.1.0 and cv2 5.0.0 on the CPU, bit for bit: ``data.image.decode``
against ``Image.open(b).convert("RGBA")`` and ``data.image.imdecode``
against ``cv2.imdecode`` with ``IMREAD_COLOR`` / ``IMREAD_UNCHANGED``.

Progressive and any-sampling JPEG (block smoothing on files whose
refinement stops early), CMYK, EXIF orientations, 16-bit and Adam7 PNG of
every colour type, GIF and BMP; the forms still not decoded raise
``UnsupportedImage`` naming the form.
"""

import importlib.util
import io
import struct
from pathlib import Path

import cv2
import numpy as np
import PIL.Image
import pytest

from mrn_tpu_torch.data import image

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "make_torch_forms_fixtures", ROOT / "scripts" / "make_torch_forms_fixtures.py")
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)

SIZES = [(1, 1), (7, 13), (16, 16), (17, 33), (37, 53)]


def _scene(h, w, c=3, seed=0):
    rng = np.random.default_rng(seed + 31 * h + w)
    y, x = np.mgrid[0:h, 0:w]
    a = (np.sin(x / 3.0)[:, :, None] * 60 + np.cos(y / 5.0)[:, :, None] * 50 + 120
         + rng.normal(0, 20, (h, w, c)) + np.arange(c) * 15)
    return np.clip(a, 0, 255).astype(np.uint8)


def _pil_save(im, fmt, **kw):
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def _pil_view(data):
    return np.asarray(PIL.Image.open(io.BytesIO(data)).convert("RGBA"))


def _check_pil(data):
    got = image.decode(data)
    want = _pil_view(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _check_cv(data):
    for flag in (cv2.IMREAD_COLOR, cv2.IMREAD_UNCHANGED):
        want = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
        got = image.imdecode(data, flag)
        assert got.dtype == want.dtype and got.shape == want.shape, (flag, got.shape,
                                                                     want.shape)
        np.testing.assert_array_equal(got, want)


def _check(data):
    _check_pil(data)
    _check_cv(data)


def _sof(data):
    """(marker, [(h, v)] per component) of a JPEG's frame header."""
    pos = 2
    while True:
        marker, length = data[pos + 1], struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            n = data[pos + 9]
            return marker, [(data[pos + 11 + 3 * i] >> 4, data[pos + 11 + 3 * i] & 15)
                            for i in range(n)]
        pos += 2 + length


# ---------------------------------------------------------------------- JPEG
@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("quality", [30, 95])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_pil_jpeg(size, quality, subsampling, progressive):
    data = _pil_save(PIL.Image.fromarray(_scene(*size)), "JPEG", quality=quality,
                     subsampling=subsampling, progressive=progressive)
    assert _sof(data)[0] == (0xC2 if progressive else 0xC0)
    _check(data)


CV_SAMPLING = {"411": ((4, 1), cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411),
               "440": ((1, 2), cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440),
               "420": ((2, 2), cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420),
               "422": ((2, 1), cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422),
               "444": ((1, 1), cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)}


@pytest.mark.parametrize("progressive", [0, 1])
@pytest.mark.parametrize("sampling", sorted(CV_SAMPLING))
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_cv2_sampling_factors(size, sampling, progressive):
    factor, flag = CV_SAMPLING[sampling]
    ok, data = cv2.imencode(".jpg", _scene(*size), [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag,
                                                    cv2.IMWRITE_JPEG_PROGRESSIVE, progressive])
    data = data.tobytes()
    assert ok and _sof(data)[1][0] == factor
    _check(data)


@pytest.mark.parametrize("interval", [1, 3])
def test_progressive_restart_markers(interval):
    ok, data = cv2.imencode(".jpg", _scene(37, 53), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                                     cv2.IMWRITE_JPEG_RST_INTERVAL, interval])
    assert ok and b"\xff\xdd" in data.tobytes()
    _check(data.tobytes())


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_gray_and_cmyk_jpeg(size, progressive):
    _check(_pil_save(PIL.Image.fromarray(_scene(*size, c=1)[:, :, 0]), "JPEG",
                     progressive=progressive))
    cmyk = _pil_save(PIL.Image.fromarray(_scene(*size)).convert("CMYK"), "JPEG", quality=90,
                     progressive=progressive)
    assert _sof(cmyk)[0] == (0xC2 if progressive else 0xC0) and len(_sof(cmyk)[1]) == 4
    _check(cmyk)


def _scans(data):
    """[(marker, segment bytes)] of a JPEG, each SOS with its entropy data."""
    pos, segs = 2, []
    while data[pos + 1] != 0xD9:
        marker = data[pos + 1]
        end = pos + 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if marker == 0xDA:
            while not (data[end] == 0xFF and data[end + 1] not in (0, *range(0xD0, 0xD8))):
                end += 1
        segs.append((marker, data[pos:end]))
        pos = end
    return segs


def _keep_scans(data, keep):
    """The JPEG with only the scans ``keep(ss, se, ah, al, index)`` keeps."""
    out, i = b"\xff\xd8", 0
    for marker, seg in _scans(data):
        if marker == 0xDA:
            n = seg[4]
            ss, se, a = seg[5 + 2 * n:8 + 2 * n]
            if keep(ss, se, a >> 4, a & 15, i):
                out += seg
            i += 1
        else:
            out += seg
    return out + b"\xff\xd9"


CUTS = {"no_refinement": lambda ss, se, ah, al, i: ah == 0,
        "dc_only": lambda ss, se, ah, al, i: ss == 0,
        "dc_first_only": lambda ss, se, ah, al, i: ss == 0 and ah == 0,
        "first_3": lambda ss, se, ah, al, i: i < 3,
        "first_6": lambda ss, se, ah, al, i: i < 6}


@pytest.mark.parametrize("cut", sorted(CUTS))
@pytest.mark.parametrize("subsampling", [0, 2])
@pytest.mark.parametrize("size", [(17, 9), (37, 16), (64, 80), (9, 53)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_block_smoothing_where_refinement_stops(size, subsampling, cut):
    """libjpeg smooths the first coefficients still owed bits from a 5x5
    window of DC values (narrow images replicate the edge blocks)."""
    full = _pil_save(PIL.Image.fromarray(_scene(*size)), "JPEG", quality=75,
                     subsampling=subsampling, progressive=True)
    _check(_keep_scans(full, CUTS[cut]))


@pytest.mark.parametrize("endian", ["<", ">"])
@pytest.mark.parametrize("orientation", range(10))
def test_exif_orientation_in_cv2s_view_only(orientation, endian):
    tiff = (b"II" if endian == "<" else b"MM") + struct.pack(endian + "HI", 42, 8)
    tiff += struct.pack(endian + "H", 1) + struct.pack(endian + "HHIHH", 0x0112, 3, 1,
                                                       orientation, 0)
    tiff += struct.pack(endian + "I", 0)
    app1 = b"Exif\x00\x00" + tiff
    base = _pil_save(PIL.Image.fromarray(_scene(37, 53)), "JPEG", quality=90)
    data = base[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 + base[2:]
    _check(data)
    assert image.imdecode(data).shape[:2] == ((53, 37) if orientation in (5, 6, 7, 8)
                                              else (37, 53))
    assert image.imdecode(data, image.IMREAD_UNCHANGED).shape[:2] == (37, 53)


# ----------------------------------------------------------------------- PNG
PNG_TYPES = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
             (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


def _png_cases(ctype, depth, h, w, rng):
    """[(tag, samples, plte, trns)] for one colour type and depth."""
    c = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    s = rng.integers(0, 1 << depth, (h, w, c))
    if depth == 16:   # small values too: I;16 clips them at 255
        s = np.where(rng.random((h, w, c)) < 0.3, rng.integers(0, 300, (h, w, c)), s)
    if ctype == 3:
        n = min(1 << depth, 6 if depth > 1 else 2)
        s = s % (n + 1)      # index n lies past PLTE: black in both libraries
        plte = rng.integers(0, 256, 3 * n).astype(np.uint8).tobytes()
        return [("", s, plte, b""),
                ("trns", s, plte, rng.integers(0, 256, n - 1).astype(np.uint8).tobytes())]
    if ctype == 0:
        k = int(s[0, 0, 0])
        return [("", s, b"", b""), ("key", s, b"", struct.pack(">H", k)),
                ("key8", s, b"", struct.pack(">H", k % 256 if depth == 16 else k))]
    if ctype == 2:
        cases = [("", s, b"", b""), ("key", s, b"", struct.pack(">HHH", *s[0, 0].tolist()))]
        if depth == 16:  # Pillow compares the high bytes with the keys' low bytes
            s = s.copy()
            s[h // 2, 0] = [0x0512, 0x0634, 0x0700]
            cases.append(("lowkey", s, b"", struct.pack(">HHH", 0x1105, 0x2206, 0x3307)))
        return cases
    return [("", s, b"", b"")]


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("ctype,depth", PNG_TYPES, ids=lambda v: str(v))
@pytest.mark.parametrize("size", [(1, 1), (3, 5), (9, 9), (17, 33)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_png_forms(size, ctype, depth, interlace):
    rng = np.random.default_rng(depth * 100 + ctype * 10 + size[1])
    for _, s, plte, trns in _png_cases(ctype, depth, *size, rng):
        data = fx.write_png(s, ctype, depth, interlace, plte, trns)
        _check(data)


@pytest.mark.parametrize("orientation", [1, 3, 6, 8])
def test_png_exif_chunk_rotates_in_cv2s_view(orientation):
    exif = fx._chunk(b"eXIf", fx._exif(orientation))
    _check(fx.write_png(_scene(7, 11), 2, 8, extra=exif))


def test_pil_writes_16bit_gray_as_i16():
    gray = (np.arange(6 * 9, dtype=np.uint16).reshape(6, 9) * 1200)
    data = _pil_save(PIL.Image.fromarray(gray), "PNG")
    assert PIL.Image.open(io.BytesIO(data)).mode == "I;16"
    _check(data)


# ----------------------------------------------------------------------- GIF
@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("transparency", [None, 0, 1])
@pytest.mark.parametrize("colors", [2, 16, 256])
def test_gif(colors, transparency, interlace):
    p = PIL.Image.fromarray(_scene(13, 21)).quantize(colors)
    kw = {} if transparency is None else {"transparency": transparency}
    _check(_pil_save(p, "GIF", interlace=interlace, **kw))


@pytest.mark.parametrize("transparency", [None, 7])
def test_gray_gif(transparency):
    kw = {} if transparency is None else {"transparency": transparency}
    _check(_pil_save(PIL.Image.fromarray(_scene(9, 40, c=1)[:, :, 0]), "GIF", **kw))


@pytest.mark.parametrize("transparency", [None, 3])
def test_gif_frame_inside_a_larger_screen(transparency):
    kw = {} if transparency is None else {"transparency": transparency}
    data = bytearray(_pil_save(PIL.Image.fromarray(_scene(13, 21)).quantize(16), "GIF", **kw))
    data[6:10] = struct.pack("<HH", 30, 20)   # the logical screen grows
    data[11] = 2                              # its background index
    at = 13 + (3 << ((data[10] & 7) + 1))
    while data[at] != 0x2C:                   # skip the extensions to the descriptor
        at += 2
        while data[at]:
            at += 1 + data[at]
        at += 1
    data[at + 1:at + 5] = struct.pack("<HH", 5, 4)
    _check(bytes(data))


def test_short_gif_raises_as_pillow_does():
    """A file cut short, and a frame its LZW stream does not fill: Pillow
    raises "image file is truncated"."""
    data = bytearray(_pil_save(PIL.Image.fromarray(_scene(20, 30)).quantize(16), "GIF"))
    at = 13 + (3 << ((data[10] & 7) + 1))
    while data[at] != 0x2C:
        at += 2
        while data[at]:
            at += 1 + data[at]
        at += 1
    unfilled = bytearray(data)
    unfilled[8:10] = struct.pack("<H", 40)            # the screen's height
    unfilled[at + 7:at + 9] = struct.pack("<H", 40)   # the frame's
    for short in (bytes(data[:len(data) // 2]), bytes(unfilled)):
        with pytest.raises(OSError, match="truncated"):
            _pil_view(short)
        for call in (image.decode, image.imdecode):
            with pytest.raises(image.CorruptImage, match="truncated GIF"):
                call(short)


def test_gif_without_colour_tables():
    """Pillow reads it as mode L (the indices as gray); cv2's view raises
    (OpenCV's default table is its own)."""
    data = bytearray(_pil_save(PIL.Image.fromarray(_scene(9, 14)).quantize(16), "GIF"))
    n = 3 << ((data[10] & 7) + 1)
    data[10] &= 0x7F
    data = bytes(data[:13] + data[13 + n:])
    assert PIL.Image.open(io.BytesIO(data)).mode == "L"
    _check_pil(data)
    with pytest.raises(image.UnsupportedImage, match="GIF without a colour table"):
        image.imdecode(data)


# ----------------------------------------------------------------------- BMP
_PAL16 = [(int(v * 13 % 256), int(v * 57 % 256), int(v * 91 % 256)) for v in range(16)]
_PAL256 = [(int(v * 13 % 256), int(v * 57 % 256), int(v * 91 % 256)) for v in range(256)]
_GRAY16 = [(v * 17,) * 3 for v in range(16)]


def _bmp_cases(rng, h=7, w=13):
    """{tag: (bytes, whether the port's cv2 view reads it)}."""
    idx2, idx16, idx256 = (rng.integers(0, n, (h, w)) for n in (2, 16, 256))
    out = {}
    for td in (False, True):
        for hdr in (40, 108, 124):
            t = f"{hdr}{'td' if td else ''}"
            out[f"pal1 {t}"] = fx.write_bmp(idx2, 1, hdr, [(10, 20, 30), (200, 100, 50)],
                                            top_down=td)
            out[f"bw1 {t}"] = fx.write_bmp(idx2, 1, hdr, [(0, 0, 0), (255, 255, 255)],
                                           top_down=td)
            out[f"pal4 {t}"] = fx.write_bmp(idx16, 4, hdr, _PAL16, top_down=td)
            out[f"gray4 {t}"] = fx.write_bmp(idx16, 4, hdr, _GRAY16, top_down=td)
            out[f"pal8 {t}"] = fx.write_bmp(idx256, 8, hdr, _PAL256, top_down=td)
            out[f"pal8short {t}"] = fx.write_bmp(idx256 % 20, 8, hdr, _PAL256[:20], top_down=td)
            out[f"rgb24 {t}"] = fx.write_bmp(rng.integers(0, 256, (h, w, 3)), 24, hdr,
                                             top_down=td)
            out[f"rgb555 {t}"] = fx.write_bmp(rng.integers(0, 1 << 15, (h, w)), 16, hdr,
                                              top_down=td)
            out[f"bgrx32 {t}"] = fx.write_bmp(rng.integers(0, 1 << 32, (h, w), np.uint64), 32,
                                              hdr, top_down=td)
            for m in ((0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)):
                out[f"bf16 {m[0]:x} {t}"] = fx.write_bmp(rng.integers(0, 1 << 16, (h, w)), 16,
                                                         max(hdr, 52), masks=m, compression=3,
                                                         top_down=td)
            for m in ((0xFF0000, 0xFF00, 0xFF, 0xFF000000), (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                      (0xFF000000, 0xFF0000, 0xFF00, 0xFF)):
                if hdr >= 108:
                    out[f"bf32 {m[0]:x} {t}"] = fx.write_bmp(
                        rng.integers(0, 1 << 32, (h, w), np.uint64), 32, hdr, masks=m,
                        compression=3, top_down=td)
    idx40 = idx256 % 40
    out["rle8"] = fx.write_bmp(idx40, 8, 40, _PAL256[:40], compression=1,
                               rle=fx._rle8(np.tile(idx40, (1, 2))[:, :w]))
    out["rle8 delta"] = fx.write_bmp(idx40, 8, 40, _PAL256[:40], compression=1,
                                     rle=bytes([4, 3, 0, 2, 1, 1, 9, 9, 2, 5]) + b"\0\0"
                                     + bytes([w, 6]) + b"\0\1")
    out["rle4"] = fx.write_bmp(idx16, 4, 40, _PAL16, compression=2, rle=fx._rle4(idx16))
    return out


_BMPS = _bmp_cases(np.random.default_rng(5))


@pytest.mark.parametrize("tag", sorted(_BMPS))
def test_bmp_in_pillows_view(tag):
    _check_pil(_BMPS[tag])


@pytest.mark.parametrize("tag", sorted(t for t in _BMPS if not t.startswith(("bf", "rle"))))
def test_bmp_in_cv2s_view(tag):
    _check_cv(_BMPS[tag])


@pytest.mark.parametrize("tag", ["bf16 f800 40", "rle8", "rle4"])
def test_bmp_layouts_cv2s_view_does_not_model_raise(tag):
    with pytest.raises(image.UnsupportedImage, match="BMP under cv2's imread"):
        image.imdecode(_BMPS[tag])


def test_pillow_bmps_and_short_rle():
    rgb = PIL.Image.fromarray(_scene(13, 21))
    for im in (rgb, rgb.convert("L"), rgb.quantize(16), rgb.convert("1"),
               PIL.Image.fromarray(_scene(13, 21, c=4))):
        _check(_pil_save(im, "BMP"))
    short = fx.write_bmp(np.zeros((7, 13)), 4, 40, _PAL16, compression=2,
                         rle=bytes([0, 5, 0x12, 0x34, 0x50]) + b"\0\0\0\0\1")
    with pytest.raises(ValueError, match="not enough image data"):
        _pil_view(short)
    with pytest.raises(image.CorruptImage, match="not enough BMP image data"):
        image.decode(short)


# -------------------------------------------------------------------- raising
def _patched_sof(data, marker=None, precision=None):
    out, pos = bytearray(data), 2
    while True:
        m = out[pos + 1]
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            if marker is not None:
                out[pos + 1] = marker
            if precision is not None:
                out[pos + 4] = precision
            return bytes(out)
        pos += 2 + struct.unpack(">H", out[pos + 2:pos + 4])[0]


def _ycck():
    """Pillow's CMYK JPEG with its Adobe segment saying YCCK (transform 2)."""
    data = bytearray(_pil_save(PIL.Image.fromarray(_scene(16, 16)).convert("CMYK"), "JPEG"))
    at = bytes(data).index(b"Adobe")
    data[at + 11] = 2
    return bytes(data)


def _unencodable():
    base = _pil_save(PIL.Image.fromarray(_scene(16, 16)), "JPEG")
    return {"arithmetic-coded JPEG": _patched_sof(base, marker=0xC9),
            "lossless JPEG": _patched_sof(base, marker=0xC3),
            "12-bit JPEG": _patched_sof(base, precision=12),
            "YCCK JPEG": _ycck()}


@pytest.mark.parametrize("form", ["TIFF", "WebP", "TIFF (ZSTD)", "arithmetic-coded JPEG",
                                  "lossless JPEG", "12-bit JPEG", "YCCK JPEG"])
def test_forms_not_decoded_raise_naming_the_form(form):
    if form in ("WebP", "TIFF"):   # decoded now (data/csrc/webpcodec.cpp, tiffcodec.cpp)
        data = _pil_save(PIL.Image.fromarray(_scene(16, 16)), form.upper())
        np.testing.assert_array_equal(image.decode(data, key="root/image-000000007"),
                                      _pil_view(data))
        for flags in (image.IMREAD_COLOR, image.IMREAD_UNCHANGED):
            ref = cv2.imdecode(np.frombuffer(data, np.uint8), flags)
            got = image.imdecode(data, flags)
            assert got.dtype == ref.dtype and got.shape == ref.shape
            np.testing.assert_array_equal(got, ref)
        return
    calls = (image.decode, image.imdecode)
    if form == "TIFF (ZSTD)":   # decoded now in Pillow's view; cv2's libtiff has no ZSTD codec
        data = _pil_save(PIL.Image.fromarray(_scene(16, 16)), "TIFF", compression="zstd")
        np.testing.assert_array_equal(image.decode(data, key="root/image-000000007"),
                                      _pil_view(data))
        assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None
        with pytest.raises(image.CorruptImage):
            image.imdecode(data)
        return
    else:
        data = _unencodable()[form]
    for call in calls:
        with pytest.raises(image.UnsupportedImage, match=form):
            call(data, key="root/image-000000007")
    with pytest.raises(image.UnsupportedImage, match="root/image-000000007"):
        image.decode(data, key="root/image-000000007")


def test_ycck_is_what_pillow_decodes():
    """The raise is the port's choice, not a file Pillow refuses."""
    assert _pil_view(_ycck()).shape == (16, 16, 4)


def test_imread_gives_none_where_cv2_does(tmp_path):
    (tmp_path / "bad.png").write_bytes(b"not an image")
    assert image.imread(str(tmp_path / "bad.png")) is None
    assert cv2.imread(str(tmp_path / "bad.png")) is None
    assert image.imread(str(tmp_path / "missing.png")) is None
    good = tmp_path / "good.png"
    good.write_bytes(fx.write_png(_scene(5, 6), 2, 8))
    np.testing.assert_array_equal(image.imread(str(good)), cv2.imread(str(good)))
    with pytest.raises(ValueError, match="IMREAD_COLOR or IMREAD_UNCHANGED"):
        image.imdecode(good.read_bytes(), 0)
