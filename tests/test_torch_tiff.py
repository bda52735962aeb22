"""The port's TIFF decoder (``data/csrc/tiffcodec.cpp`` behind
``data.image``) against Pillow 12.1 and cv2 5.0 (both over libtiff 4.7),
bit for bit, on files written here from seeded numpy:

- every in-scope form: 1, 2, 4, 8 and 16-bit gray (MinIsBlack and
  MinIsWhite), RGB at 8 and 16 bits with associated, unassociated or
  unspecified extra samples, palette, gray + alpha, CMYK, YCbCr JPEG; none,
  PackBits, LZW (libtiff's codes and the old LSB-first ones), Deflate
  (both codes), LZMA and JPEG with its tables in tag 347; strips of 1 row
  to the whole image, tiles with odd edges, planar 2, FillOrder 2, the
  horizontal predictor at 8 and 16 bits, both byte orders, BigTIFF;
  sizes 1x1, 1xN and Nx1; a seeded sweep of all of them;
- the files Pillow's and cv2's own writers make (libtiff's encoders);
- the views' rules: Pillow's modes (a combination its table lacks fails
  to open), its unpremultiplied RGBa, 16-bit gray clipped; cv2's
  premultiplied alpha through libtiff's RGBA image, uint16 under
  ``IMREAD_UNCHANGED``, the Orientation under both flags, the uncompressed
  tiles it cannot read and the tiles libtiff's gray and palette put
  routines read askew;
- the forms not decoded raise ``UnsupportedImage`` naming them (old-style
  JPEG, ThunderScan), cut-off files ``CorruptImage`` and JAX's dummy
  crop; the files of the forms once refused (CCITT, ZSTD, signed and
  float samples, 12 bits, CIELab, YCbCr without JPEG) decode as the
  libraries do (``test_torch_tiff_ccitt.py``, ``test_torch_tiff_samples.py``
  and ``test_torch_zstd.py`` hold those forms in full);
- ``LmdbDataset`` over TIFF crops gives JAX's items and ``ResizeNormalize``
  tensors bytewise.

No CMYK JPEG-in-TIFF is written through Pillow's TIFF writer: it corrupts
the process heap (the CMYK JPEG cases here are written by ``write_tiff``).
"""

import importlib.util
import io
import struct
import warnings
from pathlib import Path

import cv2
import numpy as np
import PIL.Image
import pytest
import torch

from mrn_tpu.config import default_options as jax_options
from mrn_tpu.data import dataset as jax_dataset
from mrn_tpu.data.transform import ResizeNormalize as JaxResizeNormalize
from mrn_tpu_torch.config import default_options
from mrn_tpu_torch.data import dataset, image, lmdb_store
from mrn_tpu_torch.data.transform import ResizeNormalize

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "make_torch_tiff_fixtures", ROOT / "scripts" / "make_torch_tiff_fixtures.py")
tx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tx)

IMG_H, IMG_W = 32, 64
NONE, LZW, JPEG, DEFLATE, PACKBITS, ADOBE, LZMA = (tx.NONE, tx.LZW, tx.JPEG, tx.DEFLATE,
                                                   tx.PACKBITS, tx.ADOBE_DEFLATE, tx.LZMA)
# (photometric, bits, samples, extra samples) of the in-scope forms
FORMS = {
    "bilevel": (1, 1, 1, ()), "bilevel min-is-white": (0, 1, 1, ()),
    "gray2": (1, 2, 1, ()), "gray2 min-is-white": (0, 2, 1, ()),
    "gray4": (1, 4, 1, ()), "gray4 min-is-white": (0, 4, 1, ()),
    "gray8": (1, 8, 1, ()), "gray8 min-is-white": (0, 8, 1, ()),
    "gray16": (1, 16, 1, ()), "gray16 min-is-white": (0, 16, 1, ()),
    "gray alpha": (1, 8, 2, (2,)), "gray associated alpha": (1, 8, 2, (1,)),
    "rgb8": (2, 8, 3, ()), "rgba8 unassociated": (2, 8, 4, (2,)),
    "rgba8 associated": (2, 8, 4, (1,)), "rgbx8": (2, 8, 4, (0,)),
    "rgba8 without extra samples": (2, 8, 4, ()), "rgb16": (2, 16, 3, ()),
    "rgba16 unassociated": (2, 16, 4, (2,)), "rgba16 associated": (2, 16, 4, (1,)),
    "palette1": (3, 1, 1, ()), "palette2": (3, 2, 1, ()), "palette4": (3, 4, 1, ()),
    "palette8": (3, 8, 1, ()), "palette alpha": (3, 8, 2, (2,)), "cmyk8": (5, 8, 4, ()),
    "cmyk16": (5, 16, 4, ()),
}
# the divergences the port chooses (ROADMAP.md §3): a form one library
# misreads (cv2 reads planar 16-bit samples as chunky from buffers it does
# not fill; Pillow's raw unpackers take one letter of the mode a plane)
MISREAD = ("planar TIFF of 16-bit samples under cv2's IMREAD_UNCHANGED", "(uncompressed planar",
           "(planar, photometric 3")


def _samples(rng, photo, bps, spp, extra, h, w):
    s = rng.integers(0, 1 << bps, (h, w, spp))
    if extra and h * w > 4:   # alpha 0 and full among the rest
        s[::3, ::2, spp - len(extra)] = 0
        s[1::3, ::2, spp - len(extra)] = (1 << bps) - 1
    cmap = rng.integers(0, 65536, (1 << bps, 3)) if photo == 3 else None
    return s, cmap


def _write(rng, form, h, w, **kw):
    photo, bps, spp, extra = form
    s, cmap = _samples(rng, photo, bps, spp, extra, h, w)
    return tx.write_tiff(s, photo, bps, extra=extra, colormap=cmap, **kw)


def _pillow(data):
    """Pillow's RGBA, or the exception class it raises."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return np.asarray(PIL.Image.open(io.BytesIO(data)).convert("RGBA"))
    except (OSError, ValueError) as e:
        return type(e)


def _check(data, allow_misread=False):
    """Both views against the libraries: equal arrays (dtype and shape for
    cv2), or the port raising where the library fails (``CorruptImage``
    where Pillow raises OSError or cv2 gives None, ``UnsupportedImage``
    where Pillow raises ValueError).  Returns how many views decoded."""
    decoded = 0
    ref = _pillow(data)
    if isinstance(ref, np.ndarray):
        try:
            got = image.decode(data)
        except image.UnsupportedImage as e:
            assert allow_misread and any(m in str(e) for m in MISREAD), e
        else:
            assert got.shape == ref.shape
            np.testing.assert_array_equal(got, ref)
            decoded += 1
    else:
        with pytest.raises(image.CorruptImage if ref is not ValueError else
                           image.UnsupportedImage):
            image.decode(data)
    for flags in (image.IMREAD_COLOR, image.IMREAD_UNCHANGED):
        want = cv2.imdecode(np.frombuffer(data, np.uint8), flags)
        if want is None:
            with pytest.raises(image.CorruptImage):
                image.imdecode(data, flags)
            continue
        try:
            have = image.imdecode(data, flags)
        except image.UnsupportedImage as e:
            assert allow_misread and any(m in str(e) for m in MISREAD), e
            continue
        assert have.dtype == want.dtype and have.shape == want.shape, flags
        np.testing.assert_array_equal(have, want)
        decoded += 1
    return decoded


# ------------------------------------------------------------------ forms
@pytest.mark.parametrize("name", sorted(FORMS))
def test_each_form_in_strips_and_tiles(name):
    """Every in-scope form, LZW strips of 3 rows and Deflate tiles cut by
    both edges, in both byte orders."""
    rng = np.random.default_rng(sorted(FORMS).index(name))
    form = FORMS[name]
    seen = 0
    for order in "<>":
        seen += _check(_write(rng, form, 19, 23, compression=LZW, rows=3, order=order))
        seen += _check(_write(rng, form, 19, 37, compression=ADOBE, tile=(16, 16), order=order))
    assert seen >= 4 or name.startswith(("gray2", "gray4", "palette2", "cmyk16"))


@pytest.mark.parametrize("compression", [NONE, PACKBITS, LZW, DEFLATE, ADOBE, LZMA])
@pytest.mark.parametrize("size", [(1, 1), (1, 29), (23, 1), (17, 31)])
def test_each_compression_at_odd_sizes(compression, size):
    rng = np.random.default_rng(compression + size[0] * 100 + size[1])
    for form in (FORMS["rgb8"], FORMS["gray8"], FORMS["rgba16 unassociated"],
                 FORMS["bilevel min-is-white"], FORMS["palette4"]):
        for rows in (1, size[0]):
            _check(_write(rng, form, *size, compression=compression, rows=rows))
        _check(_write(rng, form, *size, compression=compression, tile=(16, 32)))


@pytest.mark.parametrize("bps", [8, 16])
@pytest.mark.parametrize("compression", [LZW, DEFLATE, LZMA])
def test_horizontal_predictor(bps, compression):
    rng = np.random.default_rng(bps + compression)
    for form in ((1, bps, 1, ()), (2, bps, 3, ()), (2, bps, 4, (2,))):
        for kw in (dict(rows=5), dict(tile=(16, 16)), dict(planar=2, rows=2)):
            for order in "<>":
                _check(_write(rng, form, 13, 21, compression=compression, predictor=2,
                              order=order, **kw), allow_misread=True)


@pytest.mark.parametrize("layout", ["planar strips", "planar tiles", "fill order 2",
                                    "fill order 2 tiles", "old-style LZW", "BigTIFF",
                                    "big-endian BigTIFF", "one strip a row", "multi-page"])
def test_layouts_neither_library_writes(layout):
    rng = np.random.default_rng(len(layout))
    kw = {"planar strips": dict(planar=2, rows=4), "planar tiles": dict(planar=2, tile=(16, 16)),
          "fill order 2": dict(fillorder=2, rows=3), "fill order 2 tiles": dict(
              fillorder=2, tile=(32, 16)), "old-style LZW": dict(compat=True, rows=6),
          "BigTIFF": dict(bigtiff=True, rows=5), "big-endian BigTIFF": dict(
              bigtiff=True, order=">"), "one strip a row": dict(rows=1),
          "multi-page": dict(pages=3)}[layout]
    decoded = 0
    for name in ("rgb8", "rgba8 unassociated", "rgba8 associated", "gray8", "bilevel", "cmyk8",
                 "rgb16", "palette8", "gray alpha"):
        for compression in (NONE, PACKBITS, LZW, ADOBE):
            decoded += _check(_write(rng, FORMS[name], 21, 35, compression=compression, **kw),
                              allow_misread=True)
    assert decoded > 36


def test_old_style_lzw_is_read_by_both():
    data = _write(np.random.default_rng(3), FORMS["rgb8"], 40, 70, compression=LZW,
                  compat=True)
    stream = tx.lzw(b"abc", compat=True)   # how libtiff tells the old codes apart
    assert stream[0] == 0 and stream[1] & 1
    assert _check(data) == 3


def test_lzw_table_resets_on_long_strips():
    """A strip long enough for several Clear codes (12-bit codes, the table
    full), at both bit orders."""
    rng = np.random.default_rng(5)
    s = rng.integers(0, 256, (120, 200, 3))
    s[:, ::7] = 9
    for compat in (False, True):
        assert _check(tx.write_tiff(s, 2, 8, compression=LZW, compat=compat)) == 3


# ------------------------------------------------------------------- JPEG
@pytest.mark.parametrize("photo,subsampling", [(6, (1, 1)), (6, (2, 1)), (6, (2, 2)),
                                               (2, (1, 1)), (1, (1, 1)), (5, (1, 1))])
def test_jpeg_in_tiff(photo, subsampling):
    """JPEG chunks with their tables in tag 347, strips (fancy upsampling
    restarts at each) and tiles; YCbCr converted, RGB, gray and CMYK as
    stored."""
    rng = np.random.default_rng(photo * 10 + subsampling[1])
    spp = {6: 3, 2: 3, 1: 1, 5: 4}[photo]
    for h, w, kw in ((1, 1, {}), (19, 1, dict(rows=8)), (37, 45, dict(rows=16)),
                     (37, 45, dict(tile=(16, 16))), (40, 70, dict(tile=(32, 16))),
                     (20, 33, dict(order=">", bigtiff=True))):
        s = rng.integers(0, 256, (h, w, spp))
        s = np.repeat(np.repeat(s[::3, ::3], 3, 0), 3, 1)[:h, :w]
        data = tx.write_tiff(s, photo, 8, compression=JPEG, subsampling=subsampling,
                             quality=int(rng.integers(30, 95)), **kw)
        # Pillow reads a big-endian BigTIFF as a classic TIFF, and fails
        assert _check(data) == 3 - int(kw.get("order") == ">")


# --------------------------------------------------------- library writers
PILLOW_MODES = ["RGB", "RGBA", "L", "1", "P", "LA", "I;16", "I;16B", "CMYK", "PA"]


@pytest.mark.parametrize("mode", PILLOW_MODES)
def test_pillow_written(mode):
    """Pillow's writer (libtiff's encoders): every compression it offers
    for the mode, strip sizes, BigTIFF, the predictor."""
    rng = np.random.default_rng(PILLOW_MODES.index(mode))
    for k, compression in enumerate((None, "tiff_lzw", "packbits", "tiff_adobe_deflate",
                                     "tiff_deflate", "lzma", "jpeg")):
        if compression == "jpeg" and mode not in ("RGB", "L"):
            continue
        for h, w in ((1, 1), (23, 41)):
            rgb = rng.integers(0, 256, (h, w, 3), np.uint8)
            if mode in ("I;16", "I;16B"):
                v = rng.integers(0, 65536, (h, w)).astype(">u2" if mode == "I;16B" else "<u2")
                im = PIL.Image.frombytes(mode, (w, h), v.tobytes())
            elif mode == "RGBA":
                im = PIL.Image.fromarray(np.dstack([rgb, rgb[:, :, 0]]))
            elif mode == "PA":
                im = PIL.Image.fromarray(rgb).convert("P").convert("PA")
            else:
                im = PIL.Image.fromarray(rgb).convert(mode)
            kw = dict(compression=compression)
            if compression not in (None, "jpeg"):   # JPEG strips: a multiple of 8 rows
                kw["strip_size"] = [64, 1 << 16][k % 2]
                kw["big_tiff"] = bool(k % 3 == 0)
            if compression in ("tiff_lzw", "tiff_adobe_deflate") and mode not in ("1", "P", "PA"):
                kw["tiffinfo"] = {317: 2}
            buf = io.BytesIO()
            im.save(buf, "TIFF", **kw)
            # cv2's libtiff has no LZMA codec
            assert _check(buf.getvalue()) == (1 if compression == "lzma" else 3)


def test_pillow_ycbcr_jpeg():
    """Photometric YCbCr under JPEG as Pillow writes it (libtiff's default
    4:2:0 YCbCrSubsampling)."""
    rng = np.random.default_rng(4)
    for h, w in ((8, 8), (21, 35), (64, 48)):
        rgb = rng.integers(0, 256, (h, w, 3), np.uint8)
        buf = io.BytesIO()
        PIL.Image.fromarray(rgb).convert("YCbCr").save(buf, "TIFF", compression="jpeg",
                                                       quality=80)
        assert _check(buf.getvalue()) == 3


@pytest.mark.parametrize("compression", [1, 5, 8, 32773, 32946])
def test_cv2_written(compression):
    rng = np.random.default_rng(compression)
    for shape in ((17, 29, 3), (17, 29, 4), (17, 29), (1, 1, 3)):
        for dtype in (np.uint8, np.uint16):
            arr = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
            ok, data = cv2.imencode(".tiff", arr, [cv2.IMWRITE_TIFF_COMPRESSION, compression])
            assert ok
            assert _check(data.tobytes()) == 3


# ------------------------------------------------------------ view rules
@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientation_in_both_views(orientation):
    """Pillow's load transposes (exif_transpose); cv2 turns the image under
    both flags, and its RGBA reads mirror each tile of a mirrored one."""
    rng = np.random.default_rng(orientation)
    for form in ("rgb8", "gray16", "rgba8 associated"):
        for kw in (dict(rows=4), dict(tile=(16, 16)), dict(tile=(32, 16))):
            data = _write(rng, FORMS[form], 21, 37, compression=LZW,
                          tags={274: (3, [orientation])}, **kw)
            assert _check(data) == 3
            if orientation in (5, 6, 7, 8):
                assert image.decode(data).shape[:2] == (37, 21)


def test_alpha_rules():
    """Pillow keeps unassociated alpha's colours and unpremultiplies
    associated alpha; cv2's BGRA is libtiff's (c * a + 127) / 255 of
    unassociated alpha, associated alpha as stored."""
    rgb = np.array([[[200, 100, 50, 128], [10, 20, 30, 0], [255, 255, 255, 255]]])
    un = tx.write_tiff(rgb, 2, 8, extra=(2,))
    assoc = tx.write_tiff(rgb, 2, 8, extra=(1,))
    np.testing.assert_array_equal(image.decode(un)[0, 0], [200, 100, 50, 128])
    np.testing.assert_array_equal(image.imdecode(un, image.IMREAD_UNCHANGED)[0, 0],
                                  [(50 * 128 + 127) // 255, (100 * 128 + 127) // 255,
                                   (200 * 128 + 127) // 255, 128])
    np.testing.assert_array_equal(image.decode(assoc)[0, :2],
                                  [[255, 199, 99, 128], [0, 0, 0, 0]])
    np.testing.assert_array_equal(image.imdecode(assoc, image.IMREAD_COLOR)[0, 0], [50, 100, 200])
    # IMREAD_COLOR drops alpha after libtiff premultiplied the colours
    np.testing.assert_array_equal(image.imdecode(un, image.IMREAD_COLOR)[0, 0],
                                  image.imdecode(un, image.IMREAD_UNCHANGED)[0, 0, :3])
    for data in (un, assoc):
        assert _check(data) == 3


def test_sixteen_bit_rules():
    """Pillow clips 16-bit gray (I;16) to 255 and takes RGB's high byte;
    cv2 gives uint16 under IMREAD_UNCHANGED, gray >> 8 and RGB through
    libtiff's (v * 255 + 32767) / 65535 under IMREAD_COLOR."""
    v = np.array([[0, 200, 255, 256, 32767, 32768, 65535]])
    gray = tx.write_tiff(v, 1, 16)
    np.testing.assert_array_equal(image.decode(gray)[0, :, 0], np.minimum(v[0], 255))
    got = image.imdecode(gray, image.IMREAD_UNCHANGED)
    assert got.dtype == np.uint16 and got.shape == (1, 7)
    np.testing.assert_array_equal(image.imdecode(gray, image.IMREAD_COLOR)[0, :, 0], v[0] >> 8)
    rgb = tx.write_tiff(np.stack([v, v, v], 2), 2, 16, order=">")
    np.testing.assert_array_equal(image.decode(rgb)[0, :, 0], v[0] >> 8)
    np.testing.assert_array_equal(image.imdecode(rgb, image.IMREAD_COLOR)[0, :, 0],
                                  (v[0] * 255 + 32767) // 65535)
    for data in (gray, rgb):
        assert _check(data) == 3


def test_cv2_rules_for_tiles():
    """Uncompressed tiles whose size is not a multiple of 1 KiB do not read
    through libtiff's RGBA image (cv2 gives None); 16-bit gray and
    two-sample tiles cut by the right edge are read askew by its gray and
    palette put routines, and the port reads them so."""
    rng = np.random.default_rng(6)
    small = _write(rng, FORMS["rgb8"], 20, 20, tile=(16, 16))
    assert cv2.imdecode(np.frombuffer(small, np.uint8), cv2.IMREAD_COLOR) is None
    with pytest.raises(image.CorruptImage):
        image.imdecode(small)
    assert _check(_write(rng, FORMS["rgba8 unassociated"], 20, 20, tile=(16, 16))) == 3
    for name in ("gray16", "gray alpha", "palette alpha"):
        data = _write(rng, FORMS[name], 30, 21, compression=PACKBITS, tile=(16, 16))
        _check(data)
        flat = _write(rng, FORMS[name], 30, 21, compression=PACKBITS, rows=30)
        _check(flat)


def test_pillow_rules_for_modes():
    """Combinations Pillow's table lacks fail to open (CorruptImage, JAX's
    dummy crop): 16-bit gray + alpha, big-endian 16-bit MinIsWhite, RGBA
    in FillOrder 2, 2-bit RGB."""
    rng = np.random.default_rng(8)
    for data in (_write(rng, (1, 16, 2, (2,)), 5, 6), _write(rng, (0, 16, 1, ()), 5, 6, order=">"),
                 _write(rng, (2, 8, 4, (2,)), 5, 6, fillorder=2, compression=LZW),
                 _write(rng, (2, 2, 3, ()), 5, 6)):
        assert _pillow(data) is PIL.UnidentifiedImageError
        with pytest.raises(image.CorruptImage):
            image.decode(data)
        _check(data)


def _sweep_case(seed):
    rng = np.random.default_rng(1000 + seed)
    names = sorted(FORMS)
    form = FORMS[names[rng.integers(len(names))]]
    compression = [NONE, PACKBITS, LZW, DEFLATE, ADOBE, LZMA][rng.integers(6)]
    photo, bps, spp, extra = form
    kw = {}
    if compression in (LZW, DEFLATE, ADOBE, LZMA) and bps in (8, 16) and rng.random() < 0.4:
        kw["predictor"] = 2
    if spp > 1 and rng.random() < 0.25:
        kw["planar"] = 2
    if rng.random() < 0.15:
        kw["fillorder"] = 2
    r = rng.random()
    if r < 0.25:
        kw["tile"] = [(16, 16), (32, 16), (16, 32)][rng.integers(3)]
    elif r < 0.6:
        kw["rows"] = int(rng.integers(1, 9))
    kw["order"] = "<>"[rng.integers(2)]
    kw["bigtiff"] = bool(rng.random() < 0.2)
    kw["compat"] = bool(compression == LZW and rng.random() < 0.3)
    if rng.random() < 0.25:
        kw["tags"] = {274: (3, [int(rng.integers(1, 9))])}
    h, w = [(1, 1), (1, 13), (11, 1), (7, 9), (20, 37), (33, 16)][rng.integers(6)]
    return _write(rng, form, h, w, compression=compression, **kw)


@pytest.mark.parametrize("block", range(8))
def test_seeded_sweep(block):
    """Random forms, compressions and layouts, 40 files a block."""
    decoded = sum(_check(_sweep_case(block * 40 + k), allow_misread=True) for k in range(40))
    assert decoded > 40


# ------------------------------------------------------- not decoded / broken
def _pil_tiff(mode, **kw):
    rgb = np.random.default_rng(12).integers(0, 256, (13, 21, 3), np.uint8)
    buf = io.BytesIO()
    PIL.Image.fromarray(rgb).convert(mode).save(buf, "TIFF", **kw)
    return buf.getvalue()


NOT_DECODED = {
    "old-style JPEG": lambda: tx.write_tiff(
        np.random.default_rng(12).integers(0, 256, (13, 21, 3)), 6, compression=tx.OLD_JPEG),
    "ThunderScan": lambda: tx.write_tiff(np.arange(35).reshape(5, 7) % 16, 1, 4,
                                         compression=tx.THUNDERSCAN),
}
# the forms this list held before the port decoded them, each now held to
# both libraries on the same file
DECODED_NOW = {
    "ZSTD": lambda: _pil_tiff("RGB", compression="zstd"),
    "CCITT G4": lambda: _pil_tiff("1", compression="group4"),
    "CCITT G3": lambda: _pil_tiff("1", compression="group3"),
    "CCITT RLE": lambda: _pil_tiff("1", compression="tiff_ccitt"),
    "SampleFormat 2": lambda: _pil_tiff("I"),
    "SampleFormat 3": lambda: _pil_tiff("F"),
    "CIELab": lambda: _pil_tiff("LAB"),
    "YCbCr without JPEG": lambda: _pil_tiff("YCbCr", compression="tiff_lzw"),
    "12-bit samples": lambda: tx.write_tiff(np.arange(35).reshape(5, 7, 1) * 100, 1, 8,
                                            tags={258: (3, [12])}),
}


@pytest.mark.parametrize("form", sorted(DECODED_NOW))
def test_forms_decoded_now(form):
    """The forms the port once refused, on the same files: both views
    give the libraries' arrays, or raise where they fail."""
    data = DECODED_NOW[form]()
    assert image.image_format(data) == "tiff"
    # cv2 reads 32-bit and 12-bit samples only under IMREAD_UNCHANGED, no ZSTD
    assert _check(data) == {"ZSTD": 1, "SampleFormat 2": 2, "SampleFormat 3": 2,
                            "12-bit samples": 2}.get(form, 3)


@pytest.mark.parametrize("form", sorted(NOT_DECODED))
def test_forms_not_decoded_raise_naming_them(form):
    """Where a library reads the form, its view raises UnsupportedImage
    naming it; where it does not (cv2 on old-style JPEG and ThunderScan),
    CorruptImage, as cv2 gives None."""
    data = NOT_DECODED[form]()
    assert image.image_format(data) == f"TIFF ({form})"
    assert isinstance(_pillow(data), np.ndarray)
    with pytest.raises(image.UnsupportedImage, match=form.replace("(", r"\(")):
        image.decode(data, key="root/image-000000001")
    for flags in (image.IMREAD_COLOR, image.IMREAD_UNCHANGED):
        if cv2.imdecode(np.frombuffer(data, np.uint8), flags) is None:
            with pytest.raises(image.CorruptImage):
                image.imdecode(data, flags)
        else:
            with pytest.raises(image.UnsupportedImage, match=form):
                image.imdecode(data, flags)


def test_image_format_names_tiff():
    rng = np.random.default_rng(1)
    assert image.image_format(_write(rng, FORMS["rgb8"], 3, 4)) == "tiff"
    assert image.image_format(_write(rng, FORMS["rgb8"], 3, 4, bigtiff=True)) == "tiff"
    assert image.image_format(_write(rng, FORMS["rgb8"], 3, 4, bigtiff=True,
                                     tags={259: (3, [32809])})) == "BigTIFF (ThunderScan)"
    for code, name in ((6, "old-style JPEG"), (34676, "SGILog"), (50001, "WebP")):
        assert image.image_format(_write(rng, FORMS["rgb8"], 3, 4, tags={259: (3, [code])})) == \
            f"TIFF ({name})"
    assert image.image_format(_write(rng, FORMS["rgb8"], 3, 4, tags={262: (3, [32845])})) == \
        "TIFF (LogLuv)"
    assert image.image_format(b"II*\x00\xff\xff\xff\x7f") == "tiff"   # decode raises


def test_cut_off_and_broken_files_are_corrupt(tmp_path):
    """A TIFF cut anywhere past its header fails in both libraries and
    raises CorruptImage in both views; in LmdbDataset it is JAX's dummy
    crop."""
    rng = np.random.default_rng(9)
    whole = [_pil_tiff("RGB", compression="tiff_lzw"), _pil_tiff("RGB"),
             _write(rng, FORMS["rgb8"], 23, 41, compression=DEFLATE, tile=(16, 16)),
             tx.write_tiff(rng.integers(0, 256, (23, 41, 3)), 6, 8, compression=JPEG, rows=8,
                           subsampling=(2, 2))]
    cut = [d[:n] for d in whole for n in (9, 40, len(d) // 2, len(d) - 3)]
    for data in cut:
        assert _pillow(data) is not None and not isinstance(_pillow(data), np.ndarray)
        with pytest.raises(image.CorruptImage):
            image.decode(data)
        for flags in (image.IMREAD_COLOR, image.IMREAD_UNCHANGED):
            assert cv2.imdecode(np.frombuffer(data, np.uint8), flags) is None
            with pytest.raises(image.CorruptImage):
                image.imdecode(data, flags)
    # broken fields: tiles without their size (or of a count 0), no samples,
    # RGB of one sample, a transparency mask; and tiles without their size
    # that cv2 reads as one short strip (the damaged-strip divergence below)
    gray, rgb = rng.integers(0, 256, (20, 37, 1)), rng.integers(0, 256, (20, 37, 3))
    broken = [tx.write_tiff(rgb, 2, tile=(16, 16), tags={322: (3, [])}),
              tx.write_tiff(rgb, 2, tile=(16, 16), tags={323: (3, [0])}),
              tx.write_tiff(gray, 1, tags={277: (3, [0])}),
              tx.write_tiff(gray, 2), tx.write_tiff(gray, 4)]
    strip_read = [tx.write_tiff(rgb, 2, tile=(16, 16), compression=c, tags={322: None, 323: None})
                  for c in (NONE, LZW)]
    for data in broken + strip_read:
        assert not isinstance(_pillow(data), np.ndarray)
        for flags in (image.IMREAD_COLOR, image.IMREAD_UNCHANGED):
            assert (cv2.imdecode(np.frombuffer(data, np.uint8), flags) is None) == \
                (data not in strip_read)
        for call in (image.decode, lambda d: image.imdecode(d, image.IMREAD_COLOR),
                     lambda d: image.imdecode(d, image.IMREAD_UNCHANGED)):
            with pytest.raises(image.CorruptImage):
                call(data)
    path = tmp_path / "cut.jpg"
    path.write_bytes(cut[2])
    assert image.imread(str(path)) is None
    w = lmdb_store.LmdbWriter(str(tmp_path / "cut"))
    w.put(b"num-samples", b"1")
    w.put(b"image-000000001", cut[6])
    w.put(b"label-000000001", b"ab")
    w.commit()
    opt, jopt = _opts()
    got = dataset.LmdbDataset(str(tmp_path / "cut"), opt)[0]
    ref = jax_dataset.LmdbDataset(str(tmp_path / "cut"), jopt)[0]
    assert got[1] == ref[1] == "[dummy_label]"
    assert not got[0].any() and got[0].shape == (IMG_H, IMG_W, 4)


def _typed(field, typ):
    """A TIFF whose ``field`` (ImageWidth, Photometric, RowsPerStrip or
    Orientation) is written with field type ``typ``."""
    rng = np.random.default_rng(13)
    rgb = rng.integers(0, 256, (20, 37, 3))
    value = {256: 30, 262: 2, 278: 4, 274: 6}[field]
    values = [value, 1] if typ == 5 else ([48 + value, 0] if typ == 2 else [value])
    return tx.write_tiff(rgb[:, :30] if field == 256 else rgb, 2, rows=4,
                         tags={field: (typ, values)})


FIELD_TYPES = [(274, t) for t in (2, 6, 7, 8, 9)] + \
    [(f, t) for f in (256, 262, 278) for t in (6, 8, 9)]


@pytest.mark.parametrize("field,typ", FIELD_TYPES)
def test_fields_of_other_types(field, typ):
    """Signed integer types are read as their values, ASCII and UNDEFINED
    fields are ignored, as both libraries do; an empty BitsPerSample is
    Pillow's default (1) and fails in libtiff; an empty Orientation is
    ignored."""
    _check(_typed(field, typ))
    gray = np.random.default_rng(14).integers(0, 256, (20, 37, 1))
    _check(tx.write_tiff(gray, 1, tags={258: (3, [])}))
    _check(tx.write_tiff(gray, 1, tags={274: (3, [])}))


def test_fields_of_other_types_diverge_as_recorded():
    """The field types the libraries part on, not modelled (ROADMAP.md §3):
    Pillow refuses a BYTE ImageWidth, Photometric or RowsPerStrip that
    libtiff and the port read; Pillow ignores a BYTE Orientation that
    libtiff and the port apply, and applies a RATIONAL or float one that
    libtiff and the port ignore; libtiff refuses an IFD-typed
    field and an empty Compression or RowsPerStrip that Pillow and the port
    read."""
    for field in (256, 262, 278):
        data = _typed(field, 1)
        assert not isinstance(_pillow(data), np.ndarray)
        image.decode(data)
        np.testing.assert_array_equal(image.imdecode(data), cv2.imdecode(
            np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))
    for typ in (1, 5, 11, 12):   # Orientation 6 turns 20x37 into 37x20
        data = _typed(274, typ)
        turned = (37, 20, 4) if typ == 1 else (20, 37, 4)
        assert _pillow(data).shape == turned[1::-1] + (4,)
        assert image.decode(data).shape == turned
        np.testing.assert_array_equal(image.imdecode(data), cv2.imdecode(
            np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))
    for data in [_typed(f, 13) for f in (256, 262, 278)] + \
            [tx.write_tiff(np.zeros((20, 37, 3), int), 2, tags={f: (3, [])}) for f in (259, 278)]:
        assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None
        np.testing.assert_array_equal(image.decode(data), _pillow(data))
        image.imdecode(data)


@pytest.mark.parametrize("block", range(2))
def test_fuzzed_ifds_raise_codec_errors(block):
    """The fixture crops with bytes of their IFD (or anywhere) flipped or
    replaced: each view decodes or raises CorruptImage / UnsupportedImage,
    never another exception (the IFD comes from outside the program)."""
    crops = ROOT / "tests" / "fixtures" / "torch_tiff" / "crops"
    files = [p.read_bytes() for p in sorted(crops.iterdir()) if p.suffix != ".txt"]
    rng = np.random.default_rng(70 + block)
    for _ in range(300):
        data = bytearray(files[rng.integers(len(files))])
        t = image._tiff(bytes(data), None, pillow=False)
        at = struct.unpack_from(t.order + ("Q" if t.big else "I"), data, 8 if t.big else 4)[0]
        for _ in range(rng.integers(1, 4)):
            pos = at + int(rng.integers(200)) if rng.random() < 0.8 else int(rng.integers(len(data)))
            if pos < len(data):
                data[pos] = rng.integers(256) if rng.random() < 0.5 else \
                    data[pos] ^ (1 << int(rng.integers(8)))
        data = bytes(data)
        image.image_format(data)
        for call in (image.decode, lambda d: image.imdecode(d, image.IMREAD_COLOR),
                     lambda d: image.imdecode(d, image.IMREAD_UNCHANGED)):
            try:
                call(data)
            except (image.CorruptImage, image.UnsupportedImage):
                pass


def test_damaged_strip_data_diverges_in_cv2_only():
    """A strip whose Deflate checksum is wrong: Pillow fails (the port
    raises CorruptImage, as JAX's dummy crop), while cv2's RGBA read goes on
    with what libtiff decoded; the port's cv2 view raises CorruptImage
    (imread: None) -- ROADMAP.md §3."""
    data = bytearray(_pil_tiff("RGB", compression="tiff_adobe_deflate"))
    t = image._tiff(bytes(data), None, pillow=False)
    end = t.tags[273][0] + t.tags[279][0]
    data[end - 1] ^= 0xFF       # the Adler-32 trailer
    data = bytes(data)
    assert _pillow(data) is OSError
    assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is not None
    for call in (image.decode, image.imdecode):
        with pytest.raises(image.CorruptImage):
            call(data)


# -------------------------------------------------------------- datasets
def _opts():
    common = dict(il="mrn", batch_size=4, imgH=IMG_H, imgW=IMG_W, manual_seed=111,
                  batch_max_length=8, lan_list=["T0"])
    return default_options(**common), jax_options(**common)


def _normed(batch):
    return ((torch.as_tensor(batch).float() / 255.0 - 0.5) / 0.5).numpy()


def test_lmdb_dataset_over_tiff_crops_matches_jax(tmp_path):
    """LmdbDataset over TIFF crops (LZW RGB, YCbCr JPEG, 16-bit gray,
    palette, associated alpha, tiles, Orientation 6) gives JAX's labels and
    ResizeNormalize tensors bytewise."""
    rng = np.random.default_rng(10)
    crops = [_pil_tiff("RGB", compression="tiff_lzw"),
             tx.write_tiff(rng.integers(0, 256, (29, 83, 3)), 6, 8, compression=JPEG, rows=16,
                           subsampling=(2, 2)),
             _write(rng, FORMS["gray16"], 25, 60, compression=ADOBE, predictor=2),
             _write(rng, FORMS["palette4"], 30, 70, compression=PACKBITS),
             _write(rng, FORMS["rgba8 associated"], 31, 57, compression=LZMA, tile=(16, 16)),
             _write(rng, FORMS["rgb8"], 70, 26, compression=LZW, tags={274: (3, [6])})]
    w = lmdb_store.LmdbWriter(str(tmp_path / "tiff"))
    w.put(b"num-samples", str(len(crops)).encode())
    for i, data in enumerate(crops, 1):
        w.put(b"image-%09d" % i, data)
        w.put(b"label-%09d" % i, b"abc")
    w.commit()
    opt, jopt = _opts()
    to_jax = JaxResizeNormalize((IMG_W, IMG_H))
    got = dataset.LmdbDataset(str(tmp_path / "tiff"), opt)
    ref = jax_dataset.LmdbDataset(str(tmp_path / "tiff"), jopt)
    assert len(got) == len(ref) == len(crops)
    for i in range(len(ref)):
        (g, gl), (r, rl) = got[i], ref[i]
        assert gl == rl == "abc"
        assert _normed(ResizeNormalize((IMG_W, IMG_H))(g)[None]).tobytes() == \
            to_jax(r)[None].astype(np.float32).tobytes()
