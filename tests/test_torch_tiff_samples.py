"""The port's TIFF samples beyond 1-16-bit unsigned integers, and the
photometrics libtiff converts itself, against Pillow 12.1 and cv2 5.0
(both over libtiff 4.7):

- SampleFormat 2 (signed) and 3 (IEEE float), 10- to 64-bit samples, the
  horizontal predictor at 32 and 64 bits and the floating-point predictor:
  Pillow's modes (``L``, ``I;16``, ``I``, ``F``: its clip and truncation,
  NaN to 0, the big-endian words libtiff hands it in native order), cv2's
  depths under ``IMREAD_UNCHANGED`` (int8 to float64, 10-14 bits shifted
  to 16) and its None under ``IMREAD_COLOR``;
- YCbCr without JPEG, subsampled 1, 2 or 4 each way: libtiff's RGBA image
  (TIFFYCbCrToRGB's tables from YCbCrCoefficients and
  ReferenceBlackWhite, the short strip reads of 4 x 4 blocks, the askew
  reads of cut 4 x 4 tiles) in both views, Pillow's raw "RGBX" reads of
  uncompressed YCbCr;
- CIELab: cv2's view through libtiff's TIFFCIELabToXYZ / TIFFXYZToRGB (8
  and 16 bits, any WhitePoint), Pillow's through LittleCMS's transform
  (its float pipeline sampled on a 33-point grid), both bit for bit;
- palettes of more than 8 bits, which neither library reads.

``LmdbDataset`` over crops in these forms gives JAX's items and
``ResizeNormalize`` tensors; ``create_lmdb``'s check keeps what JAX's does.
"""

import importlib.util
import io
import warnings
from pathlib import Path

import cv2
import numpy as np
import PIL.Image
import pytest

from mrn_tpu.data import dataset as jax_dataset
from mrn_tpu.data.transform import ResizeNormalize as JaxResizeNormalize
from mrn_tpu.tools.create_lmdb import check_image_valid as jax_check_image_valid
from mrn_tpu_torch.data import dataset, image, lmdb_store
from mrn_tpu_torch.data.transform import ResizeNormalize
from mrn_tpu_torch.tools.create_lmdb import check_image_valid

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("torch_tiff_cases",
                                               ROOT / "tests" / "test_torch_tiff.py")
tt = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tt)
tx = tt.tx

# (bits, sample format)
SAMPLES = [(8, 2), (10, 1), (12, 1), (14, 1), (16, 2), (16, 3), (24, 1), (32, 1), (32, 2),
           (32, 3), (64, 1), (64, 2), (64, 3)]
FLOAT_EDGES = np.array([0.0, -0.0, 0.5, 0.99999, 1.0, 254.6, 254.9999, 255.0, 255.5, 300.0, -0.5,
                        -1.0, 1e30, -1e30, np.inf, -np.inf, np.nan, 127.5, 1e-40, 2.5])
INT_EDGES = [0, -1, 1, 5, 200, 255, 256, 300, -300, 32767, -32768, 2 ** 31 - 1, -2 ** 31,
             2 ** 32 - 1, 70000]


def _values(rng, bps, sf, shape):
    """Samples of the form: its edge values among random ones."""
    if sf == 3:
        v = rng.normal(100, 200, shape)
        v.reshape(-1)[:len(FLOAT_EDGES)] = FLOAT_EDGES[:v.size]
        return tx.as_bits(v, bps, sf)
    lo, hi = (-(1 << (bps - 1)), (1 << (bps - 1)) - 1) if sf == 2 else (0, (1 << bps) - 1)
    v = rng.integers(max(lo, -2 ** 62), min(hi, 2 ** 62), shape).astype(object)
    edges = [e for e in INT_EDGES if lo <= e <= hi]
    v.reshape(-1)[:len(edges)] = edges[:v.size]
    return tx.as_bits(v, bps, sf) if sf == 2 else np.array(v.tolist(), np.uint64)


@pytest.mark.parametrize("form", SAMPLES, ids=[f"{b}-bit sf{s}" for b, s in SAMPLES])
def test_sample_formats(form):
    """Gray (MinIsBlack and MinIsWhite), RGB and RGBA in every codec the
    predictor runs with, strips and tiles, both byte orders: Pillow reads
    what OPEN_INFO names, cv2 what its depths hold."""
    bps, sf = form
    rng = np.random.default_rng(bps * 10 + sf)
    decoded = 0
    for photo, spp, extra in ((1, 1, ()), (0, 1, ()), (2, 3, ()), (2, 4, (2,))):
        for order in "<>":
            for kw in (dict(rows=3), dict(compression=tx.LZW, tile=(16, 16)),
                       dict(compression=tx.ADOBE_DEFLATE, predictor=3 if sf == 3 else 2)):
                data = tx.write_tiff(_values(rng, bps, sf, (11, 19, spp)), photo, bps,
                                     extra=extra, sample_format=sf, order=order, **kw)
                decoded += tt._check(data, allow_misread=True)
    assert decoded > 0 if (bps, sf) not in ((24, 1), (16, 3)) else decoded == 0


SAMPLE_FORMAT_FIELDS = [(), (1,), (1, 1), (1, 1, 1), (1, 1, 3), (3, 1, 1), (1, 1, 1, 1), (2,),
                        (2, 2), (2, 2, 2), (3, 3, 3)]


@pytest.mark.parametrize("field", SAMPLE_FORMAT_FIELDS, ids=str)
def test_sample_format_field_counts(field):
    """A SampleFormat of any count: libtiff takes one value, or one a
    sample all alike, and refuses the directory otherwise (cv2's None,
    Pillow's failure where libtiff decodes); Pillow's own reader drops an
    empty field and looks the rest up in its mode table."""
    rng = np.random.default_rng(len(field))
    for spp, photo in ((3, 2), (1, 1)):
        for compression in (tx.NONE, tx.LZW):
            tt._check(tx.write_tiff(rng.integers(0, 200, (5, 7, spp)), photo,
                                    compression=compression, tags={339: (3, list(field))}))


def test_pillow_rules_for_signed_and_float():
    """Pillow's I clips to 0..255, its F truncates (0.5 -> 0, 254.6 -> 254,
    300 -> 255) with NaN and -inf to 0; a big-endian file through libtiff
    reaches Pillow in native words that "I;16BS" / "F;32BF" read swapped,
    while the uncompressed one (Pillow's own unpacker) reads right."""
    f = np.array([[0.0, 0.5, 254.6, 300.0, -1.0, np.nan, np.inf, -np.inf, -0.0, 1.0]])
    data = tx.write_tiff(tx.as_bits(f, 32, 3), 1, 32, sample_format=3)
    np.testing.assert_array_equal(image.decode(data)[0, :, 0],
                                  [0, 0, 254, 255, 0, 0, 255, 0, 0, 1])
    v = np.array([[0, -1, 5, 200, 300, -300]])
    for bps in (16, 32):
        raw = tx.write_tiff(tx.as_bits(v, bps, 2), 1, bps, sample_format=2, order=">")
        np.testing.assert_array_equal(image.decode(raw)[0, :, 0], [0, 0, 5, 200, 255, 0])
        lzw = tx.write_tiff(tx.as_bits(v, bps, 2), 1, bps, sample_format=2, order=">",
                            compression=tx.LZW)
        np.testing.assert_array_equal(image.decode(lzw), tt._pillow(lzw))
        assert image.decode(lzw)[0, 2, 0] == 255   # 0x0500 (1280) in place of 5
        for data in (raw, lzw):   # cv2 reads 16 bits through its RGBA image too
            assert tt._check(data) == (3 if bps == 16 else 2)


def test_cv2_depths_under_imread_unchanged():
    """int8 / int16 / int32 / int64, uint32 / uint64, float32 / float64 as
    stored; 10-, 12- and 14-bit samples shifted up to 16 bits; signed 8-bit
    through libtiff's RGBA image as int8; none of them but 8 and 16 bits
    under IMREAD_COLOR."""
    rng = np.random.default_rng(3)
    for (bps, sf), dtype in (((8, 2), np.int8), ((16, 2), np.int16), ((32, 2), np.int32),
                             ((64, 2), np.int64), ((32, 1), np.uint32), ((64, 1), np.uint64),
                             ((32, 3), np.float32), ((64, 3), np.float64),
                             ((10, 1), np.uint16), ((12, 1), np.uint16), ((14, 1), np.uint16)):
        data = tx.write_tiff(_values(rng, bps, sf, (5, 7, 1)), 1, bps, sample_format=sf,
                             compression=tx.LZW)
        got = image.imdecode(data, image.IMREAD_UNCHANGED)
        assert got.dtype == dtype and got.shape == (5, 7)
        if bps in (10, 12, 14):
            assert not (got.astype(np.uint32) % (1 << (16 - bps))).any()
        if bps > 16 or bps in (10, 12, 14):
            assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None
            with pytest.raises(image.CorruptImage):
                image.imdecode(data, image.IMREAD_COLOR)
        tt._check(data)


def test_predictors_at_32_and_64_bits():
    """The horizontal predictor on 32- and 64-bit words and the floating-
    point predictor's byte planes, in strips, tiles and planes; libtiff
    runs a predictor only with LZW, Deflate, LZMA and ZSTD, so PackBits
    ignores the field."""
    rng = np.random.default_rng(4)
    for bps, sf, pred in ((32, 1, 2), (32, 2, 2), (64, 2, 2), (32, 3, 3), (64, 3, 3)):
        for compression in (tx.LZW, tx.DEFLATE, tx.LZMA, tx.PACKBITS):
            for kw in (dict(rows=4), dict(tile=(16, 32)), dict(planar=2, rows=5)):
                spp = 3 if kw.get("planar") else 1
                data = tx.write_tiff(_values(rng, bps, sf, (9, 21, spp)), 2 if spp == 3 else 1,
                                     bps, sample_format=sf, predictor=pred,
                                     compression=compression, **kw)
                tt._check(data, allow_misread=True)
    bad = tx.write_tiff(np.arange(12).reshape(3, 4), 1, 16, predictor=3, compression=tx.LZW)
    assert tt._pillow(bad) is OSError
    with pytest.raises(image.CorruptImage):
        image.decode(bad)
    tt._check(bad)


def test_samples_sweep():
    """A seeded sweep of 120 files: forms, edge values, codecs, predictors,
    layouts, orientations."""
    rng = np.random.default_rng(5)
    decoded = 0
    for _ in range(120):
        bps, sf = SAMPLES[rng.integers(len(SAMPLES))]
        photo, spp, extra = [(1, 1, ()), (0, 1, ()), (2, 3, ()), (2, 4, (1,))][rng.integers(4)]
        h, w = [(1, 1), (1, 9), (7, 1), (5, 6), (17, 23)][rng.integers(5)]
        kw = dict(order="<>"[rng.integers(2)], bigtiff=bool(rng.random() < 0.2),
                  compression=[tx.NONE, tx.LZW, tx.ADOBE_DEFLATE, tx.PACKBITS,
                               tx.LZMA][rng.integers(5)])
        if kw["compression"] != tx.NONE and rng.random() < 0.4:
            kw["predictor"] = 3 if sf == 3 else 2
        r = rng.random()
        if r < 0.2:
            kw["tile"] = (16, 16)
        elif r < 0.5:
            kw["rows"] = int(rng.integers(1, 5))
        if rng.random() < 0.2:
            kw["planar"] = 2
        if rng.random() < 0.15:
            kw["tags"] = {274: (3, [int(rng.integers(1, 9))])}
        data = tx.write_tiff(_values(rng, bps, sf, (h, w, spp)), photo, bps, extra=extra,
                             sample_format=sf, **kw)
        decoded += tt._check(data, allow_misread=True)
    assert decoded > 80


# ------------------------------------------------------------------ YCbCr
SUBSAMPLINGS = [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)]


def _ycbcr(rng, h, w, ss, **kw):
    s = rng.integers(0, 256, (h, w, 3))
    s[:, :, 1:] = rng.integers(60, 196, (h, w, 2))
    return tx.write_tiff(s, 6, subsampling=ss, **kw)


@pytest.mark.parametrize("ss", SUBSAMPLINGS, ids=[f"{a}x{b}" for a, b in SUBSAMPLINGS])
def test_ycbcr_without_jpeg(ss):
    """Every subsampling libtiff's RGBA image has a routine for, in every
    codec, strips of whole blocks and tiles cut by both edges (4 x 4's
    ``fromskew`` of 10 bytes a block), images of odd sizes (4 x 4's short
    strip reads): libtiff's RGB in both views; uncompressed, Pillow's raw
    "RGBX" bytes."""
    rng = np.random.default_rng(ss[0] * 10 + ss[1])
    decoded = 0
    for compression in (tx.NONE, tx.LZW, tx.ADOBE_DEFLATE, tx.PACKBITS, tx.LZMA):
        for h, w, kw in ((1, 1, {}), (9, 13, dict(rows=ss[1] * 2)), (17, 23, {}),
                         (21, 37, dict(tile=(16, 16), order=">"))):
            if compression == tx.NONE and "tile" in kw:
                continue   # Pillow's raw reads of tiles: ROADMAP.md §3
            decoded += tt._check(_ycbcr(rng, h, w, ss, compression=compression, **kw))
    # cv2 has no LZMA; Pillow's raw read fails where the file ends before
    # four bytes a pixel
    assert decoded >= 3 * 4 * 3 + 4 + 3 * 2


@pytest.mark.parametrize("block", range(3))
def test_ycbcr_sweep(block):
    """40 files a block: subsamplings, codecs, strips and tiles, sizes,
    byte orders, BigTIFF, orientations, coefficients and reference
    ranges."""
    rng = np.random.default_rng(50 + block)
    decoded = 0
    for _ in range(40):
        ss = SUBSAMPLINGS[rng.integers(len(SUBSAMPLINGS))]
        h, w = [(1, 1), (1, 11), (9, 1), (6, 7), (17, 23), (33, 41)][rng.integers(6)]
        kw = dict(order="<>"[rng.integers(2)], bigtiff=bool(rng.random() < 0.2),
                  compression=[tx.LZW, tx.ADOBE_DEFLATE, tx.PACKBITS, tx.LZMA,
                               tx.NONE][rng.integers(5)])
        if rng.random() < 0.35 and kw["compression"] != tx.NONE:
            kw["tile"] = [(16, 16), (32, 16)][rng.integers(2)]
        elif rng.random() < 0.5:
            kw["rows"] = ss[1] * int(rng.integers(1, 4))
        tags = {}
        if rng.random() < 0.3:
            tags[274] = (3, [int(rng.integers(1, 9))])
        if rng.random() < 0.3:
            tags[529] = (5, [int(rng.integers(200, 350)), 1000, int(rng.integers(500, 650)), 1000,
                             int(rng.integers(60, 150)), 1000])
        if rng.random() < 0.3:
            tags[532] = (5, [v for x in (0, 255, 128, 255, 128, 255)
                             for v in (max(0, x + int(rng.integers(-30, 30))), 1)])
        decoded += tt._check(_ycbcr(rng, h, w, ss, tags=tags, **kw))
    assert decoded >= 60


def test_ycbcr_fields():
    """YCbCrCoefficients and ReferenceBlackWhite as RATIONALs (libtiff's
    float num / den) through TIFFYCbCrToRGB's float and fixed-point tables,
    with the Orientation."""
    rng = np.random.default_rng(6)
    for k in range(24):
        luma = [int(v) for pair in ((rng.integers(100, 500), 1000), (rng.integers(400, 700), 1000),
                                    (rng.integers(50, 200), 1000)) for v in pair]
        ref = [max(0, v + int(rng.integers(-40, 40))) for v in (0, 255, 128, 255, 128, 255)]
        tags = {529: (5, luma), 532: (5, [v for x in ref for v in (x * 3 + k % 3, 3)]),
                274: (3, [k % 8 + 1])}
        ss = SUBSAMPLINGS[k % len(SUBSAMPLINGS)]
        assert tt._check(_ycbcr(rng, 12, 20, ss, compression=tx.LZW, tags=tags)) == 3


def test_ycbcr_written_by_pillow():
    rng = np.random.default_rng(7)
    for compression in (None, "tiff_lzw", "tiff_adobe_deflate", "packbits", "lzma", "zstd"):
        for h, w in ((1, 1), (9, 13), (40, 33)):
            rgb = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            buf = io.BytesIO()
            PIL.Image.fromarray(rgb).convert("YCbCr").save(buf, "TIFF", compression=compression)
            tt._check(buf.getvalue())


def test_ycbcr_forms_libtiff_refuses():
    """Subsamplings without a routine (1 x 4, 2 x 4, 3 x 1), 16 bits, one
    sample, planes subsampled: cv2 gives None and Pillow fails where it
    goes through libtiff; uncompressed, Pillow's raw reader reads on."""
    rng = np.random.default_rng(8)
    s = rng.integers(0, 256, (9, 13, 3))
    for data in (_ycbcr(rng, 9, 13, (1, 4), compression=tx.LZW),
                 _ycbcr(rng, 9, 13, (2, 4), compression=tx.NONE),
                 tx.write_tiff(s, 6, compression=tx.LZW, tags={530: (3, [3, 1])}),
                 tx.write_tiff(s * 200, 6, 16, compression=tx.LZW),
                 tx.write_tiff(s[:, :, :1], 6, compression=tx.LZW),
                 tx.write_tiff(s, 6, compression=tx.LZW, planar=2, tags={530: (3, [2, 2])})):
        assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None
        tt._check(data)


def test_damaged_ycbcr_strip_diverges_in_both_views():
    """Pillow reads compressed YCbCr through libtiff's RGBA image, which
    reads on past a strip it fails to decode, as cv2's does; the port
    raises ``CorruptImage`` in both views (ROADMAP.md §3)."""
    data = bytearray(_ycbcr(np.random.default_rng(15), 32, 40, (2, 2), compression=tx.LZW,
                            rows=8))
    data[image._tiff(bytes(data), None, pillow=False).tags[273][1]] ^= 0x5A
    data = bytes(data)
    assert isinstance(tt._pillow(data), np.ndarray)
    assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is not None
    for view in (image.decode, lambda b: image.imdecode(b, image.IMREAD_COLOR)):
        with pytest.raises(image.CorruptImage):
            view(data)


def test_uncompressed_tiled_or_planar_ycbcr_raises_in_pillows_view():
    """Pillow's raw reader takes tiles and planes of uncompressed YCbCr for
    "RGBX" pixels it does not lay out as the file does: the port raises
    ``UnsupportedImage`` naming the form in that view (ROADMAP.md §3); cv2's
    view is libtiff's."""
    rng = np.random.default_rng(14)
    for data in (_ycbcr(rng, 21, 37, (2, 2), tile=(16, 16)),
                 _ycbcr(rng, 21, 37, (1, 1), tile=(16, 16), order=">"),
                 tx.write_tiff(rng.integers(0, 256, (9, 13, 3)), 6, planar=2)):
        with pytest.raises(image.UnsupportedImage, match="uncompressed tiled or planar YCbCr"):
            image.decode(data)
        for flags in (image.IMREAD_COLOR, image.IMREAD_UNCHANGED):
            want = cv2.imdecode(np.frombuffer(data, np.uint8), flags)
            if want is None:
                with pytest.raises(image.CorruptImage):
                    image.imdecode(data, flags)
            else:
                np.testing.assert_array_equal(image.imdecode(data, flags), want)


# ----------------------------------------------------------------- CIELab
def _lab(rng, h, w):
    s = rng.integers(0, 256, (h, w, 3))
    s[:, :, 0] = np.linspace(0, 255, w)[None, :].astype(int)
    return s


def test_cielab_cv2_view_is_libtiffs():
    """libtiff's CIELab routines: 8 and 16 bits, the default D50 white
    point and others, strips and tiles, both byte orders."""
    rng = np.random.default_rng(9)
    for kw in (dict(compression=tx.LZW), dict(rows=2),
               dict(tile=(16, 16), order=">", compression=tx.LZW),
               dict(compression=tx.ADOBE_DEFLATE, tags={318: (5, [3127, 10000, 3290, 10000])}),
               dict(compression=tx.PACKBITS, tags={318: (5, [1, 3, 1, 3])})):
        for bps in (8, 16):
            s = _lab(rng, 13, 37) * (257 if bps == 16 else 1)
            data = tx.write_tiff(s, 8, bps, **kw)
            for flags in (image.IMREAD_COLOR, image.IMREAD_UNCHANGED):
                want = cv2.imdecode(np.frombuffer(data, np.uint8), flags)
                got = image.imdecode(data, flags)
                assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("block", range(3))
def test_cielab_sweep(block):
    """40 files a block, both views: 8 and 16 bits, codecs, strips and
    tiles, planes, byte orders, BigTIFF, WhitePoints, orientations."""
    rng = np.random.default_rng(60 + block)
    for _ in range(40):
        bps = [8, 16][rng.integers(2)]
        h, w = [(1, 1), (1, 13), (11, 1), (9, 17), (23, 31)][rng.integers(5)]
        s = rng.integers(0, 256, (h, w, 3)) * (257 if bps == 16 else 1)
        if bps == 16:
            s += rng.integers(0, 257, s.shape)
        kw = dict(order="<>"[rng.integers(2)], bigtiff=bool(rng.random() < 0.2),
                  compression=[tx.LZW, tx.ADOBE_DEFLATE, tx.PACKBITS, tx.NONE][rng.integers(4)])
        if rng.random() < 0.3 and kw["compression"] != tx.NONE:
            kw["tile"] = (16, 16)
        elif rng.random() < 0.5:
            kw["rows"] = int(rng.integers(1, 5))
        tags = {}
        if rng.random() < 0.3:
            tags[318] = (5, [int(rng.integers(2500, 4000)), 10000, int(rng.integers(2500, 4000)),
                             10000])
        if rng.random() < 0.2:
            tags[274] = (3, [int(rng.integers(1, 9))])
        if rng.random() < 0.2:   # Pillow reads the planes as "L" bands; cv2 refuses them
            kw["planar"] = 2
        tt._check(tx.write_tiff(s, 8, bps, tags=tags, **kw))


def test_cielab_pillow_view_is_littlecms():
    """Pillow converts its LAB mode through LittleCMS (a 33-point grid of
    its float pipeline, tetrahedral interpolation in fixed point): every L
    against a stride-6 grid of a and b, and Pillow's own writer."""
    lum, a, b = np.meshgrid(np.arange(256), np.arange(0, 256, 6), np.arange(0, 256, 6),
                            indexing="ij")
    s = np.stack([lum.ravel(), a.ravel(), b.ravel()], 1).reshape(256, -1, 3)
    data = tx.write_tiff(s, 8)
    np.testing.assert_array_equal(image.decode(data), tt._pillow(data))
    buf = io.BytesIO()   # Pillow's own writer
    PIL.Image.fromarray(np.random.default_rng(10).integers(0, 256, (20, 30, 3)).astype(np.uint8)
                        ).convert("LAB").save(buf, "TIFF", compression="tiff_lzw")
    assert tt._check(buf.getvalue()) == 3


def test_cielab_forms_neither_library_reads():
    """ICCLab and ITULab (photometric 9 and 10), CIELab with alpha, gray
    CIELab, planar CIELab in cv2."""
    rng = np.random.default_rng(11)
    s = _lab(rng, 9, 13)
    for data in (tx.write_tiff(s, 9, compression=tx.LZW), tx.write_tiff(s, 10),
                 tx.write_tiff(np.dstack([s, s[:, :, :1]]), 8, extra=(2,)),
                 tx.write_tiff(s[:, :, :1], 8), tx.write_tiff(s, 8, planar=2, compression=tx.LZW)):
        assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None
        for flags in (image.IMREAD_COLOR, image.IMREAD_UNCHANGED):
            with pytest.raises(image.CorruptImage):
                image.imdecode(data, flags)
        if not isinstance(tt._pillow(data), np.ndarray):
            with pytest.raises(image.CorruptImage):
                image.decode(data)


def test_sixteen_bit_palettes_are_read_by_neither():
    rng = np.random.default_rng(12)
    for bps in (12, 16):
        cmap = rng.integers(0, 65536, (1 << bps, 3))
        data = tx.write_tiff(rng.integers(0, 1 << bps, (6, 9)), 3, bps, colormap=cmap,
                             compression=tx.LZW)
        assert not isinstance(tt._pillow(data), np.ndarray)
        assert tt._check(data) == 0


# -------------------------------------------------------------- datasets
def test_lmdb_dataset_and_create_lmdb_over_sample_crops_match_jax(tmp_path):
    """LmdbDataset over signed, float, 12- and 32-bit, predictor-3, YCbCr
    and CIELab crops gives JAX's labels and ResizeNormalize tensors
    bytewise; ``create_lmdb``'s check keeps
    what JAX's keeps."""
    rng = np.random.default_rng(13)
    crops = [tx.write_tiff(_values(rng, 16, 2, (28, 70, 1)), 1, 16, sample_format=2),
             tx.write_tiff(_values(rng, 32, 3, (28, 70, 1)), 1, 32, sample_format=3,
                           compression=tx.ADOBE_DEFLATE, predictor=3),
             tx.write_tiff(_values(rng, 32, 1, (26, 60, 1)) % 300, 1, 32, compression=tx.LZW),
             tx.write_tiff(_values(rng, 12, 1, (25, 66, 1)), 1, 12, compression=tx.PACKBITS),
             tx.write_tiff(_values(rng, 8, 2, (30, 64, 1)), 1, 8, sample_format=2),
             _ycbcr(rng, 31, 77, (2, 2), compression=tx.LZW),
             _ycbcr(rng, 28, 61, (4, 4), compression=tx.ADOBE_DEFLATE, tile=(32, 16)),
             _ycbcr(rng, 29, 70, (2, 1), compression=tx.NONE),
             tx.write_tiff(_lab(rng, 30, 72), 8, compression=tx.LZW)]
    w = lmdb_store.LmdbWriter(str(tmp_path / "samples"))
    w.put(b"num-samples", str(len(crops)).encode())
    for i, data in enumerate(crops, 1):
        w.put(b"image-%09d" % i, data)
        w.put(b"label-%09d" % i, b"abc")
    w.commit()
    opt, jopt = tt._opts()
    to_jax = JaxResizeNormalize((tt.IMG_W, tt.IMG_H))
    got = dataset.LmdbDataset(str(tmp_path / "samples"), opt)
    ref = jax_dataset.LmdbDataset(str(tmp_path / "samples"), jopt)
    assert len(got) == len(ref) == len(crops)
    for i in range(len(ref)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            (g, gl), (r, rl) = got[i], ref[i]
        # Pillow fails on the uncompressed YCbCr crop: JAX's dummy crop
        assert gl == rl == ("[dummy_label]" if i == 7 else "abc")
        assert tt._normed(ResizeNormalize((tt.IMG_W, tt.IMG_H))(g)[None]).tobytes() == \
            to_jax(r)[None].astype(np.float32).tobytes()
    assert [check_image_valid(d) for d in crops] == [jax_check_image_valid(d) for d in crops]
