"""The codec names every format Pillow 12.1 or cv2 5.0 identifies, so that
no crop a library reads becomes a silent dummy crop in the port:

- one file per format each library writes here, from a seeded numpy
  image: where the library reads it back, the port's view of that library
  decodes it bit for bit or raises ``UnsupportedImage`` naming the format,
  never ``CorruptImage`` (which ``LmdbDataset`` and ``RawDataset`` turn
  into a dummy crop, and ``imread`` into None); where the library does not
  read it, the port raises ``CorruptImage`` as well (EPS, which Pillow
  reads only through Ghostscript, raises ``UnsupportedImage``);
- random and cut-off non-image bytes stay ``CorruptImage`` and a dummy
  crop, as in JAX's ``LmdbDataset``;
- a cut-off file of a format the port does not decode raises
  ``UnsupportedImage`` (ROADMAP.md §3's divergences).
"""

import functools
import io
import warnings

import cv2
import numpy as np
import PIL.Image
import pytest

from mrn_tpu.config import default_options as jax_options
from mrn_tpu.data import dataset as jax_dataset
from mrn_tpu_torch.config import default_options
from mrn_tpu_torch.data import dataset, image, lmdb_store

_RNG = np.random.default_rng(2121)
RGB = _RNG.integers(0, 256, (40, 48, 3), dtype=np.uint8)
GRAY = np.ascontiguousarray(RGB[:, :, 1])


def _pil(fmt, im, **kw):
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def _cv(ext, array):
    ok, data = cv2.imencode(ext, array)
    assert ok, ext
    return data.tobytes()


def _writers():
    """{case: (a writer of the file's bytes, the name image_format gives)};
    the files are written when a test asks for them."""
    rgb, gray = PIL.Image.fromarray(RGB), PIL.Image.fromarray(GRAY)
    bits = lambda: gray.point(lambda v: 255 * (v > 128)).convert("1")  # noqa: E731
    floats = lambda: PIL.Image.fromarray(GRAY.astype(np.float32) / 3)  # noqa: E731
    pillow = {
        "BMP": (lambda: _pil("BMP", rgb), "bmp"),
        "DIB": (lambda: _pil("DIB", rgb), "DIB"),
        "GIF": (lambda: _pil("GIF", rgb), "gif"),
        "ICNS": (lambda: _pil("ICNS", rgb), "ICNS"),
        "ICO": (lambda: _pil("ICO", rgb), "ICO"),
        "IM": (lambda: _pil("IM", rgb), "IM"),
        "JPEG": (lambda: _pil("JPEG", rgb), "jpeg"),
        "MPO": (lambda: _pil("MPO", rgb), "jpeg"),
        "JPEG 2000": (lambda: _pil("JPEG2000", rgb), "JPEG 2000"),
        "J2K codestream": (lambda: _pil("JPEG2000", rgb, no_jp2=True), "JPEG 2000"),
        "MSP": (lambda: _pil("MSP", bits()), "MSP"),
        "PCX": (lambda: _pil("PCX", rgb), "PCX"),
        "PCX gray": (lambda: _pil("PCX", gray), "PCX"),
        "PNG": (lambda: _pil("PNG", rgb), "png"),
        "PPM": (lambda: _pil("PPM", rgb), "PPM"),
        "PGM": (lambda: _pil("PPM", gray), "PGM"),
        "PBM": (lambda: _pil("PPM", bits()), "PBM"),
        "PFM": (lambda: _pil("PPM", floats()), "PFM"),
        "SGI": (lambda: _pil("SGI", rgb), "SGI"),
        "SGI gray": (lambda: _pil("SGI", gray), "SGI"),
        "SPIDER": (lambda: _pil("SPIDER", floats()), "SPIDER"),
        "TGA": (lambda: _pil("TGA", rgb), "TGA"),
        "TGA gray RLE": (lambda: _pil("TGA", gray, compression="tga_rle"), "TGA"),
        "TIFF": (lambda: _pil("TIFF", rgb), "tiff"),
        "WebP": (lambda: _pil("WEBP", rgb), "webp"),
        "XBM": (lambda: _pil("XBM", bits()), "XBM"),
        "AVIF": (lambda: _pil("AVIF", rgb), "AVIF"),
        "DDS": (lambda: _pil("DDS", rgb), "DDS"),
        "QOI": (lambda: _pil("QOI", rgb), "QOI"),
        "EPS": (lambda: _pil("EPS", rgb), "EPS"),
    }
    files = {f"Pillow {k}": v for k, v in pillow.items()}
    bgr = np.ascontiguousarray(RGB[:, :, ::-1])
    for ext, array, name in ((".bmp", bgr, "bmp"), (".jpg", bgr, "jpeg"), (".png", bgr, "png"),
                             (".webp", bgr, "webp"), (".avif", bgr, "AVIF"),
                             (".jp2", bgr, "JPEG 2000"), (".pbm", GRAY, "PBM"),
                             (".pgm", GRAY, "PGM"), (".ppm", bgr, "PPM"), (".pam", bgr, "PAM"),
                             (".pfm", bgr.astype(np.float32) / 255, "color PFM"),
                             (".pfm", GRAY.astype(np.float32) / 255, "PFM"),
                             (".sr", bgr, "Sun raster"), (".tiff", bgr, "tiff"),
                             (".hdr", bgr.astype(np.float32) / 255, "Radiance HDR"),
                             (".gif", bgr, "gif")):
        files[f"cv2 {ext} {array.ndim}d {array.dtype}"] = (
            lambda ext=ext, array=array: _cv(ext, array), name)
    return files


WRITERS = _writers()


@functools.lru_cache(maxsize=None)
def _written(case):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return WRITERS[case][0]()


def _pillow_reads(data):
    try:
        return np.asarray(PIL.Image.open(io.BytesIO(data)).convert("RGBA"))
    except OSError:
        return None


@pytest.mark.parametrize("case", sorted(WRITERS))
def test_every_written_format_is_decoded_or_named(case):
    data, name = _written(case), WRITERS[case][1]
    assert image.image_format(data) == name
    named = name if name != name.lower() else "the image"
    ref = _pillow_reads(data)
    if ref is None and name != "EPS":
        with pytest.raises(image.CorruptImage):
            image.decode(data)
    else:
        try:
            np.testing.assert_array_equal(image.decode(data), ref)
        except image.UnsupportedImage as e:
            assert named in str(e)
    for flags in (image.IMREAD_COLOR, image.IMREAD_UNCHANGED):
        want = cv2.imdecode(np.frombuffer(data, np.uint8), flags)
        if want is None:
            with pytest.raises(image.CorruptImage):
                image.imdecode(data, flags)
            continue
        try:
            got = image.imdecode(data, flags)
        except image.UnsupportedImage as e:
            assert named in str(e)
            continue
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_both_libraries_read_most_of_them():
    """The cases above are files the libraries read (so the parametrised
    test's CorruptImage branch is the exception)."""
    files = [_written(case) for case in WRITERS]
    pillow = sum(_pillow_reads(d) is not None for d in files)
    cv = sum(cv2.imdecode(np.frombuffer(d, np.uint8), cv2.IMREAD_UNCHANGED) is not None
             for d in files)
    assert pillow >= len(files) - 6 and cv >= 20


def test_random_and_cut_off_bytes_stay_corrupt(tmp_path):
    rng = np.random.default_rng(7)
    junk = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
            for n in rng.integers(0, 3000, 300)]
    text = b"a plain text file\nwith lines: and colons\n" * 20
    junk += [text[:n] for n in (0, 1, 10, 100, len(text))]
    for data in junk:
        assert _pillow_reads(data) is None
        assert not data or cv2.imdecode(np.frombuffer(data, np.uint8),
                                        cv2.IMREAD_UNCHANGED) is None
        assert image.image_format(data) == "unknown"
        with pytest.raises(image.CorruptImage, match="cannot identify"):
            image.decode(data)
        with pytest.raises(image.CorruptImage):
            image.imdecode(data)
    path = tmp_path / "junk.jpg"
    path.write_bytes(junk[0])
    assert image.imread(str(path)) is None
    w = lmdb_store.LmdbWriter(str(tmp_path / "junk"))
    w.put(b"num-samples", b"3")
    for i, data in enumerate(junk[:3], 1):
        w.put(b"image-%09d" % i, data)
        w.put(b"label-%09d" % i, b"ab")
    w.commit()
    common = dict(imgH=32, imgW=64, batch_max_length=8)
    got = dataset.LmdbDataset(str(tmp_path / "junk"), default_options(**common))
    ref = jax_dataset.LmdbDataset(str(tmp_path / "junk"), jax_options(**common))
    for i in range(3):
        assert got[i][1] == ref[i][1] == "[dummy_label]"
        assert not got[i][0].any()


def test_cut_off_file_of_a_form_not_decoded_raises_unsupported():
    """Pillow fails on it (JAX's dummy crop); the port names the form and
    stops, as for the whole file.  (A cut-off TIFF, decoded now, is
    ``CorruptImage`` and a dummy crop: ``tests/test_torch_tiff.py``.)"""
    data = _written("Pillow JPEG 2000")[:300]
    assert _pillow_reads(data) is None
    with pytest.raises(image.UnsupportedImage, match="JPEG 2000"):
        image.decode(data)
