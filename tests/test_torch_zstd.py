"""The port's Zstandard decoder (``data/csrc/zstdcodec.cpp``, RFC 8878) and
ZSTD-compressed TIFF (compression 50000) in Pillow's view, which reads it
through libtiff 4.7's tif_zstd.c and libzstd:

- raw frames of the ``zstandard`` package (the tests' reference encoder)
  at every level from -5 to 22, with and without the checksum and the
  content size, of data from 1 byte to multi-block frames past 128 KiB:
  raw, RLE and compressed blocks, every literals and sequences mode the
  encoder picks;
- ZSTD TIFFs against Pillow bit for bit: every sample form, the
  predictors, strips and tiles, planes, both byte orders, BigTIFF,
  Pillow's own writer; cv2's libtiff has no ZSTD codec, so its view
  raises ``CorruptImage`` as cv2 gives None;
- skippable frames, two frames in a chunk, a frame that names a
  dictionary, frames cut short or damaged: Pillow's answer, libzstd's
  rules included (its fast four-stream Huffman loop reading a damaged
  literal stream on, its tree and buffer checks);
- ``LmdbDataset`` over ZSTD crops gives JAX's items, and ``create_lmdb``'s
  check drops them as JAX's (cv2's) does.
"""

import ctypes
import importlib.util
import struct
import warnings
from pathlib import Path

import cv2
import numpy as np
import pytest
import zstandard

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


def _decode(frame, cap):
    """The port's decode of ``frame`` into ``cap`` bytes, or its error."""
    out, err = ctypes.create_string_buffer(max(cap, 1)), ctypes.create_string_buffer(256)
    rc = image._zstd_lib().zs_decode(frame, len(frame), out, cap, err, 256)
    return out.raw[:cap] if rc == 0 else err.value.decode()


def _data(rng, n):
    """Bytes of one of five kinds: random, a small alphabet, slow ramps,
    runs, a vocabulary of words."""
    kind = int(rng.integers(5))
    if kind == 0:
        return rng.integers(0, 256, n).astype(np.uint8).tobytes()
    if kind == 1:
        return rng.integers(0, 4, n).astype(np.uint8).tobytes()
    if kind == 2:
        return (np.arange(n) // int(rng.integers(1, 50)) % 256).astype(np.uint8).tobytes()
    if kind == 3:
        return np.repeat(rng.integers(0, 256, n // 37 + 1), 37)[:n].astype(np.uint8).tobytes()
    words = [rng.integers(0, 256, int(rng.integers(2, 20))).astype(np.uint8).tobytes()
             for _ in range(30)]
    return b"".join(words[i] for i in rng.integers(0, 30, n // 2 + 1))[:n]


@pytest.mark.parametrize("level", range(-5, 23))
def test_raw_frames_at_every_level(level):
    """Ten frames a level, one of them past 128 KiB (several blocks and the
    window), with and without the checksum and the content size."""
    rng = np.random.default_rng(100 + level)
    for k in range(10):
        n = 150_000 + int(rng.integers(0, 60_000)) if k == 0 else \
            int(rng.choice([1, 5, 100, 1000, 5000, 20_000]))
        data = _data(rng, n)
        frame = zstandard.ZstdCompressor(level=level, write_checksum=bool(k % 2),
                                         write_content_size=k % 3 != 0).compress(data)
        assert len(data) == n and _decode(frame, n) == data, (level, k, n)


def _strip_file(frame, w, h, spp, bps, photometric):
    """A little-endian TIFF of one ZSTD strip ``frame``."""
    tags = [(256, 3, w), (257, 3, h), (258, 3, bps), (259, 3, tx.ZSTD), (262, 3, photometric),
            (273, 4, 8), (277, 3, spp), (278, 3, h), (279, 4, len(frame))]
    body = frame + b"\0" * (len(frame) % 2)
    return (b"II" + struct.pack("<HI", 42, 8 + len(body)) + body + struct.pack("<H", len(tags)) +
            b"".join(struct.pack("<HHII" if ty == 4 else "<HHIHH", tag, ty, 1,
                                 *((v,) if ty == 4 else (v, 0))) for tag, ty, v in tags) +
            b"\0" * 4)


def _pillow_only(data):
    """Pillow's view against Pillow; cv2's raising as cv2 gives None.
    Returns whether Pillow decoded."""
    assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None
    for flags in (image.IMREAD_COLOR, image.IMREAD_UNCHANGED):
        with pytest.raises(image.CorruptImage):
            image.imdecode(data, flags)
    return tt._check(data) == 1


# (photometric, bits, samples, extra, sample format)
ZSTD_FORMS = [(2, 8, 3, (), 1), (1, 8, 1, (), 1), (2, 8, 4, (2,), 1), (1, 16, 1, (), 1),
              (2, 16, 3, (), 1), (1, 1, 1, (), 1), (3, 8, 1, (), 1), (1, 32, 1, (), 3),
              (1, 16, 1, (), 2), (1, 12, 1, (), 1), (8, 8, 3, (), 1), (6, 8, 3, (), 1)]


@pytest.mark.parametrize("block", range(4))
def test_zstd_tiff_sweep_against_pillow(block):
    """30 files a block: forms, predictors, strips, tiles, planes, byte
    orders, BigTIFF, levels."""
    rng = np.random.default_rng(200 + block)
    decoded = 0
    for _ in range(30):
        photo, bps, spp, extra, sf = ZSTD_FORMS[rng.integers(len(ZSTD_FORMS))]
        h, w = [(1, 1), (1, 17), (13, 1), (19, 23), (40, 70)][rng.integers(5)]
        if sf == 1 and bps <= 16:
            s = rng.integers(0, 1 << bps, (h, w, spp))
        else:
            s = tx.as_bits(rng.normal(100, 150, (h, w, spp)) if sf == 3 else
                           rng.integers(-300, 300, (h, w, spp)), bps, sf)
        kw = dict(order="<>"[rng.integers(2)], bigtiff=bool(rng.random() < 0.2),
                  zstd_level=int(rng.integers(-5, 23)), extra=extra, sample_format=sf)
        if photo == 3:
            kw["colormap"] = rng.integers(0, 65536, (1 << bps, 3))
        if photo == 6:
            kw["subsampling"] = [(1, 1), (2, 2), (2, 1), (4, 4)][rng.integers(4)]
        elif bps >= 8 and rng.random() < 0.4:
            kw["predictor"] = 3 if sf == 3 else 2
        r = rng.random()
        if r < 0.25:
            kw["tile"] = (16, 16)
        elif r < 0.6:
            kw["rows"] = int(rng.integers(1, 7))
        if spp > 1 and photo != 6 and rng.random() < 0.25:
            kw["planar"] = 2
        decoded += _pillow_only(tx.write_tiff(s, photo, bps, compression=tx.ZSTD, **kw))
    assert decoded >= 20


def test_pillow_written_zstd():
    rng = np.random.default_rng(300)
    for mode in ("RGB", "L", "RGBA", "I;16", "1", "P", "CMYK"):
        for h, w in ((1, 1), (9, 13), (60, 90)):
            a = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            im = tt.PIL.Image.fromarray(a)
            im = im.convert("RGBA") if mode == "RGBA" else im.convert(mode) if mode != "I;16" \
                else tt.PIL.Image.fromarray(rng.integers(0, 65536, (h, w)).astype(np.uint16))
            assert _pillow_only(tx.pil_tiff(im, compression="zstd"))


def test_skippable_two_frames_and_dictionaries():
    """A skippable frame ends libtiff's loop (the chunk is short: Pillow
    fails), so does the first of two frames; a frame naming a dictionary
    fails in both; a chunk decoded whole before its frame ends reads."""
    rng = np.random.default_rng(301)
    s = rng.integers(0, 256, (20, 30)).astype(np.uint8)
    raw = s.tobytes()
    frame = tx.zstd(raw, 5, checksum=True)
    skippable = struct.pack("<II", 0x184D2A53, 6) + b"header"
    halves = tx.zstd(raw[:300], 3) + tx.zstd(raw[300:], 3)
    samples = [rng.integers(0, 4, 600).astype(np.uint8).tobytes() for _ in range(40)]
    d = zstandard.train_dictionary(1024, samples)
    with_dict = zstandard.ZstdCompressor(dict_data=d).compress(raw)
    for chunk, reads in ((frame, True), (skippable + frame, False), (halves, False),
                         (with_dict, False), (frame + b"trailing data", True)):
        data = _strip_file(chunk, 30, 20, 1, 8, 1)
        assert _pillow_only(data) == reads
        if reads:
            np.testing.assert_array_equal(image.decode(data)[:, :, 0], s)
    assert "dictionary" in _decode(with_dict, len(raw))


def _damaged(rng):
    h, w = [(5, 40), (30, 64), (200, 300)][rng.integers(3)]
    s = rng.integers(0, 256, (h, w)).astype(np.uint8)
    s[::int(rng.integers(1, 5))] = 7
    if rng.integers(2):
        s %= int(rng.integers(2, 40))
    frame = bytearray(tx.zstd(s.tobytes(), int(rng.integers(-3, 20)), bool(rng.integers(2))))
    how = rng.integers(3)
    if how == 0:
        for _ in range(int(rng.integers(1, 3))):
            frame[int(rng.integers(len(frame)))] ^= 1 << int(rng.integers(8))
    elif how == 1:
        frame = frame[:int(rng.integers(1, len(frame)))]
    else:
        frame[int(rng.integers(len(frame)))] = int(rng.integers(256))
    return _strip_file(bytes(frame), w, h, 1, 8, 1)


@pytest.mark.parametrize("block", range(3))
def test_cut_and_damaged_frames(block):
    """40 frames a block cut short, with bits flipped or a byte set:
    Pillow's answer, failing or decoding (libzstd's rules below)."""
    rng = np.random.default_rng(400 + block)
    for _ in range(40):
        _pillow_only(_damaged(rng))


def _frame(size, blocks):
    """A frame of an 8 KiB window, content size ``size`` (2 bytes) and
    ``blocks``: (last, type, size field, bytes) each."""
    frame = struct.pack("<IBBH", 0xFD2FB528, 0x40, 3 << 3, size - 256)
    for last, kind, field, data in blocks:
        frame += (last | kind << 1 | field << 3).to_bytes(3, "little") + data
    return frame


def _flipped(flips):
    """Level 8's frame of 1800 bytes of a small alphabet, bits flipped:
    [(byte, bit)]."""
    data = np.random.default_rng(0).integers(0, 40, 1800).astype(np.uint8)
    data[::3] = 7
    frame = bytearray(zstandard.ZstdCompressor(level=8).compress(data.tobytes()))
    for at, bit in flips:
        frame[at] ^= 1 << bit
    return bytes(frame)


LIBZSTD_RULES = {
    # a jump table's stream length flipped: the fast four-stream loop reads
    # its streams on into the bytes before them and decodes what they say
    "four streams read on": (_flipped([(25, 4)]), True),
    # a bit of a stream flipped: it ends with bits unread
    "stream left unread": (_flipped([(304, 3)]), True),
    # a stream's last byte zeroed: the fast loop takes no end mark
    "stream without its end mark": (_flipped([(883, 0)]), True),
    # weights whose tree has an odd count of longest codes
    "Huffman weights of no tree": (_flipped([(16, 1)]), False),
    # streaming, a block past the content size fails in libzstd's buffer
    "block past the content size": (_frame(1800, [(0, 1, 1500, b"\x07"),
                                                  (0, 1, 1000, b"\x08")]), False),
    # raw literals, no sequences, and a byte after their header
    "data after no sequences": (_frame(1800, [(1, 2, 1804, bytes([0x84, 1800 >> 4]) +
                                               bytes(range(200)) * 9 + b"\x00\x00")]), False),
}


@pytest.mark.parametrize("rule", sorted(LIBZSTD_RULES))
def test_libzstd_rules(rule):
    """libzstd 1.5.7's answers on frames its decoder reads leniently or
    refuses where a plain RFC 8878 decoder would not: the port's, through
    Pillow's view of a 60 x 30 gray strip."""
    frame, reads = LIBZSTD_RULES[rule]
    assert _pillow_only(_strip_file(frame, 60, 30, 1, 8, 1)) == reads


def test_lmdb_dataset_and_create_lmdb_over_zstd_crops_match_jax(tmp_path):
    rng = np.random.default_rng(302)
    crops = [tx.write_tiff(rng.integers(0, 256, (30, 70, 3)), 2, compression=tx.ZSTD, rows=7),
             tx.write_tiff(rng.integers(0, 65536, (28, 66, 1)), 1, 16, compression=tx.ZSTD,
                           predictor=2, tile=(32, 16), order=">"),
             tx.write_tiff(tx.as_bits(rng.normal(100, 90, (29, 61, 1)), 32, 3), 1, 32,
                           sample_format=3, compression=tx.ZSTD, predictor=3, zstd_level=19),
             tx.pil_tiff(tt.PIL.Image.fromarray(rng.integers(0, 256, (31, 75)).astype(np.uint8)),
                         compression="zstd")]
    w = lmdb_store.LmdbWriter(str(tmp_path / "zstd"))
    w.put(b"num-samples", str(len(crops)).encode())
    for i, data in enumerate(crops, 1):
        w.put(b"image-%09d" % i, data)
        w.put(b"label-%09d" % i, b"abc")
    w.commit()
    opt, jopt = tt._opts()
    to_jax = JaxResizeNormalize((tt.IMG_W, tt.IMG_H))
    got = dataset.LmdbDataset(str(tmp_path / "zstd"), opt)
    ref = jax_dataset.LmdbDataset(str(tmp_path / "zstd"), jopt)
    assert len(got) == len(ref) == len(crops)
    for i in range(len(ref)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            (g, gl), (r, rl) = got[i], ref[i]
        assert gl == rl == "abc"
        assert tt._normed(ResizeNormalize((tt.IMG_W, tt.IMG_H))(g)[None]).tobytes() == \
            to_jax(r)[None].astype(np.float32).tobytes()
    assert [check_image_valid(d) for d in crops] == [jax_check_image_valid(d) for d in crops] \
        == [False] * len(crops)
