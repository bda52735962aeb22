"""The port's CCITT fax decoders (``data/csrc/tiffcodec.cpp``: tif_fax3.c's
Modified Huffman RLE and RLEW, T.4 1-D and 2-D with and without fill bits,
T.6) against Pillow 12.1 and cv2 5.0 (both over libtiff 4.7), bit for bit,
on files libtiff's own encoders write (Pillow's writer) and on those
strips re-wrapped by ``write_tiff`` in the layouts neither library writes:
MinIsWhite and MinIsBlack, FillOrder 2, tiles, strips of any height, both
byte orders, BigTIFF, an odd strip offset (RLEW aligns to the file's
words), widths from 1 to a 1728-pixel fax page.

libtiff's decoder is lenient, and so is the port: a row that ends short or
long is padded or cut, a code no table holds ends the row where it stands,
a G3 strip without EOLs is read again from its start without them, a G4
strip ends quietly at its EOFB or at the data's end after its first row,
and cv2's RGBA read goes on after a strip libtiff fails (the rows it did
not decode white... or black: zeros).  Cut-off and damaged strips are held
to both libraries, but for the one rule no decoder can model: the rows
after a G4 strip's early end are Pillow's heap memory, zeros in the port
(ROADMAP.md §3).  ``LmdbDataset`` and ``create_lmdb``'s check over fax
crops give JAX's answers.
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

# name -> (compression, T4Options)
FAX = {"RLE": (tx.CCITT_RLE, None), "RLEW": (tx.CCITT_RLEW, None), "G3 1-D": (tx.CCITT_G3, 0),
       "G3 2-D": (tx.CCITT_G3, 1), "G3 1-D fill": (tx.CCITT_G3, 4),
       "G3 2-D fill": (tx.CCITT_G3, 5), "G4": (tx.CCITT_G4, None)}


def _page(rng, h, w):
    """Bilevel content with a document's runs: strokes and blobs on white,
    some noise."""
    a = np.zeros((h, w), bool)
    for _ in range(max(1, h * w // 400)):
        y, x = rng.integers(0, h), rng.integers(0, w)
        a[y:y + rng.integers(1, 6), x:x + rng.integers(1, 40)] = True
    a ^= rng.random((h, w)) < rng.choice([0.0, 0.02, 0.3])
    return a


def _pillow_fax(bits, name):
    compression, t4 = FAX[name]
    buf = io.BytesIO()
    PIL.Image.fromarray(bits).save(buf, "TIFF", compression=tx._PIL_FAX[compression],
                                   tiffinfo={} if t4 is None else {292: t4})
    return buf.getvalue()


def _wrap(bits, name, photometric=1, **kw):
    compression, t4 = FAX[name]
    return tx.write_tiff(np.asarray(bits)[:, :, None].astype(int), photometric, 1,
                         compression=compression, t4options=t4, **kw)


def _strip_file(data, w, h, compression, t4=None, odd=False, count=None, photometric=1):
    """One strip of fax ``data`` in a TIFF of its own, at an odd offset if
    asked, with StripByteCounts ``count`` (default: the data's length)."""
    pad = b"\0" if odd else b""
    at = 8 + len(pad)
    tags = [(256, 3, w), (257, 3, h), (258, 3, 1), (259, 3, compression),
            (262, 3, photometric), (273, 4, at), (277, 3, 1), (278, 3, h),
            (279, 4, len(data) if count is None else count)]
    if t4 is not None:
        tags.append((292, 4, t4))
    body = pad + data + b"\0" * ((len(pad) + len(data)) % 2)
    entries = b"".join(struct.pack("<HHII" if ty == 4 else "<HHIHH", tag, ty, 1,
                                   *((v,) if ty == 4 else (v, 0))) for tag, ty, v in sorted(tags))
    return (b"II" + struct.pack("<HI", 42, 8 + len(body)) + body +
            struct.pack("<H", len(tags)) + entries + b"\0" * 4)


def _strip_of(data):
    t = image._tiff(data, None, pillow=False)
    return data[t.tags[273][0]:t.tags[273][0] + t.tags[279][0]]


# ------------------------------------------------------------- the encoders
@pytest.mark.parametrize("name", sorted(FAX))
def test_pillow_written(name):
    """libtiff's own encoders through Pillow's writer, 1x1 to a fax page;
    libtiff's RLEW decoder misreads its encoder's word alignment, and the
    port with it (Pillow fails where the rows run out of data, cv2 reads
    on)."""
    rng = np.random.default_rng(sorted(FAX).index(name))
    decoded = 0
    for h, w in ((1, 1), (1, 9), (9, 1), (13, 31), (24, 1728)):
        decoded += tt._check(_pillow_fax(_page(rng, h, w), name))
    assert decoded >= (10 if name == "RLEW" else 15)


@pytest.mark.parametrize("name", sorted(FAX))
def test_layouts_neither_library_writes(name):
    """The encoders' strips re-wrapped: MinIsWhite, FillOrder 2, tiles cut
    by both edges, strips of 1 to 7 rows, big-endian, BigTIFF."""
    rng = np.random.default_rng(10 + sorted(FAX).index(name))
    decoded = 0
    for kw in (dict(photometric=0), dict(fillorder=2, rows=3), dict(tile=(16, 16)),
               dict(tile=(32, 16), photometric=0, order=">"), dict(rows=1, bigtiff=True),
               dict(rows=7, order=">", bigtiff=True)):
        decoded += tt._check(_wrap(_page(rng, 21, 37), name, **kw))
    # Pillow reads a big-endian BigTIFF as a classic TIFF, and fails
    assert decoded >= (12 if name == "RLEW" else 17)


def test_rlew_word_alignment_follows_the_file_offset():
    """RLEW rows end on a 16-bit word of memory: libtiff reads the strip
    where the file maps it, so an odd strip offset moves every alignment,
    and the port counts from the file's offset too."""
    rng = np.random.default_rng(30)
    for h, w in ((7, 9), (11, 20), (5, 64)):
        data = _strip_of(_pillow_fax(_page(rng, h, w), "RLEW"))
        for odd in (False, True):
            tt._check(_strip_file(data, w, h, tx.CCITT_RLEW, odd=odd))


def test_fax_page_1728():
    """A 1728-pixel, 200-row page of text-like strokes in G4 and G3 2-D."""
    bits = _page(np.random.default_rng(31), 200, 1728)
    for name in ("G4", "G3 2-D"):
        assert tt._check(_pillow_fax(bits, name)) == 3


def _sweep_case(seed):
    rng = np.random.default_rng(2000 + seed)
    names = sorted(FAX)
    name = names[rng.integers(len(names))]
    h, w = [(1, 1), (1, 13), (11, 1), (7, 9), (20, 37), (33, 70)][rng.integers(6)]
    kw = dict(photometric=int(rng.integers(2)), order="<>"[rng.integers(2)],
              bigtiff=bool(rng.random() < 0.2))
    if rng.random() < 0.25:
        kw["fillorder"] = 2
    r = rng.random()
    if r < 0.3:
        kw["tile"] = [(16, 16), (32, 16), (16, 32)][rng.integers(3)]
    elif r < 0.7:
        kw["rows"] = int(rng.integers(1, 9))
    if rng.random() < 0.2:
        kw["tags"] = {274: (3, [int(rng.integers(1, 9))])}
    return _wrap(_page(rng, h, w), name, **kw)


@pytest.mark.parametrize("block", range(4))
def test_seeded_sweep(block):
    """Random fax forms, layouts and orientations, 30 files a block."""
    decoded = sum(tt._check(_sweep_case(block * 30 + k)) for k in range(30))
    assert decoded > 60


# ----------------------------------------------------- leniency, damage
def _damaged(rng):
    names = sorted(FAX)
    name = names[rng.integers(len(names))]
    h, w = [(5, 9), (12, 31), (20, 64)][rng.integers(3)]
    data = bytearray(_strip_of(_pillow_fax(_page(rng, h, w), name)))
    how = rng.integers(4)
    if how == 0:
        data = data[:int(rng.integers(1, len(data)))]
    elif how == 1:
        for _ in range(int(rng.integers(1, 4))):
            data[int(rng.integers(len(data)))] ^= 1 << int(rng.integers(8))
    elif how == 2:
        at = int(rng.integers(len(data)))
        data[at:at] = rng.integers(0, 256, int(rng.integers(1, 4))).astype(np.uint8).tobytes()
    else:
        at = int(rng.integers(len(data)))
        del data[at:at + int(rng.integers(1, 4))]
    compression, t4 = FAX[name]
    return name, _strip_file(bytes(data or b"\0"), w, h, compression, t4,
                             odd=bool(rng.integers(2)))


@pytest.mark.parametrize("block", range(3))
def test_cut_and_damaged_strips(block):
    """Strips cut short, with bits flipped, bytes put in or taken out: cv2's
    views exactly (libtiff's row cleanup, the G3 retry without EOLs, its
    RGBA read going on past a failed strip), Pillow's exactly where it
    fails or reads the strip whole; after a G4 strip's early end Pillow
    shows its heap, the port zeros."""
    rng = np.random.default_rng(300 + block)
    for _ in range(40):
        name, data = _damaged(rng)
        for flags in (image.IMREAD_COLOR, image.IMREAD_UNCHANGED):
            want = cv2.imdecode(np.frombuffer(data, np.uint8), flags)
            if want is None:
                with pytest.raises(image.CorruptImage):
                    image.imdecode(data, flags)
            else:
                np.testing.assert_array_equal(image.imdecode(data, flags), want)
        ref = tt._pillow(data)
        if not isinstance(ref, np.ndarray):
            with pytest.raises(image.CorruptImage):
                image.decode(data)
            continue
        got = image.decode(data)
        if name != "G4":
            np.testing.assert_array_equal(got, ref)
            continue
        np.testing.assert_array_equal(got[:, :, 0], image.imdecode(data, image.IMREAD_UNCHANGED))
        stale = ~(got == ref).all(axis=(1, 2))
        assert not got[stale, :, 0].any()   # only rows the strip never reached


def test_damaged_tile_reads_the_runs_earlier_tiles_left():
    """libtiff keeps its fax run arrays across an image's chunks: a
    damaged row of a later tile reads past its reference line's runs into
    what an earlier tile's rows left there, in both libraries, and so does
    the port (the fixture's G4 tiles, the second tile's bytes 0 and 67
    set)."""
    data = bytearray((ROOT / "tests" / "fixtures" / "torch_tiff" / "crops" /
                      "d30_g4_tiles_min_is_white.tif").read_bytes())
    at = image._tiff(bytes(data), None, pillow=False).tags[324][1]
    data[at], data[at + 67] = 161, 2
    assert tt._check(bytes(data)) == 3


def test_g4_early_end_diverges_in_pillow_only():
    """A G4 strip cut after its first rows: libtiff returns it as read, and
    the rows it never reached hold whatever Pillow's strip buffer held; cv2
    and the port give zeros there (ROADMAP.md §3)."""
    bits = _page(np.random.default_rng(32), 40, 64)
    data = _strip_of(_pillow_fax(bits, "G4"))
    cut = _strip_file(data[:len(data) // 3], 64, 40, tx.CCITT_G4)
    ref = cv2.imdecode(np.frombuffer(cut, np.uint8), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(image.imdecode(cut, image.IMREAD_UNCHANGED), ref)
    got = image.decode(cut)[:, :, 0]
    np.testing.assert_array_equal(got, ref)
    assert not ref[-5:].any() and (ref[:3] == np.where(bits[:3], 255, 0)).all()


def test_g3_without_eols_is_read_again_without_them():
    """An RLE strip labelled G3: SYNC_EOL finds no EOL, and libtiff 4.7 sets
    FAXMODE_NOEOL and reads the strip again from its start as EOL-less
    Modified Huffman rows, for this strip and the ones after."""
    rng = np.random.default_rng(33)
    for h, w in ((6, 20), (15, 64)):
        data = _strip_of(_pillow_fax(_page(rng, h, w), "RLE"))
        assert tt._check(_strip_file(data, w, h, tx.CCITT_G3, t4=0)) == 3
    bits = _page(rng, 12, 40)
    two = tx.write_tiff(bits[:, :, None].astype(int), 1, 1, compression=tx.CCITT_RLE, rows=6,
                        tags={259: (3, [tx.CCITT_G3])})
    assert tt._check(two) == 3


def test_bogus_byte_count_is_estimated():
    """A single strip whose StripByteCounts is 0: libtiff estimates it from
    the file (ByteCountLooksBad), and both libraries decode the strip."""
    rng = np.random.default_rng(34)
    for name in ("G4", "G3 2-D", "RLE"):
        bits = _page(rng, 10, 30)
        compression, t4 = FAX[name]
        data = _strip_file(_strip_of(_pillow_fax(bits, name)), 30, 10, compression, t4, count=0)
        assert tt._check(data) == 3
        np.testing.assert_array_equal(image.imdecode(data, image.IMREAD_UNCHANGED),
                                      np.where(bits, 255, 0))


# -------------------------------------------------------------- datasets
def test_lmdb_dataset_and_create_lmdb_over_fax_crops_match_jax(tmp_path):
    """LmdbDataset over crops in every fax form gives JAX's labels and
    ResizeNormalize tensors bytewise; ``create_lmdb``'s check keeps what
    JAX's (cv2's) keeps."""
    rng = np.random.default_rng(35)
    crops = [_pillow_fax(_page(rng, 28, 90), name) for name in sorted(FAX)]
    crops += [_wrap(_page(rng, 30, 70), "G4", photometric=0, tile=(32, 16)),
              _wrap(_page(rng, 25, 60), "G3 2-D", fillorder=2, rows=5, order=">")]
    w = lmdb_store.LmdbWriter(str(tmp_path / "fax"))
    w.put(b"num-samples", str(len(crops)).encode())
    for i, data in enumerate(crops, 1):
        w.put(b"image-%09d" % i, data)
        w.put(b"label-%09d" % i, b"abc")
    w.commit()
    opt, jopt = tt._opts()
    to_jax = JaxResizeNormalize((tt.IMG_W, tt.IMG_H))
    got = dataset.LmdbDataset(str(tmp_path / "fax"), opt)
    ref = jax_dataset.LmdbDataset(str(tmp_path / "fax"), jopt)
    assert len(got) == len(ref) == len(crops)
    for i in range(len(ref)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            (g, gl), (r, rl) = got[i], ref[i]
        assert gl == rl
        assert tt._normed(ResizeNormalize((tt.IMG_W, tt.IMG_H))(g)[None]).tobytes() == \
            to_jax(r)[None].astype(np.float32).tobytes()
    assert [check_image_valid(d) for d in crops] == [jax_check_image_valid(d) for d in crops]
