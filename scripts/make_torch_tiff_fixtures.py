"""Regenerates ``tests/fixtures/torch_tiff/``: a small scene tree and word
crops in the TIFF forms, with what Pillow, cv2 and the JAX package's
``crop_by_word`` make of them (``tests/fixtures/torch_forms/``'s layout).

- ``imgs/`` + ``gts/``: TIFF scenes of words from the campaign's first
  alphabet on noise (``make_torch_forms_fixtures``' scene writer), under
  the ``.jpg`` / ``.png`` names ``crop_by_word`` lists: LZW (Pillow),
  Deflate with the horizontal predictor, JPEG in tiles, LZW with
  Orientation 3 (shown upright by both libraries; cv2's ``imread`` fails
  on an Orientation of 5-8 that changes the shape, so the tools cannot
  read such a scene), a big-endian planar PackBits BigTIFF (which Pillow
  cannot read), a 1728-pixel G4 fax page of eight words; and one under
  ``.tif``, which both tools pass over.
- ``crops/``: a word crop in every form the port decodes: each
  compression (CCITT RLE, RLEW, G3 1-D and 2-D, G4 and ZSTD among them),
  strips and tiles, planar 2, FillOrder 2, both byte orders, BigTIFF, 1-64
  bits, signed and float samples, both predictors, palette, CMYK, YCbCr
  in JPEG and without it, CIELab, associated and unassociated alpha,
  Orientation 6, two pages; two crops named ``.jpg`` (what
  ``RawDataset`` lists).  ``labels.txt`` (``name word``).
- ``expected.npz``: the SHA-1 digests of Pillow's view and cv2's two
  views of every file (none for a view whose library does not read it:
  Pillow on the big-endian BigTIFF, cv2 on LZMA and 2- / 4-bit gray), and
  the JAX ``crop_by_word`` run on the tree (``make_torch_forms_fixtures``'
  ``digest`` and ``jax_crops``), and the word crops the JAX
  ``create_lmdb`` keeps (``jax:kept``: those cv2 reads in gray, so not
  LZMA, ZSTD, 2- / 4-bit gray or the samples cv2 reads only under
  ``IMREAD_UNCHANGED``).

    python3 scripts/make_torch_tiff_fixtures.py

Neither library writes tiles, planar 2, FillOrder 2 or old-style LZW, so
``write_tiff`` here does (the TIFF 6.0 layouts: strips or tiles, PackBits,
LZW in both bit orders, Deflate, LZMA and JPEG with its tables in tag 347,
the horizontal predictor, classic or BigTIFF in either byte order; and
CCITT, ZSTD, subsampled YCbCr, signed and float samples, the
floating-point predictor).  Needs
Pillow, cv2 and the JAX package's tools, so it runs where the tests run.
``tests/test_torch_tiff_fixtures.py`` holds the committed files to what
this script writes; ``chip_smoke.py`` holds the port's codec,
``crop_by_word``, ``create_lmdb`` and the CLIs against them on the machine
with the card, which has neither library.
"""

from __future__ import annotations

import importlib.util
import io
import lzma
import os
import shutil
import struct
import sys
import warnings
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import PIL.Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_spec = importlib.util.spec_from_file_location(
    "make_torch_forms_fixtures", os.path.join(ROOT, "scripts", "make_torch_forms_fixtures.py"))
forms = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(forms)

OUT = os.path.join(ROOT, "tests", "fixtures", "torch_tiff")
SEED = 2222

# compression codes
NONE, LZW, JPEG, DEFLATE, PACKBITS, ADOBE_DEFLATE, LZMA, ZSTD = 1, 5, 7, 32946, 32773, 8, 34925, \
    50000
CCITT_RLE, CCITT_G3, CCITT_G4, CCITT_RLEW = 2, 3, 4, 32771
OLD_JPEG, THUNDERSCAN = 6, 32809   # forms the port refuses, for its tests
# Pillow's names of libtiff's fax encoders
_PIL_FAX = {CCITT_RLE: "tiff_ccitt", CCITT_G3: "group3", CCITT_G4: "group4",
            CCITT_RLEW: "tiff_raw_16"}
# field types: BYTE, ASCII, SHORT, LONG, RATIONAL, SBYTE, UNDEFINED, SSHORT, SLONG,
# FLOAT, DOUBLE, IFD, LONG8
_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 11: "f",
          12: "d", 13: "I", 16: "Q"}


# -------------------------------------------------------------- compression
def packbits(data: bytes) -> bytes:
    """PackBits: runs of 3-128 equal bytes as repeats, the rest literal."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def lzw(data: bytes, compat: bool = False) -> bytes:
    """TIFF LZW: Clear, codes of 9-12 bits, EOI.  By default libtiff's
    MSB-first codes with the early change (a width grows one code before
    the table fills); ``compat`` is the old LSB-first form without it."""
    codes, width = [], []
    table: Dict[bytes, int] = {}
    nbits, free = 9, 258

    def reset():
        nonlocal nbits, free
        table.clear()
        table.update({bytes([i]): i for i in range(256)})
        nbits, free = 9, 258

    def emit(code):
        codes.append(code)
        width.append(nbits)

    def add():   # a table entry, then the width the next code is read at
        nonlocal nbits, free
        free += 1
        if free >= (1 << nbits) + (1 if compat else 0) and nbits < 12:
            nbits += 1

    reset()
    emit(256)
    w = b""
    for byte in data:
        wc = w + bytes([byte])
        if wc in table:
            w = wc
            continue
        emit(table[w])
        table[wc] = free
        add()
        if free >= 4094:
            emit(256)
            reset()
        w = bytes([byte])
    if w:
        emit(table[w])
        add()
    emit(257)
    acc, nacc, out = 0, 0, bytearray()
    for code, nb in zip(codes, width):
        if compat:
            acc |= code << nacc
            nacc += nb
            while nacc >= 8:
                out.append(acc & 255)
                acc >>= 8
                nacc -= 8
        else:
            acc = (acc << nb) | code
            nacc += nb
            while nacc >= 8:
                out.append((acc >> (nacc - 8)) & 255)
                nacc -= 8
    if nacc:
        out.append((acc << (8 - nacc)) & 255 if not compat else acc & 255)
    return bytes(out)


def fax(bits: np.ndarray, compression: int, t4options: int = 0) -> bytes:
    """A CCITT stream (RLE, RLEW, G3 under ``t4options``, G4) of a bilevel
    chunk [h, w] (1: the bits of a black run), libtiff's encoder through
    Pillow's writer, its one strip taken out."""
    im = PIL.Image.fromarray(np.asarray(bits).astype(bool))
    buf = io.BytesIO()
    im.save(buf, "TIFF", compression=_PIL_FAX[compression], strip_size=1 << 30,
            tiffinfo={292: t4options} if compression == CCITT_G3 else {})
    back = PIL.Image.open(buf)
    (off,), (n,) = back.tag_v2[273], back.tag_v2[279]
    return buf.getvalue()[off:off + n]


def zstd(data: bytes, level: int = 3, checksum: bool = False) -> bytes:
    """A ZSTD frame of ``data`` (the ``zstandard`` package; the tests' only
    use of it)."""
    import zstandard
    return zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)


def compress(data: bytes, compression: int, compat: bool = False, zstd_level: int = 3) -> bytes:
    if compression == NONE:
        return data
    if compression == PACKBITS:
        return packbits(data)
    if compression == LZW:
        return lzw(data, compat)
    if compression in (DEFLATE, ADOBE_DEFLATE):
        return zlib.compress(data, 6)
    if compression == LZMA:
        return lzma.compress(data, format=lzma.FORMAT_XZ, check=lzma.CHECK_NONE)
    if compression == ZSTD:
        return zstd(data, zstd_level)
    raise ValueError(f"no writer for compression {compression}")


_REVERSED = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


# ------------------------------------------------------------------ layout
def pack_rows(s: np.ndarray, bps: int, order: str) -> bytes:
    """Rows of samples [h, w, c] (their bit patterns: signed and float
    samples as ``as_bits`` gives them) at ``bps`` bits, each row padded to
    a byte; samples of whole bytes in the file's byte order, others MSB
    first."""
    h, w, c = s.shape
    if bps == 8:
        return s.astype(np.uint8).tobytes()
    if bps % 8 == 0:
        n = bps // 8
        le = s.astype(np.uint64).astype("<u8").view(np.uint8).reshape(h, w, c, 8)[..., :n]
        return np.ascontiguousarray(le if order == "<" else le[..., ::-1]).tobytes()
    v = s.reshape(h, w * c).astype(np.uint64)
    shifts = np.arange(bps - 1, -1, -1, dtype=np.uint64)
    bits = ((v[:, :, None] >> shifts) & np.uint64(1)).astype(np.uint8).reshape(h, -1)
    return np.packbits(bits, axis=1).tobytes()


def as_bits(values: np.ndarray, bps: int, sample_format: int) -> np.ndarray:
    """The stored bit patterns (uint64) of signed (``sample_format`` 2) or
    IEEE float (3) values at ``bps`` bits; unsigned values as they are."""
    v = np.asarray(values)
    if sample_format == 3:
        with np.errstate(over="ignore"):   # out of range: +-inf, as stored
            f = v.astype({16: "<f2", 32: "<f4", 64: "<f8"}[bps])
        return f.view({16: "<u2", 32: "<u4", 64: "<u8"}[bps]).astype(np.uint64)
    mask = (1 << bps) - 1
    return np.array([int(x) & mask for x in v.reshape(-1)], np.uint64).reshape(v.shape)


def ycbcr_blocks(s: np.ndarray, hs: int, vs: int) -> bytes:
    """8-bit YCbCr samples [h, w, 3] of a chunk in TIFF's subsampled
    layout: for each block of ``hs`` x ``vs`` pixels (the chunk padded by
    its edge pixels), its Y samples row by row, then the Cb and Cr of its
    top-left pixel."""
    h, w, _ = s.shape
    bh, bw = -(-h // vs), -(-w // hs)
    pad = np.pad(s, ((0, bh * vs - h), (0, bw * hs - w), (0, 0)), mode="edge").astype(np.uint8)
    y = pad[:, :, 0].reshape(bh, vs, bw, hs).transpose(0, 2, 1, 3).reshape(bh, bw, vs * hs)
    cbcr = pad[::vs, ::hs, 1:]
    return np.concatenate([y, cbcr], axis=2).tobytes()


def predict(s: np.ndarray, bps: int) -> np.ndarray:
    """The horizontal predictor on samples [h, w, c]: each sample less the
    same sample of the pixel to its left, modulo 2**bps."""
    s = s.astype(np.uint64)
    d = s.copy()
    d[:, 1:] -= s[:, :-1]
    return d & np.uint64((1 << bps) - 1) if bps < 64 else d


def float_predict(s: np.ndarray, bps: int) -> bytes:
    """The floating-point predictor (predictor 3) on samples [h, w, c]:
    each row's bytes gathered into planes, the most significant first,
    then each byte less the byte ``c`` before it."""
    h, w, c = s.shape
    n = bps // 8
    be = s.astype(np.uint64).astype(">u8").view(np.uint8).reshape(h, w * c, 8)[:, :, 8 - n:]
    planes = np.ascontiguousarray(be.transpose(0, 2, 1)).reshape(h, -1).astype(np.int64)
    planes[:, c:] -= planes[:, :-c].copy()
    return (planes & 255).astype(np.uint8).tobytes()


def jpeg_stream(s: np.ndarray, quality: int = 80, subsampling: int = 0) -> bytes:
    """A JPEG of a chunk's samples through Pillow's encoder (gray or the
    three samples as they are): the caller splits its tables off."""
    s = np.ascontiguousarray(s.astype(np.uint8))
    if s.shape[2] == 1:
        im = PIL.Image.fromarray(s[:, :, 0])
    else:
        im = PIL.Image.frombytes("YCbCr" if s.shape[2] == 3 else "CMYK", s.shape[1::-1],
                                 s.tobytes())
    buf = io.BytesIO()
    im.save(buf, "JPEG", quality=quality, subsampling=subsampling)
    return buf.getvalue()


def split_jpeg_tables(stream: bytes) -> Tuple[bytes, bytes]:
    """(tables, abbreviated): SOI DQT DHT EOI, and the stream without its
    DQT, DHT and APPn segments."""
    tables, image, pos = [b"\xff\xd8"], [b"\xff\xd8"], 2
    while pos < len(stream):
        marker = stream[pos + 1]
        if marker == 0xDA:
            image.append(stream[pos:])
            break
        length = struct.unpack_from(">H", stream, pos + 2)[0]
        seg = stream[pos:pos + 2 + length]
        if marker in (0xDB, 0xC4):
            tables.append(seg)
        elif not 0xE0 <= marker <= 0xEF:
            image.append(seg)
        pos += 2 + length
    return b"".join(tables) + b"\xff\xd9", b"".join(image)


def write_tiff(samples: np.ndarray, photometric: int, bps: int = 8, *,
               compression: int = NONE, predictor: int = 1, planar: int = 1,
               fillorder: int = 1, rows: Optional[int] = None,
               tile: Optional[Tuple[int, int]] = None, extra: Sequence[int] = (),
               colormap: Optional[np.ndarray] = None, bigtiff: bool = False,
               order: str = "<", compat: bool = False, quality: int = 80,
               subsampling: Tuple[int, int] = (1, 1), tags: Optional[dict] = None,
               reverse_compressed: Optional[bool] = None, pages: int = 1,
               sample_format: int = 1, t4options: Optional[int] = None,
               zstd_level: int = 3) -> bytes:
    """A TIFF of ``samples`` [h, w, c] (values as stored: indices, 16-bit
    values) in strips of ``rows`` rows (default all) or ``tile = (tw, th)``
    tiles (edge tiles padded with zeros), chunky or planar, with FillOrder
    2 reversing the bits of every stored byte (``reverse_compressed``
    overrides which chunks are reversed).  JPEG chunks are Pillow's JPEG of
    the chunk with its DQT / DHT moved into tag 347 (``subsampling`` 2x2
    for YCbCr 4:2:0).  ``tags`` adds or replaces fields (tag: (type,
    values)), or drops them (tag: None); ``pages`` > 1 chains copies of the IFD.
    Samples of ``sample_format`` 2 or 3 are given as their bit patterns
    (``as_bits``); CCITT chunks are libtiff's encoding of each chunk
    (``fax``; G3 under ``t4options``, written to tag 292 unless None);
    ZSTD chunks are frames at ``zstd_level``."""
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[:, :, None]
    h, w, c = s.shape
    e = order
    chunks: List[bytes] = []
    if tile is not None:
        tw, th = tile
        grid = [(x, y) for y in range(0, h, th) for x in range(0, w, tw)]
        size = (tw, th)
    else:
        rps = rows or h
        grid = [(0, y) for y in range(0, h, rps)]
        size = (w, rps)
    planes = [s[:, :, i:i + 1] for i in range(c)] if planar == 2 else [s]
    jpeg_tables = b""
    for plane in planes:
        for x, y in grid:
            cw, ch = size
            part = plane[y:y + ch, x:x + cw]
            if tile is not None:   # pad the edge tiles
                full = np.zeros((ch, cw, plane.shape[2]), plane.dtype)
                full[:part.shape[0], :part.shape[1]] = part
                part = full
            if compression == JPEG:
                jpeg_tables, data = split_jpeg_tables(jpeg_stream(
                    part, quality, {(2, 2): 2, (2, 1): 1}.get(tuple(subsampling), 0)))
            elif compression == OLD_JPEG:   # the whole JPEG, JPEGInterchangeFormat at it
                data = jpeg_stream(part, quality)
            elif compression == THUNDERSCAN:   # every 4-bit sample a raw code (0b11)
                data = bytes(0xC0 | int(v) for v in part.reshape(-1))
            elif compression in _PIL_FAX:
                data = fax(part[:, :, 0], compression, t4options or 0)
            elif photometric == 6 and tuple(subsampling) != (1, 1) and planar == 1:
                data = compress(ycbcr_blocks(part, *subsampling), compression, compat, zstd_level)
            elif predictor == 3:
                data = compress(float_predict(part, bps), compression, compat, zstd_level)
            else:
                if predictor == 2:
                    part = predict(part, bps)
                data = compress(pack_rows(part, bps, e), compression, compat, zstd_level)
            reverse = fillorder == 2 if reverse_compressed is None else reverse_compressed
            if reverse:
                data = data.translate(_REVERSED)
            chunks.append(data)
    fields = {256: (3 if w < 65536 else 4, [w]), 257: (3 if h < 65536 else 4, [h]),
              258: (3, [bps] * c), 259: (3, [compression]), 262: (3, [photometric]),
              277: (3, [c]), 284: (3, [planar])}
    if fillorder != 1:
        fields[266] = (3, [fillorder])
    if predictor != 1:
        fields[317] = (3, [predictor])
    if extra:
        fields[338] = (3, list(extra))
    if sample_format != 1:
        fields[339] = (3, [sample_format] * c)
    if compression == CCITT_G3 and t4options is not None:
        fields[292] = (4, [t4options])
    if colormap is not None:
        fields[320] = (3, [int(v) for v in np.asarray(colormap).T.reshape(-1)])
    if compression == JPEG:
        fields[347] = (7, list(jpeg_tables))
    if photometric == 6:
        fields[530] = (3, list(subsampling))
    long_type = 16 if bigtiff else 4
    if tile is not None:
        fields[322] = (3, [tile[0]])
        fields[323] = (3, [tile[1]])
        offsets_tag, counts_tag = 324, 325
    else:
        fields[278] = (3, [size[1]])
        offsets_tag, counts_tag = 273, 279
    fields[counts_tag] = (long_type, [len(d) for d in chunks])
    fields[offsets_tag] = (long_type, [0] * len(chunks))
    fields.update(tags or {})
    fields = {tag: v for tag, v in fields.items() if v is not None}
    head = 16 if bigtiff else 8
    data_at = head
    offsets = []
    for d in chunks:
        offsets.append(data_at)
        data_at += len(d) + (len(d) & 1)
    fields[offsets_tag] = (long_type, offsets)
    if compression == OLD_JPEG:
        fields[513], fields[514] = (4, [offsets[0]]), (4, [len(chunks[0])])
    body = b"".join(d + b"\0" * (len(d) & 1) for d in chunks)
    ifds, at = [], data_at
    for page in range(pages):
        ifd, at = _ifd(fields, at, e, bigtiff, last=page == pages - 1)
        ifds.append(ifd)
    if bigtiff:
        header = (b"II" if e == "<" else b"MM") + struct.pack(e + "HHHQ", 43, 8, 0, data_at)
    else:
        header = (b"II" if e == "<" else b"MM") + struct.pack(e + "HI", 42, data_at)
    return header + body + b"".join(ifds)


def _ifd(fields: dict, at: int, e: str, bigtiff: bool, last: bool) -> Tuple[bytes, int]:
    """One IFD written at offset ``at``, its out-of-line values after it;
    the offset after them (where a next IFD would go)."""
    count_fmt, entry, inline = ("Q", 20, 8) if bigtiff else ("H", 12, 4)
    ptr = "Q" if bigtiff else "I"
    n = len(fields)
    table_size = struct.calcsize(e + count_fmt) + n * entry + struct.calcsize(e + ptr)
    extra_at = at + table_size
    entries, blobs = [], b""
    for tag in sorted(fields):
        typ, values = fields[tag]
        fmt = _TYPES[typ]
        raw = struct.pack(e + fmt * len(values) if len(fmt) == 1 else e + "I" * len(values),
                          *values) if typ != 5 else \
            struct.pack(e + "I" * len(values), *values)
        count = len(values) if typ != 5 else len(values) // 2
        if len(raw) <= inline:
            value = raw + b"\0" * (inline - len(raw))
        else:
            value = struct.pack(e + ptr, extra_at + len(blobs))
            blobs += raw + b"\0" * (len(raw) & 1)
        entries.append(struct.pack(e + "HH" + ("Q" if bigtiff else "I"), tag, typ, count) + value)
    end = extra_at + len(blobs)
    nxt = 0 if last else end
    table = struct.pack(e + count_fmt, n) + b"".join(entries) + struct.pack(e + ptr, nxt)
    return table + blobs, end


# ----------------------------------------------------------------- content
def pil_tiff(image: PIL.Image.Image, **kw) -> bytes:
    """Pillow's TIFF writer (libtiff's encoders for every compression)."""
    buf = io.BytesIO()
    image.save(buf, "TIFF", **kw)
    return buf.getvalue()


def _alpha(rng, shape) -> np.ndarray:
    """A ramp with a transparent column and a few opaque pixels."""
    h, w = shape
    a = np.clip(np.linspace(30, 300, w)[None, :] + rng.integers(-20, 20, (h, w)), 0, 255)
    a[:, :2] = 0
    return a.astype(np.uint8)


def scenes(rng) -> Dict[str, bytes]:
    """{"imgs/<name>": bytes, "gts/<name>.txt": bytes}, one scene a form."""
    files = {}

    def put(name, data, gt):
        files[f"imgs/{name}"] = data
        files[f"gts/{os.path.splitext(name)[0]}.txt"] = gt.encode("utf-8")

    img, gt = forms._scene(rng, 100, 150)
    put("t0_lzw.jpg", pil_tiff(PIL.Image.fromarray(img), compression="tiff_lzw"), gt)
    img, gt = forms._scene(rng, 90, 150)
    put("t1_deflate_predictor.png", write_tiff(img, 2, compression=ADOBE_DEFLATE, predictor=2,
                                               rows=16), gt)
    img, gt = forms._scene(rng, 100, 140)
    put("t2_jpeg_tiles.jpg", write_tiff(img, 2, compression=JPEG, tile=(48, 32), quality=85),
        gt)
    img, gt = forms._scene(rng, 100, 130)     # shown upright after orientation 3
    put("t3_orientation3.jpg", write_tiff(np.ascontiguousarray(img[::-1, ::-1]), 2,
                                          compression=LZW, predictor=2, rows=20,
                                          tags={274: (3, [3])}), gt)
    img, gt = forms._scene(rng, 95, 130)      # Pillow reads it as a classic TIFF and fails
    put("t4_bigtiff_planar.png", write_tiff(img, 2, compression=PACKBITS, planar=2,
                                            bigtiff=True, order=">", rows=32), gt)
    img, gt = forms._scene(rng, 80, 110)      # a .tif name: both tools pass it over
    put("t5_skipped.tif", write_tiff(img, 2, compression=LZW), gt)
    black, gt = fax_page(np.random.default_rng(SEED + 1))   # the other files as they were
    put("t6_g4_page.png", write_tiff(black, 0, 1, compression=CCITT_G4), gt)
    return files


def fax_page(rng, h: int = 1100, w: int = 1728) -> Tuple[np.ndarray, str]:
    """A bilevel page of a fax's width [h, w, 1] (1: black) with eight
    words, their rendered strokes thresholded, and its gt text."""
    page = np.zeros((h, w), np.uint8)
    lines = []
    for k in range(8):
        word = forms._word(rng, 3, 6)
        wh = int(rng.integers(32, 56))
        ww = wh * len(word) + int(rng.integers(0, 20))
        y = 40 + k * (h - 100) // 8
        x = int(rng.integers(60, w - ww - 60))
        gray = forms._render(rng, word, wh, ww).mean(axis=2)
        page[y:y + wh, x:x + ww] = gray < 100
        lines.append(f"{x},{y},{x + ww},{y},{x + ww},{y + wh},{x},{y + wh},"
                     f"{forms.LANGUAGE},{word}")
    return page[:, :, None], "\n".join(lines) + "\n"


def crops(rng) -> Tuple[Dict[str, bytes], str]:
    """{"crops/<name>": bytes} in every TIFF form, and labels.txt."""
    files, labels = {}, []

    def put(name, data, word):
        files[f"crops/{name}"] = data
        labels.append(f"{name} {word}")

    def next_word(h=28):
        word = forms._word(rng, 2, 4)
        return word, forms._render(rng, word, h, h * len(word) + 6)

    word, rgb = next_word(27)
    put("d00_none_strips.tif", write_tiff(rgb, 2, rows=5), word)
    word, rgb = next_word()
    put("d01_packbits_gray.tif", pil_tiff(PIL.Image.fromarray(rgb).convert("L"),
                                          compression="packbits"), word)
    word, rgb = next_word(29)
    put("d02_lzw_predictor.tif", write_tiff(rgb, 2, compression=LZW, predictor=2, rows=7),
        word)
    word, rgb = next_word()
    put("d03_lzw_old_style.tif", write_tiff(rgb, 2, compression=LZW, compat=True), word)
    word, rgb = next_word()
    put("d04_deflate_unassociated.tif",
        write_tiff(np.dstack([rgb, _alpha(rng, rgb.shape[:2])]), 2, compression=DEFLATE,
                   extra=(2,), rows=9), word)
    word, rgb = next_word()
    a = _alpha(rng, rgb.shape[:2])
    premultiplied = (rgb.astype(np.int32) * a[:, :, None] + 127) // 255
    put("d05_deflate_associated.tif",
        write_tiff(np.dstack([premultiplied, a]), 2, compression=ADOBE_DEFLATE, extra=(1,)),
        word)
    word, rgb = next_word()
    put("d06_lzma.tif", pil_tiff(PIL.Image.fromarray(rgb), compression="lzma"), word)
    word, rgb = next_word(30)
    put("d07_jpeg_ycbcr420.tif", write_tiff(rgb, 6, compression=JPEG, subsampling=(2, 2),
                                            rows=16, quality=80), word)
    word, rgb = next_word(33)
    put("d08_jpeg_ycbcr_tiles.tif", write_tiff(rgb, 6, compression=JPEG, subsampling=(2, 1),
                                               tile=(32, 16), quality=90), word)
    word, rgb = next_word()
    put("d09_jpeg_gray.tif", write_tiff(rgb[:, :, :1], 1, compression=JPEG, rows=8), word)
    word, rgb = next_word()
    put("d10_jpeg_rgb.tif", pil_tiff(PIL.Image.fromarray(rgb), compression="jpeg",
                                     quality=75), word)
    word, rgb = next_word()
    put("d11_bilevel_min_is_white.tif", write_tiff(rgb[:, :, :1] < 128, 0, 1,
                                                   compression=PACKBITS), word)
    word, rgb = next_word()
    put("d12_gray4.tif", write_tiff(rgb[:, :, :1] >> 4, 1, 4, compression=LZW), word)
    word, rgb = next_word()
    put("d13_gray2_fill_order2.tif", write_tiff(rgb[:, :, :1] >> 6, 0, 2, fillorder=2), word)
    word, rgb = next_word()
    put("d14_gray16_big_endian.tif", write_tiff(rgb[:, :, :1].astype(np.int64) * 301, 1, 16,
                                                compression=DEFLATE, order=">"), word)
    word, rgb = next_word()
    put("d15_rgb16_predictor.tif", write_tiff(rgb.astype(np.int64) * 257 + 5, 2, 16,
                                              compression=LZW, predictor=2, rows=6), word)
    word, rgb = next_word()
    pal = PIL.Image.fromarray(rgb).quantize(64, dither=PIL.Image.Dither.NONE)
    put("d16_palette8.tif", pil_tiff(pal, compression="tiff_lzw"), word)
    word, rgb = next_word()
    pal = PIL.Image.fromarray(rgb).quantize(16, dither=PIL.Image.Dither.NONE)
    cmap = np.asarray(pal.getpalette()[:48]).reshape(16, 3) * 257
    put("d17_palette4_tiles.tif", write_tiff(np.asarray(pal)[:, :, None], 3, 4,
                                             compression=PACKBITS, tile=(32, 16),
                                             colormap=cmap), word)
    word, rgb = next_word()
    put("d18_cmyk.tif", pil_tiff(PIL.Image.fromarray(rgb).convert("CMYK"),
                                 compression="tiff_adobe_deflate"), word)
    word, rgb = next_word()
    put("d19_planar_tiles.tif", write_tiff(rgb, 2, compression=LZW, planar=2, tile=(16, 16)),
        word)
    word, rgb = next_word()
    put("d20_gray_alpha.tif", pil_tiff(PIL.Image.fromarray(
        np.dstack([rgb[:, :, 1], _alpha(rng, rgb.shape[:2])]), "LA"), compression="tiff_lzw"),
        word)
    word, rgb = next_word()
    put("d21_bigtiff.tif", pil_tiff(PIL.Image.fromarray(rgb), compression="tiff_lzw",
                                    big_tiff=True), word)
    word, rgb = next_word()
    put("d22_multi_page.tif", write_tiff(rgb, 2, compression=PACKBITS, pages=2), word)
    word, rgb = next_word()
    put("d23_orientation6.tif", write_tiff(np.ascontiguousarray(np.rot90(rgb)), 2,
                                           compression=PACKBITS, tags={274: (3, [6])}), word)
    word, rgb = next_word()
    put("d24_lzw_named.jpg", pil_tiff(PIL.Image.fromarray(rgb), compression="tiff_lzw"), word)
    word, rgb = next_word()
    put("d25_jpeg_named.jpg", write_tiff(rgb, 6, compression=JPEG, subsampling=(2, 2),
                                         rows=16), word)
    # the forms libtiff's fax codecs, other sample formats and its own
    # colour conversions bring
    word, rgb = next_word()
    put("d26_ccitt_rle.tif", pil_tiff(_bilevel(rgb), compression="tiff_ccitt"), word)
    word, rgb = next_word()
    put("d27_ccitt_rlew.tif", write_tiff(_black(rgb), 0, 1, compression=CCITT_RLEW, rows=4),
        word)
    word, rgb = next_word()
    put("d28_g3_1d.tif", pil_tiff(_bilevel(rgb), compression="group3"), word)
    word, rgb = next_word()
    put("d29_g3_2d_fill_order2.tif", write_tiff(_black(rgb), 0, 1, compression=CCITT_G3,
                                                t4options=5, fillorder=2, rows=8), word)
    word, rgb = next_word()
    put("d30_g4_tiles_min_is_white.tif", write_tiff(_black(rgb), 0, 1, compression=CCITT_G4,
                                                    tile=(32, 16)), word)
    word, rgb = next_word()
    put("d31_g4.tif", pil_tiff(_bilevel(rgb), compression="group4"), word)
    word, rgb = next_word()
    gray = rgb.mean(axis=2, keepdims=True)
    put("d32_int16_signed.tif", write_tiff(as_bits(gray.astype(np.int64) * 3 - 200, 16, 2), 1,
                                           16, sample_format=2, compression=LZW), word)
    word, rgb = next_word()
    gray = rgb.mean(axis=2, keepdims=True)
    put("d33_int32_predictor.tif", write_tiff(as_bits(gray.astype(np.int64) - 20, 32, 2), 1, 32,
                                              sample_format=2, compression=ADOBE_DEFLATE,
                                              predictor=2, rows=8), word)
    word, rgb = next_word()
    gray = rgb.mean(axis=2, keepdims=True) * 1.25 - 30   # past 0 and 255 at both ends
    put("d34_float32_predictor3.tif", write_tiff(as_bits(gray, 32, 3), 1, 32, sample_format=3,
                                                 compression=ADOBE_DEFLATE, predictor=3), word)
    word, rgb = next_word()
    put("d35_float64_big_endian.tif", write_tiff(as_bits(rgb.mean(axis=2, keepdims=True), 64,
                                                         3), 1, 64, sample_format=3,
                                                 compression=LZW, order=">", rows=9), word)
    word, rgb = next_word()
    put("d36_gray12.tif", write_tiff(rgb[:, :, :1].astype(np.int64) * 16 + 7, 1, 12,
                                     compression=PACKBITS), word)
    word, rgb = next_word()
    put("d37_ycbcr422_lzw.tif", write_tiff(_ycbcr(rgb), 6, subsampling=(2, 1),
                                           compression=LZW), word)
    word, rgb = next_word()        # Pillow's raw reader fails on it
    put("d38_ycbcr420_none.tif", write_tiff(_ycbcr(rgb), 6, subsampling=(2, 2), rows=8), word)
    word, rgb = next_word()
    put("d39_ycbcr_tiles.tif", write_tiff(_ycbcr(rgb), 6, subsampling=(4, 4), tile=(32, 16),
                                          compression=ADOBE_DEFLATE), word)
    word, rgb = next_word()        # (Pillow's LAB writer stamps its ICC profile with the time)
    put("d40_cielab.tif", write_tiff(_lab(rgb), 8, compression=LZW, rows=10), word)
    word, rgb = next_word()
    put("d41_cielab16_tiles.tif", write_tiff(_lab(rgb) * 257, 8, 16, tile=(32, 16),
                                             compression=LZW, order=">"), word)
    word, rgb = next_word()
    put("d42_zstd.tif", pil_tiff(PIL.Image.fromarray(rgb), compression="zstd"), word)
    word, rgb = next_word()
    put("d43_zstd_float_predictor3.tif", write_tiff(
        as_bits(rgb.mean(axis=2, keepdims=True), 32, 3), 1, 32, sample_format=3,
        compression=ZSTD, predictor=3, zstd_level=19), word)
    return files, "\n".join(labels) + "\n"


def _black(rgb: np.ndarray) -> np.ndarray:
    """A word crop's dark strokes [h, w, 1] (1: black)."""
    return (rgb.mean(axis=2, keepdims=True) < 100).astype(np.uint8)


def _bilevel(rgb: np.ndarray) -> PIL.Image.Image:
    """A word crop as Pillow's mode "1" (black strokes on white)."""
    return PIL.Image.fromarray(_black(rgb)[:, :, 0] == 0)


def _lab(rgb: np.ndarray) -> np.ndarray:
    """Pillow's Lab samples of an RGB crop as CIELab TIFF stores them (a
    and b signed)."""
    lab = np.asarray(PIL.Image.fromarray(rgb).convert("LAB")).astype(np.int64)
    lab[:, :, 1:] ^= 128
    return lab


def _ycbcr(rgb: np.ndarray) -> np.ndarray:
    """Pillow's YCbCr samples of an RGB crop."""
    return np.asarray(PIL.Image.fromarray(rgb).convert("YCbCr"))


def expected_views(files: Dict[str, bytes]) -> Dict[str, str]:
    """The digests of Pillow's and cv2's decodes of every image file; a
    view the library does not read (Pillow on a big-endian BigTIFF, cv2 on
    LZMA) has no key."""
    out = {}
    for name, data in sorted(files.items()):
        if not name.startswith(("imgs/", "crops/")) or name.endswith(".txt"):
            continue
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                pil = np.asarray(PIL.Image.open(io.BytesIO(data)).convert("RGBA"))
            out[f"{name}:pil"] = forms.digest(pil)
        except OSError:
            pass
        for which, flag in (("cv_color", forms.cv2.IMREAD_COLOR),
                            ("cv_unchanged", forms.cv2.IMREAD_UNCHANGED)):
            got = forms.cv2.imdecode(np.frombuffer(data, np.uint8), flag)
            if got is not None:
                out[f"{name}:{which}"] = forms.digest(got)
    return out


def jax_kept(files: Dict[str, bytes]) -> np.ndarray:
    """The word crops the JAX package's ``create_lmdb`` keeps: those
    ``cv2.imdecode(..., IMREAD_GRAYSCALE)`` reads."""
    from mrn_tpu.tools.create_lmdb import check_image_valid
    return np.array(sorted(name.split("/", 1)[1] for name, data in files.items()
                           if name.startswith("crops/") and not name.endswith(".txt")
                           and check_image_valid(data)))


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
    expected = expected_views(files)
    expected.update(forms.jax_crops(out))
    expected["jax:kept"] = jax_kept(files)
    np.savez_compressed(os.path.join(out, "expected.npz"), **expected)


if __name__ == "__main__":
    build(OUT)
    total = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(OUT) for f in fs)
    print(f"wrote {OUT}: {total / 1024:.0f} KB")
