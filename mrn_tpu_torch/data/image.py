"""Images without PIL or cv2: decode PNG, JPEG, GIF and BMP bytes bit for
bit as the JAX package's libraries read them, and resize them as Pillow's
``Image.resize(BICUBIC)`` does.

Two views of the same decoders:

- ``decode(buf, size, key)``: Pillow's, ``[H, W, 4]`` RGBA uint8 as
  ``PIL.Image.open(b).convert("RGBA")`` gives it (then resized to ``size =
  (W, H)``), what ``LmdbDataset``, ``RawDataset`` and
  ``create_lmdb.check_image_valid`` read, as the JAX readers do through
  Pillow.
- ``imdecode(buf, flags)`` / ``imread(path, flags)``: cv2's, for the tools
  (``crop_by_word``): ``IMREAD_COLOR`` is BGR ``[H, W, 3]`` with the EXIF
  orientation applied (JPEG APP1, PNG eXIf), alpha dropped, palette and
  gray expanded, 16 bits to their high byte; ``IMREAD_UNCHANGED`` is the
  stored shape, unrotated, as cv2 gives it (gray ``[H, W]``, BGRA where
  there is alpha, uint16 for 16-bit PNG).

The forms decoded:

- JPEG (``csrc/imagecodec.cpp``, as libjpeg-turbo runs it): baseline,
  extended and progressive Huffman, 8-bit, restart markers, 1, 3 or 4
  components (Adobe CMYK: Pillow's inverted ``CMYK`` and ``cmyk2rgb``;
  cv2's own conversion), any sampling libjpeg-turbo accepts (fancy h2v1 /
  h2v2 / h1v2 upsampling, ``int_upsample`` otherwise), block smoothing on
  progressive files whose refinement stops early.
- PNG: the IDAT stream is inflated here with ``zlib`` and unfiltered in
  C++; every colour type and depth (1-16 bits), Adam7 interlacing, tRNS;
  Pillow's 16-bit gray is ``I;16`` (clipped to 255), its other 16-bit
  types and all of cv2's take the high byte.
- GIF: frame 0 (LZW in C++), the local or global table, interlaced rows,
  the transparency index; the screen grown to hold the frame.
- BMP: core, INFO, V4 and V5 headers; 1/4/8-bit palettes, 16/24/32 bits,
  BITFIELDS, RLE4 and RLE8 (Pillow's decoder, quirks and all), bottom-up
  and top-down.  cv2's view reads the uncompressed INFO / V4 / V5 layouts
  and raises ``UnsupportedImage`` on RLE, BITFIELDS and core-header BMPs
  and on GIFs without a colour table.

Still raising ``UnsupportedImage`` naming the form (ROADMAP.md §1 item 8):
TIFF, WebP, ICO, and arithmetic-coded, lossless, hierarchical, 12-bit and
YCCK JPEG.  Bytes that no decoder can read (truncated, bad markers, bad
zlib, LZW or Huffman data, an unknown format) raise ``CorruptImage``, an
``OSError`` like Pillow's, which ``LmdbDataset`` turns into its dummy crop.

Each call goes into the host library ``csrc/imagecodec.cpp`` (built with
``g++`` at first use into ``build/mrn_tpu_torch/``); ``resize(rgba,
size)`` is Pillow's bicubic resize (through premultiplied RGBa), a crop
already at ``size`` returned as it is; ``to_rgba(array)`` is
``PIL.Image.fromarray(array).convert("RGBA")``; ``encode_png(array)``
writes a gray, RGB or RGBA PNG (colour type 0, 2 or 6, as given).
``data.image_ref`` holds the first forms' decoder (8-bit PNG, baseline
4:4:4 / 4:2:2 / 4:2:0 JPEG) and the resize in numpy, for the tests.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np

from mrn_tpu_torch.data import _host_build

__all__ = ["CorruptImage", "IMREAD_COLOR", "IMREAD_UNCHANGED", "PngHeader", "UnsupportedImage",
           "decode", "encode_png", "image_format", "imdecode", "imread", "parse_png", "resize",
           "to_rgba"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "imagecodec.cpp"
# the bicubic coefficients are doubles: no fused multiply-add, as Pillow's build
FLAGS = ("-ffp-contract=off",)
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_OTHER_FORMATS = ((b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"\x00\x00\x01\x00", "ICO"))
_ERRLEN = 256
# cv2's imread flags, the two the tools use
IMREAD_COLOR = 1
IMREAD_UNCHANGED = -1


class CorruptImage(OSError):
    """Bytes that no decoder can read (Pillow raises an ``OSError`` too)."""


class UnsupportedImage(ValueError):
    """A valid image of a form the port does not decode."""


def _lib() -> ctypes.CDLL:
    lib = _host_build.load("imagecodec", SOURCE, FLAGS)
    if not getattr(lib, "_typed", False):
        i, p, sz, buf = ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p
        ip = ctypes.POINTER(ctypes.c_int)
        lib.ic_jpeg_info.argtypes = [buf, sz, ip, ip, ip, buf, i]
        lib.ic_jpeg_decode.argtypes = [buf, sz, i, i, p, buf, i]
        lib.ic_jpeg_samples.argtypes = [buf, sz, p, buf, i]
        lib.ic_png_decode.argtypes = [buf, sz, i, i, i, i, i, buf, i, buf, i, i, i, p, buf, i]
        lib.ic_png_samples.argtypes = [buf, sz, i, i, i, i, i, p, buf, i]
        lib.ic_gif_lzw.argtypes = [buf, sz, i, sz, p, ctypes.POINTER(sz), buf, i]
        lib.ic_resize_rgba.argtypes = [p, i, i, i, i, p]
        for fn in (lib.ic_jpeg_info, lib.ic_jpeg_decode, lib.ic_jpeg_samples, lib.ic_png_decode,
                   lib.ic_png_samples, lib.ic_gif_lzw, lib.ic_resize_rgba):
            fn.restype = i
        lib._typed = True
    return lib


def _where(key: Optional[str]) -> str:
    return f"{key}: " if key is not None else ""


def _unsupported(form: str, key: Optional[str]) -> UnsupportedImage:
    return UnsupportedImage(f"{_where(key)}{form} is not decoded by the port (ROADMAP.md §1 "
                            "item 8)")


def _raise(rc: int, err, key: Optional[str]) -> None:
    if rc == 0:
        return
    msg = err.value.decode(errors="replace")
    if rc == 2:
        raise _unsupported(msg, key)
    raise CorruptImage(f"{_where(key)}cannot decode the image: {msg}")


class PngHeader(NamedTuple):
    width: int
    height: int
    depth: int
    color_type: int
    plte: bytes
    trns: bytes
    raw: bytes      # the inflated, still filtered image rows
    interlace: int = 0
    exif: bytes = b""


def image_format(buf: bytes) -> str:
    """"png", "jpeg", "gif", "bmp", the name of another format Pillow
    reads, or "unknown"."""
    if buf.startswith(PNG_MAGIC):
        return "png"
    if buf[:3] == b"\xff\xd8\xff":
        return "jpeg"
    if buf[:6] in (b"GIF87a", b"GIF89a"):
        return "gif"
    if buf[:2] == b"BM":
        return "bmp"
    if buf[:4] == b"RIFF" and buf[8:12] == b"WEBP":
        return "WebP"
    for magic, name in _OTHER_FORMATS:
        if buf.startswith(magic):
            return name
    return "unknown"


# --------------------------------------------------------------------- PNG
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def parse_png(buf: bytes, key: Optional[str] = None) -> PngHeader:
    """The header fields, PLTE, tRNS, eXIf and the inflated IDAT stream of
    a PNG; raises as ``decode`` does."""
    where = _where(key)
    pos, ihdr, plte, trns, exif, idat = 8, None, b"", b"", b"", []
    while pos + 8 <= len(buf):
        length, ctype = struct.unpack(">I4s", buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + length]
        crc = buf[pos + 8 + length:pos + 12 + length]
        if ctype != b"IDAT":
            # Pillow checks the CRCs of the chunks it reads before the image data
            if len(data) < length or len(crc) < 4 or \
                    zlib.crc32(data, zlib.crc32(ctype)) != struct.unpack(">I", crc)[0]:
                raise CorruptImage(f"{where}broken PNG chunk {ctype!r}")
        if ihdr is None and ctype != b"IHDR":
            raise CorruptImage(f"{where}PNG without IHDR")
        if ctype == b"IHDR":
            if length != 13:
                raise CorruptImage(f"{where}bad PNG IHDR")
            ihdr = struct.unpack(">IIBBBBB", data)
        elif ctype == b"PLTE":
            plte = data
        elif ctype == b"tRNS":
            trns = data
        elif ctype == b"eXIf":
            exif = data
        elif ctype == b"IDAT":
            idat.append(data)
        elif ctype == b"IEND":
            break
        pos += 12 + length
    if ihdr is None:
        raise CorruptImage(f"{where}truncated PNG")
    width, height, depth, color_type, _, _, interlace = ihdr
    if width == 0 or height == 0:
        raise CorruptImage(f"{where}PNG of size {width}x{height}")
    ok = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
    if depth not in ok.get(color_type, ()):
        raise CorruptImage(f"{where}PNG colour type {color_type} at bit depth {depth}")
    if interlace > 1:
        raise CorruptImage(f"{where}PNG interlace method {interlace}")
    if color_type == 3 and not plte:
        raise CorruptImage(f"{where}palette PNG without PLTE")
    if not idat:
        raise CorruptImage(f"{where}truncated PNG (no image data)")
    try:
        raw = zlib.decompressobj().decompress(b"".join(idat))
    except zlib.error as e:
        raise CorruptImage(f"{where}broken PNG data stream: {e}") from None
    return PngHeader(width, height, depth, color_type, plte, trns, raw, interlace, exif)


def _png_samples(png: PngHeader, key: Optional[str]) -> np.ndarray:
    """The unfiltered samples [H, W, channels] uint16 as stored."""
    out = np.empty((png.height, png.width, _PNG_CHANNELS[png.color_type]), np.uint16)
    err = ctypes.create_string_buffer(_ERRLEN)
    _raise(_lib().ic_png_samples(png.raw, len(png.raw), png.width, png.height, png.color_type,
                                 png.depth, png.interlace, out.ctypes.data, err, _ERRLEN),
           err, key)
    return out


# --------------------------------------------------------------------- GIF
class _GifFrame(NamedTuple):
    indices: np.ndarray              # [H, W] uint8 over the (grown) logical screen
    palette: Optional[np.ndarray]    # [n, 3] uint8, or None (gray: the index)
    transparency: Optional[int]
    background: int                  # the screen's background index
    inside: np.ndarray               # [H, W] bool: the pixels the frame gave


def _gif_frame(buf: bytes, key: Optional[str]) -> _GifFrame:
    """Frame 0 as Pillow's GifImagePlugin loads it: the logical screen grown
    to hold the frame, filled with the transparency index (else 0) around
    it, the local table or else the global one."""
    where = _where(key)
    if len(buf) < 13:
        raise CorruptImage(f"{where}truncated GIF")
    sw, sh, flags, background = struct.unpack("<HHBB", buf[6:12])
    pos, global_pal = 13, None
    if flags & 128:
        n = 3 << ((flags & 7) + 1)
        global_pal = buf[pos:pos + n]
        pos += n

    def sub_blocks(p):
        chunks = []
        while p < len(buf) and buf[p]:
            chunks.append(buf[p + 1:p + 1 + buf[p]])
            p += 1 + buf[p]
        return b"".join(chunks), p + 1

    transparency = None
    while True:
        if pos >= len(buf) or buf[pos] == 0x3B:
            raise CorruptImage(f"{where}GIF without an image")
        intro = buf[pos]
        if intro == 0x21:
            label = buf[pos + 1] if pos + 1 < len(buf) else -1
            if label == 0xF9 and pos + 2 < len(buf) and buf[pos + 2] >= 4:
                block = buf[pos + 3:pos + 3 + buf[pos + 2]]
                if len(block) >= 4 and block[0] & 1:
                    transparency = block[3]
            _, pos = sub_blocks(pos + 2)
        elif intro == 0x2C:
            if pos + 10 > len(buf):
                raise CorruptImage(f"{where}truncated GIF")
            x0, y0, w, h, iflags = struct.unpack("<HHHHB", buf[pos + 1:pos + 10])
            pos += 10
            pal = global_pal
            if iflags & 128:
                n = 3 << ((iflags & 7) + 1)
                pal = buf[pos:pos + n]
                pos += n
            if pos >= len(buf):
                raise CorruptImage(f"{where}truncated GIF")
            min_size = buf[pos]
            data, _ = sub_blocks(pos + 1)
            break
        else:   # Pillow skips a byte it does not know
            pos += 1
    width, height = max(sw, x0 + w), max(sh, y0 + h)
    if width == 0 or height == 0:
        raise CorruptImage(f"{where}GIF of size {width}x{height}")
    frame = np.zeros(w * h, np.uint8)
    got = ctypes.c_size_t()
    err = ctypes.create_string_buffer(_ERRLEN)
    if w and h:
        _raise(_lib().ic_gif_lzw(data, len(data), min_size, w * h, frame.ctypes.data,
                                 ctypes.byref(got), err, _ERRLEN), err, key)
    if got.value < w * h:   # Pillow: "image file is truncated"
        raise CorruptImage(f"{where}truncated GIF image data")
    fill = transparency if transparency is not None else 0
    screen = np.full((height, width), fill, np.uint8)
    inside = np.zeros((height, width), bool)
    rows = np.arange(h)
    if iflags & 64:   # interlaced: stored rows 0::8, 4::8, 2::4, 1::2
        rows = np.concatenate([rows[0::8], rows[4::8], rows[2::4], rows[1::2]])
    screen[y0 + rows, x0:x0 + w] = frame.reshape(h, w)
    inside[y0:y0 + h, x0:x0 + w] = True
    palette = None
    if pal:
        palette = np.frombuffer(pal, np.uint8)[:len(pal) // 3 * 3].reshape(-1, 3)
    return _GifFrame(screen, palette, transparency, background, inside)


def _palette_rgba(palette: Optional[np.ndarray]) -> np.ndarray:
    """[256, 4] as Pillow holds a palette: its entries, black past them,
    every alpha 255; no palette at all (a GIF without colour tables, mode
    L) is the gray ramp."""
    table = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 4, axis=1)
    table[:, 3] = 255
    if palette is not None:
        n = min(len(palette), 256)
        table[:, :3] = 0
        table[:n, :3] = palette[:n]
    return table


def _gif_rgba(buf: bytes, key: Optional[str]) -> np.ndarray:
    f = _gif_frame(buf, key)
    table = _palette_rgba(f.palette)
    if f.transparency is not None:
        table[f.transparency, 3] = 0
    return table[f.indices]


# --------------------------------------------------------------------- BMP
_BMP_MASKS = {   # BmpImagePlugin's BITFIELDS layouts: (bits, masks) -> raw mode
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
_BMP_RAW = {1: "P;1", 4: "P;4", 8: "P", 16: "BGR;15", 24: "BGR", 32: "BGRX"}


class _Bmp(NamedTuple):
    width: int
    height: int
    bits: int
    header: int
    compression: int
    rawmode: str         # Pillow's raw mode of the pixel rows
    palette: Optional[np.ndarray]   # [n, 3] RGB for 1/4/8 bits
    pixels: np.ndarray   # [H, W] indices or [H, W, 4] RGBA, top row first


def _bmp_rle(buf: bytes, pos: int, w: int, h: int, rle4: bool) -> bytes:
    """BmpImagePlugin's BmpRleDecoder, quirks and all: rows as stored
    (bottom first), padded with index 0."""
    data = bytearray()
    x, n, end = 0, w * h, len(buf)
    while len(data) < n:
        if pos + 2 > end:
            break
        count, byte = buf[pos], buf[pos + 1]
        pos += 2
        if count:
            count = min(count, max(0, w - x)) if x + count > w else count
            if rle4:
                pair = (byte >> 4, byte & 15)
                data += bytes(pair[i % 2] for i in range(count))
            else:
                data += bytes([byte]) * count
            x += count
        elif byte == 0:
            data += b"\x00" * (-len(data) % w)
            x = 0
        elif byte == 1:
            break
        elif byte == 2:   # delta: Pillow reads two bytes, then the two after them
            if pos + 2 > end:
                break
            pos += 2
            right, up = buf[pos:pos + 2] if pos + 2 <= end else (None, None)
            if right is None:
                raise CorruptImage("truncated BMP RLE delta")
            pos += 2
            data += b"\x00" * (right + up * w)
            x = len(data) % w
        else:
            want = byte // 2 if rle4 else byte
            got = buf[pos:pos + want]
            pos += len(got)
            if rle4:
                for b in got:
                    data += bytes((b >> 4, b & 15))
            else:
                data += got
            if len(got) < want:
                break
            x += byte
            if pos % 2:
                pos += 1
    if len(data) < n:
        raise CorruptImage("not enough BMP image data")
    return bytes(data[:n])


def _bmp(buf: bytes, key: Optional[str]) -> _Bmp:
    """A BMP as Pillow's BmpImagePlugin reads it."""
    where = _where(key)

    def u32(p):
        if p + 4 > len(buf):
            raise CorruptImage(f"{where}truncated BMP")
        return struct.unpack_from("<I", buf, p)[0]

    def u16(p):
        if p + 2 > len(buf):
            raise CorruptImage(f"{where}truncated BMP")
        return struct.unpack_from("<H", buf, p)[0]

    offset, hsize = u32(10), u32(14)
    if 14 + hsize > len(buf):
        raise CorruptImage(f"{where}truncated BMP header")
    pos, bottom_up = 18, True
    if hsize == 12:
        w, h, bits, comp, colors, padding = u16(18), u16(20), u16(24), 0, 0, 3
    elif hsize in (40, 52, 56, 64, 108, 124):
        w, height_raw = u32(18), u32(22)
        bottom_up = buf[25] != 0xFF
        h = height_raw if bottom_up else 2 ** 32 - height_raw
        bits, comp, colors, padding = u16(28), u32(30), u32(46), 4
    else:
        raise CorruptImage(f"{where}BMP header of {hsize} bytes")
    pos = 14 + hsize
    masks = None
    if comp == 3:   # BI_BITFIELDS
        if hsize - 4 >= 48:
            masks = tuple(u32(18 + 36 + 4 * i) for i in range(4 if hsize - 4 >= 52 else 3))
            if len(masks) == 3:
                masks += (0,)
        else:
            masks = tuple(u32(pos + 4 * i) for i in range(3)) + (0,)
            pos += 12
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits not in _BMP_RAW:
        raise CorruptImage(f"{where}BMP pixel depth {bits}")
    if w <= 0 or h <= 0 or w > 1 << 16 or h > 1 << 16:
        raise CorruptImage(f"{where}BMP of size {w}x{h}")
    rawmode, rle = _BMP_RAW[bits], False
    if comp == 3:
        if bits == 32 and masks in {m for (b, m) in _BMP_MASKS if b == 32}:
            rawmode = _BMP_MASKS[(32, masks)]
        elif bits in (24, 16) and (bits, masks[:3]) in _BMP_MASKS:
            rawmode = _BMP_MASKS[(bits, masks[:3])]
        else:
            raise CorruptImage(f"{where}unsupported BMP bitfields layout")
    elif comp in (1, 2):
        rle = True
    elif comp != 0:
        raise CorruptImage(f"{where}unsupported BMP compression {comp}")
    palette = None
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise CorruptImage(f"{where}BMP palette of {colors} colours")
        raw = buf[pos:pos + padding * colors]
        ent = np.frombuffer(raw[:len(raw) // padding * padding], np.uint8).reshape(-1, padding)
        palette = np.ascontiguousarray(ent[:, 2::-1])   # BGR(X) -> RGB
    if rle:
        if bits not in (4, 8) or (comp == 1) != (bits == 8):
            raise CorruptImage(f"{where}BMP RLE at {bits} bits")
        rows = np.frombuffer(_bmp_rle(buf, offset, w, h, comp == 2), np.uint8).reshape(h, w)
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        if offset + stride * h > len(buf):
            raise CorruptImage(f"{where}not enough BMP image data")
        rows = np.frombuffer(buf, np.uint8, stride * h, offset).reshape(h, stride)
        if bits < 8:
            rows = np.unpackbits(rows, axis=1)
            if bits == 4:
                rows = rows.reshape(h, -1, 4) @ np.array([8, 4, 2, 1], np.uint8)
            rows = rows[:, :w]
        else:
            rows = _bmp_unpack(rows[:, :w * bits // 8], rawmode, w)
    if bottom_up:
        rows = rows[::-1]
    return _Bmp(w, h, bits, hsize, comp, rawmode, palette, np.ascontiguousarray(rows))


def _bmp_unpack(rows: np.ndarray, rawmode: str, w: int) -> np.ndarray:
    """Pillow's unpacker of ``rawmode``: [H, W] indices for "P", else
    [H, W, 4] RGBA (alpha 255 unless the raw mode has one)."""
    h = rows.shape[0]
    if rawmode == "P":
        return rows
    out = np.full((h, w, 4), 255, np.uint8)
    if rawmode in ("BGR;15", "BGR;16"):
        px = rows.reshape(h, w, 2).astype(np.uint32)
        px = px[:, :, 0] | (px[:, :, 1] << 8)
        gbits = 6 if rawmode == "BGR;16" else 5
        out[:, :, 2] = (px & 31) * 255 // 31
        out[:, :, 1] = ((px >> 5) & ((1 << gbits) - 1)) * 255 // ((1 << gbits) - 1)
        out[:, :, 0] = ((px >> (5 + gbits)) & 31) * 255 // 31
        return out
    px = rows.reshape(h, w, len(rawmode))
    for i, band in enumerate(rawmode):
        if band in "RGBA":
            out[:, :, "RGBA".index(band)] = px[:, :, i]
    return out


def _bmp_rgba(buf: bytes, key: Optional[str]) -> np.ndarray:
    b = _bmp(buf, key)
    if b.pixels.ndim == 3:
        return b.pixels
    return _palette_rgba(b.palette)[b.pixels]


# -------------------------------------------------------------- Pillow's view
def _check_size(size: Tuple[int, int]) -> Tuple[int, int]:
    w, h = (int(v) for v in size)
    if w < 1 or h < 1:
        raise ValueError(f"output size (W, H) must be positive, not {size}")
    return w, h


def _jpeg_shape(buf: bytes, key: Optional[str]) -> Tuple[int, int, int]:
    cw, ch, cn = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERRLEN)
    _raise(_lib().ic_jpeg_info(buf, len(buf), ctypes.byref(cw), ctypes.byref(ch),
                               ctypes.byref(cn), err, _ERRLEN), err, key)
    return ch.value, cw.value, cn.value


def decode(buf: bytes, size: Optional[Tuple[int, int]] = None,
           key: Optional[str] = None) -> np.ndarray:
    """RGBA uint8 ``[H, W, 4]`` of a PNG, JPEG, GIF or BMP as Pillow's
    ``Image.open(b).convert("RGBA")`` gives it, resized to ``size = (W,
    H)`` (Pillow's bicubic) unless ``size`` is None; ``key`` names the crop
    in errors."""
    buf = bytes(buf)
    if size is not None:
        size = _check_size(size)
    fmt = image_format(buf)
    lib = _lib()
    err = ctypes.create_string_buffer(_ERRLEN)
    if fmt == "png":
        png = parse_png(buf, key)
        w, h = size or (png.width, png.height)
        out = np.empty((h, w, 4), np.uint8)
        rc = lib.ic_png_decode(png.raw, len(png.raw), png.width, png.height, png.color_type,
                               png.depth, png.interlace, png.plte, len(png.plte) // 3,
                               png.trns, len(png.trns), h, w, out.ctypes.data, err, _ERRLEN)
        _raise(rc, err, key)
        return out
    if fmt == "jpeg":
        if size is None:
            h, w, _ = _jpeg_shape(buf, key)
            size = (w, h)
        w, h = size
        out = np.empty((h, w, 4), np.uint8)
        _raise(lib.ic_jpeg_decode(buf, len(buf), h, w, out.ctypes.data, err, _ERRLEN),
               err, key)
        return out
    if fmt in ("gif", "bmp"):
        rgba = _gif_rgba(buf, key) if fmt == "gif" else _bmp_rgba(buf, key)
        return rgba if size is None else resize(rgba, size)
    if fmt == "unknown":
        raise CorruptImage(f"{_where(key)}cannot identify the image format")
    raise _unsupported(f"{fmt} images", key)


# ----------------------------------------------------------------- cv2's view
def _exif_orientation(tiff: bytes) -> int:
    """Tag 0x0112 of IFD0 of a TIFF-structured EXIF block, or 1."""
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    ifd = struct.unpack_from(e + "I", tiff, 4)[0]
    if ifd + 2 > len(tiff):
        return 1
    for i in range(struct.unpack_from(e + "H", tiff, ifd)[0]):
        at = ifd + 2 + 12 * i
        if at + 12 > len(tiff):
            break
        tag, typ = struct.unpack_from(e + "HH", tiff, at)
        if tag == 0x0112 and typ == 3:
            return struct.unpack_from(e + "H", tiff, at + 8)[0]
    return 1


def _jpeg_exif(buf: bytes) -> bytes:
    """The TIFF block of the JPEG's first APP1 "Exif" segment, or b""."""
    pos = 2
    while pos + 4 <= len(buf) and buf[pos] == 0xFF:
        marker, length = buf[pos + 1], struct.unpack_from(">H", buf, pos + 2)[0]
        if marker in (0xDA, 0xD9):
            break
        if marker == 0xE1 and buf[pos + 4:pos + 10] == b"Exif\x00\x00":
            return buf[pos + 10:pos + 2 + length]
        pos += 2 + length
    return b""


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ExifTransform."""
    if orientation in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def _gray3(g: np.ndarray) -> np.ndarray:
    return np.repeat(g[:, :, None], 3, axis=2)


def _cv_png(buf: bytes, flags: int, key: Optional[str]) -> np.ndarray:
    png = parse_png(buf, key)
    px = _png_samples(png, key)
    ct, depth = png.color_type, png.depth
    if depth < 8:    # libpng's expand of 1/2/4-bit gray scales to 8 bits
        px = px * (255 // ((1 << depth) - 1)) if ct == 0 else px
    if ct == 3:
        table = _palette_rgba(np.frombuffer(png.plte, np.uint8)[:len(png.plte) // 3 * 3]
                              .reshape(-1, 3))
        trns = np.frombuffer(png.trns, np.uint8)[:256]
        table[:len(trns), 3] = trns
        px = table[px[:, :, 0]].astype(np.uint16)
        ct = 6 if png.trns else 2
    unchanged = flags == IMREAD_UNCHANGED
    if unchanged and depth == 16:
        dt, top = np.uint16, px
    else:
        dt, top = np.uint8, px >> 8 if depth == 16 else px
    if ct == 0:
        out = top[:, :, 0] if unchanged else _gray3(top[:, :, 0])
    elif ct == 4:
        g = _gray3(top[:, :, 0])
        out = np.concatenate([g, top[:, :, 1:]], axis=2) if unchanged else g
    else:
        out = top[:, :, 2::-1]
        if ct == 6 and unchanged:
            out = np.concatenate([out, top[:, :, 3:]], axis=2)
        elif ct == 2 and unchanged and len(png.trns) >= 6:
            key16 = np.frombuffer(png.trns[:6], ">u2")
            alpha = np.where((px == key16).all(axis=2), 0, (1 << (16 if dt == np.uint16 else 8)) - 1)
            out = np.concatenate([out, alpha[:, :, None]], axis=2)
    out = np.ascontiguousarray(out.astype(dt))
    if not unchanged and png.exif:
        out = _orient(out, _exif_orientation(png.exif))
    return out


def _cv_jpeg(buf: bytes, flags: int, key: Optional[str]) -> np.ndarray:
    h, w, nc = _jpeg_shape(buf, key)
    px = np.empty((h, w, nc), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    _raise(_lib().ic_jpeg_samples(buf, len(buf), px.ctypes.data, err, _ERRLEN), err, key)
    if nc == 1:
        out = px[:, :, 0] if flags == IMREAD_UNCHANGED else _gray3(px[:, :, 0])
    elif nc == 3:
        out = px[:, :, ::-1]
    else:   # OpenCV's icvCvt_CMYK2BGR_8u_C4C3R on the stored (inverted) CMYK
        k = px[:, :, 3:].astype(np.int32)
        out = (k - (((255 - px[:, :, 2::-1].astype(np.int32)) * k) >> 8)).astype(np.uint8)
    out = np.ascontiguousarray(out)
    if flags != IMREAD_UNCHANGED:
        out = _orient(out, _exif_orientation(_jpeg_exif(buf)))
    return out


def _cv_gif(buf: bytes, flags: int, key: Optional[str]) -> np.ndarray:
    """OpenCV's GIF decoder on frame 0: the canvas and the transparent
    pixels take the background entry's colour; ``IMREAD_UNCHANGED`` adds
    alpha (0 there) when the frame has a transparency index."""
    f = _gif_frame(buf, key)
    if f.palette is None:
        raise _unsupported("GIF without a colour table under cv2's imread", key)
    table = _palette_rgba(f.palette)
    bgra = table[f.indices][:, :, [2, 1, 0, 3]]
    hole = ~f.inside
    if f.transparency is not None:
        hole |= f.indices == f.transparency
    bgra[hole, :3] = table[f.background, 2::-1]
    bgra[:, :, 3] = np.where(hole, 0, 255)
    keep = 4 if flags == IMREAD_UNCHANGED and f.transparency is not None else 3
    return np.ascontiguousarray(bgra[:, :, :keep])


def _cv_bmp(buf: bytes, flags: int, key: Optional[str]) -> np.ndarray:
    """OpenCV's BMP decoder on the uncompressed INFO / V4 / V5 layouts:
    palettes to BGR (one channel under ``IMREAD_UNCHANGED`` when every
    entry is gray), 5-bit channels shifted left by 3, 32 bits as BGR."""
    b = _bmp(buf, key)
    if b.header == 12 or b.compression != 0:
        form = "core-header" if b.header == 12 else ("RLE" if b.compression in (1, 2)
                                                     else "BITFIELDS")
        raise _unsupported(f"{form} BMP under cv2's imread", key)
    if b.bits <= 8:
        table = _palette_rgba(b.palette)
        if flags == IMREAD_UNCHANGED and (table[:, 0] == table[:, 1]).all() and \
                (table[:, 1] == table[:, 2]).all():
            return np.ascontiguousarray(table[b.pixels, 0])
        return np.ascontiguousarray(table[b.pixels, 2::-1])
    if b.bits == 16:
        rgb = b.pixels[:, :, :3] * np.array([31 / 255] * 3)
        return np.ascontiguousarray((np.round(rgb).astype(np.uint8) << 3)[:, :, ::-1])
    return np.ascontiguousarray(b.pixels[:, :, 2::-1])


def imdecode(buf: bytes, flags: int = IMREAD_COLOR, key: Optional[str] = None) -> np.ndarray:
    """``cv2.imdecode(buf, flags)`` for ``IMREAD_COLOR`` (BGR [H, W, 3]
    uint8: EXIF orientation applied, alpha dropped, palette and gray
    expanded, 16 bits to their high byte) and ``IMREAD_UNCHANGED`` (the
    stored channels as cv2 gives them, uint16 for 16-bit PNG, unrotated).
    Bytes no decoder reads raise ``CorruptImage`` (where cv2 gives None)."""
    if flags not in (IMREAD_COLOR, IMREAD_UNCHANGED):
        raise ValueError(f"imdecode flags IMREAD_COLOR or IMREAD_UNCHANGED, not {flags}")
    buf = bytes(buf)
    fmt = image_format(buf)
    if fmt == "png":
        return _cv_png(buf, flags, key)
    if fmt == "jpeg":
        return _cv_jpeg(buf, flags, key)
    if fmt == "gif":
        return _cv_gif(buf, flags, key)
    if fmt == "bmp":
        return _cv_bmp(buf, flags, key)
    if fmt == "unknown":
        raise CorruptImage(f"{_where(key)}cannot identify the image format")
    raise _unsupported(f"{fmt} images", key)


def imread(path: str, flags: int = IMREAD_COLOR) -> Optional[np.ndarray]:
    """``cv2.imread(path, flags)``: None where the file is missing or
    unreadable, as cv2 gives; a form the port does not decode raises."""
    try:
        with open(path, "rb") as f:
            buf = f.read()
    except OSError:
        return None
    try:
        return imdecode(buf, flags, key=path)
    except CorruptImage:
        return None


# ------------------------------------------------------------------ helpers
def to_rgba(image: np.ndarray) -> np.ndarray:
    """``PIL.Image.fromarray(image).convert("RGBA")`` of a uint8 gray
    [H, W], RGB [H, W, 3] or RGBA [H, W, 4] array."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"uint8 crops only, not {image.dtype}")
    if image.ndim == 2:
        image = image[:, :, None]
    if image.ndim != 3 or image.shape[2] not in (1, 3, 4):
        raise ValueError(f"a gray, RGB or RGBA crop, not shape {image.shape}")
    if image.shape[2] == 4:
        return image
    out = np.empty(image.shape[:2] + (4,), np.uint8)
    out[:, :, :3] = image
    out[:, :, 3] = 255
    return out


def resize(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``Image.resize(size, BICUBIC)`` of an RGBA uint8 array (``to_rgba``
    first for gray or RGB), ``size = (W, H)``."""
    image = np.ascontiguousarray(to_rgba(image))
    w, h = _check_size(size)
    if image.shape[:2] == (h, w):
        return image
    if image.shape[0] == 0 or image.shape[1] == 0:
        return np.zeros((h, w, 4), np.uint8)    # Pillow's resize of an empty image
    out = np.empty((h, w, 4), np.uint8)
    _lib().ic_resize_rgba(image.ctypes.data, image.shape[0], image.shape[1], h, w,
                          out.ctypes.data)
    return out


def _chunk(ctype: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + ctype + data
            + struct.pack(">I", zlib.crc32(data, zlib.crc32(ctype))))


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """A PNG of a uint8 gray [H, W] / [H, W, 1] (colour type 0), RGB
    [H, W, 3] (2) or RGBA [H, W, 4] (6) array, every row filter 0."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"uint8 crops only, not {image.dtype}")
    if image.ndim == 2:
        image = image[:, :, None]
    if image.ndim != 3 or image.shape[2] not in (1, 3, 4):
        raise ValueError(f"a gray, RGB or RGBA crop, not shape {image.shape}")
    h, w, c = image.shape
    ctype = {1: 0, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(image).reshape(h, w * c)], axis=1)
    return (PNG_MAGIC + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))
