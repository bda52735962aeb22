"""Images without PIL or cv2: decode PNG, JPEG, GIF, BMP, WebP and TIFF
bytes bit for bit as the JAX package's libraries read them, and resize
them as Pillow's ``Image.resize(BICUBIC)`` does.

Two views of the same decoders:

- ``decode(buf, size, key)``: Pillow's, ``[H, W, 4]`` RGBA uint8 as
  ``PIL.Image.open(b).convert("RGBA")`` gives it (then resized to ``size =
  (W, H)``), what ``LmdbDataset`` and ``RawDataset`` read, as the JAX
  readers do through Pillow.
- ``imdecode(buf, flags)`` / ``imread(path, flags)``: cv2's, for the tools
  (``crop_by_word``, ``create_lmdb.check_image_valid``): ``IMREAD_COLOR`` is BGR ``[H, W, 3]`` with the EXIF
  orientation applied (JPEG APP1, PNG eXIf, the WebP EXIF chunk), alpha
  dropped, palette and gray expanded, 16 bits to their high byte;
  ``IMREAD_UNCHANGED`` is the stored shape, unrotated but for TIFF, as
  cv2 gives it (gray ``[H, W]``, BGRA where there is alpha, uint16 for
  16-bit PNG and TIFF).

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
- WebP (``csrc/webpcodec.cpp``, as libwebp 1.6 runs it; the container
  here, as its demuxer reads it): lossy VP8 key frames through libwebp's
  fancy upsampler, lossless VP8L, ALPH (raw or VP8L, filtered), VP8X with
  EXIF / ICCP / XMP, animations (frame 0 on a transparent canvas).
  Pillow's RGBA mode follows libwebp's ``has_alpha`` (the VP8L header's
  alpha bit, VP8X's flag or an ALPH chunk), cv2's four channels VP8X's
  flag; the demuxer drops an ALPH chunk VP8X does not flag.
- TIFF and BigTIFF (``csrc/tiffcodec.cpp``, as libtiff 4.7 runs it; the
  IFD here): IFD 0 only; strips or tiles, planar or chunky, FillOrder 2;
  none, PackBits, LZW (libtiff's codes and the old LSB-first ones),
  CCITT RLE, RLEW, G3 (1-D and 2-D) and G4 (tif_fax3.c's decoder, its
  leniency included), Deflate and LZMA (inflated here with ``zlib`` /
  ``lzma``), ZSTD (``csrc/zstdcodec.cpp``) and JPEG (the JPEG decoder
  above, tag 347's tables merged in, YCbCr converted within each chunk),
  the horizontal and floating-point predictors; 1-64-bit unsigned,
  signed and float samples, gray, RGB, palette, gray + alpha, CMYK,
  YCbCr (JPEG or subsampled blocks), CIELab, associated and unassociated
  alpha.  Pillow's view takes its mode from Pillow's table (a combination
  it lacks fails, as Pillow's open), unpremultiplies associated alpha,
  clips 16-bit gray and its I and F modes, converts its LAB mode as
  LittleCMS does (within one step a channel), reads uncompressed YCbCr
  raw and applies the Orientation; cv2's goes through libtiff's RGBA
  image (unassociated alpha premultiplied, 16 bits through its table,
  TIFFYCbCrToRGB, the CIELab routines, the askew reads of cut tiles by
  its gray, palette and 4 x 4 YCbCr routines) for 8-bit output and reads
  deeper samples as stored under ``IMREAD_UNCHANGED`` (int8 to float64,
  10-14 bits shifted to 16), the Orientation applied under both flags;
  cv2's libtiff has no LZMA or ZSTD codec.

Every other format Pillow 12.1 or cv2 5.0 identifies is named
(``image_format``) and raises ``UnsupportedImage`` in the view of a
library that reads it (ROADMAP.md §1 item 3): JPEG 2000, AVIF, the PNM
family, TGA, ICO, ..., the TIFF forms not decoded (named as "TIFF
(ThunderScan)": old-style JPEG, SGILog / LogLuv, ThunderScan, WebP) and
arithmetic-coded,
lossless, hierarchical, 12-bit and YCCK JPEG.  Bytes that no decoder can
read (truncated, bad markers, bad zlib, LZW, Huffman or VP8 data, a
format neither library of the view reads) raise ``CorruptImage``, an
``OSError`` like Pillow's, which ``LmdbDataset`` turns into its dummy
crop.

Each call goes into a host library (``csrc/imagecodec.cpp``, and
``csrc/webpcodec.cpp`` for WebP, ``csrc/tiffcodec.cpp`` and
``csrc/zstdcodec.cpp`` for TIFF; built
with ``g++`` at first use into ``build/mrn_tpu_torch/``); ``resize(rgba,
size)`` is Pillow's bicubic resize (through premultiplied RGBa), a crop
already at ``size`` returned as it is; ``to_rgba(array)`` is
``PIL.Image.fromarray(array).convert("RGBA")``; ``encode_png(array)``
writes a gray, RGB or RGBA PNG (colour type 0, 2 or 6, as given).
``data.image_ref`` holds the first forms' decoder (8-bit PNG, baseline
4:4:4 / 4:2:2 / 4:2:0 JPEG) and the resize in numpy, for the tests.
"""

from __future__ import annotations

import ctypes
import functools
import lzma
import re
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
WEBP_SOURCE = SOURCE.with_name("webpcodec.cpp")
# the bicubic coefficients are doubles: no fused multiply-add, as Pillow's build
FLAGS = ("-ffp-contract=off",)
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
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
        lib.ic_jpeg_samples.argtypes = [buf, sz, i, p, buf, i]
        lib.ic_png_decode.argtypes = [buf, sz, i, i, i, i, i, buf, i, buf, i, i, i, p, buf, i]
        lib.ic_png_samples.argtypes = [buf, sz, i, i, i, i, i, p, buf, i]
        lib.ic_gif_lzw.argtypes = [buf, sz, i, sz, p, ctypes.POINTER(sz), buf, i]
        lib.ic_resize_rgba.argtypes = [p, i, i, i, i, p]
        for fn in (lib.ic_jpeg_info, lib.ic_jpeg_decode, lib.ic_jpeg_samples,
                   lib.ic_png_decode, lib.ic_png_samples, lib.ic_gif_lzw, lib.ic_resize_rgba):
            fn.restype = i
        lib._typed = True
    return lib


def _where(key: Optional[str]) -> str:
    return f"{key}: " if key is not None else ""


def _unsupported(form: str, key: Optional[str]) -> UnsupportedImage:
    return UnsupportedImage(f"{_where(key)}{form} is not decoded by the port (ROADMAP.md §1 "
                            "item 3)")


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


# The formats Pillow 12.1 or cv2 5.0 identify and the port does not decode,
# by their leading bytes (Pillow's `_accept` functions and, for the formats
# that have none, the header checks of their `_open`; cv2's
# `checkSignature`).  Pillow's stub formats (BUFR, GRIB, HDF5, MPEG and WMF
# here) are named but load with neither library.
_MAGIC = (
    (b"\x00\x00\x01\x00", "ICO"), (b"\x00\x00\x02\x00", "CUR"), (b"icns", "ICNS"),
    (b"\xffO\xffQ", "JPEG 2000"), (b"\x00\x00\x00\x0cjP  \r\n\x87\n", "JPEG 2000"),
    (b"\x59\xa6\x6a\x95", "Sun raster"), (b"#?RADIANCE", "Radiance HDR"),
    (b"#?RGBE", "Radiance HDR"), (b"8BPS", "PSD"), (b"qoif", "QOI"), (b"DDS ", "DDS"),
    (b"BLP1", "BLP"), (b"BLP2", "BLP"), (b"FTEX", "FTEX"), (b"DanM", "MSP"), (b"LinS", "MSP"),
    (b"\x80\xe8\x00\x00", "PIXAR"), (b"SIMPLE", "FITS"), (b"/* XPM */", "XPM"),
    (b"P7 332", "XV thumbnail"), (b"%!PS", "EPS"), (b"\xc5\xd0\xd3\xc6", "EPS"),
    (b"\x00\x00\x00\x00\x00\x00\x00\x04", "McIDAS"), (b"Image type:", "IM"),
    (b"BUFR", "BUFR"), (b"ZCZC", "BUFR"), (b"\x89HDF\r\n\x1a\n", "HDF5"),
    (b"\x00\x00\x01\xb3", "MPEG"), (b"\xd7\xcd\xc6\x9a\x00\x00", "WMF"),
    (b"\x01\x00\x00\x00", "WMF"),
)
# TIFF and BigTIFF headers (Pillow's PREFIXES: the last two are invalid, and
# Pillow reads them in the first two bytes' byte order)
_TIFF_MAGIC = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+", b"MM*\x00", b"II\x00*")
_PILLOW_READS = frozenset({
    "ICO", "CUR", "ICNS", "JPEG 2000", "Sun raster", "PSD", "QOI", "DDS", "BLP",
    "FTEX", "MSP", "PIXAR", "FITS", "XPM", "XV thumbnail", "EPS", "McIDAS", "IM", "AVIF", "PBM",
    "PGM", "PPM", "PFM", "DCX", "PCX", "SGI", "DIB", "GBR", "FLI", "XBM", "PCD", "SPIDER",
    "IPTC/NAA", "IM Tools", "TGA"})
_CV2_READS = frozenset({"JPEG 2000", "Sun raster", "Radiance HDR", "AVIF",
                        "PBM", "PGM", "PPM", "PFM", "color PFM", "PAM"})
_WS = b" \t\n\r\x0b\x0c"
_PNM = {b"P1": "PBM", b"P4": "PBM", b"P2": "PGM", b"P5": "PGM", b"P3": "PPM", b"P6": "PPM",
        b"P0CMYK": "PPM", b"PyP": "PPM", b"PyRGBA": "PPM", b"PyCMYK": "PPM", b"Pf": "PFM",
        b"PF": "color PFM", b"P7": "PAM"}
_XBM = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+[0-9]+[\r\n]+#define[ \t]+.*_height[ \t]+[0-9]+[\r\n]+")
_SGI_MODES = {(1, 1, 1), (1, 2, 1), (2, 1, 1), (2, 2, 1), (1, 3, 3), (2, 3, 3), (1, 3, 4),
              (2, 3, 4)}


def _u16(buf: bytes, at: int, e: str = "<") -> int:
    return struct.unpack_from(e + "H", buf, at)[0]


def _u32(buf: bytes, at: int, e: str = "<") -> int:
    return struct.unpack_from(e + "I", buf, at)[0]


def _is_avif(buf: bytes) -> bool:
    """An ISO-BMFF ftyp box naming AVIF (Pillow: the major brand; cv2:
    any compatible brand)."""
    if buf[4:8] != b"ftyp" or len(buf) < 16:
        return False
    size = min(_u32(buf, 0, ">"), len(buf))
    brands = {buf[8:12]} | {buf[i:i + 4] for i in range(16, size - 3, 4)}
    return buf[8:12] in (b"avif", b"avis", b"mif1", b"msf1") or bool(brands & {b"avif", b"avis"})


def _is_spider(buf: bytes) -> bool:
    """SpiderImagePlugin's isSpiderHeader on the 27 leading floats."""
    if len(buf) < 27 * 4:
        return False
    for e in (">", "<"):
        h = (99.0,) + struct.unpack_from(e + "27f", buf)
        if not all(abs(h[i]) < 1e9 and h[i] == int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
            continue
        if int(h[5]) in (1, 3, -11, -12, -21, -22) and \
                int(h[22]) == int(h[13]) * int(h[23]) and int(h[22]) != 0:
            return True
    return False


def _is_iptc(buf: bytes) -> bool:
    """IptcImagePlugin: fields 0x1C <record> <tag> <size> up to (8, 10),
    with the layers and the size among them."""
    pos, tags = 0, set()
    while pos + 5 <= len(buf) and buf[pos:pos + 5].strip(b"\x00"):
        if buf[pos] != 0x1C or buf[pos + 1] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
            return False
        tag, size = (buf[pos + 1], buf[pos + 2]), buf[pos + 3]
        if tag == (8, 10):
            break
        if size >= 128:
            return False
        size = _u16(buf, pos + 3, ">")
        tags.add(tag)
        pos += 5 + size
    return {(3, 60), (3, 20), (3, 30)} <= tags


def _is_imt(buf: bytes) -> bool:
    """ImtImagePlugin: "key value" lines with a width and a height, then a
    form feed."""
    head = buf.split(b"\x0c", 1)
    if len(head) < 2 or b"\n" not in buf[:100]:
        return False
    size = {}
    for line in head[0].split(b"\n"):
        if line.startswith(b"*") or not line:
            continue
        key, _, value = line.partition(b" ")
        if key in (b"width", b"height") and value.strip().isdigit():
            size[key] = int(value)
    return size.get(b"width", 0) > 0 and size.get(b"height", 0) > 0


def _weak_format(buf: bytes) -> Optional[str]:
    """The formats without a magic number of their own: Pillow's header
    checks."""
    n = len(buf)
    if n >= 16 and _u32(buf, 0) in (12, 40, 52, 56, 64, 108, 124):   # a BMP without its file header
        if _u32(buf, 0) == 12:
            w, h, bits = _u16(buf, 4), _u16(buf, 6), _u16(buf, 10)
        else:
            w, h, bits = struct.unpack_from("<ii", buf, 4) + (_u16(buf, 14),)
        if w > 0 and h != 0 and bits in (1, 4, 8, 16, 24, 32):
            return "DIB"
    if n >= 4 and _u32(buf, 0) == 0x3ADE68B1:
        return "DCX"
    if n >= 68 and buf[0] == 10 and buf[1] in (0, 2, 3, 5):
        x0, y0, x1, y1 = (_u16(buf, i) for i in (4, 6, 8, 10))
        bits, planes = buf[3], buf[65]
        if x1 + 1 > x0 and y1 + 1 > y0 and ((bits, planes) in ((1, 1), (1, 2), (1, 4)) or
                                            (buf[1] == 5 and bits == 8 and planes in (1, 3))):
            return "PCX"
    if n >= 12 and _u16(buf, 0, ">") == 474 and buf[2] in (0, 1) and \
            (buf[3], _u16(buf, 4, ">"), _u16(buf, 10, ">")) in _SGI_MODES:
        return "SGI"
    if n >= 16 and _u16(buf, 4) in (0xAF11, 0xAF12) and _u16(buf, 14) in (0, 3):
        return "FLI"
    if n >= 20 and _u32(buf, 0, ">") >= 20 and _u32(buf, 4, ">") in (1, 2):
        w, h, depth = (_u32(buf, i, ">") for i in (8, 12, 16))
        if 0 < w < 1 << 31 and 0 < h < 1 << 31 and depth in (1, 4) and \
                (_u32(buf, 4, ">") == 1 or buf[24:28] == b"GIMP"):
            return "GBR"
    if _XBM.match(buf[:512]):
        return "XBM"
    if n >= 2052 and buf[2048:2052] == b"PCD_":
        return "PCD"
    if _is_spider(buf):
        return "SPIDER"
    if _is_iptc(buf):
        return "IPTC/NAA"
    if _is_imt(buf):
        return "IM Tools"
    if n >= 18 and buf[1] in (0, 1) and buf[2] in (1, 2, 3, 9, 10, 11) and \
            _u16(buf, 12) > 0 and _u16(buf, 14) > 0 and buf[16] in (1, 8, 16, 24, 32):
        return "TGA"
    return None


def image_format(buf: bytes) -> str:
    """"png", "jpeg", "gif", "bmp", "webp", "tiff" (the forms decoded
    here), the name of another format Pillow or cv2 identifies (a TIFF form
    not decoded as "TIFF (ThunderScan)"), or "unknown"."""
    if buf.startswith(PNG_MAGIC):
        return "png"
    if buf[:3] == b"\xff\xd8\xff":
        return "jpeg"
    if buf[:6] in (b"GIF87a", b"GIF89a"):
        return "gif"
    if buf[:2] == b"BM":
        return "bmp"
    if buf[:4] == b"RIFF" and buf[8:12] == b"WEBP":
        return "webp"
    if buf[:4] in _TIFF_MAGIC:
        return _tiff_name(buf)
    for magic, name in _MAGIC:
        if buf.startswith(magic) and (name not in ("ICO", "CUR") or buf[4:6] != b"\x00\x00"):
            return name    # an icon directory of no entries is a TGA's header
    if _is_avif(buf):
        return "AVIF"
    if buf[:1] == b"P":
        token = buf[:7].split(None, 1)[0] if buf[:7].strip() else b""
        if token in _PNM and len(buf) > len(token) and buf[len(token)] in _WS:
            return _PNM[token]
    return _weak_format(buf) or "unknown"


def _unreadable(fmt: str, view: str, key: Optional[str]) -> Exception:
    """The error for a format the decoders here do not read: UnsupportedImage
    where the library of this view reads it, else CorruptImage."""
    if fmt in (_PILLOW_READS if view == "Pillow" else _CV2_READS):
        return _unsupported(f"{fmt} images", key)
    if fmt == "unknown":
        return CorruptImage(f"{_where(key)}cannot identify the image format")
    return CorruptImage(f"{_where(key)}{fmt} images are not read by {view}")


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


# -------------------------------------------------------------------- WebP
_WEBP_ALPHA, _WEBP_ANIMATION, _WEBP_EXIF, _WEBP_FLAGS = 0x10, 0x02, 0x08, 0x3E


def _webp_lib() -> ctypes.CDLL:
    lib = _host_build.load("webpcodec", WEBP_SOURCE)
    if not getattr(lib, "_typed", False):
        i, p, sz, buf = ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p
        ip = ctypes.POINTER(ctypes.c_int)
        lib.wp_vp8_info.argtypes = [buf, sz, ip, ip, buf, i]
        lib.wp_vp8_decode.argtypes = [buf, sz, i, i, p, buf, i]
        lib.wp_vp8l_info.argtypes = [buf, sz, ip, ip, ip, buf, i]
        lib.wp_vp8l_decode.argtypes = [buf, sz, i, i, p, buf, i]
        lib.wp_alpha_decode.argtypes = [buf, sz, i, i, p, buf, i]
        for fn in (lib.wp_vp8_info, lib.wp_vp8_decode, lib.wp_vp8l_info, lib.wp_vp8l_decode,
                   lib.wp_alpha_decode):
            fn.restype = i
        lib._typed = True
    return lib


class _WebPFrame(NamedTuple):
    image: bytes            # the VP8 or VP8L payload
    lossless: bool
    alph: Optional[bytes]   # the ALPH payload the demuxer keeps, or None
    width: int              # the bitstream's own size
    height: int
    alpha_hint: bool        # WebPGetFeatures' has_alpha of the bitstream


class _WebP(NamedTuple):
    width: int              # the canvas
    height: int
    frame: _WebPFrame       # frame 0
    x: int                  # its offset on the canvas
    y: int
    pil_alpha: bool         # WebPGetFeatures' has_alpha: Pillow's RGBA mode
    cv_alpha: bool          # the demuxer's alpha flag: cv2's four channels
    exif: bytes             # the first EXIF chunk where VP8X flags one


def _webp_chunks(buf: bytes, start: int, end: int, where: str) -> list:
    """(fourcc, payload) of the RIFF chunks in buf[start:end], each padded
    to an even size as the demuxer reads them."""
    out, pos = [], start
    while pos < end:
        if pos + 8 > end:
            raise CorruptImage(f"{where}truncated WebP chunk header")
        size = struct.unpack_from("<I", buf, pos + 4)[0]
        if pos + 8 + size + (size & 1) > end:
            raise CorruptImage(f"{where}truncated WebP chunk {buf[pos:pos + 4]!r}")
        out.append((buf[pos:pos + 4], buf[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def _webp_frame(chunks: list, where: str, key: Optional[str]) -> Tuple[_WebPFrame, list]:
    """The demuxer's StoreFrame: an optional ALPH then VP8 or VP8L; the
    chunks after them."""
    alph = None
    n = 0
    if n < len(chunks) and chunks[n][0] == b"ALPH":
        alph = chunks[n][1]
        n += 1
    if n >= len(chunks) or chunks[n][0] not in (b"VP8 ", b"VP8L"):
        raise CorruptImage(f"{where}WebP frame without image data")
    fourcc, data = chunks[n]
    lossless = fourcc == b"VP8L"
    if lossless and alph is not None:
        raise CorruptImage(f"{where}WebP ALPH chunk before a lossless image")
    lib = _webp_lib()
    w, h, a = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERRLEN)
    if lossless:
        rc = lib.wp_vp8l_info(data, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(a),
                              err, _ERRLEN)
    else:
        rc = lib.wp_vp8_info(data, len(data), ctypes.byref(w), ctypes.byref(h), err, _ERRLEN)
    _raise(rc, err, key)
    hint = bool(a.value) if lossless else alph is not None
    return _WebPFrame(data, lossless, alph, w.value, h.value, hint), chunks[n + 1:]


def _webp(buf: bytes, key: Optional[str]) -> _WebP:
    """A WebP file as libwebp's demuxer reads it (the RIFF size bounds it;
    the bytes after it are ignored): the simple VP8 / VP8L forms, VP8X with
    ALPH, EXIF, ICCP and XMP, and animations (frame 0 on its canvas)."""
    where = _where(key)
    if len(buf) < 20:
        raise CorruptImage(f"{where}truncated WebP")
    riff_size = struct.unpack_from("<I", buf, 4)[0]
    if riff_size < 12 or riff_size + 8 > len(buf):
        raise CorruptImage(f"{where}truncated WebP (RIFF size {riff_size})")
    chunks = _webp_chunks(buf, 12, riff_size + 8, where)
    first = chunks[0][0]
    if first in (b"VP8 ", b"VP8L"):
        frame, _ = _webp_frame(chunks, where, key)
        return _WebP(frame.width, frame.height, frame, 0, 0, frame.alpha_hint, frame.alpha_hint,
                     b"")
    if first != b"VP8X" or len(chunks[0][1]) < 10:
        raise CorruptImage(f"{where}not a WebP image (first chunk {first!r})")
    vp8x = chunks[0][1]
    flags = struct.unpack_from("<I", vp8x)[0]
    width = 1 + int.from_bytes(vp8x[4:7], "little")
    height = 1 + int.from_bytes(vp8x[7:10], "little")
    if flags & ~_WEBP_FLAGS or width * height >= 1 << 32:
        raise CorruptImage(f"{where}bad WebP VP8X header")
    exif = next((d for c, d in chunks if c == b"EXIF"), b"") if flags & _WEBP_EXIF else b""
    alpha = bool(flags & _WEBP_ALPHA)
    body = chunks[1:]
    if not flags & _WEBP_ANIMATION:
        at = next((i for i, (c, _) in enumerate(body) if c in (b"ALPH", b"VP8 ", b"VP8L")), None)
        if at is None:
            raise CorruptImage(f"{where}WebP without image data")
        frame, rest = _webp_frame(body[at:], where, key)
        if any(c in (b"ALPH", b"VP8 ", b"VP8L") for c, _ in rest):
            raise CorruptImage(f"{where}WebP with a second image")
        if (frame.width, frame.height) != (width, height):
            raise CorruptImage(f"{where}WebP image of {frame.width}x{frame.height} on a "
                               f"{width}x{height} canvas")
        pil_alpha = frame.alpha_hint if frame.lossless else alpha or frame.alph is not None
        if not alpha:   # the demuxer drops ALPH where VP8X does not flag alpha
            frame = frame._replace(alph=None)
        return _WebP(width, height, frame, 0, 0, pil_alpha, alpha, exif)
    # an animation: ANIM before the frames; every frame checked, frame 0 shown
    names = [c for c, _ in body]
    if b"ANMF" not in names or b"ANIM" not in names[:names.index(b"ANMF")]:
        raise CorruptImage(f"{where}animated WebP without ANIM before its frames")
    if any(c in (b"ALPH", b"VP8 ", b"VP8L") for c in names):
        raise CorruptImage(f"{where}image data outside the frames of an animated WebP")
    frames = []
    for data in (d for c, d in body if c == b"ANMF"):
        if len(data) < 16:
            raise CorruptImage(f"{where}truncated WebP ANMF chunk")
        x = 2 * int.from_bytes(data[0:3], "little")
        y = 2 * int.from_bytes(data[3:6], "little")
        frame, _ = _webp_frame(_webp_chunks(data, 16, len(data), where), where, key)
        if x + frame.width > width or y + frame.height > height:
            raise CorruptImage(f"{where}WebP frame outside its canvas")
        frames.append((frame, x, y))
    frame, x, y = frames[0]
    return _WebP(width, height, frame, x, y, alpha, alpha, exif)


def _webp_rgba(w: _WebP, key: Optional[str]) -> np.ndarray:
    """The canvas after frame 0, RGBA as libwebp decodes it (WebPAnimDecoder:
    transparent black around the frame, every alpha as stored)."""
    f = w.frame
    lib = _webp_lib()
    err = ctypes.create_string_buffer(_ERRLEN)
    rgba = np.empty((f.height, f.width, 4), np.uint8)
    decode_fn = lib.wp_vp8l_decode if f.lossless else lib.wp_vp8_decode
    _raise(decode_fn(f.image, len(f.image), f.width, f.height, rgba.ctypes.data, err, _ERRLEN),
           err, key)
    if f.alph is not None:
        alpha = np.empty((f.height, f.width), np.uint8)
        _raise(lib.wp_alpha_decode(f.alph, len(f.alph), f.width, f.height, alpha.ctypes.data,
                                   err, _ERRLEN), err, key)
        rgba[:, :, 3] = alpha
    if (w.width, w.height) == (f.width, f.height):
        return rgba
    canvas = np.zeros((w.height, w.width, 4), np.uint8)
    canvas[w.y:w.y + f.height, w.x:w.x + f.width] = rgba
    return canvas


# -------------------------------------------------------------------- TIFF
TIFF_SOURCE = SOURCE.with_name("tiffcodec.cpp")
ZSTD_SOURCE = SOURCE.with_name("zstdcodec.cpp")
_TIFF_NONE, _TIFF_JPEG, _TIFF_LZMA, _TIFF_DEFLATE, _TIFF_ZSTD = 1, 7, 34925, (8, 32946), 50000
# none, CCITT RLE, G3, G4, LZW, JPEG, Deflate, CCITT RLEW, PackBits, Deflate (old
# code), LZMA, ZSTD
_TIFF_DECODED = frozenset({1, 2, 3, 4, 5, 7, 8, 32771, 32773, 32946, 34925, 50000})
_TIFF_FAX = frozenset({2, 3, 4, 32771})
# the codecs libtiff runs the Predictor field with (TIFFPredictorInit)
_TIFF_PREDICTED = frozenset({5, 8, 32946, 34925, 50000})
# the compressions Pillow 12.1 names (TiffImagePlugin.COMPRESSION_INFO)
_TIFF_COMPRESSION = {2: "CCITT RLE", 3: "CCITT G3", 4: "CCITT G4", 6: "old-style JPEG",
                     32771: "CCITT RLEW", 32809: "ThunderScan", 34676: "SGILog",
                     34677: "SGILog24", 50000: "ZSTD", 50001: "WebP"}
# field types: (bytes, struct code)
_TIFF_TYPES = {1: (1, "B"), 2: (1, "B"), 3: (2, "H"), 4: (4, "I"), 5: (8, "II"), 6: (1, "b"),
               7: (1, "B"), 8: (2, "h"), 9: (4, "i"), 10: (8, "ii"), 11: (4, "f"), 12: (8, "d"),
               13: (4, "I"), 16: (8, "Q"), 17: (8, "q"), 18: (8, "Q")}
# the fields read as numbers, and the integer types they may have
_TIFF_NUMERIC = frozenset((256, 257, 258, 259, 262, 266, 273, 274, 277, 278, 279, 284, 317, 320,
                           322, 323, 324, 325, 338, 339))
_TIFF_INTEGER = frozenset((1, 3, 4, 6, 8, 9, 13, 16, 17, 18))


def _zstd_lib() -> ctypes.CDLL:
    lib = _host_build.load("zstdcodec", ZSTD_SOURCE)
    if not getattr(lib, "_typed", False):
        lib.zs_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                  ctypes.c_size_t, ctypes.c_char_p, ctypes.c_int]
        lib.zs_decode.restype = ctypes.c_int
        lib._typed = True
    return lib


def _tiff_lib() -> ctypes.CDLL:
    lib = _host_build.load("tiffcodec", TIFF_SOURCE)
    if not getattr(lib, "_typed", False):
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.tf_decode.argtypes = [ctypes.c_char_p, p, p, p, i, i, i, i, i, i, i, i, i, i, i,
                                  i, i, i, i, i, i, i, i, p, ctypes.c_char_p, i]
        lib.tf_decode.restype = i
        lib._typed = True
    return lib


class _Tiff(NamedTuple):
    order: str               # "<" or ">"
    big: bool                # BigTIFF
    tags: dict               # IFD 0: tag -> tuple of values
    width: int
    height: int
    spp: int
    bps: Tuple[int, ...]     # one per sample
    compression: int
    photometric: int
    planar: int
    fillorder: int
    predictor: int
    extra: Tuple[int, ...]
    sample_format: Tuple[int, ...]
    orientation: int
    ifd_bytes: int = 0       # the header, IFD 0 and its out-of-line values


def _tiff(buf: bytes, key: Optional[str], pillow: bool) -> _Tiff:
    """IFD 0 of a TIFF or BigTIFF as the view's library reads it: Pillow
    takes the byte order from the first two bytes and BigTIFF only where
    the third byte is 43 (so a big-endian BigTIFF reads as a classic TIFF),
    libtiff wants the magic number in the file's byte order."""
    where = _where(key)
    if len(buf) < 8:
        raise CorruptImage(f"{where}truncated TIFF header")
    e = "<" if buf[:2] == b"II" else ">"
    magic = struct.unpack_from(e + "H", buf, 2)[0]
    if pillow:
        big = buf[2] == 43
    elif magic in (42, 43):
        big = magic == 43
    else:
        raise CorruptImage(f"{where}bad TIFF magic number {magic}")
    if big:
        if len(buf) < 16:
            raise CorruptImage(f"{where}truncated BigTIFF header")
        if not pillow and struct.unpack_from(e + "HH", buf, 4) != (8, 0):
            raise CorruptImage(f"{where}bad BigTIFF header")
        at = struct.unpack_from(e + "Q", buf, 8)[0]
        count_fmt, entry, inline, ptr = "Q", 20, 8, "Q"
    else:
        at = struct.unpack_from(e + "I", buf, 4)[0]
        count_fmt, entry, inline, ptr = "H", 12, 4, "I"
    csize = struct.calcsize(count_fmt)
    if at < 8 or at + csize > len(buf):
        raise CorruptImage(f"{where}truncated TIFF (no IFD at {at})")
    n = struct.unpack_from(e + count_fmt, buf, at)[0]
    if at + csize + n * entry > len(buf):
        raise CorruptImage(f"{where}truncated TIFF IFD")
    tags = {}
    ifd_bytes = (16 + 8 + 20 * n + 8) if big else (8 + 2 + 12 * n + 4)
    for k in range(n):
        pos = at + csize + k * entry
        tag, typ = struct.unpack_from(e + "HH", buf, pos)
        count = struct.unpack_from(e + ("Q" if big else "I"), buf, pos + 4)[0]
        if typ in _TIFF_TYPES and _TIFF_TYPES[typ][0] * count > inline:
            ifd_bytes += _TIFF_TYPES[typ][0] * count
        if typ not in _TIFF_TYPES or tag in tags:
            continue
        if tag in _TIFF_NUMERIC and typ not in _TIFF_INTEGER:
            continue   # libtiff ignores a field of the wrong type
        size, code = _TIFF_TYPES[typ]
        total = size * count
        if total <= inline:
            data = buf[pos + 4 + (8 if big else 4):pos + 4 + (8 if big else 4) + total]
        else:
            off = struct.unpack_from(e + ptr, buf, pos + 4 + (8 if big else 4))[0]
            if off + total > len(buf):
                raise CorruptImage(f"{where}truncated TIFF field {tag}")
            data = buf[off:off + total]
        if typ in (2, 7) and tag != 347:
            tags[tag] = (data,)
        elif tag == 347:
            tags[tag] = (bytes(data),)
        elif typ in (5, 10):   # libtiff's float of a rational: num / den in float, 0 / 0 as 0
            v = np.array(struct.unpack(e + code * count, data), np.float32).reshape(-1, 2)
            with np.errstate(divide="ignore", invalid="ignore"):
                tags[tag] = tuple(np.where(v[:, 1] == 0, np.float32(0), v[:, 0] / v[:, 1]))
        else:
            tags[tag] = struct.unpack(e + code * count, data)
    one = lambda t, d: (tags.get(t) or (d,))[0]   # noqa: E731
    if 256 not in tags or 257 not in tags:
        raise CorruptImage(f"{where}TIFF without its dimensions")
    width, height = int(one(256, 0)), int(one(257, 0))
    compression, photometric = int(one(259, 1)), int(one(262, 0))
    spp = int(one(277, 3 if compression == 6 and photometric in (2, 6) else 1))
    bps = tuple(int(v) for v in tags.get(258, (1,)))
    if pillow and not bps:   # Pillow takes an empty BitsPerSample for its default
        bps = (1,)
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) == 1:
        bps = bps * spp
    if not bps:
        raise CorruptImage(f"{where}TIFF of {spp} samples and bits {bps}")
    if 324 in tags and not (tags.get(322) and tags.get(323) and
                            min(tags[322][0], tags[323][0]) > 0):
        raise CorruptImage(f"{where}TIFF tiles without their size")
    sf = tuple(int(v) for v in tags.get(339, (1,)))
    # libtiff reads SampleFormat as one value, or one a sample all alike, and
    # refuses the directory otherwise: cv2's view, and Pillow's where
    # libtiff decodes (every compression but none)
    if not (len(sf) == 1 or len(sf) >= spp > 0 and len(set(sf[:spp])) == 1) and \
            (not pillow or compression != _TIFF_NONE):
        raise CorruptImage(f"{where}TIFF with SampleFormat {sf} for {spp} samples")
    if not pillow:
        sf = sf[:1]
    elif not sf:   # Pillow drops an empty field
        sf = (1,)
    elif len(sf) > 1 and max(sf) == min(sf) == 1:
        sf = (1,)
    return _Tiff(e, big, tags, width, height, spp, bps, compression, photometric,
                 int(one(284, 1)), int(one(266, 1)), int(one(317, 1)),
                 tuple(int(v) for v in tags.get(338, ())), sf, int(one(274, 1)), ifd_bytes)


def _tiff_scope(t: _Tiff) -> Optional[str]:
    """The form of a TIFF the port does not decode, or None."""
    c = t.compression
    if c not in _TIFF_DECODED:
        return _TIFF_COMPRESSION.get(c, f"compression {c}")
    if t.photometric in (32844, 32845):
        return "LogLuv"
    return None


def _tiff_name(buf: bytes) -> str:
    """image_format of a TIFF: "tiff" where the port decodes it (or cannot
    read its IFD), else the form, as "TIFF (ThunderScan)"."""
    try:
        t = _tiff(buf, None, pillow=False)
    except CorruptImage:
        return "tiff"
    form = _tiff_scope(t)
    return "tiff" if form is None else f"{'BigTIFF' if t.big else 'TIFF'} ({form})"


def _tiff_chunks(t: _Tiff, buf: bytes, key: Optional[str]):
    """(tiled, chunk width, chunk height, [chunk bytes as stored], [their
    offsets in the file])."""
    where = _where(key)
    tiled = 324 in t.tags
    if tiled:   # _tiff saw a tile size
        cw, ch = int(t.tags[322][0]), int(t.tags[323][0])
        offs, counts = t.tags.get(324, ()), t.tags.get(325, ())
    else:
        cw, ch = t.width, int((t.tags.get(278) or (2 ** 32 - 1,))[0])
        ch = min(max(ch, 1), t.height) if ch else t.height
        offs, counts = t.tags.get(273, ()), t.tags.get(279, ())
    across = -(-t.width // cw)
    need = across * -(-t.height // ch) * (t.spp if t.planar == 2 else 1)
    if need == 1 and not tiled and len(offs) and offs[0] and len(counts):
        # libtiff's estimate of a bogus count (ByteCountLooksBad,
        # EstimateStripByteCounts): 0 for any codec; uncompressed, past the
        # file or short of the image (Pillow's raw reader reads on too)
        hs, vs = _tiff_subsampling(t)   # TIFFScanlineSize64: YCbCr by blocks
        full = ((-(-t.width // hs) * (hs * vs + 2 if hs * vs > 1 else t.spp) * t.bps[0] + 7)
                // 8 // vs * t.height)
        if counts[0] == 0 and t.compression != _TIFF_NONE:
            counts = (min(max(len(buf) - t.ifd_bytes, 0), max(len(buf) - offs[0], 0)),)
        elif t.compression == _TIFF_NONE and (counts[0] == 0 or counts[0] < full or
                                              counts[0] > len(buf) - offs[0]):
            counts = (full,)
    if len(offs) < need or len(counts) < need:
        raise CorruptImage(f"{where}TIFF with {len(offs)} strips or tiles, not {need}")
    chunks = []
    for off, n in zip(offs[:need], counts[:need]):
        if off < 0 or n < 0 or off + n > len(buf):
            raise CorruptImage(f"{where}truncated TIFF image data")
        chunks.append(buf[off:off + n])
    return tiled, cw, ch, chunks, [int(v) for v in offs[:need]]


def _tiff_samples(t: _Tiff, buf: bytes, key: Optional[str], whole_tiles: bool = False,
                  cv2_read: bool = False) -> np.ndarray:
    """The stored samples [H, W, spp] (uint16 up to 16 bits, uint32 up to
    32, uint64 above; uint8 for JPEG, its YCbCr converted to RGB under
    Photometric 6) as libtiff decodes them; ``whole_tiles``: every tile
    whole, past the image's right and bottom edges, as libtiff's tile
    buffers hold them (JPEG: the image only).  ``cv2_read``: as cv2 drives
    libtiff: a CCITT chunk whose data ends early keeps its rows decoded so
    far and zeros after them (``TIFFReadRGBAStrip`` goes on where Pillow's
    read fails), and chunks are read into libtiff's own buffers (Pillow
    maps the file, so RLEW's word alignment counts from the file's
    offsets)."""
    where = _where(key)
    if t.width <= 0 or t.height <= 0 or t.width * t.height > 1 << 30:   # cv2's pixel cap
        raise CorruptImage(f"{where}TIFF of size {t.width}x{t.height}")
    if len(set(t.bps)) != 1:
        raise CorruptImage(f"{where}TIFF with bits per sample {t.bps}")
    predictor = _tiff_predictor(t, key)
    bps = t.bps[0]
    tiled, cw, ch, chunks, starts = _tiff_chunks(t, buf, key)
    c = t.compression
    # libtiff reverses the bits of FillOrder 2 data before every codec but JPEG's
    if t.fillorder == 2 and c != _TIFF_JPEG:
        chunks = [d.translate(_BIT_REVERSED) for d in chunks]
    if c == _TIFF_JPEG:
        return _tiff_jpeg(t, chunks, tiled, cw, ch, key)
    planes = t.spp if t.planar == 2 else 1
    hs, vs = _tiff_subsampling(t)
    rb = (cw * t.spp // planes * bps + 7) // 8
    if hs * vs > 1:   # rows of blocks: hs x vs Y samples, Cb, Cr
        rb, ch_rows = -(-cw // hs) * (hs * vs + 2), lambda rows: -(-rows // vs)
    else:
        ch_rows = lambda rows: rows   # noqa: E731
    across = -(-t.width // cw)
    method = c
    if c in _TIFF_DEFLATE or c in (_TIFF_LZMA, _TIFF_ZSTD):   # inflated first, to their size
        out = []
        for k, d in enumerate(chunks):
            y0 = k % (len(chunks) // planes) // across * ch
            want = rb * ch_rows(ch if tiled else min(ch, t.height - y0))
            try:
                if c == _TIFF_ZSTD:
                    raw = ctypes.create_string_buffer(want)
                    err = ctypes.create_string_buffer(_ERRLEN)
                    _raise(_zstd_lib().zs_decode(d, len(d), raw, want, err, _ERRLEN), err, key)
                    raw = raw.raw
                elif c == _TIFF_LZMA:
                    raw = lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(d, want)
                else:
                    raw = zlib.decompressobj().decompress(d, want)
            except (zlib.error, lzma.LZMAError) as err:
                raise CorruptImage(f"{where}broken TIFF data stream: {err}") from None
            out.append(raw)
        chunks, method = out, _TIFF_NONE
    data = b"".join(chunks)
    offs = np.cumsum([0] + [len(d) for d in chunks[:-1]]).astype(np.int64)
    lens = np.array([len(d) for d in chunks], np.int64)
    at = np.array(starts, np.int64)
    one = lambda tag, d: (t.tags.get(tag) or (d,))[0]   # noqa: E731
    ow, oh = (across * cw, -(-t.height // ch) * ch) if tiled and whole_tiles else \
        (t.width, t.height)
    samples = np.empty((oh, ow, t.spp), np.uint16 if bps <= 16 else
                       np.uint32 if bps <= 32 else np.uint64)
    err = ctypes.create_string_buffer(_ERRLEN)
    _raise(_tiff_lib().tf_decode(data, offs.ctypes.data, lens.ctypes.data,
                                 None if cv2_read else at.ctypes.data, len(chunks), method,
                                 int(one(292, 0)), int(cv2_read), t.width,
                                 t.height, t.spp, bps, t.planar, int(tiled), cw, ch,
                                 int(t.order == ">"), predictor, hs, vs, ow, oh,
                                 samples.itemsize,
                                 samples.ctypes.data, err, _ERRLEN), err, key)
    return samples


def _ycbcr_sampling(t: _Tiff) -> Tuple[int, int]:
    """YCbCrSubsampling (hs, vs): libtiff's default 2 x 2 where missing."""
    hs, vs = (tuple(int(v) for v in t.tags.get(530, ())) + (2, 2))[:2]
    return hs, vs


def _tiff_subsampling(t: _Tiff) -> Tuple[int, int]:
    """(hs, vs) of chunky 3-sample YCbCr not in JPEG, else (1, 1)."""
    if t.photometric != 6 or t.compression == _TIFF_JPEG or t.planar == 2 or t.spp != 3:
        return 1, 1
    return _ycbcr_sampling(t)


def _ycbcr_samples(t: _Tiff, buf: bytes, key: Optional[str]) -> np.ndarray:
    """The Y, Cb, Cr of every pixel of YCbCr not in JPEG, where libtiff's
    RGBA image reads it: 8 bits, 3 samples, a subsampling it has a routine
    for (chunky; planar only 1 x 1)."""
    hs, vs = _ycbcr_sampling(t)
    if t.bps[0] != 8 or t.spp != 3 or (hs, vs) not in _YCBCR_ROUTINES or \
            t.planar == 2 and (hs, vs) != (1, 1):
        raise CorruptImage(f"{_where(key)}YCbCr TIFF of {t.spp} samples at {t.bps[0]} bits, "
                           f"subsampling {hs} x {vs}, has no libtiff RGBA routine")
    return _tiff_samples(t, buf, key)


# the subsamplings tif_getimage.c has a YCbCr routine for
_YCBCR_ROUTINES = frozenset({(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)})


def _tiff_predictor(t: _Tiff, key: Optional[str]) -> int:
    """The predictor libtiff runs: the field where the codec takes one
    (else 1); one tif_predict.c refuses raises."""
    p = t.predictor if t.compression in _TIFF_PREDICTED else 1
    bps, sf = t.bps[0], t.sample_format[0]
    if p == 2 and bps not in (8, 16, 32, 64) or p == 3 and (sf != 3 or bps not in (16, 24, 32, 64)):
        raise CorruptImage(f"{_where(key)}TIFF predictor {p} at {bps} bits of sample format {sf}")
    return p


_BIT_REVERSED = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def _tiff_jpeg(t: _Tiff, chunks, tiled: bool, cw: int, ch: int,
               key: Optional[str]) -> np.ndarray:
    """JPEG chunks as libtiff reads them: each with the JPEGTables of tag
    347 before its own segments, converted from YCbCr to RGB under
    Photometric 6 (JPEGCOLORMODE_RGB), its components as stored else."""
    where = _where(key)
    if t.bps[0] != 8:
        raise CorruptImage(f"{where}JPEG TIFF at {t.bps[0]} bits")
    tables = t.tags.get(347, (b"",))[0]
    planes = t.spp if t.planar == 2 else 1
    per = t.spp // planes
    ycc = int(t.photometric == 6 and t.planar != 2)
    lib = _lib()
    err = ctypes.create_string_buffer(_ERRLEN)
    out = np.zeros((t.height, t.width, t.spp), np.uint8)
    across, per_plane = -(-t.width // cw), len(chunks) // planes
    for k, d in enumerate(chunks):
        p, idx = divmod(k, per_plane)
        x0, y0 = idx % across * cw, idx // across * ch
        rows = ch if tiled else min(ch, t.height - y0)
        if len(tables) >= 4 and d[:2] == b"\xff\xd8":
            d = tables[:-2] + d[2:]
        h, w, nc = _jpeg_shape(d, key)
        if nc != per or (w, h) != (cw, rows):
            raise CorruptImage(f"{where}JPEG TIFF chunk of {w}x{h}x{nc}, not "
                               f"{cw}x{rows}x{per}")
        px = np.empty((h, w, nc), np.uint8)
        _raise(lib.ic_jpeg_samples(d, len(d), ycc, px.ctypes.data, err, _ERRLEN), err, key)
        vis_w, vis_h = min(cw, t.width - x0), min(rows, t.height - y0)
        out[y0:y0 + vis_h, x0:x0 + vis_w, p * per:(p + 1) * per] = px[:vis_h, :vis_w]
    return out


# Pillow 12.1's TIFF modes (TiffImagePlugin.OPEN_INFO): (byte order,
# photometric, sample format, fill order, bits, extra samples) -> mode.
def _pillow_tiff_modes() -> dict:
    modes = {}
    for o in "<>":
        for fill in (1, 2):
            for photo in (0, 1):
                for b in (1, 2, 4, 8):
                    modes[(o, photo, (1,), fill, (b,), ())] = "1" if b == 1 else "L"
            for b in (1, 2, 4, 8):
                modes[(o, 3, (1,), fill, (b,), ())] = "P"
        modes[(o, 2, (1,), 2, (8, 8, 8), ())] = "RGB"
        modes[(o, 1, (2,), 1, (8,), ())] = "L"
        modes[(o, 1, (1,), 1, (8, 8), (2,))] = "LA"
        for extra, mode in (((), "RGB"), ((0,), "RGBX"), ((1,), "RGBa"), ((2,), "RGBA")):
            bits = (8,) * (3 + len(extra))
            modes[(o, 2, (1,), 1, bits, extra)] = mode
            modes[(o, 2, (1,), 1, (16,) * len(bits), extra)] = mode
            if extra:
                modes[(o, 2, (1,), 1, bits + (8,), extra + (0,))] = mode
                modes[(o, 2, (1,), 1, bits + (8, 8), extra + (0, 0))] = mode
        modes[(o, 2, (1,), 1, (8,) * 4, ())] = "RGBA"
        modes[(o, 2, (1,), 1, (16,) * 4, ())] = "RGBA"
        modes[(o, 2, (1,), 1, (8,) * 4, (999,))] = "RGBA"
        modes[(o, 3, (1,), 1, (8, 8), (0,))] = "PX"
        modes[(o, 3, (1,), 1, (8, 8), (2,))] = "PA"
        modes[(o, 5, (1,), 1, (8,) * 4, ())] = "CMYK"
        modes[(o, 5, (1,), 1, (8,) * 5, (0,))] = "CMYK"
        modes[(o, 5, (1,), 1, (8,) * 6, (0, 0))] = "CMYK"
        modes[(o, 5, (1,), 1, (16,) * 4, ())] = "CMYK"
        modes[(o, 6, (1,), 1, (8,), ())] = "L"
        modes[(o, 6, (1,), 1, (8, 8, 8), ())] = "RGB"
        modes[(o, 8, (1,), 1, (8, 8, 8), ())] = "LAB"
        modes[(o, 1, (2,), 1, (16,), ())] = "I"      # I;16S, I;16BS
        modes[(o, 1, (2,), 1, (32,), ())] = "I"      # I;32S, I;32BS
        modes[(o, 0, (3,), 1, (32,), ())] = "F"      # F;32F, F;32BF
        modes[(o, 1, (3,), 1, (32,), ())] = "F"
    modes[("<", 1, (1,), 1, (12,), ())] = "I;16"    # I;12
    modes[("<", 0, (1,), 1, (16,), ())] = "I;16"
    modes[("<", 1, (1,), 1, (16,), ())] = "I;16"
    modes[(">", 1, (1,), 1, (16,), ())] = "I;16"
    modes[("<", 1, (1,), 2, (16,), ())] = "I;16"
    modes[("<", 1, (1,), 1, (32,), ())] = "I"       # I;32N
    return modes


_PILLOW_TIFF = _pillow_tiff_modes()


def _tiff_rgba(buf: bytes, key: Optional[str]) -> np.ndarray:
    """Pillow's ``Image.open(b).convert("RGBA")`` of a TIFF: its mode from
    the fields (OPEN_INFO; a combination it lacks fails to open), the
    samples as libtiff (or, uncompressed, Pillow's own unpackers) give
    them, the Orientation applied (``exif_transpose`` on load)."""
    where = _where(key)
    t = _tiff(buf, key, pillow=True)
    if 0xBC01 in t.tags:
        raise CorruptImage(f"{where}Windows Media Photo in a TIFF")
    if t.compression not in _TIFF_DECODED and t.compression not in _TIFF_COMPRESSION or \
            t.compression == 50001:   # Pillow's libtiff has no WebP codec
        raise CorruptImage(f"{where}TIFF compression {t.compression} is not read by Pillow")
    if len(t.bps) != t.spp or t.spp > 6:
        raise CorruptImage(f"{where}TIFF with {t.spp} samples and bits {t.bps}")
    photo = 6 if t.compression == 6 else t.photometric
    mode_key = (t.order, photo, t.sample_format, t.fillorder, t.bps, t.extra)
    if mode_key not in _PILLOW_TIFF:
        raise CorruptImage(f"{where}TIFF of a mode Pillow does not read {mode_key[1:]}")
    form = _tiff_scope(t)
    mode = _PILLOW_TIFF[mode_key]
    if photo == 6 and t.compression not in (_TIFF_JPEG, _TIFF_NONE) and t.spp != 3:
        raise CorruptImage(f"{where}YCbCr TIFF of {t.spp} samples has no libtiff RGBA routine")
    if photo == 6 and t.compression != _TIFF_JPEG and t.spp == 3 and form is None:
        if t.compression == _TIFF_NONE:
            rgba = _pillow_raw_ycbcr(t, buf, key)
        else:   # Pillow's decoder reads it through libtiff's RGBA image
            rgba = _rgba_image(t, _ycbcr_samples(t, buf, key))
            rgba[:, :, 3] = 255
        return _orient(rgba, t.orientation) if 1 < t.orientation <= 8 else rgba
    if form is not None:
        raise _unsupported(f"TIFF ({form})", key)
    bps = t.bps[0]
    raw = t.compression == _TIFF_NONE    # Pillow's own unpackers, not libtiff
    planar = t.planar == 2 and t.spp > 1
    misread = None
    if raw and t.fillorder == 2 and (photo, bps) in ((0, 8), (3, 1), (3, 2), (3, 4)):
        misread = "FillOrder 2"
    if raw and t.planar == 2:   # one raw mode letter a plane
        # Pillow unpacks the plane with the rawmode's first letter ("I" of "I;16S")
        if t.spp == 1 and (photo, bps) not in ((1, 1), (1, 8), (3, 8)) and \
                not (bps == 32 and t.order == "<"):
            misread = "planar"
        elif t.spp > 1 and (bps != 8 or t.fillorder != 1 or
                            mode not in ("RGB", "RGBA", "CMYK", "LAB") or
                            t.extra not in ((), (2,), (999,))):
            misread = "planar"
    if planar and mode == "PX" and not raw and 324 in t.tags:
        misread = "planar"   # the "R" unpacker writes four-byte pixels into a P image
    if misread:   # Pillow raises ValueError (no unpacker) or misreads the planes
        raise _unsupported(f"TIFF ({'uncompressed ' if raw else ''}{misread}, photometric "
                           f"{photo}, bits {t.bps}, extra samples {t.extra})", key)
    bands = {"LA": 2, "PA": 2, "PX": 1, "RGB": 3, "RGBX": 3, "CMYK": 4, "LAB": 3}.get(mode, 4)
    if planar and not raw and bands != t.spp and 324 not in t.tags:
        raise CorruptImage(f"{where}planar TIFF of {t.spp} samples in Pillow's {bands}-band mode")
    s = _tiff_samples(t, buf, key)
    rgba = np.empty(s.shape[:2] + (4,), np.uint8)
    rgba[:, :, 3] = 255
    if planar and not raw:
        # libtiff's planes go one to a band byte ("R", "G", "B", "A" unpackers)
        top = np.zeros(s.shape[:2] + (4,), np.uint8)
        top[:, :, :bands] = (s >> 8 if bps == 16 else s)[:, :, :bands]
        if mode in ("LA", "PA"):
            top[:, :, 1:] = 0
            s = top.astype(np.uint16)[:, :, [0, 3]]
        else:
            s = top.astype(np.uint16)
        if mode == "RGBA" and (t.extra or (0,))[0] in (0, 1):
            mode = "RGBa"   # TiffDecode.c's shuffle of associated alpha planes
        bps = 8
    if mode in ("1", "L"):
        v = s[:, :, 0].astype(np.int32)
        if t.photometric == 0:
            v = (1 << bps) - 1 - v
        v = v * (255 // ((1 << bps) - 1))
        rgba[:, :, :3] = v[:, :, None]
    elif mode == "I;16":
        rgba[:, :, :3] = np.minimum(s[:, :, :1], 255)
    elif mode == "LAB":
        if planar:   # each plane unpacked as "L": a and b not offset, the fourth byte 0
            rgba[:, :, :3] = _pillow_lab_rgb(s[:, :, :3] ^ np.array([0, 128, 128], s.dtype))
            rgba[:, :, 3] = 0
        else:
            rgba[:, :, :3] = _pillow_lab_rgb(s)
    elif mode in ("I", "F"):
        n = bps // 8
        stored = s[:, :, 0].astype(f"<u{n}")
        if t.order == ">" and not raw:   # libtiff's native words through "I;16BS", "F;32BF", ...
            stored = stored.byteswap()
        v = stored.view(f"<{'f' if mode == 'F' else 'i'}{n}")
        # Pillow's i2rgb clips; its F conversion truncates, NaN to 0
        rgba[:, :, :3] = np.where(v >= 255, 255, np.where(v > 0, v, 0)).astype(np.uint8)[:, :, None]
    elif mode == "LA":
        rgba[:, :, :3] = s[:, :, :1]
        rgba[:, :, 3] = s[:, :, 1]
    elif mode in ("P", "PX", "PA"):
        cmap = np.asarray(t.tags.get(320, ()), np.int64) // 256
        n = len(cmap) // 3
        table = np.zeros((256, 3), np.uint8)
        table[:n] = cmap[:3 * n].reshape(3, n).T
        rgba[:, :, :3] = table[np.minimum(s[:, :, 0], 255)]
        if mode == "PA":
            rgba[:, :, 3] = s[:, :, 1]
    else:
        top = (s >> 8 if bps == 16 else s).astype(np.uint8)
        if mode == "CMYK":
            k = 255 - top[:, :, 3:4].astype(np.int32)
            tmp = top[:, :, :3].astype(np.int32) * k + 128
            rgba[:, :, :3] = np.clip(k - (((tmp >> 8) + tmp) >> 8), 0, 255)
        else:
            rgba[:, :, :3] = top[:, :, :3]
            if mode in ("RGBA", "RGBa"):
                rgba[:, :, 3] = top[:, :, 3]
            if mode == "RGBa":
                rgba = _unpremultiply(rgba)
    return _orient(rgba, t.orientation) if 1 < t.orientation <= 8 else rgba


def _pillow_raw_ycbcr(t: _Tiff, buf: bytes, key: Optional[str]) -> np.ndarray:
    """Pillow's raw decoder on uncompressed YCbCr: each strip's bytes from
    its offset on read as "RGBX", four a pixel, whatever the samples and
    their subsampling (it fails where the file ends first)."""
    where = _where(key)
    if 324 in t.tags or t.planar == 2:
        raise _unsupported("TIFF (uncompressed tiled or planar YCbCr, which Pillow misreads)", key)
    rps = int((t.tags.get(278) or (2 ** 32 - 1,))[0]) or t.height
    rps = min(max(rps, 1), t.height)
    offs = t.tags.get(273, ())
    rgba = np.empty((t.height, t.width, 4), np.uint8)
    for k, y0 in enumerate(range(0, t.height, rps)):
        rows = min(rps, t.height - y0)
        need = 4 * t.width * rows
        if k >= len(offs) or offs[k] < 0 or offs[k] + need > len(buf):
            raise CorruptImage(f"{where}image file is truncated (uncompressed YCbCr TIFF)")
        rgba[y0:y0 + rows] = np.frombuffer(buf, np.uint8, need, offs[k]).reshape(rows, t.width, 4)
    rgba[:, :, 3] = 255
    return rgba


def _unpremultiply(rgba: np.ndarray) -> np.ndarray:
    """Pillow's "RGBa" unpacker: colour * 255 / alpha, clipped; alpha 0 is
    all zero."""
    a = rgba[:, :, 3:4].astype(np.int32)
    c = rgba[:, :, :3].astype(np.int32)
    out = rgba.copy()
    out[:, :, :3] = np.where(a == 255, c, np.clip(c * 255 // np.maximum(a, 1), 0, 255))
    out[(a == 0)[:, :, 0]] = 0
    return out


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
    """RGBA uint8 ``[H, W, 4]`` of a PNG, JPEG, GIF, BMP, WebP or TIFF as Pillow's
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
    if fmt == "webp":
        webp = _webp(buf, key)
        rgba = _webp_rgba(webp, key)
        if not webp.pil_alpha:   # Pillow's "RGB" mode
            rgba[:, :, 3] = 255
        return rgba if size is None else resize(rgba, size)
    if fmt == "tiff" or fmt.startswith(("TIFF (", "BigTIFF (")):
        rgba = _tiff_rgba(buf, key)
        return rgba if size is None else resize(rgba, size)
    raise _unreadable(fmt, "Pillow", key)


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
    _raise(_lib().ic_jpeg_samples(buf, len(buf), -1, px.ctypes.data, err, _ERRLEN), err, key)
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


def _cv_webp(buf: bytes, flags: int, key: Optional[str]) -> np.ndarray:
    """OpenCV's WebP decoder: frame 0's canvas, BGRA under
    ``IMREAD_UNCHANGED`` where the file flags alpha (else BGR), BGR with
    the EXIF orientation applied under ``IMREAD_COLOR``."""
    webp = _webp(buf, key)
    bgra = _webp_rgba(webp, key)[:, :, [2, 1, 0, 3]]
    if flags == IMREAD_UNCHANGED:
        return np.ascontiguousarray(bgra if webp.cv_alpha else bgra[:, :, :3])
    return _orient(np.ascontiguousarray(bgra[:, :, :3]), _exif_orientation(webp.exif))


def _tiff_extra(t: _Tiff) -> Tuple[int, ...]:
    """libtiff's ExtraSamples: the field, or (0,) * n where the samples
    outnumber the photometric's colour channels."""
    colour = {0: 1, 1: 1, 3: 1, 4: 1, 2: 3, 6: 3, 8: 3, 5: 4}.get(t.photometric, 0)
    if t.extra or not colour or t.spp <= colour:
        return t.extra
    return (0,) * (t.spp - colour)


def _rgba_image(t: _Tiff, s: np.ndarray) -> np.ndarray:
    """libtiff's TIFFRGBAImage (tif_getimage.c) of the samples: RGBA uint8
    as ``TIFFReadRGBAStrip`` / ``TIFFReadRGBATile`` give cv2, alpha
    premultiplied where it is unassociated."""
    bps, photo = t.bps[0], t.photometric
    extra = _tiff_extra(t)
    alpha = 0
    if extra:
        alpha = extra[0] if extra[0] in (1, 2) else (1 if extra[0] == 0 and t.spp > 3 else 0)
    separate = t.planar == 2 and t.spp > 1
    h, w = s.shape[:2]
    rgba = np.full((h, w, 4), 255, np.uint8)
    if photo in (0, 1) and not separate:
        v = s[:, :, 0].astype(np.int32)
        if bps == 16:
            v, rng = v >> 8, 255
        else:
            rng = (1 << bps) - 1
        v = ((rng - v) if photo == 0 else v) * 255 // rng
        rgba[:, :, :3] = v[:, :, None]
        if alpha and t.spp == 2 and bps == 8:
            rgba[:, :, 3] = s[:, :, 1]
        return rgba
    if photo == 3:
        cmap = np.asarray(t.tags.get(320, ()), np.int64)
        n = 1 << bps
        if len(cmap) < 3 * n:
            raise CorruptImage("TIFF colormap too short")
        cmap = cmap[:3 * n].reshape(3, n).T
        if (cmap >= 256).any():   # else libtiff takes it for an 8-bit map
            cmap = cmap >> 8
        rgba[:, :, :3] = cmap[s[:, :, 0]]
        return rgba
    top = s.astype(np.int64)
    if bps == 16:   # Bitdepth16To8
        top = (top * 255 + 32767) // 65535
    if photo == 5:
        k = 255 - top[:, :, 3:4]
        rgba[:, :, :3] = k * (255 - top[:, :, :3]) // 255
        return rgba
    if photo == 6 and t.compression != _TIFF_JPEG:
        rgba[:, :, :3] = _ycbcr_rgb(t, s)
        return rgba
    if photo == 8:
        rgba[:, :, :3] = _cielab_rgb(t, s)
        return rgba
    if separate and photo in (0, 1):   # the gray plane for red, green and blue
        top = np.concatenate([top[:, :, :1]] * 3 + [top[:, :, 1:]], axis=2)
    rgba[:, :, :3] = top[:, :, :3]
    if alpha:
        a = top[:, :, 3 if top.shape[2] > 3 else 1]
        rgba[:, :, 3] = a
        if alpha == 2:   # UaToAa
            rgba[:, :, :3] = (top[:, :, :3] * a[:, :, None] + 127) // 255
    return rgba


def _tiff_float_field(t: _Tiff, tag: int, default: Tuple[float, ...]) -> np.ndarray:
    """A float field (RATIONAL or FLOAT) as libtiff's floats, or its default."""
    v = t.tags.get(tag, ())
    if len(v) < len(default) or not all(isinstance(x, (float, np.floating)) for x in v):
        v = default
    return np.array(v[:len(default) or len(v)], np.float32)


def _ycbcr_rgb(t: _Tiff, s: np.ndarray) -> np.ndarray:
    """libtiff's TIFFYCbCrToRGB of 8-bit Y, Cb, Cr samples [H, W, 3]: its
    tables (TIFFYCbCrToRGBInit) from YCbCrCoefficients and
    ReferenceBlackWhite, in the same float and fixed-point steps."""
    f32 = np.float32
    luma = _tiff_float_field(t, 529, (0.299, 0.587, 0.114))
    ref = _tiff_float_field(t, 532, (0.0, 255.0, 128.0, 255.0, 128.0, 255.0))
    if np.isnan(luma).any() or luma[1] == 0 or not np.isfinite(ref).all():
        raise CorruptImage("TIFF with invalid YCbCrCoefficients or ReferenceBlackWhite")

    def fix(x):   # FIX(CLAMP(x, 0, 2)): float x * 65536, + 0.5 in double, truncated
        x = f32(0) if not x >= 0 else min(x, f32(2))
        return int(float(x * f32(65536)) + 0.5)

    def code2v(c, rb, rw, cr):   # Code2V, then CLAMPw to +-4096 and (int32_t)
        span = f32(rw - rb)
        v = (c - np.int32(np.trunc(rb))).astype(f32) * f32(cr) / (span if span != 0 else f32(1))
        return np.trunc(np.where(~(v >= -4096), -4096, np.minimum(v, 4096))).astype(np.int64)

    lr, lg, lb = luma
    f1, f3 = f32(2) - f32(2) * lr, f32(2) - f32(2) * lb
    d1, d2, d3, d4 = fix(f1), -fix(f32(lr * f1) / lg), fix(f3), -fix(f32(lb * f3) / lg)
    x = np.arange(-128, 128, dtype=np.int64)
    cr = code2v(x, ref[4] - f32(128), ref[5] - f32(128), 127)
    cb = code2v(x, ref[2] - f32(128), ref[3] - f32(128), 127)
    cr_r, cb_b = (d1 * cr + 32768) >> 16, (d3 * cb + 32768) >> 16
    cr_g, cb_g = d2 * cr, d4 * cb + 32768
    y_tab = code2v(x + 128, ref[0], ref[1], 255)
    yy, b, r = y_tab[s[:, :, 0]], s[:, :, 1], s[:, :, 2]
    rgb = np.stack([yy + cr_r[r], yy + ((cb_g[b] + cr_g[r]) >> 16), yy + cb_b[b]], axis=2)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _cielab_rgb(t: _Tiff, s: np.ndarray) -> np.ndarray:
    """libtiff's CIELab RGBA routines (putcontig8bitCIELab8 / 16):
    TIFFCIELab16ToXYZ against the WhitePoint (D50 by default), then
    TIFFXYZToRGB's sRGB display table, in libtiff's float steps."""
    f32 = np.float32
    wp = _tiff_float_field(t, 318, ())
    if len(wp) < 2:
        tot = f32(96.4250) + f32(100.0) + f32(82.4680)
        wp = np.array([f32(96.4250) / tot, f32(100.0) / tot], f32)
    if wp[1] == 0:
        raise CorruptImage("TIFF with an invalid WhitePoint")
    x0 = wp[0] / wp[1] * f32(100)
    z0 = (f32(1) - wp[0] - wp[1]) / wp[1] * f32(100)
    y0 = f32(100)
    if t.bps[0] == 8:   # TIFFCIELabToXYZ: the 8-bit samples scaled to 16 bits
        l16 = s[:, :, 0].astype(np.int64) * 257
        a16 = s[:, :, 1].astype(np.uint8).view(np.int8).astype(np.int64) * 256
        b16 = s[:, :, 2].astype(np.uint8).view(np.int8).astype(np.int64) * 256
    else:
        l16 = s[:, :, 0].astype(np.int64)
        a16 = s[:, :, 1].astype(np.uint16).view(np.int16).astype(np.int64)
        b16 = s[:, :, 2].astype(np.uint16).view(np.int16).astype(np.int64)
    lum = l16.astype(f32) * f32(100) / f32(65535)
    small = lum < f32(8.856)
    yy = np.where(small, (lum * y0) / f32(903.292), f32(0))
    cby = np.where(small, f32(7.787) * (yy / y0) + f32(16) / f32(116), (lum + f32(16)) / f32(116))
    yy = np.where(small, yy, y0 * cby * cby * cby)
    channels = []
    for v, scale, white, sign in ((a16, 500, x0, 1), (b16, 200, z0, -1)):
        q = v.astype(f32) / f32(256) / f32(scale)
        tmp = q + cby if sign > 0 else cby - q
        channels.append(np.where(tmp < f32(0.2069), white * (tmp - f32(0.13793)) / f32(7.787),
                                 white * tmp * tmp * tmp))
    xx, zz = channels
    table = _cielab_table()
    rgb = np.empty(s.shape[:2] + (3,), np.uint8)
    step = (f32(100) - f32(1)) / f32(1500)
    for i, row in enumerate(_SRGB_DISPLAY):
        lumc = (row[0] * xx + row[1] * yy + row[2] * zz).astype(f32)
        lumc = np.minimum(np.maximum(lumc, f32(1)), f32(100))
        idx = np.minimum(((lumc - f32(1)) / step).astype(np.int64), 1500)
        rgb[:, :, i] = np.minimum(np.floor(table[idx].astype(np.float64) + 0.5), 255)
    return rgb


# TIFFDisplay display_sRGB's XYZ -> luminance matrix
_SRGB_DISPLAY = np.array([[3.2410, -1.5374, -0.4986], [-0.9692, 1.8760, 0.0416],
                          [0.0556, -0.2040, 1.0570]], np.float32)


@functools.lru_cache(maxsize=None)
def _cielab_table() -> np.ndarray:
    """TIFFCIELabToRGBInit's Yr2r: 255 * (i / 1500) ** (1 / 2.4) in float."""
    i = np.arange(1501, dtype=np.float64)
    return np.float32(255) * np.power(i / 1500, 1.0 / 2.4).astype(np.float32)


def _mat3_inverse(a):
    """LittleCMS's _cmsMAT3inverse, in its order of double operations."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return [[c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det,
             (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det],
            [c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det,
             (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det],
            [c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det,
             (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det]]


def _mat3_product(a, b):
    return [[a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j] for j in range(3)]
            for i in range(3)]


def _mat3_apply(a, v):
    return [a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2] for i in range(3)]


_LCMS_D50 = (0.9642, 1.0, 0.8249)


def _srgb_colorants():
    """cmsCreate_sRGBProfile's colorant matrix (RGB -> XYZ D50), in double:
    _cmsBuildRGB2XYZtransferMatrix on D65 and the Rec. 709 primaries, then
    Bradford to D50 (_cmsAdaptationMatrix)."""
    xn, yn = 0.3127, 0.3290
    prim = ((0.64, 0.33), (0.30, 0.60), (0.15, 0.06))
    p = [[prim[0][0], prim[1][0], prim[2][0]], [prim[0][1], prim[1][1], prim[2][1]],
         [1 - prim[0][0] - prim[0][1], 1 - prim[1][0] - prim[1][1], 1 - prim[2][0] - prim[2][1]]]
    coef = _mat3_apply(_mat3_inverse(p), [xn / yn, 1.0, (1.0 - xn - yn) / yn])
    rgb = [[coef[j] * p[i][j] for j in range(3)] for i in range(3)]
    rgb[2] = [coef[j] * (1.0 - prim[j][0] - prim[j][1]) for j in range(3)]
    bradford = [[0.8951, 0.2664, -0.1614], [-0.7502, 1.7135, 0.0367], [0.0389, -0.0685, 1.0296]]
    src = _mat3_apply(bradford, [(xn / yn) * 1.0, 1.0, ((1 - xn - yn) / yn) * 1.0])
    dst = _mat3_apply(bradford, list(_LCMS_D50))
    cone = [[dst[0] / src[0], 0.0, 0.0], [0.0, dst[1] / src[1], 0.0],
            [0.0, 0.0, dst[2] / src[2]]]
    adapt = _mat3_product(_mat3_inverse(bradford), _mat3_product(cone, bradford))
    return _mat3_product(adapt, rgb)


def _lcms_word(v: np.ndarray) -> np.ndarray:
    """_cmsQuickSaturateWord: v + 0.5 clamped to 0..65535, floored after
    rounding to 2^-16 (its magic-number floor)."""
    d = v + 0.5
    magic = 68719476736.0 * 1.5
    fl = np.floor(((d - 32767.0) + magic) - magic) + 32767
    return np.where(d <= 0, 0, np.where(d >= 65535.0, 65535, fl)).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _lcms_lab_grid() -> np.ndarray:
    """LittleCMS's 33-point grid of Lab (D50) -> sRGB at 16 bits, flat
    ([33, 33, 33, 3] in L, a, b order), as its transform samples the
    pipeline (XFormSampler16): each node's 16-bit Lab to float, Lab -> XYZ
    (cmsLab2XYZ in double, out as float over 1.99997), the inverse of the
    sRGB colorants (double products summed, out as float), the sRGB curve
    inverted (parametric type -4 in double, out as float), then to 16
    bits."""
    f32, f64 = np.float32, np.float64
    node = _lcms_word(np.arange(33, dtype=f64) * 65535.0 / 32)
    lab = [(v.astype(f64) / 65535.0).astype(f32).astype(f64)
           for v in np.meshgrid(node, node, node, indexing="ij")]
    y = (lab[0] * 100.0 + 16.0) / 116.0
    x, z = y + 0.002 * (lab[1] * 255.0 - 128.0), y - 0.005 * (lab[2] * 255.0 - 128.0)

    def f_1(t):   # cmsLab2XYZ's inverse of f
        return np.where(t <= 24.0 / 116.0, (108.0 / 841.0) * (t - 16.0 / 116.0), t * t * t)

    max_xyz = 1.0 + 32767.0 / 32768.0
    xyz = [(f_1(t) * w / max_xyz).astype(f32).astype(f64) for t, w in zip((x, y, z), _LCMS_D50)]
    inverse = [[v * max_xyz for v in row] for row in _mat3_inverse(_srgb_colorants())]
    g, a, b, c, d = 2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045
    disc = (a * d + b) ** g
    out = []
    for row in inverse:
        v = (xyz[0] * row[0] + xyz[1] * row[1] + xyz[2] * row[2]).astype(f32).astype(f64)
        curve = np.where(v >= disc, (np.power(np.maximum(v, disc), 1.0 / g) - b) / a, v / c)
        out.append(_lcms_word(curve.astype(f32).astype(f64) * 65535.0))
    return np.stack(out, -1).reshape(-1)


def _pillow_lab_rgb(s: np.ndarray) -> np.ndarray:
    """Pillow's ``convert`` of its LAB mode (the TIFF's signed a and b) to
    RGB, which goes through LittleCMS 2 (ImageCms, a Lab identity profile
    to sRGB): its 33-point grid of the conversion at 16 bits, tetrahedral
    interpolation in its fixed point (TetrahedralInterp16), 16 bits to 8."""
    lut = _lcms_lab_grid()
    h, w = s.shape[:2]
    inp = np.stack([s[:, :, 0].astype(np.int64), s[:, :, 1].astype(np.int64) ^ 128,
                    s[:, :, 2].astype(np.int64) ^ 128], -1).reshape(-1, 3) * 257
    fixed = inp * 32 + (inp * 32 + 0x7FFF) // 0xFFFF      # _cmsToFixedDomain
    opta = np.array([33 * 33 * 3, 33 * 3, 3])
    base = ((fixed >> 16) * opta).sum(1)
    r = fixed & 0xFFFF
    step = np.where(inp == 0xFFFF, 0, opta)
    rx, ry, rz = r[:, 0], r[:, 1], r[:, 2]
    sx, sy, sz = step[:, 0], step[:, 1], step[:, 2]
    at = lambda off: lut[(base + off)[:, None] + np.arange(3)]   # noqa: E731
    c0 = at(0)
    out = np.zeros_like(c0)
    # TetrahedralInterp16's six tetrahedra: each its corners and the
    # differences that weigh rx, ry and rz
    for cond, (o1, o2, o3), order in (
            ((rx >= ry) & (ry >= rz), (sx, sx + sy, sx + sy + sz), "xyz"),
            ((rx >= ry) & (ry < rz) & (rz >= rx), (sx + sz, sx + sy + sz, sz), "zxy"),
            ((rx >= ry) & (ry < rz) & (rz < rx), (sx, sx + sy + sz, sx + sz), "xzy"),
            ((rx < ry) & (rx >= rz), (sx + sy, sy, sx + sy + sz), "yxz"),
            ((rx < ry) & (rx < rz) & (ry >= rz), (sx + sy + sz, sy, sy + sz), "yzx"),
            ((rx < ry) & (rx < rz) & (ry < rz), (sx + sy + sz, sy + sz, sz), "zyx")):
        c1, c2, c3 = at(o1), at(o2), at(o3)
        k1, k2, k3 = {"xyz": (c1 - c0, c2 - c1, c3 - c2), "zxy": (c1 - c3, c2 - c1, c3 - c0),
                      "xzy": (c1 - c0, c2 - c3, c3 - c1), "yxz": (c1 - c2, c2 - c0, c3 - c1),
                      "yzx": (c1 - c3, c2 - c0, c3 - c2), "zyx": (c1 - c2, c2 - c3, c3 - c0)}[order]
        rest = k1 * rx[:, None] + k2 * ry[:, None] + k3 * rz[:, None] + 0x8001
        out = np.where(cond[:, None], (c0 + ((rest + (rest >> 16)) >> 16)) & 0xFFFF, out)
    return ((out * 65281 + 8388608) >> 24).astype(np.uint8).reshape(h, w, 3)



def _cv_gray(rgba: np.ndarray) -> np.ndarray:
    """OpenCV's icvCvt_BGRA2Gray_8u_C4C1R on libtiff's RGBA."""
    c = rgba.astype(np.int32)
    return ((c[:, :, 0] * 4899 + c[:, :, 1] * 9617 + c[:, :, 2] * 1868 + 8192) >> 14).astype(
        np.uint8)


def _skewed_tiles(t: _Tiff, whole: np.ndarray) -> np.ndarray:
    """The samples libtiff's gray and palette put routines (putgreytile,
    putagreytile, put16bitbwtile, put8bitcmaptile) read from tiles cut by
    the image's right edge: they step ``fromskew`` bytes, not pixels, past
    each row, so a tile of 16-bit samples or of more than one sample a
    pixel is read askew."""
    cw, ch = int(t.tags[322][0]), int(t.tags[323][0])
    bps, spp = t.bps[0], t.spp
    out = whole[:t.height, :t.width].copy()
    x0 = (t.width - 1) // cw * cw
    npix, skew = t.width - x0, cw - (t.width - x0)
    if skew == 0:
        return out
    step = spp * bps // 8
    r = np.arange(ch)[:, None]
    at = r * (npix * step + skew) + np.arange(npix)[None, :] * step
    for y0 in range(0, t.height, ch):
        tile = whole[y0:y0 + ch, x0:x0 + cw]
        stream = (tile.astype("<u2").view(np.uint8) if bps == 16 else
                  tile.astype(np.uint8)).reshape(-1)
        nrow = min(ch, t.height - y0)
        if bps == 16:   # *wp >> 8 of a little-endian word at a byte offset
            out[y0:y0 + nrow, x0:, 0] = stream[at[:nrow] + 1].astype(np.uint16) << 8
        else:
            out[y0:y0 + nrow, x0:, 0] = stream[at[:nrow]]
            if spp > 1:
                out[y0:y0 + nrow, x0:, 1] = stream[at[:nrow] + 1]
    return out


def _cv_tiff(buf: bytes, flags: int, key: Optional[str]) -> np.ndarray:
    """OpenCV's TIFF decoder: its channels and depth from the fields, the
    pixels through libtiff's RGBA image for 8-bit output (every
    ``IMREAD_COLOR`` read, CIELab and YCbCr too), the stored samples of
    10-64 bits otherwise (signed and float as cv2's depths); the
    Orientation applied under both flags."""
    where = _where(key)
    t = _tiff(buf, key, pillow=False)
    photo, spp, bps = t.photometric, t.spp, t.bps[0]
    if t.compression in (6, _TIFF_LZMA, 50000, 50001):   # cv2's libtiff has none of these codecs
        raise CorruptImage(f"{where}TIFF compression {t.compression} is not read by cv2")
    sf = t.sample_format[0]
    # CIELab's 16 bits come through libtiff's RGBA image under either flag
    deep = bps > 8 and flags == IMREAD_UNCHANGED and spp != 2 and photo != 8
    if spp > 4 or bps not in (1, 4, 8, 10, 12, 14, 16, 32, 64) or (bps == 4 and photo != 3) or \
            (photo == 5 and bps != 8) or (photo == 3 and bps > 8) or (photo == 6 and deep) or \
            (sf == 3 and bps not in (32, 64)) or \
            (not deep and (bps > 16 or sf == 3 or bps in (10, 12, 14))):
        raise CorruptImage(f"{where}TIFF of {spp} samples at {bps} bits is not read by cv2 "
                           f"({'IMREAD_UNCHANGED' if deep else 'through its RGBA image'})")
    form = _tiff_scope(t)
    if form is not None:
        raise _unsupported(f"TIFF ({form})", key)
    if not deep and (photo not in (0, 1, 2, 3, 5, 6, 8) or
                     photo in (2, 6) and spp - len(t.extra) < 3 or photo == 5 and spp < 4 or
                     photo == 8 and (spp != 3 or t.planar == 2)):
        raise CorruptImage(f"{where}TIFF of photometric {photo} with {spp} samples is not read "
                           f"by libtiff's RGBA image")
    if bps == 1:
        channels = 1
    elif photo == 3 and bps != 16:
        channels = 3
    else:
        channels = 1 if photo in (0, 1, 3) else spp
    tiled = 324 in t.tags
    _tiff_predictor(t, key)
    if deep and t.planar == 2 and spp > 1:   # cv2 reads the planes as chunky samples
        raise _unsupported("planar TIFF of 16-bit samples under cv2's IMREAD_UNCHANGED", key)
    if not deep and t.planar == 2 and spp > 1 and photo == 3:   # PickSeparateCase has none
        raise CorruptImage(f"{where}planar palette TIFF is not read by cv2")
    if not deep and tiled and t.compression == _TIFF_NONE:
        per = spp if t.planar != 2 else 1
        if (int(t.tags[322][0]) * int(t.tags[323][0]) * per * bps // 8) % 1024:
            raise CorruptImage(f"{where}uncompressed TIFF tiles cv2 does not read")
    skew = not deep and tiled and photo in (0, 1, 3) and (t.planar != 2 or spp == 1) and \
        (spp > 1 or bps == 16) and t.compression != _TIFF_JPEG
    if photo == 6 and t.compression != _TIFF_JPEG and not deep:
        s = _ycbcr_samples(t, buf, key)
    else:
        s = _tiff_samples(t, buf, key, whole_tiles=skew, cv2_read=True)
    if skew:
        s = _skewed_tiles(t, s)
    if deep:   # the stored words as cv2's depth for them; 10-14 bits shifted to 16
        n = 2 if bps <= 16 else bps // 8
        s = s.astype(f"<u{n}")
        if bps < 16:
            s = s << (16 - bps)
        s = s.view(f"<{'uif'[sf - 1] if sf in (1, 2, 3) else 'u'}{n}")
        out = s[:, :, :channels] if channels > 1 else s[:, :, 0]
        if channels >= 3:
            out = np.concatenate([out[:, :, 2::-1], out[:, :, 3:]], axis=2)
    else:
        rgba = _rgba_image(t, s)
        if flags == IMREAD_COLOR or channels == 3:
            out = rgba[:, :, 2::-1]
        elif channels == 4:
            out = rgba[:, :, [2, 1, 0, 3]]
        else:
            out = _cv_gray(rgba)
        if flags == IMREAD_UNCHANGED and sf == 2:   # cv2's signed 8-bit depth
            out = out.view(np.int8)
    out, o = np.ascontiguousarray(out), t.orientation
    if not deep and tiled and o in (2, 3, 6, 7):
        # TIFFReadRGBATile mirrors each tile's visible part; cv2 turns the rest
        cw, ch = int(t.tags[322][0]), int(t.tags[323][0])
        for x0 in range(0, t.width, cw):
            out[:, x0:x0 + cw] = out[:, x0:x0 + cw][:, ::-1]
        o = {2: 1, 3: 4, 6: 7, 7: 6}[o]
    return _orient(out, o) if 1 < o <= 8 else out


def imdecode(buf: bytes, flags: int = IMREAD_COLOR, key: Optional[str] = None) -> np.ndarray:
    """``cv2.imdecode(buf, flags)`` for ``IMREAD_COLOR`` (BGR [H, W, 3]
    uint8: EXIF orientation applied, alpha dropped, palette and gray
    expanded, 16 bits to their high byte) and ``IMREAD_UNCHANGED`` (the
    stored channels as cv2 gives them, uint16 for 16-bit PNG and TIFF,
    unrotated but for TIFF).
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
    if fmt == "webp":
        return _cv_webp(buf, flags, key)
    if fmt == "tiff" or fmt.startswith(("TIFF (", "BigTIFF (")):
        return _cv_tiff(buf, flags, key)
    raise _unreadable(fmt, "cv2", key)


def imread(path: str, flags: int = IMREAD_COLOR) -> Optional[np.ndarray]:
    """``cv2.imread(path, flags)``: None where the file is missing or
    unreadable, as cv2 gives; a form the port does not decode raises.  A
    TIFF whose Orientation (5-8) turns it into another shape is None too:
    cv2's ``imdecode`` turns it, its ``imread`` fails to."""
    try:
        with open(path, "rb") as f:
            buf = f.read()
    except OSError:
        return None
    try:
        img = imdecode(buf, flags, key=path)
    except CorruptImage:
        return None
    if img.shape[0] != img.shape[1] and buf[:4] in _TIFF_MAGIC and \
            _tiff(buf, path, pillow=False).orientation in (5, 6, 7, 8):
        return None
    return img


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
