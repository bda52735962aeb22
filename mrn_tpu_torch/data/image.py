"""Word-crop images without PIL: decode PNG and baseline JPEG bytes to RGBA
uint8 and resize them as Pillow's ``Image.resize(BICUBIC)`` does, bit for
bit what the JAX package's ``PIL.Image.open(b).convert("RGBA")`` and
``ResizeNormalize`` give.

Each crop is one call into the host library ``csrc/imagecodec.cpp``
(built with ``g++`` at first use into ``build/mrn_tpu_torch/``):

- ``decode(buf, size)``: encoded bytes in, ``[H, W, 4]`` uint8 out, at
  ``size = (W, H)`` or at the image's own size.  PNG's IDAT stream is
  inflated here with ``zlib`` and unfiltered in C++; JPEG is decoded
  whole in C++ (libjpeg-turbo's integer IDCT, fancy upsampling and colour
  tables, as Pillow runs it).
- ``resize(rgba, size)``: Pillow's bicubic resize of an RGBA array (through
  premultiplied RGBa and back); a crop already at ``size`` is returned as
  it is, as Pillow returns a copy.
- ``to_rgba(array)``: an HxW gray, HxWx3 or HxWx4 uint8 array as
  ``PIL.Image.fromarray(array).convert("RGBA")`` gives it.
- ``encode_png(rgba)``: a plain PNG writer (zlib and crc32) for tools and
  for the card's machine, which has no PIL.

Bytes that no decoder can read (truncated, bad markers, bad zlib or
Huffman data, an unknown format) raise ``CorruptImage``, an ``OSError``
like Pillow's, which ``LmdbDataset`` turns into its dummy crop.  A valid
file of a form the port does not decode (progressive, arithmetic, lossless,
12-bit or CMYK JPEG, 16-bit or interlaced PNG, GIF, BMP, TIFF, WebP)
raises ``UnsupportedImage`` naming the form (ROADMAP.md §1 item 8): it is
never turned into a dummy.  ``data.image_ref`` holds the same decoder and
resize in numpy, for the tests.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np

from mrn_tpu_torch.data import _host_build

__all__ = ["CorruptImage", "PngHeader", "UnsupportedImage", "decode", "encode_png",
           "image_format", "parse_png", "resize", "to_rgba"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "imagecodec.cpp"
# the bicubic coefficients are doubles: no fused multiply-add, as Pillow's build
FLAGS = ("-ffp-contract=off",)
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_OTHER_FORMATS = ((b"GIF87a", "GIF"), (b"GIF89a", "GIF"), (b"BM", "BMP"),
                  (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"\x00\x00\x01\x00", "ICO"))
_ERRLEN = 256


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
        lib.ic_png_decode.argtypes = [buf, sz, i, i, i, i, buf, i, buf, i, i, i, p, buf, i]
        lib.ic_resize_rgba.argtypes = [p, i, i, i, i, p]
        for fn in (lib.ic_jpeg_info, lib.ic_jpeg_decode, lib.ic_png_decode,
                   lib.ic_resize_rgba):
            fn.restype = i
        lib._typed = True
    return lib


def _raise(rc: int, err, key: Optional[str]) -> None:
    if rc == 0:
        return
    where = f"{key}: " if key is not None else ""
    msg = err.value.decode(errors="replace")
    if rc == 2:
        raise UnsupportedImage(f"{where}{msg} is not decoded by the port (ROADMAP.md §1 "
                               "item 8)")
    raise CorruptImage(f"{where}cannot decode the image: {msg}")


class PngHeader(NamedTuple):
    width: int
    height: int
    depth: int
    color_type: int
    plte: bytes
    trns: bytes
    raw: bytes      # the inflated, still filtered image rows


def image_format(buf: bytes) -> str:
    """"png", "jpeg", the name of another format Pillow reads, or
    "unknown"."""
    if buf.startswith(PNG_MAGIC):
        return "png"
    if buf[:3] == b"\xff\xd8\xff":
        return "jpeg"
    if buf[:4] == b"RIFF" and buf[8:12] == b"WEBP":
        return "WebP"
    for magic, name in _OTHER_FORMATS:
        if buf.startswith(magic):
            return name
    return "unknown"


def parse_png(buf: bytes, key: Optional[str] = None) -> PngHeader:
    """The header fields, PLTE, tRNS and the inflated IDAT stream of a
    PNG; raises as ``decode`` does."""
    where = f"{key}: " if key is not None else ""
    pos, ihdr, plte, trns, idat = 8, None, b"", b"", []
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
    if depth == 16:
        raise UnsupportedImage(f"{where}16-bit PNG is not decoded by the port (ROADMAP.md "
                               "§1 item 8)")
    if interlace:
        raise UnsupportedImage(f"{where}interlaced PNG is not decoded by the port "
                               "(ROADMAP.md §1 item 8)")
    ok = {0: (1, 2, 4, 8), 2: (8,), 3: (1, 2, 4, 8), 4: (8,), 6: (8,)}
    if depth not in ok.get(color_type, ()):
        raise CorruptImage(f"{where}PNG colour type {color_type} at bit depth {depth}")
    if color_type == 3 and not plte:
        raise CorruptImage(f"{where}palette PNG without PLTE")
    if not idat:
        raise CorruptImage(f"{where}truncated PNG (no image data)")
    try:
        raw = zlib.decompressobj().decompress(b"".join(idat))
    except zlib.error as e:
        raise CorruptImage(f"{where}broken PNG data stream: {e}") from None
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    if len(raw) < ((width * channels * depth + 7) // 8 + 1) * height:
        raise CorruptImage(f"{where}truncated PNG image data")
    return PngHeader(width, height, depth, color_type, plte, trns, raw)


def _check_size(size: Tuple[int, int]) -> Tuple[int, int]:
    w, h = (int(v) for v in size)
    if w < 1 or h < 1:
        raise ValueError(f"output size (W, H) must be positive, not {size}")
    return w, h


def decode(buf: bytes, size: Optional[Tuple[int, int]] = None,
           key: Optional[str] = None) -> np.ndarray:
    """RGBA uint8 ``[H, W, 4]`` of a PNG or JPEG, resized to ``size = (W,
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
                               png.depth, png.plte, len(png.plte) // 3, png.trns,
                               len(png.trns), h, w, out.ctypes.data, err, _ERRLEN)
        _raise(rc, err, key)
        return out
    if fmt == "jpeg":
        if size is None:
            cw, ch, cn = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
            _raise(lib.ic_jpeg_info(buf, len(buf), ctypes.byref(cw), ctypes.byref(ch),
                                    ctypes.byref(cn), err, _ERRLEN), err, key)
            size = (cw.value, ch.value)
        w, h = size
        out = np.empty((h, w, 4), np.uint8)
        _raise(lib.ic_jpeg_decode(buf, len(buf), h, w, out.ctypes.data, err, _ERRLEN),
               err, key)
        return out
    where = f"{key}: " if key is not None else ""
    if fmt == "unknown":
        raise CorruptImage(f"{where}cannot identify the image format")
    raise UnsupportedImage(f"{where}{fmt} images are not decoded by the port (ROADMAP.md "
                           "§1 item 8)")


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
    """An RGBA (colour type 6) PNG of a uint8 array, every row filter 0."""
    rgba = np.ascontiguousarray(to_rgba(image))
    h, w = rgba.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgba.reshape(h, w * 4)], axis=1)
    return (PNG_MAGIC + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))
