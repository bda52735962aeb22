"""Regenerates ``tests/fixtures/torch_codec/``: small JPEG (gray, 4:4:4,
4:2:2, 4:2:0, restart markers, odd sizes, an RGB-coded one) and PNG (every
colour type, with and without tRNS, low bit depths, every row filter)
word crops written by PIL, and ``expected.npz`` with PIL's
``open().convert("RGBA")`` of each (``<name>:decode``) and its
``resize((256, 32), BICUBIC)`` (``<name>:resize``).

    python3 scripts/make_torch_codec_fixtures.py

Needs PIL (this is the only place the port's fixtures come from it);
``tests/test_torch_image_codec.py`` checks that the files still give
PIL's arrays and that the port's decoder gives them too, and
``chip_smoke.py`` holds the C++ codec against them on the machine with
the card, which has no PIL.
"""

from __future__ import annotations

import io
import os
import struct
import zlib

import numpy as np
import PIL.Image

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests",
                   "fixtures", "torch_codec")
SIZE = (256, 32)


def crop(rng, h: int, w: int, channels: int) -> np.ndarray:
    """A word-crop-like image: dark strokes in vertical bands on a flat
    light ground, a tint per channel and light noise on the strokes."""
    y, x = np.mgrid[0:h, 0:w]
    ink = ((x // 4) % 3 == 0) & (np.abs(y - h / 2) < h / 3)
    img = np.where(ink[:, :, None], 60.0 + rng.normal(0, 2.0, (h, w, channels)), 215.0)
    img += np.arange(channels)[None, None, :] * 12.0
    return np.clip(img, 0, 255).astype(np.uint8)


def _png_filtered(rgb: np.ndarray) -> bytes:
    """An RGB PNG whose rows cycle through the five filters (PIL's encoder
    picks Sub, Up and Paeth on these crops, never None or Average)."""
    h, w, _ = rgb.shape
    raw = rgb.astype(np.int64).reshape(h, w * 3)
    rows = []
    prev = np.zeros(w * 3, np.int64)
    for r in range(h):
        f, cur = r % 5, raw[r]
        left = np.concatenate([np.zeros(3, np.int64), cur[:-3]])
        up_left = np.concatenate([np.zeros(3, np.int64), prev[:-3]])
        if f == 0:
            out = cur
        elif f == 1:
            out = cur - left
        elif f == 2:
            out = cur - prev
        elif f == 3:
            out = cur - (left + prev) // 2
        else:
            p = left + prev - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, up_left))
            out = cur - pred
        rows.append(bytes([f]) + (out & 255).astype(np.uint8).tobytes())
        prev = cur

    def chunk(t, d):
        return struct.pack(">I", len(d)) + t + d + struct.pack(">I", zlib.crc32(d, zlib.crc32(t)))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def fixtures():
    """{file name: encoded bytes}."""
    rng = np.random.default_rng(2024)
    files = {}

    def save(name, im, fmt, **kw):
        buf = io.BytesIO()
        im.save(buf, fmt, **kw)
        files[name] = buf.getvalue()

    for q in (50, 75, 95):
        save(f"gray_q{q}.jpg", PIL.Image.fromarray(crop(rng, 27, 83, 1)[:, :, 0], "L"),
             "JPEG", quality=q)
        for sub, tag in ((0, "444"), (1, "422"), (2, "420")):
            save(f"rgb{tag}_q{q}.jpg", PIL.Image.fromarray(crop(rng, 31, 97, 3)), "JPEG",
                 quality=q, subsampling=sub)
    for sub, tag in ((0, "444"), (1, "422"), (2, "420")):
        save(f"rgb{tag}_rst.jpg", PIL.Image.fromarray(crop(rng, 40, 120, 3)), "JPEG",
             quality=80, subsampling=sub, restart_marker_blocks=3)
    save("gray_rst.jpg", PIL.Image.fromarray(crop(rng, 23, 61, 1)[:, :, 0], "L"), "JPEG",
         quality=85, restart_marker_rows=1)
    save("rgb420_odd.jpg", PIL.Image.fromarray(crop(rng, 17, 35, 3)), "JPEG", quality=90,
         subsampling=2)
    save("rgb420_narrow.jpg", PIL.Image.fromarray(crop(rng, 9, 4, 3)), "JPEG", quality=90,
         subsampling=2)
    save("rgb422_narrow.jpg", PIL.Image.fromarray(crop(rng, 13, 3, 3)), "JPEG", quality=90,
         subsampling=1)
    save("rgb_adobe.jpg", PIL.Image.fromarray(crop(rng, 21, 45, 3)), "JPEG", quality=90,
         keep_rgb=True)

    rgb = crop(rng, 26, 71, 3)
    gray = crop(rng, 26, 71, 1)[:, :, 0]
    save("L.png", PIL.Image.fromarray(gray, "L"), "PNG")
    save("L_trns.png", PIL.Image.fromarray(gray, "L"), "PNG", transparency=int(gray[3, 3]))
    save("RGB.png", PIL.Image.fromarray(rgb), "PNG")
    save("RGB_trns.png", PIL.Image.fromarray(rgb), "PNG",
         transparency=tuple(int(v) for v in rgb[5, 7]))
    save("LA.png", PIL.Image.fromarray(crop(rng, 26, 71, 2), "LA"), "PNG")
    rgba = crop(rng, 26, 71, 4)
    rgba[:, :, 3] = np.clip(rgba[:, :, 3].astype(int) - 60, 0, 255)
    save("RGBA.png", PIL.Image.fromarray(rgba), "PNG")
    pal = PIL.Image.fromarray(rgb).quantize(colors=64)
    save("P.png", pal, "PNG")
    save("P_trns.png", pal, "PNG", transparency=bytes(rng.integers(0, 256, 40, np.uint8)))
    save("P4.png", PIL.Image.fromarray(rgb).quantize(colors=12), "PNG", transparency=5)
    save("L1.png", PIL.Image.fromarray(gray > 128), "PNG")
    save("L2.png", PIL.Image.fromarray(gray, "L"), "PNG", bits=2)
    save("L4.png", PIL.Image.fromarray(gray, "L"), "PNG", bits=4)
    files["filters.png"] = _png_filtered(crop(rng, 15, 40, 3))
    return files


def main() -> None:
    os.makedirs(OUT, exist_ok=True)
    expected = {}
    for name, data in fixtures().items():
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        im = PIL.Image.open(io.BytesIO(data)).convert("RGBA")
        expected[f"{name}:decode"] = np.asarray(im)
        expected[f"{name}:resize"] = np.asarray(im.resize(SIZE, PIL.Image.BICUBIC))
    np.savez_compressed(os.path.join(OUT, "expected.npz"), **expected)
    print(f"{len(expected) // 2} fixtures in {OUT}")


if __name__ == "__main__":
    main()
