"""Regenerates ``tests/fixtures/torch_forms/``: a small scene tree and word
crops in the image forms a scene tree brings, with what Pillow, cv2 and the
JAX package's ``crop_by_word`` make of them.

- ``imgs/`` + ``gts/``: nine scenes (at most 200x150) of words from the
  campaign's first alphabet (``data.synthetic``'s bit renderer) pasted on
  noise, one per form: baseline, progressive, 4:1:1, CMYK and
  EXIF-rotated JPEG; 8-bit, palette + tRNS, 16-bit and interlaced PNG.
  The gts are SynthMLT lines (``x1,y1,...,x4,y4,language,word``) with a
  BOM, a box past the edge, an empty box and a short line among them.
- ``crops/``: word crops in every form the port decodes beyond baseline
  JPEG and 8-bit PNG (progressive, 4:1:1, 4:4:0, CMYK and EXIF JPEG;
  16-bit gray / RGB / RGBA / LA, interlaced RGB and palette PNG; GIF
  plain and interlaced with transparency; BMP 8/24/16/32-bit, V5
  BITFIELDS, RLE8 and RLE4) and ``labels.txt`` (``name word``).
- ``expected.npz``: for every file the SHA-1 (``digest``: dtype, shape
  and bytes) of ``<path>:pil`` (Pillow's ``open().convert("RGBA")``),
  ``<path>:cv_color`` and ``<path>:cv_unchanged`` (cv2's ``imdecode``
  with ``IMREAD_COLOR`` / ``IMREAD_UNCHANGED``; absent where the port's
  cv2 view raises) -- the decoded scenes are near full entropy, and their
  arrays would not fit the fixtures' 600 KB -- and the JAX
  ``crop_by_word`` run on the tree: ``jax:names``, ``jax:label``
  (``label.txt``'s bytes) and ``jax:crop:<name>`` (each crop under cv2's
  ``IMREAD_UNCHANGED``, as an array).

    python3 scripts/make_torch_forms_fixtures.py

Needs Pillow, cv2 and the JAX package's tools, so it runs where the tests
run; neither library writes Adam7 PNG, 16-bit LA PNG or RLE / BITFIELDS
BMP, so small writers here do.  ``tests/test_torch_forms_fixtures.py``
holds the committed files to what this script writes, and ``chip_smoke.py``
holds the port's codec and ``crop_by_word`` against them on the machine
with the card, which has neither library.
"""

from __future__ import annotations

import hashlib
import io
import os
import shutil
import struct
import sys
import tempfile
import zlib
from typing import Dict, Tuple

import cv2
import numpy as np
import PIL.Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mrn_tpu.data.synthetic import synth_word_image_bits  # noqa: E402
from mrn_tpu.tools import crop_by_word as jax_crop  # noqa: E402
from mrn_tpu_torch import campaign  # noqa: E402
from mrn_tpu_torch.data import image as image_codec  # noqa: E402

OUT = os.path.join(ROOT, "tests", "fixtures", "torch_forms")
SEED = 2026
LANGUAGE = campaign.LANS[0]
ALPHABET = campaign.task_alphabets()[0]
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


# ---------------------------------------------------------------- writers
def _chunk(ctype: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + ctype + data + struct.pack(
        ">I", zlib.crc32(data, zlib.crc32(ctype)))


def _pack_rows(s: np.ndarray, depth: int) -> np.ndarray:
    h, w, c = s.shape
    if depth == 16:
        return s.astype(">u2").reshape(h, w * c).view(np.uint8).reshape(h, -1)
    if depth == 8:
        return s.astype(np.uint8).reshape(h, w * c)
    per = 8 // depth
    v = np.concatenate([s[:, :, 0].astype(np.uint8), np.zeros((h, -w % per), np.uint8)], axis=1)
    v = v.reshape(h, -1, per)
    out = np.zeros(v.shape[:2], np.uint8)
    for i in range(per):
        out |= v[:, :, i] << (8 - depth * (i + 1))
    return out


def _filtered(rows: np.ndarray, bpp: int, start: int) -> bytes:
    """Rows cycling through the five PNG filters from filter ``start``."""
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for r in range(rows.shape[0]):
        cur, f = rows[r].astype(np.int64), (start + r) % 5
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if f == 0:
            o = cur
        elif f == 1:
            o = cur - left
        elif f == 2:
            o = cur - prev
        elif f == 3:
            o = cur - (left + prev) // 2
        else:
            p = left + prev - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - up_left)
            o = cur - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, up_left))
        out.append(bytes([f]) + (o & 255).astype(np.uint8).tobytes())
        prev = cur
    return b"".join(out)


def write_png(samples: np.ndarray, ctype: int, depth: int, interlace: bool = False,
              plte: bytes = b"", trns: bytes = b"", extra: bytes = b"") -> bytes:
    """A PNG of ``samples`` [h, w, channels] as stored (palette indices,
    16-bit values), plain or Adam7-interlaced."""
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[:, :, None]
    h, w, c = s.shape
    bpp = max(1, c * depth // 8)
    if interlace:
        raw = b"".join(_filtered(_pack_rows(s[y0::dy, x0::dx], depth), bpp, i)
                       for i, (x0, y0, dx, dy) in enumerate(ADAM7) if w > x0 and h > y0)
    else:
        raw = _filtered(_pack_rows(s, depth), bpp, 0)
    out = PNG_HEAD + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                  int(interlace)))
    out += extra
    if plte:
        out += _chunk(b"PLTE", plte)
    if trns:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


PNG_HEAD = b"\x89PNG\r\n\x1a\n"


def write_bmp(pixels: np.ndarray, bits: int, header: int = 40, palette=None, masks=None,
              compression: int = 0, top_down: bool = False, rle: bytes = None) -> bytes:
    """A BMP (an INFO header or larger) of [h, w] indices (bits 1, 4, 8),
    [h, w, 3] RGB (24) or [h, w] packed words (16 / 32, laid out per
    ``masks``, which need a header of 52 bytes or more); ``rle`` the RLE
    stream."""
    pixels = np.asarray(pixels)
    h, w = pixels.shape[:2]
    pal = b""
    if palette is not None:
        pal = b"".join(bytes([b, g, r, 0]) for r, g, b in palette)
    if rle is not None:
        data = rle
    else:
        rows = []
        for y in (range(h) if top_down else range(h - 1, -1, -1)):
            r = pixels[y]
            if bits == 1:
                b = np.packbits(r.astype(np.uint8)).tobytes()
            elif bits == 4:
                v = np.concatenate([r, [0] * (w % 2)]).astype(np.uint8).reshape(-1, 2)
                b = ((v[:, 0] << 4) | v[:, 1]).astype(np.uint8).tobytes()
            elif bits == 8:
                b = r.astype(np.uint8).tobytes()
            elif bits == 16:
                b = r.astype("<u2").tobytes()
            elif bits == 24:
                b = r[:, ::-1].astype(np.uint8).tobytes()
            else:
                b = r.astype("<u4").tobytes()
            rows.append(b + b"\0" * (-len(b) % 4))
        data = b"".join(rows)
    height = (-h) & 0xFFFFFFFF if top_down else h
    hdr = struct.pack("<IIIHHIIIIII", header, w, height, 1, bits, compression, len(data),
                      2835, 2835, len(palette) if palette is not None else 0, 0)
    if header >= 52 and masks is not None:
        hdr += struct.pack("<IIII", *(list(masks) + [0] * (4 - len(masks))))
    hdr += b"\0" * (header - len(hdr))
    off = 14 + len(hdr) + len(pal)
    return b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off) + hdr + pal + data


def _rle8(idx: np.ndarray) -> bytes:
    """RLE8 rows (bottom first): a run, an absolute stretch, a run, EOL."""
    h, w = idx.shape
    out = b""
    for r in idx[::-1]:
        out += bytes([3, r[0]]) + bytes([0, 5]) + bytes(r[3:8].tolist()) + b"\0"
        out += bytes([w - 8, r[8]]) + b"\0\0"
    return out + b"\0\1"


def _rle4(idx: np.ndarray) -> bytes:
    """RLE4 rows (bottom first): a two-colour run, an absolute stretch of
    six, a run, EOL."""
    h, w = idx.shape
    out = b""
    for r in idx[::-1]:
        r = r.tolist()
        out += bytes([3, (r[0] << 4) | r[1]]) + bytes([0, 6])
        out += bytes([(r[3] << 4) | r[4], (r[5] << 4) | r[6], (r[7] << 4) | r[8]]) + b"\0"
        out += bytes([w - 9, (r[9] << 4) | r[10]]) + b"\0\0"
    return out + b"\0\1"


def _exif(orientation: int) -> bytes:
    """A little-endian TIFF block with IFD0's Orientation."""
    return (b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack("<I", 0))


def _pil(im: PIL.Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def _cv_jpeg(bgr: np.ndarray, sampling: int, quality: int = 90) -> bytes:
    ok, data = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, quality,
                                          cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling])
    assert ok
    return data.tobytes()


# ------------------------------------------------------------------ content
def _word(rng, n_min: int = 2, n_max: int = 5) -> str:
    n = int(rng.integers(n_min, n_max + 1))
    return "".join(ALPHABET[int(i)] for i in rng.integers(0, 64, n))


def _render(rng, word: str, h: int, w: int) -> np.ndarray:
    """The bit renderer's RGB, its noise cut to steps of 8 (the fixtures
    stay small)."""
    index = {ch: i for i, ch in enumerate(ALPHABET)}
    return synth_word_image_bits(word, index, h, w, rng)[:, :, :3] // 8 * 8 + 4


def _noise(rng, h: int, w: int) -> np.ndarray:
    """Coarse noise: random 8-px cells, bilinearly smoothed."""
    cells = rng.integers(60, 200, ((h + 7) // 8 + 1, (w + 7) // 8 + 1, 3)).astype(np.float64)
    ys, xs = (np.arange(h) + 0.5) / 8, (np.arange(w) + 0.5) / 8
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    top = cells[y0][:, x0] * (1 - fx) + cells[y0][:, x0 + 1] * fx
    bot = cells[y0 + 1][:, x0] * (1 - fx) + cells[y0 + 1][:, x0 + 1] * fx
    img = top * (1 - fy) + bot * fy
    return np.clip(img, 0, 255).astype(np.uint8)


def _scene(rng, h: int, w: int) -> Tuple[np.ndarray, str]:
    """An RGB scene with three words and its gt text (with a BOM, a box
    past the right edge, a zero-width box and a short line)."""
    img = _noise(rng, h, w)
    lines = []
    for k in range(3):
        word = _word(rng)
        wh = int(rng.integers(18, 26))
        ww = min(w - 8, wh * len(word) + int(rng.integers(0, 10)))
        y = 6 + k * (h - 12) // 3
        x = int(rng.integers(2, max(3, w - ww - 2)))
        img[y:y + wh, x:x + ww] = _render(rng, word, wh, ww)
        jx, jy = rng.uniform(-1.5, 1.5, 2)
        quad = [x + jx, y, x + ww, y + jy, x + ww - jx, y + wh, x, y + wh - jy]
        if k == 2:    # past the right edge: crop_img clips it
            quad[2] += 12
            quad[4] += 12
        lines.append(",".join(f"{v:.1f}" for v in quad) + f",{LANGUAGE},{word}")
    lines.insert(1, f"5,5,5,5,5,9,5,9,{LANGUAGE},{_word(rng)}")   # zero width: no crop
    lines.append("1,2,3,4")                                       # short: skipped
    return img, "\ufeff" + "\n".join(lines) + "\n"


def scenes(rng) -> Dict[str, bytes]:
    """{"imgs/<name>": bytes, "gts/<name>.txt": bytes}, one scene a form."""
    files = {}

    def put(name, data, gt):
        files[f"imgs/{name}"] = data
        files[f"gts/{os.path.splitext(name)[0]}.txt"] = gt.encode("utf-8")

    img, gt = _scene(rng, 150, 200)
    put("s0_baseline.jpg", _pil(PIL.Image.fromarray(img), "JPEG", quality=90), gt)
    img, gt = _scene(rng, 120, 170)
    put("s1_progressive.jpg", _pil(PIL.Image.fromarray(img), "JPEG", quality=85,
                                   progressive=True), gt)
    img, gt = _scene(rng, 110, 190)
    put("s2_411.jpg", _cv_jpeg(img[:, :, ::-1], cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411), gt)
    img, gt = _scene(rng, 100, 150)
    put("s3_cmyk.jpg", _pil(PIL.Image.fromarray(img).convert("CMYK"), "JPEG", quality=90), gt)
    img, gt = _scene(rng, 140, 110)      # shown upright after orientation 6 (90 degrees CW)
    exif = PIL.Image.Exif()
    exif[0x0112] = 6
    put("s4_exif6.jpg", _pil(PIL.Image.fromarray(np.ascontiguousarray(np.rot90(img))), "JPEG",
                             quality=90, exif=exif), gt)
    img, gt = _scene(rng, 100, 160)
    put("s5_rgb.png", _pil(PIL.Image.fromarray(img), "PNG"), gt)
    img, gt = _scene(rng, 90, 160)
    pal = PIL.Image.fromarray(img).quantize(64, dither=PIL.Image.Dither.NONE)
    put("s6_palette.png", _pil(pal, "PNG", transparency=int(np.asarray(pal)[0, 0])), gt)
    img, gt = _scene(rng, 90, 150)
    deep = img.astype(np.uint16) * 256 + img.astype(np.uint16) * 7 % 256
    ok, data = cv2.imencode(".png", deep[:, :, ::-1])
    assert ok
    put("s7_rgb16.png", data.tobytes(), gt)
    img, gt = _scene(rng, 95, 140)
    put("s8_interlaced.png", write_png(img, 2, 8, interlace=True), gt)
    return files


def crops(rng) -> Tuple[Dict[str, bytes], str]:
    """{"crops/<name>": bytes} in every new form, and labels.txt."""
    files, labels = {}, []

    def put(name, data, word):
        files[f"crops/{name}"] = data
        labels.append(f"{name} {word}")

    def next_word(h=28):
        word = _word(rng, 2, 4)
        return word, _render(rng, word, h, h * len(word) + 6)

    word, rgb = next_word()
    put("c00_progressive.jpg", _pil(PIL.Image.fromarray(rgb), "JPEG", quality=80,
                                    progressive=True, subsampling=2), word)
    word, rgb = next_word(27)
    put("c01_411.jpg", _cv_jpeg(rgb[:, :, ::-1], cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411), word)
    word, rgb = next_word(25)
    put("c02_440.jpg", _cv_jpeg(rgb[:, :, ::-1], cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440), word)
    word, rgb = next_word()
    put("c03_cmyk.jpg", _pil(PIL.Image.fromarray(rgb).convert("CMYK"), "JPEG", quality=85), word)
    word, rgb = next_word()
    exif = PIL.Image.Exif()
    exif[0x0112] = 3
    put("c04_exif3.jpg", _pil(PIL.Image.fromarray(rgb), "JPEG", quality=85, exif=exif), word)
    word, rgb = next_word()
    gray = rgb.mean(axis=2).astype(np.uint16)
    put("c05_gray16.png", _pil(PIL.Image.fromarray(gray * 3 + 40), "PNG"), word)   # I;16 past 255
    word, rgb = next_word()
    put("c06_rgb16.png", write_png(rgb.astype(np.uint16) * 257 + 3, 2, 16,
                                   trns=struct.pack(">HHH", *(rgb[0, 0].astype(int) * 257 + 3))),
        word)
    word, rgb = next_word()
    alpha = np.full(rgb.shape[:2] + (1,), 65535, np.uint16)
    alpha[:, :4] = 20000
    put("c07_rgba16.png", write_png(np.concatenate([rgb.astype(np.uint16) * 257, alpha], 2),
                                    6, 16), word)
    word, rgb = next_word()
    la = np.stack([rgb[:, :, 0].astype(np.uint16) * 256 + 7, np.full(rgb.shape[:2], 50000,
                                                                       np.uint16)], 2)
    put("c08_la16.png", write_png(la, 4, 16), word)
    word, rgb = next_word(29)
    put("c09_interlaced.png", write_png(rgb, 2, 8, interlace=True), word)
    word, rgb = next_word()
    p = PIL.Image.fromarray(rgb).quantize(16, dither=PIL.Image.Dither.NONE)
    plte = bytes(p.getpalette()[:48])
    put("c10_interlaced_p4.png", write_png(np.asarray(p), 3, 4, interlace=True, plte=plte,
                                           trns=b"\x80\x00"), word)
    word, rgb = next_word()
    put("c11_plain.gif", _pil(PIL.Image.fromarray(rgb).quantize(32), "GIF", interlace=False),
        word)
    word, rgb = next_word()
    p = PIL.Image.fromarray(rgb).quantize(64)
    put("c12_interlaced_trns.gif", _pil(p, "GIF", interlace=True,
                                        transparency=int(np.asarray(p)[0, 0])), word)
    word, rgb = next_word()
    p = PIL.Image.fromarray(rgb).quantize(200)
    put("c13_pal8.bmp", _pil(p, "BMP"), word)
    word, rgb = next_word()
    put("c14_rgb24.bmp", _pil(PIL.Image.fromarray(rgb), "BMP"), word)
    word, rgb = next_word()
    c = rgb.astype(np.uint32) >> 3
    put("c15_rgb555.bmp", write_bmp((c[:, :, 0] << 10) | (c[:, :, 1] << 5) | c[:, :, 2], 16,
                                    top_down=True), word)
    word, rgb = next_word()
    c = rgb.astype(np.uint32)
    words32 = (c[:, :, 0] << 16) | (c[:, :, 1] << 8) | c[:, :, 2] | (np.uint32(230) << 24)
    put("c16_bgra_v5.bmp", write_bmp(words32, 32, 124, masks=(0xFF0000, 0xFF00, 0xFF,
                                                              0xFF000000), compression=3), word)
    word, rgb = next_word()
    p = PIL.Image.fromarray(rgb).quantize(40)
    idx = np.asarray(p)
    pal = np.asarray(p.getpalette()[:120]).reshape(-1, 3).tolist()
    put("c17_rle8.bmp", write_bmp(idx, 8, palette=pal, compression=1, rle=_rle8(idx)), word)
    word, rgb = next_word()
    p = PIL.Image.fromarray(rgb).quantize(16)
    idx = np.asarray(p)
    pal = np.asarray(p.getpalette()[:48]).reshape(-1, 3).tolist()
    put("c18_rle4.bmp", write_bmp(idx, 4, palette=pal, compression=2, rle=_rle4(idx)), word)
    return files, "\n".join(labels) + "\n"


# ------------------------------------------------------------------ expected
def digest(array: np.ndarray) -> str:
    """SHA-1 of an array's dtype, shape and bytes (``chip_smoke.py`` has the
    same)."""
    array = np.ascontiguousarray(array)
    return hashlib.sha1(f"{array.dtype}{array.shape}".encode() + array.tobytes()).hexdigest()


def expected_views(files: Dict[str, bytes]) -> Dict[str, str]:
    """The digests of Pillow's and cv2's decodes of every image file."""
    out = {}
    for name, data in sorted(files.items()):
        if not name.startswith(("imgs/", "crops/")) or name.endswith(".txt"):
            continue
        out[f"{name}:pil"] = digest(np.asarray(PIL.Image.open(io.BytesIO(data)).convert("RGBA")))
        try:    # the forms the port's cv2 view raises on (RLE, BITFIELDS BMP) stay out
            image_codec.imdecode(data, image_codec.IMREAD_COLOR)
        except image_codec.UnsupportedImage:
            continue
        for which, flag in (("cv_color", cv2.IMREAD_COLOR), ("cv_unchanged",
                                                             cv2.IMREAD_UNCHANGED)):
            out[f"{name}:{which}"] = digest(cv2.imdecode(np.frombuffer(data, np.uint8), flag))
    return out


def jax_crops(tree: str) -> Dict[str, np.ndarray]:
    """The JAX tool on ``tree`` (one process): names, label.txt, crops."""
    with tempfile.TemporaryDirectory() as tmp:
        files = jax_crop.collect_files(os.path.join(tree, "imgs"), os.path.join(tree, "gts"))
        infos = jax_crop.collect_annotations(files, nproc=1)
        lines = jax_crop.generate_ann(tree, infos, tmp)
        names = sorted(os.listdir(os.path.join(tmp, "imgs")))
        with open(os.path.join(tmp, "label.txt"), "rb") as f:
            label = f.read()
        out = {"jax:names": np.array(names), "jax:label": np.frombuffer(label, np.uint8)}
        for name in names:
            out[f"jax:crop:{name}"] = cv2.imread(os.path.join(tmp, "imgs", name),
                                                 cv2.IMREAD_UNCHANGED)
        assert len(lines) == len(names)
    return out


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
    expected.update(jax_crops(out))
    np.savez_compressed(os.path.join(out, "expected.npz"), **expected)


if __name__ == "__main__":
    build(OUT)
    total = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(OUT) for f in fs)
    print(f"wrote {OUT}: {total / 1024:.0f} KB")
