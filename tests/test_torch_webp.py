"""The port's WebP decoder (``data/csrc/webpcodec.cpp`` behind
``data.image``) against Pillow 12.1 and cv2 5.0 (both over libwebp 1.6),
bit for bit, on files written here from seeded numpy:

- lossy (VP8) at several qualities and methods, at sizes 1x1, 1xN, Nx1 and
  not multiples of 16; libwebp's own options through its ``WebPEncode``
  (simple loop filter, sharpness, 2-8 token partitions, 1-4 segments, raw
  and filtered ALPH, ``alpha_quality`` < 100, sharp YUV, the
  segment-smooth and dithering preprocessing) and a seeded sweep of them;
- lossless (VP8L): gradients, palettes of 2, 4, 16 and 256 colours (pixel
  bundling), alpha, near-lossless;
- the container: the VP8X alpha flag against the bitstream's alpha (both
  views' channel counts), EXIF orientations 1-8 under cv2's
  ``IMREAD_COLOR``, animations (frame 0 on its canvas), cv2's writer;
- cut-off and broken files raise ``CorruptImage`` where both libraries
  fail, and make a dummy crop in ``LmdbDataset`` as in JAX's;
- ``LmdbDataset`` over a tree of WebP crops and ``RawDataset`` over WebP
  crops named ``.jpg`` give JAX's ``ResizeNormalize`` tensors bitwise.
"""

import importlib.util
import io
import os
from pathlib import Path

import cv2
import numpy as np
import PIL.Image
import pytest
import torch

from mrn_tpu.config import default_options as jax_options
from mrn_tpu.data import dataset as jax_dataset
from mrn_tpu.data.transform import ResizeNormalize as JaxResizeNormalize
from mrn_tpu_torch.config import default_options
from mrn_tpu_torch.data import dataset, image, lmdb_store
from mrn_tpu_torch.data.transform import ResizeNormalize

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "make_torch_webp_fixtures", ROOT / "scripts" / "make_torch_webp_fixtures.py")
wx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(wx)

IMG_H, IMG_W = 32, 64


def _picture(seed, h, w, kind="scene"):
    """An RGBA test picture: a word-like scene on a gradient with noise,
    or plain noise."""
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(x / 5.0 + c) * 90 + np.cos(y / 3.0 - c) * 40 + 128
                     for c in range(3)], axis=2)
    base += rng.normal(0, 12, base.shape)
    for _ in range(6):
        y0, x0 = rng.integers(0, max(1, h)), rng.integers(0, max(1, w))
        base[y0:y0 + rng.integers(1, 6), x0:x0 + rng.integers(2, 15)] = rng.integers(0, 60)
    alpha = np.clip(x * 255.0 / max(1, w - 1) + rng.normal(0, 20, (h, w)), 0, 255)
    return np.dstack([np.clip(base, 0, 255), alpha]).astype(np.uint8)


def _pil_save(array, **kw):
    buf = io.BytesIO()
    PIL.Image.fromarray(array).save(buf, "WEBP", **kw)
    return buf.getvalue()


def _check(data):
    """Both views equal the libraries': Pillow's RGBA, cv2's two flags in
    dtype, shape and bytes."""
    ref = np.asarray(PIL.Image.open(io.BytesIO(data)).convert("RGBA"))
    got = image.decode(data)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    for flags in (image.IMREAD_COLOR, image.IMREAD_UNCHANGED):
        want = cv2.imdecode(np.frombuffer(data, np.uint8), flags)
        have = image.imdecode(data, flags)
        assert have.dtype == want.dtype and have.shape == want.shape, flags
        np.testing.assert_array_equal(have, want)


# ------------------------------------------------------------------ lossy
@pytest.mark.parametrize("quality,method", [(0, 0), (20, 2), (50, 4), (75, 5), (95, 6),
                                            (100, 3)])
def test_lossy_qualities_and_methods(quality, method):
    _check(_pil_save(_picture(quality, 37, 83)[:, :, :3], quality=quality, method=method))


@pytest.mark.parametrize("h,w", [(1, 1), (1, 19), (23, 1), (16, 16), (17, 33), (47, 129)])
def test_lossy_and_lossless_sizes(h, w):
    pic = _picture(h * 1000 + w, h, w)
    _check(_pil_save(pic[:, :, :3], quality=70))
    _check(_pil_save(pic, quality=70))
    _check(_pil_save(pic, lossless=True))


LIBWEBP = {
    "simple filter": dict(quality=60, filter_type=0, filter_strength=80),
    "simple filter sharp": dict(quality=40, filter_type=0, filter_sharpness=6),
    "strong filter sharpness 3": dict(quality=50, filter_type=1, filter_strength=100,
                                      filter_sharpness=3),
    "no filter": dict(quality=80, filter_strength=0),
    "2 partitions": dict(quality=60, partitions=1),
    "4 partitions": dict(quality=60, partitions=2),
    "8 partitions": dict(quality=70, partitions=3, segments=4),
    "1 segment": dict(quality=30, segments=1),
    "2 segments": dict(quality=60, segments=2, sns_strength=100),
    "3 segments": dict(quality=90, segments=3),
    "raw ALPH": dict(quality=70, alpha_compression=0),
    "raw ALPH horizontal": dict(quality=70, alpha_compression=0, alpha_filtering=1),
    "ALPH best filter": dict(quality=70, alpha_filtering=2),
    "ALPH no filter": dict(quality=70, alpha_filtering=0),
    "alpha quality 20": dict(quality=70, alpha_quality=20, alpha_filtering=2),
    "sharp yuv": dict(quality=85, use_sharp_yuv=1),
    "segment smooth": dict(quality=60, preprocessing=1),
    "dithering preprocessing": dict(quality=60, preprocessing=2),
    "autofilter": dict(quality=45, autofilter=1),
}


@pytest.mark.parametrize("name", sorted(LIBWEBP))
def test_libwebp_options(name):
    _check(wx.webp_encode(_picture(len(name), 45, 70), **LIBWEBP[name]))


def test_libwebp_sweep():
    """Seeded option sets over noise and scenes, lossy and lossless."""
    rng = np.random.default_rng(21)
    for i in range(24):
        h, w = (int(v) for v in rng.integers(1, 60, 2))
        pic = _picture(100 + i, h, w, "noise" if i % 3 == 0 else "scene")
        if i % 4 == 3:
            opts = dict(lossless=1, quality=float(rng.integers(0, 101)),
                        method=int(rng.integers(0, 7)), exact=int(rng.integers(0, 2)))
            if i % 8 == 7:
                opts["near_lossless"] = int(rng.integers(0, 100))
        else:
            opts = dict(quality=float(rng.integers(0, 101)), method=int(rng.integers(0, 7)),
                        segments=int(rng.integers(1, 5)), partitions=int(rng.integers(0, 4)),
                        filter_type=int(rng.integers(0, 2)),
                        filter_strength=int(rng.integers(0, 101)),
                        filter_sharpness=int(rng.integers(0, 8)),
                        sns_strength=int(rng.integers(0, 101)),
                        alpha_compression=int(rng.integers(0, 2)),
                        alpha_filtering=int(rng.integers(0, 3)),
                        alpha_quality=int(rng.integers(0, 101)))
        if i % 5 == 0:
            pic[:, :, 3] = 255
        _check(wx.webp_encode(pic, **opts))


# --------------------------------------------------------------- lossless
@pytest.mark.parametrize("colours", [2, 3, 4, 11, 16, 17, 256])
def test_lossless_palettes(colours):
    rng = np.random.default_rng(colours)
    pal = rng.integers(0, 256, (colours, 4), dtype=np.uint8)
    idx = rng.integers(0, colours, (29, 61))
    idx[:, 10:30] = idx[:, 10:11]   # runs for the backward references
    _check(_pil_save(pal[idx], lossless=True))
    _check(_pil_save(np.ascontiguousarray(pal[idx][:, :, :3]), lossless=True, method=6))


@pytest.mark.parametrize("method", [0, 3, 6])
def test_lossless_gradients_and_alpha(method):
    y, x = np.mgrid[0:50, 0:90]
    grad = np.stack([x * 2, y * 5, (x + y) % 256, 255 - x], axis=2).astype(np.uint8)
    _check(_pil_save(grad, lossless=True, method=method))
    _check(_pil_save(np.ascontiguousarray(grad[:, :, :3]), lossless=True, method=method))
    _check(_pil_save(_picture(method, 40, 66), lossless=True, method=method, exact=True))


# -------------------------------------------------------------- container
def test_cv2_writer():
    bgr = _picture(7, 41, 77)[:, :, :3]
    for quality in (10, 60, 100, 101):     # above 100: lossless
        ok, data = cv2.imencode(".webp", bgr, [cv2.IMWRITE_WEBP_QUALITY, quality])
        assert ok
        _check(data.tobytes())
    ok, data = cv2.imencode(".webp", _picture(8, 20, 30), [cv2.IMWRITE_WEBP_QUALITY, 80])
    _check(data.tobytes())


def test_alpha_flag_against_the_bitstream():
    """Pillow's mode follows WebPGetFeatures (the VP8L header's alpha bit,
    or VP8X's flag and an ALPH chunk); cv2's channels follow VP8X's flag;
    the demuxer drops ALPH where the flag is missing."""
    pic = _picture(3, 12, 18)
    pic[:, :, 3] = np.clip(pic[:, :, 3], 90, 255)
    lossy = dict(wx.chunks(wx.webp_encode(pic, quality=70)))
    vp8l = dict(wx.chunks(_pil_save(pic, lossless=True)))[b"VP8L"]
    no_bit = bytearray(vp8l)
    no_bit[1:5] = (int.from_bytes(vp8l[1:5], "little") & ~(1 << 28)).to_bytes(4, "little")
    frame = [(b"ALPH", lossy[b"ALPH"]), (b"VP8 ", lossy[b"VP8 "])]
    files = [wx.riff([wx.vp8x(flags, 18, 12)] + parts)
             for flags in (0, wx.ALPHA)
             for parts in (frame, frame[1:], [(b"VP8L", vp8l)], [(b"VP8L", bytes(no_bit))])]
    files.append(wx.riff([(b"VP8L", bytes(no_bit))]))
    files.append(wx.riff([wx.vp8x(wx.ALPHA, 18, 12), (b"ICCP", b"\0" * 30),
                          (b"XMP ", b"<x/>"), (b"ABCD", b"123")] + frame))
    for data in files:
        _check(data)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_in_cv2_view(orientation):
    """cv2 turns the image by the EXIF chunk VP8X flags (Pillow does not);
    without the flag, or behind an "Exif" prefix, it does not."""
    pic = _picture(orientation, 13, 21)
    data = wx.with_exif(_pil_save(pic, quality=80), orientation)
    _check(data)
    turned = image.imdecode(data, image.IMREAD_COLOR)
    assert turned.shape[:2] == ((21, 13) if orientation >= 5 else (13, 21))
    parts = wx.chunks(data)
    flags = int.from_bytes(parts[0][1][:4], "little")
    _check(wx.riff([(b"VP8X", (flags & ~wx.EXIF).to_bytes(4, "little") + parts[0][1][4:])]
                   + parts[1:]))
    _check(wx.riff(parts[:-1] + [(b"EXIF", b"Exif\0\0" + parts[-1][1])]))


def test_animated_frame_zero():
    rgb = _picture(5, 30, 40)[:, :, :3]
    frames = [PIL.Image.fromarray(rgb), PIL.Image.fromarray(255 - rgb),
              PIL.Image.fromarray(rgb[::-1].copy())]
    for kw in (dict(quality=70), dict(lossless=True)):
        buf = io.BytesIO()
        frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], duration=50, **kw)
        _check(buf.getvalue())
    small = wx.chunks(wx.webp_encode(_picture(6, 9, 14), quality=60))
    parts = [p for p in small if p[0] in (b"ALPH", b"VP8 ")]
    lossless = wx.chunks(_pil_save(_picture(7, 9, 14), lossless=True))
    for flags in (wx.ALPHA | wx.ANIMATION, wx.ANIMATION):
        for frame in (parts, lossless):
            _check(wx.riff([wx.vp8x(flags, 30, 20), wx.anim((200, 100, 50, 255), 3),
                            wx.anmf(6, 4, 14, 9, frame), wx.anmf(0, 0, 14, 9, parts)]))


def test_cut_off_and_broken_files_are_corrupt(tmp_path):
    """Where Pillow and cv2 both fail, the port raises CorruptImage (an
    OSError: LmdbDataset's dummy crop, as JAX's)."""
    data = {"lossy": _pil_save(_picture(1, 40, 50), quality=80),
            "lossless": _pil_save(_picture(2, 40, 50), lossless=True),
            "alpha": wx.webp_encode(_picture(3, 40, 50), quality=80)}
    broken = []
    for whole in data.values():
        broken += [whole[:n] for n in (11, 20, 30, 60, len(whole) // 2, len(whole) - 1)]
        bad_riff = bytearray(whole)
        bad_riff[4:8] = (len(whole) + 10).to_bytes(4, "little")
        broken.append(bytes(bad_riff))
    parts = wx.chunks(data["lossy"])
    broken.append(wx.riff([wx.vp8x(0, 49, 40)] + parts))           # canvas of another size
    broken.append(wx.riff([(b"ALPH", b"\x00" * 8)] + parts))      # no VP8 / VP8L / VP8X first
    vp8 = bytearray(parts[0][1])
    vp8[3] = 0                                                     # bad start code
    broken.append(wx.riff([(b"VP8 ", bytes(vp8))]))
    for bad in broken:
        assert _pillow_fails(bad)
        assert cv2.imdecode(np.frombuffer(bad, np.uint8), cv2.IMREAD_UNCHANGED) is None
        for call in (image.decode, lambda b: image.imdecode(b, image.IMREAD_UNCHANGED)):
            with pytest.raises(image.CorruptImage):
                call(bad)
    w = lmdb_store.LmdbWriter(str(tmp_path / "cut"))
    w.put(b"num-samples", b"1")
    w.put(b"image-000000001", broken[4])
    w.put(b"label-000000001", b"ab")
    w.commit()
    opt, jopt = _opts()
    assert dataset.LmdbDataset(str(tmp_path / "cut"), opt)[0][1] == "[dummy_label]" == \
        jax_dataset.LmdbDataset(str(tmp_path / "cut"), jopt)[0][1]


def _pillow_fails(data):
    try:
        PIL.Image.open(io.BytesIO(data)).convert("RGBA")
    except OSError:
        return True
    return False


# -------------------------------------------------------------- datasets
def _opts():
    common = dict(il="mrn", batch_size=4, imgH=IMG_H, imgW=IMG_W, manual_seed=111,
                  batch_max_length=8, lan_list=["T0"])
    return default_options(**common), jax_options(**common)


def _normed(batch):
    return ((torch.as_tensor(batch).float() / 255.0 - 0.5) / 0.5).numpy()


def test_datasets_over_webp_crops_match_jax(tmp_path):
    """LmdbDataset over an LMDB of WebP crops, and RawDataset over WebP
    crops named .jpg, give JAX's ResizeNormalize tensors bitwise."""
    crops = [_pil_save(_picture(i, 20 + 3 * i, 50 + 7 * i)[:, :, :3], quality=40 + 10 * i)
             for i in range(3)]
    crops += [_pil_save(_picture(9, 31, 57), lossless=True),
              wx.webp_encode(_picture(10, 26, 90), quality=60, alpha_compression=0),
              wx.with_exif(_pil_save(_picture(11, 30, 44), quality=70), 6)]
    w = lmdb_store.LmdbWriter(str(tmp_path / "webp"))
    w.put(b"num-samples", str(len(crops)).encode())
    for i, data in enumerate(crops, 1):
        w.put(b"image-%09d" % i, data)
        w.put(b"label-%09d" % i, b"abc")
    w.commit()
    opt, jopt = _opts()
    to_jax = JaxResizeNormalize((IMG_W, IMG_H))
    got = dataset.LmdbDataset(str(tmp_path / "webp"), opt)
    ref = jax_dataset.LmdbDataset(str(tmp_path / "webp"), jopt)
    assert len(got) == len(ref) == len(crops)
    for i in range(len(ref)):
        (g, gl), (r, rl) = got[i], ref[i]
        assert gl == rl == "abc"
        assert _normed(ResizeNormalize((IMG_W, IMG_H))(g)[None]).tobytes() == \
            to_jax(r)[None].astype(np.float32).tobytes()
    folder = tmp_path / "raw"
    folder.mkdir()
    for i, data in enumerate(crops):
        (folder / f"crop{i}.jpg").write_bytes(data)
    got, ref = dataset.RawDataset(str(folder), opt), jax_dataset.RawDataset(str(folder), jopt)
    assert got.image_path_list == ref.image_path_list and len(got) == len(crops)
    for i in range(len(got)):
        (g, gp), (r, rp) = got[i], ref[i]
        assert gp == rp
        np.testing.assert_array_equal(g, np.asarray(r.resize((IMG_W, IMG_H),
                                                             PIL.Image.BICUBIC)))
    assert os.path.basename(ref.image_path_list[0]).endswith(".jpg")
