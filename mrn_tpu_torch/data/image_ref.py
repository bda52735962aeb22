"""The slow numpy version of ``data.image``'s decoder and resize, for the
tests: the same PNG unfilter and RGBA conversion (8-bit and lower, not
interlaced), baseline JPEG decode (libjpeg-turbo's integer IDCT, fancy
upsampling and colour tables; 1 or 3 components at 4:4:4, 4:2:2 or 4:2:0)
and Pillow's bicubic resize, written apart from ``csrc/imagecodec.cpp`` so
the two can be held against each other.  Raises ``data.image``'s errors;
the other forms ``data.image`` decodes (progressive and any-sampling JPEG,
CMYK, 16-bit and interlaced PNG, GIF, BMP, WebP) raise ``UnsupportedImage`` here
and are held against Pillow and cv2 themselves.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from mrn_tpu_torch.data.image import (CorruptImage, UnsupportedImage, image_format,
                                      parse_png, to_rgba)

__all__ = ["decode", "resize"]

PRECISION_BITS = 22
ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
                   12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
                   35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                   58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
                  + [63] * 16)


# ------------------------------------------------------------------ resize
def _bicubic(x: float) -> float:
    x = abs(x)
    if x < 1.0:
        return ((-0.5 + 2.0) * x - (-0.5 + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * -0.5
    return 0.0


def _coeffs(in_size: int, out_size: int):
    """Resample.c's bounds and fixed-point taps: ``(xmin [out], taps [out,
    ksize] int64, counts [out])``."""
    scale = float(np.float32(in_size)) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    kk = np.zeros((out_size, ksize), np.int64)
    xmins, counts = np.zeros(out_size, np.int64), np.zeros(out_size, np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_bicubic((x + xmin - center + 0.5) * (1.0 / filterscale)) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        if ww != 0.0:
            w = [v / ww for v in w]
        kk[xx, :xmax] = [int(-0.5 + v * (1 << PRECISION_BITS)) if v < 0
                         else int(0.5 + v * (1 << PRECISION_BITS)) for v in w]
        xmins[xx], counts[xx] = xmin, xmax
    return xmins, kk, counts


def _clip8(ss: np.ndarray) -> np.ndarray:
    return np.clip(ss >> PRECISION_BITS, 0, 255).astype(np.uint8)


def _pass(img: np.ndarray, axis: int, out_size: int):
    """One separable pass along ``axis`` (1: columns, 0: rows)."""
    xmins, kk, counts = _coeffs(img.shape[axis], out_size)
    src = img.astype(np.int64)
    shape = list(img.shape)
    shape[axis] = out_size
    ss = np.full(shape, 1 << (PRECISION_BITS - 1), np.int64)
    for o in range(out_size):
        for t in range(int(counts[o])):
            i = int(xmins[o]) + t
            if axis == 1:
                ss[:, o] += src[:, i] * kk[o, t]
            else:
                ss[o] += src[i] * kk[o, t]
    return _clip8(ss)


def resize(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Pillow's ``resize(size, BICUBIC)`` of an RGBA crop."""
    rgba = to_rgba(image)
    w, h = size
    ih, iw = rgba.shape[:2]
    if (ih, iw) == (h, w):
        return rgba.copy()
    a = rgba[:, :, 3:].astype(np.uint32)
    tmp = rgba[:, :, :3].astype(np.uint32) * a + 128
    pm = np.concatenate([((tmp >> 8) + tmp) >> 8, a], axis=2).astype(np.uint8)
    ymins, _, ycounts = _coeffs(ih, h)
    first, last = int(ymins[0]), int(ymins[-1] + ycounts[-1])
    if iw != w:
        pm = _pass(pm[first:last], 1, w)
        if ih != h:  # the vertical pass over the rows the horizontal one kept
            xm, kk, counts = _coeffs(ih, h)
            src = pm.astype(np.int64)
            ss = np.full((h,) + pm.shape[1:], 1 << (PRECISION_BITS - 1), np.int64)
            for o in range(h):
                for t in range(int(counts[o])):
                    ss[o] += src[int(xm[o]) - first + t] * kk[o, t]
            pm = _clip8(ss)
    elif ih != h:
        pm = _pass(pm, 0, h)
    alpha = pm[:, :, 3:].astype(np.uint32)
    rgb = pm[:, :, :3].astype(np.uint32)
    div = np.where((alpha == 0) | (alpha == 255), rgb,
                   np.minimum(255 * rgb // np.maximum(alpha, 1), 255))
    return np.concatenate([div, alpha], axis=2).astype(np.uint8)


# --------------------------------------------------------------------- PNG
def _png(buf: bytes, key) -> np.ndarray:
    hdr = parse_png(buf, key)
    if hdr.depth == 16 or hdr.interlace:
        raise UnsupportedImage("16-bit or interlaced PNG (the reference models 8-bit "
                               "non-interlaced PNG)")
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[hdr.color_type]
    depth = hdr.depth
    stride = (hdr.width * channels * depth + 7) // 8
    bpp = max(1, channels * depth // 8)
    if len(hdr.raw) < (stride + 1) * hdr.height:
        raise CorruptImage("truncated PNG image data")
    raw = np.frombuffer(hdr.raw, np.uint8)[:(stride + 1) * hdr.height].reshape(hdr.height, -1)
    prev = np.zeros(stride, np.int64)
    rows = []
    for y in range(hdr.height):
        f, cur = int(raw[y, 0]), raw[y, 1:].astype(np.int64)
        if f == 1:
            for i in range(bpp, stride):
                cur[i] = (cur[i] + cur[i - bpp]) & 255
        elif f == 2:
            cur = (cur + prev) & 255
        elif f == 3:
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 255
        elif f == 4:
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                c = prev[i - bpp] if i >= bpp else 0
                b = prev[i]
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 255
        elif f != 0:
            raise CorruptImage(f"PNG filter type {f}")
        rows.append(cur)
        prev = cur
    data = np.stack(rows).astype(np.uint8)
    w, h = hdr.width, hdr.height
    if depth < 8:
        bits = np.unpackbits(data, axis=1).reshape(h, -1, depth)[:, :w]
        weights = 1 << np.arange(depth - 1, -1, -1)
        values = (bits * weights).sum(axis=2)
    out = np.empty((h, w, 4), np.uint8)
    if hdr.color_type == 3:
        pal = np.tile(np.arange(256, dtype=np.uint8)[:, None], (1, 4))
        pal[:, 3] = 255
        n = min(len(hdr.plte) // 3, 256)
        pal[:n, :3] = np.frombuffer(hdr.plte[:3 * n], np.uint8).reshape(n, 3)
        t = np.frombuffer(hdr.trns[:256], np.uint8)
        pal[:len(t), 3] = t
        return pal[values if depth < 8 else data]
    if hdr.color_type in (0, 2):
        pix = (values * {1: 255, 2: 85, 4: 17}[depth]).astype(np.int64) if depth < 8 \
            else data.reshape(h, w, channels).astype(np.int64)
        pix = pix.reshape(h, w, -1)
        out[:, :, :3] = pix
        out[:, :, 3] = 255
        t = hdr.trns
        if hdr.color_type == 0 and len(t) >= 2:
            out[pix[:, :, 0] == (t[0] << 8 | t[1]), 3] = 0
        if hdr.color_type == 2 and len(t) >= 6:
            key3 = np.array([t[0] << 8 | t[1], t[2] << 8 | t[3], t[4] << 8 | t[5]])
            out[(pix == key3).all(axis=2), 3] = 0
        return out
    pix = data.reshape(h, w, channels)
    if hdr.color_type == 4:
        out[:, :, :3] = pix[:, :, :1]
        out[:, :, 3] = pix[:, :, 1]
        return out
    return pix.copy()


# -------------------------------------------------------------------- JPEG
class _Bits:
    def __init__(self, data: bytes, pos: int):
        self.data, self.pos, self.acc, self.n, self.fake = data, pos, 0, 0, 0

    def _byte(self):
        d, p = self.data, self.pos
        if p < len(d) and d[p] != 0xFF:
            self.pos += 1
            return d[p]
        if p + 1 < len(d) and d[p] == 0xFF and d[p + 1] == 0:
            self.pos += 2
            return 0xFF
        self.fake += 8
        return 0

    def bit(self) -> int:
        if self.n == 0:
            self.acc, self.n = self._byte(), 8
            if self.fake:
                raise CorruptImage("entropy-coded data ends early (truncated)")
        self.n -= 1
        return (self.acc >> self.n) & 1

    def get(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def decode(self, table) -> int:
        code = 0
        for length in range(1, 17):
            code = (code << 1) | self.bit()
            sym = table.get((length, code))
            if sym is not None:
                return sym
        raise CorruptImage("bad Huffman code")


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_1d(v, n):
    """jidctint.c's butterfly on columns ``v[0..7]`` (int64 arrays)."""
    z2, z3 = v[2], v[6]
    z1 = (z2 + z3) * 4433
    tmp2 = z1 + z3 * -15137
    tmp3 = z1 + z2 * 6270
    tmp0 = (v[0] + v[4]) << 13
    tmp1 = (v[0] - v[4]) << 13
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = v[7], v[5], v[3], v[1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * 9633
    tmp0, tmp1, tmp2, tmp3 = tmp0 * 2446, tmp1 * 16819, tmp2 * 25172, tmp3 * 12299
    z1, z2, z3, z4 = z1 * -7373, z2 * -20995, z3 * -16069 + z5, z4 * -3196 + z5
    tmp0, tmp1, tmp2, tmp3 = tmp0 + z1 + z3, tmp1 + z2 + z4, tmp2 + z2 + z3, tmp3 + z1 + z4
    return [_descale(t10 + tmp3, n), _descale(t11 + tmp2, n), _descale(t12 + tmp1, n),
            _descale(t13 + tmp0, n), _descale(t13 - tmp0, n), _descale(t12 - tmp1, n),
            _descale(t11 - tmp2, n), _descale(t10 - tmp3, n)]


_RANGE = np.array([128 + i if i < 128 else 255 if i < 512 else 0 if i < 896 else i - 896
                   for i in range(1024)], np.uint8)


def _idct(blocks: np.ndarray, q: np.ndarray) -> np.ndarray:
    """[N, 64] coefficients (natural order) -> [N, 8, 8] samples."""
    c = blocks.reshape(-1, 8, 8).astype(np.int64) * q.reshape(8, 8).astype(np.int16)
    # pass 1 over columns (the all-zero-AC shortcut gives the same values)
    ws = np.stack(_idct_1d([c[:, r, :] for r in range(8)], 11), axis=1)
    out = np.stack(_idct_1d([ws[:, :, k] for k in range(8)], 18), axis=2)
    return _RANGE[out & 1023]


def _jpeg(buf: bytes, key) -> np.ndarray:
    d, pos = buf, 2
    qt, dc, ac, comps, restart = {}, {}, {}, [], 0
    frame = jfif = False
    adobe = None
    planes = {}

    def u16(i):
        if i + 1 >= len(d):
            raise CorruptImage("truncated JPEG")
        return d[i] << 8 | d[i + 1]

    while True:
        if pos >= len(d):
            if planes:
                break
            raise CorruptImage("truncated JPEG")
        if d[pos] != 0xFF:
            raise CorruptImage("expected a JPEG marker")
        while pos < len(d) and d[pos] == 0xFF:
            pos += 1
        if pos >= len(d):
            raise CorruptImage("truncated JPEG")
        marker = d[pos]
        pos += 1
        if marker == 0xD9:
            break
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            continue
        seglen = u16(pos)
        seg, pos = pos + 2, pos + seglen
        if pos > len(d):
            raise CorruptImage("truncated JPEG segment")
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if marker in (0xC2, 0xC6, 0xCA, 0xCE):
                raise UnsupportedImage("progressive JPEG")
            if marker not in (0xC0, 0xC1):
                raise UnsupportedImage("lossless or arithmetic-coded JPEG")
            if d[seg] != 8:
                raise UnsupportedImage(f"{d[seg]}-bit JPEG")
            height, width, n = u16(seg + 1), u16(seg + 3), d[seg + 5]
            if n == 4:
                raise UnsupportedImage("4-component (CMYK / YCCK) JPEG")
            if n != 1 and n != 3:
                raise UnsupportedImage(f"{n}-component JPEG")
            for i in range(n):
                s = d[seg + 7 + 3 * i]
                comps.append(dict(id=d[seg + 6 + 3 * i], h=s >> 4, v=s & 15,
                                  tq=d[seg + 8 + 3 * i]))
            if n == 1:
                comps[0]["h"] = comps[0]["v"] = 1
            hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
            for c in comps:
                rh, rv = hmax // c["h"], vmax // c["v"]
                if hmax % c["h"] or vmax % c["v"] or rh > 2 or rv > 2 or (rh, rv) == (1, 2):
                    raise UnsupportedImage("JPEG sampling other than 4:4:4, 4:2:2 or 4:2:0")
                c["dw"] = -(-width * c["h"] // hmax)
                c["dh"] = -(-height * c["v"] // vmax)
            mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
            frame = True
        elif marker == 0xDB:
            p = seg
            while p < pos:
                pq, tq = d[p] >> 4, d[p] & 15
                vals = [u16(p + 1 + 2 * i) for i in range(64)] if pq else list(d[p + 1:p + 65])
                table = np.zeros(64, np.int64)
                table[ZIGZAG[:64]] = vals
                qt[tq] = table
                p += 1 + (128 if pq else 64)
        elif marker == 0xC4:
            p = seg
            while p < pos:
                tc, th = d[p] >> 4, d[p] & 15
                bits = list(d[p + 1:p + 17])
                vals = d[p + 17:p + 17 + sum(bits)]
                table, code, k = {}, 0, 0
                for length in range(1, 17):
                    for _ in range(bits[length - 1]):
                        table[(length, code)] = vals[k]
                        code, k = code + 1, k + 1
                    code <<= 1
                (ac if tc else dc)[th] = table
                p += 17 + sum(bits)
        elif marker == 0xDD:
            restart = u16(seg)
        elif marker == 0xE0 and d[seg:seg + 5] == b"JFIF\0":
            jfif = True
        elif marker == 0xEE and d[seg:seg + 5] == b"Adobe":
            adobe = d[seg + 11]
        elif marker == 0xDA:
            ns = d[seg]
            scan = []
            for i in range(ns):
                cid, tbl = d[seg + 1 + 2 * i], d[seg + 2 + 2 * i]
                c = next(c for c in comps if c["id"] == cid)
                ci = comps.index(c)
                c["dc"], c["ac"], c["pred"] = dc[tbl >> 4], ac[tbl & 15], 0
                if ci not in planes:
                    c["q"] = qt[c["tq"]]
                    planes[ci] = np.zeros((mcuy * c["v"] * 8, mcux * c["h"] * 8), np.uint8)
                scan.append(ci)
            if ns == 1:
                c = comps[scan[0]]
                grid = (-(-c["dh"] // 8), -(-c["dw"] // 8))
            else:
                grid = (mcuy, mcux)
            bits = _Bits(d, pos)
            rst = 0
            for m in range(grid[0] * grid[1]):
                if restart and m and m % restart == 0:
                    p = bits.pos
                    while not (d[p] == 0xFF and 0xD0 <= d[p + 1] <= 0xD7):
                        p += 1
                    if d[p + 1] != 0xD0 + rst:
                        raise CorruptImage("restart marker out of order")
                    rst = (rst + 1) & 7
                    bits = _Bits(d, p + 2)
                    for ci in scan:
                        comps[ci]["pred"] = 0
                my, mx = divmod(m, grid[1])
                for ci in scan:
                    c = comps[ci]
                    hv = [(0, 0)] if ns == 1 else [(v, h) for v in range(c["v"])
                                                    for h in range(c["h"])]
                    for v, h in hv:
                        blk = np.zeros(80, np.int64)
                        t = bits.decode(c["dc"])
                        c["pred"] += _extend(bits.get(t), t) if t else 0
                        blk[0] = (c["pred"] + 32768) % 65536 - 32768   # a JCOEF
                        k = 1
                        while k < 64:
                            rs = bits.decode(c["ac"])
                            r, s = rs >> 4, rs & 15
                            if s:
                                k += r
                                blk[ZIGZAG[k]] = _extend(bits.get(s), s)
                            elif r == 15:
                                k += 15
                            else:
                                break
                            k += 1
                        if ns == 1:
                            row, col = my * 8, mx * 8
                        else:
                            row, col = (my * c["v"] + v) * 8, (mx * c["h"] + h) * 8
                        planes[ci][row:row + 8, col:col + 8] = _idct(blk[None, :64], c["q"])[0]
            # the next marker that is not RSTn
            p = bits.pos
            while p + 1 < len(d) and not (d[p] == 0xFF and d[p + 1] not in (0, 0xFF)
                                          and not 0xD0 <= d[p + 1] <= 0xD7):
                p += 1
            if p + 1 >= len(d):
                raise CorruptImage("truncated JPEG (no marker after the scan)")
            pos = p
    if not frame or len(planes) != len(comps):
        raise CorruptImage("JPEG without a frame or a scan")
    out = np.full((height, width, 4), 255, np.uint8)
    if len(comps) == 1:
        out[:, :, :3] = planes[0][:height, :width, None]
        return out
    up = [_upsample(planes[i][:c["dh"], :c["dw"]], hmax // c["h"], vmax // c["v"])
          [:height, :width] for i, c in enumerate(comps)]
    rgb_space = (adobe == 0) if (not jfif and adobe is not None) else (
        not jfif and [c["id"] for c in comps] == [82, 71, 66])
    if rgb_space:
        out[:, :, :3] = np.stack(up, axis=2)
        return out
    y, cb, cr = (u.astype(np.int64) for u in up)
    fix = lambda v: int(v * (1 << 16) + 0.5)  # noqa: E731
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (fix(1.40200) * x + (1 << 15)) >> 16
    cb_b = (fix(1.77200) * x + (1 << 15)) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + (1 << 15)
    out[:, :, 0] = np.clip(y + cr_r[cr], 0, 255)
    out[:, :, 1] = np.clip(y + ((cb_g[cb] + cr_g[cr]) >> 16), 0, 255)
    out[:, :, 2] = np.clip(y + cb_b[cb], 0, 255)
    return out


def _upsample(p: np.ndarray, rh: int, rv: int) -> np.ndarray:
    """jdsample.c's fancy upsampling of one downsampled plane [dh, dw]."""
    p = p.astype(np.int64)
    dh, dw = p.shape
    if (rh, rv) == (1, 1):
        return p
    if dw <= 2:   # plain replication
        out = np.repeat(p, 2, axis=1)
        return np.repeat(out, 2, axis=0) if rv == 2 else out
    if rv == 1:
        out = np.empty((dh, 2 * dw), np.int64)
        left = np.concatenate([p[:, :1], p[:, :-1]], axis=1)
        right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
        out[:, 0::2] = (3 * p + left + 1) >> 2
        out[:, 1::2] = (3 * p + right + 2) >> 2
        out[:, 0], out[:, -1] = p[:, 0], p[:, -1]
        return out
    above = np.concatenate([p[:1], p[:-1]], axis=0)
    below = np.concatenate([p[1:], p[-1:]], axis=0)
    out = np.empty((2 * dh, 2 * dw), np.int64)
    for v, near in ((0, above), (1, below)):
        s = 3 * p + near
        last = np.concatenate([s[:, :1], s[:, :-1]], axis=1)
        nxt = np.concatenate([s[:, 1:], s[:, -1:]], axis=1)
        even = (3 * s + last + 8) >> 4
        odd = (3 * s + nxt + 7) >> 4
        even[:, 0] = (4 * s[:, 0] + 8) >> 4
        odd[:, -1] = (4 * s[:, -1] + 7) >> 4
        out[v::2, 0::2], out[v::2, 1::2] = even, odd
    return out


def decode(buf: bytes, size: Optional[Tuple[int, int]] = None,
           key: Optional[str] = None) -> np.ndarray:
    """``data.image.decode`` in numpy."""
    buf = bytes(buf)
    fmt = image_format(buf)
    if fmt == "png":
        rgba = _png(buf, key)
    elif fmt == "jpeg":
        rgba = _jpeg(buf, key)
    elif fmt == "unknown":
        raise CorruptImage("cannot identify the image format")
    else:
        raise UnsupportedImage(f"{fmt} images")
    return rgba if size is None else resize(rgba, size)
