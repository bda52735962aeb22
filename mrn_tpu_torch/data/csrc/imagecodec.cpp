// Host image codec of the PyTorch port: one call per image, encoded bytes
// in, samples or RGBA uint8 out, bit for bit what Pillow (over
// libjpeg-turbo and zlib) and cv2 give, without either.
//
// - PNG: the caller inflates the IDAT stream (Python's zlib) and passes the
//   header fields, PLTE and tRNS; here the rows are unfiltered (None, Sub,
//   Up, Average, Paeth), plain or Adam7-interlaced, at 1, 2, 4, 8 or 16
//   bits, into the stored samples (png_samples), and turned into RGBA as
//   Pillow's `convert("RGBA")` does (png_rgba): L / RGB with a tRNS key get
//   alpha 0 where the key's low byte matches, P takes the palette's alphas
//   (entries past PLTE black), LA and RGBA keep theirs; 16-bit gray is
//   I;16, clipped to 255, the other 16-bit types take the high byte.
// - JPEG: baseline, extended and progressive Huffman (SOF0 / SOF1 / SOF2),
//   8-bit, DRI restart markers, 1, 3 or 4 components, any integral
//   sampling, any size.  libjpeg-turbo's decode as Pillow runs it:
//   jdhuff.c / jdphuff.c (DC and AC first and refinement scans, EOB runs)
//   into a whole-image coefficient buffer; jdcoefct.c's block smoothing
//   where a progressive file's scans leave the first coefficients owed
//   bits; the JDCT_ISLOW integer IDCT (jidctint.c) with its range-limit
//   table; jdsample.c's upsampler choice (fancy h2v1 / h2v2 with plain
//   replication at a downsampled width of 2 or less, fancy h1v2,
//   int_upsample otherwise, edge rows replicated); the fixed-point YCbCr ->
//   RGB tables (jdcolor.c).  Adobe CMYK comes out as stored (jpeg_samples)
//   or through Pillow's inverted "CMYK;I" and Convert.c's cmyk2rgb
//   (jpeg_rgba).
// - GIF: one image's LZW stream into palette indices (gif_lzw); the caller
//   reads the blocks, tables and interlacing.
// - Pillow's bicubic `resize` (libImaging/Resample.c): separable, a = -0.5,
//   support 2 * max(1, in / out); the coefficients normalised in double and
//   set in fixed point (PRECISION_BITS = 22, rounded half away from zero);
//   the horizontal pass first, over the rows the vertical pass needs,
//   rounded to uint8 in between.  RGBA runs premultiplied (Convert.c's
//   rgbA2rgba / rgba2rgbA); a crop already at the output size is copied.
//
// Errors: 1 = bytes no decoder can read (truncated, bad markers, Huffman or
// LZW codes), 2 = a valid file of a form not decoded here (arithmetic,
// lossless, hierarchical, 12-bit or YCCK JPEG, 2 components); the message
// goes to `err`.

#include <algorithm>
#include <cmath>
#include <cstdlib>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

constexpr int kCorrupt = 1;
constexpr int kUnsupported = 2;

struct Fail {
  int code;
  std::string msg;
};

[[noreturn]] void corrupt(const std::string& m) { throw Fail{kCorrupt, m}; }
[[noreturn]] void unsupported(const std::string& m) { throw Fail{kUnsupported, m}; }

// ----------------------------------------------------------------- resize

constexpr int PRECISION_BITS = 32 - 8 - 2;

double bicubic_filter(double x) {
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((-0.5 + 2.0) * x - (-0.5 + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * -0.5;
  return 0.0;
}

// Resample.c's precompute_coeffs + normalize_coeffs_8bpc: per output index
// its first input index, its tap count and ksize fixed-point taps.
int precompute_coeffs(int in_size, int out_size, std::vector<int>& bounds,
                      std::vector<int32_t>& kk) {
  const float in0 = 0.0f, in1 = static_cast<float>(in_size);
  double filterscale, scale;
  filterscale = scale = static_cast<double>(in1 - in0) / out_size;
  if (filterscale < 1.0) filterscale = 1.0;
  const double support = 2.0 * filterscale;
  const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  std::vector<double> pre(static_cast<size_t>(out_size) * ksize, 0.0);
  bounds.assign(static_cast<size_t>(out_size) * 2, 0);
  for (int xx = 0; xx < out_size; xx++) {
    const double center = in0 + (xx + 0.5) * scale;
    double ww = 0.0;
    const double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &pre[static_cast<size_t>(xx) * ksize];
    for (int x = 0; x < xmax; x++) {
      const double w = bicubic_filter((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; x++) {
      if (ww != 0.0) k[x] /= ww;
    }
    bounds[xx * 2 + 0] = xmin;
    bounds[xx * 2 + 1] = xmax;
  }
  kk.resize(pre.size());
  for (size_t i = 0; i < pre.size(); i++) {
    if (pre[i] < 0)
      kk[i] = static_cast<int32_t>(-0.5 + pre[i] * (1 << PRECISION_BITS));
    else
      kk[i] = static_cast<int32_t>(0.5 + pre[i] * (1 << PRECISION_BITS));
  }
  return ksize;
}

inline uint8_t clip8(int32_t in) {
  const int32_t v = in >> PRECISION_BITS;  // arithmetic: floors
  return v < 0 ? 0 : (v > 255 ? 255 : static_cast<uint8_t>(v));
}

inline uint8_t muldiv255(unsigned a, unsigned b) {
  const unsigned tmp = a * b + 128;
  return static_cast<uint8_t>(((tmp >> 8) + tmp) >> 8);
}

// RGBA [h, w, 4] -> [oh, ow, 4] as Image.resize((ow, oh), BICUBIC).
void resize_rgba(const uint8_t* in, int h, int w, int oh, int ow, uint8_t* out) {
  if (h == oh && w == ow) {
    std::memcpy(out, in, static_cast<size_t>(h) * w * 4);
    return;
  }
  // RGBA -> RGBa
  std::vector<uint8_t> pm(static_cast<size_t>(h) * w * 4);
  for (size_t i = 0; i < pm.size(); i += 4) {
    const unsigned a = in[i + 3];
    pm[i + 0] = muldiv255(in[i + 0], a);
    pm[i + 1] = muldiv255(in[i + 1], a);
    pm[i + 2] = muldiv255(in[i + 2], a);
    pm[i + 3] = in[i + 3];
  }
  const bool need_h = ow != w, need_v = oh != h;
  std::vector<int> bh, bv;
  std::vector<int32_t> kh, kv;
  const int ksh = precompute_coeffs(w, ow, bh, kh);
  const int ksv = precompute_coeffs(h, oh, bv, kv);
  const int ybox_first = bv[0];
  const int ybox_last = bv[oh * 2 - 2] + bv[oh * 2 - 1];

  const uint8_t* src = pm.data();
  int src_w = w;
  std::vector<uint8_t> tmp;
  if (need_h) {
    for (int i = 0; i < oh; i++) bv[i * 2] -= ybox_first;
    const int th = ybox_last - ybox_first;
    tmp.resize(static_cast<size_t>(th) * ow * 4);
    for (int yy = 0; yy < th; yy++) {
      const uint8_t* row = src + static_cast<size_t>(yy + ybox_first) * w * 4;
      for (int xx = 0; xx < ow; xx++) {
        const int xmin = bh[xx * 2], xmax = bh[xx * 2 + 1];
        const int32_t* k = &kh[static_cast<size_t>(xx) * ksh];
        int32_t ss[4] = {1 << (PRECISION_BITS - 1), 1 << (PRECISION_BITS - 1),
                         1 << (PRECISION_BITS - 1), 1 << (PRECISION_BITS - 1)};
        for (int x = 0; x < xmax; x++) {
          const uint8_t* px = row + (x + xmin) * 4;
          for (int c = 0; c < 4; c++) ss[c] += px[c] * k[x];
        }
        uint8_t* o = &tmp[(static_cast<size_t>(yy) * ow + xx) * 4];
        for (int c = 0; c < 4; c++) o[c] = clip8(ss[c]);
      }
    }
    src = tmp.data();
    src_w = ow;
  }
  std::vector<uint8_t> res;
  if (need_v) {
    res.resize(static_cast<size_t>(oh) * src_w * 4);
    for (int yy = 0; yy < oh; yy++) {
      const int32_t* k = &kv[static_cast<size_t>(yy) * ksv];
      const int ymin = bv[yy * 2], ymax = bv[yy * 2 + 1];
      for (int xx = 0; xx < src_w; xx++) {
        int32_t ss[4] = {1 << (PRECISION_BITS - 1), 1 << (PRECISION_BITS - 1),
                         1 << (PRECISION_BITS - 1), 1 << (PRECISION_BITS - 1)};
        for (int y = 0; y < ymax; y++) {
          const uint8_t* px = src + (static_cast<size_t>(y + ymin) * src_w + xx) * 4;
          for (int c = 0; c < 4; c++) ss[c] += px[c] * k[y];
        }
        uint8_t* o = &res[(static_cast<size_t>(yy) * src_w + xx) * 4];
        for (int c = 0; c < 4; c++) o[c] = clip8(ss[c]);
      }
    }
    src = res.data();
  }
  // RGBa -> RGBA
  const size_t n = static_cast<size_t>(oh) * ow * 4;
  for (size_t i = 0; i < n; i += 4) {
    const unsigned a = src[i + 3];
    for (int c = 0; c < 3; c++) {
      if (a == 255 || a == 0) {
        out[i + c] = src[i + c];
      } else {
        const unsigned v = (255u * src[i + c]) / a;
        out[i + c] = v > 255 ? 255 : static_cast<uint8_t>(v);
      }
    }
    out[i + 3] = src[i + 3];
  }
}

// -------------------------------------------------------------------- PNG

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

int png_channels(int ctype) {
  switch (ctype) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
    default: corrupt("PNG colour type " + std::to_string(ctype));
  }
}

// Unfilters the inflated stream (None, Sub, Up, Average, Paeth) of a plain or
// Adam7-interlaced PNG, handing each row to `row(cur, pw, y, x0, dx)`: its
// pw pixels land at (y, x0), (y, x0 + dx), ...
template <typename Row>
void png_unfilter(const uint8_t* raw, size_t rawlen, int w, int h, int ctype, int depth,
                  int interlace, Row&& row) {
  const int channels = png_channels(ctype);
  const bool low = depth < 8;
  if (depth != 1 && depth != 2 && depth != 4 && depth != 8 && depth != 16) corrupt("PNG bit depth");
  if (low && ctype != 0 && ctype != 3) corrupt("PNG bit depth for colour type");
  if (depth == 16 && ctype == 3) corrupt("PNG bit depth for colour type");
  const int bpp = low ? 1 : channels * depth / 8;
  static const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                                   {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
  static const int kPlain[1][4] = {{0, 0, 1, 1}};
  const int (*passes)[4] = interlace ? kAdam7 : kPlain;
  const int npass = interlace ? 7 : 1;
  const uint8_t* p = raw;
  const uint8_t* end = raw + rawlen;
  for (int pass = 0; pass < npass; pass++) {
    const int x0 = passes[pass][0], y0 = passes[pass][1];
    const int dx = passes[pass][2], dy = passes[pass][3];
    const int pw = w > x0 ? (w - x0 + dx - 1) / dx : 0;
    const int ph = h > y0 ? (h - y0 + dy - 1) / dy : 0;
    if (pw == 0 || ph == 0) continue;
    const size_t stride = (static_cast<size_t>(pw) * channels * depth + 7) / 8;
    if (static_cast<size_t>(end - p) < (stride + 1) * ph) corrupt("truncated PNG image data");
    std::vector<uint8_t> cur(stride), prev(stride, 0);
    for (int r = 0; r < ph; r++) {
      const uint8_t f = *p++;
      std::memcpy(cur.data(), p, stride);
      p += stride;
      switch (f) {
        case 0: break;
        case 1:
          for (size_t i = bpp; i < stride; i++) cur[i] = static_cast<uint8_t>(cur[i] + cur[i - bpp]);
          break;
        case 2:
          for (size_t i = 0; i < stride; i++) cur[i] = static_cast<uint8_t>(cur[i] + prev[i]);
          break;
        case 3:
          for (size_t i = 0; i < stride; i++) {
            const int left = i >= static_cast<size_t>(bpp) ? cur[i - bpp] : 0;
            cur[i] = static_cast<uint8_t>(cur[i] + ((left + prev[i]) >> 1));
          }
          break;
        case 4:
          for (size_t i = 0; i < stride; i++) {
            const bool has_left = i >= static_cast<size_t>(bpp);
            const int a = has_left ? cur[i - bpp] : 0;
            const int c = has_left ? prev[i - bpp] : 0;
            cur[i] = static_cast<uint8_t>(cur[i] + paeth(a, prev[i], c));
          }
          break;
        default: corrupt("PNG filter type " + std::to_string(f));
      }
      row(cur.data(), pw, y0 + r * dy, x0, dx);
      std::swap(cur, prev);
    }
  }
}

// Sample c of pixel x of an unfiltered row, as stored: palette indices and
// 1/2/4-bit gray unscaled, 16-bit samples whole.
inline int png_sample(const uint8_t* row, int x, int c, int channels, int depth) {
  if (depth == 8) return row[x * channels + c];
  if (depth == 16) {
    const uint8_t* s = row + (static_cast<size_t>(x) * channels + c) * 2;
    return (s[0] << 8) | s[1];
  }
  const int per = 8 / depth;
  return (row[x / per] >> (8 - depth * (x % per + 1))) & ((1 << depth) - 1);
}

// The samples [h, w, channels] as stored.
void png_samples(const uint8_t* raw, size_t rawlen, int w, int h, int ctype, int depth,
                 int interlace, uint16_t* out) {
  const int channels = png_channels(ctype);
  png_unfilter(raw, rawlen, w, h, ctype, depth, interlace,
               [&](const uint8_t* cur, int pw, int y, int x0, int dx) {
                 uint16_t* o = out + (static_cast<size_t>(y) * w + x0) * channels;
                 for (int x = 0; x < pw; x++, o += static_cast<size_t>(dx) * channels)
                   for (int c = 0; c < channels; c++)
                     o[c] = static_cast<uint16_t>(png_sample(cur, x, c, channels, depth));
               });
}

// The image as Pillow's `convert("RGBA")` gives it.  8-bit and lower: L /
// RGB with a tRNS key get alpha 0 where the key matches, P takes the
// palette's alphas, LA and RGBA keep theirs; 1/2/4-bit gray is scaled to
// 0..255 as Pillow's unpackers do.  16-bit: gray is mode I;16, clipped to
// 255 (Convert.c's I16_RGB) before its key is compared; RGB, LA and RGBA
// take the high byte (the ";16B" unpackers), RGB's key compared with it.
void png_rgba(const uint8_t* raw, size_t rawlen, int w, int h, int ctype, int depth,
              int interlace, const uint8_t* plte, int nplte, const uint8_t* trns, int ntrns,
              std::vector<uint8_t>& rgba) {
  const int channels = png_channels(ctype);
  rgba.assign(static_cast<size_t>(w) * h * 4, 0);
  // the palette as Pillow holds a PNG's: entries past PLTE are black, alpha 255
  uint8_t pal[256][4];
  for (int i = 0; i < 256; i++) {
    pal[i][0] = pal[i][1] = pal[i][2] = 0;
    pal[i][3] = 255;
  }
  if (ctype == 3) {
    for (int i = 0; i < nplte && i < 256; i++) {
      pal[i][0] = plte[3 * i];
      pal[i][1] = plte[3 * i + 1];
      pal[i][2] = plte[3 * i + 2];
    }
    for (int i = 0; i < ntrns && i < 256; i++) pal[i][3] = trns[i];
  }
  // L and RGB keys: Convert.c's rgbT2rgba compares the 8-bit pixels with the
  // low byte of each 16-bit key; mode "1" holds its key as 255 or 0
  const bool keyed = (ctype == 0 && ntrns >= 2) || (ctype == 2 && ntrns >= 6);
  int key[3] = {-1, -1, -1};
  if (ctype == 0 && keyed) {
    key[0] = trns[1];
    if (depth == 1) key[0] = (trns[0] | trns[1]) ? 255 : 0;
  }
  if (ctype == 2 && keyed)
    for (int c = 0; c < 3; c++) key[c] = trns[2 * c + 1];
  const int scale = depth == 1 ? 255 : depth == 2 ? 85 : depth == 4 ? 17 : 1;
  const int shift = depth == 16 ? 8 : 0;
  auto row = [&](const uint8_t* cur, int pw, int y, int x0, int dx) {
    // s(x, c): sample c of pixel x as stored; b(x, c): its 8-bit value (16-bit
    // samples' high byte)
    auto convert = [&](auto s, auto b) {
      uint8_t* o = &rgba[(static_cast<size_t>(y) * w + x0) * 4];
      for (int x = 0; x < pw; x++, o += 4 * dx) {
        switch (ctype) {
          case 0: {
            const int g = depth == 16 ? std::min(s(x, 0), 255) : s(x, 0) * scale;
            o[0] = o[1] = o[2] = static_cast<uint8_t>(g);
            o[3] = (keyed && g == key[0]) ? 0 : 255;
            break;
          }
          case 2:
            for (int c = 0; c < 3; c++) o[c] = b(x, c);
            o[3] = (keyed && o[0] == key[0] && o[1] == key[1] && o[2] == key[2]) ? 0 : 255;
            break;
          case 3:
            std::memcpy(o, pal[s(x, 0)], 4);
            break;
          case 4:
            o[0] = o[1] = o[2] = b(x, 0);
            o[3] = b(x, 1);
            break;
          default:
            for (int c = 0; c < 4; c++) o[c] = b(x, c);
        }
      }
    };
    if (depth == 8) {  // the common case, loaded directly
      auto s8 = [&](int x, int c) { return cur[x * channels + c]; };
      convert([&](int x, int c) { return static_cast<int>(s8(x, c)); }, s8);
    } else {
      auto s = [&](int x, int c) { return png_sample(cur, x, c, channels, depth); };
      convert(s, [&](int x, int c) { return static_cast<uint8_t>(s(x, c) >> shift); });
    }
  };
  png_unfilter(raw, rawlen, w, h, ctype, depth, interlace, row);
}

// -------------------------------------------------------------------- GIF

// The LZW stream of one GIF image (its sub-blocks joined) into up to `npix`
// palette indices; returns how many it gave.
size_t gif_lzw(const uint8_t* d, size_t len, int min_size, size_t npix, uint8_t* out) {
  if (min_size < 1 || min_size > 11) corrupt("bad GIF LZW code size");
  const int clear = 1 << min_size, eoi = clear + 1;
  std::vector<uint16_t> prefix(4096);
  std::vector<uint8_t> suffix(4096), stack(4097);
  std::vector<uint16_t> length(4096);
  for (int i = 0; i < clear; i++) {
    prefix[i] = 0xFFFF;
    suffix[i] = static_cast<uint8_t>(i);
    length[i] = 1;
  }
  int size = min_size + 1, next = eoi + 1, prev = -1;
  uint32_t acc = 0;
  int nbits = 0;
  size_t pos = 0, n = 0;
  uint8_t first = 0;
  while (n < npix) {
    while (nbits < size) {
      if (pos >= len) return n;
      acc |= static_cast<uint32_t>(d[pos++]) << nbits;
      nbits += 8;
    }
    const int code = static_cast<int>(acc & ((1u << size) - 1));
    acc >>= size;
    nbits -= size;
    if (code == clear) {
      size = min_size + 1;
      next = eoi + 1;
      prev = -1;
      continue;
    }
    if (code == eoi) break;
    int c = code;
    size_t sp = 0;
    if (prev >= 0 && code >= next) {
      if (code > next) corrupt("bad GIF LZW code");
      stack[sp++] = first;  // KwKwK
      c = prev;
    } else if (prev < 0 && code >= clear) {
      corrupt("bad GIF LZW code");
    }
    while (c >= clear) {
      stack[sp++] = suffix[c];
      c = prefix[c];
    }
    stack[sp++] = static_cast<uint8_t>(c);
    first = static_cast<uint8_t>(c);
    while (sp > 0 && n < npix) out[n++] = stack[--sp];
    if (prev >= 0 && next < 4096) {
      prefix[next] = static_cast<uint16_t>(prev);
      suffix[next] = first;
      next++;
      if (next == (1 << size) && size < 12) size++;
    }
    prev = code;
  }
  return n;
}

// ------------------------------------------------------------------- JPEG

const int kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // libjpeg's extra entries: a corrupt run past the end lands on 63
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huff {
  bool defined = false;
  uint8_t look_len[512];
  uint8_t look_sym[512];
  int32_t maxcode[18];
  int32_t valoff[17];
  uint8_t vals[256];
};

void build_huff(Huff& t, const uint8_t bits[17], const uint8_t* vals, int nvals) {
  std::memset(t.look_len, 0, sizeof t.look_len);
  std::memcpy(t.vals, vals, nvals);
  int32_t code = 0, k = 0;
  for (int len = 1; len <= 16; len++) {
    t.valoff[len] = k - code;
    k += bits[len];
    code += bits[len];
    if (bits[len] && code - 1 >= (1 << len)) corrupt("bad Huffman table");
    t.maxcode[len] = bits[len] ? code - 1 : -1;
    code <<= 1;
  }
  t.maxcode[17] = 0x7fffffff;
  code = 0;
  k = 0;
  for (int len = 1; len <= 9; len++) {
    for (int i = 0; i < bits[len]; i++, k++, code++) {
      const int shift = 9 - len;
      for (int j = 0; j < (1 << shift); j++) {
        t.look_len[(code << shift) | j] = static_cast<uint8_t>(len);
        t.look_sym[(code << shift) | j] = vals[k];
      }
    }
    code <<= 1;
  }
  t.defined = true;
}

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int nbits = 0;
  int fake = 0;  // zero bits appended past a marker or the end of the data

  void fill() {
    while (nbits <= 56) {
      uint32_t byte = 0;
      if (p < end && *p != 0xFF) {
        byte = *p++;
      } else if (p + 1 < end && *p == 0xFF && p[1] == 0x00) {
        byte = 0xFF;
        p += 2;
      } else {
        fake += 8;  // a marker (or the end): libjpeg feeds zeros
      }
      acc |= static_cast<uint64_t>(byte) << (56 - nbits);
      nbits += 8;
    }
  }
  void consume(int n) {
    acc <<= n;
    nbits -= n;
    if (nbits < fake) corrupt("entropy-coded data ends early (truncated)");
  }
  int get(int n) {
    if (n == 0) return 0;
    if (nbits < n) fill();
    const int v = static_cast<int>(acc >> (64 - n));
    consume(n);
    return v;
  }
  int decode(const Huff& t) {
    if (nbits < 16) fill();
    const int peek = static_cast<int>(acc >> (64 - 9));
    if (t.look_len[peek]) {
      const int len = t.look_len[peek];
      const int sym = t.look_sym[peek];
      consume(len);
      return sym;
    }
    for (int len = 10; len <= 16; len++) {
      const int32_t code = static_cast<int32_t>(acc >> (64 - len));
      if (code <= t.maxcode[len]) {
        consume(len);
        return t.vals[t.valoff[len] + code];
      }
    }
    corrupt("bad Huffman code");
  }
  void reset(const uint8_t* at) {
    p = at;
    acc = 0;
    nbits = 0;
    fake = 0;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// jidctint.c
constexpr int CONST_BITS = 13, PASS1_BITS = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t{1} << (n - 1))) >> n; }

struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; i++) {
      if (i < 128) t[i] = static_cast<uint8_t>(128 + i);
      else if (i < 512) t[i] = 255;
      else if (i < 896) t[i] = 0;
      else t[i] = static_cast<uint8_t>(i - 896);
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, size_t stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    auto dq = [&](int r) {
      return static_cast<int64_t>(in[8 * r]) * static_cast<int16_t>(q[8 * r + c]);
    };
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 &&
        in[48] == 0 && in[56] == 0) {
      const int dc = static_cast<int>(dq(0) * (1 << PASS1_BITS));
      for (int r = 0; r < 8; r++) ws[8 * r + c] = dc;
      continue;
    }
    int64_t z2 = dq(2), z3 = dq(6);
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = dq(0);
    z3 = dq(4);
    int64_t tmp0 = (z2 + z3) * (int64_t{1} << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (int64_t{1} << CONST_BITS);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = dq(7);
    tmp1 = dq(5);
    tmp2 = dq(3);
    tmp3 = dq(1);
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * -FIX_0_899976223;
    z2 = z2 * -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560;
    z4 = z4 * -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = CONST_BITS - PASS1_BITS;
    ws[8 * 0 + c] = static_cast<int>(descale(tmp10 + tmp3, n));
    ws[8 * 7 + c] = static_cast<int>(descale(tmp10 - tmp3, n));
    ws[8 * 1 + c] = static_cast<int>(descale(tmp11 + tmp2, n));
    ws[8 * 6 + c] = static_cast<int>(descale(tmp11 - tmp2, n));
    ws[8 * 2 + c] = static_cast<int>(descale(tmp12 + tmp1, n));
    ws[8 * 5 + c] = static_cast<int>(descale(tmp12 - tmp1, n));
    ws[8 * 3 + c] = static_cast<int>(descale(tmp13 + tmp0, n));
    ws[8 * 4 + c] = static_cast<int>(descale(tmp13 - tmp0, n));
  }
  for (int r = 0; r < 8; r++) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    const int n = CONST_BITS + PASS1_BITS + 3;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 &&
        w[7] == 0) {
      const uint8_t dc = kRange.t[static_cast<int>(descale(w[0], PASS1_BITS + 3)) & 1023];
      for (int i = 0; i < 8; i++) o[i] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (static_cast<int64_t>(w[0]) + w[4]) * (int64_t{1} << CONST_BITS);
    int64_t tmp1 = (static_cast<int64_t>(w[0]) - w[4]) * (int64_t{1} << CONST_BITS);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * -FIX_0_899976223;
    z2 = z2 * -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560;
    z4 = z4 * -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = kRange.t[static_cast<int>(descale(tmp10 + tmp3, n)) & 1023];
    o[7] = kRange.t[static_cast<int>(descale(tmp10 - tmp3, n)) & 1023];
    o[1] = kRange.t[static_cast<int>(descale(tmp11 + tmp2, n)) & 1023];
    o[6] = kRange.t[static_cast<int>(descale(tmp11 - tmp2, n)) & 1023];
    o[2] = kRange.t[static_cast<int>(descale(tmp12 + tmp1, n)) & 1023];
    o[5] = kRange.t[static_cast<int>(descale(tmp12 - tmp1, n)) & 1023];
    o[3] = kRange.t[static_cast<int>(descale(tmp13 + tmp0, n)) & 1023];
    o[4] = kRange.t[static_cast<int>(descale(tmp13 - tmp0, n)) & 1023];
  }
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int dw = 0, dh = 0;       // downsampled size (jdinput.c)
  int bw = 0, bh = 0;       // coefficient grid in blocks, a whole number of MCUs
  int wib = 0, hib = 0;     // the blocks that hold image samples
  bool latched = false;
  uint16_t q[64];
  int pred = 0;
  int coef_bits[64];        // progressive: Al still owed per zigzag index, -1 = no scan yet
  std::vector<int16_t> coef;   // bh x bw blocks of 64 coefficients, natural order
  std::vector<uint8_t> plane;  // [bh * 8][bw * 8] samples after the IDCT
  int16_t* block(long bx, long by) { return &coef[(static_cast<size_t>(by) * bw + bx) * 64]; }
};

struct Jpeg {
  Jpeg(const uint8_t* d, size_t n) : data(d), len(n) {}
  const uint8_t* data;
  size_t len;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool frame = false, progressive = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  int restart = 0;
  int scans = 0;
  int force_ycc = -1;  // -1: the markers decide; 0 / 1: the caller does (TIFF)
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  Component comp[4];

  uint8_t byte_at(size_t i) const {
    if (i >= len) corrupt("truncated JPEG");
    return data[i];
  }
  int u16(size_t i) const { return (byte_at(i) << 8) | byte_at(i + 1); }

  int next_marker() {
    // markers may be preceded by fill bytes 0xFF
    if (byte_at(pos) != 0xFF) corrupt("expected a JPEG marker");
    while (byte_at(pos) == 0xFF) pos++;
    return byte_at(pos++);
  }

  void parse_sof(int marker, size_t seg, int seglen) {
    if (marker == 0xC3 || marker == 0xC7 || marker == 0xCB || marker == 0xCF)
      unsupported("lossless JPEG");
    if (marker >= 0xC9) unsupported("arithmetic-coded JPEG");
    if (marker == 0xC5 || marker == 0xC6) unsupported("hierarchical JPEG");
    if (frame) corrupt("two JPEG frames");
    progressive = marker == 0xC2;
    if (byte_at(seg) != 8) unsupported(std::to_string(byte_at(seg)) + "-bit JPEG");
    height = u16(seg + 1);
    width = u16(seg + 3);
    ncomp = byte_at(seg + 5);
    if (seglen < 6 + 3 * ncomp) corrupt("short SOF segment");
    if (height == 0) unsupported("JPEG with its height in a DNL marker");
    if (width == 0) corrupt("JPEG of width 0");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      unsupported(std::to_string(ncomp) + "-component JPEG");
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = byte_at(seg + 6 + 3 * i);
      c.h = byte_at(seg + 7 + 3 * i) >> 4;
      c.v = byte_at(seg + 7 + 3 * i) & 15;
      c.tq = byte_at(seg + 8 + 3 * i);
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) corrupt("bad JPEG sampling");
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
    }
    if (ncomp == 1) comp[0].h = comp[0].v = 1;  // one block per MCU, no upsampling
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; i++) {
      hmax = std::max(hmax, comp[i].h);
      vmax = std::max(vmax, comp[i].v);
    }
    for (int i = 0; i < ncomp; i++)  // jdsample.c: integral factors only
      if (hmax % comp[i].h || vmax % comp[i].v)
        corrupt("JPEG sampling with fractional upsampling factors");
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.dw = static_cast<int>((static_cast<long>(width) * c.h + hmax - 1) / hmax);
      c.dh = static_cast<int>((static_cast<long>(height) * c.v + vmax - 1) / vmax);
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.wib = (c.dw + 7) / 8;
      c.hib = (c.dh + 7) / 8;
    }
    frame = true;
  }

  void parse_dqt(size_t seg, int seglen) {
    size_t p = seg, end = seg + seglen - 2;
    while (p < end) {
      const int pq = byte_at(p) >> 4, tq = byte_at(p) & 15;
      p++;
      if (tq > 3 || pq > 1) corrupt("bad DQT");
      for (int i = 0; i < 64; i++) {
        const int v = pq ? u16(p + 2 * i) : byte_at(p + i);
        qt[tq][kZigzag[i]] = static_cast<uint16_t>(v);
      }
      p += pq ? 128 : 64;
      qt_defined[tq] = true;
    }
  }

  void parse_dht(size_t seg, int seglen) {
    size_t p = seg, end = seg + seglen - 2;
    while (p < end) {
      const int tc = byte_at(p) >> 4, th = byte_at(p) & 15;
      p++;
      if (tc > 1 || th > 3) corrupt("bad DHT");
      uint8_t bits[17] = {0};
      int total = 0;
      for (int i = 1; i <= 16; i++) {
        bits[i] = byte_at(p + i - 1);
        total += bits[i];
      }
      p += 16;
      if (total > 256) corrupt("bad DHT");
      uint8_t vals[256];
      for (int i = 0; i < total; i++) vals[i] = byte_at(p + i);
      p += total;
      build_huff(tc ? ac[th] : dc[th], bits, vals, total);
    }
  }

  // --- one block of one scan (jdhuff.c, jdphuff.c) ---
  int ss = 0, se = 63, ah = 0, al = 0;
  unsigned eobrun = 0;

  void block_sequential(BitReader& br, Component& c, int16_t* blk) {
    std::memset(blk, 0, 64 * sizeof(int16_t));
    const int t = br.decode(dc[c.dc_tbl]);
    if (t > 16) corrupt("bad DC category");
    const int diff = t ? extend(br.get(t), t) : 0;
    c.pred += diff;
    blk[0] = static_cast<int16_t>(c.pred);
    const Huff& ha = ac[c.ac_tbl];
    for (int k = 1; k < 64; k++) {
      const int rs = br.decode(ha);
      const int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kZigzag[k]] = static_cast<int16_t>(extend(br.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void block_dc_first(BitReader& br, Component& c, int16_t* blk) {
    const int t = br.decode(dc[c.dc_tbl]);
    if (t > 16) corrupt("bad DC category");
    const int diff = t ? extend(br.get(t), t) : 0;
    c.pred += diff;
    blk[0] = static_cast<int16_t>(static_cast<uint32_t>(c.pred) << al);
  }

  void block_dc_refine(BitReader& br, int16_t* blk) {
    if (br.get(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
  }

  void block_ac_first(BitReader& br, Component& c, int16_t* blk) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    const Huff& ha = ac[c.ac_tbl];
    for (int k = ss; k <= se; k++) {
      const int rs = br.decode(ha);
      int r = rs >> 4;
      const int s = rs & 15;
      if (s) {
        k += r;
        blk[kZigzag[k]] = static_cast<int16_t>(static_cast<uint32_t>(extend(br.get(s), s)) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1u << r;
        if (r) eobrun += br.get(r);
        eobrun--;
        break;
      }
    }
  }

  void block_ac_refine(BitReader& br, Component& c, int16_t* blk) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    auto refine = [&](int16_t& coef) {
      if (br.get(1) && (coef & p1) == 0) coef = static_cast<int16_t>(coef + (coef >= 0 ? p1 : m1));
    };
    int k = ss;
    if (eobrun == 0) {
      const Huff& ha = ac[c.ac_tbl];
      for (; k <= se; k++) {
        const int rs = br.decode(ha);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : m1;  // a size other than 1 is a warning in libjpeg
        } else if (r != 15) {
          eobrun = 1u << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t& coef = blk[kZigzag[k]];
          if (coef != 0) {
            refine(coef);
          } else if (--r < 0) {
            break;
          }
          k++;
        } while (k <= se);
        if (s) blk[kZigzag[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t& coef = blk[kZigzag[k]];
        if (coef != 0) refine(coef);
      }
      eobrun--;
    }
  }

  // skips the entropy-coded data from `pos`: returns the position of the
  // next marker that is not RSTn
  size_t scan_end(size_t p) const {
    while (p + 1 < len) {
      if (data[p] == 0xFF && data[p + 1] != 0x00 && !(data[p + 1] >= 0xD0 && data[p + 1] <= 0xD7) &&
          data[p + 1] != 0xFF)
        return p;
      p++;
    }
    corrupt("truncated JPEG (no marker after the scan)");
  }

  void parse_sos(size_t seg, int seglen) {
    if (!frame) corrupt("SOS before SOF");
    const int ns = byte_at(seg);
    if (ns < 1 || ns > ncomp || seglen < 6 + 2 * ns) corrupt("bad SOS");
    const size_t tail = seg + 1 + 2 * ns;
    ss = byte_at(tail);
    se = byte_at(tail + 1);
    ah = byte_at(tail + 2) >> 4;
    al = byte_at(tail + 2) & 15;
    if (!progressive) {
      if (ss != 0 || se != 63 || ah != 0 || al != 0)
        corrupt("sequential JPEG scan with a spectral selection");
    } else {  // jdphuff.c's start_pass_phuff_decoder
      bool bad = ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1);
      if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
      if (bad) corrupt("bad progressive JPEG scan parameters");
    }
    Component* sc[4];
    for (int i = 0; i < ns; i++) {
      const int cid = byte_at(seg + 1 + 2 * i), tbl = byte_at(seg + 2 + 2 * i);
      sc[i] = nullptr;
      for (int j = 0; j < ncomp; j++)
        if (comp[j].id == cid) sc[i] = &comp[j];
      if (!sc[i]) corrupt("SOS names an unknown component");
      Component& c = *sc[i];
      c.dc_tbl = tbl >> 4;
      c.ac_tbl = tbl & 15;
      const bool need_dc = !progressive || (ss == 0 && ah == 0);
      const bool need_ac = !progressive || ss != 0;
      if (c.dc_tbl > 3 || c.ac_tbl > 3 || (need_dc && !dc[c.dc_tbl].defined) ||
          (need_ac && !ac[c.ac_tbl].defined))
        corrupt("SOS uses an undefined Huffman table");
      if (!c.latched) {
        if (!qt_defined[c.tq]) corrupt("undefined quantization table");
        std::memcpy(c.q, qt[c.tq], sizeof c.q);
        c.latched = true;
        c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
      }
      c.pred = 0;
      if (progressive)
        for (int k = ss; k <= se; k++) c.coef_bits[k] = al;
    }
    scans++;
    eobrun = 0;
    pos = seg + seglen - 2;
    BitReader br{data + pos, data + len};
    long mcus_w, mcus_h;
    if (ns == 1) {
      mcus_w = sc[0]->wib;
      mcus_h = sc[0]->hib;
    } else {
      mcus_w = mcux;
      mcus_h = mcuy;
    }
    auto one = [&](Component& c, int16_t* blk) {
      if (!progressive) block_sequential(br, c, blk);
      else if (ss == 0 && ah == 0) block_dc_first(br, c, blk);
      else if (ss == 0) block_dc_refine(br, blk);
      else if (ah == 0) block_ac_first(br, c, blk);
      else block_ac_refine(br, c, blk);
    };
    const long total = mcus_w * mcus_h;
    int expected_rst = 0;
    for (long m = 0; m < total; m++) {
      if (restart && m > 0 && m % restart == 0) {
        // find the RSTn marker: the bits before it are padding
        const uint8_t* p = br.p;
        while (p + 1 < data + len && !(p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7)) {
          if (p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF) corrupt("missing restart marker");
          p++;
        }
        if (p + 1 >= data + len) corrupt("truncated JPEG (restart marker)");
        if (p[1] != 0xD0 + expected_rst) corrupt("restart marker out of order");
        expected_rst = (expected_rst + 1) & 7;
        br.reset(p + 2);
        for (int i = 0; i < ns; i++) sc[i]->pred = 0;
        eobrun = 0;
      }
      const long my = m / mcus_w, mx = m % mcus_w;
      if (ns == 1) {
        one(*sc[0], sc[0]->block(mx, my));
        continue;
      }
      for (int i = 0; i < ns; i++) {
        Component& c = *sc[i];
        for (int v = 0; v < c.v; v++)
          for (int h = 0; h < c.h; h++) one(c, c.block(mx * c.h + h, my * c.v + v));
      }
    }
    pos = scan_end(static_cast<size_t>(br.p - data));
  }

  void parse() {
    if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) corrupt("not a JPEG (no SOI)");
    pos = 2;
    for (;;) {
      if (pos >= len) {
        if (scans) return;  // all scans decoded, EOI missing
        corrupt("truncated JPEG");
      }
      const int marker = next_marker();
      if (marker == 0xD9) {
        if (!scans) corrupt("JPEG without a scan");
        return;
      }
      if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
      const int seglen = u16(pos);
      if (seglen < 2) corrupt("bad JPEG segment length");
      const size_t seg = pos + 2;
      if (seg + seglen - 2 > len) corrupt("truncated JPEG segment");
      if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 && marker != 0xC8 &&
          marker != 0xCC) {
        parse_sof(marker, seg, seglen);
      } else if (marker == 0xCC) {
        unsupported("arithmetic-coded JPEG");
      } else if (marker == 0xC4) {
        parse_dht(seg, seglen);
      } else if (marker == 0xDB) {
        parse_dqt(seg, seglen);
      } else if (marker == 0xDD) {
        restart = u16(seg);
      } else if (marker == 0xDA) {
        parse_sos(seg, seglen);
        continue;
      } else if (marker == 0xE0) {
        if (seglen >= 7 && std::memcmp(data + seg, "JFIF\0", 5) == 0) jfif = true;
      } else if (marker == 0xEE) {
        if (seglen >= 14 && std::memcmp(data + seg, "Adobe", 5) == 0) {
          adobe = true;
          adobe_transform = data[seg + 11];
        }
      }
      pos = seg + seglen - 2;
    }
  }

  // jdapimin.c's default_decompress_parms
  bool is_rgb() const {
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
  }
  bool is_ycck() const { return adobe && adobe_transform != 0; }
};

// jdcoefct.c's smoothing_ok: progressive, every component's first quantizers
// nonzero, its DC seen, and some of its first nine AC coefficients owed bits
bool smoothing_ok(const Jpeg& j) {
  if (!j.progressive) return false;
  static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
  bool useful = false;
  for (int i = 0; i < j.ncomp; i++) {
    const Component& c = j.comp[i];
    for (int k = 0; k < 10; k++)
      if (c.q[kPos[k]] == 0) return false;
    if (c.coef_bits[0] < 0) return false;
    for (int k = 1; k < 10; k++)
      if (c.coef_bits[k] != 0) useful = true;
  }
  return useful;
}

// jdcoefct.c's decompress_smooth_data over the whole image (the coefficient
// buffer is complete: every iMCU row is "good"): each block whose first
// coefficients are still owed bits gets them estimated from the DC values of
// a 5x5 window of blocks, then the IDCT.
void idct_smoothed(Component& c, int total_imcu_rows) {
  const int* bits = c.coef_bits;
  const bool change_dc = bits[1] == -1 && bits[2] == -1 && bits[3] == -1 && bits[4] == -1 &&
                         bits[5] == -1 && bits[6] == -1 && bits[7] == -1 && bits[8] == -1 &&
                         bits[9] == -1;
  const int64_t Q00 = c.q[0], Q01 = c.q[1], Q10 = c.q[8], Q20 = c.q[16], Q11 = c.q[9],
                Q02 = c.q[2], Q03 = c.q[3], Q12 = c.q[10], Q21 = c.q[17], Q30 = c.q[24];
  const int last_imcu = total_imcu_rows - 1, last_col = c.wib - 1;
  const size_t pw = static_cast<size_t>(c.bw) * 8;
  int16_t ws[64];
  auto estimate = [&](int coefi, int pos, int64_t qk, int64_t sum) {
    const int al = bits[coefi];
    if (al == 0 || ws[pos] != 0) return;
    const int64_t num = Q00 * sum;
    int pred = static_cast<int>(((qk << 7) + (num >= 0 ? num : -num)) / (qk << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    ws[pos] = static_cast<int16_t>(num >= 0 ? pred : -pred);
  };
  for (int ir = 0; ir < total_imcu_rows; ir++) {
    int block_rows = c.v;
    if (ir == last_imcu) {
      block_rows = c.hib % c.v;
      if (block_rows == 0) block_rows = c.v;
    }
    const int image_block_rows = block_rows * total_imcu_rows;
    for (int br = 0; br < block_rows; br++) {
      const int ibr = ir * block_rows + br, row = ir * c.v + br;
      const int16_t* r[5];
      r[2] = c.block(0, row);
      r[1] = ibr > 0 ? c.block(0, row - 1) : r[2];
      r[0] = ibr > 1 ? c.block(0, row - 2) : r[1];
      r[3] = ibr < image_block_rows - 1 ? c.block(0, row + 1) : r[2];
      r[4] = ibr < image_block_rows - 2 ? c.block(0, row + 2) : r[3];
      int d[5][5];  // d[row][col]: DC01..DC25 row-major
      for (int i = 0; i < 5; i++)
        for (int k = 0; k < 5; k++) d[i][k] = r[i][0];
      for (int bn = 0; bn <= last_col; bn++) {
        std::memcpy(ws, r[2] + static_cast<size_t>(bn) * 64, sizeof ws);
        if (bn == 0 && bn < last_col)
          for (int i = 0; i < 5; i++) d[i][3] = d[i][4] = r[i][64];
        if (bn + 1 < last_col)
          for (int i = 0; i < 5; i++) d[i][4] = r[i][(static_cast<size_t>(bn) + 2) * 64];
        const int64_t DC01 = d[0][0], DC02 = d[0][1], DC03 = d[0][2], DC04 = d[0][3],
                      DC05 = d[0][4], DC06 = d[1][0], DC07 = d[1][1], DC08 = d[1][2],
                      DC09 = d[1][3], DC10 = d[1][4], DC11 = d[2][0], DC12 = d[2][1],
                      DC13 = d[2][2], DC14 = d[2][3], DC15 = d[2][4], DC16 = d[3][0],
                      DC17 = d[3][1], DC18 = d[3][2], DC19 = d[3][3], DC20 = d[3][4],
                      DC21 = d[4][0], DC22 = d[4][1], DC23 = d[4][2], DC24 = d[4][3],
                      DC25 = d[4][4];
        estimate(1, 1, Q01,
                 change_dc ? -DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 +
                                 3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 -
                                 3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 - DC21 - DC22 +
                                 DC24 + DC25
                           : -7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15);
        estimate(2, 8, Q10,
                 change_dc ? -DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 +
                                 38 * DC08 + 13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 -
                                 13 * DC19 + DC20 + DC21 + 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25
                           : -7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23);
        estimate(3, 16, Q20,
                 change_dc ? DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 -
                                 5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 + DC23
                           : -DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23);
        estimate(4, 9, Q11,
                 change_dc ? -DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 -
                                 DC25
                           : DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 +
                                 DC04 - DC06 + 10 * DC07 - 10 * DC09);
        estimate(5, 2, Q02,
                 change_dc ? 2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 +
                                 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19
                           : -DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15);
        if (change_dc) {
          estimate(6, 3, Q03, DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19);
          estimate(7, 10, Q12, DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19);
          estimate(8, 17, Q21, DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19);
          estimate(9, 24, Q30, DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19);
          const int64_t num =
              Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 +
                     6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 +
                     152 * DC13 + 42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 +
                     6 * DC19 - 6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
          const int pred = static_cast<int>(((Q00 << 7) + (num >= 0 ? num : -num)) / (Q00 << 8));
          ws[0] = static_cast<int16_t>(num >= 0 ? pred : -pred);
        }
        idct_islow(ws, c.q, &c.plane[static_cast<size_t>(row) * 8 * pw + bn * 8], pw);
        for (int i = 0; i < 5; i++)
          for (int k = 0; k < 4; k++) d[i][k] = d[i][k + 1];
      }
    }
  }
}

// every component's coefficients through the IDCT into its plane
void idct_all(Jpeg& j) {
  const bool smooth = smoothing_ok(j);
  for (int i = 0; i < j.ncomp; i++) {
    Component& c = j.comp[i];
    if (!c.latched) corrupt("JPEG component without a scan");
    const size_t pw = static_cast<size_t>(c.bw) * 8;
    c.plane.assign(pw * c.bh * 8, 0);
    if (smooth) {
      idct_smoothed(c, j.mcuy);
      continue;
    }
    for (int by = 0; by < c.hib; by++)
      for (int bx = 0; bx < c.wib; bx++)
        idct_islow(c.block(bx, by), c.q, &c.plane[static_cast<size_t>(by) * 8 * pw + bx * 8], pw);
  }
}

// jdsample.c: one component's rows [dh] of [dw] samples up to the output
// size, row by row into `out` ([dh * rv][ow], ow = dw * rh >= width).  The
// upsampler libjpeg-turbo picks: fancy h2v1 / h2v2 (plain replication at a
// downsampled width of 2 or less), fancy h1v2, int_upsample otherwise.
void upsample(const Component& c, int rh, int rv, std::vector<uint8_t>& out, int& ow) {
  const int dw = c.dw, dh = c.dh;
  const size_t pw = static_cast<size_t>(c.bw) * 8;
  ow = dw * rh;
  out.assign(static_cast<size_t>(ow) * dh * rv, 0);
  auto row = [&](int r) { return &c.plane[static_cast<size_t>(std::min(std::max(r, 0), dh - 1)) * pw]; };
  const bool fancy = dw > 2;
  for (int r = 0; r < dh; r++) {
    const uint8_t* in0 = row(r);
    if (rh == 2 && rv == 1 && fancy) {
      uint8_t* o = &out[static_cast<size_t>(r) * ow];
      int iv = in0[0];
      o[0] = static_cast<uint8_t>(iv);
      o[1] = static_cast<uint8_t>((iv * 3 + in0[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; x++) {
        iv = in0[x] * 3;
        o[2 * x] = static_cast<uint8_t>((iv + in0[x - 1] + 1) >> 2);
        o[2 * x + 1] = static_cast<uint8_t>((iv + in0[x + 1] + 2) >> 2);
      }
      iv = in0[dw - 1];
      o[2 * dw - 2] = static_cast<uint8_t>((iv * 3 + in0[dw - 2] + 1) >> 2);
      o[2 * dw - 1] = static_cast<uint8_t>(iv);
    } else if (rh == 1 && rv == 2) {  // h1v2_fancy_upsample
      for (int v = 0; v < 2; v++) {
        uint8_t* o = &out[static_cast<size_t>(2 * r + v) * ow];
        const uint8_t* in1 = row(v == 0 ? r - 1 : r + 1);
        const int bias = v == 0 ? 1 : 2;
        for (int x = 0; x < dw; x++) o[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
      }
    } else if (rh == 2 && rv == 2 && fancy) {
      for (int v = 0; v < 2; v++) {
        uint8_t* o = &out[static_cast<size_t>(2 * r + v) * ow];
        const uint8_t* in1 = row(v == 0 ? r - 1 : r + 1);
        int thiscolsum = in0[0] * 3 + in1[0];
        int nextcolsum = in0[1] * 3 + in1[1];
        o[0] = static_cast<uint8_t>((thiscolsum * 4 + 8) >> 4);
        o[1] = static_cast<uint8_t>((thiscolsum * 3 + nextcolsum + 7) >> 4);
        int lastcolsum = thiscolsum;
        thiscolsum = nextcolsum;
        for (int x = 1; x < dw - 1; x++) {
          nextcolsum = in0[x + 1] * 3 + in1[x + 1];
          o[2 * x] = static_cast<uint8_t>((thiscolsum * 3 + lastcolsum + 8) >> 4);
          o[2 * x + 1] = static_cast<uint8_t>((thiscolsum * 3 + nextcolsum + 7) >> 4);
          lastcolsum = thiscolsum;
          thiscolsum = nextcolsum;
        }
        o[2 * dw - 2] = static_cast<uint8_t>((thiscolsum * 3 + lastcolsum + 8) >> 4);
        o[2 * dw - 1] = static_cast<uint8_t>((thiscolsum * 4 + 7) >> 4);
      }
    } else {  // fullsize, h2v1 / h2v2 replication and int_upsample
      uint8_t* o = &out[static_cast<size_t>(r) * rv * ow];
      for (int x = 0; x < dw; x++)
        for (int k = 0; k < rh; k++) o[x * rh + k] = in0[x];
      for (int v = 1; v < rv; v++) std::memcpy(o + static_cast<size_t>(v) * ow, o, ow);
    }
  }
}

struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t one_half = int64_t{1} << 15;
    auto fix = [](double x) { return static_cast<int64_t>(x * (int64_t{1} << 16) + 0.5); };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : static_cast<uint8_t>(v)); }

// The decoded samples [h, w, nc] as libjpeg hands them out: gray (nc 1),
// RGB (nc 3, YCbCr converted), or CMYK as stored (nc 4, Adobe's inverted
// polarity, not converted).
int jpeg_samples(Jpeg& j, std::vector<uint8_t>& px) {
  if (j.ncomp == 4 && j.force_ycc < 0 && j.is_ycck()) unsupported("YCCK JPEG");
  idct_all(j);
  const int w = j.width, h = j.height, nc = j.ncomp;
  px.assign(static_cast<size_t>(w) * h * nc, 0);
  if (nc == 1) {
    const Component& c = j.comp[0];
    const size_t pw = static_cast<size_t>(c.bw) * 8;
    for (int y = 0; y < h; y++) std::memcpy(&px[static_cast<size_t>(y) * w], &c.plane[y * pw], w);
    return nc;
  }
  std::vector<uint8_t> up[4];
  int ow[4];
  for (int i = 0; i < nc; i++)
    upsample(j.comp[i], j.hmax / j.comp[i].h, j.vmax / j.comp[i].v, up[i], ow[i]);
  const bool ycc = nc == 3 && (j.force_ycc < 0 ? !j.is_rgb() : j.force_ycc == 1);
  for (int y = 0; y < h; y++) {
    uint8_t* o = &px[static_cast<size_t>(y) * w * nc];
    const uint8_t* c[4];
    for (int i = 0; i < nc; i++) c[i] = &up[i][static_cast<size_t>(y) * ow[i]];
    for (int x = 0; x < w; x++, o += nc) {
      if (!ycc) {
        for (int i = 0; i < nc; i++) o[i] = c[i][x];
        continue;
      }
      const int yy = c[0][x], cb = c[1][x], cr = c[2][x];
      o[0] = clamp255(yy + kYcc.cr_r[cr]);
      o[1] = clamp255(yy + static_cast<int>((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
      o[2] = clamp255(yy + kYcc.cb_b[cb]);
    }
  }
  return nc;
}

// Pillow's RGBA of the samples: L and RGB as they are; CMYK is read as
// "CMYK;I" (inverted) and converted by Convert.c's cmyk2rgb.
void jpeg_rgba(Jpeg& j, std::vector<uint8_t>& rgba) {
  std::vector<uint8_t> px;
  const int nc = jpeg_samples(j, px);
  const size_t n = static_cast<size_t>(j.width) * j.height;
  rgba.assign(n * 4, 255);
  for (size_t i = 0; i < n; i++) {
    const uint8_t* s = &px[i * nc];
    uint8_t* o = &rgba[i * 4];
    if (nc == 1) {
      o[0] = o[1] = o[2] = s[0];
    } else if (nc == 3) {
      o[0] = s[0];
      o[1] = s[1];
      o[2] = s[2];
    } else {
      const unsigned nk = s[3];  // 255 - (255 - stored K)
      for (int c = 0; c < 3; c++)
        o[c] = clamp255(static_cast<int>(nk) - muldiv255(255u - s[c], nk));
    }
  }
}

template <typename F>
int guarded(char* err, int errlen, F&& f) {
  try {
    f();
    return 0;
  } catch (const Fail& e) {
    if (err && errlen > 0) std::snprintf(err, errlen, "%s", e.msg.c_str());
    return e.code;
  } catch (const std::bad_alloc&) {
    if (err && errlen > 0) std::snprintf(err, errlen, "out of memory");
    return kCorrupt;
  }
}

}  // namespace

extern "C" {

// The JPEG's width, height and component count without decoding it.
int ic_jpeg_info(const uint8_t* buf, size_t len, int* w, int* h, int* ncomp, char* err,
                 int errlen) {
  return guarded(err, errlen, [&] {
    Jpeg j{buf, len};
    if (len < 4 || buf[0] != 0xFF || buf[1] != 0xD8) corrupt("not a JPEG (no SOI)");
    j.pos = 2;
    for (;;) {
      const int marker = j.next_marker();
      if (marker == 0xD9 || marker == 0xDA) corrupt("JPEG without a frame header");
      if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
      const int seglen = j.u16(j.pos);
      if (seglen < 2) corrupt("bad JPEG segment length");
      const size_t seg = j.pos + 2;
      if (seg + seglen - 2 > len) corrupt("truncated JPEG segment");
      if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 && marker != 0xC8 &&
          marker != 0xCC) {
        j.parse_sof(marker, seg, seglen);
        *w = j.width;
        *h = j.height;
        *ncomp = j.ncomp;
        return;
      }
      j.pos = seg + seglen - 2;
    }
  });
}

// Decodes a JPEG into out [out_h, out_w, 4] (resized unless that is its size).
int ic_jpeg_decode(const uint8_t* buf, size_t len, int out_h, int out_w, uint8_t* out,
                   char* err, int errlen) {
  return guarded(err, errlen, [&] {
    Jpeg j{buf, len};
    j.parse();
    if (!j.frame) corrupt("JPEG without a frame header");
    std::vector<uint8_t> rgba;
    jpeg_rgba(j, rgba);
    resize_rgba(rgba.data(), j.height, j.width, out_h, out_w, out);
  });
}

// Decodes a JPEG into its samples out [h, w, ncomp] (see jpeg_samples). Where
// `ycc` is -1 the markers decide whether three components are YCbCr; a
// JPEG-in-TIFF strip or tile (its JPEGTables merged in) passes 1 under
// Photometric YCbCr (libtiff's JPEGCOLORMODE_RGB) and 0 otherwise, which
// keeps every component as stored.
int ic_jpeg_samples(const uint8_t* buf, size_t len, int ycc, uint8_t* out, char* err,
                    int errlen) {
  return guarded(err, errlen, [&] {
    Jpeg j{buf, len};
    j.force_ycc = ycc;
    j.parse();
    if (!j.frame) corrupt("JPEG without a frame header");
    std::vector<uint8_t> px;
    jpeg_samples(j, px);
    std::memcpy(out, px.data(), px.size());
  });
}

// Unfilters an inflated PNG image into out [out_h, out_w, 4] as Pillow's
// RGBA (resized unless that is its size).
int ic_png_decode(const uint8_t* raw, size_t rawlen, int w, int h, int color_type, int depth,
                  int interlace, const uint8_t* plte, int nplte, const uint8_t* trns,
                  int ntrns, int out_h, int out_w, uint8_t* out, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    std::vector<uint8_t> rgba;
    png_rgba(raw, rawlen, w, h, color_type, depth, interlace, plte, nplte, trns, ntrns, rgba);
    resize_rgba(rgba.data(), h, w, out_h, out_w, out);
  });
}

// Unfilters an inflated PNG image into its samples out [h, w, channels].
int ic_png_samples(const uint8_t* raw, size_t rawlen, int w, int h, int color_type, int depth,
                   int interlace, uint16_t* out, char* err, int errlen) {
  return guarded(err, errlen,
                 [&] { png_samples(raw, rawlen, w, h, color_type, depth, interlace, out); });
}

// Decodes a GIF image's LZW data into up to npix indices; *got says how many.
int ic_gif_lzw(const uint8_t* data, size_t len, int min_size, size_t npix, uint8_t* out,
               size_t* got, char* err, int errlen) {
  return guarded(err, errlen, [&] { *got = gif_lzw(data, len, min_size, npix, out); });
}

// Image.resize((out_w, out_h), BICUBIC) of an RGBA image [h, w, 4].
int ic_resize_rgba(const uint8_t* in, int h, int w, int out_h, int out_w, uint8_t* out) {
  return guarded(nullptr, 0, [&] { resize_rgba(in, h, w, out_h, out_w, out); });
}

}  // extern "C"
