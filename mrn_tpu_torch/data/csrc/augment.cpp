// Host augmentation ops of the PyTorch port: the per-pixel work of the
// training-time augmentations (TextAugment, ABINet's suite, MoCo) on RGBA
// uint8 [h, w, 4] arrays, as Pillow 12 and OpenCV 5 compute it, without
// either.  The geometry (matrices, output sizes, random draws) stays in
// Python (`data/augment.py`); every function here takes a finished matrix.
//
// Pillow (libImaging):
// - `gaussian_blur`: BoxBlur.c's extended box blur, 3 passes a direction,
//   the radius turned into a box radius in float (`_gaussian_blur_radius`),
//   24-bit fixed-point weights, every band (alpha too) blurred.
// - `affine_bicubic`: Geometry.c's generic affine transform with the
//   bicubic filter (a = -1, doubles, truncated to uint8), pixel centres at
//   +0.5, pixels whose source lies outside filled with 0; RGBA runs through
//   premultiplied RGBa and back (Convert.c), as `Image.transform` does for
//   a filter other than NEAREST.
// - `blend`: Blend.c (float alpha; truncated, clipped when extrapolating).
// - `rgb_to_l`, `rgb_to_hsv`, `hsv_to_rgb`: Convert.c's L24, rgb2hsv and
//   hsv2rgb.
//
// OpenCV 5 (imgproc) on this code's reference build (AVX-512 dispatch):
// - `warp`: warpAffine / warpPerspective, 4 channels, BORDER_REPLICATE,
//   from the inverse matrix cast to float.  NEAREST and LINEAR (AREA runs
//   as LINEAR) compute the source point with one fused multiply-add in the
//   16-wide vector body and another form in the scalar tail; LINEAR
//   interpolates with fused lerps; CUBIC (A = -0.75, taps from double)
//   finds the source point without fusing.
//   Every result is rounded half to even.
// - `warp_kernel_f64`: warpAffine of a float64 single-channel image,
//   INTER_LINEAR, BORDER_CONSTANT 0: the fixed-point remap (1/32 source
//   steps, float tap weights, double sums).
// - `resize`: NEAREST; LINEAR and AREA-upscale with 11-bit fixed-point taps
//   (the vertical pass in the vector form's rounding); CUBIC in float from
//   a source point and taps in double (Intel IPP's path), or from a source
//   under 4 pixels on a side OpenCV's own fixed-point form;
//   AREA-downscale with float tables (integer ratios: the fast path; an
//   exact 2x LINEAR runs it too).
// - `pyr_down`: the 5x5 [1 4 6 4 1] Gaussian, BORDER_REFLECT_101, integers.
// - `filter2d`: the direct float correlation (fused, over the kernel's
//   nonzero taps in row order), BORDER_REFLECT_101.
//
// CUBIC warps and CUBIC resizes are not bit for bit: OpenCV's order of
// float operations there is not known, and about 1 value in 10^5 lands on
// the other side of a .5 (ROADMAP.md §3).  Everything else is held to
// Pillow and OpenCV bit for bit by tests/test_torch_augment_ops.py.
//
// Errors: a return of 1 is a bad argument (sizes, interpolation).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kNearest = 0, kLinear = 1, kCubic = 2, kArea = 3;
constexpr int kVec = 16;  // the vector body's width in output pixels

inline int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

inline uint8_t sat_round(float v) {
  // cvRound / v_round: half to even (the default rounding mode)
  if (!(v > -1e9f && v < 1e9f)) return v > 0 ? 255 : 0;
  const long r = std::lrint(v);
  return static_cast<uint8_t>(r < 0 ? 0 : (r > 255 ? 255 : r));
}

inline int floor_int(float v) {
  if (v < -1e8f) return -100000000;
  if (v > 1e8f) return 100000000;
  return static_cast<int>(std::floor(v));
}

// ------------------------------------------------------------ Pillow blur

inline uint8_t muldiv255(unsigned a, unsigned b) {
  const unsigned tmp = a * b + 128;
  return static_cast<uint8_t>(((tmp >> 8) + tmp) >> 8);
}

float gaussian_blur_radius(float radius, int passes) {
  float sigma2, L, l, a;
  sigma2 = radius * radius / passes;
  L = static_cast<float>(std::sqrt(12.0 * sigma2 + 1.0));
  l = static_cast<float>(std::floor((L - 1.0) / 2.0));
  a = (2 * l + 1) * (l * (l + 1) - 3 * sigma2);
  a /= 6 * (sigma2 - (l + 1) * (l + 1));
  return l + a;
}

// One line of BoxBlur.c's BoxBlurLine (4 bands).
void box_blur_line(const uint8_t* in, uint8_t* out, int n, int radius, uint32_t ww, uint32_t fw) {
  const int lastx = n - 1;
  const int edgeA = std::min(radius + 1, n);
  const int edgeB = std::max(n - radius - 1, 0);
  auto px = [&](int i) { return in + static_cast<size_t>(i) * 4; };
  uint32_t acc[4], bulk[4];
  for (int c = 0; c < 4; c++) acc[c] = px(0)[c] * (radius + 1);
  for (int x = 0; x < edgeA - 1; x++)
    for (int c = 0; c < 4; c++) acc[c] += px(x)[c];
  for (int c = 0; c < 4; c++) acc[c] += px(lastx)[c] * (radius - edgeA + 1);
  auto step_out = [&](int x, int sub, int add, int left, int right) {
    for (int c = 0; c < 4; c++) {
      acc[c] += px(add)[c] - px(sub)[c];
      bulk[c] = acc[c] * ww + (px(left)[c] + px(right)[c]) * fw;
      out[static_cast<size_t>(x) * 4 + c] = static_cast<uint8_t>((bulk[c] + (1u << 23)) >> 24);
    }
  };
  if (edgeA <= edgeB) {
    for (int x = 0; x < edgeA; x++) step_out(x, 0, x + radius, 0, x + radius + 1);
    for (int x = edgeA; x < edgeB; x++)
      step_out(x, x - radius - 1, x + radius, x - radius - 1, x + radius + 1);
    for (int x = edgeB; x <= lastx; x++) step_out(x, x - radius - 1, lastx, x - radius - 1, lastx);
  } else {
    for (int x = 0; x < edgeB; x++) step_out(x, 0, x + radius, 0, x + radius + 1);
    for (int x = edgeB; x < edgeA; x++) step_out(x, 0, lastx, 0, lastx);
    for (int x = edgeA; x <= lastx; x++) step_out(x, x - radius - 1, lastx, x - radius - 1, lastx);
  }
}

// ImagingHorizontalBoxBlur over rows (vertical=false) or columns.
void box_blur_pass(uint8_t* img, int h, int w, float float_radius, bool vertical) {
  const int radius = static_cast<int>(float_radius);
  const uint32_t ww = static_cast<uint32_t>(static_cast<float>(1u << 24) / (float_radius * 2 + 1));
  const uint32_t fw = ((1u << 24) - (radius * 2 + 1) * ww) / 2;
  const int lines = vertical ? w : h, n = vertical ? h : w, step = vertical ? w : 1;
  std::vector<uint8_t> line(static_cast<size_t>(n) * 4), out(static_cast<size_t>(n) * 4);
  for (int l = 0; l < lines; l++) {
    uint8_t* base = vertical ? img + static_cast<size_t>(l) * 4 : img + static_cast<size_t>(l) * w * 4;
    for (int i = 0; i < n; i++) std::memcpy(&line[i * 4], base + static_cast<size_t>(i) * step * 4, 4);
    box_blur_line(line.data(), out.data(), n, radius, ww, fw);
    for (int i = 0; i < n; i++) std::memcpy(base + static_cast<size_t>(i) * step * 4, &out[i * 4], 4);
  }
}

// ------------------------------------------------------- Pillow transform

inline double bicubic(double v1, double v2, double v3, double v4, double d) {
  const double p1 = v2;
  const double p2 = -v1 + v3;
  const double p3 = 2 * (v1 - v2) + v3 - v4;
  const double p4 = -v1 + v2 - v3 + v4;
  return p1 + d * (p2 + d * (p3 + d * p4));
}

inline int pil_floor(double x) { return x < 0.0 ? static_cast<int>(std::floor(x)) : static_cast<int>(x); }

bool bicubic_filter32(uint8_t* out, const uint8_t* im, int h, int w, double xin, double yin) {
  if (xin < 0.0 || xin >= w || yin < 0.0 || yin >= h) return false;
  xin -= 0.5;
  yin -= 0.5;
  int x = pil_floor(xin), y = pil_floor(yin);
  const double dx = xin - x, dy = yin - y;
  x--;
  y--;
  const int x0 = clampi(x + 0, 0, w - 1) * 4, x1 = clampi(x + 1, 0, w - 1) * 4;
  const int x2 = clampi(x + 2, 0, w - 1) * 4, x3 = clampi(x + 3, 0, w - 1) * 4;
  for (int b = 0; b < 4; b++) {
    auto row = [&](int yy) {
      const uint8_t* in = im + static_cast<size_t>(yy) * w * 4 + b;
      return bicubic(in[x0], in[x1], in[x2], in[x3], dx);
    };
    double v1 = row(clampi(y, 0, h - 1)), v2, v3, v4;
    v2 = (y + 1 >= 0 && y + 1 < h) ? row(y + 1) : v1;
    v3 = (y + 2 >= 0 && y + 2 < h) ? row(y + 2) : v2;
    v4 = (y + 3 >= 0 && y + 3 < h) ? row(y + 3) : v3;
    v1 = bicubic(v1, v2, v3, v4, dy);
    out[b] = v1 <= 0.0 ? 0 : (v1 >= 255.0 ? 255 : static_cast<uint8_t>(v1));
  }
  return true;
}

void premultiply(const uint8_t* in, size_t npix, uint8_t* out) {
  for (size_t i = 0; i < npix * 4; i += 4) {
    const unsigned a = in[i + 3];
    out[i + 0] = muldiv255(in[i + 0], a);
    out[i + 1] = muldiv255(in[i + 1], a);
    out[i + 2] = muldiv255(in[i + 2], a);
    out[i + 3] = in[i + 3];
  }
}

void unpremultiply(uint8_t* px, size_t npix) {
  for (size_t i = 0; i < npix * 4; i += 4) {
    const unsigned a = px[i + 3];
    if (a == 255 || a == 0) continue;
    for (int c = 0; c < 3; c++) {
      const unsigned v = (255u * px[i + c]) / a;
      px[i + c] = v > 255 ? 255 : static_cast<uint8_t>(v);
    }
  }
}

// --------------------------------------------------------- OpenCV warps

// interpolateCubic's taps (A = -0.75) in float
inline void interp_cubic_f(float x, float c[4]) {
  const float A = -0.75f;
  c[0] = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1) - 4 * A;
  c[1] = ((A + 2) * x - (A + 3)) * x * x + 1;
  c[2] = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1;
  c[3] = 1.f - c[0] - c[1] - c[2];
}

struct Px {
  const uint8_t* im;
  int h, w;
  inline const uint8_t* at(int y, int x) const {
    return im + (static_cast<size_t>(clampi(y, 0, h - 1)) * w + clampi(x, 0, w - 1)) * 4;
  }
};

// interpolateCubic's taps (A = -0.75), computed in double, stored as float
inline void interp_cubic(double x, float c[4]) {
  const double A = -0.75;
  const double c0 = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1) - 4 * A;
  const double c1 = ((A + 2) * x - (A + 3)) * x * x + 1;
  const double c2 = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1;
  c[0] = static_cast<float>(c0);
  c[1] = static_cast<float>(c1);
  c[2] = static_cast<float>(c2);
  c[3] = static_cast<float>(1 - c0 - c1 - c2);
}

void sample(const Px& src, int interp, float sx, float sy, uint8_t* out) {
  if (!std::isfinite(sx) || !std::isfinite(sy)) {  // a singular perspective matrix
    std::memcpy(out, src.at(0, 0), 4);
    return;
  }
  if (interp == kNearest) {
    const float rx = std::nearbyint(sx), ry = std::nearbyint(sy);
    const uint8_t* p = src.at(floor_int(ry), floor_int(rx));
    std::memcpy(out, p, 4);
    return;
  }
  const int ix = floor_int(sx), iy = floor_int(sy);
  const float a = sx - std::floor(sx), b = sy - std::floor(sy);
  if (interp == kLinear) {
    const uint8_t *p00 = src.at(iy, ix), *p01 = src.at(iy, ix + 1);
    const uint8_t *p10 = src.at(iy + 1, ix), *p11 = src.at(iy + 1, ix + 1);
    for (int c = 0; c < 4; c++) {
      const float f00 = p00[c], f01 = p01[c], f10 = p10[c], f11 = p11[c];
      const float v0 = std::fma(a, f01 - f00, f00);
      const float v1 = std::fma(a, f11 - f10, f10);
      out[c] = sat_round(std::fma(b, v1 - v0, v0));
    }
    return;
  }
  float cx[4], cy[4];
  interp_cubic(a, cx);
  interp_cubic(b, cy);
  const uint8_t* p[4][4];
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 4; j++) p[i][j] = src.at(iy + i - 1, ix + j - 1);
  for (int c = 0; c < 4; c++) {
    float r[4];
    for (int i = 0; i < 4; i++) {
      float s = cx[0] * static_cast<float>(p[i][0][c]);
      s = std::fma(cx[1], static_cast<float>(p[i][1][c]), s);
      s = std::fma(cx[2], static_cast<float>(p[i][2][c]), s);
      r[i] = std::fma(cx[3], static_cast<float>(p[i][3][c]), s);
    }
    float v = cy[0] * r[0];
    v = std::fma(cy[1], r[1], v);
    v = std::fma(cy[2], r[2], v);
    out[c] = sat_round(std::fma(cy[3], r[3], v));
  }
}

// The source point of output (x, y) under m (2x3, or 3x3 when persp).
inline void source_point(const float* m, bool persp, int interp, bool tail, int x, int y,
                         float* sx, float* sy) {
  const float xf = static_cast<float>(x), yf = static_cast<float>(y);
  float X, Y, W = 1.f;
  if (interp == kCubic) {
    if (tail) {
      X = (m[0] * xf + m[1] * yf) + m[2];
      Y = (m[3] * xf + m[4] * yf) + m[5];
      if (persp) W = (m[6] * xf + m[7] * yf) + m[8];
    } else {
      X = m[0] * xf + (m[1] * yf + m[2]);
      Y = m[3] * xf + (m[4] * yf + m[5]);
      if (persp) W = m[6] * xf + (m[7] * yf + m[8]);
    }
  } else if (tail) {
    X = std::fma(xf, m[0], yf * m[1]) + m[2];
    Y = std::fma(xf, m[3], yf * m[4]) + m[5];
    if (persp) W = std::fma(xf, m[6], yf * m[7]) + m[8];
  } else {
    const float rx = m[1] * yf, ry = m[4] * yf, rw = persp ? m[7] * yf : 0.f;
    X = std::fma(m[0], xf, rx + m[2]);
    Y = std::fma(m[3], xf, ry + m[5]);
    if (persp) W = std::fma(m[6], xf, rw + m[8]);
  }
  if (persp) {
    *sx = X / W;
    *sy = Y / W;
  } else {
    *sx = X;
    *sy = Y;
  }
}

// ------------------------------------------------------- OpenCV resize

inline short sat_short(float v) {
  const long r = std::lrint(v);
  return static_cast<short>(r < -32768 ? -32768 : (r > 32767 ? 32767 : r));
}

// resizeGeneric_'s tables: per output index its first tap and ksize taps.
void resize_tabs(int ssize, int dsize, int interp, bool is_x, std::vector<int>& ofs,
                 std::vector<float>& coef, bool cubic_double = true) {
  const double inv_scale = static_cast<double>(dsize) / ssize;
  const double scale = 1. / inv_scale;
  const int ksize = interp == kCubic ? 4 : 2;
  ofs.assign(dsize, 0);
  coef.assign(static_cast<size_t>(dsize) * ksize, 0.f);
  for (int d = 0; d < dsize; d++) {
    float f;
    int s;
    if (interp == kCubic && cubic_double) {  // the source point in double
      const double fd = (d + 0.5) * scale - 0.5;
      s = static_cast<int>(std::floor(fd));
      f = static_cast<float>(fd - s);
    } else if (interp != kArea) {
      f = static_cast<float>((d + 0.5) * scale - 0.5);
      s = static_cast<int>(std::floor(f));
      f -= s;
    } else {
      s = static_cast<int>(std::floor(d * scale));
      f = static_cast<float>((d + 1) - (s + 1) * inv_scale);
      f = f <= 0 ? 0.f : f - std::floor(f);
    }
    if (is_x && interp != kCubic) {
      if (s < 0) f = 0, s = 0;
      if (s >= ssize - 1) f = 0, s = ssize - 1;
    }
    ofs[d] = s;
    float* c = &coef[static_cast<size_t>(d) * ksize];
    if (interp == kCubic) {
      if (cubic_double)
        interp_cubic(f, c);
      else
        interp_cubic_f(f, c);
    } else {
      c[0] = 1.f - f;
      c[1] = f;
    }
  }
}

void resize_nearest(const uint8_t* in, int h, int w, int oh, int ow, uint8_t* out) {
  const double ifx = 1. / (static_cast<double>(ow) / w), ify = 1. / (static_cast<double>(oh) / h);
  std::vector<int> xs(ow);
  for (int x = 0; x < ow; x++) xs[x] = std::min(static_cast<int>(std::floor(x * ifx)), w - 1);
  for (int y = 0; y < oh; y++) {
    const int sy = std::min(static_cast<int>(std::floor(y * ify)), h - 1);
    for (int x = 0; x < ow; x++)
      std::memcpy(out + (static_cast<size_t>(y) * ow + x) * 4,
                  in + (static_cast<size_t>(sy) * w + xs[x]) * 4, 4);
  }
}

void resize_linear(const uint8_t* in, int h, int w, int oh, int ow, int interp, uint8_t* out) {
  std::vector<int> xo, yo;
  std::vector<float> xc, yc;
  resize_tabs(w, ow, interp, true, xo, xc);
  resize_tabs(h, oh, interp, false, yo, yc);
  std::vector<short> xa(xc.size()), ya(yc.size());
  for (size_t i = 0; i < xc.size(); i++) xa[i] = sat_short(xc[i] * 2048.f);
  for (size_t i = 0; i < yc.size(); i++) ya[i] = sat_short(yc[i] * 2048.f);
  std::vector<int> rows(static_cast<size_t>(h) * ow * 4);
  for (int y = 0; y < h; y++) {
    const uint8_t* src = in + static_cast<size_t>(y) * w * 4;
    int* d = &rows[static_cast<size_t>(y) * ow * 4];
    for (int x = 0; x < ow; x++) {
      const int s0 = xo[x] * 4, s1 = std::min(xo[x] + 1, w - 1) * 4;
      for (int c = 0; c < 4; c++) d[x * 4 + c] = src[s0 + c] * xa[x * 2] + src[s1 + c] * xa[x * 2 + 1];
    }
  }
  for (int y = 0; y < oh; y++) {
    const int* r0 = &rows[static_cast<size_t>(clampi(yo[y], 0, h - 1)) * ow * 4];
    const int* r1 = &rows[static_cast<size_t>(clampi(yo[y] + 1, 0, h - 1)) * ow * 4];
    const int b0 = ya[y * 2], b1 = ya[y * 2 + 1];
    uint8_t* o = out + static_cast<size_t>(y) * ow * 4;
    for (int i = 0; i < ow * 4; i++) {
      const int v = (((b0 * (r0[i] >> 4)) >> 16) + ((b1 * (r1[i] >> 4)) >> 16) + 2) >> 2;
      o[i] = static_cast<uint8_t>(clampi(v, 0, 255));
    }
  }
}

void resize_cubic(const uint8_t* in, int h, int w, int oh, int ow, uint8_t* out) {
  std::vector<int> xo, yo;
  std::vector<float> xc, yc;
  resize_tabs(w, ow, kCubic, true, xo, xc);
  resize_tabs(h, oh, kCubic, false, yo, yc);
  std::vector<float> rows(static_cast<size_t>(h) * ow * 4);
  for (int y = 0; y < h; y++) {
    const uint8_t* src = in + static_cast<size_t>(y) * w * 4;
    float* d = &rows[static_cast<size_t>(y) * ow * 4];
    for (int x = 0; x < ow; x++) {
      const float* a = &xc[static_cast<size_t>(x) * 4];
      int s[4];
      for (int k = 0; k < 4; k++) s[k] = clampi(xo[x] + k - 1, 0, w - 1) * 4;
      for (int c = 0; c < 4; c++) {
        float v = static_cast<float>(src[s[0] + c]) * a[0];
        v = v + static_cast<float>(src[s[1] + c]) * a[1];
        v = v + static_cast<float>(src[s[2] + c]) * a[2];
        d[x * 4 + c] = v + static_cast<float>(src[s[3] + c]) * a[3];
      }
    }
  }
  for (int y = 0; y < oh; y++) {
    const float* r[4];
    for (int k = 0; k < 4; k++) r[k] = &rows[static_cast<size_t>(clampi(yo[y] + k - 1, 0, h - 1)) * ow * 4];
    const float* b = &yc[static_cast<size_t>(y) * 4];
    uint8_t* o = out + static_cast<size_t>(y) * ow * 4;
    for (int i = 0; i < ow * 4; i++) {
      float v = r[0][i] * b[0];
      v = v + r[1][i] * b[1];
      v = v + r[2][i] * b[2];
      o[i] = sat_round(v + r[3][i] * b[3]);
    }
  }
}

// OpenCV's own CUBIC resize, which a source under 4 pixels on a side takes:
// 11-bit fixed-point horizontal taps, the vertical pass in float (fused, in
// 32-value vectors) with the integer form for the tail.
void resize_cubic_small(const uint8_t* in, int h, int w, int oh, int ow, uint8_t* out) {
  std::vector<int> xo, yo;
  std::vector<float> xc, yc;
  resize_tabs(w, ow, kCubic, true, xo, xc, false);
  resize_tabs(h, oh, kCubic, false, yo, yc, false);
  std::vector<short> xa(xc.size()), ya(yc.size());
  for (size_t i = 0; i < xc.size(); i++) xa[i] = sat_short(xc[i] * 2048.f);
  for (size_t i = 0; i < yc.size(); i++) ya[i] = sat_short(yc[i] * 2048.f);
  std::vector<int> rows(static_cast<size_t>(h) * ow * 4);
  for (int y = 0; y < h; y++) {
    const uint8_t* src = in + static_cast<size_t>(y) * w * 4;
    int* d = &rows[static_cast<size_t>(y) * ow * 4];
    for (int x = 0; x < ow; x++)
      for (int c = 0; c < 4; c++) {
        int v = 0;
        for (int k = 0; k < 4; k++) v += src[clampi(xo[x] + k - 1, 0, w - 1) * 4 + c] * xa[x * 4 + k];
        d[x * 4 + c] = v;
      }
  }
  const int n = ow * 4, vec_end = (n / 32) * 32;
  const float scale = 1.f / (2048 * 2048);
  for (int y = 0; y < oh; y++) {
    const int* r[4];
    for (int k = 0; k < 4; k++) r[k] = &rows[static_cast<size_t>(clampi(yo[y] + k - 1, 0, h - 1)) * n];
    const short* b = &ya[static_cast<size_t>(y) * 4];
    float bf[4];
    for (int k = 0; k < 4; k++) bf[k] = b[k] * scale;
    uint8_t* o = out + static_cast<size_t>(y) * n;
    for (int i = 0; i < n; i++) {
      if (i < vec_end) {
        float v = static_cast<float>(r[3][i]) * bf[3];
        v = std::fma(static_cast<float>(r[2][i]), bf[2], v);
        v = std::fma(static_cast<float>(r[1][i]), bf[1], v);
        o[i] = sat_round(std::fma(static_cast<float>(r[0][i]), bf[0], v));
      } else {
        const int v = (b[0] * r[0][i] + b[1] * r[1][i] + b[2] * r[2][i] + b[3] * r[3][i] + (1 << 21)) >> 22;
        o[i] = static_cast<uint8_t>(clampi(v, 0, 255));
      }
    }
  }
}

struct AreaTap {
  int d, s;
  float alpha;
};

std::vector<AreaTap> area_tab(int ssize, int dsize) {
  const double scale = static_cast<double>(ssize) / dsize;
  std::vector<AreaTap> tab;
  for (int dx = 0; dx < dsize; dx++) {
    const double fsx1 = dx * scale, fsx2 = fsx1 + scale;
    const double cell = std::min(scale, ssize - fsx1);
    int sx1 = static_cast<int>(std::ceil(fsx1)), sx2 = static_cast<int>(std::floor(fsx2));
    sx2 = std::min(sx2, ssize - 1);
    sx1 = std::min(sx1, sx2);
    if (sx1 - fsx1 > 1e-3) tab.push_back({dx, sx1 - 1, static_cast<float>((sx1 - fsx1) / cell)});
    for (int sx = sx1; sx < sx2; sx++) tab.push_back({dx, sx, static_cast<float>(1.0 / cell)});
    if (fsx2 - sx2 > 1e-3)
      tab.push_back({dx, sx2, static_cast<float>(std::min(std::min(fsx2 - sx2, 1.), cell) / cell)});
  }
  return tab;
}

void resize_area_down(const uint8_t* in, int h, int w, int oh, int ow, uint8_t* out) {
  const std::vector<AreaTap> xt = area_tab(w, ow), yt = area_tab(h, oh);
  const int n = ow * 4;
  std::vector<float> buf(n), sum(n, 0.f);
  int prev = yt[0].d;
  for (const AreaTap& ty : yt) {
    const uint8_t* s = in + static_cast<size_t>(ty.s) * w * 4;
    std::fill(buf.begin(), buf.end(), 0.f);
    for (const AreaTap& tx : xt)
      for (int c = 0; c < 4; c++) buf[tx.d * 4 + c] = buf[tx.d * 4 + c] + s[tx.s * 4 + c] * tx.alpha;
    if (ty.d != prev) {
      uint8_t* o = out + static_cast<size_t>(prev) * n;
      for (int i = 0; i < n; i++) {
        o[i] = sat_round(sum[i]);
        sum[i] = ty.alpha * buf[i];
      }
      prev = ty.d;
    } else {
      for (int i = 0; i < n; i++) sum[i] = sum[i] + ty.alpha * buf[i];
    }
  }
  uint8_t* o = out + static_cast<size_t>(prev) * n;
  for (int i = 0; i < n; i++) o[i] = sat_round(sum[i]);
}

void resize_area_fast(const uint8_t* in, int w, int oh, int ow, int sx, int sy,
                      uint8_t* out) {
  const float scale = 1.f / (sx * sy);
  for (int y = 0; y < oh; y++)
    for (int x = 0; x < ow; x++)
      for (int c = 0; c < 4; c++) {
        int sum = 0;
        for (int i = 0; i < sy; i++)
          for (int j = 0; j < sx; j++)
            sum += in[(static_cast<size_t>(y * sy + i) * w + x * sx + j) * 4 + c];
        uint8_t* o = out + (static_cast<size_t>(y) * ow + x) * 4 + c;
        *o = (sx == 2 && sy == 2) ? static_cast<uint8_t>((sum + 2) >> 2) : sat_round(sum * scale);
      }
}

inline int reflect101(int i, int n) {
  if (n == 1) return 0;
  while (i < 0 || i >= n) {
    if (i < 0) i = -i;
    if (i >= n) i = 2 * n - 2 - i;
  }
  return i;
}

}  // namespace

extern "C" {

// ImageFilter.GaussianBlur(radius) of an RGBA image, in place.
int ag_gaussian_blur(uint8_t* img, int h, int w, float radius) {
  if (h < 0 || w < 0) return 1;
  if (h == 0 || w == 0 || radius == 0.f) return 0;
  const float r = gaussian_blur_radius(radius, 3);
  if (r == 0.f) return 0;
  for (int i = 0; i < 3; i++) box_blur_pass(img, h, w, r, false);
  for (int i = 0; i < 3; i++) box_blur_pass(img, h, w, r, true);
  return 0;
}

// Image.transform((ow, oh), AFFINE, a, BICUBIC) of an RGBA image.
int ag_affine_bicubic(const uint8_t* in, int h, int w, const double* a, int oh, int ow,
                      uint8_t* out) {
  if (h < 0 || w < 0 || oh < 0 || ow < 0) return 1;   // an empty source fills with 0
  std::vector<uint8_t> pm(static_cast<size_t>(h) * w * 4);
  premultiply(in, static_cast<size_t>(h) * w, pm.data());
  for (int y = 0; y < oh; y++)
    for (int x = 0; x < ow; x++) {
      const double xin = x + 0.5, yin = y + 0.5;
      const double xx = a[0] * xin + a[1] * yin + a[2];
      const double yy = a[3] * xin + a[4] * yin + a[5];
      uint8_t* o = out + (static_cast<size_t>(y) * ow + x) * 4;
      if (!bicubic_filter32(o, pm.data(), h, w, xx, yy)) std::memset(o, 0, 4);
    }
  unpremultiply(out, static_cast<size_t>(oh) * ow);
  return 0;
}

// Image.blend(degenerate, image, alpha) over n bytes.
void ag_blend(const uint8_t* in1, const uint8_t* in2, size_t n, float alpha, uint8_t* out) {
  if (alpha == 0.0f) {
    std::memcpy(out, in1, n);
  } else if (alpha == 1.0f) {
    std::memcpy(out, in2, n);
  } else if (alpha >= 0 && alpha <= 1.0) {
    for (size_t i = 0; i < n; i++)
      out[i] = static_cast<uint8_t>(static_cast<int>(in1[i]) +
                                    alpha * (static_cast<int>(in2[i]) - static_cast<int>(in1[i])));
  } else {
    for (size_t i = 0; i < n; i++) {
      const float t = static_cast<float>(
          static_cast<int>(in1[i]) + alpha * (static_cast<int>(in2[i]) - static_cast<int>(in1[i])));
      out[i] = t <= 0.0f ? 0 : (t >= 255.0f ? 255 : static_cast<uint8_t>(t));
    }
  }
}

// convert("L") of n RGB(A) pixels `step` bytes apart.
void ag_rgb_to_l(const uint8_t* in, size_t n, int step, uint8_t* out) {
  for (size_t i = 0; i < n; i++, in += step)
    out[i] = static_cast<uint8_t>((in[0] * 19595 + in[1] * 38470 + in[2] * 7471 + 0x8000) >> 16);
}

// convert("HSV") of n RGB(A) pixels `step` bytes apart into [n, 3].
void ag_rgb_to_hsv(const uint8_t* in, size_t n, int step, uint8_t* out) {
  for (size_t i = 0; i < n; i++, in += step, out += 3) {
    const uint8_t r = in[0], g = in[1], b = in[2];
    const uint8_t maxc = std::max(r, std::max(g, b)), minc = std::min(r, std::min(g, b));
    uint8_t uh, us;
    if (minc == maxc) {
      uh = 0;
      us = 0;
    } else {
      float h, s, rc, gc, bc, cr;
      cr = static_cast<float>(maxc - minc);
      s = cr / static_cast<float>(maxc);
      rc = static_cast<float>(maxc - r) / cr;
      gc = static_cast<float>(maxc - g) / cr;
      bc = static_cast<float>(maxc - b) / cr;
      if (r == maxc) {
        h = bc - gc;
      } else if (g == maxc) {
        h = static_cast<float>(2.0 + rc - bc);
      } else {
        h = static_cast<float>(4.0 + gc - rc);
      }
      h = static_cast<float>(std::fmod((h / 6.0 + 1.0), 1.0));
      const int hi = static_cast<int>(h * 255.0), si = static_cast<int>(s * 255.0);
      uh = static_cast<uint8_t>(clampi(hi, 0, 255));
      us = static_cast<uint8_t>(clampi(si, 0, 255));
    }
    out[0] = uh;
    out[1] = us;
    out[2] = maxc;
  }
}

// convert("RGB") of n HSV pixels [n, 3] into [n, 3].
void ag_hsv_to_rgb(const uint8_t* in, size_t n, uint8_t* out) {
  for (size_t k = 0; k < n; k++, in += 3, out += 3) {
    const uint8_t h = in[0], s = in[1], v = in[2];
    if (s == 0) {
      out[0] = out[1] = out[2] = v;
      continue;
    }
    const int i = static_cast<int>(std::floor(static_cast<float>(h) * 6.0 / 255.0));
    const float f = static_cast<float>(static_cast<float>(h) * 6.0 / 255.0 - static_cast<float>(i));
    const float fs = static_cast<float>(static_cast<float>(s) / 255.0);
    const int p = static_cast<int>(std::round(static_cast<float>(v) * (1.0 - fs)));
    const int q = static_cast<int>(std::round(static_cast<float>(v) * (1.0 - fs * f)));
    const int t = static_cast<int>(std::round(static_cast<float>(v) * (1.0 - fs * (1.0 - f))));
    const uint8_t up = static_cast<uint8_t>(clampi(p, 0, 255));
    const uint8_t uq = static_cast<uint8_t>(clampi(q, 0, 255));
    const uint8_t ut = static_cast<uint8_t>(clampi(t, 0, 255));
    uint8_t r = 0, g = 0, b = 0;
    switch (i % 6) {
      case 0: r = v; g = ut; b = up; break;
      case 1: r = uq; g = v; b = up; break;
      case 2: r = up; g = v; b = ut; break;
      case 3: r = up; g = uq; b = v; break;
      case 4: r = ut; g = up; b = v; break;
      case 5: r = v; g = up; b = uq; break;
    }
    out[0] = r;
    out[1] = g;
    out[2] = b;
  }
}

// cv2.warpAffine (persp = 0, m 2x3) or cv2.warpPerspective (persp = 1, m
// 3x3) of an RGBA image to [oh, ow, 4], BORDER_REPLICATE; `minv` is the
// inverse (destination -> source) matrix in double.
int ag_warp(const uint8_t* in, int h, int w, const double* minv, int persp, int oh, int ow,
            int interp, uint8_t* out) {
  if (h < 1 || w < 1 || oh < 1 || ow < 1 || interp < kNearest || interp > kArea) return 1;
  if (interp == kArea) interp = kLinear;
  float m[9];
  for (int i = 0; i < (persp ? 9 : 6); i++) m[i] = static_cast<float>(minv[i]);
  const Px src{in, h, w};
  const int vec_end = (ow / kVec) * kVec;
  for (int y = 0; y < oh; y++)
    for (int x = 0; x < ow; x++) {
      float sx, sy;
      source_point(m, persp != 0, interp, x >= vec_end, x, y, &sx, &sy);
      sample(src, interp, sx, sy, out + (static_cast<size_t>(y) * ow + x) * 4);
    }
  return 0;
}

// cv2.warpAffine of a float64 [h, w] image to [oh, ow], INTER_LINEAR,
// BORDER_CONSTANT 0; `minv` is the inverse matrix.
int ag_warp_kernel_f64(const double* in, int h, int w, const double* minv, int oh, int ow,
                       double* out) {
  if (h < 1 || w < 1 || oh < 1 || ow < 1) return 1;
  constexpr int kAbScale = 1 << 10, kRoundDelta = kAbScale / 32 / 2;
  float tab[32][2];
  for (int i = 0; i < 32; i++) {
    const float t = static_cast<float>(i) / 32;
    tab[i][0] = 1.f - t;
    tab[i][1] = t;
  }
  for (int y = 0; y < oh; y++) {
    const int X0 = static_cast<int>(std::lrint((minv[1] * y + minv[2]) * kAbScale)) + kRoundDelta;
    const int Y0 = static_cast<int>(std::lrint((minv[4] * y + minv[5]) * kAbScale)) + kRoundDelta;
    for (int x = 0; x < ow; x++) {
      const int X = (X0 + static_cast<int>(std::lrint(minv[0] * x * kAbScale))) >> 5;
      const int Y = (Y0 + static_cast<int>(std::lrint(minv[3] * x * kAbScale))) >> 5;
      const int sx = X >> 5, sy = Y >> 5, fx = X & 31, fy = Y & 31;
      const float wt[4] = {tab[fy][0] * tab[fx][0], tab[fy][0] * tab[fx][1],
                           tab[fy][1] * tab[fx][0], tab[fy][1] * tab[fx][1]};
      double* o = out + static_cast<size_t>(y) * ow + x;
      if (sx >= w || sx + 1 < 0 || sy >= h || sy + 1 < 0) {
        *o = 0.0;
        continue;
      }
      auto v = [&](int yy, int xx) {
        return (yy >= 0 && yy < h && xx >= 0 && xx < w) ? in[static_cast<size_t>(yy) * w + xx] : 0.0;
      };
      *o = v(sy, sx) * wt[0] + v(sy, sx + 1) * wt[1] + v(sy + 1, sx) * wt[2] +
           v(sy + 1, sx + 1) * wt[3];
    }
  }
  return 0;
}

// cv2.resize of an RGBA image to [oh, ow, 4].
int ag_resize(const uint8_t* in, int h, int w, int oh, int ow, int interp, uint8_t* out) {
  if (h < 1 || w < 1 || oh < 1 || ow < 1 || interp < kNearest || interp > kArea) return 1;
  if (oh == h && ow == w) {
    std::memcpy(out, in, static_cast<size_t>(h) * w * 4);
    return 0;
  }
  if (interp == kNearest) {
    resize_nearest(in, h, w, oh, ow, out);
    return 0;
  }
  const double scale_x = 1. / (static_cast<double>(ow) / w);
  const double scale_y = 1. / (static_cast<double>(oh) / h);
  const int isx = static_cast<int>(std::lrint(scale_x)), isy = static_cast<int>(std::lrint(scale_y));
  const double eps = 2.220446049250313e-16;
  const bool fast = std::abs(scale_x - isx) < eps && std::abs(scale_y - isy) < eps;
  if (interp == kLinear && fast && isx == 2 && isy == 2) interp = kArea;
  if (interp == kArea && scale_x >= 1 && scale_y >= 1) {
    if (fast)
      resize_area_fast(in, w, oh, ow, isx, isy, out);
    else
      resize_area_down(in, h, w, oh, ow, out);
    return 0;
  }
  if (interp == kCubic && (h < 4 || w < 4))
    resize_cubic_small(in, h, w, oh, ow, out);
  else if (interp == kCubic)
    resize_cubic(in, h, w, oh, ow, out);
  else
    resize_linear(in, h, w, oh, ow, interp, out);
  return 0;
}

// cv2.pyrDown of an RGBA image to [(h + 1) / 2, (w + 1) / 2, 4].
int ag_pyr_down(const uint8_t* in, int h, int w, uint8_t* out) {
  if (h < 1 || w < 1) return 1;
  const int oh = (h + 1) / 2, ow = (w + 1) / 2;
  static const int k[5] = {1, 4, 6, 4, 1};
  std::vector<int> rows(static_cast<size_t>(h) * ow * 4, 0);
  for (int y = 0; y < h; y++)
    for (int x = 0; x < ow; x++)
      for (int t = 0; t < 5; t++) {
        const uint8_t* p = in + (static_cast<size_t>(y) * w + reflect101(2 * x - 2 + t, w)) * 4;
        for (int c = 0; c < 4; c++) rows[(static_cast<size_t>(y) * ow + x) * 4 + c] += k[t] * p[c];
      }
  for (int y = 0; y < oh; y++)
    for (int i = 0; i < ow * 4; i++) {
      int s = 0;
      for (int t = 0; t < 5; t++) s += k[t] * rows[static_cast<size_t>(reflect101(2 * y - 2 + t, h)) * ow * 4 + i];
      out[static_cast<size_t>(y) * ow * 4 + i] = static_cast<uint8_t>((s + 128) >> 8);
    }
  return 0;
}

// cv2.filter2D(img, -1, k) of an RGBA image, k float64 [kh, kw] (anchor at
// its centre, delta 0, BORDER_REFLECT_101).
int ag_filter2d(const uint8_t* in, int h, int w, const double* kernel, int kh, int kw,
                uint8_t* out) {
  if (h < 1 || w < 1 || kh < 1 || kw < 1) return 1;
  struct Tap {
    int dy, dx;
    float f;
  };
  std::vector<Tap> taps;
  for (int i = 0; i < kh; i++)
    for (int j = 0; j < kw; j++) {
      const float f = static_cast<float>(kernel[i * kw + j]);
      if (f != 0.f) taps.push_back({i - kh / 2, j - kw / 2, f});
    }
  for (int y = 0; y < h; y++)
    for (int x = 0; x < w; x++)
      for (int c = 0; c < 4; c++) {
        float s = 0.f;
        for (const Tap& t : taps)
          s = std::fma(t.f, static_cast<float>(in[(static_cast<size_t>(reflect101(y + t.dy, h)) * w +
                                                   reflect101(x + t.dx, w)) * 4 + c]), s);
        out[(static_cast<size_t>(y) * w + x) * 4 + c] = sat_round(s);
      }
  return 0;
}

}  // extern "C"
