// Host TIFF decoder of the PyTorch port: the strips or tiles of a TIFF in,
// the stored samples out, bit for bit what libtiff 4.7 hands Pillow and
// cv2, without either.  The caller (data/image.py) reads the IFD, reverses
// the bits of FillOrder 2 chunks, inflates Deflate and LZMA chunks and
// decodes JPEG ones, and hands every chunk over with the method that is
// left: none, PackBits or LZW.
//
// - PackBits (tif_packbits.c): repeat and literal runs, -128 a no-op; a
//   run past the chunk's end is cut to it.
// - LZW (tif_lzw.c): libtiff's MSB-first codes, the width growing one code
//   before the table fills (the "early change"), and the old-style
//   LSB-first codes (a chunk whose first byte is 0 and whose second has
//   bit 0 set) without it; Clear and EOI, KwKwK.
// - The horizontal predictor (tif_predict.c) at 8 and 16 bits, row by row
//   over the chunk, on values in the file's byte order.
// - Samples of 1, 2, 4, 8 or 16 bits (MSB first, rows padded to a byte),
//   chunky or planar, strips or tiles; a tile's rows and columns past the
//   image are dropped.
//
// Errors: 1 = a chunk that does not decode to its full size (libtiff's
// "Not enough data"), a bad LZW code; the message goes to `err`.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

constexpr int kCorrupt = 1;
constexpr int kNone = 1, kLzw = 5, kPackBits = 32773;

struct Fail {
  int code;
  std::string msg;
};

[[noreturn]] void corrupt(const std::string& m) { throw Fail{kCorrupt, m}; }

// ------------------------------------------------------------- PackBits
void packbits(const uint8_t* in, size_t n, uint8_t* out, size_t want) {
  size_t o = 0, i = 0;
  while (i < n && o < want) {
    int c = static_cast<int8_t>(in[i++]);
    if (c < 0) {
      if (c == -128) continue;
      size_t run = static_cast<size_t>(1 - c);
      if (run > want - o) run = want - o;
      if (i >= n) break;
      std::memset(out + o, in[i++], run);
      o += run;
    } else {
      size_t run = static_cast<size_t>(c) + 1;
      if (run > want - o) run = want - o;
      if (n - i < run) break;
      std::memcpy(out + o, in + i, run);
      o += run;
      i += run;
    }
  }
  if (o < want) corrupt("not enough PackBits data");
}

// ------------------------------------------------------------------ LZW
struct LzwEntry {
  int prefix;      // the code this one extends, -1 for a root
  uint8_t value;   // its last byte
  uint8_t first;   // its first byte
  int length;      // 0 = undefined
};

void lzw(const uint8_t* in, size_t n, uint8_t* out, size_t want) {
  const bool compat = n >= 2 && in[0] == 0 && (in[1] & 1);
  std::vector<LzwEntry> tab(4096 + 1024);
  for (int i = 0; i < 256; i++) tab[i] = {-1, static_cast<uint8_t>(i), static_cast<uint8_t>(i), 1};
  size_t bitpos = 0;
  const size_t nbits_total = n * 8;
  auto next = [&](int width) -> int {
    if (bitpos + width > nbits_total) return -1;
    int code = 0;
    if (compat) {
      for (int b = 0; b < width; b++, bitpos++)
        code |= ((in[bitpos >> 3] >> (bitpos & 7)) & 1) << b;
    } else {
      for (int b = 0; b < width; b++, bitpos++)
        code = (code << 1) | ((in[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
    }
    return code;
  };
  // the width grows once the table holds (1 << width) - 1 entries (MSB) or
  // 1 << width (compat)
  const int early = compat ? 0 : 1;
  int width = 9, free_ent = 258, old = -1;
  size_t o = 0;
  std::vector<uint8_t> stack;
  while (o < want) {
    const int code = next(width);
    if (code < 0) break;
    if (code == 257) break;
    if (code == 256) {
      width = 9;
      free_ent = 258;
      for (int i = 258; i < static_cast<int>(tab.size()); i++) tab[i].length = 0;
      int c = next(width);
      if (c < 0 || c == 257) break;
      if (c > 256) corrupt("corrupted LZW table");
      if (c == 256) {  // repeated Clear
        old = -1;
        continue;
      }
      out[o++] = static_cast<uint8_t>(c);
      old = c;
      continue;
    }
    if (old < 0) corrupt("LZW data without a leading Clear code");
    if (code > free_ent || code == 256 || code == 257) corrupt("corrupted LZW table");
    if (free_ent >= static_cast<int>(tab.size())) corrupt("LZW table overflow");
    LzwEntry& e = tab[free_ent];
    e.prefix = old;
    e.first = tab[old].first;
    e.length = tab[old].length + 1;
    e.value = code < free_ent ? tab[code].first : tab[old].first;
    free_ent++;
    if (free_ent >= (1 << width) - early && width < 12) width++;
    if (tab[code].length == 0) corrupt("LZW code without a string");
    stack.clear();
    for (int c = code; c >= 0; c = tab[c].prefix) stack.push_back(tab[c].value);
    for (size_t k = stack.size(); k-- > 0 && o < want;) out[o++] = stack[k];
    old = code;
  }
  if (o < want) corrupt("not enough LZW data");
}

// ------------------------------------------------------------- layout
struct Layout {
  int width, height, spp, bps, planar, tiled, cw, ch, big_endian, predictor;
  int ow, oh;  // the output: the image, or the whole tiles (libtiff's buffers) for cv2's view
};

// bytes of one row of a chunk `w` pixels wide holding `samples` samples a pixel
inline size_t row_bytes(int w, int samples, int bps) {
  return (static_cast<size_t>(w) * samples * bps + 7) / 8;
}

inline unsigned sample_at(const uint8_t* row, size_t i, int bps, bool big) {
  switch (bps) {
    case 16:
      return big ? (row[2 * i] << 8) | row[2 * i + 1] : row[2 * i] | (row[2 * i + 1] << 8);
    case 8:
      return row[i];
    default: {
      const size_t bit = i * bps;
      return (row[bit >> 3] >> (8 - bps - (bit & 7))) & ((1u << bps) - 1);
    }
  }
}

// tif_predict.c's horizontal accumulation over one decoded chunk
void undo_predictor(uint8_t* buf, size_t rows, size_t rb, int stride, int bps, bool big) {
  for (size_t r = 0; r < rows; r++) {
    uint8_t* row = buf + r * rb;
    if (bps == 8) {
      for (size_t i = stride; i < rb; i++) row[i] = static_cast<uint8_t>(row[i] + row[i - stride]);
    } else {
      const size_t n = rb / 2;
      for (size_t i = stride; i < n; i++) {
        const unsigned v = (sample_at(row, i, 16, big) + sample_at(row, i - stride, 16, big)) &
                           0xFFFF;
        row[2 * i + (big ? 0 : 1)] = static_cast<uint8_t>(v >> 8);
        row[2 * i + (big ? 1 : 0)] = static_cast<uint8_t>(v);
      }
    }
  }
}

void decode(const uint8_t* data, const int64_t* offs, const int64_t* lens, int nchunks,
            int method, const Layout& L, uint16_t* out) {
  const int chunk_samples = L.planar == 2 ? 1 : L.spp;
  const int planes = L.planar == 2 ? L.spp : 1;
  const int across = (L.width + L.cw - 1) / L.cw;
  const int down = (L.height + L.ch - 1) / L.ch;
  const int per_plane = across * down;
  if (nchunks < per_plane * planes) corrupt("fewer TIFF strips or tiles than the image needs");
  if (L.predictor == 2 && L.bps != 8 && L.bps != 16)
    corrupt("horizontal predictor at " + std::to_string(L.bps) + " bits");
  const size_t rb = row_bytes(L.cw, chunk_samples, L.bps);
  std::vector<uint8_t> buf;
  for (int p = 0; p < planes; p++) {
    for (int k = 0; k < per_plane; k++) {
      const int idx = p * per_plane + k;
      const int x0 = (k % across) * L.cw, y0 = (k / across) * L.ch;
      // a strip holds the rows left; a tile is always whole
      const int rows = L.tiled ? L.ch : std::min(L.ch, L.height - y0);
      const size_t want = rb * rows;
      const uint8_t* src = data + offs[idx];
      const size_t n = static_cast<size_t>(lens[idx]);
      buf.assign(want, 0);
      if (method == kNone) {
        if (n < want) corrupt("not enough TIFF image data");
        std::memcpy(buf.data(), src, want);
      } else if (method == kPackBits) {
        packbits(src, n, buf.data(), want);
      } else if (method == kLzw) {
        lzw(src, n, buf.data(), want);
      } else {
        corrupt("TIFF compression " + std::to_string(method));
      }
      if (L.predictor == 2)
        undo_predictor(buf.data(), rows, rb, chunk_samples, L.bps, L.big_endian);
      const int w = std::min(L.cw, L.ow - x0), h = std::min(rows, L.oh - y0);
      for (int y = 0; y < h; y++) {
        const uint8_t* row = buf.data() + static_cast<size_t>(y) * rb;
        uint16_t* o = out + (static_cast<size_t>(y0 + y) * L.ow + x0) * L.spp;
        // chunky: every sample of the row in turn; planar: plane p's
        for (size_t i = 0; i < static_cast<size_t>(w) * chunk_samples; i++) {
          const size_t at = L.planar == 2 ? i * L.spp + p : i;
          o[at] = static_cast<uint16_t>(sample_at(row, i, L.bps, L.big_endian));
        }
      }
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

// Decodes the image's chunks (data + offs[i], lens[i] bytes each, in the
// file's order: every chunk of plane 0, then plane 1, ...) by `method`
// (1 none, 32773 PackBits, 5 LZW) into the samples out [oh, ow, spp]:
// the image (ow = width, oh = height) or its whole tiles (ow, oh the
// multiples of the tile size that hold it).  Strips are chunks cw = width
// pixels wide and ch = RowsPerStrip rows high (the last one shorter);
// tiles are cw x ch.
int tf_decode(const uint8_t* data, const int64_t* offs, const int64_t* lens, int nchunks,
              int method, int width, int height, int spp, int bps, int planar, int tiled, int cw,
              int ch, int big_endian, int predictor, int ow, int oh, uint16_t* out, char* err,
              int errlen) {
  return guarded(err, errlen, [&] {
    const Layout L{width, height, spp, bps, planar, tiled, cw, ch, big_endian, predictor, ow, oh};
    decode(data, offs, lens, nchunks, method, L, out);
  });
}

}  // extern "C"
