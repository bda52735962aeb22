// Host Zstandard decoder of the PyTorch port (RFC 8878), for the ZSTD
// strips and tiles of a TIFF (compression 50000) as libtiff 4.7's
// tif_zstd.c decodes them with libzstd: ZSTD_decompressStream until the
// chunk's decoded size is reached or a frame ends, without a dictionary.
//
// - Frames: the header (window, dictionary ID, content size, checksum
//   flag); the first frame only, a skippable one decoding to nothing (the
//   chunk then fails, as libtiff's loop ends with its frame); a frame that
//   names a dictionary fails, as libzstd without one does.
// - Blocks: raw, RLE and compressed; a compressed block's literals (raw,
//   RLE, Huffman with 1 or 4 streams, treeless reusing the last table;
//   the table's weights direct or FSE-coded) and sequences (predefined,
//   RLE, FSE and repeat modes, the three repeat offsets), copied through
//   the frame's history.
// - XXH64 of the content where the frame carries a checksum, checked when
//   the frame ends.
// - libzstd 1.5.7's rules where a frame is damaged: its fast four-stream
//   Huffman loop, which reads a stream on past where its bits end (or
//   leaves bits unread) and checks only where each stream stands when the
//   loop ends (HufStreams4); its tree checks (HUF_readStats); its block
//   buffer of the content size when streaming; no data after a block's
//   empty sequences.  Not modelled: a sequences bitstream read past its
//   start, which libzstd decodes from its wrapped bit container.
//
// Errors: 1 with the message in `err` (corrupt data, a frame too short for
// the chunk, a dictionary).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

constexpr int kCorrupt = 1;

struct Fail {
  std::string msg;
};

[[noreturn]] void corrupt(const std::string& m) { throw Fail{m}; }

inline uint32_t rd16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t rd24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }
inline uint32_t rd32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<uint32_t>(p[3]) << 24);
}
inline uint64_t rd64(const uint8_t* p) {
  return rd32(p) | (static_cast<uint64_t>(rd32(p + 4)) << 32);
}
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ------------------------------------------------------------------ XXH64
constexpr uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
                   P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
                   P5 = 2870177450012600261ull;
inline uint64_t rotl(uint64_t v, int r) { return (v << r) | (v >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xmerge(uint64_t acc, uint64_t v) { return (acc ^ xround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += n;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (static_cast<uint64_t>(rd32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; p++) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ------------------------------------------------------------ bit readers
// forward, least significant bit first (FSE table descriptions)
struct FwdBits {
  const uint8_t* p;
  size_t n, pos = 0;  // pos in bits
  uint32_t peek(int k) const {
    uint32_t v = 0;
    for (int i = 0; i < k; i++) {
      const size_t b = pos + i;
      if ((b >> 3) < n) v |= ((p[b >> 3] >> (b & 7)) & 1u) << i;
    }
    return v;
  }
  uint32_t read(int k) {
    const uint32_t v = peek(k);
    pos += k;
    return v;
  }
};

// backward: the stream read from its end, past the last byte's top set
// bit; bits before the start read as zeros, and `left` goes negative
struct BackBits {
  const uint8_t* p;
  int64_t left;  // bits not yet read
  BackBits(const uint8_t* data, size_t n) : p(data) {
    if (n == 0 || data[n - 1] == 0) corrupt("zstd bitstream without its end mark");
    left = static_cast<int64_t>(n) * 8 - (8 - highbit(data[n - 1]));
  }
  uint64_t read(int k) {
    uint64_t v = 0;
    for (int i = 0; i < k; i++) {
      const int64_t b = left - 1 - i;
      v = (v << 1) | (b >= 0 ? ((p[b >> 3] >> (b & 7)) & 1u) : 0u);
    }
    left -= k;
    return v;
  }
  uint64_t peek(int k) const {
    BackBits c = *this;
    return c.read(k);
  }
};

// -------------------------------------------------------------------- FSE
struct FseEntry {
  uint16_t symbol;
  uint8_t nb_bits;
  uint16_t base;  // the next state's baseline
};

struct Fse {
  int log = 0;
  std::vector<FseEntry> t;
};

void fse_build(Fse& f, const std::vector<int>& norm, int log) {
  const int size = 1 << log;
  f.log = log;
  f.t.assign(size, {0, 0, 0});
  std::vector<uint32_t> next(norm.size());
  int high = size - 1;
  for (size_t s = 0; s < norm.size(); s++) {
    if (norm[s] == -1) {
      f.t[high--].symbol = static_cast<uint16_t>(s);
      next[s] = 1;
    } else {
      next[s] = static_cast<uint32_t>(norm[s]);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (size_t s = 0; s < norm.size(); s++) {
    for (int i = 0; i < norm[s]; i++) {
      f.t[pos].symbol = static_cast<uint16_t>(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  if (pos != 0) corrupt("zstd FSE table does not fill");
  for (int i = 0; i < size; i++) {
    const uint16_t s = f.t[i].symbol;
    const uint32_t x = next[s]++;
    const int nb = log - highbit(x);
    f.t[i].nb_bits = static_cast<uint8_t>(nb);
    f.t[i].base = static_cast<uint16_t>((x << nb) - size);
  }
}

// an FSE table description (RFC 8878 4.1.1); returns the bytes it takes
size_t fse_read(Fse& f, const uint8_t* p, size_t n, int max_log, int max_symbol) {
  FwdBits br{p, n};
  const int log = static_cast<int>(br.read(4)) + 5;
  if (log > max_log) corrupt("zstd FSE accuracy log too large");
  int remaining = (1 << log) + 1, threshold = 1 << log, nb = log + 1;
  std::vector<int> norm;
  while (remaining > 1) {
    if (static_cast<int>(norm.size()) > max_symbol) corrupt("zstd FSE table of too many symbols");
    const int max = (2 * threshold - 1) - remaining;
    const uint32_t peek = br.peek(nb);
    int count;
    if (static_cast<int>(peek & (threshold - 1)) < max) {
      count = static_cast<int>(peek & (threshold - 1));
      br.pos += nb - 1;
    } else {
      count = static_cast<int>(peek & (2 * threshold - 1));
      if (count >= threshold) count -= max;
      br.pos += nb;
    }
    count--;
    remaining -= count < 0 ? -count : count;
    norm.push_back(count);
    if (count == 0) {
      for (;;) {
        const int r = static_cast<int>(br.read(2));
        for (int i = 0; i < r; i++) norm.push_back(0);
        if (r != 3) break;
      }
    }
    while (remaining < threshold && threshold > 1) {
      nb--;
      threshold >>= 1;
    }
  }
  if (remaining != 1 || static_cast<int>(norm.size()) > max_symbol + 1)
    corrupt("zstd FSE table description is corrupt");
  const size_t used = (br.pos + 7) / 8;
  if (used > n) corrupt("zstd FSE table description past its data");
  fse_build(f, norm, log);
  return used;
}

void fse_rle(Fse& f, uint8_t symbol) {
  f.log = 0;
  f.t.assign(1, {symbol, 0, 0});
}

// ---------------------------------------------------------------- Huffman
struct Huf {
  int max_bits = 0;
  std::vector<uint8_t> sym, nbits;  // 1 << max_bits entries
  bool ready = false;
};

void huf_build(Huf& h, std::vector<int> w) {
  // HUF_readStats: weights and codes up to HUF_TABLELOG_MAX (12) bits
  uint32_t total = 0;
  for (int v : w) {
    if (v > 12) corrupt("zstd Huffman weight too large");
    if (v) total += 1u << (v - 1);
  }
  if (total == 0) corrupt("zstd Huffman weights all zero");
  const int max_bits = highbit(total) + 1;
  if (max_bits > 12) corrupt("zstd Huffman code too long");
  const uint32_t left = (1u << max_bits) - total;
  if (left & (left - 1)) corrupt("zstd Huffman weights do not sum to a power of two");
  w.push_back(highbit(left) + 1);
  // a tree has an even number of longest codes (weight 1), two at least
  const auto ones = std::count(w.begin(), w.end(), 1);
  if (ones < 2 || ones % 2) corrupt("zstd Huffman weights of no tree");
  h.max_bits = max_bits;
  h.sym.assign(1u << max_bits, 0);
  h.nbits.assign(1u << max_bits, 0);
  uint32_t pos = 0;
  for (int weight = 1; weight <= max_bits; weight++) {
    for (size_t s = 0; s < w.size(); s++) {
      if (w[s] != weight) continue;
      const uint32_t len = 1u << (weight - 1);
      for (uint32_t i = 0; i < len; i++) {
        h.sym[pos + i] = static_cast<uint8_t>(s);
        h.nbits[pos + i] = static_cast<uint8_t>(max_bits + 1 - weight);
      }
      pos += len;
    }
  }
  h.ready = true;
}

// a Huffman tree description; returns the bytes it takes
size_t huf_read(Huf& h, const uint8_t* p, size_t n) {
  if (n < 1) corrupt("zstd Huffman tree past its data");
  const int head = p[0];
  std::vector<int> w;
  if (head >= 128) {
    const int count = head - 127;
    const size_t bytes = (count + 1) / 2;
    if (1 + bytes > n) corrupt("zstd Huffman weights past their data");
    for (int i = 0; i < count; i++) w.push_back(i % 2 ? p[1 + i / 2] & 15 : p[1 + i / 2] >> 4);
    huf_build(h, w);
    return 1 + bytes;
  }
  if (static_cast<size_t>(1 + head) > n || head == 0)
    corrupt("zstd Huffman weights past their data");
  Fse f;
  const size_t desc = fse_read(f, p + 1, head, 6, 255);
  if (desc >= static_cast<size_t>(head)) corrupt("zstd Huffman weights without a bitstream");
  BackBits br(p + 1 + desc, head - desc);
  uint32_t s1 = static_cast<uint32_t>(br.read(f.log)), s2 = static_cast<uint32_t>(br.read(f.log));
  // two interleaved states, to the bitstream's overflow (FSE_decompress_usingDTable)
  for (;;) {
    if (w.size() > 253) corrupt("zstd Huffman of too many weights");
    w.push_back(f.t[s1].symbol);
    s1 = f.t[s1].base + static_cast<uint32_t>(br.read(f.t[s1].nb_bits));
    if (br.left < 0) {
      w.push_back(f.t[s2].symbol);
      break;
    }
    if (w.size() > 253) corrupt("zstd Huffman of too many weights");
    w.push_back(f.t[s2].symbol);
    s2 = f.t[s2].base + static_cast<uint32_t>(br.read(f.t[s2].nb_bits));
    if (br.left < 0) {
      w.push_back(f.t[s1].symbol);
      break;
    }
  }
  huf_build(h, w);
  return 1 + head;
}

void huf_stream(const Huf& h, const uint8_t* p, size_t n, uint8_t* out, size_t count) {
  BackBits br(p, n);
  for (size_t i = 0; i < count; i++) {
    const uint32_t v = static_cast<uint32_t>(br.peek(h.max_bits));
    out[i] = h.sym[v];
    br.left -= h.nbits[v];
  }
  if (br.left != 0) corrupt("zstd Huffman stream does not end where its literals do");
}

// HUF_selectDecoder: whether libzstd decodes four streams with a table of
// two symbols an entry (X2) or one (X1), by its timing model
bool select_x2(size_t regen, size_t csize) {
  static const uint32_t kTime[16][2][2] = {
      {{0, 0}, {1, 1}},          {{0, 0}, {1, 1}},          {{150, 216}, {381, 119}},
      {{170, 205}, {514, 112}},  {{177, 199}, {539, 110}},  {{197, 194}, {644, 107}},
      {{221, 192}, {735, 107}},  {{256, 189}, {881, 106}},  {{359, 188}, {1167, 109}},
      {{582, 187}, {1570, 114}}, {{688, 187}, {1712, 122}}, {{825, 186}, {1965, 136}},
      {{976, 185}, {2131, 150}}, {{1180, 186}, {2070, 175}}, {{1377, 185}, {1731, 202}},
      {{1412, 185}, {1695, 202}}};
  const uint32_t q = csize >= regen ? 15 : static_cast<uint32_t>(csize * 16 / regen);
  const uint32_t d256 = static_cast<uint32_t>(regen >> 8);
  const uint32_t t0 = kTime[q][0][0] + kTime[q][0][1] * d256;
  uint32_t t1 = kTime[q][1][0] + kTime[q][1][1] * d256;
  t1 += t1 >> 5;
  return t1 < t0;
}

// Four Huffman streams after their jump table q[0:6] (q[0:n] the
// streams' section), into out[0:regen].  Where every stream holds 8 bytes
// or more, libzstd takes its fast loop (HUF_decompress4X*_usingDTable_
// internal_fast), which checks only where each stream stopped reading
// when the loop ended, not where its bits end: a stream may leave bits
// unread, or read on into the bytes before it (the stream before, the
// jump table) and decode what those bits say.  Each iteration makes 5
// table lookups a stream (one symbol each, or up to two with the X2
// table), in rounds sized so that stream 0 stays above the section's start
// and every stream within its output; a round does not start where a
// stream's read position has passed the one before it.  A stream then
// more than 8 bytes before its start fails the block; the rest of each
// segment is decoded from where it stands through libzstd's bit reader
// (HUF_decodeStreamX1 / X2, BIT_reloadDStream), which at the section's
// start stops loading and reads its 64-bit container round again.
class HufStreams4 {
 public:
  HufStreams4(const Huf& h, bool x2, const uint8_t* q, size_t n) : h(h), x2(x2), q(q), n(n) {}

  void decode(uint8_t* out, size_t regen) {
    if (n < 10) corrupt("zstd Huffman jump table past its data");
    if (regen < 6) corrupt("zstd literals too few for four streams");
    const size_t s1 = rd16(q), s2 = rd16(q + 2), s3 = rd16(q + 4);
    if (6 + s1 + s2 + s3 > n) corrupt("zstd Huffman streams past their data");
    const size_t len[4] = {s1, s2, s3, n - 6 - s1 - s2 - s3}, seg = (regen + 3) / 4;
    if (3 * seg > regen) corrupt("zstd Huffman streams longer than their literals");
    const size_t count[4] = {seg, seg, seg, regen - 3 * seg};
    const size_t start[5] = {6, 6 + s1, 6 + s1 + s2, 6 + s1 + s2 + s3, n};
    if (!(len[0] >= 8 && len[1] >= 8 && len[2] >= 8 && len[3] >= 8 && count[3] > 0 &&
          h.max_bits <= 11)) {  // libzstd's fast loop reads 11-bit tables only
      for (int i = 0; i < 4; i++) huf_stream(h, q + start[i], len[i], out + i * seg, count[i]);
      return;
    }
    // the fast loop: stream i has consumed t[i] bits from the top of its
    // last byte (its end mark's padding first) and written j[i] symbols
    int64_t t[4];
    size_t j[4] = {0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
      const uint8_t last = q[start[i + 1] - 1];
      t[i] = last ? 8 - highbit(last) : 0;
    }
    auto ip = [&](int i) { return static_cast<int64_t>(start[i + 1]) - 8 - t[i] / 8; };
    auto lookup = [&](int i) {  // one table entry: its symbols out, its bits consumed
      const uint32_t v = window(static_cast<int64_t>(start[i + 1]) * 8 - t[i]);
      uint8_t* o = out + i * seg + j[i];
      t[i] += entry(v, o, j[i] + 1 < count[i], &j[i]);
    };
    for (;;) {
      size_t iters = static_cast<size_t>(ip(0) / 7);
      for (int i = x2 ? 0 : 3; i < 4; i++)  // X1's streams advance alike: stream 3 is the shortest
        iters = std::min(iters, (count[i] - j[i]) / (x2 ? 10 : 5));
      if (iters == 0) break;
      if (ip(1) < ip(0) || ip(2) < ip(1) || ip(3) < ip(2)) break;
      const size_t olimit = j[3] + 5 * iters;
      do {
        for (int i = 0; i < 4; i++)
          for (int r = 0; r < 5; r++) lookup(i);
      } while (j[3] < olimit);
    }
    for (int i = 0; i < 4; i++)
      if (ip(i) < static_cast<int64_t>(start[i]) - 8)
        corrupt("zstd Huffman stream read past its start");
    for (int i = 0; i < 4; i++) tail(ip(i), static_cast<int>(t[i] % 8), out + i * seg + j[i],
                                     count[i] - j[i]);
  }

 private:
  const Huf& h;
  const bool x2;
  const uint8_t* const q;
  const size_t n;

  // 11 bits of the section ending at bit `top` (exclusive), MSB first
  uint32_t window(int64_t top) const {
    uint32_t v = 0;
    for (int b = 1; b <= 11; b++) {
      const int64_t bit = top - b;
      v = (v << 1) | (bit >= 0 ? ((q[bit >> 3] >> (bit & 7)) & 1u) : 0u);
    }
    return v;
  }
  int code(uint32_t v11, uint8_t* sym) const {
    const uint32_t v = v11 >> (11 - h.max_bits);
    *sym = h.sym[v];
    return h.nbits[v];
  }
  // a table entry for the 11-bit window v: its first symbol, and with X2
  // the next one where both codes fit the window and `room` allows;
  // returns the bits it takes, adding the symbols written to *j
  int entry(uint32_t v, uint8_t* o, bool room, size_t* j) const {
    const int l1 = code(v, o);
    *j += 1;
    if (!x2 || !room) return l1;
    uint8_t s2;
    const int l2 = code((v << l1) & 0x7FF, &s2);
    if (l1 + l2 > 11) return l1;
    o[1] = s2;
    *j += 1;
    return l1 + l2;
  }
  uint64_t read64(int64_t at) const {
    uint64_t v = 0;
    for (int k = 7; k >= 0; k--) v = (v << 8) | q[at + k];
    return v;
  }
  // HUF_decodeStreamX1 / X2 from a fast-loop state: the container loaded
  // at byte `ptr` with `c` bits consumed; `left` symbols to write
  void tail(int64_t ptr, int c, uint8_t* o, size_t left) const {
    uint64_t box = read64(ptr);
    enum Status { kUnfinished, kEnd, kOverflow };
    auto reload = [&]() -> Status {
      if (c > 64) return kOverflow;
      if (ptr >= 8) {
        ptr -= c >> 3;
        c &= 7;
        box = read64(ptr);
        return kUnfinished;
      }
      if (ptr == 0) return kEnd;
      int64_t nb = c >> 3;
      Status status = kUnfinished;
      if (ptr - nb < 0) {
        nb = ptr;
        status = kEnd;
      }
      ptr -= nb;
      c -= static_cast<int>(nb) * 8;
      box = read64(ptr);
      return status;
    };
    auto look = [&]() { return static_cast<uint32_t>((box << (c & 63)) >> 53); };
    size_t p = 0;
    const int64_t end = static_cast<int64_t>(left);  // pEnd, signed as the pointers are
    if (!x2) {
      auto one = [&]() {
        c += code(look(), o + p);
        p++;
      };
      if (left > 3) {
        for (;;) {
          const bool more = reload() == kUnfinished;
          if (!(more && static_cast<int64_t>(p) < end - 3)) break;
          for (int k = 0; k < 4; k++) one();
        }
      } else {
        reload();
      }
      while (p < left) one();
      return;
    }
    uint8_t pair[2];
    auto two = [&]() {  // HUF_decodeSymbolX2: both bytes written, 1 or 2 kept
      size_t got = 0;
      c += entry(look(), pair, true, &got);
      o[p] = pair[0];
      if (got == 2) o[p + 1] = pair[1];
      p += got;
    };
    if (left >= 8) {
      for (;;) {
        const bool more = reload() == kUnfinished;
        if (!(more && static_cast<int64_t>(p) < end - 9)) break;
        for (int k = 0; k < 5; k++) two();
      }
    } else {
      reload();
    }
    if (left - p >= 2) {
      for (;;) {
        const bool more = reload() == kUnfinished;
        if (!(more && static_cast<int64_t>(p) <= end - 2)) break;
        two();
      }
      while (static_cast<int64_t>(p) <= end - 2) two();
    }
    if (p < left) code(look(), o + p);  // HUF_decodeLastSymbolX2: its first symbol
  }
};

// -------------------------------------------------------------- sequences
const int kLLBase[36] = {0,  1,  2,  3,  4,  5,   6,   7,   8,   9,    10,   11,
                         12, 13, 14, 15, 16, 18,  20,  22,  24,  28,   32,   40,
                         48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const int kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                         1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int kMLBase[53] = {3,   4,   5,   6,    7,    8,    9,    10,    11,    12,    13,
                         14,  15,  16,  17,   18,   19,   20,   21,    22,    23,    24,
                         25,  26,  27,  28,   29,   30,   31,   32,    33,    34,    35,
                         37,  39,  41,  43,   47,   51,   59,   67,    83,    99,    131,
                         259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const int kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,
                         0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1,  1,  1,  1,
                         2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const std::vector<int> kLLNorm = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                  2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const std::vector<int> kMLNorm = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                  1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                  1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const std::vector<int> kOFNorm = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                  1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

// a frame's state across its blocks
struct Frame {
  std::vector<uint8_t> out;  // everything the frame has decoded
  Huf huf;
  bool huf_x2 = false;  // the Huffman table's kind in libzstd (treeless literals reuse it)
  Fse ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint32_t rep[3] = {1, 4, 8};
  size_t window = 0;
};

size_t read_table(Fse& f, bool& have, int mode, const uint8_t* p, size_t n,
                  const std::vector<int>& predefined, int predefined_log, int max_log,
                  int max_symbol) {
  switch (mode) {
    case 0:
      fse_build(f, predefined, predefined_log);
      have = true;
      return 0;
    case 1:
      if (n < 1) corrupt("zstd RLE table past its data");
      if (p[0] > max_symbol) corrupt("zstd RLE symbol out of range");
      fse_rle(f, p[0]);
      have = true;
      return 1;
    case 2: {
      const size_t used = fse_read(f, p, n, max_log, max_symbol);
      have = true;
      return used;
    }
    default:
      if (!have) corrupt("zstd repeat table without a table before it");
      return 0;
  }
}

void compressed_block(Frame& fr, const uint8_t* p, size_t n) {
  // ---- literals
  if (n < 1) corrupt("zstd block without literals");
  const int ltype = p[0] & 3, sfmt = (p[0] >> 2) & 3;
  size_t regen = 0, csize = 0, head = 0;
  int streams = 1;
  if (ltype < 2) {
    if ((sfmt & 1) == 0) {
      regen = p[0] >> 3;
      head = 1;
    } else if (sfmt == 1) {
      if (n < 2) corrupt("zstd literals header past its data");
      regen = (p[0] >> 4) + (p[1] << 4);
      head = 2;
    } else {
      if (n < 3) corrupt("zstd literals header past its data");
      regen = (p[0] >> 4) + (p[1] << 4) + (p[2] << 12);
      head = 3;
    }
  } else {
    if (sfmt < 2) {
      if (n < 3) corrupt("zstd literals header past its data");
      const uint32_t v = rd24(p);
      regen = (v >> 4) & 1023;
      csize = (v >> 14) & 1023;
      head = 3;
      streams = sfmt == 0 ? 1 : 4;
    } else if (sfmt == 2) {
      if (n < 4) corrupt("zstd literals header past its data");
      const uint32_t v = rd32(p);
      regen = (v >> 4) & 16383;
      csize = v >> 18;
      head = 4;
      streams = 4;
    } else {
      if (n < 5) corrupt("zstd literals header past its data");
      const uint64_t v = rd32(p) | (static_cast<uint64_t>(p[4]) << 32);
      regen = (v >> 4) & 262143;
      csize = (v >> 22) & 262143;
      head = 5;
      streams = 4;
    }
  }
  if (regen > 128 * 1024) corrupt("zstd literals larger than a block");
  std::vector<uint8_t> lit(regen);
  size_t at = head;
  if (ltype == 0) {
    if (at + regen > n) corrupt("zstd raw literals past the block");
    std::memcpy(lit.data(), p + at, regen);
    at += regen;
  } else if (ltype == 1) {
    if (at + 1 > n) corrupt("zstd RLE literals past the block");
    std::memset(lit.data(), p[at], regen);
    at += 1;
  } else {
    if (at + csize > n) corrupt("zstd Huffman literals past the block");
    const uint8_t* q = p + at;
    size_t qn = csize;
    if (ltype == 2) {
      const size_t tree = huf_read(fr.huf, q, qn);
      q += tree;
      qn -= tree;
      // a table built for one stream is X1's; for four, as libzstd picks
      fr.huf_x2 = streams == 4 && regen > 0 && select_x2(regen, csize);
    } else if (!fr.huf.ready) {
      corrupt("zstd treeless literals without a table before them");
    }
    if (streams == 1)
      huf_stream(fr.huf, q, qn, lit.data(), regen);
    else
      HufStreams4(fr.huf, fr.huf_x2, q, qn).decode(lit.data(), regen);
    at += csize;
  }
  // ---- sequences
  if (at >= n) corrupt("zstd block without its sequences header");
  size_t nseq = p[at];
  if (nseq < 128) {
    at += 1;
  } else if (nseq < 255) {
    if (at + 2 > n) corrupt("zstd sequences header past the block");
    nseq = ((nseq - 128) << 8) + p[at + 1];
    at += 2;
  } else {
    if (at + 3 > n) corrupt("zstd sequences header past the block");
    nseq = p[at + 1] + (p[at + 2] << 8) + 0x7F00;
    at += 3;
  }
  std::vector<uint8_t>& out = fr.out;
  size_t lit_at = 0;
  if (nseq == 0 && at != n) corrupt("zstd block with data past its sequences header");
  if (nseq > 0) {
    if (at >= n) corrupt("zstd sequences without their modes");
    const int modes = p[at++];
    if (modes & 3) corrupt("zstd reserved sequence mode bits");
    at += read_table(fr.ll, fr.have_ll, modes >> 6, p + at, n - at, kLLNorm, 6, 9, 35);
    at += read_table(fr.of, fr.have_of, (modes >> 4) & 3, p + at, n - at, kOFNorm, 5, 8, 31);
    at += read_table(fr.ml, fr.have_ml, (modes >> 2) & 3, p + at, n - at, kMLNorm, 6, 9, 52);
    if (at >= n) corrupt("zstd sequences without their bitstream");
    BackBits br(p + at, n - at);
    uint32_t sll = static_cast<uint32_t>(br.read(fr.ll.log));
    uint32_t sof = static_cast<uint32_t>(br.read(fr.of.log));
    uint32_t sml = static_cast<uint32_t>(br.read(fr.ml.log));
    for (size_t k = 0; k < nseq; k++) {
      const int ofc = fr.of.t[sof].symbol, llc = fr.ll.t[sll].symbol, mlc = fr.ml.t[sml].symbol;
      if (ofc > 31) corrupt("zstd offset code out of range");
      uint64_t ofv = (1ull << ofc) + br.read(ofc);
      const uint64_t ml = kMLBase[mlc] + br.read(kMLBits[mlc]);
      const uint64_t ll = kLLBase[llc] + br.read(kLLBits[llc]);
      uint64_t offset;
      if (ofv > 3) {
        offset = ofv - 3;
        fr.rep[2] = fr.rep[1];
        fr.rep[1] = fr.rep[0];
        fr.rep[0] = static_cast<uint32_t>(offset);
      } else {
        if (ll == 0) ofv++;
        if (ofv == 1) {
          offset = fr.rep[0];
        } else {
          offset = ofv == 4 ? fr.rep[0] - 1ull : fr.rep[ofv - 1];
          if (offset == 0) corrupt("zstd repeat offset of 0");
          if (ofv != 2) fr.rep[2] = fr.rep[1];
          fr.rep[1] = fr.rep[0];
          fr.rep[0] = static_cast<uint32_t>(offset);
        }
      }
      if (k + 1 < nseq) {
        sll = fr.ll.t[sll].base + static_cast<uint32_t>(br.read(fr.ll.t[sll].nb_bits));
        sml = fr.ml.t[sml].base + static_cast<uint32_t>(br.read(fr.ml.t[sml].nb_bits));
        sof = fr.of.t[sof].base + static_cast<uint32_t>(br.read(fr.of.t[sof].nb_bits));
      }
      if (ll > lit.size() - lit_at) corrupt("zstd sequence past its literals");
      out.insert(out.end(), lit.begin() + lit_at, lit.begin() + lit_at + ll);
      lit_at += ll;
      if (offset > out.size()) corrupt("zstd match offset before the frame's start");
      if (fr.window && offset > fr.window) corrupt("zstd match offset past the window");
      const size_t from = out.size() - offset;
      out.reserve(out.size() + ml);
      for (uint64_t i = 0; i < ml; i++) out.push_back(out[from + i]);
    }
    if (br.left != 0) corrupt("zstd sequences do not end where their bitstream does");
  }
  out.insert(out.end(), lit.begin() + lit_at, lit.end());
}

// decodes the first frame of `src` into `dst` until `cap` bytes are out
// or the frame ends; returns the bytes out
size_t decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  size_t at = 0;
  {
    if (n - at < 4) corrupt("zstd data ends before a frame");
    const uint32_t magic = rd32(src + at);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // a skippable frame: a frame of nothing
      if (n - at < 8) corrupt("zstd skippable frame past its data");
      const uint64_t size = rd32(src + at + 4);
      if (size > n - at - 8) corrupt("zstd skippable frame past its data");
      return 0;
    }
    if (magic != 0xFD2FB528u) corrupt("not a zstd frame");
    at += 4;
    if (at >= n) corrupt("zstd frame header past its data");
    const int desc = src[at++];
    const int fcs_flag = desc >> 6, single = (desc >> 5) & 1, checksum = (desc >> 2) & 1,
              dict_flag = desc & 3;
    if (desc & 8) corrupt("zstd frame header's reserved bit is set");
    Frame fr;
    if (!single) {
      if (at >= n) corrupt("zstd frame header past its data");
      const int wd = src[at++];
      const int exp = wd >> 3, mant = wd & 7;
      if (10 + exp > 31) corrupt("zstd window too large");
      const uint64_t base = 1ull << (10 + exp);
      fr.window = base + (base / 8) * mant;
    }
    // libzstd's streaming limit (ZSTD_MAXWINDOWSIZE_DEFAULT) is checked below, once
    // a single-segment frame's window is known
    const int dict_bytes = dict_flag == 3 ? 4 : dict_flag;
    if (n - at < static_cast<size_t>(dict_bytes)) corrupt("zstd frame header past its data");
    uint32_t dict = 0;
    for (int i = 0; i < dict_bytes; i++) dict |= static_cast<uint32_t>(src[at + i]) << (8 * i);
    at += dict_bytes;
    if (dict) corrupt("zstd frame with dictionary " + std::to_string(dict));
    const int fcs_bytes = fcs_flag == 0 ? single : (1 << fcs_flag);
    if (n - at < static_cast<size_t>(fcs_bytes)) corrupt("zstd frame header past its data");
    uint64_t fcs = 0;
    for (int i = 0; i < fcs_bytes; i++) fcs |= static_cast<uint64_t>(src[at + i]) << (8 * i);
    if (fcs_bytes == 2) fcs += 256;
    at += fcs_bytes;
    if (single) fr.window = fcs;
    if (fr.window > (1ull << 27) + 1) corrupt("zstd frame's window larger than 128 MiB");
    const bool known = fcs_flag || single;
    const uint64_t block_max = std::min<uint64_t>(fr.window, 128 * 1024);
    // libzstd's single-pass shortcut: the content size known and within the
    // chunk, the whole frame in the data (ZSTD_findFrameCompressedSize)
    bool whole = false;
    if (known && fcs <= cap) {
      size_t q = at;
      for (;;) {
        if (n - q < 3) break;
        const uint32_t bh = rd24(src + q);
        const size_t stored = ((bh >> 1) & 3) == 1 ? 1 : bh >> 3;
        if (n - q - 3 < stored) break;
        q += 3 + stored;
        if (bh & 1) {
          whole = !checksum || n - q >= 4;
          break;
        }
      }
    }
    bool full = false;  // streaming, the chunk filled exactly: one more block is decoded
    auto done = [&] {
      std::memcpy(dst, fr.out.data(), cap);
      return cap;
    };
    for (;;) {
      // streaming, once the chunk is full, data that ends early is awaited
      if (n - at < 3) {
        if (full) return done();
        corrupt("zstd block header past its data");
      }
      const uint32_t bh = rd24(src + at);
      at += 3;
      const int last = bh & 1, type = (bh >> 1) & 3;
      const size_t size = bh >> 3;
      if (type == 3) corrupt("zstd reserved block type");
      if (size > block_max) corrupt("zstd block larger than its maximum");
      const size_t stored = type == 1 ? 1 : size;
      const size_t before = fr.out.size();
      if (n - at < stored) {
        if (full) return done();
        if (type != 0) corrupt("zstd block past its data");
        // a raw block streams out as far as the data goes
        fr.out.insert(fr.out.end(), src + at, src + n);
        if (fr.out.size() >= cap) return done();
        corrupt("zstd block past its data");
      }
      if (type == 0) {
        fr.out.insert(fr.out.end(), src + at, src + at + size);
      } else if (type == 1) {
        fr.out.insert(fr.out.end(), size, src[at]);
      } else {
        compressed_block(fr, src + at, size);
      }
      if (fr.out.size() - before > block_max) corrupt("zstd block decodes past its maximum");
      // streaming, libzstd decodes each block into its buffer of the frame's
      // content size where that is no larger than a window and two blocks
      // (ZSTD_decodingBufferSize_internal): a block past it fails
      if (!whole && known && fcs <= fr.window + 2 * block_max + 64 && fr.out.size() > fcs)
        corrupt("zstd block past the frame's content size");
      at += stored;
      if (whole && fr.out.size() > cap) corrupt("zstd frame larger than the chunk");
      if (last && known && fr.out.size() != fcs)
        corrupt("zstd frame of another size than its header says");
      if (!whole) {
        // the chunk full: libtiff asks no more once libzstd holds more than
        // it flushed (a frame that ends there has its checksum checked first)
        if (full || fr.out.size() > cap) return done();
        if (fr.out.size() == cap && !last) {
          full = true;
          continue;
        }
      }
      if (last) break;
    }
    if (checksum && n - at >= 4 &&   // a checksum cut short is only awaited
        rd32(src + at) != static_cast<uint32_t>(xxh64(fr.out.data(), fr.out.size())))
      corrupt("zstd checksum mismatch");
    std::memcpy(dst, fr.out.data(), fr.out.size());
    return fr.out.size();
  }
}

}  // namespace

extern "C" {

// Decodes the zstd data src[0:n] into dst[0:cap] as tif_zstd.c does; 0,
// or 1 where it fails (the message in `err`) or ends before `cap` bytes.
int zs_decode(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, char* err, int errlen) {
  try {
    const size_t got = decompress(src, n, dst, cap);
    if (got < cap)
      corrupt("not enough zstd data (" + std::to_string(got) + " of " + std::to_string(cap) +
              " bytes)");
    return 0;
  } catch (const Fail& e) {
    if (err && errlen > 0) std::snprintf(err, errlen, "%s", e.msg.c_str());
    return kCorrupt;
  } catch (const std::bad_alloc&) {
    if (err && errlen > 0) std::snprintf(err, errlen, "out of memory");
    return kCorrupt;
  }
}

}  // extern "C"
