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

// ----------------------------------------------------------- CCITT fax
// tif_fax3.c's decoders, state machine and all: the codes are looked up
// LSB first in tables built as mkg3states builds them (7 bits for the 2-D
// modes, 12 for white runs, 13 for black), a row that ends short or long
// is cut or padded (CLEANUP_RUNS), data that ends mid-row fills the row
// and fails the chunk (a G4 chunk only when its first row is unfinished),
// and a code no table holds ends the row where it stands.
enum FaxState : uint8_t {
  S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB, S_MakeUpW, S_MakeUpB,
  S_MakeUp, S_EOL
};

struct FaxEnt {
  uint8_t state, width;
  int32_t param;
};

struct FaxTables {
  FaxEnt main[128], white[4096], black[8192];
};

const char* const kWhiteTerm[64] = {
    "00110101", "000111",   "0111",     "1000",     "1011",     "1100",     "1110",
    "1111",     "10011",    "10100",    "00111",    "01000",    "001000",   "000011",
    "110100",   "110101",   "101010",   "101011",   "0100111",  "0001100",  "0001000",
    "0010111",  "0000011",  "0000100",  "0101000",  "0101011",  "0010011",  "0100100",
    "0011000",  "00000010", "00000011", "00011010", "00011011", "00010010", "00010011",
    "00010100", "00010101", "00010110", "00010111", "00101000", "00101001", "00101010",
    "00101011", "00101100", "00101101", "00000100", "00000101", "00001010", "00001011",
    "01010010", "01010011", "01010100", "01010101", "00100100", "00100101", "01011000",
    "01011001", "01011010", "01011011", "01001010", "01001011", "00110010", "00110011",
    "00110100"};
const char* const kBlackTerm[64] = {
    "0000110111",   "010",          "11",           "10",           "011",
    "0011",         "0010",         "00011",        "000101",       "000100",
    "0000100",      "0000101",      "0000111",      "00000100",     "00000111",
    "000011000",    "0000010111",   "0000011000",   "0000001000",   "00001100111",
    "00001101000",  "00001101100",  "00000110111",  "00000101000",  "00000010111",
    "00000011000",  "000011001010", "000011001011", "000011001100", "000011001101",
    "000001101000", "000001101001", "000001101010", "000001101011", "000011010010",
    "000011010011", "000011010100", "000011010101", "000011010110", "000011010111",
    "000001101100", "000001101101", "000011011010", "000011011011", "000001010100",
    "000001010101", "000001010110", "000001010111", "000001100100", "000001100101",
    "000001010010", "000001010011", "000000100100", "000000110111", "000000111000",
    "000000100111", "000000101000", "000001011000", "000001011001", "000000101011",
    "000000101100", "000001011010", "000001100110", "000001100111"};
// the make-up codes of 64, 128, ..., 1728
const char* const kWhiteMakeUp[27] = {
    "11011",     "10010",     "010111",    "0110111",   "00110110",  "00110111",  "01100100",
    "01100101",  "01101000",  "01100111",  "011001100", "011001101", "011010010", "011010011",
    "011010100", "011010101", "011010110", "011010111", "011011000", "011011001", "011011010",
    "011011011", "010011000", "010011001", "010011010", "011000",    "010011011"};
const char* const kBlackMakeUp[27] = {
    "0000001111",    "000011001000",  "000011001001",  "000001011011",  "000000110011",
    "000000110100",  "000000110101",  "0000001101100", "0000001101101", "0000001001010",
    "0000001001011", "0000001001100", "0000001001101", "0000001110010", "0000001110011",
    "0000001110100", "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010", "0000001011011",
    "0000001100100", "0000001100101"};
// the extended make-up codes of 1792, 1856, ..., 2560, either colour
const char* const kMakeUp[13] = {
    "00000001000",  "00000001100",  "00000001101",  "000000010010", "000000010011",
    "000000010100", "000000010101", "000000010110", "000000010111", "000000011100",
    "000000011101", "000000011110", "000000011111"};

// mkg3states' FillTable: every index whose low bits are the code, read LSB first
void fill_table(FaxEnt* t, int size, const char* bits, FaxState state, int32_t param) {
  const int width = static_cast<int>(std::strlen(bits));
  int code = 0;
  for (int i = 0; i < width; i++) code |= (bits[i] - '0') << i;
  for (int c = code; c < (1 << size); c += 1 << width)
    t[c] = {state, static_cast<uint8_t>(width), param};
}

const FaxTables& fax_tables() {
  static const FaxTables* tables = [] {
    auto* t = new FaxTables{};
    const struct {
      const char* bits;
      FaxState state;
      int param;
    } modes[] = {{"0001", S_Pass, 0},    {"001", S_Horiz, 0},   {"1", S_V0, 0},
                 {"011", S_VR, 1},       {"000011", S_VR, 2},   {"0000011", S_VR, 3},
                 {"010", S_VL, 1},       {"000010", S_VL, 2},   {"0000010", S_VL, 3},
                 {"0000001", S_Ext, 0},  {"0000000", S_EOL, 0}};
    for (const auto& m : modes) fill_table(t->main, 7, m.bits, m.state, m.param);
    for (int k = 0; k < 27; k++) fill_table(t->white, 12, kWhiteMakeUp[k], S_MakeUpW, 64 * (k + 1));
    for (int k = 0; k < 13; k++) fill_table(t->white, 12, kMakeUp[k], S_MakeUp, 1792 + 64 * k);
    for (int k = 0; k < 64; k++) fill_table(t->white, 12, kWhiteTerm[k], S_TermW, k);
    fill_table(t->white, 12, "00000000000", S_EOL, 0);
    for (int k = 0; k < 27; k++) fill_table(t->black, 13, kBlackMakeUp[k], S_MakeUpB, 64 * (k + 1));
    for (int k = 0; k < 13; k++) fill_table(t->black, 13, kMakeUp[k], S_MakeUp, 1792 + 64 * k);
    for (int k = 0; k < 64; k++) fill_table(t->black, 13, kBlackTerm[k], S_TermB, k);
    fill_table(t->black, 13, "00000000000", S_EOL, 0);
    return t;
  }();
  return *tables;
}

uint8_t kReversed[256];
const bool kReversedReady = [] {
  for (int i = 0; i < 256; i++) {
    int r = 0;
    for (int b = 0; b < 8; b++) r |= ((i >> b) & 1) << (7 - b);
    kReversed[i] = static_cast<uint8_t>(r);
  }
  return true;
}();

// _TIFFFax3fillruns: white runs clear bits, black runs set them; a run
// past lastx is cut to it (and so is the run in the array)
void fax_fill(uint8_t* row, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0;
  for (; runs < erun; runs += 2) {
    for (int black = 0; black < 2; black++) {
      uint32_t run = runs[black];
      if (x + run > lastx || run > lastx) run = runs[black] = lastx - x;
      for (uint32_t i = x; i < x + run; i++) {
        const uint8_t bit = static_cast<uint8_t>(0x80 >> (i & 7));
        row[i >> 3] = black ? (row[i >> 3] | bit) : (row[i >> 3] & ~bit);
      }
      x += run;
    }
  }
}

enum FaxMethod { kFaxRle, kFaxRlew, kFaxG3, kFaxG4 };

class FaxDecoder {
 public:
  // `runs`: the codec's run arrays, which live as long as the image's
  // decode (libtiff keeps them across its chunks: a damaged row can read
  // past the reference line's runs into what earlier rows left there)
  FaxDecoder(const uint8_t* data, size_t n, bool odd_start, int lastx, bool two_d,
             std::vector<uint32_t>& runs)
      : T(fax_tables()), cp(data), ep(data + n), odd(odd_start), lastx(lastx) {
    nruns = ((static_cast<uint32_t>(lastx) + 1 + 31) / 32) * 32;
    if (two_d) nruns *= 2;
    if (runs.size() != 2 * static_cast<size_t>(nruns) + 2)
      runs.assign(2 * static_cast<size_t>(nruns) + 2, 0);
    cur = runs.data();  // Fax3PreDecode: the reference line all white
    ref = runs.data() + nruns;
    ref[0] = static_cast<uint32_t>(lastx);
    ref[1] = 0;
  }

  // each returns false where libtiff's decoder returns -1
  bool rle(uint8_t* buf, size_t rows, size_t rb, bool word) {
    for (size_t r = 0; r < rows; r++, buf += rb) {
      start_row();
      const bool ok = expand1d();
      fax_fill(buf, thisrun, pa, lastx);
      if (!ok) return false;
      if (!word) {
        clr(avail - (avail & ~7));
      } else {
        clr(avail - (avail & ~15));
        if (avail == 0 && ((cp - base()) & 1) != (odd ? 1 : 0)) cp++;
      }
    }
    return true;
  }

  // `noeol`: libtiff's FAXMODE_NOEOL, set once a row finds no EOL (the
  // data is then read again from the chunk's start, without EOLs, for
  // this row and every later one, later chunks too)
  bool g3(uint8_t* buf, size_t rows, size_t rb, bool two_d, bool& noeol) {
    for (size_t r = 0; r < rows; r++, buf += rb) {
      start_row();
      bool ok = true;
      if (!noeol) {
        const int sync = sync_eol();
        ok = sync != kSyncEof;
        if (sync == kSyncNone) {
          noeol = true;
          cp = start_;
          acc = 0;
          avail = 0;
        }
      }
      bool is1d = true;
      if (ok && two_d) {
        ok = need8(1);
        if (ok) {
          is1d = bits(1);
          clr(1);
        }
      }
      if (!ok) {
        cleanup_runs();
        fax_fill(buf, thisrun, pa, lastx);
        return false;
      }
      pb = ref;
      b1 = static_cast<int32_t>(*pb++);
      ok = is1d ? expand1d() : expand2d();
      fax_fill(buf, thisrun, pa, lastx);
      if (!ok) return false;
      if (two_d) {
        if (pa < thisrun + nruns) setvalue(0);
        std::swap(cur, ref);
      }
    }
    return true;
  }

  bool g4(uint8_t* buf, size_t rows, size_t rb) {
    for (size_t r = 0; r < rows; r++, buf += rb) {
      start_row();
      pb = ref;
      b1 = static_cast<int32_t>(*pb++);
      if (!expand2d() || eolcnt) {  // EOFB, or the data's end: the chunk ends here
        fax_fill(buf, thisrun, pa, lastx);
        return r > 0;
      }
      fax_fill(buf, thisrun, pa, lastx);
      setvalue(0);
      std::swap(cur, ref);
    }
    return true;
  }

 private:
  const FaxTables& T;
  const uint8_t* cp;
  const uint8_t* const ep;
  const bool odd;  // whether the chunk starts at an odd offset of the file
  const int32_t lastx;
  const uint8_t* start_ = cp;
  uint32_t acc = 0;
  int avail = 0, eolcnt = 0;
  uint32_t nruns;
  uint32_t *cur, *ref, *thisrun = nullptr, *pa = nullptr, *pb = nullptr;
  int32_t a0 = 0, run_length = 0, b1 = 0;
  const FaxEnt* te = nullptr;

  const uint8_t* base() const { return start_; }
  void start_row() {
    a0 = 0;
    run_length = 0;
    pa = thisrun = cur;
  }
  bool end_of_data() const { return cp >= ep; }
  // NeedBits8 / NeedBits16: false where no bit is left; past the end, zeros
  bool need8(int n) {
    if (avail < n) {
      if (end_of_data()) {
        if (avail == 0) return false;
        avail = n;
      } else {
        acc |= static_cast<uint32_t>(kReversed[*cp++]) << avail;
        avail += 8;
      }
    }
    return true;
  }
  bool need16(int n) {
    if (avail < n) {
      if (end_of_data()) {
        if (avail == 0) return false;
        avail = n;
      } else {
        acc |= static_cast<uint32_t>(kReversed[*cp++]) << avail;
        if ((avail += 8) < n) {
          if (end_of_data()) {
            avail = n;
          } else {
            acc |= static_cast<uint32_t>(kReversed[*cp++]) << avail;
            avail += 8;
          }
        }
      }
    }
    return true;
  }
  uint32_t bits(int n) const { return acc & ((1u << n) - 1); }
  void clr(int n) {
    avail -= n;
    acc >>= n;
  }
  bool lookup8(int w, const FaxEnt* tab) {
    if (!need8(w)) return false;
    te = tab + bits(w);
    clr(te->width);
    return true;
  }
  bool lookup16(int w, const FaxEnt* tab) {
    if (!need16(w)) return false;
    te = tab + bits(w);
    clr(te->width);
    return true;
  }
  void setvalue(int32_t x) {
    if (pa >= thisrun + nruns) corrupt("fax run buffer overflow");
    *pa++ = static_cast<uint32_t>(run_length + x);
    a0 += x;
    run_length = 0;
  }
  void cleanup_runs() {
    if (run_length) setvalue(0);
    if (a0 != lastx) {  // libtiff's "Line length mismatch" / "Premature EOL" warning
      while (a0 > lastx && pa > thisrun) a0 -= static_cast<int32_t>(*--pa);
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if ((pa - thisrun) & 1) setvalue(0);
        setvalue(lastx - a0);
      } else if (a0 > lastx) {
        setvalue(lastx);
        setvalue(0);
      }
    }
  }
  // SYNC_EOL: on to the next EOL (and past fill bits); kSyncEof at the
  // data's end before any EOL, kSyncNone where the data ends in one
  enum { kSynced, kSyncEof, kSyncNone };
  int sync_eol() {
    if (eolcnt == 0) {
      for (;;) {
        if (!need16(11)) return kSyncEof;
        if (bits(11) == 0) break;
        clr(1);
      }
    }
    for (;;) {
      if (!need8(8)) return kSyncNone;
      if (bits(8)) break;
      clr(8);
    }
    while (bits(1) == 0) clr(1);
    clr(1);
    eolcnt = 0;
    return kSynced;
  }
  // one run of a colour (make-up codes, then a terminating one) as
  // EXPAND1D / the horizontal mode read it: 1 done, 0 the data's end,
  // -1 a code the colour's table does not end a run with (EOL: -2)
  int colour_run(bool black) {
    for (;;) {
      if (!lookup16(black ? 13 : 12, black ? T.black : T.white)) return 0;
      switch (te->state) {
        case S_TermW:
        case S_TermB:
          if ((te->state == S_TermB) != black) return -1;
          setvalue(te->param);
          return 1;
        case S_MakeUpW:
        case S_MakeUpB:
          if ((te->state == S_MakeUpB) != black) return -1;
          a0 += te->param;
          run_length += te->param;
          break;
        case S_MakeUp:
          a0 += te->param;
          run_length += te->param;
          break;
        case S_EOL:
          return -2;
        default:
          return -1;
      }
    }
  }
  // EXPAND1D: false at the data's end (the runs cleaned up either way)
  bool expand1d() {
    for (;;) {
      for (int black = 0; black < 2; black++) {
        const int got = colour_run(black);
        if (got == 0) {
          cleanup_runs();
          return false;
        }
        if (got == -2) eolcnt = 1;
        if (got < 0 || a0 >= lastx) {
          cleanup_runs();
          return true;
        }
      }
      if (pa[-1] == 0 && pa[-2] == 0) pa -= 2;
    }
  }
  void check_b1() {
    if (pa != thisrun) {
      while (b1 <= a0 && b1 < lastx) {
        if (pb + 1 >= ref + nruns) corrupt("fax reference line overflow");
        b1 += static_cast<int32_t>(pb[0] + pb[1]);
        pb += 2;
      }
    }
  }
  // EXPAND2D: false at the data's end (the runs cleaned up either way)
  bool expand2d() {
    while (a0 < lastx) {
      if (pa >= thisrun + nruns) corrupt("fax run buffer overflow");
      if (!lookup8(7, T.main)) {
        cleanup_runs();
        return false;
      }
      switch (te->state) {
        case S_Pass:
          check_b1();
          if (pb + 1 >= ref + nruns) corrupt("fax reference line overflow");
          b1 += static_cast<int32_t>(*pb++);
          run_length += b1 - a0;
          a0 = b1;
          b1 += static_cast<int32_t>(*pb++);
          break;
        case S_Horiz: {
          const bool black_first = (pa - thisrun) & 1;
          for (int k = 0; k < 2; k++) {
            const int got = colour_run(black_first != (k == 1));
            if (got == 0) {
              cleanup_runs();
              return false;
            }
            if (got < 0) {  // "Bad code word": the row ends here
              cleanup_runs();
              return true;
            }
          }
          check_b1();
          break;
        }
        case S_V0:
          check_b1();
          setvalue(b1 - a0);
          if (pb >= ref + nruns) corrupt("fax reference line overflow");
          b1 += static_cast<int32_t>(*pb++);
          break;
        case S_VR:
          check_b1();
          setvalue(b1 - a0 + te->param);
          if (pb >= ref + nruns) corrupt("fax reference line overflow");
          b1 += static_cast<int32_t>(*pb++);
          break;
        case S_VL:
          check_b1();
          if (b1 < a0 + te->param) {
            cleanup_runs();
            return true;
          }
          setvalue(b1 - a0 - te->param);
          b1 -= static_cast<int32_t>(*--pb);
          break;
        case S_Ext:
          *pa++ = static_cast<uint32_t>(lastx - a0);
          cleanup_runs();
          return true;
        case S_EOL:
          *pa++ = static_cast<uint32_t>(lastx - a0);
          if (!need8(4)) {
            cleanup_runs();
            return false;
          }
          clr(4);
          eolcnt = 1;
          cleanup_runs();
          return true;
        default:
          cleanup_runs();
          return true;
      }
    }
    if (run_length) {
      if (run_length + a0 < lastx) {  // a final V0 is due
        if (!need8(1)) {
          cleanup_runs();
          return false;
        }
        if (!bits(1)) {
          cleanup_runs();
          return true;
        }
        clr(1);
      }
      setvalue(0);
    }
    cleanup_runs();
    return true;
  }
};

// ------------------------------------------------------------- layout
struct Layout {
  int width, height, spp, bps, planar, tiled, cw, ch, big_endian, predictor;
  int ow, oh;  // the output: the image, or the whole tiles (libtiff's buffers) for cv2's view
  int hs, vs;  // YCbCr subsampling of 8-bit chunky YCbCr; 1, 1 otherwise
};

// bytes of one row of a chunk `w` pixels wide holding `samples` samples a pixel
inline size_t row_bytes(int w, int samples, int bps) {
  return (static_cast<size_t>(w) * samples * bps + 7) / 8;
}

// sample i of a row: whole bytes in the file's byte order (libtiff swabs
// 16, 24, 32 and 64 bits), any other width MSB first across bytes
inline uint64_t sample_at(const uint8_t* row, size_t i, int bps, bool big) {
  if (bps % 8 == 0) {
    const int n = bps / 8;
    const uint8_t* p = row + i * n;
    uint64_t v = 0;
    for (int k = 0; k < n; k++) v |= static_cast<uint64_t>(p[big ? n - 1 - k : k]) << (8 * k);
    return v;
  }
  if (8 % bps == 0) {
    const size_t bit = i * bps;
    return (row[bit >> 3] >> (8 - bps - (bit & 7))) & ((1u << bps) - 1);
  }
  uint64_t v = 0;
  for (size_t bit = i * bps, end = bit + bps; bit < end; bit++)
    v = (v << 1) | ((row[bit >> 3] >> (7 - (bit & 7))) & 1);
  return v;
}

// tif_predict.c's fpAcc: the bytes summed along the row, then each sample
// gathered from its byte planes (the most significant plane first); the
// row is left in the file's byte order for sample_at
void undo_float_predictor(uint8_t* row, size_t rb, int stride, int bps, bool big,
                          std::vector<uint8_t>& tmp) {
  const size_t n = bps / 8, wc = rb / n;
  if (rb % (n * stride)) corrupt("floating-point predictor on a row of " + std::to_string(rb) +
                                 " bytes");
  for (size_t i = stride; i < rb; i++) row[i] = static_cast<uint8_t>(row[i] + row[i - stride]);
  tmp.assign(row, row + rb);
  for (size_t c = 0; c < wc; c++)
    for (size_t k = 0; k < n; k++) row[c * n + (big ? k : n - 1 - k)] = tmp[k * wc + c];
}

// decodes a fax chunk into `buf` (rows of rb bytes); false where libtiff
// fails the chunk (what it decoded is kept)
bool fax_chunk(const uint8_t* src, size_t n, bool odd, int method, int options, int lastx,
               uint8_t* buf, size_t rows, size_t rb, bool& noeol, std::vector<uint32_t>& runs) {
  const bool two_d = method == kFaxG4 || (method == kFaxG3 && (options & 1));
  FaxDecoder d(src, n, odd, lastx, two_d, runs);
  switch (method) {
    case kFaxRle:
    case kFaxRlew:
      return d.rle(buf, rows, rb, method == kFaxRlew);
    case kFaxG3:
      return d.g3(buf, rows, rb, two_d, noeol);
    default:
      return d.g4(buf, rows, rb);
  }
}

template <typename Out>
void decode(const uint8_t* data, const int64_t* offs, const int64_t* lens, const int64_t* at,
            int nchunks, int method, int options, int lenient, const Layout& L, Out* out) {
  const int chunk_samples = L.planar == 2 ? 1 : L.spp;
  const int planes = L.planar == 2 ? L.spp : 1;
  const int across = (L.width + L.cw - 1) / L.cw;
  const int down = (L.height + L.ch - 1) / L.ch;
  const int per_plane = across * down;
  if (nchunks < per_plane * planes) corrupt("fewer TIFF strips or tiles than the image needs");
  if (L.predictor == 2 && L.bps != 8 && L.bps != 16 && L.bps != 32 && L.bps != 64)
    corrupt("horizontal predictor at " + std::to_string(L.bps) + " bits");
  if (L.predictor == 3 && L.bps != 16 && L.bps != 24 && L.bps != 32 && L.bps != 64)
    corrupt("floating-point predictor at " + std::to_string(L.bps) + " bits");
  const int fax = method == 2 ? kFaxRle : method == 32771 ? kFaxRlew : method == 3 ? kFaxG3
                : method == 4 ? kFaxG4 : -1;
  if (fax >= 0 && L.bps != 1) corrupt("CCITT compression at " + std::to_string(L.bps) + " bits");
  // subsampled YCbCr comes in blocks of hs x vs Y samples, then Cb and Cr;
  // a "row" is then one row of blocks
  const bool blocks = L.hs * L.vs > 1;
  if (blocks && (L.spp != 3 || L.bps != 8 || L.planar == 2 || fax >= 0 || L.predictor != 1))
    corrupt("subsampled YCbCr of " + std::to_string(L.spp) + " samples at " +
            std::to_string(L.bps) + " bits");
  const int block_bytes = L.hs * L.vs + 2, blocks_across = (L.cw + L.hs - 1) / L.hs;
  const size_t rb = blocks ? static_cast<size_t>(blocks_across) * block_bytes
                           : row_bytes(L.cw, chunk_samples, L.bps);
  const uint64_t mask = L.bps == 64 ? ~0ull : (1ull << L.bps) - 1;
  std::vector<uint8_t> buf, tmp;
  std::vector<uint64_t> vals(static_cast<size_t>(L.cw) * chunk_samples);
  bool noeol = false;
  std::vector<uint32_t> runs;  // the fax codec's, kept across chunks
  for (int p = 0; p < planes; p++) {
    for (int k = 0; k < per_plane; k++) {
      const int idx = p * per_plane + k;
      const int x0 = (k % across) * L.cw, y0 = (k / across) * L.ch;
      // a strip holds the rows left; a tile is always whole
      const int rows = L.tiled ? L.ch : std::min(L.ch, L.height - y0);
      const size_t want = rb * (blocks ? (rows + L.vs - 1) / L.vs : rows);
      const uint8_t* src = data + offs[idx];
      const size_t n = static_cast<size_t>(lens[idx]);
      // Pillow reads every chunk into one buffer: rows a fax chunk leaves
      // (a G4 chunk that ends early, a tile libtiff lets fail) keep the
      // chunk's before them; libtiff's RGBA reads (cv2) start from zeros
      if (fax >= 0 && !lenient)
        buf.resize(std::max(buf.size(), want), 0);
      else
        buf.assign(want, 0);
      if (method == kNone) {
        if (n < want) corrupt("not enough TIFF image data");
        std::memcpy(buf.data(), src, want);
      } else if (method == kPackBits) {
        packbits(src, n, buf.data(), want);
      } else if (method == kLzw) {
        lzw(src, n, buf.data(), want);
      } else if (fax >= 0) {
        // a fax decoder fails with -1, which TIFFReadEncodedTile takes for
        // success (it tests the result for zero, the strip reader for <= 0)
        if (!fax_chunk(src, n, at && (at[idx] & 1), fax, options, L.cw, buf.data(), rows, rb,
                       noeol, runs) && !lenient && !L.tiled)
          corrupt("premature end of CCITT data");
      } else {
        corrupt("TIFF compression " + std::to_string(method));
      }
      const int w = std::min(L.cw, L.ow - x0), h = std::min(rows, L.oh - y0);
      const size_t nvals = static_cast<size_t>(L.cw) * chunk_samples;
      if (blocks && !L.tiled) {
        // gtStripContig reads a strip's rows (up to a multiple of vs) times
        // TIFFScanlineSize, a row of blocks / vs rounded down: 4 x 4 blocks
        // of an odd count a row lose the strip's last bytes (read as zeros)
        const size_t read = static_cast<size_t>((rows + L.vs - 1) / L.vs * L.vs) * (rb / L.vs);
        if (read < want) std::memset(buf.data() + read, 0, want - read);
      }
      if (blocks) {  // each pixel's Y with its block's Cb and Cr
        // the put routines step past a cut tile's hidden blocks by
        // `fromskew`, which putcontig8bitYCbCr44tile counts at 10 bytes a
        // block (4 * 2 + 2), not 18: its later rows of blocks read askew
        const int nblk = (w + L.hs - 1) / L.hs;
        const size_t skip = static_cast<size_t>(blocks_across - nblk) *
                            (L.tiled && L.hs == 4 && L.vs == 4 ? 10 : block_bytes);
        for (int y = 0; y < h; y++) {
          Out* o = out + (static_cast<size_t>(y0 + y) * L.ow + x0) * 3;
          const size_t base = static_cast<size_t>(y / L.vs) * (nblk * block_bytes + skip);
          for (int x = 0; x < w; x++) {
            const uint8_t* b = buf.data() + base + static_cast<size_t>(x / L.hs) * block_bytes;
            o[3 * x] = b[(y % L.vs) * L.hs + x % L.hs];
            o[3 * x + 1] = b[L.hs * L.vs];
            o[3 * x + 2] = b[L.hs * L.vs + 1];
          }
        }
        continue;
      }
      for (int y = 0; y < h; y++) {
        uint8_t* row = buf.data() + static_cast<size_t>(y) * rb;
        if (L.predictor == 3)
          undo_float_predictor(row, rb, chunk_samples, L.bps, L.big_endian, tmp);
        for (size_t i = 0; i < nvals; i++) vals[i] = sample_at(row, i, L.bps, L.big_endian);
        if (L.predictor == 2)  // tif_predict.c's horAcc on the row's values
          for (size_t i = chunk_samples; i < nvals; i++)
            vals[i] = (vals[i] + vals[i - chunk_samples]) & mask;
        Out* o = out + (static_cast<size_t>(y0 + y) * L.ow + x0) * L.spp;
        // chunky: every sample of the row in turn; planar: plane p's
        for (size_t i = 0; i < static_cast<size_t>(w) * chunk_samples; i++) {
          const size_t pos = L.planar == 2 ? i * L.spp + p : i;
          o[pos] = static_cast<Out>(vals[i]);
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
// file's order: every chunk of plane 0, then plane 1, ...; at[i] the
// chunk's offset in the file, or at null) by `method` (1 none, 32773
// PackBits, 5 LZW, 2 CCITT RLE, 32771 RLEW, 3 G3 with T4Options `options`,
// 4 G4) into the samples out [oh, ow, spp] of `out_bytes` (2, 4 or 8)
// each: the image (ow = width, oh = height) or its whole tiles (ow, oh the
// multiples of the tile size that hold it).  Strips are chunks cw = width
// pixels wide and ch = RowsPerStrip rows high (the last one shorter);
// tiles are cw x ch; 8-bit YCbCr subsampled hs x vs comes in blocks, and
// each pixel gets its Y and its block's Cb and Cr.  `lenient`: a fax chunk
// libtiff fails keeps what it decoded (TIFFReadRGBA* goes on), else the
// call fails.
int tf_decode(const uint8_t* data, const int64_t* offs, const int64_t* lens, const int64_t* at,
              int nchunks, int method, int options, int lenient, int width, int height, int spp,
              int bps, int planar, int tiled, int cw, int ch, int big_endian, int predictor,
              int hs, int vs, int ow, int oh, int out_bytes, void* out, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    const Layout L{width, height, spp,       bps, planar, tiled, cw, ch,
                   big_endian, predictor, ow, oh, hs, vs};
    if (out_bytes == 2)
      decode(data, offs, lens, at, nchunks, method, options, lenient, L,
             static_cast<uint16_t*>(out));
    else if (out_bytes == 4)
      decode(data, offs, lens, at, nchunks, method, options, lenient, L,
             static_cast<uint32_t*>(out));
    else
      decode(data, offs, lens, at, nchunks, method, options, lenient, L,
             static_cast<uint64_t*>(out));
  });
}

}  // extern "C"
