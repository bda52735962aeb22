// Host WebP decoder of the PyTorch port: the bitstreams of a WebP file in,
// RGBA uint8 out, bit for bit what libwebp gives Pillow and cv2, without
// either.  The caller (data/image.py) reads the RIFF container and hands
// over the payloads of the chunks.
//
// - VP8 (lossy, RFC 6386): one key frame.  The boolean decoder, the segment
//   and filter headers, 1-8 token partitions, the quantiser tables (the y2
//   AC step at least 8, the uv DC index clamped at 117, i.e. 132), the
//   coefficient-probability updates and contexts, the 16x16, chroma and ten
//   4x4 intra predictors with the frame-edge values 127 / 129 and the
//   above-right pixels of the sub-blocks in a macroblock's right column
//   taken from the macroblock row above, the inverse WHT and IDCT (20091,
//   35468), then both loop filters over the whole frame in macroblock
//   order (per-segment level, sharpness, mode deltas, the key-frame hev
//   thresholds, inner edges skipped where a non-B_PRED macroblock has no
//   coefficients), as libwebp's decoder runs them.  YUV 4:2:0 becomes RGB
//   through libwebp's "fancy" upsampler (two-step rounding, the first and
//   last rows mirrored) and its 14-bit VP8YUVToR/G/B (vp8_yuv_to_rgba).
// - VP8L (lossless, RFC 9649): the header, the four transforms (predictor
//   with its 14 modes, Select and the clamped add-subtract forms; cross
//   colour; subtract green; colour indexing with pixel bundling), the
//   colour cache, the meta prefix-code image, simple and normal prefix
//   codes and the 120-entry distance map (vp8l_decode).
// - ALPH: raw or VP8L-compressed alpha (an implicit-size image whose green
//   holds alpha) and the horizontal, vertical and gradient unfilters
//   (alpha_decode).
//
// Errors: 1 = bytes no decoder can read (a bad or cut-off stream); the
// message goes to `err`.  Every valid key frame and VP8L stream decodes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

constexpr int kCorrupt = 1;

struct Fail {
  int code;
  std::string msg;
};

[[noreturn]] void corrupt(const std::string& m) { throw Fail{kCorrupt, m}; }

// ------------------------------------------------------------ VP8 tables
// RFC 6386's dc_qlookup, ac_qlookup, default_coeff_probs,
// coeff_update_probs ([type][band][context][node], flattened),
// kf_bmode_probs ([above][left][node], in the mode order below) and, for
// VP8L, RFC 9649's distance map as (yoffset << 4) | (8 - xoffset).
constexpr uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
constexpr uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
constexpr uint8_t kCoeffsProba0[4 * 8 * 3 * 11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
constexpr uint8_t kCoeffsUpdateProba[4 * 8 * 3 * 11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
constexpr uint8_t kBModesProba[10 * 10 * 9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};
constexpr uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a,
    0x26, 0x2a, 0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a,
    0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b,
    0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03,
    0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d, 0x44, 0x4c,
    0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b,
    0x32, 0x3e, 0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f,
    0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41,
    0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d, 0x51, 0x5f,
    0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70,
};

constexpr uint8_t kBands[16 + 1] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
constexpr uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
constexpr uint8_t kCat3[] = {173, 148, 140, 0};
constexpr uint8_t kCat4[] = {176, 155, 140, 135, 0};
constexpr uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
constexpr uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
constexpr const uint8_t* kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// intra modes: the 4x4 ones; DC / TM / V / H for 16x16 and chroma share
// their numbers
enum {
  B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED,
  B_VL_PRED, B_HD_PRED, B_HU_PRED
};
constexpr int DC_PRED = B_DC_PRED, TM_PRED = B_TM_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED;

// the 4x4 mode tree: a node's two children, a leaf as -mode
constexpr int8_t kYModesIntra4[18] = {
    -B_DC_PRED, 1, -B_TM_PRED, 2, -B_VE_PRED, 3, 4, 6, -B_HE_PRED, 5,
    -B_RD_PRED, -B_VR_PRED, -B_LD_PRED, 7, -B_VL_PRED, 8, -B_HD_PRED, -B_HU_PRED};

inline int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }
inline uint8_t clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

// ----------------------------------------------------- boolean decoder
// libwebp's VP8BitReader: `range` kept minus one, `bits` the count of read
// bits below the 8-bit window; `eof` set once the window reaches past the
// end (the missing byte read as zero).
struct BoolReader {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 254;
  bool eof = false;

  void init(const uint8_t* start, size_t size) {
    p = start;
    end = start + size;
    value = 0;
    bits = -8;
    range = 254;
    eof = false;
    load();
  }
  void load() {
    if (p < end) {
      bits += 8;
      value = (value << 8) | *p++;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int get(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * static_cast<uint32_t>(prob)) >> 8;
    const uint32_t v = static_cast<uint32_t>(value >> pos);
    const int bit = v > split;
    if (bit) {
      r -= split;
      value -= static_cast<uint64_t>(split + 1) << pos;
    } else {
      r = split + 1;
    }
    const int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  // VP8GetSigned: a bit at probability 1/2 giving -v or v
  int get_signed(int v) {
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t value8 = static_cast<uint32_t>(value >> pos);
    const int32_t mask = static_cast<int32_t>(split - value8) >> 31;
    bits -= 1;
    range += static_cast<uint32_t>(mask);
    range |= 1;
    value -= static_cast<uint64_t>((split + 1) & static_cast<uint32_t>(mask)) << pos;
    return (v ^ mask) - mask;
  }
  uint32_t value_bits(int n) {
    uint32_t v = 0;
    while (n-- > 0) v |= static_cast<uint32_t>(get(0x80)) << n;
    return v;
  }
  int flag() { return static_cast<int>(value_bits(1)); }
  int signed_value(int n) {
    const int v = static_cast<int>(value_bits(n));
    return flag() ? -v : v;
  }
};

// ------------------------------------------------------ intra predictors
// On a work buffer of stride BPS: the block at `dst`, its top row at
// dst - BPS (with the top-left at dst - BPS - 1), its left column at
// dst - 1.
constexpr int BPS = 32;

inline uint8_t avg3(int a, int b, int c) { return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int left = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + left - tl);
    dst += BPS;
  }
}

void fill(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, v, size);
}

void vertical(uint8_t* dst, int size) {
  for (int y = 0; y < size; ++y) std::memcpy(dst + y * BPS, dst - BPS, size);
}

void horizontal(uint8_t* dst, int size) {
  for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, dst[y * BPS - 1], size);
}

// DC for 16x16 (shift 5) and 8x8 (shift 4), with libwebp's forms at the
// frame's edges
void predict_dc(uint8_t* dst, int size, bool has_top, bool has_left) {
  const int shift = size == 16 ? 4 : 3;
  int dc;
  if (has_top && has_left) {
    dc = size;
    for (int j = 0; j < size; ++j) dc += dst[j - BPS] + dst[-1 + j * BPS];
    dc >>= shift + 1;
  } else if (has_left) {
    dc = size >> 1;
    for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
    dc >>= shift;
  } else if (has_top) {
    dc = size >> 1;
    for (int j = 0; j < size; ++j) dc += dst[j - BPS];
    dc >>= shift;
  } else {
    dc = 0x80;
  }
  fill(dst, size, dc);
}

void predict_large(uint8_t* dst, int size, int mode, bool has_top, bool has_left) {
  switch (mode) {
    case DC_PRED: predict_dc(dst, size, has_top, has_left); break;
    case TM_PRED: true_motion(dst, size); break;
    case V_PRED: vertical(dst, size); break;
    default: horizontal(dst, size); break;
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]

void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  switch (mode) {
    case B_DC_PRED: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
      fill(dst, 4, dc >> 3);
      break;
    }
    case B_TM_PRED: true_motion(dst, 4); break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE_PRED:
      std::memset(dst, avg3(X, I, J), 4);
      std::memset(dst + BPS, avg3(I, J, K), 4);
      std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
      std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case B_RD_PRED:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD_PRED:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR_PRED:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL_PRED:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HD_PRED:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default:  // B_HU_PRED
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = static_cast<uint8_t>(L);
      break;
  }
}

#undef DST

// ------------------------------------------------------------ transforms
inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// the inverse DCT of one 4x4 block, added to the prediction at dst
void idct_add(const int16_t* in, uint8_t* dst) {
  int tmp[16];
  int* t = tmp;
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    t[0] = a + d;
    t[1] = b + c;
    t[2] = b - c;
    t[3] = a - d;
    t += 4;
    ++in;
  }
  t = tmp;
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int dc = t[0] + 4;
    const int a = dc + t[8];
    const int b = dc - t[8];
    const int c = mul2(t[4]) - mul1(t[12]);
    const int d = mul1(t[4]) + mul2(t[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
    ++t;
    dst += BPS;
  }
}

// the inverse WHT of the y2 block into the DC of the 16 luma blocks
void iwht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    out += 64;
  }
}

// ----------------------------------------------------------- loop filter
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // [-1020, 1020]
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // [-112, 112]
inline int abs0(int v) { return v < 0 ? -v : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return abs0(p1 - p0) > thresh || abs0(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * abs0(p0 - q0) + abs0(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * abs0(p0 - q0) + abs0(p1 - q1) > t) return false;
  return abs0(p3 - p2) <= it && abs0(p2 - p1) <= it && abs0(p1 - p0) <= it &&
         abs0(q3 - q2) <= it && abs0(q2 - q1) <= it && abs0(q1 - q0) <= it;
}

// the simple filter along one edge of 16 pixels: `step` across the edge,
// `along` between its pixels
void simple_edge(uint8_t* p, int step, int along, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += along)
    if (needs_filter(p, step, thresh2)) do_filter2(p, step);
}

// the normal filter along one edge of `size` pixels: the macroblock edge's
// 6-tap form or the inner edges' 4-tap form
void normal_edge(uint8_t* p, int step, int along, int size, int thresh, int ithresh,
                 int hev_thresh, bool mb_edge) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += along) {
    if (!needs_filter2(p, step, thresh2, ithresh)) continue;
    if (hev(p, step, hev_thresh)) {
      do_filter2(p, step);
    } else if (mb_edge) {
      do_filter6(p, step);
    } else {
      do_filter4(p, step);
    }
  }
}

// ------------------------------------------------------- the VP8 decoder
struct Quant {
  int y1[2], y2[2], uv[2];
};

struct FilterInfo {
  int limit = 0, ilevel = 0, hev_thresh = 0;
  bool inner = false;
};

struct Vp8 {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  // segment header (libwebp's defaults where the frame sends none)
  bool use_segment = false, update_map = false, absolute_delta = true;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  uint8_t seg_proba[3] = {255, 255, 255};
  // filter header
  bool simple = false, use_lf_delta = false;
  int level = 0, sharpness = 0, filter_type = 0;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  FilterInfo fstrengths[4][2];
  int num_parts = 1;
  BoolReader br, parts[8];
  Quant dqm[4];
  uint8_t proba[4 * 8 * 3 * 11];
  bool use_skip = false;
  int skip_p = 0;
  // the frame, 16-aligned, before the loop filter and after it
  int ystride = 0, uvstride = 0;
  std::vector<uint8_t> y, u, v;
  std::vector<FilterInfo> finfo;

  const uint8_t* probas(int type, int n) const { return proba + (type * 8 + kBands[n]) * 33; }

  void parse_headers(const uint8_t* buf, size_t size);
  void parse_quant();
  void parse_proba();
  void precompute_filter_strengths();
  int get_coeffs(BoolReader& tb, int type, int ctx, const int* dq, int n, int16_t* out) const;
  void decode(const uint8_t* buf, size_t size);
  void filter_frame();
};

void Vp8::parse_headers(const uint8_t* buf, size_t size) {
  if (size < 10) corrupt("truncated VP8 frame header");
  const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
  const bool key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7;
  const bool show = (bits >> 4) & 1;
  const uint32_t partition_length = bits >> 5;
  if (!key_frame) corrupt("VP8 stream does not start with a key frame");
  if (profile > 3) corrupt("VP8 profile " + std::to_string(profile));
  if (!show) corrupt("VP8 frame that is not shown");
  if (buf[3] != 0x9d || buf[4] != 0x01 || buf[5] != 0x2a) corrupt("bad VP8 start code");
  width = ((buf[7] << 8) | buf[6]) & 0x3fff;
  height = ((buf[9] << 8) | buf[8]) & 0x3fff;
  if (width == 0 || height == 0) corrupt("VP8 frame of size 0");
  mb_w = (width + 15) >> 4;
  mb_h = (height + 15) >> 4;
  buf += 10;
  size -= 10;
  if (partition_length > size) corrupt("bad VP8 partition length");
  br.init(buf, partition_length);
  buf += partition_length;
  size -= partition_length;
  br.flag();  // colour space
  br.flag();  // clamping type (always clamped)
  // segment header
  use_segment = br.flag();
  if (use_segment) {
    update_map = br.flag();
    if (br.flag()) {  // update data
      absolute_delta = br.flag();
      for (int s = 0; s < 4; ++s) quantizer[s] = br.flag() ? br.signed_value(7) : 0;
      for (int s = 0; s < 4; ++s) filter_strength[s] = br.flag() ? br.signed_value(6) : 0;
    }
    if (update_map)
      for (int s = 0; s < 3; ++s) seg_proba[s] = br.flag() ? br.value_bits(8) : 255;
  } else {
    update_map = false;
  }
  if (br.eof) corrupt("cannot parse the VP8 segment header");
  // filter header
  simple = br.flag();
  level = br.value_bits(6);
  sharpness = br.value_bits(3);
  use_lf_delta = br.flag();
  if (use_lf_delta && br.flag()) {
    for (int i = 0; i < 4; ++i)
      if (br.flag()) ref_lf_delta[i] = br.signed_value(6);
    for (int i = 0; i < 4; ++i)
      if (br.flag()) mode_lf_delta[i] = br.signed_value(6);
  }
  filter_type = level == 0 ? 0 : simple ? 1 : 2;
  if (br.eof) corrupt("cannot parse the VP8 filter header");
  // partitions
  num_parts = 1 << br.value_bits(2);
  const size_t last_part = num_parts - 1;
  if (size < 3 * last_part) corrupt("truncated VP8 partition sizes");
  const uint8_t* sz = buf;
  const uint8_t* part_start = buf + last_part * 3;
  const uint8_t* buf_end = buf + size;
  size_t size_left = size - last_part * 3;
  for (size_t p = 0; p < last_part; ++p) {
    size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > size_left) psize = size_left;
    parts[p].init(part_start, psize);
    part_start += psize;
    size_left -= psize;
    sz += 3;
  }
  parts[last_part].init(part_start, size_left);
  if (part_start >= buf_end) corrupt("truncated VP8 partitions");
  parse_quant();
  br.flag();  // refresh entropy probabilities: one frame only
  parse_proba();
}

void Vp8::parse_quant() {
  const int base_q0 = br.value_bits(7);
  const int dqy1_dc = br.flag() ? br.signed_value(4) : 0;
  const int dqy2_dc = br.flag() ? br.signed_value(4) : 0;
  const int dqy2_ac = br.flag() ? br.signed_value(4) : 0;
  const int dquv_dc = br.flag() ? br.signed_value(4) : 0;
  const int dquv_ac = br.flag() ? br.signed_value(4) : 0;
  for (int i = 0; i < 4; ++i) {
    int q;
    if (use_segment) {
      q = quantizer[i] + (absolute_delta ? 0 : base_q0);
    } else if (i > 0) {
      dqm[i] = dqm[0];
      continue;
    } else {
      q = base_q0;
    }
    Quant& m = dqm[i];
    m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
    m.y1[1] = kAcTable[clip(q, 127)];
    m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;  // x * 155 / 100
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
    m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
  }
}

void Vp8::parse_proba() {
  for (int i = 0; i < 4 * 8 * 3 * 11; ++i)
    proba[i] = br.get(kCoeffsUpdateProba[i]) ? br.value_bits(8) : kCoeffsProba0[i];
  use_skip = br.flag();
  if (use_skip) skip_p = br.value_bits(8);
}

void Vp8::precompute_filter_strengths() {
  if (filter_type == 0) return;
  for (int s = 0; s < 4; ++s) {
    int base_level = level;
    if (use_segment) base_level = filter_strength[s] + (absolute_delta ? 0 : level);
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FilterInfo& info = fstrengths[s][i4x4];
      int lvl = base_level;
      if (use_lf_delta) {
        lvl += ref_lf_delta[0];
        if (i4x4) lvl += mode_lf_delta[0];
      }
      lvl = clip(lvl, 63);
      if (lvl > 0) {
        int ilevel = lvl;
        if (sharpness > 0) {
          ilevel >>= sharpness > 4 ? 2 : 1;
          if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        info.ilevel = ilevel;
        info.limit = 2 * lvl + ilevel;
        info.hev_thresh = lvl >= 40 ? 2 : lvl >= 15 ? 1 : 0;
      } else {
        info.limit = 0;
      }
      info.inner = i4x4;
    }
  }
}

// the tokens of one block from position n: returns the position after the
// last coefficient read (libwebp's GetCoeffs)
int Vp8::get_coeffs(BoolReader& tb, int type, int ctx, const int* dq, int n,
                    int16_t* out) const {
  const uint8_t* p = probas(type, n) + ctx * 11;
  for (; n < 16; ++n) {
    if (!tb.get(p[0])) return n;  // end of block
    while (!tb.get(p[1])) {       // a zero
      p = probas(type, ++n);
      if (n == 16) return 16;
    }
    const uint8_t* p_ctx = probas(type, n + 1);
    int v;
    if (!tb.get(p[2])) {
      v = 1;
      p = p_ctx + 11;
    } else {
      if (!tb.get(p[3])) {
        v = !tb.get(p[4]) ? 2 : 3 + tb.get(p[5]);
      } else if (!tb.get(p[6])) {
        if (!tb.get(p[7])) {
          v = 5 + tb.get(159);
        } else {
          v = 7 + 2 * tb.get(165);
          v += tb.get(145);
        }
      } else {
        const int bit1 = tb.get(p[8]);
        const int bit0 = tb.get(p[9 + bit1]);
        const int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + tb.get(*tab);
        v += 3 + (8 << cat);
      }
      p = p_ctx + 22;
    }
    out[kZigzag[n]] = static_cast<int16_t>(tb.get_signed(v) * dq[n > 0]);
  }
  return 16;
}

struct MbModes {
  bool is_i4x4 = false;
  bool skip = false;
  int segment = 0;
  uint8_t imodes[16];
  int uvmode = 0;
};

void Vp8::decode(const uint8_t* buf, size_t size) {
  parse_headers(buf, size);
  precompute_filter_strengths();
  ystride = mb_w * 16;
  uvstride = mb_w * 8;
  y.assign(static_cast<size_t>(ystride) * mb_h * 16, 0);
  u.assign(static_cast<size_t>(uvstride) * mb_h * 8, 0);
  v.assign(static_cast<size_t>(uvstride) * mb_h * 8, 0);
  finfo.assign(static_cast<size_t>(mb_w) * mb_h, FilterInfo());
  std::vector<uint8_t> intra_t(4 * mb_w, B_DC_PRED);
  std::vector<uint8_t> nz_top(mb_w, 0), nz_dc_top(mb_w, 0);
  std::vector<MbModes> modes(mb_w);
  int16_t coeffs[384];
  // the work buffer: Y (16 rows of 16 + 4 above-right, a row above, a
  // column left) then U and V (8 x 8 each, same borders)
  uint8_t ws[BPS * 17 + 2 * BPS * 9];
  uint8_t* const y_dst = ws + BPS + 8;
  uint8_t* const u_dst = ws + BPS * 17 + BPS + 8;
  uint8_t* const v_dst = u_dst + 16;

  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    // the row's modes, from the first partition
    uint8_t intra_l[4] = {B_DC_PRED, B_DC_PRED, B_DC_PRED, B_DC_PRED};
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MbModes& m = modes[mb_x];
      uint8_t* top = &intra_t[4 * mb_x];
      m.segment = !update_map ? 0
                  : !br.get(seg_proba[0]) ? br.get(seg_proba[1])
                                          : br.get(seg_proba[2]) + 2;
      m.skip = use_skip ? br.get(skip_p) : false;
      m.is_i4x4 = !br.get(145);
      if (!m.is_i4x4) {
        const int ymode = br.get(156) ? (br.get(128) ? TM_PRED : H_PRED)
                                      : (br.get(163) ? V_PRED : DC_PRED);
        m.imodes[0] = static_cast<uint8_t>(ymode);
        std::memset(top, ymode, 4);
        std::memset(intra_l, ymode, 4);
      } else {
        uint8_t* mo = m.imodes;
        for (int yy = 0; yy < 4; ++yy) {
          int ymode = intra_l[yy];
          for (int xx = 0; xx < 4; ++xx) {
            const uint8_t* prob = kBModesProba + (top[xx] * 10 + ymode) * 9;
            int i = kYModesIntra4[br.get(prob[0])];
            while (i > 0) i = kYModesIntra4[2 * i + br.get(prob[i])];
            ymode = -i;
            top[xx] = static_cast<uint8_t>(ymode);
          }
          std::memcpy(mo, top, 4);
          mo += 4;
          intra_l[yy] = static_cast<uint8_t>(ymode);
        }
      }
      m.uvmode = !br.get(142) ? DC_PRED : !br.get(114) ? V_PRED : br.get(183) ? TM_PRED : H_PRED;
    }
    if (br.eof) corrupt("premature end of VP8 partition 0");

    BoolReader& tb = parts[mb_y & (num_parts - 1)];
    uint8_t nz_left = 0, nz_dc_left = 0;
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const MbModes& m = modes[mb_x];
      // ------------------------------------------------ residuals
      uint32_t non_zero_y = 0, non_zero_uv = 0;
      bool skip = use_skip ? m.skip : false;
      std::memset(coeffs, 0, sizeof(coeffs));
      if (!skip) {
        const Quant& q = dqm[m.segment];
        int16_t* dst = coeffs;
        int first, ac_type;
        if (!m.is_i4x4) {
          int16_t dc[16] = {0};
          const int ctx = nz_dc_top[mb_x] + nz_dc_left;
          const int nz = get_coeffs(tb, 1, ctx, q.y2, 0, dc);
          nz_dc_top[mb_x] = nz_dc_left = nz > 0;
          if (nz > 1) {
            iwht(dc, dst);
          } else {
            const int dc0 = (dc[0] + 3) >> 3;
            for (int i = 0; i < 16 * 16; i += 16) dst[i] = static_cast<int16_t>(dc0);
          }
          first = 1;
          ac_type = 0;
        } else {
          first = 0;
          ac_type = 3;
        }
        uint32_t tnz = nz_top[mb_x] & 0x0f;
        uint32_t lnz = nz_left & 0x0f;
        for (int yy = 0; yy < 4; ++yy) {
          int l = lnz & 1;
          uint32_t nz_coeffs = 0;
          for (int xx = 0; xx < 4; ++xx) {
            const int ctx = l + (tnz & 1);
            const int nz = get_coeffs(tb, ac_type, ctx, q.y1, first, dst);
            l = nz > first;
            tnz = (tnz >> 1) | (l << 7);
            nz_coeffs = (nz_coeffs << 2) | (nz > 3 ? 3 : nz > 1 ? 2 : dst[0] != 0);
            dst += 16;
          }
          tnz >>= 4;
          lnz = (lnz >> 1) | (l << 7);
          non_zero_y = (non_zero_y << 8) | nz_coeffs;
        }
        uint32_t out_t_nz = tnz;
        uint32_t out_l_nz = lnz >> 4;
        for (int ch = 0; ch < 4; ch += 2) {
          uint32_t nz_coeffs = 0;
          tnz = nz_top[mb_x] >> (4 + ch);
          lnz = nz_left >> (4 + ch);
          for (int yy = 0; yy < 2; ++yy) {
            int l = lnz & 1;
            for (int xx = 0; xx < 2; ++xx) {
              const int ctx = l + (tnz & 1);
              const int nz = get_coeffs(tb, 2, ctx, q.uv, 0, dst);
              l = nz > 0;
              tnz = (tnz >> 1) | (l << 3);
              nz_coeffs = (nz_coeffs << 2) | (nz > 3 ? 3 : nz > 1 ? 2 : dst[0] != 0);
              dst += 16;
            }
            tnz >>= 2;
            lnz = (lnz >> 1) | (l << 5);
          }
          non_zero_uv |= nz_coeffs << (4 * ch);
          out_t_nz |= (tnz << 4) << ch;
          out_l_nz |= (lnz & 0xf0) << ch;
        }
        nz_top[mb_x] = static_cast<uint8_t>(out_t_nz);
        nz_left = static_cast<uint8_t>(out_l_nz);
        skip = !(non_zero_y | non_zero_uv);
      } else {
        nz_top[mb_x] = nz_left = 0;
        if (!m.is_i4x4) nz_dc_top[mb_x] = nz_dc_left = 0;
      }
      if (filter_type > 0) {
        FilterInfo& fi = finfo[static_cast<size_t>(mb_y) * mb_w + mb_x];
        fi = fstrengths[m.segment][m.is_i4x4];
        fi.inner = fi.inner || !skip;
      }
      if (tb.eof) corrupt("premature end of a VP8 token partition");

      // ------------------------------------------- reconstruction
      uint8_t* fy = &y[static_cast<size_t>(mb_y) * 16 * ystride + mb_x * 16];
      uint8_t* fu = &u[static_cast<size_t>(mb_y) * 8 * uvstride + mb_x * 8];
      uint8_t* fv = &v[static_cast<size_t>(mb_y) * 8 * uvstride + mb_x * 8];
      // the borders: row above (127 on the frame's first row), column left
      // (129 on its first column), the corner (127 / 129 / the pixel)
      for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = mb_x > 0 ? fy[j * ystride - 1] : 129;
      for (int j = 0; j < 8; ++j) {
        u_dst[j * BPS - 1] = mb_x > 0 ? fu[j * uvstride - 1] : 129;
        v_dst[j * BPS - 1] = mb_x > 0 ? fv[j * uvstride - 1] : 129;
      }
      if (mb_y > 0) {
        std::memcpy(y_dst - BPS, fy - ystride, 16);
        std::memcpy(u_dst - BPS, fu - uvstride, 8);
        std::memcpy(v_dst - BPS, fv - uvstride, 8);
        y_dst[-BPS - 1] = mb_x > 0 ? fy[-ystride - 1] : 129;
        u_dst[-BPS - 1] = mb_x > 0 ? fu[-uvstride - 1] : 129;
        v_dst[-BPS - 1] = mb_x > 0 ? fv[-uvstride - 1] : 129;
        if (mb_x < mb_w - 1) {
          std::memcpy(y_dst - BPS + 16, fy - ystride + 16, 4);
        } else {
          std::memset(y_dst - BPS + 16, fy[-ystride + 15], 4);
        }
      } else {
        std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
        std::memset(u_dst - BPS - 1, 127, 8 + 1);
        std::memset(v_dst - BPS - 1, 127, 8 + 1);
      }
      if (m.is_i4x4) {
        // the right column's sub-blocks see the macroblock's above-right
        // pixels, the block to their right not being decoded yet
        for (int k = 1; k < 4; ++k) std::memcpy(y_dst + (4 * k - 1) * BPS + 16, y_dst - BPS + 16, 4);
        uint32_t bits = non_zero_y;
        for (int n = 0; n < 16; ++n, bits <<= 2) {
          uint8_t* const dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
          predict4(dst, m.imodes[n]);
          if (bits >> 30) idct_add(coeffs + n * 16, dst);
        }
      } else {
        predict_large(y_dst, 16, m.imodes[0], mb_y > 0, mb_x > 0);
        uint32_t bits = non_zero_y;
        for (int n = 0; n < 16; ++n, bits <<= 2)
          if (bits >> 30) idct_add(coeffs + n * 16, y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
      }
      predict_large(u_dst, 8, m.uvmode, mb_y > 0, mb_x > 0);
      predict_large(v_dst, 8, m.uvmode, mb_y > 0, mb_x > 0);
      for (int n = 0; n < 4; ++n) {
        const int off = (n & 1) * 4 + (n >> 1) * 4 * BPS;
        if ((non_zero_uv >> (6 - 2 * n)) & 3) idct_add(coeffs + 256 + n * 16, u_dst + off);
        if ((non_zero_uv >> (14 - 2 * n)) & 3) idct_add(coeffs + 320 + n * 16, v_dst + off);
      }
      for (int j = 0; j < 16; ++j) std::memcpy(fy + j * ystride, y_dst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(fu + j * uvstride, u_dst + j * BPS, 8);
        std::memcpy(fv + j * uvstride, v_dst + j * BPS, 8);
      }
    }
  }
  if (filter_type > 0) filter_frame();
}

// both loop filters over the frame, macroblock by macroblock: left edge,
// inner vertical edges, top edge, inner horizontal edges
void Vp8::filter_frame() {
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const FilterInfo& f = finfo[static_cast<size_t>(mb_y) * mb_w + mb_x];
      const int limit = f.limit;
      if (limit == 0) continue;
      uint8_t* yp = &y[static_cast<size_t>(mb_y) * 16 * ystride + mb_x * 16];
      const int ys = ystride;
      if (filter_type == 1) {
        if (mb_x > 0) simple_edge(yp, 1, ys, limit + 4);
        if (f.inner)
          for (int k = 1; k < 4; ++k) simple_edge(yp + 4 * k, 1, ys, limit);
        if (mb_y > 0) simple_edge(yp, ys, 1, limit + 4);
        if (f.inner)
          for (int k = 1; k < 4; ++k) simple_edge(yp + 4 * k * ys, ys, 1, limit);
        continue;
      }
      const int uvs = uvstride;
      uint8_t* up = &u[static_cast<size_t>(mb_y) * 8 * uvs + mb_x * 8];
      uint8_t* vp = &v[static_cast<size_t>(mb_y) * 8 * uvs + mb_x * 8];
      const int il = f.ilevel, ht = f.hev_thresh;
      if (mb_x > 0) {
        normal_edge(yp, 1, ys, 16, limit + 4, il, ht, true);
        normal_edge(up, 1, uvs, 8, limit + 4, il, ht, true);
        normal_edge(vp, 1, uvs, 8, limit + 4, il, ht, true);
      }
      if (f.inner) {
        for (int k = 1; k < 4; ++k) normal_edge(yp + 4 * k, 1, ys, 16, limit, il, ht, false);
        normal_edge(up + 4, 1, uvs, 8, limit, il, ht, false);
        normal_edge(vp + 4, 1, uvs, 8, limit, il, ht, false);
      }
      if (mb_y > 0) {
        normal_edge(yp, ys, 1, 16, limit + 4, il, ht, true);
        normal_edge(up, uvs, 1, 8, limit + 4, il, ht, true);
        normal_edge(vp, uvs, 1, 8, limit + 4, il, ht, true);
      }
      if (f.inner) {
        for (int k = 1; k < 4; ++k) normal_edge(yp + 4 * k * ys, ys, 1, 16, limit, il, ht, false);
        normal_edge(up + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
        normal_edge(vp + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
      }
    }
  }
}

// ----------------------------------------------------- YUV -> RGB
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline int yuv_clip8(int v) { return (v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255; }

inline void yuv_to_rgba(int yy, int uu, int vv, uint8_t* rgba) {
  rgba[0] = static_cast<uint8_t>(yuv_clip8(mult_hi(yy, 19077) + mult_hi(vv, 26149) - 14234));
  rgba[1] = static_cast<uint8_t>(
      yuv_clip8(mult_hi(yy, 19077) - mult_hi(uu, 6419) - mult_hi(vv, 13320) + 8708));
  rgba[2] = static_cast<uint8_t>(yuv_clip8(mult_hi(yy, 19077) + mult_hi(uu, 33050) - 17685));
  rgba[3] = 0xff;
}

// libwebp's fancy upsampler for one output row: the chroma row `near`
// weighs 3/4 and `far` 1/4 vertically, then 3/4 and 1/4 horizontally in
// two rounded steps
void upsample_chroma(const uint8_t* n, const uint8_t* f, int len, uint8_t* out) {
  out[0] = static_cast<uint8_t>((3 * n[0] + f[0] + 2) >> 2);
  const int last_pair = (len - 1) >> 1;
  for (int x = 1; x <= last_pair; ++x) {
    const int a = n[x - 1], b = n[x], c = f[x - 1], d = f[x];
    const int diag_12 = (a + 3 * b + 3 * c + d + 8) >> 3;
    const int diag_03 = (3 * a + b + c + 3 * d + 8) >> 3;
    out[2 * x - 1] = static_cast<uint8_t>((diag_12 + a) >> 1);
    out[2 * x] = static_cast<uint8_t>((diag_03 + b) >> 1);
  }
  if (!(len & 1)) out[len - 1] = static_cast<uint8_t>((3 * n[last_pair] + f[last_pair] + 2) >> 2);
}

void vp8_to_rgba(const Vp8& d, uint8_t* out) {
  const int w = d.width, h = d.height;
  std::vector<uint8_t> ur(w), vr(w);
  for (int r = 0; r < h; ++r) {
    int near, far;
    if (r == 0) {
      near = far = 0;
    } else if (r & 1) {
      near = (r - 1) >> 1;
      far = r == h - 1 ? near : near + 1;
    } else {
      near = r >> 1;
      far = near - 1;
    }
    upsample_chroma(&d.u[static_cast<size_t>(near) * d.uvstride],
                    &d.u[static_cast<size_t>(far) * d.uvstride], w, ur.data());
    upsample_chroma(&d.v[static_cast<size_t>(near) * d.uvstride],
                    &d.v[static_cast<size_t>(far) * d.uvstride], w, vr.data());
    const uint8_t* yr = &d.y[static_cast<size_t>(r) * d.ystride];
    uint8_t* o = out + static_cast<size_t>(r) * w * 4;
    for (int x = 0; x < w; ++x) yuv_to_rgba(yr[x], ur[x], vr[x], o + 4 * x);
  }
}

// ------------------------------------------------------------ VP8L
// libwebp's VP8LBitReader semantics: bits least significant first, zeros
// past the end, the end reached once more bits are read than there are (a
// stream under 8 bytes counts as 8)
struct LBits {
  std::vector<uint8_t> buf;  // the stream and 8 zero bytes
  uint64_t pos = 0, limit = 0;

  void init(const uint8_t* data, size_t size) {
    buf.assign(data, data + size);
    buf.resize(size + 8, 0);
    pos = 0;
    limit = 8 * static_cast<uint64_t>(size < 8 ? 8 : size);
  }
  bool eos() const { return pos > limit; }
  uint32_t peek() const {  // the next 24+ bits
    const uint64_t byte = pos >> 3;
    if (byte + 8 > buf.size()) return 0;
    uint64_t w;
    std::memcpy(&w, &buf[byte], 8);
    return static_cast<uint32_t>(w >> (pos & 7));
  }
  uint32_t read(int n) {
    if (n == 0) return 0;
    const uint32_t v = peek() & ((1u << n) - 1);
    pos += n;
    return v;
  }
};

// a canonical prefix code: one symbol (read with no bits), or a complete
// code of lengths 1..15, decoded through an 8-bit table and, for longer
// codes, one bit at a time
struct Huffman {
  int single = -1;
  uint16_t count[16] = {0};
  std::vector<uint16_t> sorted;
  uint16_t table[256];  // (length << 12) | symbol, 0 where longer than 8

  bool build(const int* lengths, int n) {
    int nonzero = 0, last = 0;
    for (int s = 0; s < n; ++s) {
      if (lengths[s] > 15) return false;
      if (lengths[s]) {
        ++nonzero;
        last = s;
      }
    }
    if (nonzero == 0) return false;
    if (nonzero == 1) {
      single = last;
      return true;
    }
    std::memset(count, 0, sizeof(count));
    for (int s = 0; s < n; ++s) ++count[lengths[s]];
    count[0] = 0;
    int left = 1;
    for (int len = 1; len <= 15; ++len) {
      left <<= 1;
      left -= count[len];
      if (left < 0) return false;
    }
    if (left != 0) return false;  // incomplete
    int offs[16];
    offs[1] = 0;
    for (int len = 1; len < 15; ++len) offs[len + 1] = offs[len] + count[len];
    sorted.assign(nonzero, 0);
    for (int s = 0; s < n; ++s)
      if (lengths[s]) sorted[offs[lengths[s]]++] = static_cast<uint16_t>(s);
    std::memset(table, 0, sizeof(table));
    int code = 0, k = 0;
    for (int len = 1; len <= 8; ++len) {
      for (int i = 0; i < count[len]; ++i, ++code, ++k) {
        int rev = 0;
        for (int b = 0; b < len; ++b) rev |= ((code >> (len - 1 - b)) & 1) << b;
        for (int fill = rev; fill < 256; fill += 1 << len)
          table[fill] = static_cast<uint16_t>((len << 12) | sorted[k]);
      }
      code <<= 1;
    }
    return true;
  }

  int read(LBits& br) const {
    if (single >= 0) return single;
    const uint32_t bits = br.peek();
    const uint16_t e = table[bits & 255];
    if (e) {
      br.pos += e >> 12;
      return e & 0xfff;
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= 15; ++len) {
      code |= (bits >> (len - 1)) & 1;
      const int cnt = count[len];
      if (code - cnt < first) {
        br.pos += len;
        return sorted[index + (code - first)];
      }
      index += cnt;
      first += cnt;
      first <<= 1;
      code <<= 1;
    }
    return 0;  // not reached: the code is complete
  }
  bool zero_bits() const { return single >= 0; }
};

constexpr int kNumLiteralCodes = 256, kNumLengthCodes = 24, kNumDistanceCodes = 40;
constexpr int kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                          7, 8, 9, 10, 11, 12, 13, 14, 15};
enum { GREEN = 0, RED = 1, BLUE = 2, ALPHA = 3, DIST = 4 };
enum { PREDICTOR = 0, CROSS_COLOR = 1, SUBTRACT_GREEN = 2, COLOR_INDEXING = 3 };

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

struct HGroup {
  Huffman h[5];
};

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

struct Vp8l {
  LBits br;
  Transform tr[4];
  int ntr = 0;
  unsigned seen = 0;
  bool tolerate_final_eos = false;  // libwebp's 8-bit alpha path

  void check() const {
    if (br.eos()) corrupt("truncated VP8L stream");
  }

  void read_code(int alphabet, Huffman* out, std::vector<int>& lengths) {
    lengths.assign(alphabet > 256 ? alphabet : 256, 0);
    if (br.read(1)) {  // simple code: one or two symbols
      const int num = br.read(1) + 1;
      const int first_len = br.read(1);
      lengths[br.read(first_len == 0 ? 1 : 8)] = 1;
      if (num == 2) lengths[br.read(8)] = 1;
    } else {
      int cl_lengths[19] = {0};
      const int num_codes = br.read(4) + 4;
      for (int i = 0; i < num_codes; ++i) cl_lengths[kCodeLengthCodeOrder[i]] = br.read(3);
      Huffman cl;
      if (!cl.build(cl_lengths, 19)) corrupt("bad VP8L code-length code");
      int max_symbol = alphabet;
      if (br.read(1)) {
        const int length_nbits = 2 + 2 * br.read(3);
        max_symbol = 2 + br.read(length_nbits);
        if (max_symbol > alphabet) corrupt("bad VP8L code-length count");
      }
      int prev = 8, symbol = 0;
      while (symbol < alphabet) {
        if (max_symbol-- == 0) break;
        const int code_len = cl.read(br);
        if (code_len < 16) {
          lengths[symbol++] = code_len;
          if (code_len != 0) prev = code_len;
        } else {
          static const int extra_bits[3] = {2, 3, 7}, offsets[3] = {3, 3, 11};
          const int slot = code_len - 16;
          const int repeat = br.read(extra_bits[slot]) + offsets[slot];
          if (symbol + repeat > alphabet) corrupt("bad VP8L code lengths");
          const int len = code_len == 16 ? prev : 0;
          for (int i = 0; i < repeat; ++i) lengths[symbol++] = len;
        }
      }
    }
    check();
    Huffman scratch;
    if (!(out ? out : &scratch)->build(lengths.data(), alphabet)) corrupt("bad VP8L prefix code");
  }

  // the prefix codes of an image: one group, or a meta image of groups
  void read_codes(int xsize, int ysize, int cache_bits, bool allow_meta,
                  std::vector<HGroup>& groups, std::vector<uint32_t>& meta, int& meta_bits) {
    int num_groups_max = 1;
    meta.clear();
    meta_bits = 0;
    std::vector<int> mapping;
    if (allow_meta && br.read(1)) {
      meta_bits = 2 + br.read(3);
      const int hx = subsample(xsize, meta_bits), hy = subsample(ysize, meta_bits);
      meta = decode_stream(hx, hy, false);
      for (uint32_t& g : meta) {
        g = (g >> 8) & 0xffff;
        if (static_cast<int>(g) >= num_groups_max) num_groups_max = g + 1;
      }
      if (num_groups_max > 1000 || num_groups_max > static_cast<int64_t>(xsize) * ysize) {
        // keep only the groups the image uses (the others are read and checked)
        mapping.assign(num_groups_max, -1);
        int next = 0;
        for (uint32_t& g : meta) {
          if (mapping[g] == -1) mapping[g] = next++;
          g = mapping[g];
        }
      }
    }
    check();
    const int sizes[5] = {kNumLiteralCodes + kNumLengthCodes + (cache_bits > 0 ? 1 << cache_bits : 0),
                          256, 256, 256, kNumDistanceCodes};
    int kept = 0;
    for (int i = 0; i < num_groups_max; ++i) kept += mapping.empty() || mapping[i] >= 0;
    groups.assign(kept, HGroup());
    std::vector<int> lengths;
    for (int i = 0; i < num_groups_max; ++i) {
      HGroup* g = nullptr;
      if (mapping.empty()) g = &groups[i];
      else if (mapping[i] >= 0) g = &groups[mapping[i]];
      for (int j = 0; j < 5; ++j) read_code(sizes[j], g ? &g->h[j] : nullptr, lengths);
    }
  }

  void read_transform(int& xsize, int ysize) {
    const int type = br.read(2);
    if (seen & (1u << type)) corrupt("repeated VP8L transform");
    seen |= 1u << type;
    Transform& t = tr[ntr++];
    t.type = type;
    t.xsize = xsize;
    t.ysize = ysize;
    if (type == PREDICTOR || type == CROSS_COLOR) {
      t.bits = br.read(3) + 2;
      t.data = decode_stream(subsample(xsize, t.bits), subsample(ysize, t.bits), false);
    } else if (type == COLOR_INDEXING) {
      const int num_colors = br.read(8) + 1;
      t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
      xsize = subsample(t.xsize, t.bits);
      std::vector<uint32_t> pal = decode_stream(num_colors, 1, false);
      // the palette is delta-coded; entries past it are transparent black
      const int final_num = 1 << (8 >> t.bits);
      t.data.assign(final_num, 0);
      t.data[0] = pal[0];
      for (int i = 1; i < num_colors; ++i) {
        uint32_t out = 0;
        for (int b = 0; b < 32; b += 8)
          out |= (((pal[i] >> b) + (t.data[i - 1] >> b)) & 0xff) << b;
        t.data[i] = out;
      }
    }
  }

  // an image stream: transforms (level 0 only), the colour cache, the
  // prefix codes and the entropy-coded pixels
  std::vector<uint32_t> decode_stream(int xsize, int ysize, bool level0) {
    int tx = xsize;
    if (level0)
      while (br.read(1)) read_transform(tx, ysize);
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = br.read(4);
      if (cache_bits < 1 || cache_bits > 11) corrupt("bad VP8L colour cache size");
    }
    std::vector<HGroup> groups;
    std::vector<uint32_t> meta;
    int meta_bits = 0;
    read_codes(tx, ysize, cache_bits, level0, groups, meta, meta_bits);
    bool tolerate = false;
    if (tolerate_final_eos && level0 && ntr == 1 && tr[0].type == COLOR_INDEXING && cache_bits == 0) {
      tolerate = true;
      for (const HGroup& g : groups)
        tolerate = tolerate && g.h[RED].zero_bits() && g.h[BLUE].zero_bits() && g.h[ALPHA].zero_bits();
    }
    return decode_pixels(tx, ysize, cache_bits, groups, meta, meta_bits, tolerate);
  }

  static int copy_value(int sym, LBits& br) {
    if (sym < 4) return sym + 1;
    const int extra = (sym - 2) >> 1;
    const int offset = (2 + (sym & 1)) << extra;
    return offset + br.read(extra) + 1;
  }

  std::vector<uint32_t> decode_pixels(int w, int h, int cache_bits, const std::vector<HGroup>& groups,
                                      const std::vector<uint32_t>& meta, int meta_bits,
                                      bool tolerate_eos) {
    const size_t total = static_cast<size_t>(w) * h;
    std::vector<uint32_t> px(total);
    std::vector<uint32_t> cache(cache_bits ? 1u << cache_bits : 0, 0);
    const int cache_shift = 32 - cache_bits;
    const int len_limit = kNumLiteralCodes + kNumLengthCodes;
    const int hx = meta.empty() ? 0 : subsample(w, meta_bits);
    size_t src = 0, cached = 0;
    int col = 0, row = 0;
    while (src < total) {
      const HGroup& g =
          meta.empty() ? groups[0] : groups[meta[(row >> meta_bits) * hx + (col >> meta_bits)]];
      const int code = g.h[GREEN].read(br);
      if (code < kNumLiteralCodes) {
        const int red = g.h[RED].read(br);
        const int blue = g.h[BLUE].read(br);
        const int alpha = g.h[ALPHA].read(br);
        px[src++] = (static_cast<uint32_t>(alpha) << 24) | (red << 16) | (code << 8) | blue;
        if (++col >= w) {
          col = 0;
          ++row;
        }
      } else if (code < len_limit) {
        const int length = copy_value(code - kNumLiteralCodes, br);
        const int dist_symbol = g.h[DIST].read(br);
        const int dist_code = copy_value(dist_symbol, br);
        int dist;
        if (dist_code > 120) {
          dist = dist_code - 120;
        } else {
          const int c = kCodeToPlane[dist_code - 1];
          dist = (c >> 4) * w + (8 - (c & 0xf));
          if (dist < 1) dist = 1;
        }
        if (src < static_cast<size_t>(dist) || total - src < static_cast<size_t>(length))
          corrupt("bad VP8L backward reference");
        for (int i = 0; i < length; ++i, ++src) px[src] = px[src - dist];
        col += length;
        while (col >= w) {
          col -= w;
          ++row;
        }
      } else {
        const int key = code - len_limit;
        while (cached < src) {
          const uint32_t c = px[cached++];
          cache[(0x1e35a7bdu * c) >> cache_shift] = c;
        }
        px[src++] = cache[key];
        if (++col >= w) {
          col = 0;
          ++row;
        }
      }
      if (br.eos()) break;
    }
    if (br.eos() && !(tolerate_eos && src == total)) corrupt("truncated VP8L stream");
    return px;
  }
};

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline int sub3(int a, int b, int c) {
  const int pb = b - c, pa = a - c;
  return abs0(pb) - abs0(pa);
}

inline uint32_t select(uint32_t a, uint32_t b, uint32_t c) {
  const int pa_minus_pb = sub3(a >> 24, b >> 24, c >> 24) +
                          sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                          sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
                          sub3(a & 0xff, b & 0xff, c & 0xff);
  return pa_minus_pb <= 0 ? a : b;
}

inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }

inline uint32_t clamped_add_subtract_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (c0 >> s) & 0xff, b = (c1 >> s) & 0xff, c = (c2 >> s) & 0xff;
    out |= clip255(static_cast<uint32_t>(a + b - c)) << s;
  }
  return out;
}

inline uint32_t clamped_add_subtract_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (ave >> s) & 0xff, b = (c2 >> s) & 0xff;
    out |= clip255(static_cast<uint32_t>(a + (a - b) / 2)) << s;  // C's truncating division
  }
  return out;
}

// predictor `mode` for the pixel at `out` (its left at out[-1], the row
// above at top = out - width)
inline uint32_t predict(int mode, const uint32_t* out, const uint32_t* top) {
  const uint32_t left = out[-1];
  switch (mode) {
    case 1: return left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(left, top[1]), top[0]);
    case 6: return average2(left, top[-1]);
    case 7: return average2(left, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(left, top[-1]), average2(top[0], top[1]));
    case 11: return select(top[0], left, top[-1]);
    case 12: return clamped_add_subtract_full(left, top[0], top[-1]);
    case 13: return clamped_add_subtract_half(left, top[0], top[-1]);
    default: return 0xff000000u;  // 0, and the unused 14 and 15
  }
}

// the inverse of transform t: `in` of t's input width (the packed width
// for colour indexing) into `out` of t.xsize
void inverse_transform(const Transform& t, const std::vector<uint32_t>& in,
                       std::vector<uint32_t>& out) {
  const int w = t.xsize, h = t.ysize;
  out.resize(static_cast<size_t>(w) * h);
  switch (t.type) {
    case PREDICTOR: {
      const int tiles_per_row = subsample(w, t.bits);
      for (int yy = 0; yy < h; ++yy) {
        const uint32_t* src = &in[static_cast<size_t>(yy) * w];
        uint32_t* dst = &out[static_cast<size_t>(yy) * w];
        if (yy == 0) {
          dst[0] = add_pixels(src[0], 0xff000000u);
          for (int x = 1; x < w; ++x) dst[x] = add_pixels(src[x], dst[x - 1]);
          continue;
        }
        const uint32_t* top = dst - w;
        dst[0] = add_pixels(src[0], top[0]);
        const uint32_t* modes = &t.data[static_cast<size_t>(yy >> t.bits) * tiles_per_row];
        for (int x = 1; x < w; ++x) {
          const int mode = (modes[x >> t.bits] >> 8) & 0xf;
          dst[x] = add_pixels(src[x], predict(mode, dst + x, top + x));
        }
      }
      break;
    }
    case CROSS_COLOR: {
      const int tiles_per_row = subsample(w, t.bits);
      for (int yy = 0; yy < h; ++yy) {
        const uint32_t* tiles = &t.data[static_cast<size_t>(yy >> t.bits) * tiles_per_row];
        for (int x = 0; x < w; ++x) {
          const uint32_t code = tiles[x >> t.bits];
          const int8_t g2r = static_cast<int8_t>(code & 0xff);
          const int8_t g2b = static_cast<int8_t>((code >> 8) & 0xff);
          const int8_t r2b = static_cast<int8_t>((code >> 16) & 0xff);
          const uint32_t argb = in[static_cast<size_t>(yy) * w + x];
          const int8_t green = static_cast<int8_t>(argb >> 8);
          int new_red = (argb >> 16) & 0xff;
          int new_blue = argb & 0xff;
          new_red += (static_cast<int>(g2r) * green) >> 5;
          new_red &= 0xff;
          new_blue += (static_cast<int>(g2b) * green) >> 5;
          new_blue += (static_cast<int>(r2b) * static_cast<int8_t>(new_red)) >> 5;
          new_blue &= 0xff;
          out[static_cast<size_t>(yy) * w + x] =
              (argb & 0xff00ff00u) | (static_cast<uint32_t>(new_red) << 16) | new_blue;
        }
      }
      break;
    }
    case SUBTRACT_GREEN:
      for (size_t i = 0; i < out.size(); ++i) {
        const uint32_t argb = in[i];
        const uint32_t green = (argb >> 8) & 0xff;
        uint32_t red_blue = argb & 0x00ff00ffu;
        red_blue += (green << 16) | green;
        out[i] = (argb & 0xff00ff00u) | (red_blue & 0x00ff00ffu);
      }
      break;
    default: {  // COLOR_INDEXING
      const int bits_per_pixel = 8 >> t.bits;
      const int packed_w = subsample(w, t.bits);
      const uint32_t mask = (1u << bits_per_pixel) - 1;
      for (int yy = 0; yy < h; ++yy) {
        const uint32_t* src = &in[static_cast<size_t>(yy) * packed_w];
        uint32_t* dst = &out[static_cast<size_t>(yy) * w];
        uint32_t packed = 0;
        for (int x = 0; x < w; ++x) {
          if ((x & ((1 << t.bits) - 1)) == 0) packed = (*src++ >> 8) & 0xff;
          dst[x] = t.data[packed & mask];
          packed >>= bits_per_pixel;
        }
      }
      break;
    }
  }
}

// a level-0 VP8L image of w x h (the header read by the caller): ARGB
std::vector<uint32_t> vp8l_image(Vp8l& d, int w, int h) {
  std::vector<uint32_t> px = d.decode_stream(w, h, true);
  std::vector<uint32_t> tmp;
  for (int n = d.ntr - 1; n >= 0; --n) {
    inverse_transform(d.tr[n], px, tmp);
    px.swap(tmp);
  }
  return px;
}

void vp8l_header(Vp8l& d, const uint8_t* data, size_t size, int* w, int* h, int* alpha) {
  if (size < 5) corrupt("truncated VP8L header");
  if (data[0] != 0x2f) corrupt("bad VP8L signature");
  if ((data[4] >> 5) != 0) corrupt("VP8L version " + std::to_string(data[4] >> 5));
  d.br.init(data, size);
  d.br.read(8);
  *w = d.br.read(14) + 1;
  *h = d.br.read(14) + 1;
  *alpha = d.br.read(1);
  d.br.read(3);
}

// the unfilters of an ALPH plane, row by row in place
void unfilter_alpha(int filter, uint8_t* a, int w, int h) {
  const uint8_t* prev = nullptr;
  for (int r = 0; r < h; ++r, prev = a, a += w) {
    if (filter == 0) continue;
    if (filter == 1 || prev == nullptr) {  // horizontal, and every first row
      uint8_t pred = prev == nullptr ? 0 : prev[0];
      for (int i = 0; i < w; ++i) pred = a[i] = static_cast<uint8_t>(pred + a[i]);
    } else if (filter == 2) {  // vertical
      for (int i = 0; i < w; ++i) a[i] = static_cast<uint8_t>(prev[i] + a[i]);
    } else {  // gradient
      uint8_t top = prev[0], top_left = top, left = top;
      for (int i = 0; i < w; ++i) {
        top = prev[i];
        const int g = left + top - top_left;
        left = static_cast<uint8_t>(a[i] + ((g & ~0xff) == 0 ? g : g < 0 ? 0 : 255));
        top_left = top;
        a[i] = left;
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

// The VP8 frame's width and height, checked as libwebp's VP8GetInfo does.
int wp_vp8_info(const uint8_t* buf, size_t len, int* w, int* h, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    if (len < 10) corrupt("truncated VP8 frame header");
    if (buf[3] != 0x9d || buf[4] != 0x01 || buf[5] != 0x2a) corrupt("bad VP8 start code");
    const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
    if (bits & 1) corrupt("VP8 stream does not start with a key frame");
    if (((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) || (bits >> 5) >= len)
      corrupt("inconsistent VP8 frame header");
    *w = ((buf[7] << 8) | buf[6]) & 0x3fff;
    *h = ((buf[9] << 8) | buf[8]) & 0x3fff;
    if (*w == 0 || *h == 0) corrupt("VP8 frame of size 0");
  });
}

// A VP8 key frame into RGBA [h, w, 4] (alpha 255), w x h its own.
int wp_vp8_decode(const uint8_t* buf, size_t len, int w, int h, uint8_t* rgba, char* err,
                  int errlen) {
  return guarded(err, errlen, [&] {
    Vp8 d;
    d.decode(buf, len);
    if (d.width != w || d.height != h) corrupt("VP8 frame size changed");
    vp8_to_rgba(d, rgba);
  });
}

// The VP8L header: width, height and the alpha hint.
int wp_vp8l_info(const uint8_t* buf, size_t len, int* w, int* h, int* alpha, char* err,
                 int errlen) {
  return guarded(err, errlen, [&] {
    Vp8l d;
    vp8l_header(d, buf, len, w, h, alpha);
  });
}

// A VP8L image into RGBA [h, w, 4], every alpha as stored.
int wp_vp8l_decode(const uint8_t* buf, size_t len, int w, int h, uint8_t* rgba, char* err,
                   int errlen) {
  return guarded(err, errlen, [&] {
    Vp8l d;
    int iw, ih, alpha;
    vp8l_header(d, buf, len, &iw, &ih, &alpha);
    if (iw != w || ih != h) corrupt("VP8L image size changed");
    const std::vector<uint32_t> px = vp8l_image(d, w, h);
    for (size_t i = 0; i < px.size(); ++i) {
      const uint32_t p = px[i];
      rgba[4 * i] = (p >> 16) & 0xff;
      rgba[4 * i + 1] = (p >> 8) & 0xff;
      rgba[4 * i + 2] = p & 0xff;
      rgba[4 * i + 3] = p >> 24;
    }
  });
}

// An ALPH chunk's payload into the alpha plane [h, w] of a w x h frame.
int wp_alpha_decode(const uint8_t* buf, size_t len, int w, int h, uint8_t* alpha, char* err,
                    int errlen) {
  return guarded(err, errlen, [&] {
    if (len <= 1) corrupt("empty ALPH chunk");
    const int method = buf[0] & 3, filter = (buf[0] >> 2) & 3;
    const int pre = (buf[0] >> 4) & 3, rsrv = (buf[0] >> 6) & 3;
    if (method > 1 || pre > 1 || rsrv != 0) corrupt("bad ALPH header");
    const size_t n = static_cast<size_t>(w) * h;
    if (method == 0) {
      if (len - 1 < n) corrupt("truncated ALPH data");
      std::memcpy(alpha, buf + 1, n);
    } else {
      Vp8l d;
      d.tolerate_final_eos = true;
      d.br.init(buf + 1, len - 1);
      const std::vector<uint32_t> px = vp8l_image(d, w, h);
      for (size_t i = 0; i < n; ++i) alpha[i] = (px[i] >> 8) & 0xff;
    }
    unfilter_alpha(filter, alpha, w, h);
  });
}

}  // extern "C"
