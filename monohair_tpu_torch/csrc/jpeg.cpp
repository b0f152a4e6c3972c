// Baseline JPEG codec on the host: the port's counterpart of the libjpeg that
// OpenCV reads and writes JPEG captures with (cv2.imread / cv2.imwrite in the
// JAX package). Built by monohair_tpu_torch/ops/_build.py (g++), called
// through ctypes by monohair_tpu_torch/io/jpeg.py.
//
// Parity with OpenCV means libjpeg-turbo's own rules, written out here:
// - decode: sequential Huffman (SOF0, and SOF1 at 8 bits), any number of
//   scans; the integer IDCT (jidctint.c, "islow"), clamped to 0..255;
//   "fancy" triangle upsampling for h2v1, h1v2 and h2v2 chroma when the
//   component is more than 2 samples wide (jdsample.c), replication otherwise;
//   the 16-bit fixed-point YCbCr->RGB tables (jdcolor.c); restart intervals.
//   A grayscale read of a YCbCr file is its Y plane, as libjpeg's
//   JCS_GRAYSCALE output is. Progressive, arithmetic-coded, lossless,
//   hierarchical, 12-bit and CMYK files are refused by name (error code 2).
// - encode: the fixed-point RGB->YCbCr tables (jccolor.c), the h2v1/h2v2
//   downsamplers with their alternating rounding bias (jcsample.c), edge
//   replication to whole blocks (jcprep.c), the integer forward DCT
//   (jfdctint.c), quantisation by reciprocal (jcdctmgr.c), the standard
//   tables scaled by jpeg_quality_scaling (jcparam.c), the standard Huffman
//   tables, dummy blocks at the right and bottom edges (jccoefct.c), and the
//   marker layout of jcmarker.c (JFIF APP0, one DQT and one DHT segment per
//   table, optional DRI). A file written here is byte for byte the file
//   cv2.imwrite writes at the same quality and sampling.
//
// Huffman coding is serial within a scan, so this stays on the host, as it is
// in the JAX package.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries so that a corrupt run past 63 lands on a harmless slot
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

const int kStdLuminanceQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kStdChrominanceQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// The standard Huffman tables (JPEG Annex K.3): code counts per length 1..16
// and the symbols in code order.
const uint8_t kDcLumBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcLumVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kDcChromBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcChromVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// Error codes of the C interface: 1 a malformed file or bad argument, 2 a
// valid JPEG of a kind this codec does not take.
struct Error {
  int code;
  std::string msg;
};

inline uint8_t clamp255(int x) { return (uint8_t)(x < 0 ? 0 : (x > 255 ? 255 : x)); }

// ---------------------------------------------------------------------------
// integer DCTs (jfdctint.c / jidctint.c), CONST_BITS 13, PASS1_BITS 2
// ---------------------------------------------------------------------------
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t F_0_298 = 2446, F_0_390 = 3196, F_0_541 = 4433, F_0_765 = 6270,
                  F_0_899 = 7373, F_1_175 = 9633, F_1_501 = 12299, F_1_847 = 15137,
                  F_1_961 = 16069, F_2_053 = 16819, F_2_562 = 20995, F_3_072 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

// In place on 64 level-shifted samples (row-major); leaves the results scaled
// up by 8, as jpeg_fdct_islow does.
void fdct_islow(int32_t* data) {
  for (int r = 0; r < 8; ++r) {
    int32_t* d = data + 8 * r;
    int32_t tmp0 = d[0] + d[7], tmp7 = d[0] - d[7];
    int32_t tmp1 = d[1] + d[6], tmp6 = d[1] - d[6];
    int32_t tmp2 = d[2] + d[5], tmp5 = d[2] - d[5];
    int32_t tmp3 = d[3] + d[4], tmp4 = d[3] - d[4];
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    d[0] = (tmp10 + tmp11) * (1 << kPass1Bits);
    d[4] = (tmp10 - tmp11) * (1 << kPass1Bits);
    int32_t z1 = (tmp12 + tmp13) * F_0_541;
    d[2] = descale(z1 + tmp13 * F_0_765, kConstBits - kPass1Bits);
    d[6] = descale(z1 + tmp12 * -F_1_847, kConstBits - kPass1Bits);
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * F_1_175;
    tmp4 *= F_0_298;
    tmp5 *= F_2_053;
    tmp6 *= F_3_072;
    tmp7 *= F_1_501;
    z1 *= -F_0_899;
    z2 *= -F_2_562;
    z3 *= -F_1_961;
    z4 *= -F_0_390;
    z3 += z5;
    z4 += z5;
    d[7] = descale(tmp4 + z1 + z3, kConstBits - kPass1Bits);
    d[5] = descale(tmp5 + z2 + z4, kConstBits - kPass1Bits);
    d[3] = descale(tmp6 + z2 + z3, kConstBits - kPass1Bits);
    d[1] = descale(tmp7 + z1 + z4, kConstBits - kPass1Bits);
  }
  for (int c = 0; c < 8; ++c) {
    int32_t* d = data + c;
    int32_t tmp0 = d[0] + d[56], tmp7 = d[0] - d[56];
    int32_t tmp1 = d[8] + d[48], tmp6 = d[8] - d[48];
    int32_t tmp2 = d[16] + d[40], tmp5 = d[16] - d[40];
    int32_t tmp3 = d[24] + d[32], tmp4 = d[24] - d[32];
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    d[0] = descale(tmp10 + tmp11, kPass1Bits);
    d[32] = descale(tmp10 - tmp11, kPass1Bits);
    int32_t z1 = (tmp12 + tmp13) * F_0_541;
    d[16] = descale(z1 + tmp13 * F_0_765, kConstBits + kPass1Bits);
    d[48] = descale(z1 + tmp12 * -F_1_847, kConstBits + kPass1Bits);
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * F_1_175;
    tmp4 *= F_0_298;
    tmp5 *= F_2_053;
    tmp6 *= F_3_072;
    tmp7 *= F_1_501;
    z1 *= -F_0_899;
    z2 *= -F_2_562;
    z3 *= -F_1_961;
    z4 *= -F_0_390;
    z3 += z5;
    z4 += z5;
    d[56] = descale(tmp4 + z1 + z3, kConstBits + kPass1Bits);
    d[40] = descale(tmp5 + z2 + z4, kConstBits + kPass1Bits);
    d[24] = descale(tmp6 + z2 + z3, kConstBits + kPass1Bits);
    d[8] = descale(tmp7 + z1 + z4, kConstBits + kPass1Bits);
  }
}

// The odd/even butterflies shared by both passes of the inverse DCT: in[k] is
// the k-th input of the 1-D transform, out[k] its undescaled k-th output.
inline void idct_1d(int32_t i0, int32_t i1, int32_t i2, int32_t i3, int32_t i4,
                    int32_t i5, int32_t i6, int32_t i7, int32_t* out) {
  int32_t z1 = (i2 + i6) * F_0_541;
  int32_t tmp2 = z1 + i6 * -F_1_847;
  int32_t tmp3 = z1 + i2 * F_0_765;
  int32_t tmp0 = (i0 + i4) * (1 << kConstBits);
  int32_t tmp1 = (i0 - i4) * (1 << kConstBits);
  int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  tmp0 = i7;
  tmp1 = i5;
  tmp2 = i3;
  tmp3 = i1;
  z1 = tmp0 + tmp3;
  int32_t z2 = tmp1 + tmp2, z3 = tmp0 + tmp2, z4 = tmp1 + tmp3;
  int32_t z5 = (z3 + z4) * F_1_175;
  tmp0 *= F_0_298;
  tmp1 *= F_2_053;
  tmp2 *= F_3_072;
  tmp3 *= F_1_501;
  z1 *= -F_0_899;
  z2 *= -F_2_562;
  z3 *= -F_1_961;
  z4 *= -F_0_390;
  z3 += z5;
  z4 += z5;
  tmp0 += z1 + z3;
  tmp1 += z2 + z4;
  tmp2 += z2 + z3;
  tmp3 += z1 + z4;
  out[0] = tmp10 + tmp3;
  out[7] = tmp10 - tmp3;
  out[1] = tmp11 + tmp2;
  out[6] = tmp11 - tmp2;
  out[2] = tmp12 + tmp1;
  out[5] = tmp12 - tmp1;
  out[3] = tmp13 + tmp0;
  out[4] = tmp13 - tmp0;
}

// jpeg_idct_islow: 64 quantised coefficients (natural order) and their
// quantisation table -> an 8x8 block of samples at `out` with row stride
// `stride`. The all-zero-AC shortcuts of both passes give the same values as
// the full butterflies, and are kept for speed.
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qc = q + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
      int32_t dc = (int32_t)in[0] * qc[0] * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = dc;
      continue;
    }
    int32_t o[8];
    idct_1d(in[0] * qc[0], in[8] * qc[8], in[16] * qc[16], in[24] * qc[24],
            in[32] * qc[32], in[40] * qc[40], in[48] * qc[48], in[56] * qc[56], o);
    for (int r = 0; r < 8; ++r) ws[8 * r + c] = descale(o[r], kConstBits - kPass1Bits);
  }
  const int shift = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + 8 * r;
    uint8_t* dst = out + (size_t)r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = clamp255(descale(w[0], kPass1Bits + 3) + 128);
      for (int c = 0; c < 8; ++c) dst[c] = v;
      continue;
    }
    int32_t o[8];
    idct_1d(w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], o);
    for (int c = 0; c < 8; ++c) dst[c] = clamp255(descale(o[c], shift) + 128);
  }
}

// ---------------------------------------------------------------------------
// colour tables (jdcolor.c / jccolor.c), SCALEBITS 16
// ---------------------------------------------------------------------------
constexpr int kScale = 16;
constexpr int32_t kHalf = 1 << (kScale - 1);
inline int32_t fix(double x) { return (int32_t)(x * (1 << kScale) + 0.5); }

struct YccToRgb {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccToRgb() {
    for (int i = 0; i < 256; ++i) {
      int x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = (int)((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
};

struct RgbToYcc {
  int32_t t[8][256];  // R_Y, G_Y, B_Y, R_CB, G_CB, B_CB (= R_CR), G_CR, B_CR
  RgbToYcc() {
    for (int i = 0; i < 256; ++i) {
      t[0][i] = fix(0.29900) * i;
      t[1][i] = fix(0.58700) * i;
      t[2][i] = fix(0.11400) * i + kHalf;
      t[3][i] = -fix(0.16874) * i;
      t[4][i] = -fix(0.33126) * i;
      // the rounding fudge 0.5 - epsilon keeps Cb and Cr within 0..255
      t[5][i] = fix(0.50000) * i + (128 << kScale) + kHalf - 1;
      t[6][i] = -fix(0.41869) * i;
      t[7][i] = -fix(0.08131) * i;
    }
  }
  uint8_t y(int r, int g, int b) const { return (uint8_t)((t[0][r] + t[1][g] + t[2][b]) >> kScale); }
  uint8_t cb(int r, int g, int b) const { return (uint8_t)((t[3][r] + t[4][g] + t[5][b]) >> kScale); }
  uint8_t cr(int r, int g, int b) const { return (uint8_t)((t[5][r] + t[6][g] + t[7][b]) >> kScale); }
};

const YccToRgb& ycc_to_rgb() {
  static const YccToRgb t;
  return t;
}
const RgbToYcc& rgb_to_ycc() {
  static const RgbToYcc t;
  return t;
}

// ---------------------------------------------------------------------------
// decoder
// ---------------------------------------------------------------------------
struct Huffman {
  // fast path: the next 9 bits -> (code length << 8 | symbol), 0 if longer
  uint16_t look[512];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  bool defined = false;

  void build(const uint8_t* bits, const uint8_t* v, int nvals) {
    memcpy(vals, v, nvals);
    memset(look, 0, sizeof(look));
    int code = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
      valoffset[len] = k - code;
      for (int i = 0; i < bits[len - 1]; ++i, ++k, ++code) {
        if (len <= 9) {
          int shift = 9 - len;
          for (int f = 0; f < (1 << shift); ++f)
            look[(code << shift) | f] = (uint16_t)((len << 8) | vals[k]);
        }
      }
      maxcode[len] = bits[len - 1] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
  }
};

struct Component {
  int id, h, v, tq;
  int dw, dh;            // downsampled width and height in samples
  int bw, bh;            // blocks per row and column of the MCU-padded plane
  std::vector<int16_t> coef;
  uint16_t q[64];        // latched at the component's first scan
  bool q_latched = false;
  std::vector<uint8_t> plane;  // bw*8 x bh*8 samples after the IDCT
};

struct Decoder {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0, maxh = 1, maxv = 1;
  int restart_interval = 0;
  int orientation = 1;
  bool seen_sof = false, seen_jfif = false, seen_adobe = false;
  int adobe_transform = -1;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  std::vector<Component> comps;

  // bit reader over entropy-coded data
  uint64_t bitbuf = 0;
  int bitcnt = 0;
  bool hit_marker = false;

  Decoder(const uint8_t* d, size_t len) : data(d), n(len) {}

  uint8_t byte() {
    if (pos >= n) throw Error{1, "JPEG ends early"};
    return data[pos++];
  }
  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  void fill() {
    while (bitcnt <= 56) {
      int b = 0;
      if (!hit_marker && pos < n) {
        b = data[pos];
        if (b == 0xFF) {
          int nxt = pos + 1 < n ? data[pos + 1] : 0xD9;
          if (nxt == 0x00) {
            pos += 2;
          } else {
            hit_marker = true;  // leave the marker for the caller; feed zeros
            b = 0;
          }
        } else {
          ++pos;
        }
      }
      bitbuf |= (uint64_t)b << (56 - bitcnt);
      bitcnt += 8;
    }
  }
  int get_bits(int s) {
    if (s == 0) return 0;
    if (bitcnt < s) fill();
    int v = (int)(bitbuf >> (64 - s));
    bitbuf <<= s;
    bitcnt -= s;
    return v;
  }
  int decode(const Huffman& h) {
    if (bitcnt < 16) fill();
    int peek = (int)(bitbuf >> (64 - 9));
    uint16_t e = h.look[peek];
    if (e) {
      int len = e >> 8;
      bitbuf <<= len;
      bitcnt -= len;
      return e & 0xFF;
    }
    int code = (int)(bitbuf >> (64 - 10));
    int len = 10;
    while (len <= 16 && code > h.maxcode[len]) {
      ++len;
      code = (int)(bitbuf >> (64 - len));
    }
    if (len > 16) throw Error{1, "corrupt JPEG data: bad Huffman code"};
    bitbuf <<= len;
    bitcnt -= len;
    return h.vals[(h.valoffset[len] + code) & 0xFF];
  }
  static int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

  void decode_block(int16_t* blk, const Huffman& dct, const Huffman& act, int& pred) {
    int s = decode(dct);
    if (s > 15) throw Error{1, "corrupt JPEG data: DC magnitude above 15 bits"};
    int diff = s ? extend(get_bits(s), s) : 0;
    pred += diff;
    blk[0] = (int16_t)pred;
    for (int k = 1; k < 64; ++k) {
      int rs = decode(act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)extend(get_bits(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // after restart_interval MCUs: drop the bits left, read RSTn, reset the
  // predictors (the caller does that)
  void restart() {
    bitbuf = 0;
    bitcnt = 0;
    hit_marker = false;
    while (pos + 1 < n && !(data[pos] == 0xFF && data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7))
      ++pos;
    if (pos + 1 >= n) throw Error{1, "corrupt JPEG data: missing restart marker"};
    pos += 2;
  }

  void read_sof(int marker) {
    if (marker == 0xC2 || marker == 0xC6 || marker == 0xCA || marker == 0xCE)
      throw Error{2, "progressive JPEG (SOF" + std::to_string(marker - 0xC0) +
                         ") is not supported: baseline sequential only"};
    if (marker == 0xC3 || marker == 0xC7 || marker == 0xCB || marker == 0xCF)
      throw Error{2, "lossless JPEG (SOF" + std::to_string(marker - 0xC0) +
                         ") is not supported: baseline sequential only"};
    if (marker >= 0xC9)
      throw Error{2, "arithmetic-coded JPEG (SOF" + std::to_string(marker - 0xC0) +
                         ") is not supported: Huffman coding only"};
    if (marker == 0xC5)
      throw Error{2, "hierarchical JPEG (SOF5) is not supported: baseline sequential only"};
    if (seen_sof) throw Error{1, "JPEG with two frame headers"};
    seen_sof = true;
    int len = u16();
    int prec = byte();
    if (prec != 8)
      throw Error{2, std::to_string(prec) + "-bit JPEG is not supported: 8-bit samples only"};
    height = u16();
    width = u16();
    ncomp = byte();
    if (height == 0) throw Error{2, "JPEG with a DNL-defined height is not supported"};
    if (width == 0 || len != 8 + 3 * ncomp) throw Error{1, "bad JPEG frame header"};
    if (ncomp != 1 && ncomp != 3)
      throw Error{2, std::to_string(ncomp) +
                         "-component JPEG (CMYK or other) is not supported: gray or YCbCr only"};
    comps.resize(ncomp);
    for (auto& c : comps) {
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        throw Error{1, "bad JPEG sampling factors or table number"};
      maxh = std::max(maxh, c.h);
      maxv = std::max(maxv, c.v);
    }
    int mcux = (width + 8 * maxh - 1) / (8 * maxh);
    int mcuy = (height + 8 * maxv - 1) / (8 * maxv);
    for (auto& c : comps) {
      c.dw = (int)(((int64_t)width * c.h + maxh - 1) / maxh);
      c.dh = (int)(((int64_t)height * c.v + maxv - 1) / maxv);
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }
  }

  void read_dqt() {
    int len = u16() - 2;
    while (len > 0) {
      int pq = byte();
      int tq = pq & 15;
      if (tq > 3) throw Error{1, "bad JPEG quantisation table number"};
      for (int k = 0; k < 64; ++k) qt[tq][kNatural[k]] = (uint16_t)((pq >> 4) ? u16() : byte());
      qt_defined[tq] = true;
      len -= 1 + ((pq >> 4) ? 128 : 64);
    }
  }

  void read_dht() {
    int len = u16() - 2;
    while (len > 0) {
      int tc = byte();
      uint8_t bits[16], vals[256];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += bits[i] = byte();
      if (total > 256 || (tc & 15) > 3 || (tc >> 4) > 1) throw Error{1, "bad JPEG Huffman table"};
      for (int i = 0; i < total; ++i) vals[i] = byte();
      ((tc >> 4) ? ac : dc)[tc & 15].build(bits, vals, total);
      len -= 17 + total;
    }
  }

  // APP1 "Exif": the orientation tag (0x0112) of IFD0, as OpenCV reads it
  void read_exif(size_t beg, size_t end) {
    if (end - beg < 14 || memcmp(data + beg, "Exif\0\0", 6) != 0) return;
    const uint8_t* t = data + beg + 6;
    size_t tn = end - beg - 6;
    bool le = t[0] == 'I' && t[1] == 'I';
    if (!le && !(t[0] == 'M' && t[1] == 'M')) return;
    auto rd16 = [&](size_t o) -> int {
      return le ? (t[o] | (t[o + 1] << 8)) : ((t[o] << 8) | t[o + 1]);
    };
    auto rd32 = [&](size_t o) -> uint32_t {
      return le ? (uint32_t)(t[o] | (t[o + 1] << 8) | (t[o + 2] << 16) | ((uint32_t)t[o + 3] << 24))
                : (uint32_t)(((uint32_t)t[o] << 24) | (t[o + 1] << 16) | (t[o + 2] << 8) | t[o + 3]);
    };
    uint32_t ifd = rd32(4);
    if ((size_t)ifd + 2 > tn) return;
    int count = rd16(ifd);
    for (int i = 0; i < count; ++i) {
      size_t e = ifd + 2 + 12 * (size_t)i;
      if (e + 12 > tn) return;
      if (rd16(e) == 0x0112) {
        orientation = rd16(e + 8);
        return;
      }
    }
  }

  // markers up to and including the first SOS; returns false at EOI
  bool read_markers() {
    for (;;) {
      int b = byte();
      if (b != 0xFF) throw Error{1, "corrupt JPEG data: expected a marker"};
      int m = byte();
      while (m == 0xFF) m = byte();
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      if (m == 0xD9) return false;
      if (m == 0xDA) return true;
      if (m == 0xDB) {
        read_dqt();
      } else if (m == 0xC4) {
        read_dht();
      } else if (m == 0xCC) {
        throw Error{2, "arithmetic-coded JPEG (DAC) is not supported: Huffman coding only"};
      } else if (m >= 0xC0 && m <= 0xCF && m != 0xC8) {
        read_sof(m);
      } else if (m == 0xDD) {
        u16();
        restart_interval = u16();
      } else if (m == 0xDC) {
        throw Error{2, "JPEG with a DNL marker is not supported"};
      } else {
        size_t len = (size_t)u16();
        if (len < 2 || pos + len - 2 > n) throw Error{1, "corrupt JPEG marker length"};
        size_t beg = pos, end = pos + len - 2;
        if (m == 0xE0 && len >= 7 && memcmp(data + beg, "JFIF\0", 5) == 0) seen_jfif = true;
        if (m == 0xE1 && orientation == 1) read_exif(beg, end);
        if (m == 0xEE && len >= 14 && memcmp(data + beg, "Adobe", 5) == 0) {
          seen_adobe = true;
          adobe_transform = data[beg + 11];
        }
        pos = end;
      }
    }
  }

  void read_scan() {
    int len = u16();
    int ns = byte();
    if (!seen_sof) throw Error{1, "JPEG scan before the frame header"};
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) throw Error{1, "bad JPEG scan header"};
    Component* sc[4];
    int td[4], ta[4];
    for (int i = 0; i < ns; ++i) {
      int cid = byte(), t = byte();
      sc[i] = nullptr;
      for (auto& c : comps)
        if (c.id == cid) sc[i] = &c;
      if (!sc[i]) throw Error{1, "JPEG scan names an unknown component"};
      td[i] = t >> 4;
      ta[i] = t & 15;
      if (td[i] > 3 || ta[i] > 3 || !dc[td[i]].defined || !ac[ta[i]].defined)
        throw Error{1, "JPEG scan uses an undefined Huffman table"};
      if (!sc[i]->q_latched) {
        if (!qt_defined[sc[i]->tq]) throw Error{1, "JPEG component uses an undefined quantisation table"};
        memcpy(sc[i]->q, qt[sc[i]->tq], sizeof(sc[i]->q));
        sc[i]->q_latched = true;
      }
    }
    int ss = byte(), se = byte(), ahal = byte();
    if (ss != 0 || se != 63 || ahal != 0) throw Error{1, "bad JPEG spectral selection in a sequential scan"};

    bitbuf = 0;
    bitcnt = 0;
    hit_marker = false;
    int pred[4] = {0, 0, 0, 0};
    int64_t mcus, mcux;
    if (ns == 1) {
      mcux = (sc[0]->dw + 7) / 8;
      mcus = mcux * ((sc[0]->dh + 7) / 8);
    } else {
      mcux = (width + 8 * maxh - 1) / (8 * maxh);
      mcus = mcux * ((height + 8 * maxv - 1) / (8 * maxv));
    }
    int togo = restart_interval;
    for (int64_t m = 0; m < mcus; ++m) {
      if (restart_interval && togo == 0) {
        restart();
        togo = restart_interval;
        for (int& p : pred) p = 0;
      }
      int64_t my = m / mcux, mx = m % mcux;
      for (int i = 0; i < ns; ++i) {
        Component& c = *sc[i];
        int nh = ns == 1 ? 1 : c.h, nv = ns == 1 ? 1 : c.v;
        for (int y = 0; y < nv; ++y)
          for (int x = 0; x < nh; ++x) {
            int64_t by = my * nv + y, bx = mx * nh + x;
            decode_block(&c.coef[((size_t)by * c.bw + bx) * 64], dc[td[i]], ac[ta[i]], pred[i]);
          }
      }
      if (restart_interval) --togo;
    }
    // skip to the next marker (a scan may be followed by padding)
    while (pos + 1 < n && !(data[pos] == 0xFF && data[pos + 1] != 0 &&
                            !(data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7)))
      ++pos;
  }

  void parse() {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) throw Error{1, "not a JPEG file"};
    pos = 2;
    bool any_scan = false;
    while (read_markers()) {
      read_scan();
      any_scan = true;
    }
    if (!seen_sof || !any_scan) throw Error{1, "JPEG without a frame or a scan"};
  }

  void header_only() {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) throw Error{1, "not a JPEG file"};
    pos = 2;
    if (!read_markers() || !seen_sof) throw Error{1, "JPEG without a frame or a scan"};
  }

  bool is_rgb() const {
    // jdapimin.c default_decompress_parms for three components
    if (seen_jfif) return false;
    if (seen_adobe) return adobe_transform == 0;
    return comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
  }

  void idct(Component& c) {
    size_t stride = (size_t)c.bw * 8;
    c.plane.assign(stride * c.bh * 8, 0);
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], c.q,
                   &c.plane[(size_t)by * 8 * stride + (size_t)bx * 8], (int)stride);
  }

  // One component upsampled to width x height (jdsample.c): rows and columns
  // past the downsampled size repeat the last real one.
  std::vector<uint8_t> upsample(const Component& c) const {
    const size_t stride = (size_t)c.bw * 8;
    auto at = [&](int r, int col) -> int {
      r = std::min(std::max(r, 0), c.dh - 1);
      return c.plane[(size_t)r * stride + col];
    };
    std::vector<uint8_t> out((size_t)width * height);
    const int W = width, H = height, dw = c.dw;
    if (c.h == maxh && c.v == maxv) {
      for (int y = 0; y < H; ++y) memcpy(&out[(size_t)y * W], &c.plane[(size_t)y * stride], W);
      return out;
    }
    std::vector<int> row(2 * (size_t)dw + 2);
    if (c.h * 2 == maxh && c.v * 2 == maxv && dw > 2) {  // h2v2 fancy
      std::vector<int> sum(dw);
      for (int y = 0; y < H; ++y) {
        int r = y / 2;
        int far = (y & 1) ? r + 1 : r - 1;
        for (int x = 0; x < dw; ++x) sum[x] = at(r, x) * 3 + at(far, x);
        uint8_t* o = &out[(size_t)y * W];
        row[0] = (sum[0] * 4 + 8) >> 4;
        row[1] = (sum[0] * 3 + sum[1] + 7) >> 4;
        for (int x = 1; x < dw - 1; ++x) {
          row[2 * x] = (sum[x] * 3 + sum[x - 1] + 8) >> 4;
          row[2 * x + 1] = (sum[x] * 3 + sum[x + 1] + 7) >> 4;
        }
        row[2 * dw - 2] = (sum[dw - 1] * 3 + sum[dw - 2] + 8) >> 4;
        row[2 * dw - 1] = (sum[dw - 1] * 4 + 7) >> 4;
        for (int x = 0; x < W; ++x) o[x] = (uint8_t)row[x];
      }
      return out;
    }
    if (c.h * 2 == maxh && c.v == maxv && dw > 2) {  // h2v1 fancy
      for (int y = 0; y < H; ++y) {
        const uint8_t* in = &c.plane[(size_t)y * stride];
        row[0] = in[0];
        row[1] = (in[0] * 3 + in[1] + 2) >> 2;
        for (int x = 1; x < dw - 1; ++x) {
          row[2 * x] = (in[x] * 3 + in[x - 1] + 1) >> 2;
          row[2 * x + 1] = (in[x] * 3 + in[x + 1] + 2) >> 2;
        }
        row[2 * dw - 2] = (in[dw - 1] * 3 + in[dw - 2] + 1) >> 2;
        row[2 * dw - 1] = in[dw - 1];
        uint8_t* o = &out[(size_t)y * W];
        for (int x = 0; x < W; ++x) o[x] = (uint8_t)row[x];
      }
      return out;
    }
    if (c.h == maxh && c.v * 2 == maxv) {  // h1v2 fancy
      for (int y = 0; y < H; ++y) {
        int r = y / 2;
        int far = (y & 1) ? r + 1 : r - 1;
        int bias = (y & 1) ? 2 : 1;
        uint8_t* o = &out[(size_t)y * W];
        for (int x = 0; x < W; ++x) o[x] = (uint8_t)((at(r, x) * 3 + at(far, x) + bias) >> 2);
      }
      return out;
    }
    if (maxh % c.h || maxv % c.v)
      throw Error{2, "JPEG with non-integral sampling ratios is not supported"};
    const int fh = maxh / c.h, fv = maxv / c.v;  // replication (int_upsample)
    for (int y = 0; y < H; ++y) {
      uint8_t* o = &out[(size_t)y * W];
      const uint8_t* in = &c.plane[(size_t)(y / fv) * stride];
      for (int x = 0; x < W; ++x) o[x] = in[x / fh];
    }
    return out;
  }

  void output(uint8_t* out, bool gray) {
    if (ncomp == 1 || (gray && !is_rgb())) {
      idct(comps[0]);
      std::vector<uint8_t> y = upsample(comps[0]);
      const size_t np = (size_t)width * height;
      if (gray) {
        memcpy(out, y.data(), np);
      } else {
        for (size_t i = 0; i < np; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
      }
      return;
    }
    std::vector<uint8_t> p[3];
    for (int i = 0; i < 3; ++i) {
      idct(comps[i]);
      p[i] = upsample(comps[i]);
    }
    const size_t np = (size_t)width * height;
    if (is_rgb()) {
      const RgbToYcc& t = rgb_to_ycc();
      for (size_t i = 0; i < np; ++i) {
        if (gray) {
          out[i] = t.y(p[0][i], p[1][i], p[2][i]);
        } else {
          out[3 * i] = p[0][i];
          out[3 * i + 1] = p[1][i];
          out[3 * i + 2] = p[2][i];
        }
      }
      return;
    }
    const YccToRgb& t = ycc_to_rgb();
    for (size_t i = 0; i < np; ++i) {
      int y = p[0][i], cb = p[1][i], cr = p[2][i];
      out[3 * i] = clamp255(y + t.cr_r[cr]);
      out[3 * i + 1] = clamp255(y + (int)((t.cb_g[cb] + t.cr_g[cr]) >> kScale));
      out[3 * i + 2] = clamp255(y + t.cb_b[cb]);
    }
  }
};

// ---------------------------------------------------------------------------
// encoder
// ---------------------------------------------------------------------------
struct HuffCode {
  uint16_t code[256];
  uint8_t size[256];
  void build(const uint8_t* bits, const uint8_t* vals) {
    memset(size, 0, sizeof(size));
    int code_v = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < bits[len - 1]; ++i, ++k) {
        code[vals[k]] = (uint16_t)code_v++;
        size[vals[k]] = (uint8_t)len;
      }
      code_v <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t buf = 0;
  int cnt = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t code, int size) {
    buf = (buf << size) | (code & ((1u << size) - 1));
    cnt += size;
    while (cnt >= 8) {
      uint8_t b = (uint8_t)(buf >> (cnt - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      cnt -= 8;
    }
  }
  void flush() {  // pad with 1 bits to a byte (jchuff.c flush_bits)
    if (cnt > 0) put(0x7F, 8 - cnt);
    buf = 0;
    cnt = 0;
  }
};

inline int nbits(int v) {
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

struct QuantDivisor {
  // jcdctmgr.c compute_reciprocal, for a 16-bit DCTELEM
  uint32_t recip, corr;
  int shift;
  explicit QuantDivisor(uint32_t divisor) {
    int b = 0;
    while ((divisor >> (b + 1)) != 0) ++b;  // flss(divisor) - 1
    int r = 16 + b;
    uint32_t fq = (1u << r) / divisor;
    uint32_t fr = (1u << r) % divisor;
    uint32_t c = divisor / 2;
    if (fr == 0) {
      fq >>= 1;
      --r;
    } else if (fr <= divisor / 2u) {
      ++c;
    } else {
      ++fq;
    }
    recip = fq & 0xFFFF;
    corr = c & 0xFFFF;
    shift = r;
  }
  int quantize(int32_t v) const {
    uint32_t a = (uint32_t)(v < 0 ? -v : v) & 0xFFFF;
    int q = (int)(((a + corr) * recip) >> shift);
    return v < 0 ? -q : q;
  }
};

void scaled_table(const int* base, int quality, int* out) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = ((long)base[i] * scale + 50L) / 100L;
    out[i] = (int)std::min(std::max(t, 1L), 255L);  // force_baseline
  }
}

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back((uint8_t)(v >> 8));
  o.push_back((uint8_t)(v & 0xFF));
}

void encode(const uint8_t* img, int W, int H, int C, int quality, int hs, int vs,
            int restart_interval, std::vector<uint8_t>& out) {
  if (W < 1 || H < 1 || W > 65535 || H > 65535) throw Error{1, "JPEG image size out of range"};
  if (C != 1 && C != 3) throw Error{1, "JPEG takes 1 or 3 channels"};
  if (C == 1) hs = vs = 1;
  if (!((hs == 1 && vs == 1) || (hs == 2 && vs == 1) || (hs == 2 && vs == 2)))
    throw Error{1, "JPEG encoder takes 4:4:4, 4:2:2 or 4:2:0 sampling"};
  int qtab[2][64];
  scaled_table(kStdLuminanceQ, quality, qtab[0]);
  scaled_table(kStdChrominanceQ, quality, qtab[1]);

  // colour conversion into full-size planes
  const int nc = C;
  std::vector<uint8_t> full[3];
  const size_t np = (size_t)W * H;
  for (int c = 0; c < nc; ++c) full[c].resize(np);
  if (C == 1) {
    memcpy(full[0].data(), img, np);
  } else {
    const RgbToYcc& t = rgb_to_ycc();
    for (size_t i = 0; i < np; ++i) {
      int r = img[3 * i], g = img[3 * i + 1], b = img[3 * i + 2];
      full[0][i] = t.y(r, g, b);
      full[1][i] = t.cb(r, g, b);
      full[2][i] = t.cr(r, g, b);
    }
  }

  const int maxh = hs, maxv = vs;
  struct Comp {
    int h, v, tq, wb, hb;  // sampling, table, width/height in blocks
    std::vector<uint8_t> plane;  // wb*8 x hb*8
    std::vector<int16_t> coef;
  } comps[3];
  for (int c = 0; c < nc; ++c) {
    Comp& k = comps[c];
    k.h = c == 0 ? hs : 1;
    k.v = c == 0 ? vs : 1;
    k.tq = c == 0 ? 0 : 1;
    int cw = (W * k.h + maxh - 1) / maxh, ch = (H * k.v + maxv - 1) / maxv;
    k.wb = (cw + 7) / 8;
    k.hb = (ch + 7) / 8;
    const int pw = k.wb * 8, ph = k.hb * 8;
    const int fh = maxh / k.h, fv = maxv / k.v;
    // jcprep.c pads the full-size rows to a multiple of max_v by repeating
    // the last; jcsample.c pads the columns to the blocks' width (times the
    // factor) by repeating the last, then downsamples; jcprep.c then repeats
    // the last downsampled row down to whole blocks
    auto src = [&](int y, int x) -> int {
      return full[c][(size_t)std::min(y, H - 1) * W + std::min(x, W - 1)];
    };
    const int rows_ds = (H + maxv - 1) / maxv * k.v;
    k.plane.resize((size_t)pw * ph);
    for (int y = 0; y < ph; ++y) {
      int yd = std::min(y, rows_ds - 1);
      uint8_t* o = &k.plane[(size_t)y * pw];
      if (fh == 1 && fv == 1) {
        for (int x = 0; x < pw; ++x) o[x] = (uint8_t)src(yd, x);
      } else if (fv == 1) {  // h2v1: bias 0, 1, 0, 1, ...
        for (int x = 0; x < pw; ++x)
          o[x] = (uint8_t)((src(yd, 2 * x) + src(yd, 2 * x + 1) + (x & 1)) >> 1);
      } else {  // h2v2: bias 1, 2, 1, 2, ...
        for (int x = 0; x < pw; ++x)
          o[x] = (uint8_t)((src(2 * yd, 2 * x) + src(2 * yd, 2 * x + 1) + src(2 * yd + 1, 2 * x) +
                            src(2 * yd + 1, 2 * x + 1) + 1 + (x & 1)) >> 2);
      }
    }
    // forward DCT and quantisation of every real block
    std::vector<QuantDivisor> div;
    div.reserve(64);
    for (int i = 0; i < 64; ++i) div.emplace_back((uint32_t)qtab[k.tq][i] << 3);
    k.coef.resize((size_t)k.wb * k.hb * 64);
    int32_t ws[64];
    for (int by = 0; by < k.hb; ++by)
      for (int bx = 0; bx < k.wb; ++bx) {
        for (int r = 0; r < 8; ++r)
          for (int x = 0; x < 8; ++x)
            ws[8 * r + x] = (int32_t)k.plane[(size_t)(by * 8 + r) * pw + bx * 8 + x] - 128;
        fdct_islow(ws);
        int16_t* blk = &k.coef[((size_t)by * k.wb + bx) * 64];
        for (int i = 0; i < 64; ++i) blk[i] = (int16_t)div[i].quantize(ws[i]);
      }
  }

  // markers (jcmarker.c)
  out.clear();
  const uint8_t jfif[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00,
                          0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  out.insert(out.end(), jfif, jfif + sizeof(jfif));
  const int ntables = nc == 1 ? 1 : 2;
  for (int t = 0; t < ntables; ++t) {
    out.push_back(0xFF);
    out.push_back(0xDB);
    put16(out, 67);
    out.push_back((uint8_t)t);
    for (int k = 0; k < 64; ++k) out.push_back((uint8_t)qtab[t][kNatural[k]]);
  }
  out.push_back(0xFF);
  out.push_back(0xC0);
  put16(out, 8 + 3 * nc);
  out.push_back(8);
  put16(out, H);
  put16(out, W);
  out.push_back((uint8_t)nc);
  for (int c = 0; c < nc; ++c) {
    out.push_back((uint8_t)(c + 1));
    out.push_back((uint8_t)((comps[c].h << 4) | comps[c].v));
    out.push_back((uint8_t)comps[c].tq);
  }
  const uint8_t* bits[4] = {kDcLumBits, kAcLumBits, kDcChromBits, kAcChromBits};
  const uint8_t* vals[4] = {kDcLumVals, kAcLumVals, kDcChromVals, kAcChromVals};
  for (int t = 0; t < 2 * ntables; ++t) {
    int total = 0;
    for (int i = 0; i < 16; ++i) total += bits[t][i];
    out.push_back(0xFF);
    out.push_back(0xC4);
    put16(out, 2 + 1 + 16 + total);
    out.push_back((uint8_t)(((t & 1) << 4) | (t >> 1)));
    out.insert(out.end(), bits[t], bits[t] + 16);
    out.insert(out.end(), vals[t], vals[t] + total);
  }
  if (restart_interval) {
    out.push_back(0xFF);
    out.push_back(0xDD);
    put16(out, 4);
    put16(out, restart_interval);
  }
  out.push_back(0xFF);
  out.push_back(0xDA);
  put16(out, 6 + 2 * nc);
  out.push_back((uint8_t)nc);
  for (int c = 0; c < nc; ++c) {
    out.push_back((uint8_t)(c + 1));
    out.push_back(c == 0 ? 0x00 : 0x11);
  }
  out.push_back(0);
  out.push_back(63);
  out.push_back(0);

  // entropy-coded data (jccoefct.c compress_data + jchuff.c encode_one_block)
  HuffCode hdc[2], hac[2];
  hdc[0].build(kDcLumBits, kDcLumVals);
  hac[0].build(kAcLumBits, kAcLumVals);
  hdc[1].build(kDcChromBits, kDcChromVals);
  hac[1].build(kAcChromBits, kAcChromVals);
  BitWriter bw(out);
  int last_dc[3] = {0, 0, 0};
  auto put_block = [&](const int16_t* blk, int c) {
    const int t = comps[c].tq;
    int temp = blk[0] - last_dc[c], temp2 = temp;
    last_dc[c] = blk[0];
    if (temp < 0) {
      temp = -temp;
      --temp2;
    }
    int nb = nbits(temp);
    bw.put(hdc[t].code[nb], hdc[t].size[nb]);
    if (nb) bw.put((uint32_t)temp2, nb);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      temp = blk[kNatural[k]];
      if (temp == 0) {
        ++run;
        continue;
      }
      while (run > 15) {
        bw.put(hac[t].code[0xF0], hac[t].size[0xF0]);
        run -= 16;
      }
      temp2 = temp;
      if (temp < 0) {
        temp = -temp;
        --temp2;
      }
      nb = nbits(temp);
      int sym = (run << 4) + nb;
      bw.put(hac[t].code[sym], hac[t].size[sym]);
      bw.put((uint32_t)temp2, nb);
      run = 0;
    }
    if (run > 0) bw.put(hac[t].code[0], hac[t].size[0]);
  };

  const bool interleaved = nc > 1;
  const int mcux = interleaved ? (W + 8 * maxh - 1) / (8 * maxh) : comps[0].wb;
  const int mcuy = interleaved ? (H + 8 * maxv - 1) / (8 * maxv) : comps[0].hb;
  int togo = restart_interval, next_rst = 0;
  int16_t blk[64];
  int16_t prev_dc = 0;
  for (int my = 0; my < mcuy; ++my)
    for (int mx = 0; mx < mcux; ++mx) {
      if (restart_interval) {
        if (togo == 0) {
          bw.flush();
          out.push_back(0xFF);
          out.push_back((uint8_t)(0xD0 + next_rst));
          next_rst = (next_rst + 1) & 7;
          togo = restart_interval;
          last_dc[0] = last_dc[1] = last_dc[2] = 0;
        }
        --togo;
      }
      for (int c = 0; c < nc; ++c) {
        Comp& k = comps[c];
        const int nh = interleaved ? k.h : 1, nv = interleaved ? k.v : 1;
        for (int y = 0; y < nv; ++y) {
          const int by = my * nv + y;
          for (int x = 0; x < nh; ++x) {
            const int bx = mx * nh + x;
            if (by < k.hb && bx < k.wb) {
              const int16_t* src = &k.coef[((size_t)by * k.wb + bx) * 64];
              put_block(src, c);
              prev_dc = src[0];
            } else {
              // a dummy block: no AC, the DC of the block before it
              // (at the bottom: the last block of the row above)
              memset(blk, 0, sizeof(blk));
              blk[0] = prev_dc;
              put_block(blk, c);
            }
          }
        }
      }
    }
  bw.flush();
  out.push_back(0xFF);
  out.push_back(0xD9);
}

int fail(const Error& e, char* err, int errlen) {
  if (err && errlen > 0) snprintf(err, (size_t)errlen, "%s", e.msg.c_str());
  return e.code;
}

}  // namespace

extern "C" {

// info = {width, height, components, EXIF orientation (1 when absent)}
int jpeg_header(const uint8_t* data, int64_t n, int* info, char* err, int errlen) {
  try {
    Decoder d(data, (size_t)n);
    d.header_only();
    info[0] = d.width;
    info[1] = d.height;
    info[2] = d.ncomp;
    info[3] = d.orientation;
    return 0;
  } catch (const Error& e) {
    return fail(e, err, errlen);
  }
}

// out: height x width x (gray ? 1 : 3) bytes, RGB order
int jpeg_decode(const uint8_t* data, int64_t n, int gray, uint8_t* out, char* err, int errlen) {
  try {
    Decoder d(data, (size_t)n);
    d.parse();
    d.output(out, gray != 0);
    return 0;
  } catch (const Error& e) {
    return fail(e, err, errlen);
  }
}

// img: height x width x channels (1 gray, 3 RGB). Returns the file's size,
// or -(size) when it does not fit in cap bytes, or -1 on an error.
int64_t jpeg_encode(const uint8_t* img, int width, int height, int channels, int quality,
                    int h_samp, int v_samp, int restart_interval, uint8_t* out, int64_t cap,
                    char* err, int errlen) {
  try {
    std::vector<uint8_t> buf;
    encode(img, width, height, channels, quality, h_samp, v_samp, restart_interval, buf);
    if ((int64_t)buf.size() > cap) return -(int64_t)buf.size();
    memcpy(out, buf.data(), buf.size());
    return (int64_t)buf.size();
  } catch (const Error& e) {
    fail(e, err, errlen);
    return -1;
  }
}

}  // extern "C"
