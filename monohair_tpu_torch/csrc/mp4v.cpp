// MPEG-4 Part 2 video ("mp4v" in MP4) on the host: the port's counterpart of
// the FFmpeg that OpenCV reads and writes videos with (cv2.VideoCapture and
// cv2.VideoWriter(..., fourcc "mp4v") in the JAX package). Built by
// monohair_tpu_torch/ops/_build.py (g++), called through ctypes by
// monohair_tpu_torch/io/video.py.
//
// Demuxer: mp4.h's (shared with h264.cpp); the first video track's stsd must
// hold an mp4v sample entry whose esds carries the decoder config
// (VOS/VO/VOL). The frames are rotated by the display matrix as cv2 rotates
// them.
//
// Decoder: ISO/IEC 14496-2 Simple Profile as libavcodec's mpeg4 encoder writes
// it, with libavcodec's reconstruction rules so that the pixels are FFmpeg's:
// - I- and P-VOPs; H.263 or MPEG quantisation (default or loaded matrices);
//   intra_dc_vlc_thr; intra DC/AC prediction with the DC scaler tables (the
//   stored DC clipped to 0..2047, AC rescaled across quantisers); the intra
//   and inter TCOEF VLCs with the three escape modes (the third one's level
//   clipped to -2048..2047 after dequantisation, as libavcodec does); MCBPC,
//   CBPY, MVD with f_code; median MV prediction with the first-row rules; 1MV
//   and 4MV; half-pel motion compensation under vop_rounding_type; unrestricted
//   MVs against the reference replicated past its whole macroblocks (FFmpeg's
//   edge, not the picture's); not-coded MBs; sizes that are not a multiple of
//   16.
// - the integer "simple" IDCT (libavcodec's simple_idct, 8-bit), which is the
//   IDCT libavcodec picks for a stream that a libavcodec encoder wrote (held
//   bitwise on cv2's files). For a stream whose user data names XviD,
//   libavcodec switches to its XviD IDCT; such streams decode here with the
//   simple one, so their pixels may differ from cv2's by its rounding.
// - YUV 4:2:0 -> BGR24 as swscale's unscaled x86 converter computes it
//   (mp4.h's yuv420_to_bgr).
// Anything else (B-VOPs, sprites/GMC, interlace, quarter-pel, data
// partitioning, video packets, OBMC, the short video header, other shapes,
// other sample entries) is refused by name (error code 2).
//
// Encoder + muxer: an I-VOP every gop frames and P-VOPs between, at a fixed
// quantiser (H.263 quantisation), with a diamond then half-pel motion search;
// each VOP written is decoded by the decoder above, which gives the next
// reference. 4MV, AC prediction, MPEG quantisation and DC coded as AC are
// options, so that the decoder's paths for them can be held against FFmpeg
// on streams its default writer never makes. The MP4 (ftyp, mdat, then moov
// with an mp4v sample entry and its esds) is what FFmpeg reads back.
//
// Bit parsing is serial, so this stays on the host, as OpenCV's codec does in
// the JAX package.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "mp4.h"

namespace {

// ---------------------------------------------------------------- tables --
// The TCOEF tables of ISO/IEC 14496-2 (B-16 intra, B-17 inter): (code, length)
// without the sign bit, in the order of the (last, run, level) lists below;
// the last entry is the escape code.
const uint16_t kIntraVlc[103][2] = {
    {2, 2},   {6, 3},   {15, 4},  {13, 5},  {12, 5},  {21, 6},  {19, 6},  {18, 6},  {23, 7},
    {31, 8},  {30, 8},  {29, 8},  {37, 9},  {36, 9},  {35, 9},  {33, 9},  {33, 10}, {32, 10},
    {15, 10}, {14, 10}, {7, 11},  {6, 11},  {32, 11}, {33, 11}, {80, 12}, {81, 12}, {82, 12},
    {14, 4},  {20, 6},  {22, 7},  {28, 8},  {32, 9},  {31, 9},  {13, 10}, {34, 11}, {83, 12},
    {85, 12}, {11, 5},  {21, 7},  {30, 9},  {12, 10}, {86, 12}, {17, 6},  {27, 8},  {29, 9},
    {11, 10}, {16, 6},  {34, 9},  {10, 10}, {13, 6},  {28, 9},  {8, 10},  {18, 7},  {27, 9},
    {84, 12}, {20, 7},  {26, 9},  {87, 12}, {25, 8},  {9, 10},  {24, 8},  {35, 11}, {23, 8},
    {25, 9},  {24, 9},  {7, 10},  {88, 12}, {7, 4},   {12, 6},  {22, 8},  {23, 9},  {6, 10},
    {5, 11},  {4, 11},  {89, 12}, {15, 6},  {22, 9},  {5, 10},  {14, 6},  {4, 10},  {17, 7},
    {36, 11}, {16, 7},  {37, 11}, {19, 7},  {90, 12}, {21, 8},  {91, 12}, {20, 8},  {19, 8},
    {26, 8},  {21, 9},  {20, 9},  {19, 9},  {18, 9},  {17, 9},  {38, 11}, {39, 11}, {92, 12},
    {93, 12}, {94, 12}, {95, 12}, {3, 7}};
const uint8_t kIntraRun[102] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 5,
    6, 6, 6, 7, 7, 7, 8, 8, 9, 9, 10, 11, 12, 13, 14, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1,
    2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20};
const uint8_t kIntraLevel[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26,
    27, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 1, 2, 3, 4, 5, 1, 2, 3, 4, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1,
    2, 3, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3, 1, 2, 1, 2, 1, 2, 1, 2,
    1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
const int kIntraNotLast = 67;
const uint16_t kInterVlc[103][2] = {
    {2, 2},   {15, 4},  {21, 6},  {23, 7},  {31, 8},  {37, 9},  {36, 9},  {33, 10}, {32, 10},
    {7, 11},  {6, 11},  {32, 11}, {6, 3},   {20, 6},  {30, 8},  {15, 10}, {33, 11}, {80, 12},
    {14, 4},  {29, 8},  {14, 10}, {81, 12}, {13, 5},  {35, 9},  {13, 10}, {12, 5},  {34, 9},
    {82, 12}, {11, 5},  {12, 10}, {83, 12}, {19, 6},  {11, 10}, {84, 12}, {18, 6},  {10, 10},
    {17, 6},  {9, 10},  {16, 6},  {8, 10},  {22, 7},  {85, 12}, {21, 7},  {20, 7},  {28, 8},
    {27, 8},  {33, 9},  {32, 9},  {31, 9},  {30, 9},  {29, 9},  {28, 9},  {27, 9},  {26, 9},
    {34, 11}, {35, 11}, {86, 12}, {87, 12}, {7, 4},   {25, 9},  {5, 11},  {15, 6},  {4, 11},
    {14, 6},  {13, 6},  {12, 6},  {19, 7},  {18, 7},  {17, 7},  {16, 7},  {26, 8},  {25, 8},
    {24, 8},  {23, 8},  {22, 8},  {21, 8},  {20, 8},  {19, 8},  {24, 9},  {23, 9},  {22, 9},
    {21, 9},  {20, 9},  {19, 9},  {18, 9},  {17, 9},  {7, 10},  {6, 10},  {5, 10},  {4, 10},
    {36, 11}, {37, 11}, {38, 11}, {39, 11}, {88, 12}, {89, 12}, {90, 12}, {91, 12}, {92, 12},
    {93, 12}, {94, 12}, {95, 12}, {3, 7}};
const uint8_t kInterRun[102] = {
    0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  1,  1,  1,  1,  1,  1,  2,  2,  2,
    2,  3,  3,  3,  4,  4,  4,  5,  5,  5,  6,  6,  6,  7,  7,  8,  8,  9,  9,  10, 10,
    11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 0,  0,  0,  1,  1,
    2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
    23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40};
const uint8_t kInterLevel[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 1, 2, 3, 1,
    2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 2, 3, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
const int kInterNotLast = 58;

// MCBPC for I-VOPs (B-6): index = 4 * (intra+q) + cbpc; 8 is stuffing.
const uint8_t kIntraMcbpc[9][2] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4},
                                   {1, 6}, {2, 6}, {3, 6}, {1, 9}};
// MCBPC for P-VOPs (B-7): index = 4 * type + cbpc with type 0 inter, 1 intra,
// 2 inter+q, 3 intra+q, 4 inter4v; 20 is stuffing.
const uint8_t kInterMcbpc[21][2] = {
    {1, 1}, {3, 4}, {2, 4}, {5, 6}, {3, 5}, {4, 8}, {3, 8}, {3, 7}, {3, 3}, {7, 7}, {6, 7},
    {5, 9}, {4, 6}, {4, 9}, {3, 9}, {2, 9}, {2, 3}, {5, 7}, {4, 7}, {5, 8}, {1, 9}};
// CBPY (B-8), index = the intra pattern (an inter MB's pattern is its complement)
const uint8_t kCbpy[16][2] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4}, {2, 6}, {11, 4},
                              {2, 5}, {3, 6}, {5, 4}, {10, 4}, {4, 4}, {8, 4}, {6, 4}, {3, 2}};
// MVD magnitude 0..32 (B-12), without the sign bit
const uint8_t kMv[33][2] = {
    {1, 1},   {1, 2},   {1, 3},   {1, 4},   {3, 6},   {5, 7},   {4, 7},   {3, 7},   {11, 9},
    {10, 9},  {9, 9},   {17, 10}, {16, 10}, {15, 10}, {14, 10}, {13, 10}, {12, 10}, {11, 10},
    {10, 10}, {9, 10},  {8, 10},  {7, 10},  {6, 10},  {5, 10},  {4, 10},  {7, 11},  {6, 11},
    {5, 11},  {4, 11},  {3, 11},  {2, 11},  {3, 12},  {2, 12}};
// intra DC size (B-13 luminance, B-14 chrominance)
const uint8_t kDcLum[13][2] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3}, {1, 4}, {1, 5},
                               {1, 6}, {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}};
const uint8_t kDcChrom[13][2] = {{3, 2}, {2, 2}, {1, 2}, {1, 3},  {1, 4},  {1, 5}, {1, 6},
                                 {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}, {1, 12}};

const uint8_t kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                             12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                             35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                             58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
const uint8_t kAltHorizontal[64] = {
    0,  1,  2,  3,  8,  9,  16, 17, 10, 11, 4,  5,  6,  7,  15, 14, 13, 12, 19, 18, 24, 25,
    32, 33, 26, 27, 20, 21, 22, 23, 28, 29, 30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37,
    38, 39, 44, 45, 46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
const uint8_t kAltVertical[64] = {
    0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48, 56, 57, 49, 41, 33, 26, 18, 3,  11,
    4,  12, 19, 27, 34, 42, 50, 58, 35, 43, 51, 59, 20, 28, 5,  13, 6,  14, 21, 29, 36, 44,
    52, 60, 37, 45, 53, 61, 22, 30, 7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};
// the default MPEG quantisation matrices (6.3.3), in raster order
const uint8_t kDefaultIntraMat[64] = {
    8,  17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27, 28, 20, 21, 22, 23, 24, 26,
    28, 30, 21, 22, 23, 24, 26, 28, 30, 32, 22, 23, 24, 26, 28, 30, 32, 35, 23, 24, 26, 28,
    30, 32, 35, 38, 25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32, 35, 38, 41, 45};
const uint8_t kDefaultInterMat[64] = {
    16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23, 24, 18, 19, 20, 21, 22, 23,
    24, 25, 19, 20, 21, 22, 23, 24, 26, 27, 20, 21, 22, 23, 25, 26, 27, 28, 21, 22, 23, 24,
    26, 27, 28, 30, 22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 26, 28, 30, 31, 33};
// intra_dc_vlc_thr -> the running quantiser from which the DC is coded as AC
const int kDcThreshold[8] = {99, 13, 15, 17, 19, 21, 23, 0};
const int kDquant[4] = {-1, -2, 1, 2};

int y_dc_scale(int q) { return q < 5 ? 8 : q < 9 ? 2 * q : q < 25 ? q + 8 : 2 * q - 16; }
int c_dc_scale(int q) { return q < 5 ? 8 : q < 25 ? (q + 13) / 2 : q - 6; }

// A table decoder for one prefix code: 2^maxlen slots of (symbol, length).
struct Vlc {
  int bits = 0;
  std::vector<int16_t> sym;
  std::vector<uint8_t> len;
  template <typename T>
  void build(const T (*codes)[2], int n) {
    bits = 0;
    for (int i = 0; i < n; i++) bits = std::max(bits, (int)codes[i][1]);
    sym.assign(size_t(1) << bits, -1);
    len.assign(size_t(1) << bits, 0);
    for (int i = 0; i < n; i++) {
      int l = codes[i][1];
      if (l == 0) continue;
      uint32_t first = uint32_t(codes[i][0]) << (bits - l), count = 1u << (bits - l);
      for (uint32_t k = 0; k < count; k++) {
        sym[first + k] = (int16_t)i;
        len[first + k] = (uint8_t)l;
      }
    }
  }
};

// LMAX/RMAX of a TCOEF table (for the first and second escape modes)
struct RunLevel {
  const uint16_t (*vlc)[2];
  const uint8_t* run;
  const uint8_t* level;
  int not_last;
  int max_level[2][64];  // [last][run]
  int max_run[2][65];    // [last][level], level <= 64
  int index[2][64][32];  // [last][run][level] -> table index or -1 (level < 32)
  Vlc dec;
  void init(const uint16_t (*v)[2], const uint8_t* r, const uint8_t* l, int nl) {
    vlc = v;
    run = r;
    level = l;
    not_last = nl;
    memset(max_level, 0, sizeof(max_level));
    memset(max_run, 0, sizeof(max_run));
    memset(index, -1, sizeof(index));
    for (int i = 0; i < 102; i++) {
      int last = i >= nl;
      max_level[last][run[i]] = std::max(max_level[last][run[i]], (int)level[i]);
      max_run[last][level[i]] = std::max(max_run[last][level[i]], (int)run[i]);
      index[last][run[i]][level[i]] = i;
    }
    dec.build(vlc, 103);
  }
};

struct Tables {
  RunLevel intra, inter;
  Vlc intra_mcbpc, inter_mcbpc, cbpy, mv, dc_lum, dc_chrom;
  Tables() {
    intra.init(kIntraVlc, kIntraRun, kIntraLevel, kIntraNotLast);
    inter.init(kInterVlc, kInterRun, kInterLevel, kInterNotLast);
    intra_mcbpc.build(kIntraMcbpc, 9);
    inter_mcbpc.build(kInterMcbpc, 21);
    cbpy.build(kCbpy, 16);
    mv.build(kMv, 33);
    dc_lum.build(kDcLum, 13);
    dc_chrom.build(kDcChrom, 13);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// ------------------------------------------------------------ bit reader --
struct BitReader {
  const uint8_t* p;
  size_t n;      // bytes
  size_t pos;    // bits
  BitReader(const uint8_t* data, size_t size) : p(data), n(size), pos(0) {}
  uint32_t peek(int k) const {  // k <= 32; zeros past the end
    uint64_t w = 0;
    size_t byte = pos >> 3;
    for (int i = 0; i < 8; i++) w = (w << 8) | (byte + i < n ? p[byte + i] : 0);
    return (uint32_t)((w << (pos & 7)) >> (64 - k));
  }
  void skip(int k) { pos += k; }
  uint32_t get(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    pos += k;
    return v;
  }
  int get1() { return (int)get(1); }
  int sget(int k) {  // k-bit two's complement
    int v = (int)get(k);
    return v >= (1 << (k - 1)) ? v - (1 << k) : v;
  }
  size_t left() const { return pos >= n * 8 ? 0 : n * 8 - pos; }
  int vlc(const Vlc& t, const char* what) {
    uint32_t w = peek(t.bits);
    int s = t.sym[w];
    if (s < 0) fail(std::string("invalid ") + what + " code");
    pos += t.len[w];
    return s;
  }
  void marker(const char* what) {
    if (!get1()) fail(std::string("missing marker bit ") + what);
  }
};

// ----------------------------------------------------- the simple IDCT --
// libavcodec's simple_idct_template.c at 8 bits: rows with a DC-only shortcut,
// then columns, W4 = 16383, ROW_SHIFT 11, COL_SHIFT 20.
const int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867, W7 = 4520;

inline void idct_row(int16_t* row) {
  if (!(row[1] | row[2] | row[3] | row[4] | row[5] | row[6] | row[7])) {
    int16_t v = (int16_t)(uint16_t)(row[0] * 8);
    for (int i = 0; i < 8; i++) row[i] = v;
    return;
  }
  int a0 = W4 * row[0] + (1 << 10), a1 = a0, a2 = a0, a3 = a0;
  a0 += W2 * row[2];
  a1 += W6 * row[2];
  a2 -= W6 * row[2];
  a3 -= W2 * row[2];
  int b0 = W1 * row[1] + W3 * row[3];
  int b1 = W3 * row[1] - W7 * row[3];
  int b2 = W5 * row[1] - W1 * row[3];
  int b3 = W7 * row[1] - W5 * row[3];
  a0 += W4 * row[4] + W6 * row[6];
  a1 += -W4 * row[4] - W2 * row[6];
  a2 += -W4 * row[4] + W2 * row[6];
  a3 += W4 * row[4] - W6 * row[6];
  b0 += W5 * row[5] + W7 * row[7];
  b1 += -W1 * row[5] - W5 * row[7];
  b2 += W7 * row[5] + W3 * row[7];
  b3 += W3 * row[5] - W1 * row[7];
  row[0] = (int16_t)((a0 + b0) >> 11);
  row[7] = (int16_t)((a0 - b0) >> 11);
  row[1] = (int16_t)((a1 + b1) >> 11);
  row[6] = (int16_t)((a1 - b1) >> 11);
  row[2] = (int16_t)((a2 + b2) >> 11);
  row[5] = (int16_t)((a2 - b2) >> 11);
  row[3] = (int16_t)((a3 + b3) >> 11);
  row[4] = (int16_t)((a3 - b3) >> 11);
}

inline void idct_col(const int16_t* col, int out[8]) {
  int a0 = W4 * (col[0] + ((1 << 19) / W4)), a1 = a0, a2 = a0, a3 = a0;
  a0 += W2 * col[16];
  a1 += W6 * col[16];
  a2 -= W6 * col[16];
  a3 -= W2 * col[16];
  int b0 = W1 * col[8] + W3 * col[24];
  int b1 = W3 * col[8] - W7 * col[24];
  int b2 = W5 * col[8] - W1 * col[24];
  int b3 = W7 * col[8] - W5 * col[24];
  a0 += W4 * col[32];
  a1 -= W4 * col[32];
  a2 -= W4 * col[32];
  a3 += W4 * col[32];
  b0 += W5 * col[40];
  b1 -= W1 * col[40];
  b2 += W7 * col[40];
  b3 += W3 * col[40];
  a0 += W6 * col[48];
  a1 -= W2 * col[48];
  a2 += W2 * col[48];
  a3 -= W6 * col[48];
  b0 += W7 * col[56];
  b1 -= W5 * col[56];
  b2 += W3 * col[56];
  b3 -= W1 * col[56];
  out[0] = (a0 + b0) >> 20;
  out[7] = (a0 - b0) >> 20;
  out[1] = (a1 + b1) >> 20;
  out[6] = (a1 - b1) >> 20;
  out[2] = (a2 + b2) >> 20;
  out[5] = (a2 - b2) >> 20;
  out[3] = (a3 + b3) >> 20;
  out[4] = (a3 - b3) >> 20;
}

// blk (raster order) -> dst (8x8, stride): put (intra) or add (inter)
void idct_put(int16_t* blk, uint8_t* dst, int stride, bool add) {
  for (int r = 0; r < 8; r++) idct_row(blk + 8 * r);
  for (int c = 0; c < 8; c++) {
    int out[8];
    idct_col(blk + c, out);
    for (int r = 0; r < 8; r++) {
      uint8_t* d = dst + r * stride + c;
      *d = clip8(add ? *d + out[r] : out[r]);
    }
  }
}

// ------------------------------------------------------------- headers --
struct Vol {
  bool have = false;
  int verid = 1;
  int width = 0, height = 0;
  int time_resolution = 1, time_bits = 1;
  int quant_type = 0;
  uint8_t intra_mat[64], inter_mat[64];  // raster order
  bool resync = false;                    // video packets may occur
};

void read_matrix(BitReader& br, uint8_t* mat) {
  int last = 0, i = 0;
  for (; i < 64; i++) {
    int v = (int)br.get(8);
    if (v == 0) break;
    last = v;
    mat[kZigzag[i]] = (uint8_t)v;
  }
  if (i == 0) fail("quantisation matrix starts with 0");
  for (; i < 64; i++) mat[kZigzag[i]] = (uint8_t)last;
}

void parse_vol(BitReader& br, Vol& vol) {
  br.get1();  // random_accessible_vol
  int type = (int)br.get(8);
  if (type == 0x12) unsupported("fine granularity scalable video object layer");
  int verid = 1;
  if (br.get1()) {  // is_object_layer_identifier
    verid = (int)br.get(4);
    br.get(3);
  }
  if (br.get(4) == 15) br.get(16);  // extended PAR
  if (br.get1()) {                  // vol_control_parameters
    int chroma = (int)br.get(2);
    if (chroma != 1) unsupported("chroma_format " + std::to_string(chroma) + " (only 4:2:0)");
    int low_delay = br.get1();
    (void)low_delay;
    if (br.get1()) {  // vbv_parameters
      br.get(15); br.marker("vbv"); br.get(15); br.marker("vbv");
      br.get(15); br.marker("vbv"); br.get(3); br.get(11); br.marker("vbv");
      br.get(15); br.marker("vbv");
    }
  }
  int shape = (int)br.get(2);
  if (shape != 0) unsupported("video_object_layer_shape " + std::to_string(shape) +
                              " (only rectangular)");
  br.marker("before vop_time_increment_resolution");
  vol.time_resolution = (int)br.get(16);
  if (vol.time_resolution == 0) fail("vop_time_increment_resolution 0");
  int bits = 1;
  while ((1 << bits) < vol.time_resolution) bits++;
  vol.time_bits = bits;
  br.marker("after vop_time_increment_resolution");
  if (br.get1()) br.get(bits);  // fixed_vop_rate
  br.marker("before width");
  vol.width = (int)br.get(13);
  br.marker("before height");
  vol.height = (int)br.get(13);
  br.marker("after height");
  if (vol.width <= 0 || vol.height <= 0) fail("VOL of size 0");
  if (br.get1()) unsupported("interlaced video");
  if (!br.get1()) unsupported("overlapped block motion compensation (obmc_disable 0)");
  int sprite = (int)br.get(verid == 1 ? 1 : 2);
  if (sprite) unsupported("sprites/GMC (sprite_enable " + std::to_string(sprite) + ")");
  if (br.get1()) unsupported("not_8_bit video");
  vol.quant_type = br.get1();
  memcpy(vol.intra_mat, kDefaultIntraMat, 64);
  memcpy(vol.inter_mat, kDefaultInterMat, 64);
  if (vol.quant_type) {
    if (br.get1()) read_matrix(br, vol.intra_mat);
    if (br.get1()) read_matrix(br, vol.inter_mat);
  }
  if (verid != 1 && br.get1()) unsupported("quarter-pel motion (quarter_sample 1)");
  if (!br.get1()) unsupported("complexity estimation header");
  vol.resync = !br.get1();
  if (br.get1()) unsupported("data partitioning");
  if (verid != 1) {
    if (br.get1()) unsupported("newpred");
    if (br.get1()) unsupported("reduced resolution VOP");
  }
  if (br.get1()) unsupported("scalability");
  vol.verid = verid;
  vol.have = true;
}

// -------------------------------------------------------------- frames --
struct Plane {
  int w = 0, h = 0;  // allocated (whole macroblocks)
  std::vector<uint8_t> d;
  void alloc(int width, int height) {
    w = width;
    h = height;
    d.assign((size_t)w * h, 0);
  }
  uint8_t* at(int x, int y) { return d.data() + (size_t)y * w + x; }
  const uint8_t* at(int x, int y) const { return d.data() + (size_t)y * w + x; }
};

struct Frame {
  Plane p[3];
  void alloc(int mbw, int mbh) {
    p[0].alloc(mbw * 16, mbh * 16);
    p[1].alloc(mbw * 8, mbh * 8);
    p[2].alloc(mbw * 8, mbh * 8);
  }
};

// Half-pel prediction of a bw x bh block at integer position (x, y) + half
// flags (dxy bit 0: x, bit 1: y), the reference replicated past (ew, eh):
// libavcodec's edge is the whole-macroblock size, not the picture's.
void mc_block(const Plane& ref, int ew, int eh, int x, int y, int dxy, int bw, int bh,
              bool no_round, uint8_t* dst, int dstride) {
  int sx = bw + 1, sy = bh + 1;
  uint8_t src[17 * 17];
  bool inside = x >= 0 && y >= 0 && x + sx <= ew && y + sy <= eh;
  for (int j = 0; j < sy; j++) {
    int yy = inside ? y + j : std::min(std::max(y + j, 0), eh - 1);
    const uint8_t* row = ref.at(0, yy);
    for (int i = 0; i < sx; i++) {
      int xx = inside ? x + i : std::min(std::max(x + i, 0), ew - 1);
      src[j * 17 + i] = row[xx];
    }
  }
  int r = no_round ? 0 : 1;
  for (int j = 0; j < bh; j++) {
    for (int i = 0; i < bw; i++) {
      const uint8_t* s = src + j * 17 + i;
      int v;
      switch (dxy) {
        case 0: v = s[0]; break;
        case 1: v = (s[0] + s[1] + r) >> 1; break;
        case 2: v = (s[0] + s[17] + r) >> 1; break;
        default: v = (s[0] + s[1] + s[17] + s[18] + 1 + r) >> 2; break;
      }
      dst[j * dstride + i] = (uint8_t)v;
    }
  }
}

inline int mid3(int a, int b, int c) {
  return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

inline int rounded_div(int a, int b) { return (a > 0 ? a + (b >> 1) : a - (b >> 1)) / b; }

// chroma vector of a 4MV macroblock from the sum of its four luma vectors
inline int round_chroma4(int s) {
  static const int tab[16] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2};
  return tab[s & 15] + ((s >> 3) & ~1);
}

// ------------------------------------------------------------- decoder --
// The order of Decoder::stats (io/video.py names them the same)
enum Stat {
  kIVops, kPVops, kRoundingVops, kIntraMbs, kInterMbs, kFourMvMbs, kNotCodedMbs,
  kHalfPelVectors, kEscape1, kEscape2, kEscape3, kAcPredMbs, kDcAsAcBlocks, kMpegQuantVops,
  kStatCount
};

struct Decoder {
  Vol vol;
  int mbw = 0, mbh = 0;
  Frame cur, ref;
  bool have_ref = false;
  int vop_count = 0;
  // intra prediction state, per block of each plane's block grid:
  // dc (scaled), ac[0..6] left column rows 1..7, ac[7..13] top row cols 1..7
  struct Pred {
    int stamp = -1;
    int dc = 1024;
    int16_t ac[14] = {0};
  };
  std::vector<Pred> pred[3];
  int gw[3] = {0, 0, 0}, gh[3] = {0, 0, 0};
  std::vector<int> mbq;           // qscale of each MB in this VOP
  std::vector<int16_t> mvs;       // (2*mbw) x (2*mbh) x 2, this VOP
  // what the stream used, counted over every VOP decoded (see kStatNames)
  int64_t stats[16] = {0};
  // VOP state
  int qscale = 1, rounding = 0, fcode = 1, dc_thr = 99;
  bool use_dc_vlc = true, ac_pred = false;

  void setup() {
    mbw = (vol.width + 15) / 16;
    mbh = (vol.height + 15) / 16;
    cur.alloc(mbw, mbh);
    ref.alloc(mbw, mbh);
    gw[0] = 2 * mbw; gh[0] = 2 * mbh;
    for (int c = 1; c < 3; c++) { gw[c] = mbw; gh[c] = mbh; }
    for (int c = 0; c < 3; c++) pred[c].assign((size_t)gw[c] * gh[c], Pred());
    mbq.assign((size_t)mbw * mbh, 0);
    mvs.assign((size_t)4 * mbw * mbh * 2, 0);
    have_ref = false;
  }

  // The start codes of a sample (or of the decoder config) in order. Returns
  // true when a VOP was decoded into `cur`.
  bool decode(const uint8_t* data, size_t n) {
    bool decoded = false;
    size_t i = 0;
    while (true) {
      while (i + 3 < n && !(data[i] == 0 && data[i + 1] == 0 && data[i + 2] == 1)) i++;
      if (i + 3 >= n) break;
      int code = data[i + 3];
      size_t start = i + 4;
      size_t end = start;
      while (end + 2 < n && !(data[end] == 0 && data[end + 1] == 0 && data[end + 2] == 1)) end++;
      if (end + 2 >= n) end = n;
      BitReader br(data + start, end - start);
      if (code <= 0x1F) {
        // video_object_start_code
      } else if (code <= 0x2F) {
        Vol v;
        parse_vol(br, v);
        bool resize = !vol.have || v.width != vol.width || v.height != vol.height;
        vol = v;
        if (resize) setup();  // a repeated VOL keeps the reference
      } else if (code == 0xB6) {
        if (!vol.have) fail("VOP before any video object layer header");
        decoded = decode_vop(br) || decoded;
        i = end;
        continue;
      } else if (code >= 0x80 && code <= 0x8F) {
        unsupported("short video header (H.263 baseline) stream");
      }
      // VOS, user data, GOV, visual object: nothing the pixels depend on
      i = end;
    }
    return decoded;
  }

  bool decode_vop(BitReader& br) {
    int type = (int)br.get(2);
    if (type == 2) unsupported("B-VOP (bidirectional prediction)");
    if (type == 3) unsupported("S-VOP (sprite/GMC)");
    while (br.get1()) {}  // modulo_time_base
    br.marker("before vop_time_increment");
    br.get(vol.time_bits);
    br.marker("after vop_time_increment");
    if (!br.get1()) return false;  // vop_coded 0: nothing to show (FFmpeg skips it)
    if (type == 1) {
      if (!have_ref) fail("P-VOP without a reference VOP");
      rounding = br.get1();
    } else {
      rounding = 0;
    }
    dc_thr = kDcThreshold[br.get(3)];
    qscale = (int)br.get(5);
    if (qscale == 0) fail("vop_quant 0");
    if (type == 1) {
      fcode = (int)br.get(3);
      if (fcode == 0) fail("vop_fcode_forward 0");
    }
    if (type == 1) std::swap(cur, ref);  // the last decoded VOP is the reference
    stats[type == 0 ? kIVops : kPVops]++;
    if (type == 1 && rounding) stats[kRoundingVops]++;
    if (vol.quant_type) stats[kMpegQuantVops]++;
    vop_count++;
    std::fill(mvs.begin(), mvs.end(), 0);
    for (int my = 0; my < mbh; my++) {
      for (int mx = 0; mx < mbw; mx++) {
        if (vol.resync && is_resync(br, type))
          unsupported("video packets (resync markers) in a VOP");
        if (type == 0) decode_intra_mb(br, mx, my, false);
        else decode_p_mb(br, mx, my);
      }
    }
    have_ref = true;
    return true;
  }

  // whether a video packet starts here: stuffing ('0' then '1's) to the byte
  // boundary, then the resync marker, 16 zeros (I-VOP) or 15 + f_code (P-VOP)
  // and a one
  bool is_resync(const BitReader& br, int type) {
    size_t pos = br.pos, aligned = (pos + 8) & ~size_t(7);
    int stuff = (int)(aligned - pos);
    BitReader b2 = br;
    if (b2.get(stuff) != (1u << (stuff - 1)) - 1) return false;
    int zeros = type == 0 ? 16 : 15 + fcode;
    return b2.left() >= (size_t)zeros + 1 && b2.peek(zeros + 1) == 1;
  }

  // ---- intra ----
  Pred* pred_at(int c, int bx, int by) {
    if (bx < 0 || by < 0 || bx >= gw[c]) return nullptr;
    Pred* p = &pred[c][(size_t)by * gw[c] + bx];
    return p->stamp == vop_count ? p : nullptr;
  }

  void decode_intra_mb(BitReader& br, int mx, int my, bool in_p, int cbpc_in = -1,
                       bool dquant_in = false) {
    const Tables& T = tables();
    int cbpc;
    bool dquant;
    if (!in_p) {
      int m;
      do { m = br.vlc(T.intra_mcbpc, "MCBPC"); } while (m == 8);
      cbpc = m & 3;
      dquant = (m & 4) != 0;
    } else {
      cbpc = cbpc_in;
      dquant = dquant_in;
    }
    ac_pred = br.get1();
    stats[kIntraMbs]++;
    if (ac_pred) stats[kAcPredMbs]++;
    int cbpy = br.vlc(T.cbpy, "CBPY");
    int cbp = cbpc | (cbpy << 2);
    use_dc_vlc = qscale < dc_thr;
    if (dquant) qscale = std::min(std::max(qscale + kDquant[br.get(2)], 1), 31);
    mbq[(size_t)my * mbw + mx] = qscale;
    for (int b = 0; b < 6; b++) {
      int16_t blk[64];
      memset(blk, 0, sizeof(blk));
      intra_block(br, blk, b, mx, my, (cbp >> (5 - b)) & 1);
      int c = b < 4 ? 0 : b - 3;
      uint8_t* dst = c == 0 ? cur.p[0].at(mx * 16 + (b & 1) * 8, my * 16 + (b >> 1) * 8)
                            : cur.p[c].at(mx * 8, my * 8);
      idct_put(blk, dst, cur.p[c].w, false);
    }
    for (int k = 0; k < 4; k++) set_mv(mx, my, k, 0, 0);
  }

  void intra_block(BitReader& br, int16_t* blk, int b, int mx, int my, int coded) {
    const Tables& T = tables();
    int c = b < 4 ? 0 : b - 3;
    int bx = c == 0 ? 2 * mx + (b & 1) : mx, by = c == 0 ? 2 * my + (b >> 1) : my;
    int scale = c == 0 ? y_dc_scale(qscale) : c_dc_scale(qscale);
    // DC prediction: B C / A X
    Pred* A = pred_at(c, bx - 1, by);
    Pred* B = pred_at(c, bx - 1, by - 1);
    Pred* C = pred_at(c, bx, by - 1);
    int a = A ? A->dc : 1024, bb = B ? B->dc : 1024, cc = C ? C->dc : 1024;
    int dir;  // 0: from the left, 1: from the top
    int pred_dc;
    if (std::abs(a - bb) < std::abs(bb - cc)) { pred_dc = cc; dir = 1; }
    else { pred_dc = a; dir = 0; }
    pred_dc = (pred_dc + (scale >> 1)) / scale;
    int i;  // index of the last coefficient read, in scan order
    if (use_dc_vlc) {
      int size = br.vlc(c == 0 ? T.dc_lum : T.dc_chrom, "DC size");
      int level = 0;
      if (size) {
        int v = (int)br.get(size);
        level = (v >> (size - 1)) ? v : v - (1 << size) + 1;
        if (size > 8) br.marker("after DC");
      }
      blk[0] = (int16_t)level;
      i = 0;
    } else {
      i = -1;
      stats[kDcAsAcBlocks]++;
    }
    const uint8_t* scan = !ac_pred ? kZigzag : dir == 0 ? kAltVertical : kAltHorizontal;
    if (coded) read_coefficients(br, blk, scan, i, T.intra, 1, 0);
    int dc = blk[0] + pred_dc;
    blk[0] = (int16_t)dc;
    int stored = dc * scale;
    if (stored & ~2047) stored = stored < 0 ? 0 : 2047;
    Pred& P = pred[c][(size_t)by * gw[c] + bx];
    P.stamp = vop_count;
    P.dc = stored;
    // AC prediction
    if (ac_pred) {
      if (dir == 0) {
        if (A) {
          int q = mbq[(size_t)my * mbw + mx - ((c != 0 || (b & 1) == 0) ? 1 : 0)];
          bool same = mx == 0 || q == qscale || b == 1 || b == 3;
          for (int k = 1; k < 8; k++)
            blk[k * 8] += same ? A->ac[k - 1] : rounded_div(A->ac[k - 1] * q, qscale);
        }
      } else {
        if (C) {
          int q = (c != 0 || b < 2) ? mbq[(size_t)(my - 1) * mbw + mx] : qscale;
          bool same = my == 0 || q == qscale || b == 2 || b == 3;
          for (int k = 1; k < 8; k++)
            blk[k] += same ? C->ac[6 + k] : rounded_div(C->ac[6 + k] * q, qscale);
        }
      }
    }
    for (int k = 1; k < 8; k++) {
      P.ac[k - 1] = blk[k * 8];
      P.ac[6 + k] = blk[k];
    }
    dequant_intra(blk, scale);
  }

  void dequant_intra(int16_t* blk, int scale) {
    blk[0] = (int16_t)(blk[0] * scale);
    if (vol.quant_type == 0) {
      int qmul = 2 * qscale, qadd = (qscale - 1) | 1;
      for (int k = 1; k < 64; k++) {
        int l = blk[k];
        if (l) blk[k] = (int16_t)(l < 0 ? l * qmul - qadd : l * qmul + qadd);
      }
    } else {
      int q2 = 2 * qscale;
      for (int k = 1; k < 64; k++) {
        int l = blk[k];
        if (!l) continue;
        int m = (std::abs(l) * q2 * vol.intra_mat[k]) >> 4;
        blk[k] = (int16_t)(l < 0 ? -m : m);
      }
    }
  }

  // TCOEF symbols into blk (raster positions through `scan`) from index i+1.
  // Levels are multiplied by qmul, qadd added (inter, H.263 quantisation).
  // Returns the last index.
  int read_coefficients(BitReader& br, int16_t* blk, const uint8_t* scan, int i,
                        const RunLevel& rl, int qmul, int qadd) {
    while (true) {
      int s = br.vlc(rl.dec, "TCOEF");
      int last, run, level;
      if (s == 102) {  // escape
        if (!br.get1()) {  // mode 1: level offset by LMAX
          stats[kEscape1]++;
          s = br.vlc(rl.dec, "TCOEF (escape 1)");
          if (s == 102) fail("escape inside escape");
          last = s >= rl.not_last; run = rl.run[s];
          level = rl.level[s] + rl.max_level[last][run];
        } else if (!br.get1()) {  // mode 2: run offset by RMAX + 1
          stats[kEscape2]++;
          s = br.vlc(rl.dec, "TCOEF (escape 2)");
          if (s == 102) fail("escape inside escape");
          last = s >= rl.not_last; level = rl.level[s];
          run = rl.run[s] + rl.max_run[last][level] + 1;
        } else {  // mode 3: fixed length
          stats[kEscape3]++;
          last = br.get1();
          run = (int)br.get(6);
          br.marker("in escape 3");
          level = br.sget(12);
          br.marker("after escape 3 level");
          if (level == 0) fail("escape 3 with level 0");
          int mag = std::abs(level) * qmul + qadd;
          level = level < 0 ? -mag : mag;
          if (level < -2048) level = -2048;
          if (level > 2047) level = 2047;
          i += run + 1;
          if (i > 63) fail("more than 64 coefficients in a block");
          blk[scan[i]] = (int16_t)level;
          if (last) return i;
          continue;
        }
      } else {
        last = s >= rl.not_last; run = rl.run[s]; level = rl.level[s];
      }
        int mag = level * qmul + qadd;
      level = br.get1() ? -mag : mag;
      i += run + 1;
      if (i > 63) fail("more than 64 coefficients in a block");
      blk[scan[i]] = (int16_t)level;
      if (last) return i;
    }
  }

  // ---- inter ----
  void set_mv(int mx, int my, int k, int x, int y) {
    size_t idx = ((size_t)(2 * my + (k >> 1)) * (2 * mbw) + 2 * mx + (k & 1)) * 2;
    mvs[idx] = (int16_t)x;
    mvs[idx + 1] = (int16_t)y;
  }
  // the vector of b8 block (x, y); 0 outside the picture
  void mv_at(int x, int y, int& vx, int& vy) {
    if (x < 0 || y < 0 || x >= 2 * mbw) { vx = vy = 0; return; }
    size_t idx = ((size_t)y * (2 * mbw) + x) * 2;
    vx = mvs[idx];
    vy = mvs[idx + 1];
  }

  void predict_mv(int mx, int my, int k, int& px, int& py) {
    int x = 2 * mx + (k & 1), y = 2 * my + (k >> 1);
    static const int off[4] = {2, 1, 1, -1};  // C: above and to the right
    int ax, ay, bx, by, cx, cy;
    mv_at(x - 1, y, ax, ay);
    if (my == 0 && k < 2) {  // first row: A only (0 at the left edge)
      if (k == 0 && mx == 0) { px = py = 0; }
      else { px = ax; py = ay; }
      return;
    }
    mv_at(x, y - 1, bx, by);
    mv_at(x + off[k], y - 1, cx, cy);
    px = mid3(ax, bx, cx);
    py = mid3(ay, by, cy);
  }

  int decode_mv(BitReader& br, int pred) {
    int v = decode_mv_component(br, pred);
    if (v & 1) stats[kHalfPelVectors]++;
    return v;
  }

  int decode_mv_component(BitReader& br, int pred) {
    int code = br.vlc(tables().mv, "MVD");
    if (code == 0) return pred;
    int sign = br.get1();
    int shift = fcode - 1;
    int val = code;
    if (shift) {
      val = ((val - 1) << shift) | (int)br.get(shift);
      val++;
    }
    if (sign) val = -val;
    val += pred;
    int bits = 5 + fcode;  // wrap into the f_code range
    val = (int)((uint32_t)val << (32 - bits)) >> (32 - bits);
    return val;
  }

  void decode_p_mb(BitReader& br, int mx, int my) {
    const Tables& T = tables();
    if (br.get1()) {  // not coded: copy from the reference
      stats[kNotCodedMbs]++;
      mbq[(size_t)my * mbw + mx] = qscale;
      predict_luma(mx, my, 0, nullptr);
      return;
    }
    int m;
    do { m = br.vlc(T.inter_mcbpc, "MCBPC"); } while (m == 20);
    int type = m >> 2, cbpc = m & 3;
    if (type == 1 || type == 3) {
      decode_intra_mb(br, mx, my, true, cbpc, type == 3);
      return;
    }
    int cbpy = br.vlc(T.cbpy, "CBPY") ^ 15;
    int cbp = cbpc | (cbpy << 2);
    if (type == 2) qscale = std::min(std::max(qscale + kDquant[br.get(2)], 1), 31);
    mbq[(size_t)my * mbw + mx] = qscale;
    stats[type == 4 ? kFourMvMbs : kInterMbs]++;
    int v[4][2];
    if (type == 4) {
      for (int k = 0; k < 4; k++) {
        int px, py;
        predict_mv(mx, my, k, px, py);
        v[k][0] = decode_mv(br, px);
        v[k][1] = decode_mv(br, py);
        set_mv(mx, my, k, v[k][0], v[k][1]);
      }
    } else {
      int px, py;
      predict_mv(mx, my, 0, px, py);
      int x = decode_mv(br, px);
      int y = decode_mv(br, py);
      for (int k = 0; k < 4; k++) { v[k][0] = x; v[k][1] = y; set_mv(mx, my, k, x, y); }
    }
    predict_luma(mx, my, type == 4, v);
    int qmul = vol.quant_type ? 1 : 2 * qscale, qadd = vol.quant_type ? 0 : (qscale - 1) | 1;
    for (int b = 0; b < 6; b++) {
      if (!((cbp >> (5 - b)) & 1)) continue;
      int16_t blk[64];
      memset(blk, 0, sizeof(blk));
      int last = read_coefficients(br, blk, kZigzag, -1, T.inter, qmul, qadd);
      if (vol.quant_type) dequant_inter_mpeg(blk, last);
      int c = b < 4 ? 0 : b - 3;
      uint8_t* dst = c == 0 ? cur.p[0].at(mx * 16 + (b & 1) * 8, my * 16 + (b >> 1) * 8)
                            : cur.p[c].at(mx * 8, my * 8);
      idct_put(blk, dst, cur.p[c].w, true);
    }
  }

  void dequant_inter_mpeg(int16_t* blk, int last) {
    int q2 = 2 * qscale, sum = -1;
    for (int i = 0; i <= last; i++) {
      int k = kZigzag[i], l = blk[k];
      if (!l) continue;
      int m = ((2 * std::abs(l) + 1) * q2 * vol.inter_mat[k]) >> 5;
      blk[k] = (int16_t)(l < 0 ? -m : m);
      sum += blk[k];
    }
    blk[63] ^= (int16_t)(sum & 1);
  }

  // Motion-compensated prediction of MB (mx, my) into cur: v == nullptr is a
  // zero vector (not coded), four4 the 4MV case.
  void predict_luma(int mx, int my, bool four4, int (*v)[2]) {
    int ew = mbw * 16, eh = mbh * 16, cew = mbw * 8, ceh = mbh * 8;
    bool nr = rounding != 0;
    Plane& Y = cur.p[0];
    if (!v) {
      mc_block(ref.p[0], ew, eh, mx * 16, my * 16, 0, 16, 16, nr, Y.at(mx * 16, my * 16), Y.w);
      for (int c = 1; c < 3; c++)
        mc_block(ref.p[c], cew, ceh, mx * 8, my * 8, 0, 8, 8, nr, cur.p[c].at(mx * 8, my * 8),
                 cur.p[c].w);
      for (int k = 0; k < 4; k++) set_mv(mx, my, k, 0, 0);
      return;
    }
    int cx, cy;
    if (!four4) {
      int x = v[0][0], y = v[0][1];
      mc_block(ref.p[0], ew, eh, mx * 16 + (x >> 1), my * 16 + (y >> 1),
               ((y & 1) << 1) | (x & 1), 16, 16, nr, Y.at(mx * 16, my * 16), Y.w);
      cx = (x >> 1) | (x & 1);
      cy = (y >> 1) | (y & 1);
    } else {
      int sx = 0, sy = 0;
      for (int k = 0; k < 4; k++) {
        int x = v[k][0], y = v[k][1];
        int ox = mx * 16 + (k & 1) * 8, oy = my * 16 + (k >> 1) * 8;
        mc_block(ref.p[0], ew, eh, ox + (x >> 1), oy + (y >> 1), ((y & 1) << 1) | (x & 1), 8,
                 8, nr, Y.at(ox, oy), Y.w);
        sx += x;
        sy += y;
      }
      cx = round_chroma4(sx);
      cy = round_chroma4(sy);
    }
    for (int c = 1; c < 3; c++)
      mc_block(ref.p[c], cew, ceh, mx * 8 + (cx >> 1), my * 8 + (cy >> 1),
               ((cy & 1) << 1) | (cx & 1), 8, 8, nr, cur.p[c].at(mx * 8, my * 8), cur.p[c].w);
  }
};

struct Reader {
  Movie movie;
  size_t next = 0;
  Decoder dec;
  std::vector<uint8_t> buf, bgr;

  void open(const char* path) {
    movie.open(path);
    const Track& track = movie.track;
    if (track.entry != "mp4v")
      unsupported("sample entry '" + track.entry +
                  "' (the port reads mp4v, MPEG-4 Part 2; avc1/avc3, H.264; hvc1/hev1, HEVC)");
    if (track.esds_object_type != 0x20)
      unsupported("esds objectTypeIndication " + std::to_string(track.esds_object_type) +
                  " (only 0x20, MPEG-4 Visual)");
    if (!track.dsi.empty()) dec.decode(track.dsi.data(), track.dsi.size());
    if (!dec.vol.have && !movie.samples.empty()) {  // the VOL may be in the first sample
      Decoder probe;
      std::vector<uint8_t> s = movie.read_sample(0);
      probe_headers(probe, s);
      dec.vol = probe.vol;
      if (dec.vol.have) dec.setup();
    }
    if (!dec.vol.have) fail("no video object layer header");
  }

  static void probe_headers(Decoder& d, const std::vector<uint8_t>& s) {
    // parse up to the first VOP only
    size_t i = 0, n = s.size();
    while (i + 3 < n) {
      if (s[i] == 0 && s[i + 1] == 0 && s[i + 2] == 1) {
        if (s[i + 3] == 0xB6) { d.decode(s.data(), i); return; }
      }
      i++;
    }
  }

  // 1 with a BGR frame in out (rotated as the display matrix says), 0 at the end
  int next_frame(uint8_t* out) {
    while (next < movie.samples.size()) {
      buf = movie.read_sample(next++);
      if (!dec.decode(buf.data(), buf.size())) continue;
      const Frame& f = dec.cur;
      int w = dec.vol.width, h = dec.vol.height;
      uint8_t* dst = out;
      if (movie.rotation) {
        bgr.resize((size_t)w * h * 3);
        dst = bgr.data();
      }
      yuv420_to_bgr(f.p[0].at(0, 0), f.p[0].w, f.p[1].at(0, 0), f.p[2].at(0, 0),
                    f.p[1].w, w, h, dst);
      if (movie.rotation) rotate_bgr(dst, w, h, movie.rotation, out);
      return 1;
    }
    return 0;
  }
};

// -------------------------------------------------------------- encoder --
struct BitWriter {
  std::vector<uint8_t> buf;
  uint64_t acc = 0;
  int nacc = 0;
  void put(uint32_t v, int n) {  // n <= 32
    if (n == 0) return;
    acc = (acc << n) | (v & (n == 32 ? 0xFFFFFFFFu : ((1u << n) - 1)));
    nacc += n;
    while (nacc >= 8) {
      buf.push_back((uint8_t)(acc >> (nacc - 8)));
      nacc -= 8;
    }
  }
  void start_code(uint8_t code) {
    put(0x000001, 24);
    put(code, 8);
  }
  // next_start_code(): a zero bit, then ones to the byte boundary
  void stuffing() {
    put(0, 1);
    int k = (8 - nacc) & 7;
    put((1u << k) - 1, k);
  }
};

template <typename T>
void put_code(BitWriter& bw, const T (*tab)[2], int i) { bw.put(tab[i][0], tab[i][1]); }

// One TCOEF symbol, by the shortest of the direct code and the three escapes.
void put_coefficient(BitWriter& bw, const RunLevel& rl, int last, int run, int level) {
  int a = std::abs(level), sign = level < 0;
  auto direct = [&](int r, int l) { return r < 64 && l < 32 ? rl.index[last][r][l] : -1; };
  int i = direct(run, a);
  if (i >= 0) {
    put_code(bw, rl.vlc, i);
    bw.put(sign, 1);
    return;
  }
  const uint16_t* esc = rl.vlc[102];
  int lmax = run < 64 ? rl.max_level[last][run] : 0;
  if (lmax > 0 && (i = direct(run, a - lmax)) >= 0) {
    bw.put(esc[0], esc[1]);
    bw.put(0, 1);
    put_code(bw, rl.vlc, i);
    bw.put(sign, 1);
    return;
  }
  if (a < 32 && rl.index[last][0][a] >= 0) {
    int r2 = run - rl.max_run[last][a] - 1;
    if (r2 >= 0 && (i = direct(r2, a)) >= 0) {
      bw.put(esc[0], esc[1]);
      bw.put(2, 2);
      put_code(bw, rl.vlc, i);
      bw.put(sign, 1);
      return;
    }
  }
  bw.put(esc[0], esc[1]);
  bw.put(3, 2);
  bw.put(last, 1);
  bw.put(run, 6);
  bw.put(1, 1);
  bw.put((uint32_t)level & 0xFFF, 12);
  bw.put(1, 1);
}

// the coefficients of a block (raster order) from scan index `first` on
void put_block(BitWriter& bw, const RunLevel& rl, const int* lv, const uint8_t* scan, int first) {
  int last_i = -1;
  for (int i = first; i < 64; i++)
    if (lv[scan[i]]) last_i = i;
  int run = 0;
  for (int i = first; i <= last_i; i++) {
    int l = lv[scan[i]];
    if (!l) { run++; continue; }
    put_coefficient(bw, rl, i == last_i, run, l);
    run = 0;
  }
}

void put_mvd(BitWriter& bw, int d, int fcode) {
  int bits = 5 + fcode;
  d = (int)((uint32_t)d << (32 - bits)) >> (32 - bits);  // into the f_code range
  if (d == 0) { put_code(bw, kMv, 0); return; }
  int r = fcode - 1, a = std::abs(d) - 1;
  put_code(bw, kMv, (a >> r) + 1);
  bw.put(d < 0, 1);
  bw.put(a & ((1 << r) - 1), r);
}

// 8x8 forward DCT (orthonormal, scaled as MPEG's: DC = 8 x mean)
struct Fdct {
  double c[8][8];
  Fdct() {
    for (int u = 0; u < 8; u++)
      for (int x = 0; x < 8; x++)
        c[u][x] = (u ? 0.5 : 0.5 / std::sqrt(2.0)) * std::cos((2 * x + 1) * u * M_PI / 16);
  }
  void run(const int* in, int* out) const {  // raster in and out
    double t[64];
    for (int y = 0; y < 8; y++)
      for (int u = 0; u < 8; u++) {
        double s = 0;
        for (int x = 0; x < 8; x++) s += c[u][x] * in[y * 8 + x];
        t[y * 8 + u] = s;
      }
    for (int u = 0; u < 8; u++)
      for (int v = 0; v < 8; v++) {
        double s = 0;
        for (int y = 0; y < 8; y++) s += c[v][y] * t[y * 8 + u];
        out[v * 8 + u] = (int)std::lround(s);
      }
  }
};

const Fdct& fdct() {
  static const Fdct f;
  return f;
}

struct EncoderOptions {
  int qscale = 3;
  int gop = 12;          // an I-VOP every gop frames, P-VOPs between (1: intra only)
  bool four_mv = false;  // 8x8 vectors where they pay
  bool ac_pred = false;  // intra AC prediction on every intra MB
  int quant_type = 0;    // 1: MPEG quantisation with the default matrices
  int dc_thr = 0;        // intra_dc_vlc_thr
};

struct Writer {
  FILE* f = nullptr;
  std::string path;
  int width = 0, height = 0, mbw = 0, mbh = 0;
  int fps_num = 0, fps_den = 1, time_bits = 1, timescale = 0, delta = 0;
  EncoderOptions o;
  std::vector<uint8_t> config;  // VOS, VO, VOL: the esds DecoderSpecificInfo
  std::vector<uint32_t> sizes;
  std::vector<uint32_t> sync;   // 1-based numbers of the I-VOP samples
  uint64_t mdat_start = 0, written = 0;
  Decoder recon;                // decodes every VOP written: the reference
  Decoder st;                   // prediction state while a VOP is coded
  Frame src;
  int64_t prev_sec = 0;
  int rounding = 0;

  ~Writer() {
    if (f) fclose(f);
  }

  void open(const char* p, int w, int h, int num, int den, const EncoderOptions& opt) {
    if (w <= 0 || h <= 0 || w >= 8192 || h >= 8192) fail("frame size out of 1..8191");
    if (num <= 0 || den <= 0 || num > 65535) fail("frame rate out of range");
    if (opt.qscale < 1 || opt.qscale > 31) fail("qscale out of 1..31");
    if (opt.gop < 1) fail("gop < 1");
    if (opt.dc_thr < 0 || opt.dc_thr > 7) fail("dc_thr out of 0..7");
    path = p;
    width = w; height = h; fps_num = num; fps_den = den; o = opt;
    mbw = (w + 15) / 16;
    mbh = (h + 15) / 16;
    while ((1 << time_bits) < fps_num) time_bits++;
    timescale = fps_num; delta = fps_den;
    while (timescale < 10000 && (int64_t)timescale * 2 <= 0x7FFFFFFF) { timescale *= 2; delta *= 2; }
    BitWriter bw;
    bw.start_code(0xB0);
    bw.put(0x01, 8);  // profile_and_level_indication, as libavcodec writes it
    bw.start_code(0xB5);
    bw.put(0x8913, 16);  // visual object: identifier, verid 1, priority 1, video, no signal type
    bw.start_code(0x00);
    bw.start_code(0x20);
    bw.put(0, 1);              // random_accessible_vol
    bw.put(1, 8);              // simple object type
    bw.put(1, 1); bw.put(1, 4); bw.put(1, 3);  // identifier, verid 1, priority 1
    bw.put(1, 4);              // square pixels
    bw.put(1, 1); bw.put(1, 2); bw.put(1, 1); bw.put(0, 1);  // 4:2:0, low delay, no vbv
    bw.put(0, 2);              // rectangular
    bw.put(1, 1); bw.put(fps_num, 16); bw.put(1, 1);
    bw.put(0, 1);              // fixed_vop_rate
    bw.put(1, 1); bw.put(w, 13); bw.put(1, 1); bw.put(h, 13); bw.put(1, 1);
    bw.put(0, 1); bw.put(1, 1);  // progressive, obmc_disable
    bw.put(0, 1);              // sprite_enable
    bw.put(0, 1);              // 8 bit
    bw.put(o.quant_type, 1);
    if (o.quant_type) { bw.put(0, 1); bw.put(0, 1); }  // the default matrices
    bw.put(1, 1);              // complexity_estimation_disable
    bw.put(1, 1);              // resync_marker_disable
    bw.put(0, 1);              // data_partitioned
    bw.put(0, 1);              // scalability
    bw.stuffing();
    config = bw.buf;
    recon.decode(config.data(), config.size());
    st.decode(config.data(), config.size());
    src.alloc(mbw, mbh);
    f = fopen(p, "wb");
    if (!f) fail(std::string("cannot create ") + p);
    std::vector<uint8_t> head;
    put_be(head, 24, 4); head.insert(head.end(), {'f', 't', 'y', 'p', 'i', 's', 'o', 'm'});
    put_be(head, 0x200, 4); head.insert(head.end(), {'i', 's', 'o', 'm', 'm', 'p', '4', '1'});
    put_be(head, 1, 4); head.insert(head.end(), {'m', 'd', 'a', 't'});
    put_be(head, 0, 8);  // 64-bit size, patched at release
    if (fwrite(head.data(), 1, head.size(), f) != head.size()) fail("write failed");
    mdat_start = head.size();
  }

  // BGR (height x width x 3) -> the padded YUV 4:2:0 source, BT.601 limited
  // range, edges replicated
  void load(const uint8_t* bgr) {
    Plane& Y = src.p[0];
    for (int y = 0; y < Y.h; y++) {
      const uint8_t* row = bgr + (size_t)std::min(y, height - 1) * width * 3;
      for (int x = 0; x < Y.w; x++) {
        const uint8_t* px = row + 3 * std::min(x, width - 1);
        Y.at(0, y)[x] = clip8((int)std::lround(16 + (65.481 * px[2] + 128.553 * px[1] +
                                                        24.966 * px[0]) / 255.0));
      }
    }
    for (int y = 0; y < src.p[1].h; y++)
      for (int x = 0; x < src.p[1].w; x++) {
        double r = 0, g = 0, b = 0;
        for (int k = 0; k < 4; k++) {
          int yy = std::min(2 * y + (k >> 1), height - 1), xx = std::min(2 * x + (k & 1), width - 1);
          const uint8_t* px = bgr + ((size_t)yy * width + xx) * 3;
          b += px[0]; g += px[1]; r += px[2];
        }
        r /= 4; g /= 4; b /= 4;
        src.p[1].at(0, y)[x] = clip8((int)std::lround(128 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255.0));
        src.p[2].at(0, y)[x] = clip8((int)std::lround(128 + (112.0 * r - 93.786 * g - 18.214 * b) / 255.0));
      }
  }

  // quantised levels of one intra block; returns the DC level
  int quant_intra(const int* F, int scale, int q, int* lv) {
    int dc = std::min(std::max((F[0] + scale / 2) / scale, 1), 2047 / scale);
    lv[0] = 0;
    for (int k = 1; k < 64; k++) {
      int a = std::abs(F[k]), l;
      if (o.quant_type == 0) {
        // the level whose reconstruction (2l+1)q (-1 for even q) is nearest
        int qadd = (q - 1) | 1;
        l = std::max((a - qadd + q) / (2 * q), 0);
        if (l > 0 && a < (2 * l * q + qadd) / 2) l = 0;
      } else {
        int step = 2 * q * kDefaultIntraMat[k];  // the reconstruction's step x 16
        l = (a * 16 + step / 2) / step;
      }
      l = std::min(l, 2047);
      lv[k] = F[k] < 0 ? -l : l;
    }
    return dc;
  }

  bool quant_inter(const int* F, int q, int* lv) {
    bool any = false;
    for (int k = 0; k < 64; k++) {
      int a = std::abs(F[k]), l;
      if (o.quant_type == 0) {
        int qadd = (q - 1) | 1;
        l = std::max((a - q / 2) / (2 * q), 0);
        l = std::min(l, (2047 - qadd) / (2 * q));
      } else {
        l = std::max((a * 16 / (q * kDefaultInterMat[k]) - 1) / 2, 0);
        l = std::min(l, 2047);
      }
      lv[k] = F[k] < 0 ? -l : l;
      any = any || l;
    }
    return any;
  }

  // the 8x8 source block b of MB (mx, my), minus a prediction (or not)
  void source_block(int mx, int my, int b, const Frame* pred, int* out) {
    int c = b < 4 ? 0 : b - 3;
    int x0 = c == 0 ? mx * 16 + (b & 1) * 8 : mx * 8, y0 = c == 0 ? my * 16 + (b >> 1) * 8 : my * 8;
    for (int y = 0; y < 8; y++)
      for (int x = 0; x < 8; x++) {
        int v = src.p[c].at(x0 + x, y0 + y)[0];
        if (pred) v -= pred->p[c].at(x0 + x, y0 + y)[0];
        out[y * 8 + x] = v;
      }
  }

  // An intra MB (of an I- or P-VOP) into bw, updating st's prediction state.
  void intra_mb(BitWriter& bw, int mx, int my, bool in_p) {
    const Tables& T = tables();
    int q = st.qscale;
    bool use_dc_vlc = q < kDcThreshold[o.dc_thr];
    st.ac_pred = o.ac_pred;
    st.mbq[(size_t)my * mbw + mx] = q;
    int lv[6][64], dcdiff[6];
    const uint8_t* scans[6];
    int cbp = 0;
    for (int b = 0; b < 6; b++) {
      int c = b < 4 ? 0 : b - 3;
      int bx = c == 0 ? 2 * mx + (b & 1) : mx, by = c == 0 ? 2 * my + (b >> 1) : my;
      int scale = c == 0 ? y_dc_scale(q) : c_dc_scale(q);
      int in[64], F[64];
      source_block(mx, my, b, nullptr, in);
      fdct().run(in, F);
      int dc = quant_intra(F, scale, q, lv[b]);
      Decoder::Pred* A = st.pred_at(c, bx - 1, by);
      Decoder::Pred* B = st.pred_at(c, bx - 1, by - 1);
      Decoder::Pred* C = st.pred_at(c, bx, by - 1);
      int a = A ? A->dc : 1024, bb = B ? B->dc : 1024, cc = C ? C->dc : 1024;
      int dir, pdc;
      if (std::abs(a - bb) < std::abs(bb - cc)) { pdc = cc; dir = 1; }
      else { pdc = a; dir = 0; }
      pdc = (pdc + (scale >> 1)) / scale;
      Decoder::Pred& P = st.pred[c][(size_t)by * st.gw[c] + bx];
      P.stamp = st.vop_count;
      int stored = dc * scale;
      P.dc = stored & ~2047 ? (stored < 0 ? 0 : 2047) : stored;
      for (int k = 1; k < 8; k++) { P.ac[k - 1] = (int16_t)lv[b][k * 8]; P.ac[6 + k] = (int16_t)lv[b][k]; }
      if (o.ac_pred) {  // all MBs share one quantiser, so no rescaling
        if (dir == 0 && A) for (int k = 1; k < 8; k++) lv[b][k * 8] -= A->ac[k - 1];
        if (dir == 1 && C) for (int k = 1; k < 8; k++) lv[b][k] -= C->ac[6 + k];
      }
      scans[b] = !o.ac_pred ? kZigzag : dir == 0 ? kAltVertical : kAltHorizontal;
      // the DC difference goes by the DC VLC, or as the first TCOEF
      dcdiff[b] = dc - pdc;
      lv[b][0] = use_dc_vlc ? 0 : dcdiff[b];
      bool coded = false;
      for (int k = 0; k < 64; k++) coded = coded || lv[b][k];
      if (coded) cbp |= 32 >> b;
    }
    int cbpc = cbp & 3, cbpy = cbp >> 2;
    if (in_p) { bw.put(0, 1); put_code(bw, kInterMcbpc, 4 + cbpc); }
    else put_code(bw, kIntraMcbpc, cbpc);
    bw.put(o.ac_pred, 1);
    put_code(bw, kCbpy, cbpy);
    for (int b = 0; b < 6; b++) {
      if (use_dc_vlc) {
        int d = dcdiff[b], size = 0;
        while ((1 << size) <= std::abs(d)) size++;
        put_code(bw, b < 4 ? kDcLum : kDcChrom, size);
        if (size) bw.put(d > 0 ? d : d + (1 << size) - 1, size);
        if (size > 8) bw.put(1, 1);
      }
      if (cbp & (32 >> b)) put_block(bw, T.intra, lv[b], scans[b], use_dc_vlc ? 1 : 0);
    }
    for (int k = 0; k < 4; k++) st.set_mv(mx, my, k, 0, 0);
  }

  // sum of absolute differences of the 16x16 (or 8x8 block k) source against
  // the prediction at half-pel vector (vx, vy)
  int sad(int mx, int my, int k, int vx, int vy) {
    int size = k < 0 ? 16 : 8;
    int ox = mx * 16 + (k > 0 ? (k & 1) * 8 : 0), oy = my * 16 + (k > 0 ? (k >> 1) * 8 : 0);
    uint8_t p[256];
    mc_block(st.ref.p[0], mbw * 16, mbh * 16, ox + (vx >> 1), oy + (vy >> 1),
             ((vy & 1) << 1) | (vx & 1), size, size, rounding != 0, p, size);
    int s = 0;
    for (int y = 0; y < size; y++) {
      const uint8_t* r = src.p[0].at(ox, oy + y);
      for (int x = 0; x < size; x++) s += std::abs(r[x] - p[y * size + x]);
    }
    return s;
  }

  // a small diamond search in full pels from `start`, then the 8 half-pel
  // neighbours; vectors stay inside f_code 1's range
  int search(int mx, int my, int k, int& vx, int& vy) {
    auto ok = [](int v) { return v >= -32 && v <= 31; };
    int best = sad(mx, my, k, vx, vy);
    for (int step = 0; step < 32; step++) {
      static const int d[4][2] = {{2, 0}, {-2, 0}, {0, 2}, {0, -2}};
      int bi = -1;
      for (int i = 0; i < 4; i++) {
        int x = vx + d[i][0], y = vy + d[i][1];
        if (!ok(x) || !ok(y)) continue;
        int s = sad(mx, my, k, x, y);
        if (s < best) { best = s; bi = i; }
      }
      if (bi < 0) break;
      vx += d[bi][0];
      vy += d[bi][1];
    }
    int cx = vx, cy = vy;
    for (int dy = -1; dy <= 1; dy++)
      for (int dx = -1; dx <= 1; dx++) {
        int x = cx + dx, y = cy + dy;
        if ((dx || dy) && ok(x) && ok(y)) {
          int s = sad(mx, my, k, x, y);
          if (s < best) { best = s; vx = x; vy = y; }
        }
      }
    return best;
  }

  void inter_mb(BitWriter& bw, int mx, int my) {
    const Tables& T = tables();
    int q = st.qscale;
    int px, py;
    st.predict_mv(mx, my, 0, px, py);
    int vx = 0, vy = 0, best = search(mx, my, -1, vx, vy);
    int wx = px & ~1, wy = py & ~1;  // also start from the predicted vector
    if (wx >= -32 && wx <= 31 && wy >= -32 && wy <= 31) {
      int s = search(mx, my, -1, wx, wy);
      if (s < best) { best = s; vx = wx; vy = wy; }
    }
    // intra when the prediction is poor (TMN's rule)
    int mean = 0, dev = 0;
    for (int y = 0; y < 16; y++) for (int x = 0; x < 16; x++) mean += src.p[0].at(mx * 16 + x, my * 16 + y)[0];
    mean /= 256;
    for (int y = 0; y < 16; y++) for (int x = 0; x < 16; x++) dev += std::abs(src.p[0].at(mx * 16 + x, my * 16 + y)[0] - mean);
    if (best >= dev + 500) { intra_mb(bw, mx, my, true); return; }
    int v[4][2];
    for (int k = 0; k < 4; k++) { v[k][0] = vx; v[k][1] = vy; }
    bool four = false;
    if (o.four_mv) {
      int sum = 0;
      for (int k = 0; k < 4; k++) sum += search(mx, my, k, v[k][0], v[k][1]);
      four = sum + 200 < best;
      if (!four) for (int k = 0; k < 4; k++) { v[k][0] = vx; v[k][1] = vy; }
    }
    st.predict_luma(mx, my, four, v);  // the decoder's prediction into st.cur
    int lv[6][64], cbp = 0;
    for (int b = 0; b < 6; b++) {
      int in[64], F[64];
      source_block(mx, my, b, &st.cur, in);
      fdct().run(in, F);
      if (quant_inter(F, q, lv[b])) cbp |= 32 >> b;
    }
    st.mbq[(size_t)my * mbw + mx] = q;
    if (!four && vx == 0 && vy == 0 && cbp == 0) {
      bw.put(1, 1);  // not coded
      for (int k = 0; k < 4; k++) st.set_mv(mx, my, k, 0, 0);
      return;
    }
    bw.put(0, 1);
    put_code(bw, kInterMcbpc, (four ? 16 : 0) + (cbp & 3));
    put_code(bw, kCbpy, (cbp >> 2) ^ 15);
    if (four) {
      for (int k = 0; k < 4; k++) {
        st.predict_mv(mx, my, k, px, py);
        put_mvd(bw, v[k][0] - px, 1);
        put_mvd(bw, v[k][1] - py, 1);
        st.set_mv(mx, my, k, v[k][0], v[k][1]);
      }
    } else {
      put_mvd(bw, vx - px, 1);
      put_mvd(bw, vy - py, 1);
      for (int k = 0; k < 4; k++) st.set_mv(mx, my, k, vx, vy);
    }
    for (int b = 0; b < 6; b++)
      if (cbp & (32 >> b)) put_block(bw, T.inter, lv[b], kZigzag, 0);
  }

  void write(const uint8_t* bgr) {
    int n = (int)sizes.size();
    bool intra = n % o.gop == 0;
    load(bgr);
    int64_t t = (int64_t)n * fps_den, sec = t / fps_num;
    BitWriter bw;
    bw.start_code(0xB6);
    bw.put(intra ? 0 : 1, 2);
    for (int64_t s = prev_sec; s < sec; s++) bw.put(1, 1);
    prev_sec = sec;
    bw.put(0, 1); bw.put(1, 1);
    bw.put((uint32_t)(t % fps_num), time_bits);
    bw.put(1, 1); bw.put(1, 1);  // marker, vop_coded
    rounding = intra ? 0 : rounding ^ 1;
    if (!intra) bw.put(rounding, 1);
    bw.put(o.dc_thr, 3);
    bw.put(o.qscale, 5);
    if (!intra) bw.put(1, 3);  // vop_fcode_forward
    st.qscale = o.qscale;
    st.rounding = rounding;
    st.vop_count++;
    std::fill(st.mvs.begin(), st.mvs.end(), 0);
    if (!intra) st.ref = recon.cur;
    for (int my = 0; my < mbh; my++)
      for (int mx = 0; mx < mbw; mx++) {
        if (intra) intra_mb(bw, mx, my, false);
        else inter_mb(bw, mx, my);
      }
    bw.stuffing();
    if (!recon.decode(bw.buf.data(), bw.buf.size())) fail("internal: VOP did not decode");
    if (fwrite(bw.buf.data(), 1, bw.buf.size(), f) != bw.buf.size()) fail("write failed");
    written += bw.buf.size();
    sizes.push_back((uint32_t)bw.buf.size());
    if (intra) sync.push_back((uint32_t)sizes.size());
  }

  // box helpers: a box is its 32-bit size, its type and its body
  void descriptor(std::vector<uint8_t>& out, int tag, const std::vector<uint8_t>& body) {
    out.push_back((uint8_t)tag);
    size_t n = body.size();
    out.push_back((uint8_t)(0x80 | ((n >> 21) & 0x7F)));
    out.push_back((uint8_t)(0x80 | ((n >> 14) & 0x7F)));
    out.push_back((uint8_t)(0x80 | ((n >> 7) & 0x7F)));
    out.push_back((uint8_t)(n & 0x7F));
    out.insert(out.end(), body.begin(), body.end());
  }

  void release() {
    uint64_t n = sizes.size();
    uint64_t dur = n * (uint64_t)delta;
    uint64_t bitrate = dur ? (uint64_t)(written * 8.0 * timescale / dur) : 0;
    std::vector<uint8_t> esds, es, dcd, sl;
    // the esds: ES_Descriptor(DecoderConfigDescriptor(DecoderSpecificInfo), SLConfig)
    dcd.push_back(0x20);  // MPEG-4 Visual
    dcd.push_back(0x11);  // visual stream
    put_be(dcd, 0, 3); put_be(dcd, bitrate, 4); put_be(dcd, bitrate, 4);
    descriptor(dcd, 5, config);
    put_be(es, 1, 2); es.push_back(0);
    descriptor(es, 4, dcd);
    sl.push_back(2);
    descriptor(es, 6, sl);
    put_be(esds, 0, 4);
    descriptor(esds, 3, es);
    MoovSpec spec;
    spec.width = width;
    spec.height = height;
    spec.timescale = timescale;
    spec.delta = delta;
    spec.entry_type = "mp4v";
    spec.entry = visual_entry(width, height);
    box(spec.entry, "esds", esds);
    spec.sizes = sizes;
    spec.sync = sync;
    spec.mdat_start = mdat_start;
    spec.big = mdat_start + written > 0xFFFFFFFFull;
    std::vector<uint8_t> out = build_moov(spec);
    if (fwrite(out.data(), 1, out.size(), f) != out.size()) fail("write failed");
    std::vector<uint8_t> size;
    put_be(size, 16 + written, 8);
    if (fseeko(f, (off_t)(mdat_start - 8), SEEK_SET) != 0 ||
        fwrite(size.data(), 1, 8, f) != 8)
      fail("write failed");
    if (fclose(f) != 0) { f = nullptr; fail("close failed"); }
    f = nullptr;
  }
};

}  // namespace

extern "C" {

// info = {frames, width, height, fps numerator, fps denominator}; width and
// height as displayed (after the display matrix's rotation)
void* mp4v_open(const char* path, int64_t* info, char* err, int errlen) {
  Reader* r = new Reader();
  try {
    r->open(path);
    const Movie& m = r->movie;
    bool swap = m.rotation == 90 || m.rotation == 270;
    info[0] = (int64_t)m.samples.size();
    info[1] = swap ? r->dec.vol.height : r->dec.vol.width;
    info[2] = swap ? r->dec.vol.width : r->dec.vol.height;
    info[3] = (int64_t)m.samples.size() * m.track.timescale;
    info[4] = (int64_t)m.total_delta;
    return r;
  } catch (const Error& e) {
    info[0] = report(e, err, errlen);
    delete r;
    return nullptr;
  }
}

// out: height x width x 3 BGR bytes; 1 with a frame, 0 at the end
int mp4v_read(void* h, uint8_t* out, char* err, int errlen) {
  try {
    return static_cast<Reader*>(h)->next_frame(out);
  } catch (const Error& e) {
    return report(e, err, errlen);
  }
}

void mp4v_close(void* h) { delete static_cast<Reader*>(h); }

// what the frames read so far used (Stat order); returns the count
int mp4v_stats(void* h, int64_t* out) {
  const Decoder& d = static_cast<Reader*>(h)->dec;
  for (int i = 0; i < kStatCount; i++) out[i] = d.stats[i];
  return kStatCount;
}

// opts = {qscale, gop, four_mv, ac_pred, quant_type, dc_thr}
void* mp4v_writer_open(const char* path, int width, int height, int fps_num, int fps_den,
                       const int* opts, char* err, int errlen) {
  Writer* w = new Writer();
  try {
    EncoderOptions o;
    o.qscale = opts[0];
    o.gop = opts[1];
    o.four_mv = opts[2] != 0;
    o.ac_pred = opts[3] != 0;
    o.quant_type = opts[4];
    o.dc_thr = opts[5];
    w->open(path, width, height, fps_num, fps_den, o);
    return w;
  } catch (const Error& e) {
    report(e, err, errlen);
    delete w;
    return nullptr;
  }
}

// bgr: height x width x 3 bytes
int mp4v_writer_write(void* h, const uint8_t* bgr, char* err, int errlen) {
  try {
    static_cast<Writer*>(h)->write(bgr);
    return 0;
  } catch (const Error& e) {
    return report(e, err, errlen);
  }
}

// writes the moov box and closes the file; frees the writer
int mp4v_writer_close(void* h, char* err, int errlen) {
  Writer* w = static_cast<Writer*>(h);
  int code = 0;
  try {
    w->release();
  } catch (const Error& e) {
    code = report(e, err, errlen);
  }
  delete w;
  return code;
}

}  // extern "C"

