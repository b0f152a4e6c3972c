// Bitstream plumbing that the H.264 (h264.h) and H.265 (hevc.h) codecs and
// their test-stream writers share: an RBSP read or written MSB first with
// Exp-Golomb codes, the CABAC arithmetic engine both standards define, the
// emulation prevention of NAL unit payloads, and the writers' seeded draws
// and "key=value;..." options. Everything has internal linkage: each codec
// is its own library.

#pragma once

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <string>
#include <vector>

#include "mp4.h"

namespace {

// CABAC: rangeTabLPS (Table 9-44) and transIdxLPS (Table 9-45)
const uint8_t kRangeLps[64][4] = {
    {128, 176, 208, 240}, {128, 167, 197, 227}, {128, 158, 187, 216}, {123, 150, 178, 205},
    {116, 142, 169, 195}, {111, 135, 160, 185}, {105, 128, 152, 175}, {100, 122, 144, 166},
    {95, 116, 137, 158},  {90, 110, 130, 150},  {85, 104, 123, 142},  {81, 99, 117, 135},
    {77, 94, 111, 128},   {73, 89, 105, 122},   {69, 85, 100, 116},   {66, 80, 95, 110},
    {62, 76, 90, 104},    {59, 72, 86, 99},     {56, 69, 81, 94},     {53, 65, 77, 89},
    {51, 62, 73, 85},     {48, 59, 69, 80},     {46, 56, 66, 76},     {43, 53, 63, 72},
    {41, 50, 59, 69},     {39, 48, 56, 65},     {37, 45, 54, 62},     {35, 43, 51, 59},
    {33, 41, 48, 56},     {32, 39, 46, 53},     {30, 37, 43, 50},     {29, 35, 41, 48},
    {27, 33, 39, 45},     {26, 31, 37, 43},     {24, 30, 35, 41},     {23, 28, 33, 39},
    {22, 27, 32, 37},     {21, 26, 30, 35},     {20, 24, 29, 33},     {19, 23, 27, 31},
    {18, 22, 26, 30},     {17, 21, 25, 28},     {16, 20, 23, 27},     {15, 19, 22, 25},
    {14, 18, 21, 24},     {14, 17, 20, 23},     {13, 16, 19, 22},     {12, 15, 18, 21},
    {12, 14, 17, 20},     {11, 14, 16, 19},     {11, 13, 15, 18},     {10, 12, 15, 17},
    {10, 12, 14, 16},     {9, 11, 13, 15},      {9, 11, 12, 14},      {8, 10, 12, 14},
    {8, 9, 11, 13},       {7, 9, 11, 12},       {7, 9, 10, 12},       {7, 8, 10, 11},
    {6, 8, 9, 11},        {6, 7, 9, 10},        {6, 7, 8, 9},         {2, 2, 2, 2}};
const uint8_t kTransLps[64] = {0,  0,  1,  2,  2,  4,  4,  5,  6,  7,  8,  9,  9,  11, 11, 12,
                               13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24,
                               24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
                               33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63};

// ------------------------------------------------------------- bit I/O --
// An RBSP (emulation prevention removed) read or written MSB first.
struct Bits {
  bool writing = false;
  const uint8_t* d = nullptr;
  size_t nbytes = 0, pos = 0, end_bits = 0;  // end_bits: the position of the stop bit
  std::vector<uint8_t> out;
  uint32_t acc = 0;
  int nacc = 0;

  void start_read(const uint8_t* data, size_t n) {
    writing = false;
    d = data;
    nbytes = n;
    pos = 0;
    // rbsp_stop_one_bit: the last 1 bit (trailing zero bytes, cabac_zero_words, skipped)
    size_t i = n;
    while (i > 0 && d[i - 1] == 0) i--;
    end_bits = 0;
    if (i > 0) {
      int b = 0;
      while (!((d[i - 1] >> b) & 1)) b++;
      end_bits = (i - 1) * 8 + (7 - b);
    }
  }
  void start_write() {
    writing = true;
    out.clear();
    acc = 0;
    nacc = 0;
  }
  inline int get1() {
    if (pos >= nbytes * 8) fail("read past the end of a NAL unit");
    int b = (d[pos >> 3] >> (7 - (pos & 7))) & 1;
    pos++;
    return b;
  }
  uint32_t getn(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++) v = (v << 1) | get1();
    return v;
  }
  uint32_t peek(int n) const {  // n <= 24, zeros past the end
    uint32_t v = 0;
    for (int i = 0; i < n; i++) {
      size_t p = pos + i;
      int b = p < nbytes * 8 ? (d[p >> 3] >> (7 - (p & 7))) & 1 : 0;
      v = (v << 1) | b;
    }
    return v;
  }
  void put(uint32_t v, int n) {
    for (int i = n - 1; i >= 0; i--) {
      acc = (acc << 1) | ((v >> i) & 1);
      if (++nacc == 8) {
        out.push_back((uint8_t)acc);
        acc = 0;
        nacc = 0;
      }
    }
  }
  uint32_t u(int n, uint32_t v = 0) {
    if (writing) { put(v, n); return v; }
    return getn(n);
  }
  int flag(int v = 0) { return (int)u(1, v ? 1 : 0); }
  uint32_t ue(uint32_t v = 0) {
    if (writing) {
      uint32_t x = v + 1;
      int len = 0;
      while ((x >> len) > 1) len++;
      put(0, len);
      put(x, len + 1);
      return v;
    }
    int zeros = 0;
    while (!get1()) {
      if (++zeros > 31) fail("invalid Exp-Golomb code");
    }
    return ((1u << zeros) - 1) + getn(zeros);
  }
  int32_t se(int32_t v = 0) {
    if (writing) {
      ue(v > 0 ? 2 * (uint32_t)v - 1 : 2 * (uint32_t)(-v));
      return v;
    }
    uint32_t k = ue();
    return (k & 1) ? (int32_t)((k + 1) / 2) : -(int32_t)(k / 2);
  }
  // unary: `zeros` zero bits then a one
  int leading_zeros(int zeros = 0) {
    if (writing) { put(0, zeros); put(1, 1); return zeros; }
    int z = 0;
    while (!get1()) {
      if (++z > 32) fail("invalid level_prefix");
    }
    return z;
  }
  // a prefix code from parallel (code, length) tables of n entries: returns
  // the index (writer: writes entry v)
  int vlc(const uint8_t* bits, const uint8_t* len, int n, int v, int stride = 1) {
    if (writing) { put(bits[v * stride], len[v * stride]); return v; }
    for (int i = 0; i < n; i++) {
      int l = len[i * stride];
      if (l && peek(l) == bits[i * stride]) { pos += l; return i; }
    }
    fail("invalid variable-length code");
  }
  bool aligned() const { return writing ? nacc == 0 : (pos & 7) == 0; }
  bool more_rbsp_data() const { return pos < end_bits; }
  void trailing() {  // rbsp_trailing_bits
    put(1, 1);
    while (nacc) put(0, 1);
  }
};

// --------------------------------------------------------------- CABAC --
// The arithmetic decoding and encoding engines of H.264 9.3.1.2, 9.3.3.2 and
// 9.3.4, which H.265 (9.3.4.3, 9.3.5) keeps as they are; N contexts, each
// initialised by the codec.
template <int N>
struct CabacEngine {
  Bits* b = nullptr;
  uint8_t state[N];  // pStateIdx | valMPS << 6
  uint32_t range = 510, offset = 0, low = 0;
  int outstanding = 0;
  bool first = true;

  void start() {
    range = 510;
    if (b->writing) {
      low = 0;
      outstanding = 0;
      first = true;
    } else {
      offset = b->getn(9);
    }
  }
  void put_bit(int v) {
    if (first) first = false;
    else b->put(v, 1);
    while (outstanding > 0) {
      b->put(1 - v, 1);
      outstanding--;
    }
  }
  void renorm_e() {
    while (range < 256) {
      if (low < 256) put_bit(0);
      else if (low >= 512) { low -= 512; put_bit(1); }
      else { low -= 256; outstanding++; }
      range <<= 1;
      low <<= 1;
    }
  }
  int bin(int ctx, int v = 0) {
    uint8_t& s = state[ctx];
    int p = s & 63, mps = s >> 6;
    uint32_t lps = kRangeLps[p][(range >> 6) & 3];
    range -= lps;
    int bit;
    if (b->writing) {
      bit = v ? 1 : 0;
      if (bit != mps) {
        low += range;
        range = lps;
      }
    } else {
      if (offset >= range) {
        bit = !mps;
        offset -= range;
        range = lps;
      } else {
        bit = mps;
      }
    }
    if (bit != mps) {
      if (p == 0) mps = 1 - mps;
      p = kTransLps[p];
    } else {
      p = std::min(p + 1, 62);
    }
    s = (uint8_t)(p | (mps << 6));
    if (b->writing) renorm_e();
    else
      while (range < 256) {
        range <<= 1;
        offset = (offset << 1) | b->get1();
      }
    return bit;
  }
  int bypass(int v = 0) {
    if (b->writing) {
      low <<= 1;
      if (v) low += range;
      if (low >= 1024) { put_bit(1); low -= 1024; }
      else if (low < 512) put_bit(0);
      else { low -= 512; outstanding++; }
      return v ? 1 : 0;
    }
    offset = (offset << 1) | b->get1();
    if (offset >= range) { offset -= range; return 1; }
    return 0;
  }
  // the storage and synchronization of the context variables (H.265 9.3.2.4)
  void save(uint8_t* to) const { memcpy(to, state, N); }
  void load(const uint8_t* from) { memcpy(state, from, N); }
  int terminate(int v = 0) {
    range -= 2;
    if (b->writing) {
      if (v) {
        low += range;
        // EncodeFlush: the last bit written is the 1 that ends the slice,
        // comes before the I_PCM samples' alignment or is the first bit of
        // the byte_alignment( ) after H.265's end_of_subset_one_bit
        range = 2;
        renorm_e();
        put_bit((low >> 9) & 1);
        b->put(((low >> 7) & 3) | 1, 2);
        return 1;
      }
      renorm_e();
      return 0;
    }
    if (offset >= range) return 1;
    while (range < 256) {
      range <<= 1;
      offset = (offset << 1) | b->get1();
    }
    return 0;
  }
  // H.265's end of a substream (7.3.8.1): end_of_subset_one_bit, then
  // byte_alignment( ) (its one bit is the flush's last) and the engine
  // started again at the next byte (9.3.2.5), whose RBSP position it returns
  size_t restart() {
    if (!terminate(1)) fail("end_of_subset_one_bit is 0");
    while (!b->aligned()) b->u(1, 0);
    size_t at = b->writing ? b->out.size() : b->pos >> 3;
    start();
    return at;
  }
};

// NAL unit payload with emulation_prevention_three_byte removed; removed,
// if given, gets the RBSP position of the byte each removed one came before
std::vector<uint8_t> unescape(const uint8_t* d, size_t n, std::vector<uint32_t>* removed = nullptr) {
  std::vector<uint8_t> out;
  out.reserve(n);
  if (removed) removed->clear();
  int zeros = 0;
  for (size_t i = 0; i < n; i++) {
    if (zeros >= 2 && d[i] == 3) {
      zeros = 0;
      if (removed) removed->push_back((uint32_t)out.size());
      continue;
    }
    zeros = d[i] == 0 ? zeros + 1 : 0;
    out.push_back(d[i]);
  }
  return out;
}

// a NAL unit: its header bytes, then the RBSP with emulation_prevention_three_byte
// inserted wherever two zero bytes come before a byte <= 3
std::vector<uint8_t> escape_rbsp(std::vector<uint8_t> out, const std::vector<uint8_t>& rbsp) {
  int zeros = 0;
  for (uint8_t b : rbsp) {
    if (zeros >= 2 && b <= 3) {
      out.push_back(3);
      zeros = 0;
    }
    out.push_back(b);
    zeros = b == 0 ? zeros + 1 : 0;
  }
  return out;
}

// An SEI RBSP of one message (payload type and size coded in bytes of 255
// and a last byte), with its trailing bits: the writers' SEI NAL units
std::vector<uint8_t> sei_rbsp(int type, const std::vector<uint8_t>& payload) {
  std::vector<uint8_t> r;
  for (int v : {type, (int)payload.size()}) {
    for (; v >= 255; v -= 255) r.push_back(255);
    r.push_back((uint8_t)v);
  }
  r.insert(r.end(), payload.begin(), payload.end());
  r.push_back(0x80);
  return r;
}

// ------------------------------------------------- the writers' options --
struct Rng {  // splitmix64
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed * 0x9E3779B97F4A7C15ull + 1) {}
  uint64_t next() {
    uint64_t z = (s += 0x9E3779B97F4A7C15ull);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
  }
  int range(int lo, int hi) { return lo + (int)(next() % (uint64_t)(hi - lo + 1)); }  // inclusive
  bool chance(double p) { return (next() >> 11) * (1.0 / 9007199254740992.0) < p; }
};

struct Options {
  std::map<std::string, std::string> kv;
  void parse(const char* s) {
    std::string all = s ? s : "", item;
    size_t i = 0;
    while (i <= all.size()) {
      size_t j = all.find(';', i);
      if (j == std::string::npos) j = all.size();
      item = all.substr(i, j - i);
      size_t e = item.find('=');
      if (!item.empty()) {
        if (e == std::string::npos) fail("writer option without a value: " + item);
        kv[item.substr(0, e)] = item.substr(e + 1);
      }
      i = j + 1;
    }
  }
  int get(const std::string& k, int def) const {
    auto it = kv.find(k);
    return it == kv.end() ? def : std::atoi(it->second.c_str());
  }
  double getf(const std::string& k, double def) const {
    auto it = kv.find(k);
    return it == kv.end() ? def : std::atof(it->second.c_str());
  }
  std::string gets(const std::string& k, const std::string& def) const {
    auto it = kv.find(k);
    return it == kv.end() ? def : it->second;
  }
};

}  // namespace
