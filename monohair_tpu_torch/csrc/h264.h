// H.264 (ITU-T Rec. H.264 | ISO/IEC 14496-10) syntax, reconstruction and
// picture management on the host, shared by the decoder (h264.cpp) and the
// test-stream writer (h264_writer.cpp).
//
// The syntax is written once: every syntax element goes through a call that
// reads it from the bitstream (decoder) or writes the value it is given
// (writer) and returns the value either way, so both sides walk the same
// parse, keep the same neighbour state (CAVLC nC, CABAC ctxIdxInc, motion
// vector prediction, intra mode prediction) and reconstruct the same
// pictures. The writer's streams are held against FFmpeg's decoder (cv2),
// never only against this decoder.
//
// Scope: progressive (frame_mbs_only_flag 1) 8-bit 4:2:0 I, P and B slices of
// the Constrained Baseline, Main and High profiles, CAVLC and CABAC: Intra
// 4x4/8x8/16x16 and I_PCM, P_L0 16x16/16x8/8x16, P_8x8(ref0) with
// sub-partitions, P_Skip, every B mb_type and sub_mb_type, B_Skip and
// B_Direct_16x16 with spatial and temporal direct prediction (with and
// without direct_8x8_inference), bi-prediction with default, explicit and
// implicit weights, the 8x8 transform, flat or loaded scaling lists
// (fall-back rules A and B), explicit weighted prediction, long-term
// references and MMCO 1-6, ref_pic_list_modification of both lists, B
// pictures used as references, POC types 0-2, several slices a picture of
// mixed types, the deblocking filter with disable_deblocking_filter_idc 0-2
// and its offsets, constrained_intra_pred. Where FFmpeg (cv2) departs from the
// standard, its way is taken, as each place says: the pictures it outputs
// and drops (h264_select_output_frame), the POC it keeps after an MMCO 5,
// the co-located picture's lists that
// its frame threads keep, the weighting of its x86 SIMD, its fast loop
// filter's bS for 8x8-transform macroblocks. Everything else is
// refused by name (Error code 2): SP and SI slices, fields and MBAFF, chroma
// formats other than 4:2:0, bit depths above 8, the transform bypass, slice
// groups, redundant pictures, data partitioning, gaps in frame_num, reference
// lists longer than the references held.

#pragma once

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <string>
#include <vector>

#include "h264_tables.h"
#include "mp4.h"

namespace {

const int kNoDc = -(1 << 30);  // scale4( ): position 0 is scaled like the others

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : v > hi ? hi : v; }
inline int median3(int a, int b, int c) {
  return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

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
// The arithmetic decoding and encoding engines of 9.3.1.2, 9.3.3.2 and 9.3.4.
struct Cabac {
  Bits* b = nullptr;
  uint8_t state[460];  // pStateIdx | valMPS << 6
  uint32_t range = 510, offset = 0, low = 0;
  int outstanding = 0;
  bool first = true;

  void init_contexts(int slice_is_i, int idc, int qp) {
    const int8_t(*t)[2] = kCabacInit[slice_is_i ? 0 : 1 + idc];
    for (int i = 0; i < 460; i++) {
      int pre = clip3(1, 126, ((t[i][0] * clip3(0, 51, qp)) >> 4) + t[i][1]);
      state[i] = pre <= 63 ? (uint8_t)(63 - pre) : (uint8_t)((pre - 64) | 64);
    }
  }
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
  int terminate(int v = 0) {
    range -= 2;
    if (b->writing) {
      if (v) {
        low += range;
        // EncodeFlush: the last bit written is the 1 that ends the slice or
        // comes before the I_PCM samples' alignment
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
};

// --------------------------------------------------- parameter sets --
struct SPS {
  bool valid = false;
  int profile_idc = 100, constraint_flags = 0, level_idc = 40, id = 0;
  int chroma_format_idc = 1, separate_colour_plane = 0, bit_depth_luma = 8, bit_depth_chroma = 8;
  int qpprime_bypass = 0, scaling_matrix_present = 0;
  int list_present[8] = {0};
  int use_default[8] = {0};
  uint8_t lists[8][64];    // as coded (zig-zag), when present
  uint8_t sl4[6][16];      // the lists in effect (zig-zag), after fall-back
  uint8_t sl8[2][64];
  int log2_max_frame_num = 4, poc_type = 0, log2_max_poc_lsb = 4, delta_pic_order_always_zero = 0;
  int offset_for_non_ref_pic = 0, offset_for_top_to_bottom_field = 0;
  int num_ref_frames_in_poc_cycle = 0;
  int offset_for_ref_frame[256] = {0};
  int max_num_ref_frames = 1, gaps_allowed = 0, mbw = 0, mbh = 0;
  int frame_mbs_only = 1, mb_adaptive = 0, direct_8x8_inference = 1;
  int cropping = 0, crop[4] = {0, 0, 0, 0};  // left, right, top, bottom (in 2-sample units)
  int vui_present = 0;
  int aspect_info = 0, aspect_idc = 0, sar_w = 0, sar_h = 0, overscan_info = 0, overscan_ok = 0;
  int signal_type = 0, video_format = 5, full_range = 0, colour_desc = 0, primaries = 2,
      transfer = 2, matrix = 2;
  int chroma_loc = 0, chroma_loc_top = 0, chroma_loc_bottom = 0;
  int timing = 0;
  uint32_t units_in_tick = 1, time_scale = 60;
  int fixed_rate = 0, nal_hrd = 0, vcl_hrd = 0, low_delay_hrd = 0, pic_struct = 0;
  int restriction = 0, mv_over_bounds = 1, max_bytes_denom = 0, max_bits_denom = 0,
      log2_mv_h = 15, log2_mv_v = 15, num_reorder = 0, max_dec_buffering = 1;
  bool high() const {
    switch (profile_idc) {
      case 100: case 110: case 122: case 244: case 44: case 83: case 86: case 118: case 128:
      case 138: case 139: case 134: case 135:
        return true;
    }
    return false;
  }
};

struct PPS {
  bool valid = false;
  int id = 0, sps_id = 0, cabac = 0, bottom_field_pic_order = 0, num_slice_groups = 1;
  int num_ref_idx_default[2] = {1, 1};
  int weighted_pred = 0, weighted_bipred_idc = 0, pic_init_qp = 26, pic_init_qs = 26;
  int cb_qp_offset = 0, cr_qp_offset = 0, deblocking_control = 0, constrained_intra_pred = 0;
  int redundant_pic_cnt_present = 0, has_ext = 0, transform_8x8 = 0, scaling_matrix_present = 0;
  int list_present[8] = {0};
  int use_default[8] = {0};
  uint8_t lists[8][64];
  uint8_t sl4[6][16], sl8[2][64];  // in effect for the slices (zig-zag)
};

// scaling_list( ) of 7.3.2.1.1.1: list in zig-zag order; the writer gives
// the list (and use_default) and codes the shortest delta run
void scaling_list(Bits& b, uint8_t* list, int n, int& use_default) {
  int last = 8, next = 8;
  for (int j = 0; j < n; j++) {
    if (next != 0) {
      int delta = 0;
      if (b.writing) {
        int want;
        if (j == 0 && use_default) want = 0;
        else {
          bool rest_same = j > 0;
          for (int k = j; k < n && rest_same; k++) rest_same = list[k] == last;
          want = rest_same ? 0 : list[j];
        }
        delta = (want - last + 256) % 256;
        if (delta > 127) delta -= 256;
      }
      delta = b.se(delta);
      if (delta < -128 || delta > 127) fail("delta_scale out of range");
      next = (last + delta + 256) % 256;
      use_default = (j == 0 && next == 0);
      if (use_default) return;
    }
    list[j] = (uint8_t)(next == 0 ? last : next);
    last = list[j];
  }
}

// hrd_parameters( ); the writer codes one CPB of fixed, plausible values
void hrd_parameters(Bits& b) {
  int cnt = (int)b.ue(0) + 1;
  if (cnt > 32) fail("cpb_cnt_minus1 > 31");
  b.u(4, 4);  // bit_rate_scale
  b.u(4, 6);  // cpb_size_scale
  for (int i = 0; i < cnt; i++) {
    b.ue(2499);  // bit_rate_value_minus1
    b.ue(4999);  // cpb_size_value_minus1
    b.u(1, 0);   // cbr_flag
  }
  b.u(5, 23);  // initial_cpb_removal_delay_length_minus1
  b.u(5, 23);  // cpb_removal_delay_length_minus1
  b.u(5, 23);  // dpb_output_delay_length_minus1
  b.u(5, 24);  // time_offset_length
}

// seq_parameter_set_rbsp( ) without the trailing bits; refuses what is out of scope
void sps_syntax(Bits& b, SPS& s) {
  s.profile_idc = b.u(8, s.profile_idc);
  s.constraint_flags = b.u(8, s.constraint_flags);
  s.level_idc = b.u(8, s.level_idc);
  s.id = b.ue(s.id);
  if (s.id > 31) fail("seq_parameter_set_id > 31");
  if (s.high()) {
    s.chroma_format_idc = b.ue(s.chroma_format_idc);
    if (s.chroma_format_idc == 3) s.separate_colour_plane = b.flag(s.separate_colour_plane);
    s.bit_depth_luma = b.ue(s.bit_depth_luma - 8) + 8;
    s.bit_depth_chroma = b.ue(s.bit_depth_chroma - 8) + 8;
    s.qpprime_bypass = b.flag(s.qpprime_bypass);
    s.scaling_matrix_present = b.flag(s.scaling_matrix_present);
    if (s.scaling_matrix_present) {
      int n = s.chroma_format_idc != 3 ? 8 : 12;
      if (n > 8) unsupported("chroma_format_idc 3 (4:4:4)");
      for (int i = 0; i < n; i++) {
        s.list_present[i] = b.flag(s.list_present[i]);
        if (s.list_present[i]) scaling_list(b, s.lists[i], i < 6 ? 16 : 64, s.use_default[i]);
      }
    }
  } else {
    s.chroma_format_idc = 1;
    s.bit_depth_luma = s.bit_depth_chroma = 8;
    s.qpprime_bypass = 0;
    s.scaling_matrix_present = 0;
  }
  if (s.chroma_format_idc != 1)
    unsupported("chroma_format_idc " + std::to_string(s.chroma_format_idc) +
                " (only 4:2:0 is decoded)");
  if (s.bit_depth_luma != 8 || s.bit_depth_chroma != 8)
    unsupported("bit depth " + std::to_string(s.bit_depth_luma) + "/" +
                std::to_string(s.bit_depth_chroma) + " (only 8 bits are decoded)");
  if (s.qpprime_bypass) unsupported("qpprime_y_zero_transform_bypass_flag (lossless macroblocks)");
  s.log2_max_frame_num = b.ue(s.log2_max_frame_num - 4) + 4;
  if (s.log2_max_frame_num > 16) fail("log2_max_frame_num > 16");
  s.poc_type = b.ue(s.poc_type);
  if (s.poc_type == 0) {
    s.log2_max_poc_lsb = b.ue(s.log2_max_poc_lsb - 4) + 4;
    if (s.log2_max_poc_lsb > 16) fail("log2_max_pic_order_cnt_lsb > 16");
  } else if (s.poc_type == 1) {
    s.delta_pic_order_always_zero = b.flag(s.delta_pic_order_always_zero);
    s.offset_for_non_ref_pic = b.se(s.offset_for_non_ref_pic);
    s.offset_for_top_to_bottom_field = b.se(s.offset_for_top_to_bottom_field);
    s.num_ref_frames_in_poc_cycle = b.ue(s.num_ref_frames_in_poc_cycle);
    if (s.num_ref_frames_in_poc_cycle > 255) fail("num_ref_frames_in_pic_order_cnt_cycle > 255");
    for (int i = 0; i < s.num_ref_frames_in_poc_cycle; i++)
      s.offset_for_ref_frame[i] = b.se(s.offset_for_ref_frame[i]);
  } else if (s.poc_type != 2) {
    fail("pic_order_cnt_type > 2");
  }
  s.max_num_ref_frames = b.ue(s.max_num_ref_frames);
  if (s.max_num_ref_frames > 16) fail("max_num_ref_frames > 16");
  s.gaps_allowed = b.flag(s.gaps_allowed);
  s.mbw = b.ue(s.mbw - 1) + 1;
  s.mbh = b.ue(s.mbh - 1) + 1;
  s.frame_mbs_only = b.flag(s.frame_mbs_only);
  if (!s.frame_mbs_only) {
    s.mb_adaptive = b.flag(s.mb_adaptive);
    unsupported("frame_mbs_only_flag 0 (field pictures or MBAFF)");
  }
  if (s.mbw > 512 || s.mbh > 512) fail("picture larger than 8192x8192");
  s.direct_8x8_inference = b.flag(s.direct_8x8_inference);
  s.cropping = b.flag(s.cropping);
  if (s.cropping)
    for (int i = 0; i < 4; i++) s.crop[i] = b.ue(s.crop[i]);
  else
    s.crop[0] = s.crop[1] = s.crop[2] = s.crop[3] = 0;
  if (2 * (s.crop[0] + s.crop[1]) >= 16 * s.mbw || 2 * (s.crop[2] + s.crop[3]) >= 16 * s.mbh)
    fail("frame cropping removes the whole picture");
  s.vui_present = b.flag(s.vui_present);
  if (s.vui_present) {
    s.aspect_info = b.flag(s.aspect_info);
    if (s.aspect_info) {
      s.aspect_idc = b.u(8, s.aspect_idc);
      if (s.aspect_idc == 255) {
        s.sar_w = b.u(16, s.sar_w);
        s.sar_h = b.u(16, s.sar_h);
      }
    }
    s.overscan_info = b.flag(s.overscan_info);
    if (s.overscan_info) s.overscan_ok = b.flag(s.overscan_ok);
    s.signal_type = b.flag(s.signal_type);
    if (s.signal_type) {
      s.video_format = b.u(3, s.video_format);
      s.full_range = b.flag(s.full_range);
      s.colour_desc = b.flag(s.colour_desc);
      if (s.colour_desc) {
        s.primaries = b.u(8, s.primaries);
        s.transfer = b.u(8, s.transfer);
        s.matrix = b.u(8, s.matrix);
      }
    }
    s.chroma_loc = b.flag(s.chroma_loc);
    if (s.chroma_loc) {
      s.chroma_loc_top = b.ue(s.chroma_loc_top);
      s.chroma_loc_bottom = b.ue(s.chroma_loc_bottom);
    }
    s.timing = b.flag(s.timing);
    if (s.timing) {
      uint32_t hi = b.u(16, s.units_in_tick >> 16);
      s.units_in_tick = hi << 16 | b.u(16, s.units_in_tick & 0xFFFF);
      hi = b.u(16, s.time_scale >> 16);
      s.time_scale = hi << 16 | b.u(16, s.time_scale & 0xFFFF);
      s.fixed_rate = b.flag(s.fixed_rate);
    }
    s.nal_hrd = b.flag(s.nal_hrd);
    if (s.nal_hrd) hrd_parameters(b);
    s.vcl_hrd = b.flag(s.vcl_hrd);
    if (s.vcl_hrd) hrd_parameters(b);
    if (s.nal_hrd || s.vcl_hrd) s.low_delay_hrd = b.flag(s.low_delay_hrd);
    s.pic_struct = b.flag(s.pic_struct);
    s.restriction = b.flag(s.restriction);
    if (s.restriction) {
      s.mv_over_bounds = b.flag(s.mv_over_bounds);
      s.max_bytes_denom = b.ue(s.max_bytes_denom);
      s.max_bits_denom = b.ue(s.max_bits_denom);
      s.log2_mv_h = b.ue(s.log2_mv_h);
      s.log2_mv_v = b.ue(s.log2_mv_v);
      s.num_reorder = b.ue(s.num_reorder);
      s.max_dec_buffering = b.ue(s.max_dec_buffering);
      if (s.num_reorder > 16) fail("max_num_reorder_frames > 16");
    }
  }
  // the lists in effect: fall-back rule A (Table 7-2)
  for (int i = 0; i < 6; i++) {
    if (!s.scaling_matrix_present) { memset(s.sl4[i], 16, 16); continue; }
    if (s.list_present[i] && !s.use_default[i]) memcpy(s.sl4[i], s.lists[i], 16);
    else if (s.list_present[i] || i == 0 || i == 3) memcpy(s.sl4[i], kDefault4[i / 3], 16);
    else memcpy(s.sl4[i], s.sl4[i - 1], 16);
  }
  for (int i = 0; i < 2; i++) {
    if (!s.scaling_matrix_present) { memset(s.sl8[i], 16, 64); continue; }
    if (s.list_present[6 + i] && !s.use_default[6 + i]) memcpy(s.sl8[i], s.lists[6 + i], 64);
    else memcpy(s.sl8[i], kDefault8[i], 64);
  }
  s.valid = true;
}

// pic_parameter_set_rbsp( ) without the trailing bits
void pps_syntax(Bits& b, PPS& p, const SPS* sps_table) {
  p.id = b.ue(p.id);
  if (p.id > 255) fail("pic_parameter_set_id > 255");
  p.sps_id = b.ue(p.sps_id);
  if (p.sps_id > 31 || !sps_table[p.sps_id].valid)
    fail("picture parameter set refers to a missing sequence parameter set");
  const SPS& s = sps_table[p.sps_id];
  p.cabac = b.flag(p.cabac);
  p.bottom_field_pic_order = b.flag(p.bottom_field_pic_order);
  p.num_slice_groups = b.ue(p.num_slice_groups - 1) + 1;
  if (p.num_slice_groups > 1)
    unsupported("slice groups (FMO, num_slice_groups_minus1 " +
                std::to_string(p.num_slice_groups - 1) + ")");
  p.num_ref_idx_default[0] = b.ue(p.num_ref_idx_default[0] - 1) + 1;
  p.num_ref_idx_default[1] = b.ue(p.num_ref_idx_default[1] - 1) + 1;
  if (p.num_ref_idx_default[0] > 32 || p.num_ref_idx_default[1] > 32)
    fail("num_ref_idx_default_active > 32");
  p.weighted_pred = b.flag(p.weighted_pred);
  p.weighted_bipred_idc = b.u(2, p.weighted_bipred_idc);
  if (p.weighted_bipred_idc > 2) fail("weighted_bipred_idc 3");
  p.pic_init_qp = b.se(p.pic_init_qp - 26) + 26;
  p.pic_init_qs = b.se(p.pic_init_qs - 26) + 26;
  p.cb_qp_offset = b.se(p.cb_qp_offset);
  if (p.pic_init_qp < 0 || p.pic_init_qp > 51 || p.cb_qp_offset < -12 || p.cb_qp_offset > 12)
    fail("pic_init_qp or chroma_qp_index_offset out of range");
  p.deblocking_control = b.flag(p.deblocking_control);
  p.constrained_intra_pred = b.flag(p.constrained_intra_pred);
  p.redundant_pic_cnt_present = b.flag(p.redundant_pic_cnt_present);
  bool ext = b.writing ? p.has_ext != 0 : b.more_rbsp_data();
  p.has_ext = ext;
  if (!ext) {
    p.transform_8x8 = 0;
    p.scaling_matrix_present = 0;
    p.cr_qp_offset = p.cb_qp_offset;
  } else {
    p.transform_8x8 = b.flag(p.transform_8x8);
    p.scaling_matrix_present = b.flag(p.scaling_matrix_present);
    if (p.scaling_matrix_present) {
      int n = 6 + 2 * p.transform_8x8;
      for (int i = 0; i < n; i++) {
        p.list_present[i] = b.flag(p.list_present[i]);
        if (p.list_present[i]) scaling_list(b, p.lists[i], i < 6 ? 16 : 64, p.use_default[i]);
      }
    }
    p.cr_qp_offset = b.se(p.cr_qp_offset);
    if (p.cr_qp_offset < -12 || p.cr_qp_offset > 12)
      fail("second_chroma_qp_index_offset out of range");
  }
  // the lists in effect: the sequence's, or fall-back rule A (the sequence
  // has no lists) or B (it has) for the lists the picture leaves out
  if (!p.scaling_matrix_present) {
    memcpy(p.sl4, s.sl4, sizeof p.sl4);
    memcpy(p.sl8, s.sl8, sizeof p.sl8);
  } else {
    bool rule_b = s.scaling_matrix_present != 0;
    for (int i = 0; i < 6; i++) {
      if (p.list_present[i] && !p.use_default[i]) memcpy(p.sl4[i], p.lists[i], 16);
      else if (p.list_present[i]) memcpy(p.sl4[i], kDefault4[i / 3], 16);
      else if (i == 0 || i == 3)
        memcpy(p.sl4[i], rule_b ? s.sl4[i] : kDefault4[i / 3], 16);
      else memcpy(p.sl4[i], p.sl4[i - 1], 16);
    }
    for (int i = 0; i < 2; i++) {
      bool present = i < 2 * p.transform_8x8 && p.list_present[6 + i];
      if (present && !p.use_default[6 + i]) memcpy(p.sl8[i], p.lists[6 + i], 64);
      else if (present) memcpy(p.sl8[i], kDefault8[i], 64);
      else memcpy(p.sl8[i], rule_b ? s.sl8[i] : kDefault8[i], 64);
    }
  }
  p.valid = true;
}

// ------------------------------------------------------- slice header --
struct Mmco {
  int op = 0, diff = 0, lt_pic_num = 0, lt_idx = 0, max_lt_plus1 = 0;
};
struct RefMod {
  int idc = 3, val = 0;
};

struct SliceHeader {
  int nal_ref_idc = 1, nal_type = 5;
  int first_mb = 0, slice_type = 2, type = 2;  // type: 0 P, 1 B, 2 I, 3 SP, 4 SI
  int pps_id = 0, frame_num = 0, idr_pic_id = 0, poc_lsb = 0, delta_poc_bottom = 0;
  int delta_poc[2] = {0, 0};
  int redundant_pic_cnt = 0;
  int direct_spatial = 1;
  int override = 0, num_ref_idx_active[2] = {1, 1};
  int ref_mod_flag[2] = {0, 0};
  std::vector<RefMod> mods[2];
  int luma_log2_wd = 0, chroma_log2_wd = 0;
  int luma_flag[2][32] = {{0}}, chroma_flag[2][32] = {{0}};
  int luma_w[2][32], luma_o[2][32], chroma_w[2][32][2], chroma_o[2][32][2];
  int no_output_prior = 0, long_term_ref = 0, adaptive = 0;
  std::vector<Mmco> mmcos;
  int cabac_init_idc = 0, qp_delta = 0, qp = 26;
  int disable_deblock = 0, alpha_div2 = 0, beta_div2 = 0;
  bool idr() const { return nal_type == 5; }
  int lists() const { return type == 1 ? 2 : type == 0 ? 1 : 0; }
};

// ref_pic_list_modification( ) of one list
void ref_mods_syntax(Bits& b, int& flag, std::vector<RefMod>& mods) {
  flag = b.flag(flag);
  if (!flag) return;
  if (!b.writing) mods.clear();
  for (size_t i = 0;; i++) {
    if (!b.writing) mods.push_back(RefMod());
    if (i >= mods.size()) fail("internal: ref_pic_list_modification without its end");
    RefMod& m = mods[i];
    m.idc = b.ue(m.idc);
    if (m.idc == 3) break;
    if (m.idc > 3) fail("modification_of_pic_nums_idc > 3");
    m.val = b.ue(m.val);
    if (i > 64) fail("too many reference list modifications");
  }
}

// pred_weight_table( ): list 0, and list 1 of a B slice
void weight_table_syntax(Bits& b, SliceHeader& h) {
  h.luma_log2_wd = b.ue(h.luma_log2_wd);
  h.chroma_log2_wd = b.ue(h.chroma_log2_wd);
  if (h.luma_log2_wd > 7 || h.chroma_log2_wd > 7) fail("log2_weight_denom > 7");
  for (int l = 0; l < h.lists(); l++)
    for (int i = 0; i < h.num_ref_idx_active[l]; i++) {
      h.luma_flag[l][i] = b.flag(h.luma_flag[l][i]);
      if (h.luma_flag[l][i]) {
        h.luma_w[l][i] = b.se(h.luma_w[l][i]);
        h.luma_o[l][i] = b.se(h.luma_o[l][i]);
      } else {
        h.luma_w[l][i] = 1 << h.luma_log2_wd;
        h.luma_o[l][i] = 0;
      }
      h.chroma_flag[l][i] = b.flag(h.chroma_flag[l][i]);
      for (int c = 0; c < 2; c++) {
        if (h.chroma_flag[l][i]) {
          h.chroma_w[l][i][c] = b.se(h.chroma_w[l][i][c]);
          h.chroma_o[l][i][c] = b.se(h.chroma_o[l][i][c]);
        } else {
          h.chroma_w[l][i][c] = 1 << h.chroma_log2_wd;
          h.chroma_o[l][i][c] = 0;
        }
      }
    }
}

// slice_header( ); refuses what is out of scope as soon as it shows
void slice_header_syntax(Bits& b, SliceHeader& h, const SPS* sps_table, const PPS* pps_table,
                         const SPS*& sps_out, const PPS*& pps_out) {
  h.first_mb = b.ue(h.first_mb);
  h.slice_type = b.ue(h.slice_type);
  if (h.slice_type > 9) fail("slice_type > 9");
  h.type = h.slice_type % 5;
  if (h.type == 3) unsupported("SP slices");
  if (h.type == 4) unsupported("SI slices");
  h.pps_id = b.ue(h.pps_id);
  if (h.pps_id > 255 || !pps_table[h.pps_id].valid) fail("slice refers to a missing picture parameter set");
  const PPS& p = pps_table[h.pps_id];
  const SPS& s = sps_table[p.sps_id];
  sps_out = &s;
  pps_out = &p;
  h.frame_num = b.u(s.log2_max_frame_num, h.frame_num);
  if (h.idr()) h.idr_pic_id = b.ue(h.idr_pic_id);
  if (s.poc_type == 0) {
    h.poc_lsb = b.u(s.log2_max_poc_lsb, h.poc_lsb);
    if (p.bottom_field_pic_order) h.delta_poc_bottom = b.se(h.delta_poc_bottom);
  }
  if (s.poc_type == 1 && !s.delta_pic_order_always_zero) {
    h.delta_poc[0] = b.se(h.delta_poc[0]);
    if (p.bottom_field_pic_order) h.delta_poc[1] = b.se(h.delta_poc[1]);
  }
  if (p.redundant_pic_cnt_present) {
    h.redundant_pic_cnt = b.ue(h.redundant_pic_cnt);
    if (h.redundant_pic_cnt) unsupported("redundant pictures (redundant_pic_cnt > 0)");
  }
  if (h.type == 1) h.direct_spatial = b.flag(h.direct_spatial);
  if (h.type != 2) {
    h.override = b.flag(h.override);
    for (int l = 0; l < h.lists(); l++) {
      if (h.override) h.num_ref_idx_active[l] = b.ue(h.num_ref_idx_active[l] - 1) + 1;
      else h.num_ref_idx_active[l] = p.num_ref_idx_default[l];
      if (h.num_ref_idx_active[l] > 32) fail("num_ref_idx_active > 32");
    }
    for (int l = 0; l < h.lists(); l++) ref_mods_syntax(b, h.ref_mod_flag[l], h.mods[l]);
    if ((p.weighted_pred && h.type == 0) || (p.weighted_bipred_idc == 1 && h.type == 1))
      weight_table_syntax(b, h);
  }
  if (h.nal_ref_idc) {
    if (h.idr()) {
      h.no_output_prior = b.flag(h.no_output_prior);
      h.long_term_ref = b.flag(h.long_term_ref);
    } else {
      h.adaptive = b.flag(h.adaptive);
      if (h.adaptive) {
        if (!b.writing) h.mmcos.clear();
        for (size_t i = 0;; i++) {
          if (!b.writing) h.mmcos.push_back(Mmco());
          if (i >= h.mmcos.size()) fail("internal: MMCOs without their end");
          Mmco& m = h.mmcos[i];
          m.op = b.ue(m.op);
          if (m.op == 0) break;
          if (m.op > 6) fail("memory_management_control_operation > 6");
          if (m.op == 1 || m.op == 3) m.diff = b.ue(m.diff);
          if (m.op == 2) m.lt_pic_num = b.ue(m.lt_pic_num);
          if (m.op == 3 || m.op == 6) m.lt_idx = b.ue(m.lt_idx);
          if (m.op == 4) m.max_lt_plus1 = b.ue(m.max_lt_plus1);
          if (i > 64) fail("too many MMCOs");
        }
      }
    }
  }
  if (p.cabac && h.type != 2) {
    h.cabac_init_idc = b.ue(h.cabac_init_idc);
    if (h.cabac_init_idc > 2) fail("cabac_init_idc > 2");
  }
  h.qp_delta = b.se(h.qp_delta);
  h.qp = p.pic_init_qp + h.qp_delta;
  if (h.qp < 0 || h.qp > 51) fail("slice QP out of 0..51");
  if (!p.deblocking_control) {
    h.disable_deblock = 0;
    h.alpha_div2 = h.beta_div2 = 0;
  } else {
    h.disable_deblock = b.ue(h.disable_deblock);
    if (h.disable_deblock > 2) fail("disable_deblocking_filter_idc > 2");
    if (h.disable_deblock == 1) {
      h.alpha_div2 = h.beta_div2 = 0;
    } else {
      h.alpha_div2 = b.se(h.alpha_div2);
      h.beta_div2 = b.se(h.beta_div2);
      if (h.alpha_div2 < -6 || h.alpha_div2 > 6 || h.beta_div2 < -6 || h.beta_div2 > 6)
        fail("slice_alpha/beta_offset_div2 out of -6..6");
    }
  }
}

// ------------------------------------------------------------ pictures --
// What a decoded picture keeps of a macroblock for the B pictures that take
// it as their co-located picture (8.4.1.2.1)
struct ColMb {
  bool intra = true;
  int shape = 0;        // FFmpeg's partition of it: 0 16x16 (or intra), 1 16x8, 2 8x16, 3 8x8
  int8_t ref[2][4];     // refIdxLX by 8x8 in its slice, -1 list not used
  int16_t mv[2][16][2];
};

struct Picture {
  int w = 0, h = 0;  // luma, whole macroblocks
  std::vector<uint8_t> p[3];
  int poc = 0, top_poc = 0, bottom_poc = 0, poc_msb = 0, poc_lsb = 0;
  int frame_num = 0, frame_num_offset = 0, frame_num_wrap = 0;
  int long_idx = -1;
  bool ref_short = false, ref_long = false, mmco5 = false, idr = false;
  int id = 0;  // unique, for the deblocking filter's "same reference picture"
  int first_type = 2;  // the type of its first slice
  bool has_b = false;  // it has a B slice
  int types = 0;       // its slice types (bits)
  bool key = false, mmco_reset = false;  // FFmpeg's output marks: IDR, MMCO 5 before or at it
  std::vector<ColMb> col;
  // its last slice's reference lists as FFmpeg keeps them for the temporal
  // direct mode's map: 4 * frame_num + 3 of each entry
  int list_count[2] = {0, 0};
  int list_key[2][32];
  void alloc(int width, int height) {
    w = width;
    h = height;
    p[0].assign((size_t)w * h, 0);
    p[1].assign((size_t)w * h / 4, 0);
    p[2].assign((size_t)w * h / 4, 0);
  }
  bool is_ref() const { return ref_short || ref_long; }
  uint8_t* plane(int c) { return p[c].data(); }
  const uint8_t* plane(int c) const { return p[c].data(); }
  int stride(int c) const { return c ? w / 2 : w; }
};
typedef std::shared_ptr<Picture> PicPtr;

// the narrowest prediction block whose weighting FFmpeg's x86 SIMD computes
// (in 16-bit lanes that saturate; its weighted average halves the weights
// when one is 128); narrower ones (chroma of 4-wide partitions) take its C code
const int kSimdWidth = 4;
inline int sat16(int v) { return v < -32768 ? -32768 : v > 32767 ? 32767 : v; }

// macroblock kinds: the inter kinds of P and B slices share their partition
// shapes (16x16, 16x8, 8x16, 8x8); BSKIP and BDIRECT are B_Skip and B_Direct_16x16
enum Kind { I4 = 0, I8, I16, IPCM, P16x16, P16x8, P8x16, P8x8, PSKIP, BSKIP, BDIRECT };

// What a decoded macroblock leaves for its neighbours and the deblocking filter
struct MbInfo {
  int slice = -1;      // the slice's number in the picture; -1 not yet decoded
  int kind = I4;
  int lists = 0;       // its slice's reference lists: 0 I, 1 P, 2 B
  bool intra = true, t8 = false;
  int cbp = 0;         // luma | chroma << 4
  int qp = 0;          // QPY (0 for I_PCM, as the deblocking filter takes it)
  int qpc[2] = {0, 0};
  int8_t ipred[16];    // intra 4x4/8x8 modes by raster 4x4 block, -1 none
  int cmode = 0;       // intra_chroma_pred_mode
  uint8_t nnz[24];     // coefficients a 4x4 block: luma raster 0..15, Cb 16..19, Cr 20..23
  bool dc[3] = {false, false, false};  // coded_block_flag of luma DC, Cb DC, Cr DC
  uint8_t direct = 0;  // its 8x8 blocks predicted in direct mode (bits)
  int shape = 0;       // FFmpeg's partition of it (ColMb::shape)
  uint8_t mcw[16];     // the width of FFmpeg's prediction block holding each 4x4 block
  int16_t mv[2][16][2];
  int8_t ref[2][4];    // refIdxLX by 8x8, -1 intra or list not used
  int refpic[2][4];    // the referenced picture's id, 0 none
  int16_t mvd[2][16][2];
};

// One macroblock's syntax: the writer fills it, the decoder reads into it
struct Mb {
  int mb_type = 0;     // as coded in the slice type's table
  int kind = I4;
  int skip = 0;
  int t8 = 0;
  int i16 = 0;         // Intra16x16PredMode
  int cbp = 0;
  int ipred[16];       // intra 4x4 modes by luma4x4BlkIdx, 8x8 modes by 8x8 index
  int cmode = 0;
  int sub[4] = {0, 0, 0, 0};
  int ref[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
  int mv[2][16][2];    // the writer's motion vectors by list and partition (then sub-partition)
  int qp_delta = 0;
  int16_t luma[16][16];  // levels by luma4x4BlkIdx in scan order (8x8: 4 x 64 in luma8)
  int16_t luma8[4][64];
  int16_t dc[16];
  int16_t cdc[2][4];
  int16_t cac[2][4][16];  // scan positions 1..15 at indices 1..15
  uint8_t pcm[384];
};

struct WeightTable {
  int on = 0;  // 0 none, 1 explicit, 2 implicit
  int lwd = 0, cwd = 0;
  int lw[2][32], lo[2][32], cw[2][32][2], co[2][32][2];
  int implicit[32][32];  // w0 of (refIdxL0, refIdxL1); w1 = 64 - w0
};

// sub_mb_type of P: (partitions, width, height)
const int kSubParts[4][3] = {{1, 8, 8}, {2, 8, 4}, {2, 4, 8}, {4, 4, 4}};
// sub_mb_type of B (Table 7-18): (partitions, width, height, prediction:
// 1 L0, 2 L1, 3 both); 0 is B_Direct_8x8
const int kBSubParts[13][4] = {{4, 4, 4, 0}, {1, 8, 8, 1}, {1, 8, 8, 2}, {1, 8, 8, 3},
                               {2, 8, 4, 1}, {2, 4, 8, 1}, {2, 8, 4, 2}, {2, 4, 8, 2},
                               {2, 8, 4, 3}, {2, 4, 8, 3}, {4, 4, 4, 1}, {4, 4, 4, 2},
                               {4, 4, 4, 3}};
// mb_type 1..21 of B (Table 7-14): (kind, prediction of partition 0, of partition 1)
const int kBTypes[22][3] = {
    {BDIRECT, 0, 0}, {P16x16, 1, 0}, {P16x16, 2, 0}, {P16x16, 3, 0},
    {P16x8, 1, 1}, {P8x16, 1, 1}, {P16x8, 2, 2}, {P8x16, 2, 2}, {P16x8, 1, 2}, {P8x16, 1, 2},
    {P16x8, 2, 1}, {P8x16, 2, 1}, {P16x8, 1, 3}, {P8x16, 1, 3}, {P16x8, 2, 3}, {P8x16, 2, 3},
    {P16x8, 3, 1}, {P8x16, 3, 1}, {P16x8, 3, 2}, {P8x16, 3, 2}, {P16x8, 3, 3}, {P8x16, 3, 3}};

// the decoder's stream counters (io/video.py's H264_STAT_NAMES, in order)
enum Stat {
  S_IDR, S_ISLICE, S_PSLICE, S_CABAC, S_I4, S_I8, S_I16, S_PCM, S_INTER, S_SKIP, S_SUB8,
  S_T8, S_WEIGHTED, S_LONGTERM, S_MMCO, S_DEBLOCK, S_DEBLOCK2, S_SCALED, S_REFMOD,
  S_BSLICE, S_SPATIAL, S_TEMPORAL, S_BSKIP, S_DIRECT, S_BIPRED, S_IMPLICIT, S_BREF,
  S_DROPPED, S_LTCOL, S_MIXED, kStatCount
};


struct SliceDb {  // what the deblocking filter needs of a slice
  int disable = 0, alpha = 0, beta = 0;
};

// The decoding process of one stream: parameter sets, the picture being
// decoded (or written), its macroblock state, the references and the POC
// state. The writer drives the same object with Bits.writing set and a
// chooser that fills each macroblock's syntax before it is coded.
struct Codec {
  Bits bits;
  Cabac cabac;
  SPS sps[32];
  PPS pps[256];
  const SPS* s = nullptr;
  const PPS* p = nullptr;
  SliceHeader sh;
  int mbw = 0, mbh = 0;
  std::vector<MbInfo> info;
  std::vector<SliceDb> slices;
  PicPtr cur;
  std::vector<PicPtr> dpb;    // reference pictures
  std::vector<PicPtr> list[2];  // RefPicList0 and RefPicList1 of the slice
  std::vector<PicPtr> ready;  // decoded pictures in output order
  WeightTable wt;
  int dist_scale[32], col_map[2][32];  // temporal direct, per slice
  int64_t stats[kStatCount] = {0};
  int next_id = 1;
  bool started = false;  // an IDR picture was seen
  // POC and frame_num state of the previous (reference) picture
  int prev_ref_msb = 0, prev_ref_lsb = 0, prev_ref_frame_num = 0, prev_frame_num = 0;
  int prev_frame_num_offset = 0;
  bool prev_mmco5 = false, prev_ref_mmco5 = false;
  int prev_ref_top_after_mmco5 = 0;
  int max_long_idx = -1;  // MaxLongTermFrameIdx, -1: no long-term frame indices
  // per slice
  int slice_num = -1, qp = 26, last_dqp = 0;
  int ls4[6][6][16];  // LevelScale4x4 by list (Y, Cb, Cr intra; Y, Cb, Cr inter), qP % 6, raster
  int ls8[2][6][64];
  // the macroblock being decoded
  int addr = 0, mbx = 0, mby = 0;
  uint16_t done = 0;  // its 4x4 blocks whose motion is known (raster bits)
  std::function<void(Mb&)> choose;  // the writer's

  Codec() {
    cabac.b = &bits;
    last_pocs_reset();
  }
  bool W() const { return bits.writing; }
  MbInfo& ci() { return info[addr]; }

  // ------------------------------------------------------ neighbours --
  MbInfo* avail(int x, int y) {
    if (x < 0 || y < 0 || x >= mbw || y >= mbh) return nullptr;
    MbInfo* n = &info[y * mbw + x];
    return n->slice == slice_num && (x != mbx || y != mby) ? n : nullptr;
  }
  MbInfo* mbA() { return avail(mbx - 1, mby); }
  MbInfo* mbB() { return avail(mbx, mby - 1); }
  // intra prediction may use the samples of this macroblock
  bool intra_ok(int x, int y) {
    MbInfo* n = avail(x, y);
    return n && (!p->constrained_intra_pred || n->intra);
  }
  // the macroblock holding the luma location (xN, yN) relative to the
  // current one (6.4.12), with the raster 4x4 block there; cur: it is the
  // current macroblock
  MbInfo* luma_neighbour(int xN, int yN, int& blk, bool& cur) {
    cur = false;
    if (yN > 15) return nullptr;
    int mx = mbx, my = mby;
    if (xN < 0) { mx--; xN += 16; }
    else if (xN > 15) { mx++; xN -= 16; }
    if (yN < 0) { my--; yN += 16; }
    blk = (yN >> 2) * 4 + (xN >> 2);
    if (mx == mbx && my == mby) { cur = true; return &ci(); }
    if (my == mby && mx > mbx) return nullptr;
    return avail(mx, my);
  }
  // the luma 4x4 blocks left of and above raster block (bx, by)
  MbInfo* left_blk(int bx, int by, int& blk) {
    if (bx > 0) { blk = by * 4 + bx - 1; return &ci(); }
    blk = by * 4 + 3;
    return mbA();
  }
  MbInfo* top_blk(int bx, int by, int& blk) {
    if (by > 0) { blk = (by - 1) * 4 + bx; return &ci(); }
    blk = 12 + bx;
    return mbB();
  }
  MbInfo* left_cblk(int c, int cx, int cy, int& blk) {
    if (cx > 0) { blk = 16 + 4 * c + cy * 2; return &ci(); }
    blk = 16 + 4 * c + cy * 2 + 1;
    return mbA();
  }
  MbInfo* top_cblk(int c, int cx, int cy, int& blk) {
    if (cy > 0) { blk = 16 + 4 * c + cx; return &ci(); }
    blk = 16 + 4 * c + 2 + cx;
    return mbB();
  }

  // CAVLC nC (9.2.1); blk: raster luma 0..15 or 16 + 4 c + chroma block
  int nc(int blk) {
    MbInfo *a, *b;
    int ba, bb;
    if (blk < 16) {
      a = left_blk(blk & 3, blk >> 2, ba);
      b = top_blk(blk & 3, blk >> 2, bb);
    } else {
      int c = (blk - 16) >> 2, k = (blk - 16) & 3;
      a = left_cblk(c, k & 1, k >> 1, ba);
      b = top_cblk(c, k & 1, k >> 1, bb);
    }
    if (a && b) return (a->nnz[ba] + b->nnz[bb] + 1) >> 1;
    if (a) return a->nnz[ba];
    if (b) return b->nnz[bb];
    return 0;
  }

  // ------------------------------------------------------------ setup --
  void level_scales() {
    for (int l = 0; l < 6; l++)
      for (int m = 0; m < 6; m++)
        for (int k = 0; k < 16; k++) {
          int r = kZigzag4[k], i = r >> 2, j = r & 3;
          int cls = (i & 1) == 0 && (j & 1) == 0 ? 0 : (i & 1) && (j & 1) ? 1 : 2;
          ls4[l][m][r] = p->sl4[l][k] * kNorm4[m][cls];
        }
    for (int l = 0; l < 2; l++)
      for (int m = 0; m < 6; m++)
        for (int k = 0; k < 64; k++) {
          int r = kZigzag8[k], i = r >> 3, j = r & 7;
          int cls;
          if (i % 4 == 0 && j % 4 == 0) cls = 0;
          else if (i % 2 == 1 && j % 2 == 1) cls = 1;
          else if (i % 4 == 2 && j % 4 == 2) cls = 2;
          else if ((i % 4 == 0 && j % 2 == 1) || (i % 2 == 1 && j % 4 == 0)) cls = 3;
          else if ((i % 4 == 0 && j % 4 == 2) || (i % 4 == 2 && j % 4 == 0)) cls = 4;
          else cls = 5;
          ls8[l][m][r] = p->sl8[l][k] * kNorm8[m][cls];
        }
  }
  int chroma_qp(int c, int q) const {
    return kChromaQp[clip3(0, 51, q + (c ? p->cr_qp_offset : p->cb_qp_offset))];
  }

  // ---------------------------------------------------- CABAC elements --
  int eg_bypass(int k, int v) {
    int val = 0;
    while (cabac.bypass(W() && v >= (1 << k))) {
      if (W()) v -= 1 << k;
      val += 1 << k;
      if (++k > 24) fail("invalid CABAC Exp-Golomb suffix");
    }
    while (k--) val += cabac.bypass(W() ? (v >> k) & 1 : 0) << k;
    return val;
  }
  // mb_type of an I macroblock (Table 9-36): in I slices from ctxIdx 3 with
  // the neighbours' increment, in P and B slices the suffix from ctxIdx 17
  // and 32 (base)
  int mb_type_i(int v, bool islice, int base) {
    int first;
    if (islice) {
      MbInfo *a = mbA(), *b = mbB();
      int inc = (a && a->kind != I4 && a->kind != I8) + (b && b->kind != I4 && b->kind != I8);
      first = base + inc;
    } else {
      first = base;
    }
    if (!cabac.bin(first, v != 0)) return 0;
    if (cabac.terminate(v == 25)) return 25;
    int t = v - 1, si = islice ? 1 : 0, s0 = islice ? base + 2 : base;
    int luma = cabac.bin(s0 + 1, t >= 12);
    int chroma = 0;
    if (cabac.bin(s0 + 2, (t / 4) % 3 != 0)) chroma = 1 + cabac.bin(s0 + 2 + si, (t / 4) % 3 == 2);
    int hi = cabac.bin(s0 + 3 + si, (t % 4) >> 1);
    int lo = cabac.bin(s0 + 3 + 2 * si, t & 1);
    return 1 + 12 * luma + 4 * chroma + 2 * hi + lo;
  }
  int mb_type_p(int v) {
    if (!cabac.bin(14, v >= 5)) {
      if (!cabac.bin(15, v == 1 || v == 2)) return 3 * cabac.bin(16, v == 3);
      return 2 - cabac.bin(17, v == 1);
    }
    return 5 + mb_type_i(v - 5, false, 17);
  }
  // mb_type of B (Table 9-37 (b)) as FFmpeg's decode_cabac_mb_type_b walks
  // it: ctxIdx 27 + the neighbours that are neither B_Skip nor
  // B_Direct_16x16, then 27 + 3, 4, 5
  int mb_type_b(int v) {
    MbInfo *a = mbA(), *b = mbB();
    int inc = (a && a->kind != BSKIP && a->kind != BDIRECT) +
              (b && b->kind != BSKIP && b->kind != BDIRECT);
    if (!cabac.bin(27 + inc, v != 0)) return 0;
    if (!cabac.bin(27 + 3, v >= 3)) return 1 + cabac.bin(27 + 5, v == 2);
    // bits: 4 bins after "11"; 0-7: types 3-10, 13: intra, 14: 11, 15: 22 (B_8x8),
    // else 5 bins: types 12-21
    int want = 0;
    if (W()) {
      if (v >= 3 && v <= 10) want = v - 3;
      else if (v >= 23) want = 13;
      else if (v == 11) want = 14;
      else if (v == 22) want = 15;
      else want = (v + 4) >> 1;  // 12-21: 5 bins (v + 4), the first four
    }
    int bits4 = cabac.bin(27 + 4, (want >> 3) & 1) << 3;
    bits4 |= cabac.bin(27 + 5, (want >> 2) & 1) << 2;
    bits4 |= cabac.bin(27 + 5, (want >> 1) & 1) << 1;
    bits4 |= cabac.bin(27 + 5, want & 1);
    if (bits4 < 8) return bits4 + 3;
    if (bits4 == 13) return 23 + mb_type_i(v - 23, false, 32);
    if (bits4 == 14) return 11;
    if (bits4 == 15) return 22;
    return ((bits4 << 1) | cabac.bin(27 + 5, (v + 4) & 1)) - 4;
  }
  int sub_type_p(int v) {
    if (cabac.bin(21, v == 0)) return 0;
    if (!cabac.bin(22, v != 1)) return 1;
    return cabac.bin(23, v == 2) ? 2 : 3;
  }
  // sub_mb_type of B (FFmpeg's decode_cabac_b_mb_sub_type)
  int sub_type_b(int v) {
    if (!cabac.bin(36, v != 0)) return 0;
    if (!cabac.bin(37, v >= 3)) return 1 + cabac.bin(39, v == 2);
    if (cabac.bin(38, v >= 7)) {
      if (cabac.bin(39, v >= 11)) return 11 + cabac.bin(39, v == 12);
      return 7 + 2 * cabac.bin(39, ((v - 7) >> 1) & 1) + cabac.bin(39, (v - 7) & 1);
    }
    int t = 3 + 2 * cabac.bin(39, ((v - 3) >> 1) & 1);
    return t + cabac.bin(39, (v - 3) & 1);
  }
  int ref_idx_cabac(int v, int inc) {
    int r = 0;
    while (cabac.bin(54 + (r == 0 ? inc : r == 1 ? 4 : 5), r < v)) {
      if (++r > 31) fail("ref_idx_l0 > 31");
    }
    return r;
  }
  int mvd_cabac(int comp, int v, int inc) {
    int base = comp ? 47 : 40, a = std::abs(v), pre = 0;
    while (pre < 9 && cabac.bin(base + (pre == 0 ? inc : pre < 4 ? pre + 2 : 6), pre < a)) pre++;
    int val = pre;
    if (pre >= 9) val += eg_bypass(3, a - 9);
    if (val && cabac.bypass(v < 0)) val = -val;
    return val;
  }
  int qp_delta_cabac(int v) {
    int k = v > 0 ? 2 * v - 1 : -2 * v, n = 0;
    while (cabac.bin(60 + (n == 0 ? (last_dqp != 0) : n == 1 ? 2 : 3), n < k)) {
      if (++n > 102) fail("mb_qp_delta out of range");
    }
    return (n & 1) ? (n + 1) / 2 : -(n / 2);
  }

  // coded_block_flag's condTermFlagN (9.3.3.1.1.9) for a neighbouring block
  // of category cat (0 luma DC, 1/2 luma 4x4, 3 chroma DC, 4 chroma AC)
  int cbf_cond(MbInfo* n, int cat, int blk, int c) {
    if (!n) return ci().intra ? 1 : 0;
    if (n->kind == IPCM) return 1;
    if (n->kind == PSKIP || n->kind == BSKIP) return 0;
    switch (cat) {
      case 0: return n->kind == I16 ? n->dc[0] : 0;
      case 1:
      case 2: {
        int b8 = ((blk >> 3) << 1) | ((blk & 3) >> 1);
        if (!((n->cbp >> b8) & 1)) return 0;
        if (n->t8) return 1;
        return n->nnz[blk] != 0;
      }
      case 3: return (n->cbp >> 4) ? n->dc[1 + c] : 0;
      default: return (n->cbp >> 4) == 2 ? n->nnz[blk] != 0 : 0;
    }
  }

  // residual_block_cabac( ): levels at c[first + i] in scan order; returns
  // the number of non-zero levels
  int cabac_block(int cat, int inc, int16_t* c, int first, int max) {
    int count = 0, last = -1;
    if (W()) {
      for (int i = 0; i < max; i++)
        if (c[first + i]) { count++; last = i; }
    } else {
      for (int i = 0; i < max; i++) c[first + i] = 0;
    }
    static const int cbf_off[5] = {0, 4, 8, 12, 16}, sig_off[5] = {0, 15, 29, 44, 47},
                     abs_off[5] = {0, 10, 20, 30, 39};
    if (cat != 5 && !cabac.bin(85 + cbf_off[cat] + inc, count > 0)) return 0;
    int num = max;
    bool sig[64];
    for (int i = 0; i < max; i++) sig[i] = false;
    int i = 0;
    for (; i < num - 1; i++) {
      int sctx, lctx;
      if (cat == 5) {
        sctx = 402 + kSigOff8[i];
        lctx = 417 + kLastOff8[i];
      } else {
        int k = cat == 3 ? std::min(i, 2) : i;
        sctx = 105 + sig_off[cat] + k;
        lctx = 166 + sig_off[cat] + k;
      }
      if (cabac.bin(sctx, W() && c[first + i] != 0)) {
        sig[i] = true;
        if (cabac.bin(lctx, W() && i == last)) {
          num = i + 1;
          break;
        }
      }
    }
    if (i == num - 1) sig[num - 1] = true;  // no last flag: the final one is significant
    int abase = cat == 5 ? 426 : 227 + abs_off[cat];
    int eq1 = 0, gt1 = 0, n = 0;
    for (int k = num - 1; k >= 0; k--) {
      if (!sig[k]) continue;
      int want = W() ? std::abs(c[first + k]) - 1 : 0;
      int pre = 0;
      if (cabac.bin(abase + (gt1 ? 0 : std::min(4, 1 + eq1)), want > 0)) {
        pre = 1;
        int ctx = abase + 5 + std::min(4 - (cat == 3), gt1);
        while (pre < 14 && cabac.bin(ctx, pre < want)) pre++;
      }
      int val = pre;
      if (pre >= 14) val += eg_bypass(0, want - 14);
      int neg = cabac.bypass(W() && c[first + k] < 0);
      if (!W()) c[first + k] = (int16_t)(neg ? -(val + 1) : val + 1);
      if (val == 0) eq1++;
      else gt1++;
      n++;
    }
    return n;
  }

  // ------------------------------------------------ CAVLC residual block --
  // residual_block_cavlc( ): levels at c[first + i], i < max, in scan order
  int cavlc_block(int nC, int16_t* c, int first, int max) {
    int level[16], run[16];
    int total = 0, t1 = 0, tz = 0;
    if (W()) {
      int idx[16];
      for (int i = 0; i < max; i++)
        if (c[first + i]) idx[total++] = i;
      // levels from the highest frequency down
      for (int k = 0; k < total; k++) level[k] = c[first + idx[total - 1 - k]];
      while (t1 < total && t1 < 3 && std::abs(level[t1]) == 1) t1++;
      tz = total ? idx[total - 1] + 1 - total : 0;
      for (int k = 0; k < total; k++) {
        int pos = idx[total - 1 - k];
        int below = k + 1 < total ? idx[total - 2 - k] : -1;
        run[k] = pos - below - 1;
      }
    } else {
      for (int i = 0; i < max; i++) c[first + i] = 0;
    }
    // coeff_token
    int token;
    if (nC == -1) {
      token = bits.vlc(kChromaDcTokenBits, kChromaDcTokenLen, 20, 4 * total + t1);
    } else {
      int cls = nC < 2 ? 0 : nC < 4 ? 1 : nC < 8 ? 2 : 3;
      token = bits.vlc(kCoeffTokenBits[cls], kCoeffTokenLen[cls], 68, 4 * total + t1);
    }
    total = token >> 2;
    t1 = token & 3;
    if (t1 > total || total > max) fail("invalid coeff_token");
    if (!total) return 0;
    int sl = total > 10 && t1 < 3 ? 1 : 0;
    for (int k = 0; k < total; k++) {
      if (k < t1) {
        int neg = bits.u(1, W() && level[k] < 0);
        level[k] = neg ? -1 : 1;
        continue;
      }
      bool adj = k == t1 && t1 < 3;
      int prefix = 0, suffix = 0;
      if (W()) {
        int L = level[k];
        int code = L > 0 ? 2 * L - 2 : -2 * L - 1;
        if (adj) code -= 2;
        if (sl == 0) {
          if (code < 14) prefix = code;
          else if (code < 30) { prefix = 14; suffix = code - 14; }
          else { prefix = 15; suffix = code - 30; }
        } else if ((code >> sl) < 15) {
          prefix = code >> sl;
          suffix = code & ((1 << sl) - 1);
        } else {
          prefix = 15;
          suffix = code - (15 << sl);
        }
        if (prefix == 15 && suffix >= 4096) fail("internal: level too large for CAVLC");
      }
      prefix = bits.leading_zeros(prefix);
      int size = prefix == 14 && sl == 0 ? 4 : prefix >= 15 ? prefix - 3 : sl;
      if (size) suffix = (int)bits.u(size, suffix);
      int code = (std::min(15, prefix) << sl) + suffix;
      if (prefix >= 15 && sl == 0) code += 15;
      if (prefix >= 16) code += (1 << (prefix - 3)) - 4096;
      if (adj) code += 2;
      level[k] = (code & 1) ? (-code - 1) >> 1 : (code + 2) >> 1;
      if (sl == 0) sl = 1;
      if (std::abs(level[k]) > (3 << (sl - 1)) && sl < 6) sl++;
    }
    if (total < max) {
      if (max == 4)
        tz = bits.vlc(kChromaDcTotalZerosBits[total - 1], kChromaDcTotalZerosLen[total - 1],
                      4 - total + 1, tz);
      else
        tz = bits.vlc(kTotalZerosBits[total - 1], kTotalZerosLen[total - 1], 16 - total + 1, tz);
    } else {
      tz = 0;
    }
    int left = tz;
    for (int k = 0; k < total - 1; k++) {
      if (left > 0) {
        int t = std::min(left, 7) - 1;
        run[k] = bits.vlc(kRunBits[t], kRunLen[t], t < 6 ? t + 2 : 15, W() ? run[k] : 0);
        if (run[k] > left) fail("run_before larger than the zeros left");
        left -= run[k];
      } else {
        run[k] = 0;
      }
    }
    run[total - 1] = left;
    int pos = -1;
    for (int k = total - 1; k >= 0; k--) {
      pos += run[k] + 1;
      if (pos >= max) fail("coefficients past the end of a block");
      if (!W()) c[first + pos] = (int16_t)level[k];
    }
    return total;
  }

  // -------------------------------------------------- motion vectors --
  struct Nb {
    bool avail;
    int ref, mv[2];
  };
  // list l of the block holding the luma location (xN, yN) relative to the
  // current macroblock; blocks of the current one count once decoded (done)
  Nb nb(int xN, int yN, int l) {
    int blk;
    bool cur;
    MbInfo* n = luma_neighbour(xN, yN, blk, cur);
    if (!n || (cur && !((done >> blk) & 1))) return {false, -1, {0, 0}};
    if (n->intra) return {true, -1, {0, 0}};
    int b8 = ((blk >> 3) << 1) | ((blk & 3) >> 1);
    return {true, n->ref[l][b8], {n->mv[l][blk][0], n->mv[l][blk][1]}};
  }
  // mvpLX of 8.4.1.3 for the partition at (x, y) of w x h; shape: 1 16x8,
  // 2 8x16 (part: the partition's index), 0 otherwise
  void mvp(int x, int y, int w, int ref, int shape, int part, int l, int out[2]) {
    Nb A = nb(x - 1, y, l), B = nb(x, y - 1, l), C = nb(x + w, y - 1, l);
    if (!C.avail) C = nb(x - 1, y - 1, l);
    if (shape == 1) {
      if (part == 0 && B.ref == ref) { out[0] = B.mv[0]; out[1] = B.mv[1]; return; }
      if (part == 1 && A.ref == ref) { out[0] = A.mv[0]; out[1] = A.mv[1]; return; }
    } else if (shape == 2) {
      if (part == 0 && A.ref == ref) { out[0] = A.mv[0]; out[1] = A.mv[1]; return; }
      if (part == 1 && C.ref == ref) { out[0] = C.mv[0]; out[1] = C.mv[1]; return; }
    }
    if (!B.avail && !C.avail && A.avail) { B = A; C = A; }
    int m = (A.ref == ref) + (B.ref == ref) + (C.ref == ref);
    if (m == 1) {
      const Nb& N = A.ref == ref ? A : B.ref == ref ? B : C;
      out[0] = N.mv[0];
      out[1] = N.mv[1];
      return;
    }
    for (int k = 0; k < 2; k++) out[k] = median3(A.mv[k], B.mv[k], C.mv[k]);
  }
  void skip_mv(int out[2]) {
    Nb A = nb(-1, 0, 0), B = nb(0, -1, 0);
    out[0] = out[1] = 0;
    if (!A.avail || !B.avail) return;
    if ((A.ref == 0 && !A.mv[0] && !A.mv[1]) || (B.ref == 0 && !B.mv[0] && !B.mv[1])) return;
    mvp(0, 0, 16, 0, 0, 0, 0, out);
  }
  // list l of the partition's blocks gets its motion (and mvd, for CABAC's
  // contexts); the blocks count as decoded
  void set_motion(int l, int x, int y, int w, int h, const int mv[2], const int mvd[2]) {
    MbInfo& c = ci();
    for (int by = y >> 2; by < (y + h) >> 2; by++)
      for (int bx = x >> 2; bx < (x + w) >> 2; bx++) {
        int b = by * 4 + bx;
        c.mv[l][b][0] = (int16_t)mv[0];
        c.mv[l][b][1] = (int16_t)mv[1];
        c.mvd[l][b][0] = (int16_t)mvd[0];
        c.mvd[l][b][1] = (int16_t)mvd[1];
        done |= 1 << b;
      }
  }
  int mvd_inc(int x, int y, int comp, int l) {
    int sum = 0;
    for (int k = 0; k < 2; k++) {
      int blk;
      bool cur;
      MbInfo* n = luma_neighbour(k ? x : x - 1, k ? y - 1 : y, blk, cur);
      if (n) sum += std::abs(n->mvd[l][blk][comp]);  // 0 for intra, skipped and direct blocks
    }
    return sum < 3 ? 0 : sum <= 32 ? 1 : 2;
  }
  int ref_inc(int x, int y, int l) {
    int inc = 0;
    for (int k = 0; k < 2; k++) {
      int blk;
      bool cur;
      MbInfo* n = luma_neighbour(k ? x : x - 1, k ? y - 1 : y, blk, cur);
      if (!n || n->intra || n->kind == PSKIP) continue;
      int b8 = ((blk >> 3) << 1) | ((blk & 3) >> 1);
      if ((n->direct >> b8) & 1) continue;  // B_Skip, B_Direct_16x16, B_Direct_8x8
      if (n->ref[l][b8] > 0) inc += k ? 2 : 1;
    }
    return inc;
  }
  // one partition's mvd_lX (after every ref_idx of the macroblock)
  void partition_motion(Mb& m, int l, int idx, int x, int y, int w, int h, int shape, int part) {
    MbInfo& c = ci();
    int ref = c.ref[l][((y >> 3) << 1) | (x >> 3)];
    int pred[2], mvd[2], mv[2];
    mvp(x, y, w, ref, shape, part, l, pred);
    for (int k = 0; k < 2; k++) {
      int want = W() ? m.mv[l][idx][k] - pred[k] : 0;
      mvd[k] = p->cabac ? mvd_cabac(k, want, mvd_inc(x, y, k, l)) : bits.se(want);
      mv[k] = pred[k] + mvd[k];
      if (mv[k] < -32768 || mv[k] > 32767) fail("motion vector out of range");
    }
    set_motion(l, x, y, w, h, mv, mvd);
  }
  int ref_syntax(int v, int x, int y, int l) {
    int n = sh.num_ref_idx_active[l];
    if (n <= 1) return 0;
    int r;
    if (p->cabac) r = ref_idx_cabac(v, ref_inc(x, y, l));
    else if (n == 2) r = !bits.u(1, !v);
    else r = (int)bits.ue(v);
    if (r >= n) fail("ref_idx beyond the list");
    return r;
  }

  // the direct mode's motion (8.4.1.2) of the 8x8 blocks in mask, both
  // lists, as FFmpeg derives it: spatial from the neighbours A, B, C of the
  // macroblock, temporal from the co-located picture's motion scaled by the
  // POC distances; the blocks' mvds are 0
  static int min_positive(int a, int b) { return a >= 0 && b >= 0 ? std::min(a, b) : std::max(a, b); }
  // the prediction blocks' width over the 4x4 blocks of the 8x8 blocks in mask
  void set_mcw(int mask, int w) {
    for (int b8 = 0; b8 < 4; b8++)
      if ((mask >> b8) & 1)
        for (int j = 0; j < 4; j++) ci().mcw[(b8 >> 1) * 8 + (b8 & 1) * 2 + (j >> 1) * 4 + (j & 1)] = (uint8_t)w;
  }
  // FFmpeg's partition of a direct macroblock (B_Skip, B_Direct_16x16): the
  // co-located one's, 8x8 when that is 8x8 (4x4 sub-blocks without
  // direct_8x8_inference); a B_8x8 macroblock stays 8x8
  void direct_shape(int shape, bool b8x8) {
    if (b8x8) return;
    ci().shape = shape;
    if (shape != 3) set_mcw(15, shape == 2 ? 8 : 16);
  }
  void direct_motion(int mask, bool b8x8 = false) {
    MbInfo& c = ci();
    if (list[1].empty() || !list[1][0]) fail("direct prediction without a list 1 picture");
    const Picture& colpic = *list[1][0];
    const ColMb& col = colpic.col[addr];
    bool infer = s->direct_8x8_inference != 0;
    static const int corner[4] = {0, 3, 12, 15};  // raster 4x4 blocks at the corners
    c.direct |= (uint8_t)mask;
    int sub_w = infer ? 8 : 4;  // the direct 8x8 blocks' prediction blocks
    if (!b8x8) c.shape = 3;
    if (sh.direct_spatial) {
      int ref[2], mv[2][2] = {{0, 0}, {0, 0}};
      for (int l = 0; l < 2; l++) {
        Nb A = nb(-1, 0, l), B = nb(0, -1, l), C = nb(16, -1, l);
        if (!C.avail) C = nb(-1, -1, l);
        ref[l] = min_positive(A.ref, min_positive(B.ref, C.ref));
        if (ref[l] >= 0) mvp(0, 0, 16, ref[l], 0, 0, l, mv[l]);
      }
      if (ref[0] < 0 && ref[1] < 0) ref[0] = ref[1] = 0;
      bool still = !mv[0][0] && !mv[0][1] && !mv[1][0] && !mv[1][1];
      int nzero = 0;  // FFmpeg's n: the 4x4 blocks the co-located motion zeroes
      for (int b8 = 0; b8 < 4; b8++) {
        if (!((mask >> b8) & 1)) continue;
        bool col_ok = !colpic.ref_long && !col.intra &&
                      (col.ref[0][b8] == 0 || (col.ref[0][b8] < 0 && col.ref[1][b8] == 0));
        int cl = col.ref[0][b8] == 0 ? 0 : 1;
        for (int l = 0; l < 2; l++) c.ref[l][b8] = (int8_t)ref[l];
        int m = 0;
        for (int j = 0; j < 4; j++) {
          int blk = (b8 >> 1) * 8 + (b8 & 1) * 2 + (j >> 1) * 4 + (j & 1);
          const int16_t* cm = col.mv[cl][infer ? corner[b8] : blk];
          bool zero = col_ok && std::abs(cm[0]) <= 1 && std::abs(cm[1]) <= 1;
          m += zero;
          for (int l = 0; l < 2; l++) {
            bool z = ref[l] < 0 || (zero && ref[l] == 0);
            c.mv[l][blk][0] = z ? 0 : (int16_t)mv[l][0];
            c.mv[l][blk][1] = z ? 0 : (int16_t)mv[l][1];
            c.mvd[l][blk][0] = c.mvd[l][blk][1] = 0;
          }
        }
        // a 4x4-divided block whose co-located blocks all or none zero is predicted whole
        set_mcw(1 << b8, sub_w == 4 && col_ok && !(m & 3) ? 8 : sub_w);
        nzero += col_ok ? m : 0;
      }
      if (still || col.shape == 0 || !(nzero & 15)) direct_shape(0, b8x8);
      else direct_shape(col.shape, b8x8);
      return;
    }
    set_mcw(mask, sub_w);
    direct_shape(col.shape, b8x8);
    for (int b8 = 0; b8 < 4; b8++) {
      if (!((mask >> b8) & 1)) continue;
      int ref0 = 0, scale = 256, cl = 0;
      if (!col.intra) {
        int r = col.ref[0][b8];
        if (r < 0) { cl = 1; r = col.ref[1][b8]; }
        ref0 = r >= 0 && r < 32 ? col_map[cl][r] : 0;
        scale = dist_scale[ref0];
      }
      c.ref[0][b8] = (int8_t)ref0;
      c.ref[1][b8] = 0;
      for (int j = 0; j < 4; j++) {
        int blk = (b8 >> 1) * 8 + (b8 & 1) * 2 + (j >> 1) * 4 + (j & 1);
        int cm[2] = {0, 0};
        if (!col.intra) {
          const int16_t* v = col.mv[cl][infer ? corner[b8] : blk];
          cm[0] = v[0];
          cm[1] = v[1];
        }
        for (int k = 0; k < 2; k++) {
          int m0 = (scale * cm[k] + 128) >> 8;
          c.mv[0][blk][k] = (int16_t)m0;
          c.mv[1][blk][k] = (int16_t)(m0 - cm[k]);
          c.mvd[0][blk][k] = c.mvd[1][blk][k] = 0;
        }
      }
    }
  }

  // ---------------------------------------------------- intra modes --
  int predicted_mode(int bx, int by) {
    int ba, bb;
    MbInfo* a = left_blk(bx, by, ba);
    MbInfo* b = top_blk(bx, by, bb);
    if (!a || !b || (p->constrained_intra_pred && (!a->intra || !b->intra))) return 2;
    int ma = a->kind == I4 || a->kind == I8 ? a->ipred[ba] : 2;
    int mb = b->kind == I4 || b->kind == I8 ? b->ipred[bb] : 2;
    return std::min(ma, mb);
  }
  int intra_mode_syntax(int want, int bx, int by) {
    int pred = predicted_mode(bx, by);
    int flag = want == pred, rem = want < pred ? want : want - 1;
    if (p->cabac) {
      flag = cabac.bin(68, flag);
      if (!flag) {
        int r = cabac.bin(69, rem & 1);
        r |= cabac.bin(69, (rem >> 1) & 1) << 1;
        r |= cabac.bin(69, (rem >> 2) & 1) << 2;
        rem = r;
      }
    } else {
      flag = bits.flag(flag);
      if (!flag) rem = bits.u(3, rem);
    }
    return flag ? pred : rem < pred ? rem : rem + 1;
  }

  // ------------------------------------------------ macroblock layer --
  // the 8x8 blocks of partition k of a 16x16, 16x8 or 8x16 macroblock (bits)
  static int part_blocks(int kind, int k) {
    return kind == P16x16 ? 15 : kind == P16x8 ? (k ? 12 : 3) : (k ? 10 : 5);
  }
  void macroblock(Mb& m) {
    MbInfo& c = ci();
    int st = sh.type, nl = sh.lists();
    if (p->cabac)
      m.mb_type = st == 2 ? mb_type_i(m.mb_type, true, 3) : st == 0 ? mb_type_p(m.mb_type)
                                                                 : mb_type_b(m.mb_type);
    else
      m.mb_type = bits.ue(m.mb_type);
    int t = m.mb_type;
    int first_intra = st == 2 ? 0 : st == 0 ? 5 : 23;  // mb_type of I_NxN in this slice type
    if (t > first_intra + 25) fail("mb_type " + std::to_string(t) + " beyond the slice type's table");
    bool intra = t >= first_intra;
    if (intra) t -= first_intra;
    c.intra = intra;
    c.t8 = false;
    c.cmode = 0;
    int cbp = 0;
    int pred[2] = {1, 1};  // the partitions' lists (1 L0, 2 L1, 3 both)
    if (intra) {
      for (int l = 0; l < 2; l++)
        for (int k = 0; k < 4; k++) c.ref[l][k] = -1;
      memset(c.mv, 0, sizeof c.mv);
      memset(c.mvd, 0, sizeof c.mvd);
      c.direct = 0;
      c.shape = 0;
      memset(c.mcw, 16, sizeof c.mcw);
      if (t == 0) m.kind = I4;
      else if (t == 25) m.kind = IPCM;
      else {
        m.kind = I16;
        m.i16 = (t - 1) % 4;
        cbp = (((t - 1) / 4) % 3) << 4 | (t >= 13 ? 15 : 0);
      }
    } else if (st == 0) {
      if (t == 4 && p->cabac) fail("P_8x8ref0 in a CABAC slice");
      m.kind = t == 0 ? P16x16 : t == 1 ? P16x8 : t == 2 ? P8x16 : P8x8;
    } else if (t == 22) {
      m.kind = P8x8;
    } else {
      m.kind = kBTypes[t][0];
      pred[0] = kBTypes[t][1];
      pred[1] = kBTypes[t][2];
    }
    c.kind = m.kind;
    if (m.kind == IPCM) {
      stats[S_PCM]++;
      while (!bits.aligned()) bits.u(1, 0);  // pcm_alignment_zero_bit
      for (int k = 0; k < 384; k++) m.pcm[k] = (uint8_t)bits.u(8, m.pcm[k]);
      if (p->cabac) cabac.start();
      c.cbp = 0x2F;
      c.qp = 0;
      c.qpc[0] = chroma_qp(0, 0);
      c.qpc[1] = chroma_qp(1, 0);
      memset(c.nnz, 16, sizeof c.nnz);
      c.dc[0] = c.dc[1] = c.dc[2] = true;
      last_dqp = 0;
      return;
    }
    // noSubMbPartSizeLessThan8x8Flag == 0 (and B_Direct_16x16 without
    // direct_8x8_inference): no 8x8 transform
    bool small = false;
    if (m.kind == BDIRECT) {
      direct_motion(15);
      stats[S_DIRECT]++;
      small = !s->direct_8x8_inference;
    } else if (m.kind == P8x8) {
      int direct = 0;
      bool sub8 = false;  // a sub-macroblock partition below 8x8
      for (int k = 0; k < 4; k++) {
        if (st == 0) {
          m.sub[k] = p->cabac ? sub_type_p(m.sub[k]) : (int)bits.ue(m.sub[k]);
          if (m.sub[k] > 3) fail("sub_mb_type > 3 in a P slice");
          if (m.sub[k]) sub8 = true;
        } else {
          m.sub[k] = p->cabac ? sub_type_b(m.sub[k]) : (int)bits.ue(m.sub[k]);
          if (m.sub[k] > 12) fail("sub_mb_type > 12 in a B slice");
          if (m.sub[k] == 0) {
            direct |= 1 << k;
            if (!s->direct_8x8_inference) small = true;
          } else if (kBSubParts[m.sub[k]][0] > 1) {
            sub8 = true;
          }
        }
      }
      small |= sub8;
      c.shape = 3;
      for (int k = 0; k < 4; k++)
        if (!((direct >> k) & 1)) set_mcw(1 << k, st == 0 ? kSubParts[m.sub[k]][1] : kBSubParts[m.sub[k]][1]);
      if (direct) {
        direct_motion(direct, true);
        stats[S_DIRECT]++;
      }
      auto uses = [&](int k, int l) {
        return st == 0 ? l == 0 : !((direct >> k) & 1) && ((kBSubParts[m.sub[k]][3] >> l) & 1);
      };
      for (int l = 0; l < nl; l++)
        for (int k = 0; k < 4; k++)
          if (uses(k, l)) {
            m.ref[l][k] = t == 4 && st == 0 ? 0 : ref_syntax(m.ref[l][k], (k & 1) * 8, (k >> 1) * 8, l);
            c.ref[l][k] = (int8_t)m.ref[l][k];
          }
      const int zero[2] = {0, 0};
      for (int l = 0; l < nl; l++) {
        done = 0;
        for (int k = 0; k < 4; k++) {
          int x0 = (k & 1) * 8, y0 = (k >> 1) * 8;
          if ((direct >> k) & 1) {
            done |= 0x33 << ((k >> 1) * 8 + (k & 1) * 2);
            continue;
          }
          int n = st == 0 ? kSubParts[m.sub[k]][0] : kBSubParts[m.sub[k]][0];
          int w = st == 0 ? kSubParts[m.sub[k]][1] : kBSubParts[m.sub[k]][1];
          int h = st == 0 ? kSubParts[m.sub[k]][2] : kBSubParts[m.sub[k]][2];
          for (int j = 0; j < n; j++) {
            int x = x0 + (w == 4 ? (j & 1) * 4 : 0);
            int y = y0 + (h == 4 ? (w == 4 ? (j >> 1) : j) * 4 : 0);
            if (uses(k, l)) partition_motion(m, l, 4 * k + j, x, y, w, h, 0, 0);
            else set_motion(l, x, y, w, h, zero, zero);
          }
        }
      }
      if (st == 1)
        for (int k = 0; k < 4; k++)
          if (!((direct >> k) & 1) && kBSubParts[m.sub[k]][3] == 3) stats[S_BIPRED]++;
      if (sub8) stats[S_SUB8]++;
    } else if (!intra) {
      int np = m.kind == P16x16 ? 1 : 2;
      c.shape = m.kind == P16x16 ? 0 : m.kind == P16x8 ? 1 : 2;
      set_mcw(15, m.kind == P8x16 ? 8 : 16);
      for (int l = 0; l < nl; l++)
        for (int k = 0; k < np; k++) {
          if (!((pred[k] >> l) & 1)) continue;
          int x = m.kind == P8x16 ? k * 8 : 0, y = m.kind == P16x8 ? k * 8 : 0;
          m.ref[l][k] = ref_syntax(m.ref[l][k], x, y, l);
          for (int j = 0; j < 4; j++)
            if ((part_blocks(m.kind, k) >> j) & 1) c.ref[l][j] = (int8_t)m.ref[l][k];
        }
      const int zero[2] = {0, 0};
      for (int l = 0; l < nl; l++) {
        done = 0;
        for (int k = 0; k < np; k++) {
          int x = m.kind == P8x16 ? 8 * k : 0, y = m.kind == P16x8 ? 8 * k : 0;
          int w = m.kind == P8x16 ? 8 : 16, h = m.kind == P16x8 ? 8 : 16;
          int shape = m.kind == P16x16 ? 0 : m.kind == P16x8 ? 1 : 2;
          if ((pred[k] >> l) & 1) partition_motion(m, l, k, x, y, w, h, shape, k);
          else set_motion(l, x, y, w, h, zero, zero);
        }
      }
      if (st == 1)
        for (int k = 0; k < np; k++) stats[S_BIPRED] += pred[k] == 3;
    } else {
      if (m.kind == I4 && p->transform_8x8) {
        MbInfo *a = mbA(), *b = mbB();
        m.t8 = p->cabac ? cabac.bin(399 + (a && a->t8) + (b && b->t8), m.t8) : bits.flag(m.t8);
        if (m.t8) { m.kind = I8; c.kind = I8; c.t8 = true; }
      }
      if (m.kind == I4) {
        for (int k = 0; k < 16; k++) {
          int r = kBlkRaster[k];
          m.ipred[k] = intra_mode_syntax(m.ipred[k], r & 3, r >> 2);
          c.ipred[r] = (int8_t)m.ipred[k];
        }
      } else if (m.kind == I8) {
        for (int k = 0; k < 4; k++) {
          int bx = (k & 1) * 2, by = (k >> 1) * 2;
          m.ipred[k] = intra_mode_syntax(m.ipred[k], bx, by);
          for (int j = 0; j < 4; j++) c.ipred[(by + (j >> 1)) * 4 + bx + (j & 1)] = (int8_t)m.ipred[k];
        }
      }
      if (p->cabac) {
        MbInfo *a = mbA(), *b = mbB();
        int inc = (a && a->intra && a->kind != IPCM && a->cmode) +
                  (b && b->intra && b->kind != IPCM && b->cmode);
        int n = 0;
        while (n < 3 && cabac.bin(n == 0 ? 64 + inc : 67, n < m.cmode)) n++;
        m.cmode = n;
      } else {
        m.cmode = bits.ue(m.cmode);
        if (m.cmode > 3) fail("intra_chroma_pred_mode > 3");
      }
      c.cmode = m.cmode;
    }
    if (m.kind != I16) {
      if (p->cabac) {
        MbInfo *a = mbA(), *b = mbB();
        // unavailable and I_PCM neighbours read as "all coded" here
        int la = !a || a->kind == IPCM ? 15 : a->cbp & 15;
        int lb = !b || b->kind == IPCM ? 15 : b->cbp & 15;
        int want = m.cbp, l = 0;
        for (int k = 0; k < 4; k++) {
          int bx = k & 1, by = k >> 1;
          int ca = bx ? !((l >> (k - 1)) & 1) : !((la >> (k + 1)) & 1);
          int cb = by ? !((l >> (k - 2)) & 1) : !((lb >> (k + 2)) & 1);
          l |= cabac.bin(73 + ca + 2 * cb, (want >> k) & 1) << k;
        }
        int ca = a ? (a->kind == IPCM ? 2 : a->cbp >> 4) : 0;
        int cb = b ? (b->kind == IPCM ? 2 : b->cbp >> 4) : 0;
        int ch = 0;
        if (cabac.bin(77 + (ca > 0) + 2 * (cb > 0), (want >> 4) > 0))
          ch = 1 + cabac.bin(81 + (ca == 2) + 2 * (cb == 2), (want >> 4) == 2);
        cbp = l | ch << 4;
      } else {
        const uint8_t* tab = intra ? kCbpIntra : kCbpInter;
        int code = 0;
        if (W())
          while (code < 48 && tab[code] != m.cbp) code++;
        code = bits.ue(code);
        if (code > 47) fail("coded_block_pattern code > 47");
        cbp = tab[code];
      }
      if ((cbp & 15) && p->transform_8x8 && !intra && !small) {
        MbInfo *a = mbA(), *b = mbB();
        m.t8 = p->cabac ? cabac.bin(399 + (a && a->t8) + (b && b->t8), m.t8) : bits.flag(m.t8);
        c.t8 = m.t8 != 0;
      }
    }
    m.cbp = cbp;
    c.cbp = cbp;
    if (c.t8) stats[S_T8]++;
    stats[m.kind == I4 ? S_I4 : m.kind == I8 ? S_I8 : m.kind == I16 ? S_I16 : S_INTER]++;
    memset(c.nnz, 0, sizeof c.nnz);
    c.dc[0] = c.dc[1] = c.dc[2] = false;
    if (cbp || m.kind == I16) {
      int d = p->cabac ? qp_delta_cabac(m.qp_delta) : bits.se(m.qp_delta);
      if (d < -26 || d > 25) fail("mb_qp_delta out of range");
      m.qp_delta = d;
      qp = (qp + d + 52) % 52;
      last_dqp = d;
      residual(m);
    } else {
      m.qp_delta = 0;
      last_dqp = 0;
    }
    c.qp = qp;
    c.qpc[0] = chroma_qp(0, qp);
    c.qpc[1] = chroma_qp(1, qp);
    if (!intra) finish_mb_refs();
  }

  void residual(Mb& m) {
    MbInfo& c = ci();
    bool cab = p->cabac;
    int cbpl = c.cbp & 15, cbpc = c.cbp >> 4;
    if (m.kind == I16) {
      int n;
      if (cab) {
        int ba, bb;
        MbInfo *a = left_blk(0, 0, ba), *b = top_blk(0, 0, bb);
        n = cabac_block(0, cbf_cond(a, 0, ba, 0) + 2 * cbf_cond(b, 0, bb, 0), m.dc, 0, 16);
      } else {
        n = cavlc_block(nc(0), m.dc, 0, 16);
      }
      c.dc[0] = n > 0;
    }
    for (int b8 = 0; b8 < 4; b8++) {
      bool coded = (cbpl >> b8) & 1;
      if (c.t8 && cab) {
        int n = 0;
        if (coded) n = cabac_block(5, 0, m.luma8[b8], 0, 64);
        else if (!W()) memset(m.luma8[b8], 0, sizeof m.luma8[b8]);
        for (int b4 = 0; b4 < 4; b4++) c.nnz[kBlkRaster[b8 * 4 + b4]] = (uint8_t)n;
        continue;
      }
      for (int b4 = 0; b4 < 4; b4++) {
        int k = b8 * 4 + b4, r = kBlkRaster[k];
        int16_t* lv = m.luma[k];
        int n = 0;
        if (!coded) {
          if (!W()) memset(lv, 0, sizeof m.luma[k]);
          if (c.t8 && !W())
            for (int i = 0; i < 16; i++) m.luma8[b8][4 * i + b4] = 0;
        } else if (m.kind == I16) {
          if (cab) {
            int ba, bb;
            MbInfo *a = left_blk(r & 3, r >> 2, ba), *b = top_blk(r & 3, r >> 2, bb);
            n = cabac_block(1, cbf_cond(a, 1, ba, 0) + 2 * cbf_cond(b, 1, bb, 0), lv, 1, 15);
          } else {
            n = cavlc_block(nc(r), lv, 1, 15);
          }
        } else if (!c.t8) {
          if (cab) {
            int ba, bb;
            MbInfo *a = left_blk(r & 3, r >> 2, ba), *b = top_blk(r & 3, r >> 2, bb);
            n = cabac_block(2, cbf_cond(a, 2, ba, 0) + 2 * cbf_cond(b, 2, bb, 0), lv, 0, 16);
          } else {
            n = cavlc_block(nc(r), lv, 0, 16);
          }
        } else {  // CAVLC 8x8: four interleaved 4x4 parts
          if (W())
            for (int i = 0; i < 16; i++) lv[i] = m.luma8[b8][4 * i + b4];
          n = cavlc_block(nc(r), lv, 0, 16);
          if (!W())
            for (int i = 0; i < 16; i++) m.luma8[b8][4 * i + b4] = lv[i];
        }
        c.nnz[r] = (uint8_t)n;
      }
    }
    for (int ch = 0; ch < 2; ch++) {
      int n = 0;
      if (cbpc & 3) {
        if (cab) {
          MbInfo *a = mbA(), *b = mbB();
          n = cabac_block(3, cbf_cond(a, 3, 0, ch) + 2 * cbf_cond(b, 3, 0, ch), m.cdc[ch], 0, 4);
        } else {
          n = cavlc_block(-1, m.cdc[ch], 0, 4);
        }
      } else if (!W()) {
        memset(m.cdc[ch], 0, sizeof m.cdc[ch]);
      }
      c.dc[1 + ch] = n > 0;
    }
    for (int ch = 0; ch < 2; ch++)
      for (int k = 0; k < 4; k++) {
        int blk = 16 + 4 * ch + k, n = 0;
        int16_t* lv = m.cac[ch][k];
        if (cbpc & 2) {
          if (cab) {
            int ba, bb;
            MbInfo *a = left_cblk(ch, k & 1, k >> 1, ba), *b = top_cblk(ch, k & 1, k >> 1, bb);
            n = cabac_block(4, cbf_cond(a, 4, ba, ch) + 2 * cbf_cond(b, 4, bb, ch), lv, 1, 15);
          } else {
            n = cavlc_block(nc(blk), lv, 1, 15);
          }
        } else if (!W()) {
          memset(lv, 0, sizeof m.cac[ch][k]);
        }
        c.nnz[blk] = (uint8_t)n;
      }
  }

  // ---------------------------------------------------- reconstruction --
  uint8_t* pix(int c, int x, int y) { return cur->plane(c) + (size_t)y * cur->stride(c) + x; }

  // 4x4 inverse transform of d (raster) added to the 4x4 block at dst (8.5.12.2)
  static void idct4_add(int* d, uint8_t* dst, int stride) {
    int t[16];
    for (int i = 0; i < 4; i++) {
      int* r = d + 4 * i;
      int e = r[0] + r[2], f = r[0] - r[2], g = (r[1] >> 1) - r[3], h = r[1] + (r[3] >> 1);
      t[4 * i] = e + h;
      t[4 * i + 1] = f + g;
      t[4 * i + 2] = f - g;
      t[4 * i + 3] = e - h;
    }
    for (int j = 0; j < 4; j++) {
      int a = t[j], b = t[4 + j], c = t[8 + j], dd = t[12 + j];
      int e = a + c, f = a - c, g = (b >> 1) - dd, h = b + (dd >> 1);
      int out[4] = {e + h, f + g, f - g, e - h};
      for (int i = 0; i < 4; i++) {
        uint8_t* q = dst + i * stride + j;
        *q = clip8(*q + ((out[i] + 32) >> 6));
      }
    }
  }
  // 8x8 inverse transform (8.5.13)
  static void idct8_1d(const int* s, int step, int* o, int ostep) {
    int d0 = s[0], d1 = s[step], d2 = s[2 * step], d3 = s[3 * step], d4 = s[4 * step],
        d5 = s[5 * step], d6 = s[6 * step], d7 = s[7 * step];
    int a0 = d0 + d4, a4 = d0 - d4, a2 = (d2 >> 1) - d6, a6 = d2 + (d6 >> 1);
    int b0 = a0 + a6, b2 = a4 + a2, b4 = a4 - a2, b6 = a0 - a6;
    int a1 = -d3 + d5 - d7 - (d7 >> 1), a3 = d1 + d7 - d3 - (d3 >> 1);
    int a5 = -d1 + d7 + d5 + (d5 >> 1), a7 = d3 + d5 + d1 + (d1 >> 1);
    int b1 = a1 + (a7 >> 2), b7 = a7 - (a1 >> 2), b3 = a3 + (a5 >> 2), b5 = (a3 >> 2) - a5;
    o[0] = b0 + b7;
    o[ostep] = b2 + b5;
    o[2 * ostep] = b4 + b3;
    o[3 * ostep] = b6 + b1;
    o[4 * ostep] = b6 - b1;
    o[5 * ostep] = b4 - b3;
    o[6 * ostep] = b2 - b5;
    o[7 * ostep] = b0 - b7;
  }
  static void idct8_add(int* d, uint8_t* dst, int stride) {
    int t[64], u[64];
    for (int i = 0; i < 8; i++) idct8_1d(d + 8 * i, 1, t + 8 * i, 1);
    for (int j = 0; j < 8; j++) idct8_1d(t + j, 8, u + j, 8);
    for (int i = 0; i < 8; i++)
      for (int j = 0; j < 8; j++) {
        uint8_t* q = dst + i * stride + j;
        *q = clip8(*q + ((u[8 * i + j] + 32) >> 6));
      }
  }
  // levels (scan order) -> scaled coefficients (raster), 4x4; dc: the DC
  // already scaled (Intra16x16 and chroma), or kNoDc to scale position 0
  void scale4(const int16_t* lv, int list, int q, int dc, int* d) {
    const int* ls = ls4[list][q % 6];
    for (int k = 0; k < 16; k++) {
      int r = kZigzag4[k], v = lv[k];
      if (k == 0 && dc != kNoDc) { d[r] = dc; continue; }
      if (!v) { d[r] = 0; continue; }
      d[r] = q >= 24 ? (v * ls[r]) << (q / 6 - 4) : (v * ls[r] + (1 << (3 - q / 6))) >> (4 - q / 6);
    }
  }
  void scale8(const int16_t* lv, int list, int q, int* d) {
    const int* ls = ls8[list][q % 6];
    for (int k = 0; k < 64; k++) {
      int r = kZigzag8[k], v = lv[k];
      if (!v) { d[r] = 0; continue; }
      d[r] = q >= 36 ? (v * ls[r]) << (q / 6 - 6) : (v * ls[r] + (1 << (5 - q / 6))) >> (6 - q / 6);
    }
  }

  // Intra NxN (N 4 or 8) from the edge t[0..2N-1], l[0..N-1] and tl (8.3.1.2, 8.3.2.2)
  static void pred_nxn(int N, int mode, const int* t, const int* l, int tl, bool hasL, bool hasT,
                       uint8_t* dst, int stride) {
    auto T = [&](int x) { return x < 0 ? tl : t[x]; };
    auto L = [&](int y) { return y < 0 ? tl : l[y]; };
    int sh = N == 4 ? 2 : 3;
    for (int y = 0; y < N; y++)
      for (int x = 0; x < N; x++) {
        int v;
        switch (mode) {
          case 0: v = t[x]; break;
          case 1: v = l[y]; break;
          case 2: {
            int st = 0, sl = 0;
            for (int k = 0; k < N; k++) { st += t[k]; sl += l[k]; }
            if (hasL && hasT) v = (st + sl + N) >> (sh + 1);
            else if (hasL) v = (sl + N / 2) >> sh;
            else if (hasT) v = (st + N / 2) >> sh;
            else v = 128;
            break;
          }
          case 3:
            v = x == N - 1 && y == N - 1 ? (t[2 * N - 2] + 3 * t[2 * N - 1] + 2) >> 2
                                         : (t[x + y] + 2 * t[x + y + 1] + t[x + y + 2] + 2) >> 2;
            break;
          case 4:
            if (x > y) v = (T(x - y - 2) + 2 * T(x - y - 1) + T(x - y) + 2) >> 2;
            else if (x < y) v = (L(y - x - 2) + 2 * L(y - x - 1) + L(y - x) + 2) >> 2;
            else v = (T(0) + 2 * tl + L(0) + 2) >> 2;
            break;
          case 5: {
            int z = 2 * x - y;
            if (z >= 0 && !(z & 1)) v = (T(x - (y >> 1) - 1) + T(x - (y >> 1)) + 1) >> 1;
            else if (z >= 0) v = (T(x - (y >> 1) - 2) + 2 * T(x - (y >> 1) - 1) + T(x - (y >> 1)) + 2) >> 2;
            else if (z == -1) v = (L(0) + 2 * tl + T(0) + 2) >> 2;
            else v = (L(y - 2 * x - 1) + 2 * L(y - 2 * x - 2) + L(y - 2 * x - 3) + 2) >> 2;
            break;
          }
          case 6: {
            int z = 2 * y - x;
            if (z >= 0 && !(z & 1)) v = (L(y - (x >> 1) - 1) + L(y - (x >> 1)) + 1) >> 1;
            else if (z >= 0) v = (L(y - (x >> 1) - 2) + 2 * L(y - (x >> 1) - 1) + L(y - (x >> 1)) + 2) >> 2;
            else if (z == -1) v = (L(0) + 2 * tl + T(0) + 2) >> 2;
            else v = (T(x - 2 * y - 1) + 2 * T(x - 2 * y - 2) + T(x - 2 * y - 3) + 2) >> 2;
            break;
          }
          case 7:
            if (!(y & 1)) v = (t[x + (y >> 1)] + t[x + (y >> 1) + 1] + 1) >> 1;
            else v = (t[x + (y >> 1)] + 2 * t[x + (y >> 1) + 1] + t[x + (y >> 1) + 2] + 2) >> 2;
            break;
          default: {
            int z = x + 2 * y;
            if (z < 2 * N - 3 && !(z & 1)) v = (l[y + (x >> 1)] + l[y + (x >> 1) + 1] + 1) >> 1;
            else if (z < 2 * N - 3) v = (l[y + (x >> 1)] + 2 * l[y + (x >> 1) + 1] + l[y + (x >> 1) + 2] + 2) >> 2;
            else if (z == 2 * N - 3) v = (l[N - 2] + 3 * l[N - 1] + 2) >> 2;
            else v = l[N - 1];
          }
        }
        dst[y * stride + x] = (uint8_t)v;
      }
  }
  // availability of a luma block's neighbouring samples for intra prediction:
  // block (bx, by) of size n (4 or 8 samples) in the macroblock
  void intra_avail(int bx, int by, int n, bool& L, bool& T, bool& TL, bool& TR) {
    int x = bx * 4, y = by * 4;
    L = x > 0 || intra_ok(mbx - 1, mby);
    T = y > 0 || intra_ok(mbx, mby - 1);
    TL = x > 0 && y > 0 ? true : x > 0 ? intra_ok(mbx, mby - 1)
                                        : y > 0 ? intra_ok(mbx - 1, mby) : intra_ok(mbx - 1, mby - 1);
    int xr = x + n;  // the top-right neighbour
    if (y == 0) TR = xr < 16 ? intra_ok(mbx, mby - 1) : intra_ok(mbx + 1, mby - 1);
    else if (xr >= 16) TR = false;
    else if (n == 8) TR = true;  // 8x8 #2's top-right is #1
    else {
      // decoded before this block iff its luma4x4BlkIdx is lower
      static const int idx_of_raster[16] = {0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15};
      TR = idx_of_raster[(by - 1) * 4 + bx + 1] < idx_of_raster[by * 4 + bx];
    }
  }
  void intra_luma_block(const Mb& m, int k, int n) {  // k: luma4x4BlkIdx (n 4) or 8x8 index (n 8)
    int bx, by;
    if (n == 4) { bx = kBlkRaster[k] & 3; by = kBlkRaster[k] >> 2; }
    else { bx = (k & 1) * 2; by = (k >> 1) * 2; }
    bool L, T, TL, TR;
    intra_avail(bx, by, n, L, T, TL, TR);
    int px = mbx * 16 + bx * 4, py = mby * 16 + by * 4, st = cur->stride(0);
    uint8_t* dst = pix(0, px, py);
    int t[16] = {0}, l[8] = {0}, tl = 0;
    if (T) {
      for (int i = 0; i < n; i++) t[i] = dst[-st + i];
      for (int i = n; i < 2 * n; i++) t[i] = TR ? dst[-st + i] : t[n - 1];
    }
    if (L)
      for (int i = 0; i < n; i++) l[i] = dst[i * st - 1];
    if (TL) tl = dst[-st - 1];
    int mode = m.ipred[k];
    static const uint8_t need[9] = {1, 2, 0, 1, 7, 7, 7, 1, 2};  // bit 0 top, 1 left, 2 top-left
    if (((need[mode] & 1) && !T) || ((need[mode] & 2) && !L) || ((need[mode] & 4) && !TL))
      fail("intra prediction mode " + std::to_string(mode) + " uses unavailable samples");
    if (n == 8) {  // the reference sample filter of 8.3.2.2.1
      int ft[16], fl[8], ftl = tl;
      if (T) {
        ft[0] = TL ? (tl + 2 * t[0] + t[1] + 2) >> 2 : (3 * t[0] + t[1] + 2) >> 2;
        for (int i = 1; i < 15; i++) ft[i] = (t[i - 1] + 2 * t[i] + t[i + 1] + 2) >> 2;
        ft[15] = (t[14] + 3 * t[15] + 2) >> 2;
      }
      if (TL) {
        if (T && L) ftl = (t[0] + 2 * tl + l[0] + 2) >> 2;
        else if (T) ftl = (3 * tl + t[0] + 2) >> 2;
        else if (L) ftl = (3 * tl + l[0] + 2) >> 2;
      }
      if (L) {
        fl[0] = TL ? (tl + 2 * l[0] + l[1] + 2) >> 2 : (3 * l[0] + l[1] + 2) >> 2;
        for (int i = 1; i < 7; i++) fl[i] = (l[i - 1] + 2 * l[i] + l[i + 1] + 2) >> 2;
        fl[7] = (l[6] + 3 * l[7] + 2) >> 2;
      }
      pred_nxn(8, mode, T ? ft : t, L ? fl : l, ftl, L, T, dst, st);
    } else {
      pred_nxn(4, mode, t, l, tl, L, T, dst, st);
    }
  }
  void pred16(int mode, uint8_t* dst, int st, bool L, bool T, bool TL) {
    static const uint8_t need[4] = {1, 2, 0, 7};
    if (((need[mode] & 1) && !T) || ((need[mode] & 2) && !L) || ((need[mode] & 4) && !TL))
      fail("Intra16x16 prediction mode " + std::to_string(mode) + " uses unavailable samples");
    int t[16], l[16], tl = TL ? dst[-st - 1] : 0;
    for (int i = 0; i < 16; i++) {
      t[i] = T ? dst[-st + i] : 0;
      l[i] = L ? dst[i * st - 1] : 0;
    }
    int dc = 128;
    if (mode == 2) {
      int s = 0;
      for (int i = 0; i < 16; i++) s += (T ? t[i] : 0) + (L ? l[i] : 0);
      dc = T && L ? (s + 16) >> 5 : T || L ? (s + 8) >> 4 : 128;
    }
    int a = 0, b = 0, c = 0;
    if (mode == 3) {
      int H = 0, V = 0;
      for (int i = 0; i < 8; i++) {
        H += (i + 1) * (t[8 + i] - (6 - i < 0 ? tl : t[6 - i]));
        V += (i + 1) * (l[8 + i] - (6 - i < 0 ? tl : l[6 - i]));
      }
      a = 16 * (l[15] + t[15]);
      b = (5 * H + 32) >> 6;
      c = (5 * V + 32) >> 6;
    }
    for (int y = 0; y < 16; y++)
      for (int x = 0; x < 16; x++) {
        int v = mode == 0 ? t[x] : mode == 1 ? l[y] : mode == 2 ? dc
                : clip8((a + b * (x - 7) + c * (y - 7) + 16) >> 5);
        dst[y * st + x] = (uint8_t)v;
      }
  }
  void pred_chroma(int mode, uint8_t* dst, int st, bool L, bool T, bool TL) {
    static const uint8_t need[4] = {0, 2, 1, 7};
    if (((need[mode] & 1) && !T) || ((need[mode] & 2) && !L) || ((need[mode] & 4) && !TL))
      fail("intra chroma prediction mode " + std::to_string(mode) + " uses unavailable samples");
    int t[8], l[8], tl = TL ? dst[-st - 1] : 0;
    for (int i = 0; i < 8; i++) {
      t[i] = T ? dst[-st + i] : 0;
      l[i] = L ? dst[i * st - 1] : 0;
    }
    if (mode == 0) {
      for (int by = 0; by < 2; by++)
        for (int bx = 0; bx < 2; bx++) {
          int st4 = 0, sl4 = 0;
          for (int i = 0; i < 4; i++) { st4 += t[bx * 4 + i]; sl4 += l[by * 4 + i]; }
          int v;
          if ((bx == 0 && by == 0) || (bx && by)) {
            v = T && L ? (st4 + sl4 + 4) >> 3 : L ? (sl4 + 2) >> 2 : T ? (st4 + 2) >> 2 : 128;
          } else if (bx) {
            v = T ? (st4 + 2) >> 2 : L ? (sl4 + 2) >> 2 : 128;
          } else {
            v = L ? (sl4 + 2) >> 2 : T ? (st4 + 2) >> 2 : 128;
          }
          for (int y = 0; y < 4; y++)
            for (int x = 0; x < 4; x++) dst[(by * 4 + y) * st + bx * 4 + x] = (uint8_t)v;
        }
      return;
    }
    int a = 0, b = 0, c = 0;
    if (mode == 3) {
      int H = 0, V = 0;
      for (int i = 0; i < 4; i++) {
        H += (i + 1) * (t[4 + i] - (2 - i < 0 ? tl : t[2 - i]));
        V += (i + 1) * (l[4 + i] - (2 - i < 0 ? tl : l[2 - i]));
      }
      a = 16 * (l[7] + t[7]);
      b = (34 * H + 32) >> 6;
      c = (34 * V + 32) >> 6;
    }
    for (int y = 0; y < 8; y++)
      for (int x = 0; x < 8; x++) {
        int v = mode == 1 ? l[y] : mode == 2 ? t[x] : clip8((a + b * (x - 3) + c * (y - 3) + 16) >> 5);
        dst[y * st + x] = (uint8_t)v;
      }
  }

  // luma sample interpolation (8.4.2.2.1) of a w x h block at (bx, by) + mv:
  // the 6-tap half samples b (rows -2..h+2), h (columns 0..w) and j, then
  // the position's average
  static void mc_luma(const Picture& r, int bx, int by, int w, int h, int mvx, int mvy,
                      uint8_t* dst, int ds) {
    int xi = bx + (mvx >> 2), yi = by + (mvy >> 2), fx = mvx & 3, fy = mvy & 3;
    const int W = w + 5;
    uint8_t win[21 * 21];
    const uint8_t* src = r.plane(0);
    bool inside = xi - 2 >= 0 && yi - 2 >= 0 && xi + w + 3 <= r.w && yi + h + 3 <= r.h;
    for (int j = 0; j < h + 5; j++) {
      if (inside) {
        memcpy(win + j * W, src + (size_t)(yi - 2 + j) * r.w + xi - 2, W);
        continue;
      }
      const uint8_t* row = src + (size_t)clip3(0, r.h - 1, yi - 2 + j) * r.w;
      for (int i = 0; i < W; i++) win[j * W + i] = row[clip3(0, r.w - 1, xi - 2 + i)];
    }
    auto G = [&](int x, int y) -> int { return win[(y + 2) * W + x + 2]; };
    if (!fx && !fy) {
      for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) dst[y * ds + x] = (uint8_t)G(x, y);
      return;
    }
    auto tap = [](int a, int b, int c, int d, int e, int f) {
      return a - 5 * b + 20 * c + 20 * d - 5 * e + f;
    };
    auto c5 = [](int v) { return (int)clip8((v + 16) >> 5); };
    int B1[21 * 16], H1[16 * 17], J[16 * 16];
    if (fx) {  // b1 at rows -2..h+2
      for (int y = -2; y < h + 3; y++)
        for (int x = 0; x < w; x++)
          B1[(y + 2) * w + x] = tap(G(x - 2, y), G(x - 1, y), G(x, y), G(x + 1, y), G(x + 2, y), G(x + 3, y));
    }
    if (fy) {  // h1 at columns 0..w
      for (int y = 0; y < h; y++)
        for (int x = 0; x <= w; x++)
          H1[y * (w + 1) + x] = tap(G(x, y - 2), G(x, y - 1), G(x, y), G(x, y + 1), G(x, y + 2), G(x, y + 3));
    }
    bool needj = (fx == 2 && fy) || (fy == 2 && fx);
    if (needj) {
      for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) {
          const int* c = B1 + y * w + x;
          int v = tap(c[0], c[w], c[2 * w], c[3 * w], c[4 * w], c[5 * w]);
          J[y * w + x] = (int)clip8((v + 512) >> 10);
        }
    }
    for (int y = 0; y < h; y++)
      for (int x = 0; x < w; x++) {
        int b = fx ? c5(B1[(y + 2) * w + x]) : 0;           // half, row y
        int s = fx ? c5(B1[(y + 3) * w + x]) : 0;           // half, row y + 1
        int hh = fy ? c5(H1[y * (w + 1) + x]) : 0;          // half, column x
        int m = fy ? c5(H1[y * (w + 1) + x + 1]) : 0;       // half, column x + 1
        int j = needj ? J[y * w + x] : 0;
        int v;
        switch (fy * 4 + fx) {
          case 1: v = (G(x, y) + b + 1) >> 1; break;       // a
          case 2: v = b; break;                            // b
          case 3: v = (G(x + 1, y) + b + 1) >> 1; break;   // c
          case 4: v = (G(x, y) + hh + 1) >> 1; break;      // d
          case 5: v = (b + hh + 1) >> 1; break;            // e
          case 6: v = (b + j + 1) >> 1; break;             // f
          case 7: v = (b + m + 1) >> 1; break;             // g
          case 8: v = hh; break;                           // h
          case 9: v = (hh + j + 1) >> 1; break;            // i
          case 10: v = j; break;                           // j
          case 11: v = (j + m + 1) >> 1; break;            // k
          case 12: v = (G(x, y + 1) + hh + 1) >> 1; break; // n
          case 13: v = (hh + s + 1) >> 1; break;           // p
          case 14: v = (j + s + 1) >> 1; break;            // q
          default: v = (m + s + 1) >> 1; break;            // r
        }
        dst[y * ds + x] = (uint8_t)v;
      }
  }
  // chroma sample interpolation (8.4.2.2.2), 4:2:0: mv in 1/8 chroma samples
  static void mc_chroma(const Picture& r, int c, int bx, int by, int w, int h, int mvx, int mvy,
                        uint8_t* dst, int ds) {
    int cw = r.w / 2, chh = r.h / 2;
    int xi = bx + (mvx >> 3), yi = by + (mvy >> 3), fx = mvx & 7, fy = mvy & 7;
    const uint8_t* src = r.plane(c);
    for (int y = 0; y < h; y++) {
      const uint8_t* r0 = src + (size_t)clip3(0, chh - 1, yi + y) * cw;
      const uint8_t* r1 = src + (size_t)clip3(0, chh - 1, yi + y + 1) * cw;
      for (int x = 0; x < w; x++) {
        int x0 = clip3(0, cw - 1, xi + x), x1 = clip3(0, cw - 1, xi + x + 1);
        dst[y * ds + x] = (uint8_t)(((8 - fx) * (8 - fy) * r0[x0] + fx * (8 - fy) * r0[x1] +
                                     (8 - fx) * fy * r1[x0] + fx * fy * r1[x1] + 32) >> 6);
      }
    }
  }
  const Picture& ref_pic(int l, int r) const {
    if (r < 0 || r >= (int)list[l].size() || !list[l][r]) fail("reference to a missing picture");
    return *list[l][r];
  }
  // the prediction of one block into the picture (8.4.2): list 0, list 1 or
  // both (ref < 0: list not used), weighted as the slice says (8.4.2.3)
  // mcw: the width of FFmpeg's prediction block, which picks its weighting code
  void predict_partition(int x, int y, int w, int h, const int ref[2], const int mv[2][2],
                         int mcw = 16) {
    int px = mbx * 16 + x, py = mby * 16 + y;
    uint8_t* d[3] = {pix(0, px, py), pix(1, px / 2, py / 2), pix(2, px / 2, py / 2)};
    int st[3] = {cur->stride(0), cur->stride(1), cur->stride(2)};
    int l0 = ref[0] >= 0 ? 0 : 1;
    const Picture& r0 = ref_pic(l0, ref[l0]);
    mc_luma(r0, px, py, w, h, mv[l0][0], mv[l0][1], d[0], st[0]);
    for (int c = 1; c < 3; c++)
      mc_chroma(r0, c, px / 2, py / 2, w / 2, h / 2, mv[l0][0], mv[l0][1], d[c], st[c]);
    if (l0 == 1 || ref[1] < 0) {  // one list
      if (wt.on != 1) return;
      int l = l0, r = ref[l];
      for (int c = 0; c < 3; c++) {
        // (v w + 2^(logWD - 1)) >> logWD, + o: (v w + (o << logWD) + 2^(logWD - 1)) >> logWD
        int lwd = c ? wt.cwd : wt.lwd;
        int wv = c ? wt.cw[l][r][c - 1] : wt.lw[l][r], o = c ? wt.co[l][r][c - 1] : wt.lo[l][r];
        int bw = c ? w / 2 : w, bh = c ? h / 2 : h;
        bool simd = (c ? mcw / 2 : mcw) >= kSimdWidth;
        int add = o * (1 << lwd) + (lwd ? 1 << (lwd - 1) : 0);
        if (simd) add = (int16_t)add;
        for (int j = 0; j < bh; j++)
          for (int i = 0; i < bw; i++) {
            uint8_t& v = d[c][j * st[c] + i];
            int x = v * wv + add;
            v = clip8((simd ? sat16(x) : x) >> lwd);
          }
      }
      return;
    }
    // both lists: list 1's prediction beside list 0's, then their average
    uint8_t t[3][256];
    const Picture& r1 = ref_pic(1, ref[1]);
    mc_luma(r1, px, py, w, h, mv[1][0], mv[1][1], t[0], 16);
    for (int c = 1; c < 3; c++)
      mc_chroma(r1, c, px / 2, py / 2, w / 2, h / 2, mv[1][0], mv[1][1], t[c], 8);
    for (int c = 0; c < 3; c++) {
      int bw = c ? w / 2 : w, bh = c ? h / 2 : h, ts = c ? 8 : 16;
      if (!wt.on) {  // the default average
        for (int j = 0; j < bh; j++)
          for (int i = 0; i < bw; i++) {
            uint8_t& v = d[c][j * st[c] + i];
            v = (uint8_t)((v + t[c][j * ts + i] + 1) >> 1);
          }
        continue;
      }
      // weighted (8.4.2.3): ((a w0 + b w1 + 2^logWD) >> (logWD + 1)) + ((o0 + o1 + 1) >> 1)
      // as FFmpeg's biweight computes it, offset folded into the rounding:
      // (a w0 + b w1 + (((o0 + o1 + 1) | 1) << logWD)) >> (logWD + 1); its
      // SIMD takes the weights as signed bytes and when one is 128 halves
      // both weights (rounding down), the offset term and the shift
      int w0, w1, sum = 0, lwd = 5;
      if (wt.on == 1) {
        lwd = c ? wt.cwd : wt.lwd;
        w0 = c ? wt.cw[0][ref[0]][c - 1] : wt.lw[0][ref[0]];
        w1 = c ? wt.cw[1][ref[1]][c - 1] : wt.lw[1][ref[1]];
        sum = c ? wt.co[0][ref[0]][c - 1] + wt.co[1][ref[1]][c - 1] : wt.lo[0][ref[0]] + wt.lo[1][ref[1]];
      } else {
        w0 = wt.implicit[ref[0]][ref[1]];
        w1 = 64 - w0;
      }
      int off = (sum + 1) | 1, shift = lwd + 1;
      bool simd = (c ? mcw / 2 : mcw) >= kSimdWidth;
      if ((w0 == 128 || w1 == 128) && simd) {
        w0 >>= 1;
        w1 >>= 1;
        off >>= 1;
        shift--;
      }
      int round = (int)(((int64_t)off << shift) >> 1);
      if (simd) round = (int16_t)round;
      for (int j = 0; j < bh; j++)
        for (int i = 0; i < bw; i++) {
          uint8_t& v = d[c][j * st[c] + i];
          int x = v * w0 + t[c][j * ts + i] * w1;
          v = clip8((simd ? sat16(sat16(x) + round) : x + round) >> shift);
        }
    }
  }
  // the inter prediction of the macroblock: block by block (sample
  // interpolation and weighting are per sample), as one 16x16 block when its
  // motion is uniform, else by 8x8 quadrants, else by 4x4 blocks
  void predict_inter() {
    const MbInfo& c = ci();
    auto same = [&](int a, int b) {
      if (c.mcw[a] != c.mcw[b]) return false;
      for (int l = 0; l < 2; l++) {
        int ra = c.ref[l][((a >> 3) << 1) | ((a & 3) >> 1)], rb = c.ref[l][((b >> 3) << 1) | ((b & 3) >> 1)];
        if (ra != rb) return false;
        if (ra >= 0 && (c.mv[l][a][0] != c.mv[l][b][0] || c.mv[l][a][1] != c.mv[l][b][1])) return false;
      }
      return true;
    };
    auto block = [&](int blk, int size) {
      int b8 = ((blk >> 3) << 1) | ((blk & 3) >> 1);
      int ref[2] = {c.ref[0][b8], c.ref[1][b8]};
      int mv[2][2] = {{c.mv[0][blk][0], c.mv[0][blk][1]}, {c.mv[1][blk][0], c.mv[1][blk][1]}};
      predict_partition((blk & 3) * 4, (blk >> 2) * 4, size, size, ref, mv, c.mcw[blk]);
    };
    bool all = true;
    for (int b = 1; b < 16 && all; b++) all = same(0, b);
    if (all) { block(0, 16); return; }
    for (int q = 0; q < 4; q++) {
      int b0 = (q >> 1) * 8 + (q & 1) * 2;
      if (same(b0, b0 + 1) && same(b0, b0 + 4) && same(b0, b0 + 5)) {
        block(b0, 8);
      } else {
        for (int j = 0; j < 4; j++) block(b0 + (j >> 1) * 4 + (j & 1), 4);
      }
    }
  }

  void reconstruct(const Mb& m) {
    MbInfo& c = ci();
    int px = mbx * 16, py = mby * 16, st = cur->stride(0), cst = cur->stride(1);
    if (m.kind == IPCM) {
      for (int y = 0; y < 16; y++) memcpy(pix(0, px, py + y), m.pcm + 16 * y, 16);
      for (int k = 1; k < 3; k++)
        for (int y = 0; y < 8; y++) memcpy(pix(k, px / 2, py / 2 + y), m.pcm + 256 + 64 * (k - 1) + 8 * y, 8);
      return;
    }
    int q = c.qp;
    bool intra = c.intra;
    int d[64];
    if (!intra) predict_inter();
    int ylist = intra ? 0 : 3;
    if (m.kind == I16) {
      pred16(m.i16, pix(0, px, py), st, intra_ok(mbx - 1, mby), intra_ok(mbx, mby - 1),
             intra_ok(mbx - 1, mby - 1));
      // the luma DC: inverse Hadamard, then scaling (8.5.10)
      int cm[16], f[16], tmp[16];
      for (int k = 0; k < 16; k++) cm[kZigzag4[k]] = m.dc[k];
      for (int i = 0; i < 4; i++) {
        int* r = cm + 4 * i;
        tmp[4 * i] = r[0] + r[1] + r[2] + r[3];
        tmp[4 * i + 1] = r[0] + r[1] - r[2] - r[3];
        tmp[4 * i + 2] = r[0] - r[1] - r[2] + r[3];
        tmp[4 * i + 3] = r[0] - r[1] + r[2] - r[3];
      }
      for (int j = 0; j < 4; j++) {
        int a = tmp[j], b = tmp[4 + j], cc = tmp[8 + j], dd = tmp[12 + j];
        f[j] = a + b + cc + dd;
        f[4 + j] = a + b - cc - dd;
        f[8 + j] = a - b - cc + dd;
        f[12 + j] = a - b + cc - dd;
      }
      int ls = ls4[0][q % 6][0];
      for (int k = 0; k < 16; k++) {
        int r = kBlkRaster[k];
        int v = f[r];
        int dc = q >= 36 ? (v * ls) << (q / 6 - 6) : (v * ls + (1 << (5 - q / 6))) >> (6 - q / 6);
        scale4(m.luma[k], 0, q, dc, d);
        idct4_add(d, pix(0, px + (r & 3) * 4, py + (r >> 2) * 4), st);
      }
    } else if (m.kind == I8 || (!intra && c.t8)) {
      for (int k = 0; k < 4; k++) {
        if (m.kind == I8) intra_luma_block(m, k, 8);
        if (!((c.cbp >> k) & 1)) continue;
        scale8(m.luma8[k], intra ? 0 : 1, q, d);
        idct8_add(d, pix(0, px + (k & 1) * 8, py + (k >> 1) * 8), st);
      }
    } else {
      for (int k = 0; k < 16; k++) {
        int r = kBlkRaster[k];
        if (m.kind == I4) intra_luma_block(m, k, 4);
        if (!c.nnz[r]) continue;
        scale4(m.luma[k], ylist, q, kNoDc, d);
        idct4_add(d, pix(0, px + (r & 3) * 4, py + (r >> 2) * 4), st);
      }
    }
    if (intra)
      for (int k = 1; k < 3; k++)
        pred_chroma(m.cmode, pix(k, px / 2, py / 2), cst, intra_ok(mbx - 1, mby),
                    intra_ok(mbx, mby - 1), intra_ok(mbx - 1, mby - 1));
    if (!(c.cbp >> 4)) return;
    for (int ch = 0; ch < 2; ch++) {
      int qc = c.qpc[ch], list = (intra ? 1 : 4) + ch;
      int c0 = m.cdc[ch][0], c1 = m.cdc[ch][1], c2 = m.cdc[ch][2], c3 = m.cdc[ch][3];
      int f[4] = {c0 + c1 + c2 + c3, c0 - c1 + c2 - c3, c0 + c1 - c2 - c3, c0 - c1 - c2 + c3};
      int ls = ls4[list][qc % 6][0];
      for (int k = 0; k < 4; k++) {
        int dc = ((f[k] * ls) << (qc / 6)) >> 5;
        scale4(m.cac[ch][k], list, qc, dc, d);
        idct4_add(d, pix(1 + ch, px / 2 + (k & 1) * 4, py / 2 + (k >> 1) * 4), cst);
      }
    }
  }

  // ----------------------------------------------------------- slices --
  // slice_data( ) of one slice whose header is in sh (read, or to write)
  void slice_data() {
    bool islice = sh.type == 2;
    qp = sh.qp;
    last_dqp = 0;
    stats[islice ? S_ISLICE : sh.type == 1 ? S_BSLICE : S_PSLICE]++;
    if (p->cabac) {
      stats[S_CABAC]++;
      while (!bits.aligned()) bits.u(1, 1);  // cabac_alignment_one_bit
      cabac.init_contexts(islice, sh.cabac_init_idc, sh.qp);
      cabac.start();
    }
    int n = mbw * mbh;
    addr = sh.first_mb;
    if (addr >= n) fail("first_mb_in_slice beyond the picture");
    bool more = true;
    int run = 0;  // the writer's skipped macroblocks not yet coded in an mb_skip_run
    while (more) {
      if (addr >= n) fail("slice runs past the end of the picture");
      if (info[addr].slice >= 0) fail("macroblock decoded twice");
      Mb m;
      if (W()) {
        m = Mb();
        begin_mb();
        choose(m);
      }
      if (!p->cabac) {
        if (!islice && W()) {
          if (m.skip) {
            skip_mb(m);
            run++;
            addr++;
            more = addr < n && !at_slice_end();
            if (!more) bits.ue(run);
            continue;
          }
          bits.ue(run);
          run = 0;
        } else if (!islice) {
          int r = (int)bits.ue();
          for (int k = 0; k < r; k++) {
            if (addr >= n) fail("mb_skip_run past the end of the picture");
            if (info[addr].slice >= 0) fail("macroblock decoded twice");
            begin_mb();
            skip_mb(m);
            addr++;
          }
          if (r > 0 && !bits.more_rbsp_data()) break;
          if (addr >= n) fail("slice runs past the end of the picture");
        }
        begin_mb();
        macroblock(m);
        reconstruct(m);
        addr++;
        more = W() ? addr < n && !at_slice_end() : bits.more_rbsp_data();
        continue;
      }
      if (!W()) begin_mb();
      if (!islice) {
        MbInfo *a = mbA(), *b = mbB();
        int inc = (a && a->kind != PSKIP && a->kind != BSKIP) + (b && b->kind != PSKIP && b->kind != BSKIP);
        m.skip = cabac.bin((sh.type == 1 ? 24 : 11) + inc, m.skip);
      }
      if (m.skip) {
        skip_mb(m);
      } else {
        macroblock(m);
        reconstruct(m);
      }
      addr++;
      int end = cabac.terminate(W() ? (addr >= n || at_slice_end()) : 0);
      more = !end;
      if (more && addr >= n) fail("slice runs past the end of the picture");
    }
    if (W()) {
      if (!p->cabac) bits.trailing();
      else while (!bits.aligned()) bits.u(1, 0);
    }
  }
  // the writer ends its slices where its chooser says
  int slice_end_addr = 1 << 30;
  bool at_slice_end() const { return addr >= slice_end_addr; }
  void begin_mb() {
    mbx = addr % mbw;
    mby = addr / mbw;
    MbInfo& c = ci();
    c = MbInfo();
    c.slice = slice_num;
    c.lists = sh.lists();
    for (int k = 0; k < 16; k++) c.ipred[k] = -1;
    memset(c.nnz, 0, sizeof c.nnz);
    memset(c.mv, 0, sizeof c.mv);
    memset(c.mvd, 0, sizeof c.mvd);
    for (int l = 0; l < 2; l++)
      for (int k = 0; k < 4; k++) { c.ref[l][k] = -1; c.refpic[l][k] = 0; }
    memset(c.mcw, 16, sizeof c.mcw);
    done = 0;
  }
  // P_Skip, or B_Skip (direct prediction, no residual)
  void skip_mb(Mb& m) {
    MbInfo& c = ci();
    c.intra = false;
    c.cbp = 0;
    c.qp = qp;
    c.qpc[0] = chroma_qp(0, qp);
    c.qpc[1] = chroma_qp(1, qp);
    if (sh.type == 1) {
      c.kind = m.kind = BSKIP;
      direct_motion(15);
      stats[S_BSKIP]++;
    } else {
      c.kind = m.kind = PSKIP;
      for (int k = 0; k < 4; k++) c.ref[0][k] = 0;
      int mv[2], zero[2] = {0, 0};
      skip_mv(mv);
      set_motion(0, 0, 0, 16, 16, mv, zero);
    }
    last_dqp = 0;
    stats[S_SKIP]++;
    reconstruct(m);
    finish_mb_refs();
  }
  void finish_mb_refs() {
    MbInfo& c = ci();
    for (int l = 0; l < 2; l++)
      for (int k = 0; k < 4; k++) c.refpic[l][k] = c.ref[l][k] >= 0 ? ref_pic(l, c.ref[l][k]).id : 0;
  }

  // ------------------------------------------------- deblocking filter --
  bool nonzero(const MbInfo& m, int blk) const {
    if (!m.t8) return m.nnz[blk] != 0;
    int b8x = (blk & 3) >> 1, b8y = blk >> 3, base = b8y * 8 + b8x * 2;
    return m.nnz[base] || m.nnz[base + 1] || m.nnz[base + 4] || m.nnz[base + 5];
  }
  // bS of one edge segment (8.7.2.1) with FFmpeg's check_mv: the lists of
  // Q's slice are compared pairwise (same picture, mvs within 4 quarter
  // samples), and when that fails, across (L0 with L1)
  int bs(const MbInfo& P, int pb, const MbInfo& Q, int qb, bool mb_edge) const {
    if (P.intra || Q.intra) return mb_edge ? 4 : 3;
    if (nonzero(P, pb) || nonzero(Q, qb)) return 2;
    int p8 = ((pb >> 3) << 1) | ((pb & 3) >> 1), q8 = ((qb >> 3) << 1) | ((qb & 3) >> 1);
    auto far = [&](int lq, int lp) {
      return std::abs(Q.mv[lq][qb][0] - P.mv[lp][pb][0]) >= 4 ||
             std::abs(Q.mv[lq][qb][1] - P.mv[lp][pb][1]) >= 4;
    };
    bool v = Q.refpic[0][q8] != P.refpic[0][p8];
    if (!v && Q.refpic[0][q8]) v = far(0, 0);
    if (Q.lists < 2) return v;
    if (!v) v = Q.refpic[1][q8] != P.refpic[1][p8] || far(1, 1);
    if (!v) return 0;
    if (Q.refpic[0][q8] != P.refpic[1][p8] || Q.refpic[1][q8] != P.refpic[0][p8]) return 1;
    return far(0, 1) || far(1, 0);
  }
  static void filter_line(uint8_t* q, int step, int b, int alpha, int beta, int tc0, bool chroma) {
    int p0 = q[-step], p1 = q[-2 * step], q0 = q[0], q1 = q[step];
    if (!(std::abs(p0 - q0) < alpha && std::abs(p1 - p0) < beta && std::abs(q1 - q0) < beta)) return;
    if (chroma) {
      if (b < 4) {
        int tc = tc0 + 1;
        int delta = clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3);
        q[-step] = clip8(p0 + delta);
        q[0] = clip8(q0 - delta);
      } else {
        q[-step] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
        q[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
      }
      return;
    }
    int p2 = q[-3 * step], q2 = q[2 * step];
    int ap = std::abs(p2 - p0), aq = std::abs(q2 - q0);
    if (b < 4) {
      int tc = tc0 + (ap < beta) + (aq < beta);
      int delta = clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3);
      q[-step] = clip8(p0 + delta);
      q[0] = clip8(q0 - delta);
      if (ap < beta) q[-2 * step] = (uint8_t)(p1 + clip3(-tc0, tc0, (p2 + ((p0 + q0 + 1) >> 1) - (p1 << 1)) >> 1));
      if (aq < beta) q[step] = (uint8_t)(q1 + clip3(-tc0, tc0, (q2 + ((p0 + q0 + 1) >> 1) - (q1 << 1)) >> 1));
      return;
    }
    int p3 = q[-4 * step], q3 = q[3 * step];
    bool strong = std::abs(p0 - q0) < ((alpha >> 2) + 2);
    if (ap < beta && strong) {
      q[-step] = (uint8_t)((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
      q[-2 * step] = (uint8_t)((p2 + p1 + p0 + q0 + 2) >> 2);
      q[-3 * step] = (uint8_t)((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
    } else {
      q[-step] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
    }
    if (aq < beta && strong) {
      q[0] = (uint8_t)((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3);
      q[step] = (uint8_t)((p0 + q0 + q1 + q2 + 2) >> 2);
      q[2 * step] = (uint8_t)((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3);
    } else {
      q[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
    }
  }
  // the whole picture, macroblock by macroblock in raster order (8.7)
  void deblock() {
    for (int y = 0; y < mbh; y++)
      for (int x = 0; x < mbw; x++) deblock_mb(x, y);
  }
  void deblock_mb(int x, int y) {
    const MbInfo& Q = info[y * mbw + x];
    const SliceDb& sd = slices[Q.slice];
    if (sd.disable == 1) return;
    const MbInfo* A = x > 0 ? &info[y * mbw + x - 1] : nullptr;
    const MbInfo* B = y > 0 ? &info[(y - 1) * mbw + x] : nullptr;
    bool left = A && (sd.disable != 2 || A->slice == Q.slice);
    bool top = B && (sd.disable != 2 || B->slice == Q.slice);
    bool fast8x8 = !Q.intra && Q.t8 && (Q.cbp & 7) == 7 && p->cb_qp_offset == p->cr_qp_offset;
    for (int dir = 0; dir < 2; dir++) {  // 0: vertical edges, 1: horizontal
      for (int e = 0; e < 4; e++) {
        if (e == 0 && !(dir ? top : left)) continue;
        if (e && Q.t8 && (e & 1)) continue;
        const MbInfo& P = e ? Q : *(dir ? B : A);
        int b[4];
        for (int k = 0; k < 4; k++) {
          int qb = dir ? e * 4 + k : k * 4 + e;
          int pb = e ? (dir ? qb - 4 : qb - 1) : (dir ? 12 + k : k * 4 + 3);
          b[k] = bs(P, pb, Q, qb, e == 0);
        }
        // FFmpeg's fast loop filter (frames whose two chroma QP offsets are
        // equal) takes an 8x8-transform inter macroblock with its first three
        // 8x8 blocks coded as having coefficients in each: bS 2 on its 8x8
        // edges and its macroblock edges (4 beside an intra one). With CABAC
        // a coded 8x8 block has coefficients; with CAVLC it may have none.
        if (fast8x8 && !(e & 1))
          for (int k = 0; k < 4; k++) b[k] = e == 0 && P.intra ? 4 : 2;
        if (!b[0] && !b[1] && !b[2] && !b[3]) continue;
        for (int c = 0; c < 3; c++) {
          if (c && (e & 1)) continue;  // chroma edges at 0 and 4 (luma 0 and 8)
          int qpav = c ? (P.qpc[c - 1] + Q.qpc[c - 1] + 1) >> 1 : (P.qp + Q.qp + 1) >> 1;
          int ia = clip3(0, 51, qpav + 2 * sd.alpha), ib = clip3(0, 51, qpav + 2 * sd.beta);
          int alpha = kAlpha[ia], beta = kBeta[ib];
          int st = cur->stride(c), n = c ? 8 : 16;
          int ox = c ? x * 8 : x * 16, oy = c ? y * 8 : y * 16;
          int pos = c ? e * 2 : e * 4;
          for (int i = 0; i < n; i++) {
            int bsv = b[c ? i >> 1 : i >> 2];
            if (!bsv) continue;
            int tc0 = bsv < 4 ? kTc0[ia][bsv - 1] : 0;
            uint8_t* q = dir ? pix(c, ox + i, oy + pos) : pix(c, ox + pos, oy + i);
            filter_line(q, dir ? st : 1, bsv, alpha, beta, tc0, c != 0);
          }
        }
      }
    }
  }

  // ----------------------------------------------- pictures and refs --
  int max_frame_num() const { return 1 << s->log2_max_frame_num; }
  int frame_num_wrap(const Picture& pic) const {
    return pic.frame_num > sh.frame_num ? pic.frame_num - max_frame_num() : pic.frame_num;
  }
  void start_picture() {
    if (!sh.idr() && !started) fail("the stream does not start with an IDR picture");
    mbw = s->mbw;
    mbh = s->mbh;
    int mfn = max_frame_num();
    if (sh.idr()) {
      if (sh.frame_num) fail("IDR picture with frame_num != 0");
      started = true;
    } else if (sh.frame_num != prev_ref_frame_num && sh.frame_num != (prev_ref_frame_num + 1) % mfn) {
      unsupported("a gap in frame_num (" + std::to_string(prev_ref_frame_num) + " then " +
                  std::to_string(sh.frame_num) + ")");
    }
    cur = std::make_shared<Picture>();
    cur->alloc(mbw * 16, mbh * 16);
    cur->id = next_id++;
    cur->frame_num = sh.frame_num;
    cur->idr = sh.idr();
    // POC (8.2.1)
    int top, bottom;
    if (s->poc_type == 0) {
      int pm = 0, pl = 0;
      if (!sh.idr()) {
        if (prev_ref_mmco5) { pm = 0; pl = prev_ref_top_after_mmco5; }
        else { pm = prev_ref_msb; pl = prev_ref_lsb; }
      }
      int maxl = 1 << s->log2_max_poc_lsb, lsb = sh.poc_lsb, msb;
      if (lsb < pl && pl - lsb >= maxl / 2) msb = pm + maxl;
      else if (lsb > pl && lsb - pl > maxl / 2) msb = pm - maxl;
      else msb = pm;
      cur->poc_msb = msb;
      cur->poc_lsb = lsb;
      top = msb + lsb;
      bottom = top + sh.delta_poc_bottom;
    } else {
      int prev_off = prev_mmco5 ? 0 : prev_frame_num_offset;
      int off = sh.idr() ? 0 : prev_frame_num > sh.frame_num ? prev_off + mfn : prev_off;
      cur->frame_num_offset = off;
      if (s->poc_type == 1) {
        int n = s->num_ref_frames_in_poc_cycle;
        int abs_fn = n ? off + sh.frame_num : 0;
        if (!sh.nal_ref_idc && abs_fn > 0) abs_fn--;
        int expected = 0;
        if (abs_fn > 0) {
          int delta_cycle = 0;
          for (int i = 0; i < n; i++) delta_cycle += s->offset_for_ref_frame[i];
          int cycles = (abs_fn - 1) / n, in_cycle = (abs_fn - 1) % n;
          expected = cycles * delta_cycle;
          for (int i = 0; i <= in_cycle; i++) expected += s->offset_for_ref_frame[i];
        }
        if (!sh.nal_ref_idc) expected += s->offset_for_non_ref_pic;
        top = expected + sh.delta_poc[0];
        bottom = top + s->offset_for_top_to_bottom_field + sh.delta_poc[1];
      } else {
        top = bottom = sh.idr() ? 0 : sh.nal_ref_idc ? 2 * (off + sh.frame_num)
                                                     : 2 * (off + sh.frame_num) - 1;
      }
    }
    cur->top_poc = top;
    cur->bottom_poc = bottom;
    cur->poc = std::min(top, bottom);
    info.assign((size_t)mbw * mbh, MbInfo());
    slices.clear();
    slice_num = -1;
    if (sh.idr()) stats[S_IDR]++;
  }
  // 4 * frame_num + 3: how FFmpeg names a frame in a picture's lists
  static int pic_key(const Picture& r) { return 4 * r.frame_num + 3; }
  // ref_pic_list_modification( ) of list l (8.2.4.3)
  void modify_list(int l) {
    std::vector<PicPtr>& L = list[l];
    int n = sh.num_ref_idx_active[l];
    int pred = sh.frame_num, mfn = max_frame_num(), idx = 0;
    for (const RefMod& m : sh.mods[l]) {
      if (m.idc == 3) break;
      if (idx >= n) fail("more reference list modifications than entries");
      PicPtr pic;
      if (m.idc < 2) {
        int d = m.val + 1;
        if (d > mfn) fail("abs_diff_pic_num_minus1 out of range");
        int nw = m.idc == 0 ? pred - d : pred + d;
        if (nw < 0) nw += mfn;
        else if (nw >= mfn) nw -= mfn;
        pred = nw;
        int num = nw > sh.frame_num ? nw - mfn : nw;
        for (const PicPtr& r : dpb)
          if (r->ref_short && frame_num_wrap(*r) == num) pic = r;
        if (!pic) fail("reference list modification names a missing short-term picture");
      } else {
        for (const PicPtr& r : dpb)
          if (r->ref_long && r->long_idx == m.val) pic = r;
        if (!pic) fail("reference list modification names a missing long-term picture");
      }
      L.insert(L.begin() + idx, pic);
      idx++;
      int k = idx;
      for (int c = idx; c < (int)L.size(); c++)
        if (L[c] != pic) L[k++] = L[c];
      L.resize(n);
    }
  }
  // per slice: the reference lists (8.2.4), weights, level scales, and for
  // B slices the direct mode's scale factors and map
  void start_slice() {
    slice_num++;
    slices.push_back({sh.disable_deblock, sh.alpha_div2, sh.beta_div2});
    if (slice_num == 0) cur->first_type = sh.type;
    cur->has_b |= sh.type == 1;
    cur->types |= 1 << sh.type;
    if (sh.disable_deblock != 1) stats[S_DEBLOCK]++;
    if (sh.disable_deblock == 2) stats[S_DEBLOCK2]++;
    bool flat = true;
    for (int l = 0; l < 6; l++)
      for (int k = 0; k < 16; k++) flat &= p->sl4[l][k] == 16;
    for (int l = 0; l < 2 * p->transform_8x8; l++)
      for (int k = 0; k < 64; k++) flat &= p->sl8[l][k] == 16;
    if (!flat) stats[S_SCALED]++;
    if (sh.ref_mod_flag[0] || (sh.type == 1 && sh.ref_mod_flag[1])) stats[S_REFMOD]++;
    level_scales();
    list[0].clear();
    list[1].clear();
    wt.on = 0;
    int nl = sh.lists();
    if (!nl) return;
    std::vector<PicPtr> st, lt;
    for (const PicPtr& r : dpb) {
      if (r->ref_short) st.push_back(r);
      if (r->ref_long) lt.push_back(r);
    }
    std::sort(lt.begin(), lt.end(), [](const PicPtr& a, const PicPtr& b) { return a->long_idx < b->long_idx; });
    if (sh.type == 0) {  // by descending PicNum (8.2.4.2.1)
      std::sort(st.begin(), st.end(), [&](const PicPtr& a, const PicPtr& b) {
        return frame_num_wrap(*a) > frame_num_wrap(*b);
      });
      list[0] = st;
    } else {  // by POC around the current picture's (8.2.4.2.3)
      int poc = cur->poc;
      for (size_t i = 0; i < st.size(); i++)
        for (size_t j = i + 1; j < st.size(); j++)
          if (st[i]->poc == st[j]->poc)  // after an MMCO 5; FFmpeg then keeps one of them
            unsupported("a B slice whose short-term references share POC " +
                        std::to_string(st[i]->poc) + " (after an MMCO 5)");
      std::vector<PicPtr> before, after;
      // (FFmpeg's add_sorted: a POC equal to the current one counts as before it)
      for (const PicPtr& r : st) (r->poc <= poc ? before : after).push_back(r);
      std::sort(before.begin(), before.end(), [](const PicPtr& a, const PicPtr& b) { return a->poc > b->poc; });
      std::sort(after.begin(), after.end(), [](const PicPtr& a, const PicPtr& b) { return a->poc < b->poc; });
      list[0] = before;
      list[0].insert(list[0].end(), after.begin(), after.end());
      list[1] = after;
      list[1].insert(list[1].end(), before.begin(), before.end());
      list[1].insert(list[1].end(), lt.begin(), lt.end());
    }
    list[0].insert(list[0].end(), lt.begin(), lt.end());
    if (sh.type == 1 && list[1].size() > 1 && list[1] == list[0]) std::swap(list[1][0], list[1][1]);
    for (int l = 0; l < nl; l++) {
      list[l].resize(sh.num_ref_idx_active[l]);
      if (sh.ref_mod_flag[l]) modify_list(l);
      for (const PicPtr& r : list[l])
        if (!r)  // FFmpeg substitutes a default picture and forgets its output order
          unsupported("num_ref_idx_l" + std::to_string(l) + "_active " +
                      std::to_string(sh.num_ref_idx_active[l]) + " beyond the " +
                      std::to_string(st.size() + lt.size()) + " reference frames held");
    }
    // the lists FFmpeg keeps with the picture for the temporal direct mode:
    // each slice's overwrite the last, but its frame threads (cv2 decodes
    // with one a core) copy the picture once its first slice has set up, and
    // the copy travels on: the first slice's lists, and none where it has none
    if (slice_num == 0)
    for (int l = 0; l < nl; l++) {
      cur->list_count[l] = sh.num_ref_idx_active[l];
      for (int i = 0; i < sh.num_ref_idx_active[l]; i++)
        cur->list_key[l][i] = list[l][i] ? pic_key(*list[l][i]) : -1;
    }
    if ((sh.type == 0 && p->weighted_pred) || (sh.type == 1 && p->weighted_bipred_idc == 1)) {
      stats[S_WEIGHTED]++;
      wt.lwd = sh.luma_log2_wd;
      wt.cwd = sh.chroma_log2_wd;
      // FFmpeg weights only when a weight or offset differs from the default,
      // and then both components whatever their own tables say
      bool luma = false, chroma = false;
      for (int l = 0; l < nl; l++)
        for (int i = 0; i < sh.num_ref_idx_active[l]; i++) {
          wt.lw[l][i] = sh.luma_w[l][i];
          wt.lo[l][i] = sh.luma_o[l][i];
          luma |= wt.lw[l][i] != 1 << wt.lwd || wt.lo[l][i];
          for (int c = 0; c < 2; c++) {
            wt.cw[l][i][c] = sh.chroma_w[l][i][c];
            wt.co[l][i][c] = sh.chroma_o[l][i][c];
            chroma |= wt.cw[l][i][c] != 1 << wt.cwd || wt.co[l][i][c];
          }
        }
      wt.on = luma || chroma ? 1 : 0;
    }
    if (sh.type != 1) return;
    stats[sh.direct_spatial ? S_SPATIAL : S_TEMPORAL]++;
    if (list[1][0]->ref_long) stats[S_LTCOL]++;
    int n0 = sh.num_ref_idx_active[0], n1 = sh.num_ref_idx_active[1];
    int cur_poc = cur->poc;
    if (p->weighted_bipred_idc == 2) {  // implicit weights (8.4.2.3.1), FFmpeg's implicit_weight_table
      wt.on = 2;
      stats[S_IMPLICIT]++;
      for (int i = 0; i < n0; i++)
        for (int j = 0; j < n1; j++) {
          int w = 32;
          const Picture &a = *list[0][i], &b = *list[1][j];
          if (!a.ref_long && !b.ref_long) {
            int td = clip3(-128, 127, b.poc - a.poc);
            if (td) {
              int tb = clip3(-128, 127, cur_poc - a.poc);
              int tx = (16384 + std::abs(td) / 2) / td;
              int dsf = (tb * tx + 32) >> 8;
              if (dsf >= -64 && dsf <= 128) w = 64 - dsf;
            }
          }
          wt.implicit[i][j] = w;
        }
    }
    if (sh.direct_spatial) return;
    // temporal direct: DistScaleFactor by refIdxL0 (FFmpeg's get_scale_factor)
    const Picture& colpic = *list[1][0];
    for (int i = 0; i < n0; i++) {
      const Picture& a = *list[0][i];
      int td = clip3(-128, 127, colpic.poc - a.poc);
      if (td == 0 || a.ref_long) {
        dist_scale[i] = 256;
      } else {
        int tb = clip3(-128, 127, cur_poc - a.poc);
        int tx = (16384 + std::abs(td) / 2) / td;
        dist_scale[i] = clip3(-1024, 1023, (tb * tx + 32) >> 6);
      }
    }
    // the co-located picture's reference indices to the lowest refIdxL0 of
    // the same frame, through the lists it kept (FFmpeg's fill_colmap; 0 when
    // the frame is not in list 0)
    for (int l = 0; l < 2; l++)
      for (int r = 0; r < 32; r++) {
        col_map[l][r] = 0;
        if (r >= colpic.list_count[l]) continue;
        for (int j = 0; j < n0; j++)
          if (pic_key(*list[0][j]) == colpic.list_key[l][r]) { col_map[l][r] = j; break; }
      }
  }
  // after the picture's last slice: the output choice FFmpeg makes as the
  // picture starts, deblocking, the co-located motion, reference marking
  // (8.2.5)
  void finish_picture() {
    for (const MbInfo& m : info)
      if (m.slice < 0) fail("picture not fully covered by its slices");
    if (cur->idr) last_pocs_reset();
    cur->key = cur->idr;
    select_output();
    deblock();
    cur->col.resize(info.size());
    for (size_t i = 0; i < info.size(); i++) {
      const MbInfo& m = info[i];
      ColMb& c = cur->col[i];
      c.intra = m.intra;
      memcpy(c.ref, m.ref, sizeof c.ref);
      memcpy(c.mv, m.mv, sizeof c.mv);
      c.shape = m.intra ? 0 : m.shape;
    }
    bool mmco5 = false, assigned = false;
    if (cur->types & (cur->types - 1)) stats[S_MIXED]++;
    if (sh.nal_ref_idc) {
      if (cur->has_b) stats[S_BREF]++;
      if (sh.idr()) {
        for (const PicPtr& r : dpb) r->ref_short = r->ref_long = false;
        if (sh.long_term_ref) {
          cur->ref_long = true;
          cur->long_idx = 0;
          max_long_idx = 0;
        } else {
          max_long_idx = -1;
        }
      } else if (sh.adaptive) {
        for (const Mmco& m : sh.mmcos) {
          // (an MMCO 2, 3 or 4 after an MMCO 6 that takes the current
          // picture's long-term index from it unmarks it, as in FFmpeg, and
          // it stays so)
          if (m.op == 0) break;
          stats[S_MMCO]++;
          int cur_num = sh.frame_num;
          if (m.op == 1 || m.op == 3) {
            int x = cur_num - (m.diff + 1);
            PicPtr pic;
            for (const PicPtr& r : dpb)
              if (r->ref_short && frame_num_wrap(*r) == x) pic = r;
            if (!pic) fail("MMCO names a missing short-term picture");
            if (m.op == 1) {
              pic->ref_short = false;
            } else {
              if (m.lt_idx > max_long_idx) fail("long_term_frame_idx above MaxLongTermFrameIdx");
              for (const PicPtr& r : dpb)
                if (r->ref_long && r->long_idx == m.lt_idx && r != pic) r->ref_long = false;
              if (cur->ref_long && cur->long_idx == m.lt_idx) cur->ref_long = false;
              pic->ref_short = false;
              pic->ref_long = true;
              pic->long_idx = m.lt_idx;
            }
          } else if (m.op == 2) {
            bool hit = false;
            for (const PicPtr& r : dpb)
              if (r->ref_long && r->long_idx == m.lt_pic_num) { r->ref_long = false; hit = true; }
            if (cur->ref_long && cur->long_idx == m.lt_pic_num) { cur->ref_long = false; hit = true; }
            if (!hit) fail("MMCO 2 names a missing long-term picture");
          } else if (m.op == 4) {
            max_long_idx = m.max_lt_plus1 - 1;
            for (const PicPtr& r : dpb)
              if (r->ref_long && r->long_idx > max_long_idx) r->ref_long = false;
            if (cur->ref_long && cur->long_idx > max_long_idx) cur->ref_long = false;
          } else if (m.op == 5) {
            for (const PicPtr& r : dpb) r->ref_short = r->ref_long = false;
            max_long_idx = -1;
            mmco5 = true;
          } else if (m.op == 6) {
            if (m.lt_idx > max_long_idx) fail("long_term_frame_idx above MaxLongTermFrameIdx");
            for (const PicPtr& r : dpb)
              if (r->ref_long && r->long_idx == m.lt_idx) r->ref_long = false;
            cur->ref_long = true;
            cur->long_idx = m.lt_idx;
            assigned = true;
          }
        }
      } else {  // the sliding window
        int ns = 0, nl = 0;
        for (const PicPtr& r : dpb) { ns += r->ref_short; nl += r->ref_long; }
        if (ns + nl >= std::max(s->max_num_ref_frames, 1) && ns > 0) {
          PicPtr oldest;
          for (const PicPtr& r : dpb)
            if (r->ref_short && (!oldest || frame_num_wrap(*r) < frame_num_wrap(*oldest))) oldest = r;
          oldest->ref_short = false;
        }
      }
      if (!cur->ref_long && !assigned) cur->ref_short = true;
      int nref = 0;
      for (const PicPtr& r : dpb) nref += r->is_ref();
      if (nref + 1 > std::max(s->max_num_ref_frames, 1)) fail("more reference frames than max_num_ref_frames");
    }
    std::vector<PicPtr> kept;
    for (const PicPtr& r : dpb)
      if (r->is_ref()) kept.push_back(r);
    dpb = kept;
    int nlong = 0;
    for (const PicPtr& r : dpb) nlong += r->ref_long;
    stats[S_LONGTERM] += nlong + cur->ref_long;
    if (mmco5) {  // tempPicOrderCnt for the next POCs; FFmpeg keeps its own POC (output, lists)
      int t = std::min(cur->top_poc, cur->bottom_poc);
      cur->top_poc -= t;
      cur->bottom_poc -= t;
      cur->mmco5 = true;
      cur->frame_num = 0;  // inferred after MMCO 5 (7.4.3)
      // FFmpeg marks this picture and the next one and forgets the POCs seen
      cur->mmco_reset = true;
      next_mmco_reset = true;
      last_pocs_reset();
    }
    if (sh.nal_ref_idc) {
      if (cur->is_ref()) dpb.push_back(cur);
      prev_ref_frame_num = mmco5 ? 0 : sh.frame_num;
      prev_ref_mmco5 = mmco5;
      prev_ref_top_after_mmco5 = cur->top_poc;
      prev_ref_msb = cur->poc_msb;
      prev_ref_lsb = cur->poc_lsb;
    }
    prev_mmco5 = mmco5;
    prev_frame_num = mmco5 ? 0 : sh.frame_num;
    prev_frame_num_offset = cur->frame_num_offset;
    cur.reset();
  }

  // ---------------------------------------------------------- output --
  // FFmpeg's h264_select_output_frame, which decides what cv2 sees: a
  // picture waits until more than has_b_frames wait, then the lowest POC
  // before the next IDR or MMCO 5 leaves; has_b_frames starts at the
  // container's video_delay, takes the VUI's max_num_reorder_frames, and
  // without the VUI grows with the pictures seen out of POC order; a picture
  // whose POC is below the last one output is dropped
  int has_b_frames = 0;
  int last_pocs[16];
  int next_outputed_poc = INT32_MIN;
  bool next_mmco_reset = false;
  std::vector<PicPtr> delayed;
  void last_pocs_reset() {
    for (int& v : last_pocs) v = INT32_MIN;
  }
  void select_output() {
    const int kMax = 16;
    cur->mmco_reset = next_mmco_reset;
    next_mmco_reset = false;
    if (s->restriction) has_b_frames = std::max(has_b_frames, s->num_reorder);
    int i = 0;
    for (;; i++) {
      if (i == kMax || cur->poc < last_pocs[i]) {
        if (i) last_pocs[i - 1] = cur->poc;
        break;
      } else if (i) {
        last_pocs[i - 1] = last_pocs[i];
      }
    }
    int out_of_order = kMax - i;
    if (cur->first_type == 1 ||
        (last_pocs[kMax - 2] > INT32_MIN && (int64_t)last_pocs[kMax - 1] - last_pocs[kMax - 2] > 2))
      out_of_order = std::max(out_of_order, 1);
    if (out_of_order == kMax) {
      last_pocs_reset();
      last_pocs[0] = cur->poc;
      cur->mmco_reset = true;
    } else if (has_b_frames < out_of_order && !s->restriction) {
      has_b_frames = out_of_order;
    }
    delayed.push_back(cur);
    size_t pics = delayed.size(), out_idx = 0;
    for (size_t k = 1; k < delayed.size() && !delayed[k]->key && !delayed[k]->mmco_reset; k++)
      if (delayed[k]->poc < delayed[out_idx]->poc) out_idx = k;
    PicPtr out = delayed[out_idx];
    if (has_b_frames == 0 && (delayed[0]->key || delayed[0]->mmco_reset)) next_outputed_poc = INT32_MIN;
    bool dropped = out->poc < next_outputed_poc;
    if (dropped || (int)pics > has_b_frames) delayed.erase(delayed.begin() + out_idx);
    if (dropped) {
      stats[S_DROPPED]++;
    } else if ((int)pics > has_b_frames) {
      ready.push_back(out);
      if (out_idx == 0 && !delayed.empty() && (delayed[0]->key || delayed[0]->mmco_reset))
        next_outputed_poc = INT32_MIN;
      else
        next_outputed_poc = out->poc;
    }
  }
  // the end of the stream: the rest in the same order, none dropped
  void flush_output() {
    while (!delayed.empty()) {
      size_t out_idx = 0;
      for (size_t k = 1; k < delayed.size() && !delayed[k]->key && !delayed[k]->mmco_reset; k++)
        if (delayed[k]->poc < delayed[out_idx]->poc) out_idx = k;
      ready.push_back(delayed[out_idx]);
      delayed.erase(delayed.begin() + out_idx);
    }
  }
};

}  // namespace
