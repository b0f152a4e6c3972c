// H.265 / HEVC (ITU-T Rec. H.265 | ISO/IEC 23008-2) syntax, reconstruction
// and picture management on the host, shared by the decoder (hevc.cpp) and
// the test-stream writer (hevc_writer.cpp).
//
// The syntax is written once: every syntax element goes through a call that
// reads it from the bitstream (decoder) or writes the value the writer's
// Chooser gives (writer) and returns the value either way, so both sides walk
// the same parse, keep the same neighbour state (CABAC ctxInc, merge and AMVP
// candidates, intra most probable modes, QP prediction) and reconstruct the
// same pictures. The writer's streams are held against FFmpeg's decoder
// (cv2), never only against this decoder.
//
// Scope: the Main profile's I and P slices, 8-bit 4:2:0: VPS/SPS/PPS with
// short-term reference picture sets (in the SPS and the slice header, with
// inter-RPS prediction), the conformance window and VUI colour; NAL unit types
// IDR_W_RADL, IDR_N_LP, CRA, TRAIL_N and TRAIL_R; several independent slice
// segments a picture; reference lists of any length with
// ref_pic_lists_modification; CTB sizes 16, 32 and 64 with the implicit
// splits of partial CTBs; CABAC with cabac_init_flag; cu_qp_delta, the chroma
// QP offsets of the PPS and the slice, cu_transquant_bypass; the 35 intra
// modes with reference substitution, filtering, strong intra smoothing,
// constrained_intra_pred and PCM; every inter part_mode (AMP included),
// merge (spatial, temporal, zero candidates, log2_parallel_merge_level),
// AMVP, TMVP through collocated_ref_idx, 8-tap luma and 4-tap chroma
// interpolation, explicit weighted prediction; transforms 4 to 32 with the
// DST of intra 4x4 luma, the residual quadtree, scaling lists (default, SPS,
// PPS, predicted), transform_skip and sign data hiding; the deblocking filter
// (its slice flags and offsets, loop_filter_across_slices) and SAO (band and
// edge offsets, merge left and up). Where FFmpeg (cv2) departs from the
// standard, its way is taken, as each place says: the pictures it outputs and
// when (ff_hevc_output_frames), the POC of a CRA that starts a stream, SAO at
// the edges of slices that do not filter across them. Everything else is
// refused by name (Error code 2): B slices, RASL/RADL leading pictures, BLA,
// TSA/STSA, WPP (entropy_coding_sync_enabled_flag), tiles, dependent slice
// segments, long-term reference pictures, profiles other than Main, bit
// depths above 8, chroma formats other than 4:2:0, the range/multilayer/3D/
// SCC extensions, a missing reference picture.

#pragma once

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <string>
#include <vector>

#include "bits.h"
#include "hevc_tables.h"
#include "mp4.h"

namespace {

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : v > hi ? hi : v; }
inline int ceil_log2(int v) {
  int n = 0;
  while ((1 << n) < v) n++;
  return n;
}

// ------------------------------------------------------------ scans ------
// ScanOrder[log2BlockSize][scanIdx][sPos] (6.5.3-6.5.5): up-right diagonal,
// horizontal, vertical, for blocks of 1x1 to 8x8; and the 32-point DCT matrix
struct Tables {
  uint8_t scan[4][3][64][2];
  int8_t dct[32][32];
  Tables() {
    for (int l = 0; l < 4; l++) {
      int n = 1 << l, i = 0, x = 0, y = 0;
      while (i < n * n) {
        while (y >= 0) {
          if (x < n && y < n) {
            scan[l][0][i][0] = (uint8_t)x;
            scan[l][0][i][1] = (uint8_t)y;
            i++;
          }
          y--;
          x++;
        }
        y = x;
        x = 0;
      }
      for (int k = 0; k < n * n; k++) {
        scan[l][1][k][0] = (uint8_t)(k % n);
        scan[l][1][k][1] = (uint8_t)(k / n);
        scan[l][2][k][0] = (uint8_t)(k / n);
        scan[l][2][k][1] = (uint8_t)(k % n);
      }
    }
    for (int k = 0; k < 32; k++)
      for (int n = 0; n < 32; n++) {
        if (k == 0) { dct[k][n] = 64; continue; }
        int m = ((2 * n + 1) * k) % 128, sign = 1;
        if (m > 64) m = 128 - m;
        if (m > 32) { m = 64 - m; sign = -1; }
        dct[k][n] = (int8_t)(sign * kDctCos[m]);
      }
  }
};
const Tables& tables() {
  static Tables t;
  return t;
}

// ---------------------------------------------------------- CABAC --
struct HCabac : CabacEngine<kHevcContexts> {
  // 9.3.2.2: initType by slice type and cabac_init_flag
  void init_contexts(int slice_type, int cabac_init, int qp) {
    int type = slice_type == 2 ? 0 : slice_type == 1 ? (cabac_init ? 2 : 1) : (cabac_init ? 1 : 2);
    for (int i = 0; i < kHevcContexts; i++) {
      int v = kHevcInit[type][i], m = (v >> 4) * 5 - 45, n = ((v & 15) << 3) - 16;
      int pre = clip3(1, 126, ((m * clip3(0, 51, qp)) >> 4) + n);
      state[i] = pre <= 63 ? (uint8_t)(63 - pre) : (uint8_t)((pre - 64) | 64);
    }
  }
};

// ------------------------------------------------- parameter sets --
// profile_tier_level( 1, maxNumSubLayersMinus1 ): the writer codes the Main
// profile; the decoder refuses other profiles by name
void profile_tier_level(Bits& b, int& profile_idc, int& level_idc, int max_sub_layers_minus1) {
  b.u(2, 0);  // general_profile_space
  b.u(1, 0);  // general_tier_flag
  profile_idc = (int)b.u(5, profile_idc);
  for (int j = 0; j < 32; j++) b.u(1, j == profile_idc || (profile_idc == 1 && j == 2));
  b.u(1, 1);   // general_progressive_source_flag
  b.u(1, 0);   // general_interlaced_source_flag
  b.u(1, 0);   // general_non_packed_constraint_flag
  b.u(1, 1);   // general_frame_only_constraint_flag
  b.u(32, 0);  // the 43 reserved bits and general_inbld_flag
  b.u(12, 0);
  level_idc = (int)b.u(8, level_idc);
  int prof[8] = {0}, lev[8] = {0};
  for (int i = 0; i < max_sub_layers_minus1; i++) {
    prof[i] = b.flag(0);
    lev[i] = b.flag(0);
  }
  if (max_sub_layers_minus1 > 0)
    for (int i = max_sub_layers_minus1; i < 8; i++) b.u(2, 0);
  for (int i = 0; i < max_sub_layers_minus1; i++) {
    if (prof[i]) { b.u(32, 0); b.u(32, 0); b.u(24, 0); }
    if (lev[i]) b.u(8, 0);
  }
}

// refusals: the writer may write the refused value (the decoder stops there)
void refuse(const Bits& b, const std::string& what) {
  if (!b.writing) unsupported(what);
}

void check_profile(const Bits& b, int profile_idc) {
  if (profile_idc == 1 || b.writing) return;
  if (profile_idc == 2) unsupported("profile Main 10 (general_profile_idc 2; the port decodes Main)");
  unsupported("general_profile_idc " + std::to_string(profile_idc) +
              " (profiles other than Main; the port decodes Main)");
}

struct VPS {
  bool valid = false;
  int id = 0, max_sub_layers_minus1 = 0, profile_idc = 1, level_idc = 93;
};

// video_parameter_set_rbsp( ) without the trailing bits; nothing of it
// changes the decoding of the base layer, but FFmpeg needs the one an SPS names
void vps_syntax(Bits& b, VPS& v) {
  v.id = (int)b.u(4, v.id);
  b.u(1, 1);  // vps_base_layer_internal_flag
  b.u(1, 1);  // vps_base_layer_available_flag
  b.u(6, 0);  // vps_max_layers_minus1
  v.max_sub_layers_minus1 = (int)b.u(3, v.max_sub_layers_minus1);
  b.u(1, 1);  // vps_temporal_id_nesting_flag
  b.u(16, 0xFFFF);
  profile_tier_level(b, v.profile_idc, v.level_idc, v.max_sub_layers_minus1);
  int ordering = b.flag(1);
  for (int i = ordering ? 0 : v.max_sub_layers_minus1; i <= v.max_sub_layers_minus1; i++) {
    b.ue(4);  // vps_max_dec_pic_buffering_minus1
    b.ue(0);  // vps_max_num_reorder_pics
    b.ue(0);  // vps_max_latency_increase_plus1
  }
  b.u(6, 0);  // vps_max_layer_id
  int sets = (int)b.ue(0);  // vps_num_layer_sets_minus1
  for (int i = 1; i <= sets; i++) b.u(1, 0);
  if (b.flag(0)) {  // vps_timing_info_present_flag
    b.u(32, 1);
    b.u(32, 30);
    if (b.flag(0)) b.ue(0);
    int hrd = (int)b.ue(0);
    if (hrd) unsupported("VPS HRD parameters");
  }
  b.flag(0);  // vps_extension_flag (the data that may follow is ignored)
  v.valid = true;
}

// A short-term reference picture set: the delta POCs of S0 (num_neg,
// decreasing) then S1 (num_pos, increasing), with used_by_curr_pic. The
// writer fills either the sets (explicit coding) or the inter-RPS syntax.
struct StRps {
  int num_neg = 0, num_pos = 0;
  int delta[32] = {0};
  uint8_t used[32] = {0};
  int inter = 0, delta_idx_minus1 = 0, delta_rps = 0;
  uint8_t used_by_curr[33] = {0}, use_delta[33] = {0};
  int num() const { return num_neg + num_pos; }
  bool same(const StRps& o) const {
    if (num_neg != o.num_neg || num_pos != o.num_pos) return false;
    for (int i = 0; i < num(); i++)
      if (delta[i] != o.delta[i] || used[i] != o.used[i]) return false;
    return true;
  }
};

// st_ref_pic_set( stRpsIdx ) (7.3.7) and the derivation of 7.4.8
void st_rps_syntax(Bits& b, StRps& r, int idx, const StRps* sets, int num_sets) {
  r.inter = idx != 0 ? b.flag(r.inter) : 0;
  if (r.inter) {
    r.delta_idx_minus1 = idx == num_sets ? (int)b.ue(r.delta_idx_minus1) : 0;
    if (r.delta_idx_minus1 + 1 > idx) fail("delta_idx_minus1 out of range");
    const StRps& ref = sets[idx - (r.delta_idx_minus1 + 1)];
    int sign = b.flag(r.delta_rps < 0);
    int abs_minus1 = (int)b.ue(std::abs(r.delta_rps) - 1);
    if (abs_minus1 > 32767) fail("abs_delta_rps_minus1 out of range");
    int d = (1 - 2 * sign) * (abs_minus1 + 1);
    r.delta_rps = d;
    int n0 = ref.num_neg, n1 = ref.num_pos, nd = ref.num();
    for (int j = 0; j <= nd; j++) {
      r.used_by_curr[j] = (uint8_t)b.flag(r.used_by_curr[j]);
      r.use_delta[j] = r.used_by_curr[j] ? 1 : (uint8_t)b.flag(r.use_delta[j]);
    }
    int i = 0, s0[33], s1[33];
    uint8_t u0[33], u1[33];
    for (int j = n1 - 1; j >= 0; j--) {
      int p = ref.delta[n0 + j] + d;
      if (p < 0 && r.use_delta[n0 + j]) { s0[i] = p; u0[i++] = r.used_by_curr[n0 + j]; }
    }
    if (d < 0 && r.use_delta[nd]) { s0[i] = d; u0[i++] = r.used_by_curr[nd]; }
    for (int j = 0; j < n0; j++) {
      int p = ref.delta[j] + d;
      if (p < 0 && r.use_delta[j]) { s0[i] = p; u0[i++] = r.used_by_curr[j]; }
    }
    int neg = i;
    i = 0;
    for (int j = n0 - 1; j >= 0; j--) {
      int p = ref.delta[j] + d;
      if (p > 0 && r.use_delta[j]) { s1[i] = p; u1[i++] = r.used_by_curr[j]; }
    }
    if (d > 0 && r.use_delta[nd]) { s1[i] = d; u1[i++] = r.used_by_curr[nd]; }
    for (int j = 0; j < n1; j++) {
      int p = ref.delta[n0 + j] + d;
      if (p > 0 && r.use_delta[n0 + j]) { s1[i] = p; u1[i++] = r.used_by_curr[n0 + j]; }
    }
    if (neg + i > 16) fail("short-term RPS of more than 16 pictures");
    r.num_neg = neg;
    r.num_pos = i;
    for (int k = 0; k < neg; k++) { r.delta[k] = s0[k]; r.used[k] = u0[k]; }
    for (int k = 0; k < i; k++) { r.delta[neg + k] = s1[k]; r.used[neg + k] = u1[k]; }
    return;
  }
  r.num_neg = (int)b.ue(r.num_neg);
  r.num_pos = (int)b.ue(r.num_pos);
  if (r.num_neg > 16 || r.num_pos > 16 || r.num() > 16) fail("short-term RPS of more than 16 pictures");
  int prev = 0;
  for (int k = 0; k < r.num_neg; k++) {
    int m1 = (int)b.ue(prev - r.delta[k] - 1);
    r.delta[k] = prev - (m1 + 1);
    prev = r.delta[k];
    r.used[k] = (uint8_t)b.flag(r.used[k]);
  }
  prev = 0;
  for (int k = r.num_neg; k < r.num(); k++) {
    int m1 = (int)b.ue(r.delta[k] - prev - 1);
    r.delta[k] = prev + m1 + 1;
    prev = r.delta[k];
    r.used[k] = (uint8_t)b.flag(r.used[k]);
  }
}

// Scaling lists as coded (up-right diagonal order) and their DC values, by
// sizeId and matrixId (sizeId 3: matrixId 0 and 3, as FFmpeg and version 2 of
// the standard number them); pred_mode/pred_delta carry the writer's choice
struct ScalingList {
  uint8_t list[4][6][64];
  int dc[4][6];
  uint8_t pred_mode[4][6], pred_delta[4][6];
  void set_default() {
    for (int s = 0; s < 4; s++)
      for (int m = 0; m < 6; m++) {
        dc[s][m] = 16;
        pred_mode[s][m] = 0;
        pred_delta[s][m] = 0;
        default_list(s, m, list[s][m]);
      }
  }
  static void default_list(int s, int m, uint8_t* out) {
    const Tables& t = tables();
    if (s == 0) { memset(out, 16, 16); return; }
    for (int i = 0; i < 64; i++)
      out[i] = kDefaultScaling8[m < 3 ? 0 : 1][t.scan[3][0][i][1] * 8 + t.scan[3][0][i][0]];
  }
};

// scaling_list_data( ) (7.3.4)
void scaling_list_syntax(Bits& b, ScalingList& sl) {
  for (int s = 0; s < 4; s++)
    for (int m = 0; m < 6; m += s == 3 ? 3 : 1) {
      int coded = b.flag(sl.pred_mode[s][m]);
      sl.pred_mode[s][m] = (uint8_t)coded;
      int n = std::min(64, 1 << (4 + (s << 1)));
      if (!coded) {
        int delta = (int)b.ue(sl.pred_delta[s][m]);
        int step = s == 3 ? 3 : 1;
        if (delta * step > m) fail("scaling_list_pred_matrix_id_delta out of range");
        sl.pred_delta[s][m] = (uint8_t)delta;
        if (!delta) {
          ScalingList::default_list(s, m, sl.list[s][m]);
          sl.dc[s][m] = 16;
        } else {
          int r = m - delta * step;
          memcpy(sl.list[s][m], sl.list[s][r], 64);
          sl.dc[s][m] = sl.dc[s][r];
        }
        continue;
      }
      int next = 8;
      if (s > 1) {
        int dc = b.se(sl.dc[s][m] - 8);
        if (dc < -7 || dc > 247) fail("scaling_list_dc_coef_minus8 out of range");
        sl.dc[s][m] = dc + 8;
        next = dc + 8;
      }
      for (int i = 0; i < n; i++) {
        int want = sl.list[s][m][i];
        int d = ((want - next + 128) & 255) - 128;
        d = b.se(d);
        if (d < -128 || d > 127) fail("scaling_list_delta_coef out of range");
        next = (next + d + 256) % 256;
        sl.list[s][m][i] = (uint8_t)next;
      }
    }
}

struct SPS {
  bool valid = false;
  int id = 0, vps_id = 0, max_sub_layers_minus1 = 0, profile_idc = 1, level_idc = 93;
  int chroma_format_idc = 1, width = 0, height = 0;
  int conf_win = 0, conf[4] = {0, 0, 0, 0};  // left, right, top, bottom (chroma samples)
  int bit_depth = 8, bit_depth_c = 8, log2_max_poc_lsb = 8;
  int ordering_info = 1;
  int max_dec_minus1[8] = {0}, max_reorder[8] = {0}, max_latency_plus1[8] = {0};
  int log2_min_cb = 3, log2_diff_cb = 1, log2_min_tb = 2, log2_diff_tb = 2;
  int max_th_inter = 1, max_th_intra = 1;
  int scaling_enabled = 0, scaling_present = 0;
  ScalingList sl;
  int amp = 0, sao = 0, pcm = 0, pcm_bd = 8, pcm_bd_c = 8, log2_min_pcm = 3, log2_diff_pcm = 0;
  int pcm_loop_filter_disabled = 0;
  int num_st_rps = 0;
  StRps st_rps[65];
  int long_term = 0, temporal_mvp = 0, strong_smoothing = 0;
  // VUI
  int vui = 0, aspect = 0, aspect_idc = 1, signal_type = 0, video_format = 5, full_range = 0;
  int colour_desc = 0, primaries = 2, transfer = 2, matrix = 2, chroma_loc = 0;
  int default_window = 0, timing = 0, hrd = 0, restriction = 0;
  int field_seq = 0, frame_field_info = 0;
  // derived
  int ctb_log2 = 4, ctb = 16, wctb = 0, hctb = 0, min_cb = 8, max_tb_log2 = 4;
};

// hrd_parameters( 1, maxNumSubLayersMinus1 ): the writer codes one CPB of
// fixed, plausible values for every sub-layer
void hrd_syntax(Bits& b, int max_sub_layers_minus1) {
  int nal = b.flag(1), vcl = b.flag(0), sub_pic = 0;
  if (nal || vcl) {
    sub_pic = b.flag(0);
    if (sub_pic) { b.u(8, 0); b.u(5, 0); b.u(1, 0); b.u(5, 0); }
    b.u(4, 0);  // bit_rate_scale
    b.u(4, 0);  // cpb_size_scale
    if (sub_pic) b.u(4, 0);
    b.u(5, 23);  // initial_cpb_removal_delay_length_minus1
    b.u(5, 23);  // au_cpb_removal_delay_length_minus1
    b.u(5, 23);  // dpb_output_delay_length_minus1
  }
  for (int i = 0; i <= max_sub_layers_minus1; i++) {
    int fixed_general = b.flag(1), fixed_within = 1, low_delay = 0, cpb_cnt = 0;
    if (!fixed_general) fixed_within = b.flag(1);
    if (fixed_within) b.ue(0);  // elemental_duration_in_tc_minus1
    else low_delay = b.flag(0);
    if (!low_delay) cpb_cnt = (int)b.ue(0);
    for (int k = 0; k < (nal ? 1 : 0) + (vcl ? 1 : 0); k++)
      for (int j = 0; j <= cpb_cnt; j++) {
        b.ue(2499);  // bit_rate_value_minus1
        b.ue(2499);  // cpb_size_value_minus1
        if (sub_pic) { b.ue(0); b.ue(0); }
        b.flag(0);   // cbr_flag
      }
  }
}

void vui_syntax(Bits& b, SPS& s) {
  s.aspect = b.flag(s.aspect);
  if (s.aspect) {
    s.aspect_idc = (int)b.u(8, s.aspect_idc);
    if (s.aspect_idc == 255) { b.u(16, 1); b.u(16, 1); }
  }
  if (b.flag(0)) b.flag(0);  // overscan_info_present_flag, overscan_appropriate_flag
  s.signal_type = b.flag(s.signal_type);
  if (s.signal_type) {
    s.video_format = (int)b.u(3, s.video_format);
    s.full_range = b.flag(s.full_range);
    s.colour_desc = b.flag(s.colour_desc);
    if (s.colour_desc) {
      s.primaries = (int)b.u(8, s.primaries);
      s.transfer = (int)b.u(8, s.transfer);
      s.matrix = (int)b.u(8, s.matrix);
    }
  }
  s.chroma_loc = b.flag(s.chroma_loc);
  if (s.chroma_loc) { b.ue(0); b.ue(0); }
  b.flag(0);  // neutral_chroma_indication_flag
  s.field_seq = b.flag(0);
  s.frame_field_info = b.flag(0);
  if (s.field_seq) unsupported("field_seq_flag (coded fields)");
  s.default_window = b.flag(s.default_window);
  if (s.default_window) for (int i = 0; i < 4; i++) b.ue(1);  // FFmpeg ignores it by default
  s.timing = b.flag(s.timing);
  if (s.timing) {
    b.u(32, 1001);
    b.u(32, 30000);
    if (b.flag(1)) b.ue(1);  // poc_proportional_to_timing_flag, num_ticks_poc_diff_one_minus1
    s.hrd = b.flag(s.hrd);
    if (s.hrd) hrd_syntax(b, s.max_sub_layers_minus1);
  }
  s.restriction = b.flag(s.restriction);
  if (s.restriction) {
    b.flag(0);  // tiles_fixed_structure_flag
    b.flag(1);  // motion_vectors_over_pic_boundaries_flag
    b.flag(0);  // restricted_ref_pic_lists_flag
    b.ue(0);    // min_spatial_segmentation_idc
    b.ue(2);    // max_bytes_per_pic_denom
    b.ue(1);    // max_bits_per_min_cu_denom
    b.ue(15);   // log2_max_mv_length_horizontal
    b.ue(15);   // log2_max_mv_length_vertical
  }
}

// the extension flags of an SPS or PPS: the four that carry syntax are refused
void extension_flags(Bits& b, const char* what) {
  if (!b.flag(0)) return;  // *_extension_present_flag
  const char* names[4] = {"range", "multilayer", "3D", "SCC"};
  for (int i = 0; i < 4; i++)
    if (b.flag(0)) unsupported(std::string(what) + " " + names[i] + " extension");
  b.u(4, 0);  // *_extension_4bits: the data that follows is ignored
}

// seq_parameter_set_rbsp( ) without the trailing bits; refuses what is out of scope
void sps_syntax(Bits& b, SPS& s, const VPS* vps_table) {
  s.vps_id = (int)b.u(4, s.vps_id);
  s.max_sub_layers_minus1 = (int)b.u(3, s.max_sub_layers_minus1);
  if (s.max_sub_layers_minus1 > 6) fail("sps_max_sub_layers_minus1 out of range");
  b.u(1, 1);  // sps_temporal_id_nesting_flag
  profile_tier_level(b, s.profile_idc, s.level_idc, s.max_sub_layers_minus1);
  check_profile(b, s.profile_idc);
  s.id = (int)b.ue(s.id);
  if (s.id > 15) fail("sps_seq_parameter_set_id out of range");
  if (!b.writing && !vps_table[s.vps_id].valid) fail("SPS names a missing VPS");
  s.chroma_format_idc = (int)b.ue(s.chroma_format_idc);
  if (s.chroma_format_idc != 1)
    refuse(b, "chroma_format_idc " + std::to_string(s.chroma_format_idc) +
                " (the port decodes 4:2:0)");
  s.width = (int)b.ue(s.width);
  s.height = (int)b.ue(s.height);
  s.conf_win = b.flag(s.conf_win);
  if (s.conf_win)
    for (int i = 0; i < 4; i++) s.conf[i] = (int)b.ue(s.conf[i]);
  else
    for (int i = 0; i < 4; i++) s.conf[i] = 0;
  s.bit_depth = (int)b.ue(s.bit_depth - 8) + 8;
  s.bit_depth_c = (int)b.ue(s.bit_depth_c - 8) + 8;
  if (s.bit_depth != 8 || s.bit_depth_c != 8)
    refuse(b, "bit depth " + std::to_string(std::max(s.bit_depth, s.bit_depth_c)) +
                " (the port decodes 8-bit video)");
  s.log2_max_poc_lsb = (int)b.ue(s.log2_max_poc_lsb - 4) + 4;
  if (s.log2_max_poc_lsb > 16) fail("log2_max_pic_order_cnt_lsb_minus4 out of range");
  s.ordering_info = b.flag(s.ordering_info);
  for (int i = s.ordering_info ? 0 : s.max_sub_layers_minus1; i <= s.max_sub_layers_minus1; i++) {
    s.max_dec_minus1[i] = (int)b.ue(s.max_dec_minus1[i]);
    s.max_reorder[i] = (int)b.ue(s.max_reorder[i]);
    s.max_latency_plus1[i] = (int)b.ue(s.max_latency_plus1[i]);
    if (s.max_dec_minus1[i] > 15) fail("sps_max_dec_pic_buffering_minus1 out of range");
  }
  if (!s.ordering_info)
    for (int i = 0; i < s.max_sub_layers_minus1; i++) {
      s.max_dec_minus1[i] = s.max_dec_minus1[s.max_sub_layers_minus1];
      s.max_reorder[i] = s.max_reorder[s.max_sub_layers_minus1];
      s.max_latency_plus1[i] = s.max_latency_plus1[s.max_sub_layers_minus1];
    }
  s.log2_min_cb = (int)b.ue(s.log2_min_cb - 3) + 3;
  s.log2_diff_cb = (int)b.ue(s.log2_diff_cb);
  s.log2_min_tb = (int)b.ue(s.log2_min_tb - 2) + 2;
  s.log2_diff_tb = (int)b.ue(s.log2_diff_tb);
  s.max_th_inter = (int)b.ue(s.max_th_inter);
  s.max_th_intra = (int)b.ue(s.max_th_intra);
  s.ctb_log2 = s.log2_min_cb + s.log2_diff_cb;
  s.max_tb_log2 = s.log2_min_tb + s.log2_diff_tb;
  if (s.ctb_log2 < 4 || s.ctb_log2 > 6) fail("CTB size out of range (16 to 64)");
  if (s.log2_min_tb >= s.log2_min_cb || s.max_tb_log2 > std::min(s.ctb_log2, 5))
    fail("transform block sizes out of range");
  s.scaling_enabled = b.flag(s.scaling_enabled);
  if (s.scaling_enabled) {
    s.scaling_present = b.flag(s.scaling_present);
    if (s.scaling_present) scaling_list_syntax(b, s.sl);
    else s.sl.set_default();
  }
  s.amp = b.flag(s.amp);
  s.sao = b.flag(s.sao);
  s.pcm = b.flag(s.pcm);
  if (s.pcm) {
    s.pcm_bd = (int)b.u(4, s.pcm_bd - 1) + 1;
    s.pcm_bd_c = (int)b.u(4, s.pcm_bd_c - 1) + 1;
    s.log2_min_pcm = (int)b.ue(s.log2_min_pcm - 3) + 3;
    s.log2_diff_pcm = (int)b.ue(s.log2_diff_pcm);
    s.pcm_loop_filter_disabled = b.flag(s.pcm_loop_filter_disabled);
    if (s.pcm_bd > 8 || s.pcm_bd_c > 8 ||
        s.log2_min_pcm + s.log2_diff_pcm > std::min(s.ctb_log2, 5))
      fail("PCM parameters out of range");
  }
  s.num_st_rps = (int)b.ue(s.num_st_rps);
  if (s.num_st_rps > 64) fail("num_short_term_ref_pic_sets out of range");
  for (int i = 0; i < s.num_st_rps; i++) st_rps_syntax(b, s.st_rps[i], i, s.st_rps, s.num_st_rps);
  s.long_term = b.flag(s.long_term);
  if (s.long_term) refuse(b, "long-term reference pictures (long_term_ref_pics_present_flag)");
  s.temporal_mvp = b.flag(s.temporal_mvp);
  s.strong_smoothing = b.flag(s.strong_smoothing);
  s.vui = b.flag(s.vui);
  if (s.vui) vui_syntax(b, s);
  extension_flags(b, "SPS");
  s.ctb = 1 << s.ctb_log2;
  s.min_cb = 1 << s.log2_min_cb;
  if (!s.width || !s.height || s.width % s.min_cb || s.height % s.min_cb)
    fail("picture size is no multiple of the minimum coding block");
  if (s.width > 8192 || s.height > 8192) unsupported("pictures larger than 8192 samples");
  s.wctb = (s.width + s.ctb - 1) >> s.ctb_log2;
  s.hctb = (s.height + s.ctb - 1) >> s.ctb_log2;
  if (2 * (s.conf[0] + s.conf[1]) >= s.width || 2 * (s.conf[2] + s.conf[3]) >= s.height)
    fail("conformance window out of the picture");
  s.valid = true;
}

struct PPS {
  bool valid = false;
  int id = 0, sps_id = 0, dependent_slices = 0, output_flag_present = 0, extra_bits = 0;
  int sign_hiding = 0, cabac_init_present = 0, num_ref_default[2] = {1, 1}, init_qp = 26;
  int constrained_intra = 0, transform_skip = 0, cu_qp_delta = 0, diff_cu_qp_delta_depth = 0;
  int cb_qp_offset = 0, cr_qp_offset = 0, slice_chroma_offsets = 0, weighted_pred = 0;
  int weighted_bipred = 0, transquant_bypass = 0, tiles = 0, wpp = 0, lf_across_slices = 0;
  int deblock_control = 0, deblock_override = 0, deblock_disabled = 0, beta_div2 = 0, tc_div2 = 0;
  int scaling_present = 0;
  ScalingList sl;
  int lists_modification = 0, log2_par_mrg = 2, header_extension = 0;
};

// pic_parameter_set_rbsp( ) without the trailing bits
void pps_syntax(Bits& b, PPS& p, const SPS* sps_table) {
  p.id = (int)b.ue(p.id);
  if (p.id > 63) fail("pps_pic_parameter_set_id out of range");
  p.sps_id = (int)b.ue(p.sps_id);
  if (p.sps_id > 15 || !sps_table[p.sps_id].valid) fail("PPS names a missing SPS");
  const SPS& s = sps_table[p.sps_id];
  p.dependent_slices = b.flag(p.dependent_slices);
  p.output_flag_present = b.flag(p.output_flag_present);
  p.extra_bits = (int)b.u(3, p.extra_bits);
  p.sign_hiding = b.flag(p.sign_hiding);
  p.cabac_init_present = b.flag(p.cabac_init_present);
  for (int l = 0; l < 2; l++) {
    p.num_ref_default[l] = (int)b.ue(p.num_ref_default[l] - 1) + 1;
    if (p.num_ref_default[l] > 15) fail("num_ref_idx_default_active_minus1 out of range");
  }
  p.init_qp = b.se(p.init_qp - 26) + 26;
  p.constrained_intra = b.flag(p.constrained_intra);
  // FFmpeg checks constrained intra prediction's neighbours by minimum
  // prediction blocks, which are larger than 4x4 here: not reproduced
  if (p.constrained_intra && s.log2_min_cb > 3)
    refuse(b, "constrained_intra_pred_flag with coding blocks of at least 16x16");
  p.transform_skip = b.flag(p.transform_skip);
  p.cu_qp_delta = b.flag(p.cu_qp_delta);
  p.diff_cu_qp_delta_depth = p.cu_qp_delta ? (int)b.ue(p.diff_cu_qp_delta_depth) : 0;
  if (p.diff_cu_qp_delta_depth > s.log2_diff_cb) fail("diff_cu_qp_delta_depth out of range");
  p.cb_qp_offset = b.se(p.cb_qp_offset);
  p.cr_qp_offset = b.se(p.cr_qp_offset);
  if (p.cb_qp_offset < -12 || p.cb_qp_offset > 12 || p.cr_qp_offset < -12 || p.cr_qp_offset > 12)
    fail("pps chroma QP offset out of range");
  p.slice_chroma_offsets = b.flag(p.slice_chroma_offsets);
  p.weighted_pred = b.flag(p.weighted_pred);
  p.weighted_bipred = b.flag(p.weighted_bipred);
  p.transquant_bypass = b.flag(p.transquant_bypass);
  p.tiles = b.flag(p.tiles);
  p.wpp = b.flag(p.wpp);
  if (p.tiles) refuse(b, "tiles (tiles_enabled_flag)");
  if (p.wpp) refuse(b, "entropy_coding_sync_enabled_flag (WPP)");
  p.lf_across_slices = b.flag(p.lf_across_slices);
  p.deblock_control = b.flag(p.deblock_control);
  if (p.deblock_control) {
    p.deblock_override = b.flag(p.deblock_override);
    p.deblock_disabled = b.flag(p.deblock_disabled);
    if (!p.deblock_disabled) {
      p.beta_div2 = b.se(p.beta_div2);
      p.tc_div2 = b.se(p.tc_div2);
    } else {
      p.beta_div2 = p.tc_div2 = 0;
    }
  } else {
    p.deblock_override = p.deblock_disabled = p.beta_div2 = p.tc_div2 = 0;
  }
  p.scaling_present = b.flag(p.scaling_present);
  if (p.scaling_present) scaling_list_syntax(b, p.sl);
  p.lists_modification = b.flag(p.lists_modification);
  p.log2_par_mrg = (int)b.ue(p.log2_par_mrg - 2) + 2;
  if (p.log2_par_mrg > s.ctb_log2) fail("log2_parallel_merge_level out of range");
  p.header_extension = b.flag(p.header_extension);
  extension_flags(b, "PPS");
  p.valid = true;
}

// ------------------------------------------------------- slice header --
enum NalType {
  TRAIL_N = 0, TRAIL_R = 1, TSA_N = 2, STSA_R = 5, RADL_N = 6, RASL_R = 9, BLA_W_LP = 16,
  BLA_N_LP = 18, IDR_W_RADL = 19, IDR_N_LP = 20, CRA = 21, VPS_NUT = 32, SPS_NUT = 33,
  PPS_NUT = 34, EOS_NUT = 36
};
enum SliceType { SLICE_B = 0, SLICE_P = 1, SLICE_I = 2 };

struct SliceHeader {
  int nal_type = IDR_W_RADL, temporal_id = 0;
  int first = 1, no_output_prior = 0, pps_id = 0, dependent = 0, address = 0;
  int type = SLICE_I, pic_output = 1, poc_lsb = 0;
  int rps_sps = 0, rps_idx = 0;
  StRps rps_own;
  int tmvp = 0, sao_luma = 0, sao_chroma = 0;
  int num_ref_override = 0, num_ref[2] = {0, 0};
  int mod_flag[2] = {0, 0}, list_entry[2][16] = {{0}};
  int cabac_init = 0, col_from_l0 = 1, col_ref_idx = 0;
  // pred_weight_table( ): the syntax (the writer's) and the weights
  int luma_denom = 0, chroma_denom = 0;
  int lw_flag[16] = {0}, cw_flag[16] = {0}, dlw[16] = {0}, lo[16] = {0}, dcw[16][2] = {{0}},
      dco[16][2] = {{0}};
  int luma_w[16], luma_o[16], chroma_w[16][2], chroma_o[16][2];
  int max_merge = 5;
  int qp_delta = 0, cb_offset = 0, cr_offset = 0;
  int deblock_override = 0, deblock_disabled = 0, beta_div2 = 0, tc_div2 = 0;
  int lf_across = 0;
  // derived
  int qp = 26;
  const StRps* rps = nullptr;
  int num_pic_total_curr = 0;
};

bool is_irap(int t) { return t >= 16 && t <= 23; }
bool is_idr(int t) { return t == IDR_W_RADL || t == IDR_N_LP; }

// pred_weight_table( ) of a P slice (7.3.6.3)
void weight_table_syntax(Bits& b, SliceHeader& h) {
  h.luma_denom = (int)b.ue(h.luma_denom);
  if (h.luma_denom > 7) fail("luma_log2_weight_denom out of range");
  int dc = b.se(h.chroma_denom - h.luma_denom);
  h.chroma_denom = h.luma_denom + dc;
  if (h.chroma_denom < 0 || h.chroma_denom > 7) fail("delta_chroma_log2_weight_denom out of range");
  int n = h.num_ref[0];
  for (int i = 0; i < n; i++) h.lw_flag[i] = b.flag(h.lw_flag[i]);
  for (int i = 0; i < n; i++) h.cw_flag[i] = b.flag(h.cw_flag[i]);
  for (int i = 0; i < n; i++) {
    h.luma_w[i] = 1 << h.luma_denom;
    h.luma_o[i] = 0;
    if (h.lw_flag[i]) {
      h.dlw[i] = b.se(h.dlw[i]);
      h.lo[i] = b.se(h.lo[i]);
      if (h.dlw[i] < -128 || h.dlw[i] > 127 || h.lo[i] < -128 || h.lo[i] > 127)
        fail("luma weight or offset out of range");
      h.luma_w[i] += h.dlw[i];
      h.luma_o[i] = h.lo[i];
    }
    for (int j = 0; j < 2; j++) {
      h.chroma_w[i][j] = 1 << h.chroma_denom;
      h.chroma_o[i][j] = 0;
      if (h.cw_flag[i]) {
        h.dcw[i][j] = b.se(h.dcw[i][j]);
        h.dco[i][j] = b.se(h.dco[i][j]);
        if (h.dcw[i][j] < -128 || h.dcw[i][j] > 127 || h.dco[i][j] < -512 || h.dco[i][j] > 511)
          fail("chroma weight or offset out of range");
        h.chroma_w[i][j] += h.dcw[i][j];
        h.chroma_o[i][j] =
            clip3(-128, 127, (128 + h.dco[i][j]) - ((128 * h.chroma_w[i][j]) >> h.chroma_denom));
      }
    }
  }
}

// slice_segment_header( ) (7.3.6.1) up to and including byte_alignment( );
// refuses what is out of scope as soon as it shows
void slice_header_syntax(Bits& b, SliceHeader& h, const SPS* sps_table, const PPS* pps_table,
                         const SPS*& sp, const PPS*& pp) {
  h.first = b.flag(h.first);
  if (is_irap(h.nal_type)) h.no_output_prior = b.flag(h.no_output_prior);
  h.pps_id = (int)b.ue(h.pps_id);
  if (h.pps_id > 63 || !pps_table[h.pps_id].valid) fail("slice names a missing PPS");
  const PPS& p = pps_table[h.pps_id];
  const SPS& s = sps_table[p.sps_id];
  if (!s.valid) fail("PPS names a missing SPS");
  sp = &s;
  pp = &p;
  if (!h.first) {
    h.dependent = p.dependent_slices ? b.flag(h.dependent) : 0;
    if (h.dependent) refuse(b, "dependent slice segments (dependent_slice_segment_flag)");
    h.address = (int)b.u(ceil_log2(s.wctb * s.hctb), h.address);
    if (h.address >= s.wctb * s.hctb) fail("slice_segment_address out of range");
  } else {
    h.address = 0;
    h.dependent = 0;
  }
  for (int i = 0; i < p.extra_bits; i++) b.flag(0);
  h.type = (int)b.ue(h.type);
  if (h.type > 2) fail("slice_type out of range");
  if (h.type == SLICE_B) refuse(b, "B slices");
  h.pic_output = p.output_flag_present ? b.flag(h.pic_output) : 1;
  h.rps = nullptr;
  h.num_pic_total_curr = 0;
  if (!is_idr(h.nal_type)) {
    h.poc_lsb = (int)b.u(s.log2_max_poc_lsb, h.poc_lsb);
    h.rps_sps = b.flag(h.rps_sps);
    if (!h.rps_sps) {
      st_rps_syntax(b, h.rps_own, s.num_st_rps, s.st_rps, s.num_st_rps);
      h.rps = &h.rps_own;
    } else {
      if (!s.num_st_rps) fail("short_term_ref_pic_set_sps_flag without sets in the SPS");
      h.rps_idx = s.num_st_rps > 1 ? (int)b.u(ceil_log2(s.num_st_rps), h.rps_idx) : 0;
      if (h.rps_idx >= s.num_st_rps) fail("short_term_ref_pic_set_idx out of range");
      h.rps = &s.st_rps[h.rps_idx];
    }
    for (int i = 0; i < h.rps->num(); i++) h.num_pic_total_curr += h.rps->used[i];
    h.tmvp = s.temporal_mvp ? b.flag(h.tmvp) : 0;
  } else {
    h.poc_lsb = 0;
    h.tmvp = 0;
  }
  if (s.sao) {
    h.sao_luma = b.flag(h.sao_luma);
    h.sao_chroma = b.flag(h.sao_chroma);
  } else {
    h.sao_luma = h.sao_chroma = 0;
  }
  if (h.type == SLICE_P) {
    if (!h.num_pic_total_curr) fail("P slice without reference pictures in its RPS");
    h.num_ref_override = b.flag(h.num_ref_override);
    h.num_ref[0] = h.num_ref_override ? (int)b.ue(h.num_ref[0] - 1) + 1 : p.num_ref_default[0];
    if (h.num_ref[0] > 15) fail("num_ref_idx_l0_active_minus1 out of range");
    h.mod_flag[0] = h.mod_flag[0] && p.lists_modification && h.num_pic_total_curr > 1;
    if (p.lists_modification && h.num_pic_total_curr > 1) {
      h.mod_flag[0] = b.flag(h.mod_flag[0]);
      if (h.mod_flag[0])
        for (int i = 0; i < h.num_ref[0]; i++) {
          h.list_entry[0][i] = (int)b.u(ceil_log2(h.num_pic_total_curr), h.list_entry[0][i]);
          if (h.list_entry[0][i] >= h.num_pic_total_curr) fail("list_entry_l0 out of range");
        }
    }
    h.cabac_init = p.cabac_init_present ? b.flag(h.cabac_init) : 0;
    h.col_from_l0 = 1;
    if (h.tmvp && h.num_ref[0] > 1) {
      h.col_ref_idx = (int)b.ue(h.col_ref_idx);
      if (h.col_ref_idx >= h.num_ref[0]) fail("collocated_ref_idx out of range");
    } else {
      h.col_ref_idx = 0;
    }
    if (p.weighted_pred) weight_table_syntax(b, h);
    h.max_merge = 5 - (int)b.ue(5 - h.max_merge);
    if (h.max_merge < 1 || h.max_merge > 5) fail("five_minus_max_num_merge_cand out of range");
  } else {
    h.cabac_init = 0;
    h.num_ref[0] = h.num_ref[1] = 0;
    h.mod_flag[0] = h.mod_flag[1] = 0;
  }
  h.qp_delta = b.se(h.qp_delta);
  h.qp = p.init_qp + h.qp_delta;
  if (h.qp < 0 || h.qp > 51) fail("SliceQpY out of range");
  if (p.slice_chroma_offsets) {
    h.cb_offset = b.se(h.cb_offset);
    h.cr_offset = b.se(h.cr_offset);
    if (h.cb_offset < -12 || h.cb_offset > 12 || h.cr_offset < -12 || h.cr_offset > 12 ||
        p.cb_qp_offset + h.cb_offset < -12 || p.cb_qp_offset + h.cb_offset > 12 ||
        p.cr_qp_offset + h.cr_offset < -12 || p.cr_qp_offset + h.cr_offset > 12)
      fail("slice chroma QP offset out of range");
  } else {
    h.cb_offset = h.cr_offset = 0;
  }
  h.deblock_override = p.deblock_override ? b.flag(h.deblock_override) : 0;
  if (h.deblock_override) {
    h.deblock_disabled = b.flag(h.deblock_disabled);
    if (!h.deblock_disabled) {
      h.beta_div2 = b.se(h.beta_div2);
      h.tc_div2 = b.se(h.tc_div2);
      if (h.beta_div2 < -6 || h.beta_div2 > 6 || h.tc_div2 < -6 || h.tc_div2 > 6)
        fail("slice deblocking offsets out of range");
    } else {
      h.beta_div2 = h.tc_div2 = 0;
    }
  } else {
    h.deblock_disabled = p.deblock_disabled;
    h.beta_div2 = p.beta_div2;
    h.tc_div2 = p.tc_div2;
  }
  if (p.lf_across_slices && (h.sao_luma || h.sao_chroma || !h.deblock_disabled))
    h.lf_across = b.flag(h.lf_across);
  else
    h.lf_across = p.lf_across_slices;
  if (p.header_extension) {
    int n = (int)b.ue(0);
    for (int i = 0; i < n; i++) b.u(8, 0);
  }
  // byte_alignment( )
  b.u(1, 1);
  while (!b.aligned()) b.u(1, 0);
}

// ------------------------------------------------------------ pictures --
// What a decoded picture keeps of each 4x4 block for motion prediction
// (neighbours, and TMVP of the pictures that take it as collocated)
struct PbMotion {
  int16_t mv[2][2];
  int32_t ref_poc[2];
  int8_t ref_idx[2];
  uint8_t pred;  // bit 0: list 0, bit 1: list 1; 0: intra (or not coded)
};

struct Picture {
  int w = 0, h = 0, w4 = 0, h4 = 0;
  std::vector<uint8_t> y, cb, cr;
  std::vector<PbMotion> mv;
  int poc = 0, id = 0;
  bool output = false, ref = false;
  void alloc(int width, int height) {
    w = width;
    h = height;
    w4 = (w + 3) / 4;
    h4 = (h + 3) / 4;
    y.assign((size_t)w * h, 0);
    cb.assign((size_t)(w / 2) * (h / 2), 128);
    cr.assign((size_t)(w / 2) * (h / 2), 128);
    mv.assign((size_t)w4 * h4, PbMotion{});
  }
  uint8_t* plane(int c) { return c == 0 ? y.data() : c == 1 ? cb.data() : cr.data(); }
  const uint8_t* plane(int c) const { return c == 0 ? y.data() : c == 1 ? cb.data() : cr.data(); }
  int stride(int c) const { return c ? w / 2 : w; }
};
using PicPtr = std::shared_ptr<Picture>;

// part_mode values (Table 7-10)
enum PartMode { P2Nx2N = 0, P2NxN, PNx2N, PNxN, P2NxnU, P2NxnD, PnLx2N, PnRx2N };

struct Motion {
  uint8_t pred = 0;
  int16_t mv[2][2] = {{0, 0}, {0, 0}};
  int8_t ref[2] = {-1, -1};
};

struct SaoParams {
  int type[3] = {0, 0, 0};      // 0 none, 1 band, 2 edge
  int offset[3][4] = {{0}};     // SaoOffsetVal[1..4]
  int band[3] = {0, 0, 0};      // sao_band_position
  int eo[3] = {0, 0, 0};        // sao_eo_class
};

// the decoder's stream counters (io/video.py's HEVC_STAT_NAMES, in order)
enum Stat {
  S_IDR, S_CRA, S_TRAIL_N, S_ISLICE, S_PSLICE, S_MULTI_SLICE, S_CTB16, S_CTB32, S_CTB64,
  S_PARTIAL_CTB, S_INTRA_CU, S_INTRA_NXN, S_PCM, S_BYPASS, S_SKIP, S_MERGE, S_AMVP, S_AMP,
  S_INTER_NXN, S_SMALL_PU, S_TMVP_SLICE, S_TMVP_CAND, S_WEIGHTED, S_TSKIP, S_SDH, S_DST,
  S_TB32, S_SCALING, S_QP_DELTA, S_CHROMA_OFFSET, S_STRONG, S_CONSTRAINED, S_DEBLOCKED,
  S_DEBLOCK_OFF, S_LF_NOT_ACROSS, S_SAO_BAND, S_SAO_EDGE, S_SAO_MERGE, S_REFMOD, S_INTER_RPS,
  S_SPS_RPS, S_HIDDEN, S_DISCARDED, S_CABAC_INIT, S_REPEATED_REF, kStatCount
};

// Per-slice values the loop filters read after the picture is decoded
struct SliceInfo {
  int addr = 0, deblock_disabled = 0, beta = 0, tc = 0, lf_across = 0, sao_luma = 0,
      sao_chroma = 0;
};

// cu flags of a 4x4 block
enum { F_INTRA = 1, F_SKIP = 2, F_NOFILTER = 4, F_PCM = 8 };

// What the writer decides; the decoder never calls it. Each call comes when
// the syntax needs the value, with what the decoder would know by then.
struct Hevc;
struct CuChoice {
  int bypass = 0, skip = 0, intra = 1, part = P2Nx2N, pcm = 0, rqt_root_cbf = 1;
};
struct PuChoice {
  int merge = 1, merge_idx = 0, ref_idx = 0, mvp = 0;
  int mvd[2] = {0, 0};
};
struct Chooser {
  virtual ~Chooser() {}
  virtual void sao(int rx, int ry, bool left_ok, bool up_ok, int& merge_left, int& merge_up,
                   SaoParams& p) = 0;
  virtual int split_cu(int x0, int y0, int log2) = 0;
  virtual void cu(int x0, int y0, int log2, CuChoice& c) = 0;
  virtual void pcm_samples(int x0, int y0, int log2, uint8_t* samples) = 0;
  virtual int intra_mode(int x, int y, int log2) = 0;
  virtual int chroma_mode(int x0, int y0, int luma_mode) = 0;
  // merge: the merge candidates (max_merge of them); amvp(ref, flag) gives a predictor
  virtual void pu(int x, int y, int w, int h, int part_idx, const Motion* merge_cands,
                  PuChoice& c) = 0;
  virtual int split_tf(int x0, int y0, int log2, int depth) = 0;
  virtual int cbf(int c, int x0, int y0, int log2, int depth) = 0;
  virtual int qp_delta(int x0, int y0) = 0;
  virtual int transform_skip(int c, int x0, int y0, int log2) = 0;
  // the coefficient levels of a transform block (n x n, raster), at least one non-zero
  virtual void coeffs(int c, int x0, int y0, int log2, int16_t* levels) = 0;
  virtual int end_of_slice(int ctb_addr) = 0;
};

// The decoding process of one stream: parameter sets, the picture being
// decoded (or written), its block state, the DPB and the POC state. The
// writer drives the same object with Bits.writing set and a Chooser.
struct Hevc {
  Bits bits;
  HCabac cabac;
  VPS vps[16];
  SPS sps[16];
  PPS pps[64];
  const SPS* s = nullptr;
  const PPS* p = nullptr;
  SliceHeader sh;
  Chooser* ch = nullptr;
  int64_t stats[kStatCount] = {0};

  PicPtr cur;
  std::vector<PicPtr> dpb;    // pictures held: references and pictures waiting for output
  std::vector<PicPtr> ready;  // output order
  std::vector<PicPtr> list0;  // RefPicList0 of the slice
  int list_poc[2][16];
  int poc = 0, poc_tid0 = 0, next_id = 1;
  bool started = false;
  int slices_in_pic = 0;
  int last_beta = 0, last_tc = 0;  // the deblocking offsets of the last slice header

  // the picture's block state, by 4x4 block (w4 x h4) or CTB
  int w4 = 0, h4 = 0;
  std::vector<uint8_t> cuflags, qpy, ctdepth, ipm, cbf4;
  std::vector<uint32_t> zs;        // z-scan order of each 4x4 block
  std::vector<int> ctb_addr_slice;  // SliceAddrRs of each decoded CTB, -1 before
  std::vector<int> ctb_slice;       // index into slices
  std::vector<SliceInfo> slices;
  std::vector<SaoParams> sao;

  // slice and coding unit state
  int ctb_addr = 0;
  int qp_y = 26, qp_prev = 26, last_cu_qp = 26, qp_cb = 26, qp_cr = 26;
  bool qp_delta_coded = false;
  int qp_delta_val = 0, qg_x = 0, qg_y = 0;
  bool cu_intra = false, cu_bypass = false;
  int cu_part = P2Nx2N, cu_chroma_mode = 0;
  int cu_x = 0, cu_y = 0, cu_log2 = 3;
  bool merge0 = false;

  Hevc() { cabac.b = &bits; }
  bool W() const { return bits.writing; }

  // ------------------------------------------------------- block maps --
  int at4(int x, int y) const { return (y >> 2) * w4 + (x >> 2); }
  bool intra_at(int x, int y) const { return cuflags[at4(x, y)] & F_INTRA; }

  // 6.4.1: the block at (xN, yN) is decoded, in this slice, before (xC, yC)
  bool avail(int xC, int yC, int xN, int yN) const {
    if (xN < 0 || yN < 0 || xN >= s->width || yN >= s->height) return false;
    int ctb = (yN >> s->ctb_log2) * s->wctb + (xN >> s->ctb_log2);
    if (ctb_addr_slice[ctb] != sh.address) return false;
    return zs[at4(xN, yN)] <= zs[at4(xC, yC)];
  }

  void setup_picture_maps() {
    w4 = (s->width + 3) / 4;
    h4 = (s->height + 3) / 4;
    size_t n = (size_t)w4 * h4;
    cuflags.assign(n, 0);
    qpy.assign(n, 0);
    ctdepth.assign(n, 0);
    ipm.assign(n, 1);
    cbf4.assign(n, 0);
    bsv.assign(n, 0);
    bsh.assign(n, 0);
    zs.assign(n, 0);
    int l = s->ctb_log2 - 2;
    for (int y = 0; y < h4; y++)
      for (int x = 0; x < w4; x++) {
        int ctb = (y >> l) * s->wctb + (x >> l);
        uint32_t v = 0;
        for (int i = 0; i < l; i++) {
          int m = 1 << i;
          v += (x & m ? m * m : 0) + (y & m ? 2 * m * m : 0);
        }
        zs[y * w4 + x] = ((uint32_t)ctb << (2 * l)) + v;
      }
    ctb_addr_slice.assign((size_t)s->wctb * s->hctb, -1);
    ctb_slice.assign((size_t)s->wctb * s->hctb, 0);
    sao.assign((size_t)s->wctb * s->hctb, SaoParams{});
    slices.clear();
  }

  template <class F>
  void fill4(int x0, int y0, int w, int h, F f) {
    for (int y = y0 >> 2; y < (y0 + h) >> 2; y++)
      for (int x = x0 >> 2; x < (x0 + w) >> 2; x++) f(y * w4 + x);
  }

  // ------------------------------------------------------ POC and DPB --
  // 8.3.1 with FFmpeg's rule for a CRA: its POC MSB comes from the previous
  // TemporalId 0 picture as for any other picture (ff_hevc_compute_poc); only
  // IDR and BLA pictures start from 0. The first picture of a stream has
  // prevTid0Pic at POC 0.
  int compute_poc() const {
    if (is_idr(sh.nal_type)) return 0;
    int max = 1 << s->log2_max_poc_lsb;
    int prev_lsb = poc_tid0 & (max - 1), prev_msb = poc_tid0 - prev_lsb, msb;
    if (sh.poc_lsb < prev_lsb && prev_lsb - sh.poc_lsb >= max / 2) msb = prev_msb + max;
    else if (sh.poc_lsb > prev_lsb && sh.poc_lsb - prev_lsb > max / 2) msb = prev_msb - max;
    else msb = prev_msb;
    return msb + sh.poc_lsb;
  }

  // FFmpeg's ff_hevc_output_frames: while more pictures wait for output
  // than max_output, or some wait and the DPB holds more than max_dpb
  // (counting the current picture), the one with the smallest POC leaves
  // (or is discarded). sps_max_latency_increase_plus1 plays no part in it.
  void output_frames(int max_output, int max_dpb, bool discard) {
    for (;;) {
      int nb_output = 0, nb_dpb = 0;
      PicPtr best;
      for (const PicPtr& f : dpb) {
        if (f->output) {
          nb_output++;
          if (!best || f->poc < best->poc) best = f;
        }
        if (f->output || f->ref) nb_dpb++;
      }
      if (nb_output > max_output || (nb_output && nb_dpb > max_dpb)) {
        best->output = false;
        if (discard) stats[S_DISCARDED]++;
        else ready.push_back(best);
        prune();
        continue;
      }
      return;
    }
  }
  void prune() {
    dpb.erase(std::remove_if(dpb.begin(), dpb.end(),
                             [&](const PicPtr& f) { return !f->output && !f->ref && f != cur; }),
              dpb.end());
  }
  void flush_output() { output_frames(0, 0, false); }

  // the first slice of a picture: POC, RPS (8.3.2), a new picture in the DPB
  // and FFmpeg's output of the pictures before it
  void start_picture() {
    int t = sh.nal_type;
    if (!started && !is_irap(t)) fail("the stream does not start with an IRAP picture");
    started = true;
    poc = compute_poc();
    // prevTid0Pic: TemporalId 0, neither a leading nor a sub-layer non-reference picture
    bool slnr = t <= 14 && !(t & 1), leading = t >= RADL_N && t <= RASL_R;
    if (sh.temporal_id == 0 && !slnr && !leading) poc_tid0 = poc;
    if (is_idr(t)) stats[S_IDR]++;
    if (t == CRA) stats[S_CRA]++;
    if (t == TRAIL_N) stats[S_TRAIL_N]++;
    // NoRaslOutputFlag: an IDR (BLA and a CRA after an end of sequence are
    // refused; a CRA that starts the stream finds the DPB empty)
    if (is_idr(t)) {
      if (sh.no_output_prior) output_frames(0, 0, true);
      else flush_output();
      for (PicPtr& f : dpb) f->ref = false;
      prune();
    }
    for (const PicPtr& f : dpb)
      if (f->poc == poc) fail("two pictures with POC " + std::to_string(poc));
    cur = std::make_shared<Picture>();
    cur->alloc(s->width, s->height);
    cur->poc = poc;
    cur->id = next_id++;
    cur->output = sh.pic_output != 0;
    cur->ref = true;
    if (!cur->output) stats[S_HIDDEN]++;
    // 8.3.2: the pictures of the RPS stay references, the others do not
    const StRps* r = sh.rps;
    std::vector<PicPtr> keep;
    if (r)
      for (int i = 0; i < r->num(); i++) {
        int want = poc + r->delta[i];
        PicPtr f;
        for (const PicPtr& g : dpb)
          if (g->ref && g->poc == want) f = g;
        if (!f)
          unsupported("a missing reference picture (POC " + std::to_string(want) +
                      " of the RPS of POC " + std::to_string(poc) + ")");
        keep.push_back(f);
      }
    for (PicPtr& f : dpb) f->ref = std::find(keep.begin(), keep.end(), f) != keep.end();
    dpb.push_back(cur);
    prune();
    int top = s->max_sub_layers_minus1;
    output_frames(s->max_reorder[top], s->max_dec_minus1[top] + 1, false);
    setup_picture_maps();
    slices_in_pic = 0;
    // FFmpeg decodes pictures in frame threads, each parsing slice headers
    // into its own context: the first slice of a picture finds the offsets
    // of the last header its thread parsed (none yet: 0), not of the slice
    // before it in the stream
    last_beta = last_tc = 0;
    if (s->ctb_log2 == 4) stats[S_CTB16]++;
    if (s->ctb_log2 == 5) stats[S_CTB32]++;
    if (s->ctb_log2 == 6) stats[S_CTB64]++;
  }

  // RefPicList0 (8.3.4): StCurrBefore then StCurrAfter, repeated to the
  // list's length, then the modification
  void build_lists() {
    list0.clear();
    if (sh.type != SLICE_P) return;
    const StRps* r = sh.rps;
    std::vector<PicPtr> temp, curr;
    for (int pass = 0; pass < 2; pass++)
      for (int i = pass ? r->num_neg : 0; i < (pass ? r->num() : r->num_neg); i++)
        if (r->used[i]) {
          int want = poc + r->delta[i];
          for (const PicPtr& g : dpb)
            if (g->poc == want && g != cur) curr.push_back(g);
        }
    if ((int)curr.size() != sh.num_pic_total_curr)
      unsupported("a missing reference picture (the RPS of a slice of POC " + std::to_string(poc) + ")");
    int n = std::max(sh.num_ref[0], (int)curr.size());
    while ((int)temp.size() < n)
      for (const PicPtr& g : curr)
        if ((int)temp.size() < n) temp.push_back(g);
    for (int i = 0; i < sh.num_ref[0]; i++) {
      list0.push_back(sh.mod_flag[0] ? temp[sh.list_entry[0][i]] : temp[i]);
      list_poc[0][i] = list0[i]->poc;
    }
    if (sh.num_ref[0] > (int)curr.size()) stats[S_REPEATED_REF]++;
    if (sh.mod_flag[0]) stats[S_REFMOD]++;
  }

  // the slice header in effect (its RPS points into itself when coded there)
  void set_slice(const SliceHeader& h, const SPS* sp, const PPS* pp) {
    sh = h;
    if (sh.rps && !sh.rps_sps) sh.rps = &sh.rps_own;
    s = sp;
    p = pp;
  }

  void start_slice() {
    slices_in_pic++;
    if (slices_in_pic == 2) stats[S_MULTI_SLICE]++;
    stats[sh.type == SLICE_I ? S_ISLICE : S_PSLICE]++;
    if (sh.rps && sh.rps->inter) stats[S_INTER_RPS]++;
    if (sh.rps_sps && sh.rps) stats[S_SPS_RPS]++;
    if (sh.tmvp && sh.type == SLICE_P) stats[S_TMVP_SLICE]++;
    if (sh.type == SLICE_P && p->weighted_pred) stats[S_WEIGHTED]++;
    if (s->scaling_enabled) stats[S_SCALING]++;
    if (p->cb_qp_offset || p->cr_qp_offset || sh.cb_offset || sh.cr_offset)
      stats[S_CHROMA_OFFSET]++;
    if (p->constrained_intra) stats[S_CONSTRAINED]++;
    stats[sh.deblock_disabled ? S_DEBLOCK_OFF : S_DEBLOCKED]++;
    if (!sh.lf_across && sh.address) stats[S_LF_NOT_ACROSS]++;
    if (sh.cabac_init) stats[S_CABAC_INIT]++;
    build_lists();
    SliceInfo si;
    si.addr = sh.address;
    si.deblock_disabled = sh.deblock_disabled;
    // FFmpeg leaves the offsets of the header before when this one disables the filter
    bool kept = sh.deblock_override && sh.deblock_disabled;
    si.beta = kept ? last_beta : sh.beta_div2 * 2;
    si.tc = kept ? last_tc : sh.tc_div2 * 2;
    last_beta = si.beta;
    last_tc = si.tc;
    si.lf_across = sh.lf_across;
    si.sao_luma = sh.sao_luma;
    si.sao_chroma = sh.sao_chroma;
    slices.push_back(si);
    if (!sh.first && ctb_addr_slice[sh.address] != -1) fail("slices overlap");
  }

  // --------------------------------------------------------- slice data --
  void slice_data() {
    cabac.init_contexts(sh.type, sh.cabac_init, sh.qp);
    cabac.start();
    ctb_addr = sh.address;
    last_cu_qp = sh.qp;
    qp_y = sh.qp;
    qp_delta_val = 0;
    qp_delta_coded = false;
    int n = s->wctb * s->hctb;
    for (;;) {
      int rx = ctb_addr % s->wctb, ry = ctb_addr / s->wctb;
      ctb_addr_slice[ctb_addr] = sh.address;
      ctb_slice[ctb_addr] = (int)slices.size() - 1;
      int x0 = rx << s->ctb_log2, y0 = ry << s->ctb_log2;
      if (x0 + s->ctb > s->width || y0 + s->ctb > s->height) stats[S_PARTIAL_CTB]++;
      if (sh.sao_luma || sh.sao_chroma) sao_syntax(rx, ry);
      coding_quadtree(x0, y0, s->ctb_log2, 0);
      int end = cabac.terminate(W() ? (ctb_addr + 1 >= n || ch->end_of_slice(ctb_addr)) : 0);
      ctb_addr++;
      if (end) break;
      if (ctb_addr >= n) fail("slice runs past the end of the picture");
      if (ctb_addr_slice[ctb_addr] != -1) fail("slices overlap");
    }
    if (W())
      while (!bits.aligned()) bits.u(1, 0);
  }

  // -------------------------------------------------------------- SAO --
  int tr_bypass(int cmax, int v) {
    int k = 0;
    while (k < cmax && cabac.bypass(W() && v > k)) k++;
    return k;
  }
  int fl_bypass(int nbits, int v) {
    int r = 0;
    for (int i = nbits - 1; i >= 0; i--) r |= cabac.bypass((v >> i) & 1) << i;
    return r;
  }
  void sao_syntax(int rx, int ry) {
    int addr = ry * s->wctb + rx;
    SaoParams want;
    int ml = 0, mu = 0;
    bool left_ok = rx > 0 && ctb_addr_slice[addr - 1] == sh.address;
    bool up_ok = ry > 0 && ctb_addr_slice[addr - s->wctb] == sh.address;
    if (W()) ch->sao(rx, ry, left_ok, up_ok, ml, mu, want);
    if (left_ok) ml = cabac.bin(C_SAO_MERGE, ml);
    else ml = 0;
    if (!ml && up_ok) mu = cabac.bin(C_SAO_MERGE, mu);
    else mu = 0;
    SaoParams& P = sao[addr];
    if (ml || mu) {
      P = sao[ml ? addr - 1 : addr - s->wctb];
      stats[S_SAO_MERGE]++;
      return;
    }
    P = SaoParams{};
    for (int c = 0; c < 3; c++) {
      if (!(c == 0 ? sh.sao_luma : sh.sao_chroma)) continue;
      if (c < 2) {
        int t = cabac.bin(C_SAO_TYPE, want.type[c] != 0);
        if (t) t = 1 + cabac.bypass(want.type[c] == 2);
        P.type[c] = t;
      } else {
        P.type[2] = P.type[1];
      }
      if (!P.type[c]) continue;
      int absv[4];
      for (int i = 0; i < 4; i++) absv[i] = tr_bypass(7, std::abs(want.offset[c][i]));
      if (P.type[c] == 1) {
        stats[S_SAO_BAND]++;
        for (int i = 0; i < 4; i++) {
          int sign = absv[i] ? cabac.bypass(want.offset[c][i] < 0) : 0;
          P.offset[c][i] = sign ? -absv[i] : absv[i];
        }
        P.band[c] = fl_bypass(5, want.band[c]);
      } else {
        stats[S_SAO_EDGE]++;
        for (int i = 0; i < 4; i++) P.offset[c][i] = i < 2 ? absv[i] : -absv[i];
        P.eo[c] = c == 2 ? P.eo[1] : fl_bypass(2, want.eo[c]);
      }
    }
  }

  // ------------------------------------------------------ coding tree --
  void coding_quadtree(int x0, int y0, int log2, int depth) {
    int n = 1 << log2, split;
    if (x0 + n <= s->width && y0 + n <= s->height && log2 > s->log2_min_cb) {
      int inc = (avail(x0, y0, x0 - 1, y0) && ctdepth[at4(x0 - 1, y0)] > depth) +
                (avail(x0, y0, x0, y0 - 1) && ctdepth[at4(x0, y0 - 1)] > depth);
      split = cabac.bin(C_SPLIT_CU + inc, W() ? ch->split_cu(x0, y0, log2) : 0);
    } else {
      split = log2 > s->log2_min_cb;
    }
    if (p->cu_qp_delta && log2 >= s->ctb_log2 - p->diff_cu_qp_delta_depth) {
      qp_delta_coded = false;
      qp_delta_val = 0;
    }
    // a new quantization group: qPY_PREV is the QpY of the last coding unit before it
    if (log2 >= s->ctb_log2 - p->diff_cu_qp_delta_depth) {
      qg_x = x0;
      qg_y = y0;
      qp_prev = last_cu_qp;
    }
    if (split) {
      int h = n >> 1;
      for (int k = 0; k < 4; k++) {
        int x = x0 + (k & 1) * h, y = y0 + (k >> 1) * h;
        if (x < s->width && y < s->height) coding_quadtree(x, y, log2 - 1, depth + 1);
      }
    } else {
      coding_unit(x0, y0, log2, depth);
    }
  }

  // 8.6.1: QpY of a coding unit from its quantization group's prediction and CuQpDeltaVal
  void derive_qp(int x0, int y0) {
    int ctb = s->ctb_log2;
    int qa = qp_prev, qb = qp_prev;
    if (((qg_x - 1) >> ctb) == (qg_x >> ctb) && qg_x > 0 && avail(x0, y0, qg_x - 1, qg_y))
      qa = qpy[at4(qg_x - 1, qg_y)];
    if (((qg_y - 1) >> ctb) == (qg_y >> ctb) && qg_y > 0 && avail(x0, y0, qg_x, qg_y - 1))
      qb = qpy[at4(qg_x, qg_y - 1)];
    int pred = (qa + qb + 1) >> 1;
    qp_y = ((pred + qp_delta_val + 52) % 52);
    qp_cb = chroma_qp(qp_y + p->cb_qp_offset + sh.cb_offset);
    qp_cr = chroma_qp(qp_y + p->cr_qp_offset + sh.cr_offset);
  }
  static int chroma_qp(int qpi) {
    qpi = clip3(0, 57, qpi);
    return qpi < 30 ? qpi : qpi > 43 ? qpi - 6 : kQpC[qpi - 30];
  }

  int part_mode_syntax(bool intra, int log2, int v) {
    if (cabac.bin(C_PART_MODE, v == P2Nx2N)) return P2Nx2N;
    if (intra) return PNxN;
    if (log2 == s->log2_min_cb) {
      if (cabac.bin(C_PART_MODE + 1, v == P2NxN)) return P2NxN;
      if (log2 == 3) return PNx2N;
      if (cabac.bin(C_PART_MODE + 2, v == PNx2N)) return PNx2N;
      return PNxN;
    }
    if (!s->amp) return cabac.bin(C_PART_MODE + 1, v == P2NxN) ? P2NxN : PNx2N;
    // AMP: the third bin takes context 3 (FFmpeg and the corrected Table 9-41)
    if (cabac.bin(C_PART_MODE + 1, v == P2NxN || v == P2NxnU || v == P2NxnD)) {
      if (cabac.bin(C_PART_MODE + 3, v == P2NxN)) return P2NxN;
      return cabac.bypass(v == P2NxnD) ? P2NxnD : P2NxnU;
    }
    if (cabac.bin(C_PART_MODE + 3, v == PNx2N)) return PNx2N;
    return cabac.bypass(v == PnRx2N) ? PnRx2N : PnLx2N;
  }

  void coding_unit(int x0, int y0, int log2, int depth) {
    int n = 1 << log2;
    CuChoice c;
    cu_x = x0;
    cu_y = y0;
    cu_log2 = log2;
    cu_part = P2Nx2N;
    derive_qp(x0, y0);
    if (W()) ch->cu(x0, y0, log2, c);
    cu_bypass = p->transquant_bypass ? cabac.bin(C_TQ_BYPASS, c.bypass) : 0;
    int skip = 0;
    if (sh.type != SLICE_I) {
      int inc = (avail(x0, y0, x0 - 1, y0) && (cuflags[at4(x0 - 1, y0)] & F_SKIP)) +
                (avail(x0, y0, x0, y0 - 1) && (cuflags[at4(x0, y0 - 1)] & F_SKIP));
      skip = cabac.bin(C_SKIP + inc, c.skip);
    }
    cu_intra = sh.type == SLICE_I;
    cu_part = P2Nx2N;
    int pcm = 0;
    bool tree = false;  // a transform tree was coded (its leaves set the bS)
    merge0 = false;
    if (!skip && sh.type != SLICE_I) cu_intra = cabac.bin(C_PRED_MODE, c.intra);
    uint8_t f = (cu_intra ? F_INTRA : 0) | (skip ? F_SKIP : 0) | (cu_bypass ? F_NOFILTER : 0);
    fill4(x0, y0, n, n, [&](int i) {
      cuflags[i] = f;
      ctdepth[i] = (uint8_t)depth;
      ipm[i] = 1;  // INTRA_DC for the MPM derivation of inter coding units
      cbf4[i] = 0;
    });
    if (cu_bypass) stats[S_BYPASS]++;
    if (skip) {
      stats[S_SKIP]++;
      prediction_unit(x0, y0, n, n, 0, true);
    } else {
      if (!cu_intra || log2 == s->log2_min_cb) cu_part = part_mode_syntax(cu_intra, log2, c.part);
      if (cu_intra) {
        stats[S_INTRA_CU]++;
        if (cu_part == PNxN) stats[S_INTRA_NXN]++;
        if (cu_part == P2Nx2N && s->pcm && log2 >= s->log2_min_pcm &&
            log2 <= s->log2_min_pcm + s->log2_diff_pcm)
          pcm = cabac.terminate(c.pcm);
        if (pcm) pcm_sample(x0, y0, log2);
        else intra_modes(x0, y0, log2);
      } else {
        if (cu_part >= P2NxnU) stats[S_AMP]++;
        if (cu_part == PNxN) stats[S_INTER_NXN]++;
        int h = n / 2, q = n / 4;
        switch (cu_part) {
          case P2Nx2N: prediction_unit(x0, y0, n, n, 0, false); break;
          case P2NxN:
            prediction_unit(x0, y0, n, h, 0, false);
            prediction_unit(x0, y0 + h, n, h, 1, false);
            break;
          case PNx2N:
            prediction_unit(x0, y0, h, n, 0, false);
            prediction_unit(x0 + h, y0, h, n, 1, false);
            break;
          case P2NxnU:
            prediction_unit(x0, y0, n, q, 0, false);
            prediction_unit(x0, y0 + q, n, n - q, 1, false);
            break;
          case P2NxnD:
            prediction_unit(x0, y0, n, n - q, 0, false);
            prediction_unit(x0, y0 + n - q, n, q, 1, false);
            break;
          case PnLx2N:
            prediction_unit(x0, y0, q, n, 0, false);
            prediction_unit(x0 + q, y0, n - q, n, 1, false);
            break;
          case PnRx2N:
            prediction_unit(x0, y0, n - q, n, 0, false);
            prediction_unit(x0 + n - q, y0, q, n, 1, false);
            break;
          default:
            prediction_unit(x0, y0, h, h, 0, false);
            prediction_unit(x0 + h, y0, h, h, 1, false);
            prediction_unit(x0, y0 + h, h, h, 2, false);
            prediction_unit(x0 + h, y0 + h, h, h, 3, false);
        }
      }
      if (!pcm) {
        int rqt = 1;
        if (!cu_intra && !(cu_part == P2Nx2N && merge0)) rqt = cabac.bin(C_RQT_ROOT_CBF, c.rqt_root_cbf);
        tree = rqt;
        if (rqt) {
          int max_depth = cu_intra ? s->max_th_intra + (cu_part == PNxN) : s->max_th_inter;
          transform_tree(x0, y0, x0, y0, log2, 0, 0, max_depth, 0, 0);
        }
      }
    }
    if (pcm && s->pcm_loop_filter_disabled) fill4(x0, y0, n, n, [&](int i) { cuflags[i] |= F_NOFILTER; });
    if (pcm) fill4(x0, y0, n, n, [&](int i) { cuflags[i] |= F_PCM; });
    fill4(x0, y0, n, n, [&](int i) { qpy[i] = (uint8_t)qp_y; });
    if (!tree && !sh.deblock_disabled) bs_block(x0, y0, log2);
    last_cu_qp = qp_y;
  }

  // -------------------------------------------------------------- PCM --
  void pcm_sample(int x0, int y0, int log2) {
    stats[S_PCM]++;
    int n = 1 << log2, nc = n / 2;
    std::vector<uint8_t> smp(n * n + 2 * nc * nc);
    if (W()) ch->pcm_samples(x0, y0, log2, smp.data());
    while (!bits.aligned()) bits.u(1, 0);  // pcm_alignment_zero_bit
    for (int i = 0; i < n * n; i++) smp[i] = (uint8_t)bits.u(s->pcm_bd, smp[i]);
    for (int i = n * n; i < (int)smp.size(); i++) smp[i] = (uint8_t)bits.u(s->pcm_bd_c, smp[i]);
    cabac.start();
    for (int y = 0; y < n; y++)
      for (int x = 0; x < n; x++)
        cur->y[(size_t)(y0 + y) * cur->w + x0 + x] = (uint8_t)(smp[y * n + x] << (8 - s->pcm_bd));
    for (int c = 1; c < 3; c++)
      for (int y = 0; y < nc; y++)
        for (int x = 0; x < nc; x++)
          cur->plane(c)[(size_t)(y0 / 2 + y) * (cur->w / 2) + x0 / 2 + x] =
              (uint8_t)(smp[n * n + (c - 1) * nc * nc + y * nc + x] << (8 - s->pcm_bd_c));
  }

  // ------------------------------------------------------------ intra --
  // 8.4.2: candModeList from the left and above neighbours
  void mpm_list(int x, int y, int* cand) {
    int a = 1, b = 1;
    if (avail(x, y, x - 1, y) && intra_at(x - 1, y) && !(cuflags[at4(x - 1, y)] & F_PCM))
      a = ipm[at4(x - 1, y)];
    if (avail(x, y, x, y - 1) && intra_at(x, y - 1) && !(cuflags[at4(x, y - 1)] & F_PCM) &&
        ((y - 1) >> s->ctb_log2) == (y >> s->ctb_log2))
      b = ipm[at4(x, y - 1)];
    if (a == b) {
      if (a < 2) { cand[0] = 0; cand[1] = 1; cand[2] = 26; }
      else { cand[0] = a; cand[1] = 2 + ((a + 29) % 32); cand[2] = 2 + ((a - 2 + 1) % 32); }
    } else {
      cand[0] = a;
      cand[1] = b;
      cand[2] = a != 0 && b != 0 ? 0 : a != 1 && b != 1 ? 1 : 26;
    }
  }

  void intra_modes(int x0, int y0, int log2) {
    int np = cu_part == PNxN ? 4 : 1, pb = cu_part == PNxN ? (1 << log2) / 2 : 1 << log2;
    int prev[4], idx[4], modes[4];
    if (W()) {  // the modes in order, each with the MPMs its neighbours give
      for (int k = 0; k < np; k++) {
        int x = x0 + (k & 1) * pb, y = y0 + (k >> 1) * pb, cand[3];
        mpm_list(x, y, cand);
        int m = ch->intra_mode(x, y, log2 - (np == 4));
        modes[k] = m;
        prev[k] = m == cand[0] || m == cand[1] || m == cand[2];
        if (prev[k]) idx[k] = m == cand[0] ? 0 : m == cand[1] ? 1 : 2;
        else {
          std::sort(cand, cand + 3);
          int r = m;
          for (int i = 2; i >= 0; i--)
            if (m > cand[i]) r--;
          idx[k] = r;
        }
        fill4(x, y, pb, pb, [&](int i) { ipm[i] = (uint8_t)m; });
      }
    }
    for (int k = 0; k < np; k++) prev[k] = cabac.bin(C_PREV_INTRA, prev[k]);
    for (int k = 0; k < np; k++)
      idx[k] = prev[k] ? tr_bypass(2, idx[k]) : fl_bypass(5, idx[k]);
    for (int k = 0; k < np; k++) {
      int x = x0 + (k & 1) * pb, y = y0 + (k >> 1) * pb, cand[3];
      mpm_list(x, y, cand);
      int m;
      if (prev[k]) m = cand[idx[k]];
      else {
        std::sort(cand, cand + 3);
        m = idx[k];
        for (int i = 0; i < 3; i++)
          if (m >= cand[i]) m++;
      }
      fill4(x, y, pb, pb, [&](int i) { ipm[i] = (uint8_t)m; });
      modes[k] = m;
    }
    int v = W() ? ch->chroma_mode(x0, y0, modes[0]) : 0;
    int cm = cabac.bin(C_CHROMA_MODE, v != 4) ? fl_bypass(2, v) : 4;
    if (cm == 4) cu_chroma_mode = modes[0];
    else {
      const int table[4] = {0, 26, 10, 1};
      cu_chroma_mode = table[cm] == modes[0] ? 34 : table[cm];
    }
  }

  // 8.4.4.2: intra sample prediction of an n x n block of component c at (x0, y0)
  void intra_pred(int c, int x0, int y0, int log2, int mode) {
    int n = 1 << log2, sh2 = c ? 1 : 0;
    int xl = x0 << sh2, yl = y0 << sh2, unit = 4 >> sh2;
    int stride = cur->stride(c);
    uint8_t* pl = cur->plane(c);
    // arr: p[-1][2n-1] .. p[-1][-1], p[0][-1] .. p[2n-1][-1]
    int arr[129];
    bool ok[129];
    bool any = false;
    auto usable = [&](int xs, int ys) {  // a sample of component c
      int xn = xs * (1 << sh2), yn = ys * (1 << sh2);
      if (!avail(xl, yl, xn, yn)) return false;
      return !p->constrained_intra || intra_at(xn, yn);
    };
    for (int k = 0; k < 2 * n; k += unit) {
      int ys = y0 + 2 * n - unit - k;  // from the bottom
      bool a = usable(x0 - 1, ys);
      for (int j = 0; j < unit; j++) {
        int idx = k + j;
        int yy = y0 + 2 * n - 1 - idx;
        ok[idx] = a;
        if (a) arr[idx] = pl[(size_t)yy * stride + x0 - 1];
      }
      any |= a;
    }
    ok[2 * n] = usable(x0 - 1, y0 - 1);
    if (ok[2 * n]) arr[2 * n] = pl[(size_t)(y0 - 1) * stride + x0 - 1];
    any |= ok[2 * n];
    for (int k = 0; k < 2 * n; k += unit) {
      bool a = usable(x0 + k, y0 - 1);
      for (int j = 0; j < unit; j++) {
        ok[2 * n + 1 + k + j] = a;
        if (a) arr[2 * n + 1 + k + j] = pl[(size_t)(y0 - 1) * stride + x0 + k + j];
      }
      any |= a;
    }
    int total = 4 * n + 1;
    if (!any) {
      for (int i = 0; i < total; i++) arr[i] = 128;
    } else {
      if (!ok[0]) {
        int i = 1;
        while (!ok[i]) i++;
        arr[0] = arr[i];
      }
      for (int i = 1; i < total; i++)
        if (!ok[i]) arr[i] = arr[i - 1];
    }
    // left[y + 1] = p[-1][y], top[x + 1] = p[x][-1], left[0] = top[0] = p[-1][-1]
    int left[129], top[129];
    for (int y = 0; y < 2 * n; y++) left[y + 1] = arr[2 * n - 1 - y];
    for (int x = 0; x < 2 * n; x++) top[x + 1] = arr[2 * n + 1 + x];
    left[0] = top[0] = arr[2 * n];
    // 8.4.4.2.3: filtering of the neighbouring samples (luma)
    if (c == 0 && mode != 1 && n != 4) {
      int dist = std::min(std::abs(mode - 26), std::abs(mode - 10));
      int thres = n == 8 ? 7 : n == 16 ? 1 : 0;
      if (dist > thres) {
        int fl[129], ft[129];
        int thr = 1 << (8 - 5);
        if (s->strong_smoothing && n == 32 &&
            std::abs(top[0] + top[2 * n] - 2 * top[n]) < thr &&
            std::abs(left[0] + left[2 * n] - 2 * left[n]) < thr) {
          stats[S_STRONG]++;
          fl[0] = ft[0] = top[0];
          for (int i = 0; i < 63; i++) {
            fl[i + 1] = ((63 - i) * left[0] + (i + 1) * left[64] + 32) >> 6;
            ft[i + 1] = ((63 - i) * top[0] + (i + 1) * top[64] + 32) >> 6;
          }
          fl[64] = left[64];
          ft[64] = top[64];
        } else {
          fl[0] = ft[0] = (left[1] + 2 * left[0] + top[1] + 2) >> 2;
          for (int i = 1; i < 2 * n; i++) {
            fl[i] = (left[i + 1] + 2 * left[i] + left[i - 1] + 2) >> 2;
            ft[i] = (top[i + 1] + 2 * top[i] + top[i - 1] + 2) >> 2;
          }
          fl[2 * n] = left[2 * n];
          ft[2 * n] = top[2 * n];
        }
        memcpy(left, fl, sizeof(int) * (2 * n + 1));
        memcpy(top, ft, sizeof(int) * (2 * n + 1));
      }
    }
    auto out = [&](int x, int y) -> uint8_t& { return pl[(size_t)(y0 + y) * stride + x0 + x]; };
    if (mode == 0) {  // planar
      for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++)
          out(x, y) = (uint8_t)(((n - 1 - x) * left[y + 1] + (x + 1) * top[n + 1] +
                                 (n - 1 - y) * top[x + 1] + (y + 1) * left[n + 1] + n) >>
                                (log2 + 1));
      return;
    }
    if (mode == 1) {  // DC
      int sum = n;
      for (int i = 1; i <= n; i++) sum += left[i] + top[i];
      int dc = sum >> (log2 + 1);
      for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++) out(x, y) = (uint8_t)dc;
      if (c == 0 && n < 32) {
        out(0, 0) = (uint8_t)((left[1] + 2 * dc + top[1] + 2) >> 2);
        for (int x = 1; x < n; x++) out(x, 0) = (uint8_t)((top[x + 1] + 3 * dc + 2) >> 2);
        for (int y = 1; y < n; y++) out(0, y) = (uint8_t)((left[y + 1] + 3 * dc + 2) >> 2);
      }
      return;
    }
    int angle = kIntraAngle[mode];
    int refbuf[3 * 64 + 1];
    int* ref = refbuf + 64;  // ref[-n .. 2n]
    bool vertical = mode >= 18;
    const int* main = vertical ? top : left;
    const int* side = vertical ? left : top;
    for (int x = 0; x <= n; x++) ref[x] = main[x];
    if (angle < 0) {
      int last = (n * angle) >> 5;
      if (last < -1) {
        int inv = kInvAngle[mode - 11];
        for (int x = last; x <= -1; x++) ref[x] = side[((x * inv + 128) >> 8)];
      }
    } else {
      for (int x = n + 1; x <= 2 * n; x++) ref[x] = main[x];
    }
    for (int j = 0; j < n; j++) {  // j: y for vertical modes, x for horizontal
      int pos = (j + 1) * angle, idx = pos >> 5, fact = pos & 31;
      for (int i = 0; i < n; i++) {
        int v = fact ? ((32 - fact) * ref[i + idx + 1] + fact * ref[i + idx + 2] + 16) >> 5
                     : ref[i + idx + 1];
        if (vertical) out(i, j) = (uint8_t)v;
        else out(j, i) = (uint8_t)v;
      }
    }
    if (c == 0 && n < 32) {
      if (mode == 26)
        for (int y = 0; y < n; y++) out(0, y) = clip8(top[1] + ((left[y + 1] - left[0]) >> 1));
      if (mode == 10)
        for (int x = 0; x < n; x++) out(x, 0) = clip8(left[1] + ((top[x + 1] - top[0]) >> 1));
    }
  }

  // ------------------------------------------------------------ inter --
  // 6.4.2: the prediction block at (xN, yN) is available for this one
  bool pb_avail(int xCb, int yCb, int nCb, int xPb, int yPb, int w, int h, int part_idx, int xN,
                int yN) const {
    bool same = xCb <= xN && yCb <= yN && xCb + nCb > xN && yCb + nCb > yN;
    bool a;
    if (!same) a = avail(xPb, yPb, xN, yN);
    else a = !((w << 1) == nCb && (h << 1) == nCb && part_idx == 1 && yCb + h <= yN && xCb + w > xN);
    return a && !intra_at(xN, yN);
  }
  Motion motion_at(int x, int y) const {
    const PbMotion& m = cur->mv[at4(x, y)];
    Motion r;
    r.pred = m.pred;
    for (int l = 0; l < 2; l++) {
      r.mv[l][0] = m.mv[l][0];
      r.mv[l][1] = m.mv[l][1];
      r.ref[l] = m.ref_idx[l];
    }
    return r;
  }
  static bool same_motion(const Motion& a, const Motion& b) {
    if (a.pred != b.pred) return false;
    for (int l = 0; l < 2; l++)
      if ((a.pred >> l) & 1)
        if (a.mv[l][0] != b.mv[l][0] || a.mv[l][1] != b.mv[l][1] || a.ref[l] != b.ref[l])
          return false;
    return true;
  }
  static int scale_mv(int mv, int td, int tb) {
    td = clip3(-128, 127, td);
    tb = clip3(-128, 127, tb);
    int tx = (16384 + (std::abs(td) >> 1)) / td;
    int dsf = clip3(-4096, 4095, (tb * tx + 32) >> 6);
    int prod = dsf * mv;
    int v = prod >= 0 ? (prod + 127) >> 8 : -((-prod + 127) >> 8);
    return clip3(-32768, 32767, v);
  }

  // 8.5.3.2.8-9: the temporal motion vector of list X for refIdx
  bool temporal_mv(int xPb, int yPb, int w, int h, int ref_idx, int mv[2]) {
    if (!sh.tmvp) return false;
    const Picture* col = list0[sh.col_ref_idx].get();
    auto col_mv = [&](int x, int y) {
      x = (x >> 4) << 4;
      y = (y >> 4) << 4;
      const PbMotion& c = col->mv[(y >> 2) * col->w4 + (x >> 2)];
      if (!c.pred) return false;
      int l = (c.pred & 1) ? 0 : 1;  // both lists: only B slices, refused
      int col_diff = col->poc - c.ref_poc[l], cur_diff = poc - list_poc[0][ref_idx];
      for (int k = 0; k < 2; k++)
        mv[k] = col_diff == cur_diff ? c.mv[l][k] : scale_mv(c.mv[l][k], col_diff, cur_diff);
      return true;
    };
    int xb = xPb + w, yb = yPb + h;
    if ((yPb >> s->ctb_log2) == (yb >> s->ctb_log2) && yb < s->height && xb < s->width &&
        col_mv(xb, yb))
      return true;
    return col_mv(xPb + (w >> 1), yPb + (h >> 1));
  }

  // 8.5.3.2.2-5: the merge candidate list (up to max_merge entries)
  int merge_list(int xPb, int yPb, int w, int h, int part_idx, Motion* cand) {
    int xCb = cu_x, yCb = cu_y, nCb = 1 << cu_log2;
    if (p->log2_par_mrg > 2 && nCb == 8) {
      xPb = xCb;
      yPb = yCb;
      w = h = nCb;
      part_idx = 0;
    }
    int lv = p->log2_par_mrg;
    auto pm = [&](int x, int y) { return (xPb >> lv) == (x >> lv) && (yPb >> lv) == (y >> lv); };
    auto av = [&](int x, int y) {
      return !pm(x, y) && pb_avail(xCb, yCb, nCb, xPb, yPb, w, h, part_idx, x, y);
    };
    int count = 0;
    int xA1 = xPb - 1, yA1 = yPb + h - 1, xB1 = xPb + w - 1, yB1 = yPb - 1;
    bool a1 = av(xA1, yA1) &&
              !(part_idx == 1 && (cu_part == PNx2N || cu_part == PnLx2N || cu_part == PnRx2N));
    Motion mA1 = a1 ? motion_at(xA1, yA1) : Motion{};
    if (a1) cand[count++] = mA1;
    bool b1 = av(xB1, yB1) &&
              !(part_idx == 1 && (cu_part == P2NxN || cu_part == P2NxnU || cu_part == P2NxnD));
    Motion mB1 = b1 ? motion_at(xB1, yB1) : Motion{};
    if (b1 && !(a1 && same_motion(mA1, mB1))) cand[count++] = mB1;
    bool b0 = av(xPb + w, yPb - 1);
    if (b0) {
      Motion m = motion_at(xPb + w, yPb - 1);
      if (!(b1 && same_motion(mB1, m))) cand[count++] = m;
    }
    bool a0 = av(xPb - 1, yPb + h);
    if (a0) {
      Motion m = motion_at(xPb - 1, yPb + h);
      if (!(a1 && same_motion(mA1, m))) cand[count++] = m;
    }
    if (count < 4 && av(xPb - 1, yPb - 1)) {
      Motion m = motion_at(xPb - 1, yPb - 1);
      if (!(a1 && same_motion(mA1, m)) && !(b1 && same_motion(mB1, m))) cand[count++] = m;
    }
    if (count > sh.max_merge) count = sh.max_merge;
    int mv[2];
    if (count < sh.max_merge && temporal_mv(xPb, yPb, w, h, 0, mv)) {
      Motion m;
      m.pred = 1;
      m.mv[0][0] = (int16_t)mv[0];
      m.mv[0][1] = (int16_t)mv[1];
      m.ref[0] = 0;
      cand[count++] = m;
      tmvp_used = true;
    }
    int zero = 0;
    while (count < sh.max_merge) {
      Motion m;
      m.pred = 1;
      m.ref[0] = (int8_t)(zero < sh.num_ref[0] ? zero : 0);
      cand[count++] = m;
      zero++;
    }
    return count;
  }
  bool tmvp_used = false;

  // 8.5.3.2.6-7: the two AMVP candidates of list 0 for ref_idx
  void amvp(int xPb, int yPb, int w, int h, int part_idx, int ref_idx, int out[2][2]) {
    int xCb = cu_x, yCb = cu_y, nCb = 1 << cu_log2;
    int want = list_poc[0][ref_idx];
    auto av = [&](int x, int y) { return pb_avail(xCb, yCb, nCb, xPb, yPb, w, h, part_idx, x, y); };
    auto ref_poc_at = [&](int x, int y) { return cur->mv[at4(x, y)].ref_poc[0]; };
    int ax[2] = {xPb - 1, xPb - 1}, ay[2] = {yPb + h, yPb + h - 1};
    bool aa[2] = {av(ax[0], ay[0]), av(ax[1], ay[1])};
    bool scaled = aa[0] || aa[1];
    bool fa = false, fb = false;
    int mva[2] = {0, 0}, mvb[2] = {0, 0};
    for (int k = 0; k < 2 && !fa; k++)
      if (aa[k] && (cur->mv[at4(ax[k], ay[k])].pred & 1) && ref_poc_at(ax[k], ay[k]) == want) {
        fa = true;
        mva[0] = cur->mv[at4(ax[k], ay[k])].mv[0][0];
        mva[1] = cur->mv[at4(ax[k], ay[k])].mv[0][1];
      }
    for (int k = 0; k < 2 && !fa; k++)
      if (aa[k] && (cur->mv[at4(ax[k], ay[k])].pred & 1)) {
        fa = true;
        int rp = ref_poc_at(ax[k], ay[k]);
        for (int i = 0; i < 2; i++) mva[i] = scale_mv(cur->mv[at4(ax[k], ay[k])].mv[0][i], poc - rp, poc - want);
      }
    int bx[3] = {xPb + w, xPb + w - 1, xPb - 1}, by[3] = {yPb - 1, yPb - 1, yPb - 1};
    bool ab[3] = {av(bx[0], by[0]), av(bx[1], by[1]), av(bx[2], by[2])};
    for (int k = 0; k < 3 && !fb; k++)
      if (ab[k] && (cur->mv[at4(bx[k], by[k])].pred & 1) && ref_poc_at(bx[k], by[k]) == want) {
        fb = true;
        mvb[0] = cur->mv[at4(bx[k], by[k])].mv[0][0];
        mvb[1] = cur->mv[at4(bx[k], by[k])].mv[0][1];
      }
    if (!scaled && fb) {
      fa = true;
      mva[0] = mvb[0];
      mva[1] = mvb[1];
    }
    if (!scaled) {
      fb = false;
      for (int k = 0; k < 3 && !fb; k++)
        if (ab[k] && (cur->mv[at4(bx[k], by[k])].pred & 1)) {
          fb = true;
          int rp = ref_poc_at(bx[k], by[k]);
          for (int i = 0; i < 2; i++) mvb[i] = scale_mv(cur->mv[at4(bx[k], by[k])].mv[0][i], poc - rp, poc - want);
        }
    }
    int n = 0;
    int list[3][2];
    if (fa) { list[n][0] = mva[0]; list[n][1] = mva[1]; n++; }
    if (fb && !(fa && mva[0] == mvb[0] && mva[1] == mvb[1])) { list[n][0] = mvb[0]; list[n][1] = mvb[1]; n++; }
    int mv[2];
    if (n < 2 && temporal_mv(xPb, yPb, w, h, ref_idx, mv)) {
      list[n][0] = mv[0];
      list[n][1] = mv[1];
      n++;
      tmvp_used = true;
    }
    while (n < 2) { list[n][0] = list[n][1] = 0; n++; }
    for (int i = 0; i < 2; i++) { out[i][0] = list[i][0]; out[i][1] = list[i][1]; }
  }

  int eg_bypass(int k, int v) {  // k-th order Exp-Golomb in bypass bins
    int val = 0;
    while (cabac.bypass(W() && v >= (1 << k))) {
      if (W()) v -= 1 << k;
      val += 1 << k;
      if (++k > 24) fail("invalid CABAC Exp-Golomb code");
    }
    while (k--) val += cabac.bypass(W() ? (v >> k) & 1 : 0) << k;
    return val;
  }

  void prediction_unit(int x, int y, int w, int h, int part_idx, bool skip) {
    PuChoice pc;
    Motion cands[5];
    if (W()) {
      merge_list(x, y, w, h, part_idx, cands);
      amvp_query = [&](int ref, int flag, int out[2]) {
        int l[2][2];
        amvp(x, y, w, h, part_idx, ref, l);
        out[0] = l[flag][0];
        out[1] = l[flag][1];
      };
      ch->pu(x, y, w, h, part_idx, cands, pc);
      amvp_query = nullptr;
    }
    tmvp_used = false;
    int merge = skip ? 1 : cabac.bin(C_MERGE_FLAG, pc.merge);
    if (part_idx == 0) merge0 = merge != 0;
    Motion m;
    if (merge) {
      int idx = 0;
      if (sh.max_merge > 1) {
        idx = cabac.bin(C_MERGE_IDX, pc.merge_idx > 0);
        if (idx) idx += tr_bypass(sh.max_merge - 2, pc.merge_idx - 1);
      }
      merge_list(x, y, w, h, part_idx, cands);
      m = cands[idx];
      if (!skip) stats[S_MERGE]++;
    } else {
      stats[S_AMVP]++;
      int ref = 0;
      if (sh.num_ref[0] > 1) {
        int cmax = sh.num_ref[0] - 1;
        ref = cabac.bin(C_REF_IDX, pc.ref_idx > 0);
        if (ref && cmax > 1) {
          ref += cabac.bin(C_REF_IDX + 1, pc.ref_idx > 1);
          if (ref == 2 && cmax > 2) ref += tr_bypass(cmax - 2, pc.ref_idx - 2);
        }
      }
      int g0[2], g1[2] = {0, 0}, mvd[2];
      for (int k = 0; k < 2; k++) g0[k] = cabac.bin(C_MVD_G0, pc.mvd[k] != 0);
      for (int k = 0; k < 2; k++)
        if (g0[k]) g1[k] = cabac.bin(C_MVD_G1, std::abs(pc.mvd[k]) > 1);
      for (int k = 0; k < 2; k++) {
        mvd[k] = 0;
        if (!g0[k]) continue;
        int a = 1 + g1[k];
        if (g1[k]) a += eg_bypass(1, std::abs(pc.mvd[k]) - 2);
        mvd[k] = cabac.bypass(pc.mvd[k] < 0) ? -a : a;
      }
      int flag = cabac.bin(C_MVP_FLAG, pc.mvp);
      int l[2][2];
      amvp(x, y, w, h, part_idx, ref, l);
      m.pred = 1;
      m.ref[0] = (int8_t)ref;
      for (int k = 0; k < 2; k++) {
        int u = (l[flag][k] + mvd[k] + 65536) & 0xFFFF;
        m.mv[0][k] = (int16_t)(u >= 32768 ? u - 65536 : u);
      }
    }
    if (tmvp_used) stats[S_TMVP_CAND]++;
    if (w + h == 12) stats[S_SMALL_PU]++;
    PbMotion pm{};
    pm.pred = m.pred;
    for (int l = 0; l < 2; l++) {
      pm.mv[l][0] = m.mv[l][0];
      pm.mv[l][1] = m.mv[l][1];
      pm.ref_idx[l] = m.ref[l];
      pm.ref_poc[l] = (m.pred >> l) & 1 ? list_poc[l][m.ref[l]] : 0;
    }
    fill4(x, y, w, h, [&](int i) { cur->mv[i] = pm; });
    predict_inter(x, y, w, h, m);
  }
  std::function<void(int, int, int[2])> amvp_query;

  // 8.5.3.3: fractional sample interpolation and weighted sample prediction
  void predict_inter(int x0, int y0, int w, int h, const Motion& m) {
    const Picture& ref = *list0[m.ref[0]];
    int ri = m.ref[0];
    bool weighted = p->weighted_pred && sh.type == SLICE_P;
    static thread_local std::vector<int16_t> tmp;
    tmp.resize((size_t)w * h);
    for (int c = 0; c < 3; c++) {
      int bw = c ? w / 2 : w, bh = c ? h / 2 : h, bx = c ? x0 / 2 : x0, by = c ? y0 / 2 : y0;
      if (c == 0) mc_luma(ref, bx, by, bw, bh, m.mv[0][0], m.mv[0][1], tmp.data());
      else mc_chroma(ref, c, bx, by, bw, bh, m.mv[0][0], m.mv[0][1], tmp.data());
      uint8_t* dst = cur->plane(c);
      int stride = cur->stride(c);
      if (!weighted) {
        for (int y = 0; y < bh; y++)
          for (int x = 0; x < bw; x++)
            dst[(size_t)(by + y) * stride + bx + x] = clip8((tmp[y * bw + x] + 32) >> 6);
      } else {
        int wt = c ? sh.chroma_w[ri][c - 1] : sh.luma_w[ri];
        int of = c ? sh.chroma_o[ri][c - 1] : sh.luma_o[ri];
        int log2wd = (c ? sh.chroma_denom : sh.luma_denom) + 6;
        for (int y = 0; y < bh; y++)
          for (int x = 0; x < bw; x++)
            dst[(size_t)(by + y) * stride + bx + x] =
                clip8(((tmp[y * bw + x] * wt + (1 << (log2wd - 1))) >> log2wd) + of);
      }
    }
  }
  // reference samples (w + taps - 1) x (h + taps - 1) from (x, y), the picture's edges replicated
  static void fetch(const uint8_t* pl, int pw, int ph, int x, int y, int w, int h, uint8_t* win) {
    if (x >= 0 && y >= 0 && x + w <= pw && y + h <= ph) {
      for (int r = 0; r < h; r++) memcpy(win + r * w, pl + (size_t)(y + r) * pw + x, w);
      return;
    }
    for (int r = 0; r < h; r++) {
      const uint8_t* row = pl + (size_t)clip3(0, ph - 1, y + r) * pw;
      for (int k = 0; k < w; k++) win[r * w + k] = row[clip3(0, pw - 1, x + k)];
    }
  }
  void mc_luma(const Picture& ref, int x0, int y0, int w, int h, int mvx, int mvy, int16_t* dst) {
    int xf = mvx & 3, yf = mvy & 3, xi = x0 + (mvx >> 2), yi = y0 + (mvy >> 2);
    int ww = w + 7, wh = h + 7;
    static thread_local std::vector<uint8_t> win;
    static thread_local std::vector<int16_t> t;
    win.resize((size_t)ww * wh);
    fetch(ref.y.data(), ref.w, ref.h, xi - 3, yi - 3, ww, wh, win.data());
    const int8_t* fx = kLumaFilter[xf];
    const int8_t* fy = kLumaFilter[yf];
    if (!xf && !yf) {
      for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) dst[y * w + x] = (int16_t)(win[(y + 3) * ww + x + 3] << 6);
    } else if (!yf) {
      for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) {
          const uint8_t* s8 = &win[(y + 3) * ww + x];
          int v = 0;
          for (int i = 0; i < 8; i++) v += fx[i] * s8[i];
          dst[y * w + x] = (int16_t)v;
        }
    } else if (!xf) {
      for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) {
          int v = 0;
          for (int i = 0; i < 8; i++) v += fy[i] * win[(y + i) * ww + x + 3];
          dst[y * w + x] = (int16_t)v;
        }
    } else {
      t.resize((size_t)w * wh);
      for (int r = 0; r < wh; r++)
        for (int x = 0; x < w; x++) {
          const uint8_t* s8 = &win[r * ww + x];
          int v = 0;
          for (int i = 0; i < 8; i++) v += fx[i] * s8[i];
          t[r * w + x] = (int16_t)v;
        }
      for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) {
          int v = 0;
          for (int i = 0; i < 8; i++) v += fy[i] * t[(y + i) * w + x];
          dst[y * w + x] = (int16_t)(v >> 6);
        }
    }
  }
  void mc_chroma(const Picture& ref, int c, int x0, int y0, int w, int h, int mvx, int mvy,
                 int16_t* dst) {
    int xf = mvx & 7, yf = mvy & 7, xi = x0 + (mvx >> 3), yi = y0 + (mvy >> 3);
    int ww = w + 3, wh = h + 3;
    static thread_local std::vector<uint8_t> win;
    static thread_local std::vector<int16_t> t;
    win.resize((size_t)ww * wh);
    fetch(ref.plane(c), ref.w / 2, ref.h / 2, xi - 1, yi - 1, ww, wh, win.data());
    const int8_t* fx = kChromaFilter[xf];
    const int8_t* fy = kChromaFilter[yf];
    if (!xf && !yf) {
      for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) dst[y * w + x] = (int16_t)(win[(y + 1) * ww + x + 1] << 6);
    } else if (!yf) {
      for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) {
          const uint8_t* s4 = &win[(y + 1) * ww + x];
          dst[y * w + x] = (int16_t)(fx[0] * s4[0] + fx[1] * s4[1] + fx[2] * s4[2] + fx[3] * s4[3]);
        }
    } else if (!xf) {
      for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) {
          int v = 0;
          for (int i = 0; i < 4; i++) v += fy[i] * win[(y + i) * ww + x + 1];
          dst[y * w + x] = (int16_t)v;
        }
    } else {
      t.resize((size_t)w * wh);
      for (int r = 0; r < wh; r++)
        for (int x = 0; x < w; x++) {
          const uint8_t* s4 = &win[r * ww + x];
          t[r * w + x] = (int16_t)(fx[0] * s4[0] + fx[1] * s4[1] + fx[2] * s4[2] + fx[3] * s4[3]);
        }
      for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) {
          int v = 0;
          for (int i = 0; i < 4; i++) v += fy[i] * t[(y + i) * w + x];
          dst[y * w + x] = (int16_t)(v >> 6);
        }
    }
  }

  // ------------------------------------------------------ transform tree --
  void transform_tree(int x0, int y0, int xb, int yb, int log2, int depth, int blk, int max_depth,
                      int parent_cb, int parent_cr) {
    int split;
    bool intra_split = cu_intra && cu_part == PNxN;
    if (log2 <= s->max_tb_log2 && log2 > s->log2_min_tb && depth < max_depth &&
        !(intra_split && depth == 0)) {
      split = cabac.bin(C_SPLIT_TF + 5 - log2, W() ? ch->split_tf(x0, y0, log2, depth) : 0);
    } else {
      bool inter_split = s->max_th_inter == 0 && !cu_intra && cu_part != P2Nx2N && depth == 0;
      split = log2 > s->max_tb_log2 || (intra_split && depth == 0) || inter_split;
    }
    int cb = parent_cb, cr = parent_cr;
    if (log2 > 2) {
      cb = cr = 0;
      if (depth == 0 || parent_cb) cb = cabac.bin(C_CBF_CHROMA + depth, W() ? ch->cbf(1, x0, y0, log2, depth) : 0);
      if (depth == 0 || parent_cr) cr = cabac.bin(C_CBF_CHROMA + depth, W() ? ch->cbf(2, x0, y0, log2, depth) : 0);
    }
    if (split) {
      int h = 1 << (log2 - 1);
      for (int k = 0; k < 4; k++)
        transform_tree(x0 + (k & 1) * h, y0 + (k >> 1) * h, x0, y0, log2 - 1, depth + 1, k,
                       max_depth, cb, cr);
      return;
    }
    int luma = 1;
    if (cu_intra || depth != 0 || cb || cr)
      luma = cabac.bin(C_CBF_LUMA + (depth == 0 ? 1 : 0), W() ? ch->cbf(0, x0, y0, log2, depth) : 1);
    transform_unit(x0, y0, xb, yb, log2, blk, luma, cb, cr);
  }

  void transform_unit(int x0, int y0, int xb, int yb, int log2, int blk, int luma, int cb, int cr) {
    int n = 1 << log2;
    if (cu_intra) intra_pred(0, x0, y0, log2, ipm[at4(x0, y0)]);
    if ((luma || cb || cr) && p->cu_qp_delta && !qp_delta_coded) {
      int v = W() ? ch->qp_delta(x0, y0) : 0, a = std::abs(v);
      int pre = cabac.bin(C_QP_DELTA, a > 0), k = pre;
      while (pre && k < 5 && cabac.bin(C_QP_DELTA + 1, a > k)) k++;
      if (k == 5) k += eg_bypass(0, a - 5);
      if (k && cabac.bypass(v < 0)) k = -k;
      if (k < -26 || k > 25) fail("CuQpDeltaVal out of range");
      qp_delta_coded = true;
      qp_delta_val = k;
      if (k) stats[S_QP_DELTA]++;
      derive_qp(cu_x, cu_y);
    }
    if (luma) residual_coding(0, x0, y0, log2);
    fill4(x0, y0, n, n, [&](int i) { cbf4[i] = (uint8_t)luma; });
    if (!sh.deblock_disabled) bs_block(x0, y0, log2);
    if (log2 > 2) {
      for (int c = 1; c < 3; c++) {
        if (cu_intra) intra_pred(c, x0 / 2, y0 / 2, log2 - 1, cu_chroma_mode);
        if (c == 1 ? cb : cr) residual_coding(c, x0 / 2, y0 / 2, log2 - 1);
      }
    } else if (blk == 3) {
      for (int c = 1; c < 3; c++) {
        if (cu_intra) intra_pred(c, xb / 2, yb / 2, 2, cu_chroma_mode);
        if (c == 1 ? cb : cr) residual_coding(c, xb / 2, yb / 2, 2);
      }
    }
  }

  // ---------------------------------------------------------- residual --
  void residual_coding(int c, int x0, int y0, int log2) {
    const Tables& T = tables();
    int n = 1 << log2;
    int16_t lv[32 * 32];
    memset(lv, 0, sizeof(int16_t) * n * n);
    int want_ts = 0;
    if (W()) {
      ch->coeffs(c, x0, y0, log2, lv);
      if (p->transform_skip && !cu_bypass && log2 == 2) want_ts = ch->transform_skip(c, x0, y0, log2);
    }
    int ts = 0;
    if (p->transform_skip && !cu_bypass && log2 == 2) ts = cabac.bin(C_TSKIP + (c ? 1 : 0), want_ts);
    if (ts) stats[S_TSKIP]++;
    int scan = 0;
    if (cu_intra && (log2 == 2 || (log2 == 3 && c == 0))) {
      int m = c ? cu_chroma_mode : ipm[at4(x0, y0)];
      if (m >= 6 && m <= 14) scan = 2;
      else if (m >= 22 && m <= 30) scan = 1;
    }
    int lsb = log2 - 2;  // sub-blocks per side, log2
    const uint8_t(*sbscan)[2] = T.scan[lsb][scan];
    const uint8_t(*pscan)[2] = T.scan[2][scan];
    bool hiding = p->sign_hiding && !cu_bypass;
    if (W()) {
      // sign data hiding: the writer makes each hidden sign the parity's
      if (hiding)
        for (int i = (1 << (2 * lsb)) - 1; i >= 0; i--) {
          int first = -1, last = -1, sum = 0;
          for (int k = 15; k >= 0; k--) {
            int x = (sbscan[i][0] << 2) + pscan[k][0], y = (sbscan[i][1] << 2) + pscan[k][1];
            int v = lv[y * n + x];
            if (!v) continue;
            if (last < 0) last = k;
            first = k;
            sum += std::abs(v);
          }
          if (last >= 0 && last - first > 3) {
            int x = (sbscan[i][0] << 2) + pscan[first][0], y = (sbscan[i][1] << 2) + pscan[first][1];
            int16_t& v = lv[y * n + x];
            v = (int16_t)((sum & 1) ? -std::abs(v) : std::abs(v));
          }
        }
    }
    // last significant position
    int lx = 0, ly = 0;
    if (W()) {
      bool found = false;
      for (int i = (1 << (2 * lsb)) - 1; i >= 0 && !found; i--)
        for (int k = 15; k >= 0 && !found; k--) {
          int x = (sbscan[i][0] << 2) + pscan[k][0], y = (sbscan[i][1] << 2) + pscan[k][1];
          if (lv[y * n + x]) { lx = x; ly = y; found = true; }
        }
      if (!found) fail("writer: a coded block without coefficients");
      if (scan == 2) std::swap(lx, ly);
    }
    int off, shift;
    if (c == 0) { off = 3 * (log2 - 2) + ((log2 - 1) >> 2); shift = (log2 + 1) >> 2; }
    else { off = 15; shift = log2 - 2; }
    int cmax = (log2 << 1) - 1;
    auto prefix_of = [](int v) {
      if (v < 4) return v;
      int p2 = 4;
      while (true) {
        int base = (1 << ((p2 >> 1) - 1)) * (2 + (p2 & 1));
        int nb = (1 << (((p2 + 1) >> 1) - 1)) * (2 + ((p2 + 1) & 1));
        if (v >= base && v < nb) return p2;
        p2++;
      }
    };
    int want_px = prefix_of(lx), want_py = prefix_of(ly);
    int px = 0, py = 0;
    while (px < cmax && cabac.bin(C_LAST_X + off + (px >> shift), want_px > px)) px++;
    while (py < cmax && cabac.bin(C_LAST_Y + off + (py >> shift), want_py > py)) py++;
    auto value = [&](int pre, int want) {
      if (pre <= 3) return pre;
      int base = (1 << ((pre >> 1) - 1)) * (2 + (pre & 1));
      return base + fl_bypass((pre >> 1) - 1, want - base);
    };
    lx = value(px, lx);
    ly = value(py, ly);
    if (scan == 2) std::swap(lx, ly);
    if (lx >= n || ly >= n) fail("last significant coefficient out of the block");
    // the sub-block and position of the last coefficient
    int last_sb = (1 << (2 * lsb)) - 1, last_pos = 16;
    for (;;) {
      if (last_pos == 0) { last_pos = 16; last_sb--; }
      last_pos--;
      int x = (sbscan[last_sb][0] << 2) + pscan[last_pos][0];
      int y = (sbscan[last_sb][1] << 2) + pscan[last_pos][1];
      if (x == lx && y == ly) break;
    }
    uint8_t csbf[8][8];
    memset(csbf, 0, sizeof csbf);
    int16_t out[32 * 32];
    memset(out, 0, sizeof(int16_t) * n * n);
    int nsb = 1 << lsb;
    int greater1_ctx = 1;
    for (int i = last_sb; i >= 0; i--) {
      int xs = sbscan[i][0], ys = sbscan[i][1];
      bool infer_dc = false;
      int sig[16] = {0}, val[16];
      for (int k = 0; k < 16; k++) {
        int x = (xs << 2) + pscan[k][0], y = (ys << 2) + pscan[k][1];
        val[k] = W() ? lv[y * n + x] : 0;
      }
      if (i < last_sb && i > 0) {
        int ctx = std::min(1, (xs < nsb - 1 ? csbf[xs + 1][ys] : 0) + (ys < nsb - 1 ? csbf[xs][ys + 1] : 0));
        bool any = false;
        for (int k = 0; k < 16; k++) any |= val[k] != 0;
        csbf[xs][ys] = (uint8_t)cabac.bin(C_CSBF + ctx + (c ? 2 : 0), any);
        infer_dc = true;
      } else {
        csbf[xs][ys] = 1;
      }
      int prev = (xs < nsb - 1 ? csbf[xs + 1][ys] : 0) + 2 * (ys < nsb - 1 ? csbf[xs][ys + 1] : 0);
      int start = i == last_sb ? last_pos - 1 : 15;
      if (i == last_sb) sig[last_pos] = 1;
      for (int k = start; k >= 0; k--) {
        int x = (xs << 2) + pscan[k][0], y = (ys << 2) + pscan[k][1];
        if (csbf[xs][ys] && (k > 0 || !infer_dc)) {
          int sctx;
          if (log2 == 2) sctx = kSigCtx4[(y << 2) + x];
          else if (x + y == 0) sctx = 0;
          else {
            int xp = x & 3, yp = y & 3;
            if (prev == 0) sctx = xp + yp == 0 ? 2 : xp + yp < 3 ? 1 : 0;
            else if (prev == 1) sctx = yp == 0 ? 2 : yp == 1 ? 1 : 0;
            else if (prev == 2) sctx = xp == 0 ? 2 : xp == 1 ? 1 : 0;
            else sctx = 2;
            if (c == 0) {
              if (xs || ys) sctx += 3;
              sctx += log2 == 3 ? (scan == 0 ? 9 : 15) : 21;
            } else {
              sctx += log2 == 3 ? 9 : 12;
            }
          }
          sig[k] = cabac.bin(C_SIG + (c ? 27 : 0) + sctx, val[k] != 0);
          if (sig[k]) infer_dc = false;
        } else if (csbf[xs][ys] && k == 0 && infer_dc) {
          sig[k] = 1;
        }
      }
      // levels
      int first = 16, lastk = -1, ng1 = 0, first_g1 = -1;
      int g1[16] = {0}, g2[16] = {0};
      int ctx_set = 0;
      bool any_sig = false;
      for (int k = 15; k >= 0; k--) any_sig |= sig[k] != 0;
      if (any_sig) {
        ctx_set = (i == 0 || c > 0) ? 0 : 2;
        if (i != last_sb && greater1_ctx == 0) ctx_set++;
        greater1_ctx = 1;
      }
      for (int k = 15; k >= 0; k--) {
        if (!sig[k]) continue;
        if (ng1 < 8) {
          g1[k] = cabac.bin(C_GT1 + ctx_set * 4 + greater1_ctx + (c ? 16 : 0), std::abs(val[k]) > 1);
          ng1++;
          if (g1[k]) {
            greater1_ctx = 0;
            if (first_g1 < 0) first_g1 = k;
          } else if (greater1_ctx > 0 && greater1_ctx < 3) {
            greater1_ctx++;
          }
        }
        if (lastk < 0) lastk = k;
        first = k;
      }
      bool hidden = hiding && lastk - first > 3;
      if (first_g1 >= 0)
        g2[first_g1] = cabac.bin(C_GT2 + ctx_set + (c ? 4 : 0), std::abs(val[first_g1]) > 2);
      int sign[16] = {0};
      for (int k = 15; k >= 0; k--)
        if (sig[k] && (!hidden || k != first)) sign[k] = cabac.bypass(val[k] < 0);
      int nsig = 0, sum = 0, rice = 0;
      for (int k = 15; k >= 0; k--) {
        if (!sig[k]) continue;
        int base = 1 + g1[k] + g2[k];
        int a = base;
        if (base == (nsig < 8 ? (k == first_g1 ? 3 : 2) : 1)) {
          int rem = W() ? std::abs(val[k]) - base : 0;
          // coeff_abs_level_remaining (9.3.3.11): a prefix of up to four
          // ones with a rice suffix, then Exp-Golomb of order rice + 1
          int pre = 0;
          if (W()) {
            if ((rem >> rice) < 4) pre = rem >> rice;
            else {
              pre = 4;
              while ((((1 << (pre - 2)) + 2) << rice) <= rem) pre++;
            }
          }
          int pr = 0;
          while (pr < 32 && cabac.bypass(W() && pr < pre)) pr++;
          if (pr > 30) fail("invalid coeff_abs_level_remaining");
          int r;
          if (pr <= 3) r = (pr << rice) + fl_bypass(rice, rem - (pr << rice));
          else {
            int b0 = ((1 << (pr - 3)) + 2) << rice;
            r = b0 + fl_bypass(pr - 3 + rice, rem - b0);
          }
          a = base + r;
          if (a > 3 * (1 << rice)) rice = std::min(rice + 1, 4);
        }
        int v = sign[k] ? -a : a;
        if (hidden) {
          sum += a;
          if (k == first && (sum & 1)) v = -v;
        }
        if (v > 32767 || v < -32768) fail("coefficient level out of range");
        int x = (xs << 2) + pscan[k][0], y = (ys << 2) + pscan[k][1];
        out[y * n + x] = (int16_t)v;
        nsig++;
      }
      if (hidden) stats[S_SDH]++;
    }
    reconstruct_residual(c, x0, y0, log2, out, ts);
  }

  // 8.6.2-8.6.4: scaling, transform and the residual added to the prediction
  void reconstruct_residual(int c, int x0, int y0, int log2, const int16_t* lv, int ts) {
    const Tables& T = tables();
    int n = 1 << log2;
    int res[32 * 32];
    uint8_t* pl = cur->plane(c);
    int stride = cur->stride(c);
    if (cu_bypass) {
      for (int i = 0; i < n * n; i++) res[i] = lv[i];
    } else {
      int qp = c == 0 ? qp_y : c == 1 ? qp_cb : qp_cr;
      int bd_shift = log2 + 3;
      int64_t scale = (int64_t)kLevelScale[qp % 6] << (qp / 6);
      bool lists = s->scaling_enabled && !(ts && log2 > 2);
      const ScalingList& sl = p->scaling_present ? p->sl : s->sl;
      int size_id = log2 - 2, matrix = (cu_intra ? 0 : 3) + (size_id == 3 ? 0 : c);
      int d[32 * 32];
      int maxx = -1, maxy = -1;
      for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++) {
          int v = lv[y * n + x];
          if (!v) { d[y * n + x] = 0; continue; }
          int m = 16;
          if (lists) {
            if (size_id == 0) m = sl.list[0][matrix][pos_index(2, x, y)];
            else {
              int f = size_id == 1 ? 1 : size_id == 2 ? 2 : 4;
              m = sl.list[size_id][matrix][pos_index(3, x / f, y / f)];
              if (size_id >= 2 && x == 0 && y == 0) m = sl.dc[size_id][matrix];
            }
          }
          int64_t t = ((int64_t)v * m * scale + (1LL << (bd_shift - 1))) >> bd_shift;
          d[y * n + x] = (int)std::max<int64_t>(-32768, std::min<int64_t>(32767, t));
          maxx = std::max(maxx, x);
          maxy = std::max(maxy, y);
        }
      if (ts) {
        for (int i = 0; i < n * n; i++) res[i] = (d[i] * 128 + (1 << 11)) >> 12;
      } else {
        if (log2 == 5) stats[S_TB32]++;
        bool dst = cu_intra && c == 0 && log2 == 2;
        if (dst) stats[S_DST]++;
        // the basis functions of the n-point transform: rows of the 32-point
        // DCT (every 32/n-th) or of the DST; sums fit 32 bits
        int step = 32 >> log2;
        auto basis = [&](int k) { return dst ? kDst4[k] : T.dct[k * step]; };
        int e[32 * 32];
        // columns: e[y][x] = clip((sum_k basis_k[y] d[k][x] + 64) >> 7)
        for (int x = 0; x <= maxx; x++) {
          int col[32] = {0};
          for (int k = 0; k <= maxy; k++) {
            int c = d[k * n + x];
            if (!c) continue;
            const int8_t* bk = basis(k);
            for (int y = 0; y < n; y++) col[y] += bk[y] * c;
          }
          for (int y = 0; y < n; y++) e[y * n + x] = clip3(-32768, 32767, (col[y] + 64) >> 7);
        }
        // rows: res[y][x] = (sum_k basis_k[x] e[y][k] + 2048) >> 12
        for (int y = 0; y < n; y++) {
          int row[32] = {0};
          for (int k = 0; k <= maxx; k++) {
            int c = e[y * n + k];
            if (!c) continue;
            const int8_t* bk = basis(k);
            for (int x = 0; x < n; x++) row[x] += bk[x] * c;
          }
          for (int x = 0; x < n; x++) res[y * n + x] = (row[x] + 2048) >> 12;
        }
      }
    }
    for (int y = 0; y < n; y++)
      for (int x = 0; x < n; x++) {
        uint8_t& px = pl[(size_t)(y0 + y) * stride + x0 + x];
        px = clip8(px + res[y * n + x]);
      }
  }
  // the index of (x, y) in the up-right diagonal scan of a (1 << l) block
  static int pos_index(int l, int x, int y) {
    static int idx[4][64];
    static bool init = false;
    if (!init) {
      for (int ll = 0; ll < 4; ll++)
        for (int i = 0; i < (1 << (2 * ll)); i++)
          idx[ll][tables().scan[ll][0][i][1] * (1 << ll) + tables().scan[ll][0][i][0]] = i;
      init = true;
    }
    return idx[l][y * (1 << l) + x];
  }

  // -------------------------------------------------------- loop filters --
  // 8.7.2: the deblocking filter over the whole picture, vertical edges first
  // bS (8.7.2.4) of the 4-sample segments on the 8x8 grid, written as FFmpeg
  // writes them (ff_hevc_deblocking_boundary_strengths): for each transform
  // block (a coding block without a transform tree counts as one) of a slice
  // that does not disable the filter, its upper and left edges, unless they
  // are a CTB edge that is also the slice's edge in a slice without
  // slice_loop_filter_across_slices_enabled_flag, and in an inter block the
  // grid lines inside it (0 where the motion is the same)
  std::vector<uint8_t> bsv, bsh;
  int bs_of(int q, int p, bool tu_edge) const {
    if ((cuflags[q] | cuflags[p]) & F_INTRA) return 2;
    if (tu_edge && (cbf4[q] || cbf4[p])) return 1;
    const PbMotion& a = cur->mv[p];
    const PbMotion& b = cur->mv[q];
    // P slices: one motion vector each
    if (a.ref_poc[0] != b.ref_poc[0]) return 1;
    if (std::abs(a.mv[0][0] - b.mv[0][0]) >= 4 || std::abs(a.mv[0][1] - b.mv[0][1]) >= 4) return 1;
    return 0;
  }
  void bs_block(int x0, int y0, int log2) {
    int n = 1 << log2, ctb = (y0 >> s->ctb_log2) * s->wctb + (x0 >> s->ctb_log2);
    bool up = y0 > 0 && !(y0 & 7), left = x0 > 0 && !(x0 & 7);
    if (up && !sh.lf_across && !(y0 & (s->ctb - 1)) && ctb_addr_slice[ctb - s->wctb] != sh.address)
      up = false;
    if (left && !sh.lf_across && !(x0 & (s->ctb - 1)) && ctb_addr_slice[ctb - 1] != sh.address)
      left = false;
    if (up)
      for (int i = 0; i < n; i += 4) {
        int q = at4(x0 + i, y0);
        bsh[q] = (uint8_t)bs_of(q, q - w4, true);
      }
    if (left)
      for (int j = 0; j < n; j += 4) {
        int q = at4(x0, y0 + j);
        bsv[q] = (uint8_t)bs_of(q, q - 1, true);
      }
    if (log2 > s->log2_min_cb - 1 && !(cuflags[at4(x0, y0)] & F_INTRA)) {
      for (int j = 8; j < n; j += 8)
        for (int i = 0; i < n; i += 4) {
          int q = at4(x0 + i, y0 + j);
          bsh[q] = (uint8_t)bs_of(q, q - w4, false);
        }
      for (int j = 0; j < n; j += 4)
        for (int i = 8; i < n; i += 8) {
          int q = at4(x0 + i, y0 + j);
          bsv[q] = (uint8_t)bs_of(q, q - 1, false);
        }
    }
  }
  // one 4-sample segment of a luma or chroma edge at luma (x, y), with the
  // offsets FFmpeg's loop gives it (deblock_ctb)
  void luma_segment(int x, int y, int dir, int beta_off, int tc_off) {
    if (x >= s->width || y >= s->height) return;
    int i = at4(x, y), b = dir ? bsh[i] : bsv[i];
    if (!b) return;
    int pi = dir ? i - w4 : i - 1;
    int qpl = (qpy[i] + qpy[pi] + 1) >> 1;
    int beta = kBetaTable[clip3(0, 51, qpl + beta_off)];
    int tc = kTcTable[clip3(0, 53, qpl + 2 * (b - 1) + tc_off)];
    luma_edge(x, y, dir, beta, tc, cuflags[pi] & F_NOFILTER, cuflags[i] & F_NOFILTER);
  }
  void chroma_segment(int c, int x, int y, int dir, int tc_off) {
    if (x >= s->width || y >= s->height) return;
    int i = at4(x, y);
    if ((dir ? bsh[i] : bsv[i]) != 2) return;
    int pi = dir ? i - w4 : i - 1;
    int qpl = (qpy[i] + qpy[pi] + 1) >> 1;
    // the PPS offset only: the slice's is not used (FFmpeg clips qPi to 0..57)
    int qpc = chroma_qp(qpl + (c == 1 ? p->cb_qp_offset : p->cr_qp_offset));
    int tc = kTcTable[clip3(0, 53, qpc + 2 + tc_off)];
    chroma_edge(c, x / 2, y / 2, dir, tc, cuflags[pi] & F_NOFILTER, cuflags[i] & F_NOFILTER);
  }
  // 8.7.2 for one CTB as FFmpeg's deblocking_filter_CTB cuts the picture:
  // by bands of 8 luma rows (16 for chroma), the vertical edges of the band
  // in the CTB, then the horizontal edge at its top from 8 luma samples (16
  // for chroma) left of the CTB to as far short of its right end, the rest
  // left to the next CTB of the row. The samples come out as in the
  // standard's order; what SAO sees in between does not always (sao_ctb).
  // The beta and tC offsets follow FFmpeg's: each CTB's are its slice's
  // (those of the slice before it when it disables the filter by override,
  // whose header does not set them); a horizontal luma segment left of the
  // CTB takes the left CTB's, and so does every vertical segment after it
  // until a horizontal segment of the CTB is filtered; the chroma planes
  // continue with what luma left; a band's horizontal chroma edge takes the
  // left CTB's offset (the CTB's at the picture's left edge) for the first 8
  // luma columns of each 16 and the CTB's for the others, and the vertical
  // chroma edges after it keep the left CTB's.
  void deblock_ctb(int rx, int ry) {
    int x0 = rx << s->ctb_log2, y0 = ry << s->ctb_log2, addr = ry * s->wctb + rx;
    int x_end = std::min(x0 + s->ctb, s->width), y_end = std::min(y0 + s->ctb, s->height);
    const SliceInfo& cs = slices[ctb_slice[addr]];
    int cur_beta = cs.beta, cur_tc = cs.tc, left_beta = 0, left_tc = 0;
    if (x0) {
      const SliceInfo& ls = slices[ctb_slice[addr - 1]];
      left_beta = ls.beta;
      left_tc = ls.tc;
    }
    int beta_off = cur_beta, tc_off = cur_tc;
    int x_end2 = x_end == s->width ? x_end : x_end - 8;
    for (int y = y0; y < y_end; y += 8) {
      for (int x = x0 ? x0 : 8; x < x_end; x += 8) {
        luma_segment(x, y, 0, beta_off, tc_off);
        luma_segment(x, y + 4, 0, beta_off, tc_off);
      }
      if (!y) continue;
      for (int x = x0 ? x0 - 8 : 0; x < x_end2; x += 8) {
        if (!bsh[at4(x, y)] && !(x + 4 < s->width && bsh[at4(x + 4, y)])) continue;
        tc_off = x >= x0 ? cur_tc : left_tc;
        beta_off = x >= x0 ? cur_beta : left_beta;
        luma_segment(x, y, 1, beta_off, tc_off);
        luma_segment(x + 4, y, 1, beta_off, tc_off);
      }
    }
    for (int c = 1; c < 3; c++)
      for (int y = y0; y < y_end; y += 16) {
        for (int x = x0 ? x0 : 16; x < x_end; x += 16) {
          chroma_segment(c, x, y, 0, tc_off);
          chroma_segment(c, x, y + 8, 0, tc_off);
        }
        if (!y) continue;
        tc_off = x0 ? left_tc : cur_tc;
        int x_end2c = x_end == s->width ? x_end : x_end - 16;
        for (int x = x0 ? x0 - 16 : 0; x < x_end2c; x += 16) {
          chroma_segment(c, x, y, 1, tc_off);
          chroma_segment(c, x + 8, y, 1, cur_tc);
        }
      }
  }
  void luma_edge(int x0, int y0, int dir, int beta, int tc, bool nop, bool noq) {
    uint8_t* pl = cur->y.data();
    int stride = cur->w;
    int xs = dir ? 1 : stride, step = dir ? stride : 1;  // xs: along the edge; step: across
    uint8_t* base = pl + (size_t)y0 * stride + x0;
    auto P = [&](int k, int i) -> uint8_t& { return base[k * xs - (i + 1) * step]; };
    auto Q = [&](int k, int i) -> uint8_t& { return base[k * xs + i * step]; };
    int dp0 = std::abs(P(0, 2) - 2 * P(0, 1) + P(0, 0)), dp3 = std::abs(P(3, 2) - 2 * P(3, 1) + P(3, 0));
    int dq0 = std::abs(Q(0, 2) - 2 * Q(0, 1) + Q(0, 0)), dq3 = std::abs(Q(3, 2) - 2 * Q(3, 1) + Q(3, 0));
    int d = dp0 + dq0 + dp3 + dq3;
    if (d >= beta) return;
    auto dsam = [&](int k, int dpq) {
      return 2 * dpq < (beta >> 2) && std::abs(P(k, 3) - P(k, 0)) + std::abs(Q(k, 0) - Q(k, 3)) < (beta >> 3) &&
             std::abs(P(k, 0) - Q(k, 0)) < ((5 * tc + 1) >> 1);
    };
    bool strong = dsam(0, dp0 + dq0) && dsam(3, dp3 + dq3);
    bool dep = dp0 + dp3 < ((beta + (beta >> 1)) >> 3), deq = dq0 + dq3 < ((beta + (beta >> 1)) >> 3);
    for (int k = 0; k < 4; k++) {
      int p0 = P(k, 0), p1 = P(k, 1), p2 = P(k, 2), p3 = P(k, 3);
      int q0 = Q(k, 0), q1 = Q(k, 1), q2 = Q(k, 2), q3 = Q(k, 3);
      if (strong) {
        int t2 = 2 * tc;
        if (!nop) {
          P(k, 0) = (uint8_t)clip3(p0 - t2, p0 + t2, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
          P(k, 1) = (uint8_t)clip3(p1 - t2, p1 + t2, (p2 + p1 + p0 + q0 + 2) >> 2);
          P(k, 2) = (uint8_t)clip3(p2 - t2, p2 + t2, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
        }
        if (!noq) {
          Q(k, 0) = (uint8_t)clip3(q0 - t2, q0 + t2, (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3);
          Q(k, 1) = (uint8_t)clip3(q1 - t2, q1 + t2, (p0 + q0 + q1 + q2 + 2) >> 2);
          Q(k, 2) = (uint8_t)clip3(q2 - t2, q2 + t2, (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3);
        }
      } else {
        int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
        if (std::abs(delta) >= tc * 10) continue;
        delta = clip3(-tc, tc, delta);
        if (!nop) P(k, 0) = clip8(p0 + delta);
        if (!noq) Q(k, 0) = clip8(q0 - delta);
        if (dep && !nop) P(k, 1) = clip8(p1 + clip3(-(tc >> 1), tc >> 1, (((p2 + p0 + 1) >> 1) - p1 + delta) >> 1));
        if (deq && !noq) Q(k, 1) = clip8(q1 + clip3(-(tc >> 1), tc >> 1, (((q2 + q0 + 1) >> 1) - q1 - delta) >> 1));
      }
    }
  }
  void chroma_edge(int c, int x0, int y0, int dir, int tc, bool nop, bool noq) {
    uint8_t* pl = cur->plane(c);
    int stride = cur->stride(c);
    int xs = dir ? 1 : stride, step = dir ? stride : 1;
    uint8_t* base = pl + (size_t)y0 * stride + x0;
    int len = std::min(4, dir ? cur->w / 2 - x0 : cur->h / 2 - y0);
    for (int k = 0; k < len; k++) {
      uint8_t* q = base + k * xs;
      int p0 = q[-step], p1 = q[-2 * step], q0 = q[0], q1 = q[step];
      int delta = clip3(-tc, tc, ((((q0 - p0) * 4) + p1 - q1 + 4) >> 3));
      if (!nop) q[-step] = clip8(p0 + delta);
      if (!noq) q[0] = clip8(q0 - delta);
    }
  }

  // 8.7.3: SAO of one CTB. Its own samples are taken as they are now (the
  // picture deblocked so far); a neighbouring CTB's as they were when SAO
  // reached it (FFmpeg's sao_pixel_buffer), or as they are now if SAO has
  // not. FFmpeg's rule at slice edges: a sample is left as it is when a
  // neighbour it compares with lies in a CTB of another slice and the
  // sample's own slice has slice_loop_filter_across_slices_enabled_flag 0
  // (the standard looks at the later of the two slices); PCM samples under
  // pcm_loop_filter_disabled_flag and transquant-bypass samples stay as
  // they are.
  std::vector<uint8_t> pre[3];   // samples as SAO found them, in the CTBs it has done
  std::vector<uint8_t> applied;  // by CTB and component: SAO done
  void sao_ctb(int rx, int ry) {
    int addr = ry * s->wctb + rx;
    const SaoParams& P = sao[addr];
    const SliceInfo& si = slices[ctb_slice[addr]];
    for (int c = 0; c < 3; c++) {
      if (!(c ? si.sao_chroma : si.sao_luma) || !P.type[c]) continue;
      int pw = c ? s->width / 2 : s->width, ph = c ? s->height / 2 : s->height;
      int stride = cur->stride(c), sh2 = c ? 1 : 0, ctb = s->ctb >> sh2;
      uint8_t* pl = cur->plane(c);
      int x0 = rx * ctb, y0 = ry * ctb, x1 = std::min(pw, x0 + ctb), y1 = std::min(ph, y0 + ctb);
      for (int y = y0; y < y1; y++)
        memcpy(&pre[c][(size_t)y * stride + x0], &pl[(size_t)y * stride + x0], x1 - x0);
      applied[addr * 3 + c] = 1;  // its own samples: as found
      auto input = [&](int x, int y) {
        int cx = (x << sh2) >> s->ctb_log2, cy = (y << sh2) >> s->ctb_log2;
        bool done = applied[(cy * s->wctb + cx) * 3 + c];
        return (int)(done ? pre[c][(size_t)y * stride + x] : pl[(size_t)y * stride + x]);
      };
      int table[32] = {0};
      if (P.type[c] == 1)
        for (int k = 0; k < 4; k++) table[(k + P.band[c]) & 31] = P.offset[c][k];
      static const int dx[4][2] = {{-1, 1}, {0, 0}, {-1, 1}, {1, -1}};
      static const int dy[4][2] = {{0, 0}, {-1, 1}, {-1, 1}, {-1, 1}};
      int eo = P.eo[c];
      for (int y = y0; y < y1; y++)
        for (int x = x0; x < x1; x++) {
          // FFmpeg's restore_tqb_pixels takes the CTB's luma position with the
          // chroma width and height: chroma samples stay as they are only in
          // the CTB's upper-left quarter (by their luma position)
          if ((cuflags[at4(x << sh2, y << sh2)] & F_NOFILTER) &&
              (!c || ((x << 1) < (x0 << 1) + (x1 - x0) && (y << 1) < (y0 << 1) + (y1 - y0))))
            continue;
          int v = pre[c][(size_t)y * stride + x], o;
          if (P.type[c] == 1) {
            o = table[v >> 3];
          } else {
            int ax = x + dx[eo][0], ay = y + dy[eo][0], bx = x + dx[eo][1], by = y + dy[eo][1];
            if (ax < 0 || ay < 0 || bx < 0 || by < 0 || ax >= pw || bx >= pw || ay >= ph || by >= ph)
              continue;
            if (!si.lf_across) {
              int ca = ((ay << sh2) >> s->ctb_log2) * s->wctb + ((ax << sh2) >> s->ctb_log2);
              int cb = ((by << sh2) >> s->ctb_log2) * s->wctb + ((bx << sh2) >> s->ctb_log2);
              if (ctb_addr_slice[ca] != si.addr || ctb_addr_slice[cb] != si.addr) continue;
            }
            int a = input(ax, ay), b = input(bx, by);
            int sgn = (v > a) - (v < a) + (v > b) - (v < b);
            const int map[5] = {1, 2, 0, 3, 4};
            int e = map[sgn + 2];
            o = e ? P.offset[c][e - 1] : 0;
          }
          pl[(size_t)y * stride + x] = clip8(v + o);
        }
    }
  }
  // FFmpeg's schedule (hevc_filter.c): after each CTB is decoded, the CTB up
  // and left of it is deblocked (ff_hevc_hls_filters, with the last column
  // and row), and each deblocking is followed by SAO of the CTB up and left
  // of that one (ff_hevc_hls_filter), with the last column and row; the
  // last CTB of the picture closes. The deblocking's result is the
  // standard's; what SAO reads of its neighbours is not always.
  void filter_ctb(int rx, int ry, bool sao_on) {
    deblock_ctb(rx, ry);
    if (!sao_on) return;
    bool x_end = rx == s->wctb - 1, y_end = ry == s->hctb - 1;
    if (ry && rx) sao_ctb(rx - 1, ry - 1);
    if (rx && y_end) sao_ctb(rx - 1, ry);
    if (ry && x_end) sao_ctb(rx, ry - 1);
    if (x_end && y_end) sao_ctb(rx, ry);
  }
  void loop_filters() {
    bool sao_on = false;
    for (const SliceInfo& si : slices) sao_on |= si.sao_luma || si.sao_chroma;
    if (sao_on) {
      for (int c = 0; c < 3; c++) pre[c].assign(c ? cur->cb.size() : cur->y.size(), 0);
      applied.assign((size_t)s->wctb * s->hctb * 3, 0);
    }
    int W = s->wctb, H = s->hctb;
    for (int y = 0; y < H; y++)
      for (int x = 0; x < W; x++) {
        bool x_end = x == W - 1, y_end = y == H - 1;
        if (y && x) filter_ctb(x - 1, y - 1, sao_on);
        if (y && x_end) filter_ctb(x, y - 1, sao_on);
        if (x && y_end) filter_ctb(x - 1, y, sao_on);
      }
    filter_ctb(W - 1, H - 1, sao_on);
  }

  // the picture is complete: loop filters, then the DPB holds it
  void finish_picture() {
    if (!cur) return;
    loop_filters();
    cur.reset();
  }
};

}  // namespace
