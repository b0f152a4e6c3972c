// H.264 test streams in MP4 for the port's tests and its smoke run: the
// port reads H.264 (h264.cpp) but, like the JAX package, writes only mp4v,
// so this writer is reachable from io/h264_streams.py alone. Built by
// monohair_tpu_torch/ops/_build.py (g++), called through ctypes.
//
// It drives h264.h's syntax with the bit writer on, so the writer and the
// decoder share their tables and context derivation; every stream it writes
// is therefore held against FFmpeg's decoder (cv2.VideoCapture) in the
// tests, never only against h264.cpp.
//
// Two modes:
// - random: syntax drawn from a seed, every decoded picture of it legal: each
//   macroblock and sub-macroblock type of I, P and B slices, each intra mode
//   the neighbours allow, I_PCM, motion vectors, coefficients (CAVLC escapes
//   and CABAC's Exp-Golomb suffixes), QP deltas, several slices a picture of
//   I, P or B type, reference indices and modifications of both lists, MMCO
//   1-6 and long-term references, explicit weights, spatial and temporal
//   direct prediction, implicit bi-prediction weights, scaling lists, the 8x8
//   transform, the deblocking filter's modes and offsets, cropping; CAVLC or
//   CABAC.
// - frames: BGR frames in, an I/P or I/P/B stream of them out: Intra 16x16
//   (the best of the allowed modes) with residual, P_L0_16x16 from a small
//   integer search around the skip vector (and zero) refined to quarter
//   samples, or P_Skip; in B pictures B_Skip, B_Direct_16x16 or
//   B_L0/L1/Bi_16x16 from the same search around each list's prediction; at
//   a fixed QP.
// B pictures (bframes between anchors) wait in display order until the
// anchor that follows them is coded, then come in decode order: with pyramid
// the middle one first, as a reference. The MP4 (ftyp "isom" or "qt  ",
// mdat, moov with an avc1 or avc3 sample entry and its avcC) can carry a
// rotation in tkhd's matrix, the composition offsets of reordered pictures
// (ctts version 0 or 1) and an edit list.
// The NAL units carry 4-byte lengths, or 1 or 2 (length_size). Options come
// as "key=value;..." (see Options).

#include <cmath>
#include <map>

#include "h264.h"

namespace {

const int kMF[6][3] = {{13107, 5243, 8066}, {11916, 4660, 7490}, {10082, 4194, 6554},
                       {9362, 3647, 5825},  {8192, 3355, 5243},  {7282, 2893, 4559}};

std::vector<uint8_t> nal_unit(int ref_idc, int type, const std::vector<uint8_t>& rbsp) {
  return escape_rbsp({(uint8_t)((ref_idc << 5) | type)}, rbsp);
}

struct Writer {
  Options o;
  Rng rng{0};
  Codec codec;
  FILE* f = nullptr;
  std::string path;
  bool random_mode = true;
  int width = 0, height = 0, mbw = 0, mbh = 0, fps_num = 30, fps_den = 1;
  SPS sps;
  PPS pps;
  std::vector<uint8_t> sps_nal, pps_nal;
  std::vector<uint32_t> sizes, sync;
  uint64_t mdat_start = 0, written = 0;
  int frame = 0, since_reset = 0;  // since_reset: pictures since the last IDR or MMCO 5
  bool prev_nonref = false;
  // B pictures: bframes between anchors, coded after the anchor that follows
  // them (the middle one first, as a reference, with pyramid); frames wait
  // in display order until their group is complete
  int bframes = 0, pyramid = 0;
  std::string direct;  // spatial, temporal or mixed (per slice)
  struct Pending {
    int display;
    std::vector<uint8_t> bgr;
  };
  std::vector<Pending> group;
  int display = 0, reset_display = 0, prev_anchor = 0;  // display indices
  std::vector<int> sample_display;  // each sample's display index (decode order)
  std::string refuse;
  bool ended = false;  // a refused feature was written: no more pictures
  // frames mode: the source picture (coded size, edges replicated)
  Picture src;
  int enc_qp = 24;

  ~Writer() {
    if (f) fclose(f);
  }

  // ------------------------------------------------------------ setup --
  void open(const char* p, int w, int h, int num, int den, const char* opts) {
    path = p;
    o.parse(opts);
    if (w <= 0 || h <= 0 || w > 8192 || h > 8192 || (w & 1) || (h & 1))
      fail("frame size must be even and within 2..8192");
    if (num <= 0 || den <= 0) fail("frame rate out of range");
    width = w;
    height = h;
    fps_num = num;
    fps_den = den;
    random_mode = o.gets("mode", "random") == "random";
    rng = Rng((uint64_t)o.get("seed", 0));
    refuse = o.gets("refuse", "");
    enc_qp = o.get("qp", 24);
    bframes = o.get("bframes", 0);
    pyramid = o.get("pyramid", 0);
    direct = o.gets("direct", "spatial");
    if (bframes < 0 || bframes > 7) fail("bframes must be within 0..7");
    if (direct != "spatial" && direct != "temporal" && direct != "mixed")
      fail("direct must be spatial, temporal or mixed");
    if (bframes && o.get("poc_type", 0) != 0) fail("B pictures out of display order need poc_type 0");
    mbw = (w + 15) / 16;
    mbh = (h + 15) / 16;
    build_sps();
    build_pps();
    f = fopen(p, "wb");
    if (!f) fail(std::string("cannot create ") + p);
    std::vector<uint8_t> head;
    std::string brand = o.get("quicktime", 0) ? "qt  " : "isom";
    put_be(head, brand == "qt  " ? 20 : 24, 4);
    head.insert(head.end(), {'f', 't', 'y', 'p'});
    head.insert(head.end(), brand.begin(), brand.end());
    put_be(head, 0x200, 4);
    head.insert(head.end(), brand.begin(), brand.end());
    if (brand != "qt  ") head.insert(head.end(), {'a', 'v', 'c', '1'});
    put_be(head, 1, 4);
    head.insert(head.end(), {'m', 'd', 'a', 't'});
    put_be(head, 0, 8);  // 64-bit size, patched at release
    if (fwrite(head.data(), 1, head.size(), f) != head.size()) fail("write failed");
    mdat_start = head.size();
  }

  void build_sps() {
    SPS& s = sps;
    bool high = o.get("t8", 0) || o.get("scaling", 0);
    bool cabac = o.get("cabac", 0);
    bool main = cabac || o.get("weighted", 0) || o.get("bframes", 0) || o.get("bslices", 0.0);
    s.profile_idc = high ? 100 : main ? 77 : 66;
    s.constraint_flags = s.profile_idc == 66 ? 0xC0 : 0;
    s.level_idc = 51;
    s.log2_max_frame_num = 4;  // small, so frame_num and the POC lsb wrap
    s.poc_type = o.get("poc_type", 0);
    s.log2_max_poc_lsb = 5;
    if (s.poc_type == 1) {
      s.delta_pic_order_always_zero = rng.range(0, 1);
      s.offset_for_non_ref_pic = 1;
      s.offset_for_top_to_bottom_field = 0;
      s.num_ref_frames_in_poc_cycle = rng.range(1, 3);
      for (int i = 0; i < s.num_ref_frames_in_poc_cycle; i++) s.offset_for_ref_frame[i] = 2;
    }
    s.max_num_ref_frames = o.get("refs", 1);
    s.gaps_allowed = 0;
    s.mbw = mbw;
    s.mbh = mbh;
    s.direct_8x8_inference = o.get("direct8x8", 1);
    int cr = (16 * mbw - width) / 2, cb = (16 * mbh - height) / 2;
    int cl = o.get("crop_left", 0), ct = o.get("crop_top", 0);
    if (cl || ct) {  // a left/top crop inside the same coded size
      cr -= cl;
      cb -= ct;
      if (cr < 0 || cb < 0) fail("crop_left/crop_top larger than the padding");
    }
    s.cropping = cr || cb || cl || ct;
    s.crop[0] = cl;
    s.crop[1] = cr;
    s.crop[2] = ct;
    s.crop[3] = cb;
    if (high) {
      s.chroma_format_idc = 1;
      s.scaling_matrix_present = o.get("scaling", 0) & 1;  // bit 0: the SPS's lists
      if (s.scaling_matrix_present) random_lists(s.list_present, s.use_default, s.lists, 8);
    }
    s.vui_present = o.get("full_range", 0) || o.get("matrix", -1) >= 0 ||
                    o.get("reorder", -1) >= 0 || o.get("hrd", 0);
    if (s.vui_present) {
      s.aspect_info = 1;
      s.aspect_idc = 255;
      s.sar_w = 1;
      s.sar_h = 1;
      s.signal_type = 1;
      s.video_format = 5;
      s.full_range = o.get("full_range", 0);
      s.colour_desc = o.get("matrix", -1) >= 0;
      s.primaries = o.get("primaries", o.get("matrix", 2));
      s.transfer = o.get("transfer", o.get("matrix", 2));
      s.matrix = o.get("matrix", 2);
      s.chroma_loc = 1;
      s.timing = 1;
      s.units_in_tick = (uint32_t)fps_den;
      s.time_scale = (uint32_t)(2 * fps_num);
      s.fixed_rate = 1;
      s.nal_hrd = s.vcl_hrd = o.get("hrd", 0);
      s.low_delay_hrd = 0;
      s.pic_struct = o.get("hrd", 0);
      s.restriction = o.get("reorder", -1) >= 0;
      s.num_reorder = std::max(0, o.get("reorder", 0));
      s.max_dec_buffering = std::max(std::max(s.max_num_ref_frames, 1), s.num_reorder);
    }
    if (refuse == "chroma422" || refuse == "bit_depth10" || refuse == "transform_bypass")
      s.profile_idc = 122;
    if (refuse == "chroma422") s.chroma_format_idc = 2;
    if (refuse == "bit_depth10") s.bit_depth_luma = s.bit_depth_chroma = 10;
    if (refuse == "transform_bypass") { s.profile_idc = 244; s.qpprime_bypass = 1; }
    if (refuse == "fields") s.frame_mbs_only = 0;
    sps_nal = param_nal(7);
  }

  void random_lists(int* present, int* use_default, uint8_t (*lists)[64], int n) {
    for (int i = 0; i < n; i++) {
      present[i] = rng.chance(0.6);
      use_default[i] = present[i] && rng.chance(0.25);
      int len = i < 6 ? 16 : 64;
      int base = rng.range(6, 24);
      for (int k = 0; k < len; k++) {
        // rising with the scan position, with a flat tail now and then
        int v = base + (k * rng.range(0, 24)) / len + rng.range(-2, 2);
        lists[i][k] = (uint8_t)clip3(4, 48, v);
      }
      if (rng.chance(0.3)) {
        int from = rng.range(1, len - 1);
        for (int k = from; k < len; k++) lists[i][k] = lists[i][from - 1];
      }
    }
  }

  void build_pps() {
    PPS& p = pps;
    p.sps_id = sps.id;
    p.cabac = o.get("cabac", 0);
    p.num_ref_idx_default[0] = 1;
    p.weighted_pred = o.get("weighted", 0);
    p.weighted_bipred_idc = o.get("bipred_idc", 0);
    if (p.weighted_bipred_idc < 0 || p.weighted_bipred_idc > 2) fail("bipred_idc must be 0, 1 or 2");
    p.pic_init_qp = random_mode ? 26 : enc_qp;
    p.cb_qp_offset = random_mode ? rng.range(-4, 4) : 0;
    p.cr_qp_offset = p.cb_qp_offset;
    p.deblocking_control = o.get("deblock", 0) ? 1 : 0;
    p.constrained_intra_pred = o.get("constrained_intra", 0);
    p.redundant_pic_cnt_present = refuse == "redundant";
    p.has_ext = sps.profile_idc == 100;
    if (p.has_ext) {
      p.transform_8x8 = o.get("t8", 0);
      p.scaling_matrix_present = (o.get("scaling", 0) >> 1) & 1;  // bit 1: the PPS's
      if (p.scaling_matrix_present) random_lists(p.list_present, p.use_default, p.lists, 6 + 2 * p.transform_8x8);
      p.cr_qp_offset = random_mode ? rng.range(-4, 4) : 0;
      if (o.get("equal_chroma_offsets", 0)) p.cr_qp_offset = p.cb_qp_offset;
    }
    if (refuse == "slice_groups") p.num_slice_groups = 2;
    pps_nal = param_nal(8);
  }

  // an SPS or PPS NAL unit; a refused feature is written up to the syntax
  // element that shows it, where the decoder stops, and the stream ends there
  std::vector<uint8_t> param_nal(int type) {
    Bits b;
    b.start_write();
    try {
      if (type == 7) {
        sps_syntax(b, sps);
        codec.sps[sps.id] = sps;
      } else {
        pps_syntax(b, pps, codec.sps);
        codec.pps[pps.id] = pps;
      }
    } catch (const Error& e) {
      if (e.code != 2 || refuse.empty()) throw;
      ended = true;
      if (type == 7) {  // the PPS that follows still names it
        sps.valid = true;
        codec.sps[sps.id] = sps;
      }
    }
    b.trailing();
    return nal_unit(3, type, b.out);
  }

  // --------------------------------------------------------- pictures --
  // one frame in display order: coded now (no B pictures, or an IDR), or
  // when its group of bframes + 1 is complete
  void write(const uint8_t* bgr) {
    if (ended && !(frame == 0 && param_refusal())) return;
    if (!random_mode && !bgr) fail("frames mode needs a frame");
    int idr_period = o.get("idr_period", 0);
    int d = display++;
    if (!bframes) {
      code_picture(d, bgr, frame == 0 || (idr_period && frame % idr_period == 0) ? 'I' : 'A');
      return;
    }
    if (d == 0 || (idr_period && d % idr_period == 0)) {
      flush_group();
      code_picture(d, bgr, 'I');
      return;
    }
    group.push_back({d, bgr ? std::vector<uint8_t>(bgr, bgr + (size_t)width * height * 3)
                            : std::vector<uint8_t>()});
    if ((int)group.size() == bframes + 1) flush_group();
  }
  // the group's last frame as the anchor, then its B pictures: with pyramid
  // the middle one first (a reference), then the others in display order
  void flush_group() {
    if (group.empty()) return;
    std::vector<Pending> g;
    g.swap(group);
    auto data = [](const Pending& q) { return q.bgr.empty() ? nullptr : q.bgr.data(); };
    code_picture(g.back().display, data(g.back()), 'A');
    int nb = (int)g.size() - 1, mid = pyramid && nb >= 2 ? nb / 2 : -1;
    if (mid >= 0) code_picture(g[mid].display, data(g[mid]), 'b');
    for (int k = 0; k < nb; k++)
      if (k != mid) code_picture(g[k].display, data(g[k]), 'B');
  }
  // role: I an IDR picture, A an anchor (I every gop frames, else P), B a
  // non-reference B picture, b a reference one
  void code_picture(int d, const uint8_t* bgr, char role) {
    if (!random_mode) load_source(bgr);
    int gop = o.get("gop", random_mode ? 4 : 2);
    bool idr = role == 'I', bpic = role == 'B' || role == 'b';
    bool intra_pic = idr || o.get("intra_only", 0);
    if (role == 'A')
      intra_pic |= gop > 0 && (bframes ? d / gop != prev_anchor / gop : frame % gop == 0);
    if (role == 'I' || role == 'A') prev_anchor = d;
    std::vector<uint8_t> sample;
    int ls = length_size();
    auto append = [&](const std::vector<uint8_t>& n) {
      if (ls < 4 && n.size() >= (1u << (8 * ls))) fail("NAL unit too long for length_size");
      put_be(sample, n.size(), ls);
      sample.insert(sample.end(), n.begin(), n.end());
    };
    bool inband = o.get("avc3", 0) || o.get("inband", 0);
    if (frame == 0 && param_refusal()) {
      // the refused parameter set travels in band before the first picture
      append(sps_nal);
      append(pps_nal);
      finish_sample(sample, true, d);
      ended = true;
      frame++;
      return;
    }
    if (idr && inband) {
      append(sps_nal);
      append(pps_nal);
    }
    if (refuse == "partitioning" && frame == 1) {
      std::vector<uint8_t> part = {0x12, 0x34, 0x80};
      append(nal_unit(2, 2, part));
      finish_sample(sample, false, d);
      ended = true;
      return;
    }
    SliceHeader h;
    h.nal_type = idr ? 5 : 1;
    if (bpic) {
      h.nal_ref_idc = role == 'B' ? 0 : random_mode ? rng.range(1, 3) : 2;
    } else {
      bool nonref = !idr && random_mode && rng.chance(o.getf("nonref", 0.0)) && !prev_nonref;
      h.nal_ref_idc = nonref ? 0 : random_mode ? rng.range(1, 3) : 3;
      prev_nonref = nonref;
    }
    int mfn = 1 << sps.log2_max_frame_num;
    // a gap: the decoder sees frame_num skip one value (the writer's own state moves on)
    if (refuse == "frame_num_gap" && frame == 2) codec.prev_ref_frame_num = (codec.prev_ref_frame_num + 1) % mfn;
    h.frame_num = idr ? 0 : (codec.prev_ref_frame_num + 1) % mfn;
    if (idr) { since_reset = 0; reset_display = d; }
    h.idr_pic_id = idr ? ((bframes ? d : frame) / std::max(1, o.get("idr_period", 0))) % 4 : 0;
    int poc = bframes ? 2 * (d - reset_display) : 2 * since_reset;
    h.poc_lsb = poc % (1 << sps.log2_max_poc_lsb);
    if (h.nal_ref_idc) choose_marking(h, idr);
    int nslices = random_mode ? rng.range(1, std::max(1, o.get("slices", 1))) : 1;
    int n = mbw * mbh;
    std::vector<int> starts = {0};
    for (int k = 1; k < nslices; k++) starts.push_back(rng.range(1, n - 1));
    std::sort(starts.begin(), starts.end());
    starts.erase(std::unique(starts.begin(), starts.end()), starts.end());
    bool refused_slice = refuse == "sp_slice" || refuse == "si_slice" || refuse == "redundant";
    double bslices = o.getf("bslices", 0.0), pslices = o.getf("pslices", 0.0);
    for (size_t k = 0; k < starts.size(); k++) {
      SliceHeader sh = h;
      sh.first_mb = starts[k];
      int end = k + 1 < starts.size() ? starts[k + 1] : n;
      bool islice = intra_pic || (random_mode && rng.chance(0.1));
      int type = islice ? 2 : bpic ? 1 : 0;
      // mixed slice types: P slices in B pictures, B slices in P pictures
      if (!islice && random_mode && bpic && pslices > 0 && rng.chance(pslices)) type = 0;
      if (!islice && random_mode && !bpic && bslices > 0 && rng.chance(bslices)) type = 1;
      sh.slice_type = type;
      if (refused_slice && frame == 1) {
        sh.slice_type = refuse == "sp_slice" ? 3 : refuse == "si_slice" ? 4 : 0;
        if (refuse == "redundant") sh.redundant_pic_cnt = 1;
      }
      sh.type = sh.slice_type % 5;
      choose_slice(sh);
      Bits& b = codec.bits;
      b.start_write();
      const SPS* s;
      const PPS* p;
      try {
        slice_header_syntax(b, sh, codec.sps, codec.pps, s, p);
      } catch (const Error& e) {
        if (e.code != 2 || refuse.empty()) throw;
        b.trailing();
        append(nal_unit(sh.nal_ref_idc, sh.nal_type, b.out));
        finish_sample(sample, false, d);
        ended = true;
        return;
      }
      codec.sh = sh;
      codec.s = s;
      codec.p = p;
      if (k == 0) codec.start_picture();
      codec.start_slice();
      codec.slice_end_addr = end;
      codec.choose = [this](Mb& m) { random_mode ? choose_random(m) : choose_encode(m); };
      codec.slice_data();
      append(nal_unit(sh.nal_ref_idc, sh.nal_type, b.out));
    }
    codec.finish_picture();
    codec.ready.clear();
    since_reset = codec.prev_mmco5 ? 1 : since_reset + 1;
    frame++;
    finish_sample(sample, idr, d);
  }
  int length_size() const {
    int n = o.get("length_size", 4);
    if (n != 1 && n != 2 && n != 4) fail("length_size must be 1, 2 or 4");
    return n;
  }
  bool param_refusal() const {
    return refuse == "chroma422" || refuse == "bit_depth10" || refuse == "transform_bypass" ||
           refuse == "fields" || refuse == "slice_groups";
  }

  void finish_sample(const std::vector<uint8_t>& sample, bool key, int d) {
    if (fwrite(sample.data(), 1, sample.size(), f) != sample.size()) fail("write failed");
    written += sample.size();
    sizes.push_back((uint32_t)sample.size());
    sample_display.push_back(d);
    if (key) sync.push_back((uint32_t)sizes.size());
  }

  // dec_ref_pic_marking( ): IDR long-term, or MMCOs legal in the current DPB
  void choose_marking(SliceHeader& h, bool idr) {
    h.mmcos.clear();
    h.adaptive = 0;
    h.long_term_ref = 0;
    bool lt = o.get("mmco", 0);
    if (idr) {
      h.long_term_ref = lt && rng.chance(o.getf("idr_long", 0.3));
      return;
    }
    std::vector<PicPtr> st, ltp;
    for (const PicPtr& r : codec.dpb) {
      if (r->ref_short) st.push_back(r);
      if (r->ref_long) ltp.push_back(r);
    }
    if (st.empty() && !ltp.empty() && (int)ltp.size() >= std::max(1, sps.max_num_ref_frames)) {
      // the sliding window needs a short-term picture: free a long-term one
      Mmco m, end;
      m.op = 2;
      m.lt_pic_num = ltp[0]->long_idx;
      end.op = 0;
      h.adaptive = 1;
      h.mmcos = {m, end};
      return;
    }
    if (!lt || !rng.chance(0.5)) return;
    int maxl = codec.max_long_idx;
    int cur_num = h.frame_num, mfn = 1 << sps.log2_max_frame_num;
    auto pic_num = [&](const Picture& r) { return r.frame_num > cur_num ? r.frame_num - mfn : r.frame_num; };
    std::vector<bool> st_used(st.size(), false);
    bool cur_long = false;
    int nops = rng.range(1, 3);
    for (int k = 0; k < nops; k++) {
      int op = rng.range(1, 6);
      if (op == 5 && !rng.chance(0.3)) op = 4;
      // POCs restart: no B pictures around it, no B slices after it
      if (op == 5 && (bframes || o.getf("bslices", 0.0) > 0)) op = 4;
      Mmco m;
      m.op = op;
      if (op == 1 || op == 3) {
        std::vector<int> free;
        for (size_t i = 0; i < st.size(); i++)
          if (!st_used[i]) free.push_back((int)i);
        if (free.empty()) continue;
        int i = free[rng.range(0, (int)free.size() - 1)];
        st_used[i] = true;
        m.diff = cur_num - pic_num(*st[i]) - 1;
        if (op == 3) {
          if (maxl < 0) continue;
          m.lt_idx = rng.range(0, maxl);
        }
      } else if (op == 2) {
        if (ltp.empty()) continue;
        m.lt_pic_num = ltp[rng.range(0, (int)ltp.size() - 1)]->long_idx;
        bool dup = false;
        for (const Mmco& q : h.mmcos) dup |= (q.op == 2 && q.lt_pic_num == m.lt_pic_num) || q.op == 3 || q.op == 4;
        if (dup) continue;
      } else if (op == 4) {
        m.max_lt_plus1 = rng.range(0, std::max(1, sps.max_num_ref_frames));
        bool later = false;
        for (const Mmco& q : h.mmcos) later |= q.op == 2 || q.op == 3 || q.op == 6;
        if (later) continue;
        maxl = m.max_lt_plus1 - 1;
      } else if (op == 5) {
        h.mmcos.clear();
        h.mmcos.push_back(m);
        break;
      } else if (op == 6) {
        if (maxl < 0 || cur_long) continue;
        m.lt_idx = rng.range(0, maxl);
        cur_long = true;
      }
      h.mmcos.push_back(m);
    }
    if (h.mmcos.empty()) return;
    // the marking must leave room for the current picture
    h.adaptive = 1;
    if (!simulate_fits(h)) {
      h.mmcos.clear();
      h.adaptive = 0;
      return;
    }
    Mmco end;
    end.op = 0;
    h.mmcos.push_back(end);
  }
  // whether MMCOs leave at most max_num_ref_frames references with the current one
  bool simulate_fits(const SliceHeader& h) {
    int cur_num = h.frame_num, mfn = 1 << sps.log2_max_frame_num;
    std::vector<std::pair<bool, bool>> refs;  // short, long
    std::vector<int> nums, idx;
    for (const PicPtr& r : codec.dpb) {
      refs.push_back({r->ref_short, r->ref_long});
      nums.push_back(r->frame_num > cur_num ? r->frame_num - mfn : r->frame_num);
      idx.push_back(r->long_idx);
    }
    int maxl = codec.max_long_idx;
    for (const Mmco& m : h.mmcos) {
      if (m.op == 1 || m.op == 3) {
        int x = cur_num - (m.diff + 1);
        int hit = -1;
        for (size_t i = 0; i < refs.size(); i++)
          if (refs[i].first && nums[i] == x) hit = (int)i;
        if (hit < 0) return false;
        if (m.op == 1) refs[hit].first = false;
        else {
          if (m.lt_idx > maxl) return false;
          for (size_t i = 0; i < refs.size(); i++)
            if (refs[i].second && idx[i] == m.lt_idx) refs[i].second = false;
          refs[hit] = {false, true};
          idx[hit] = m.lt_idx;
        }
      } else if (m.op == 2) {
        bool hit = false;
        for (size_t i = 0; i < refs.size(); i++)
          if (refs[i].second && idx[i] == m.lt_pic_num) { refs[i].second = false; hit = true; }
        if (!hit) return false;
      } else if (m.op == 4) {
        maxl = m.max_lt_plus1 - 1;
        for (size_t i = 0; i < refs.size(); i++)
          if (refs[i].second && idx[i] > maxl) refs[i].second = false;
      } else if (m.op == 5) {
        return true;
      } else if (m.op == 6) {
        if (m.lt_idx > maxl) return false;
        for (size_t i = 0; i < refs.size(); i++)
          if (refs[i].second && idx[i] == m.lt_idx) refs[i].second = false;
      }
    }
    int n = 1;
    for (auto& r : refs) n += r.first || r.second;
    return n <= std::max(1, sps.max_num_ref_frames);
  }

  // the slice's QP, deblocking, CABAC table, reference lists and weights
  void choose_slice(SliceHeader& sh) {
    sh.direct_spatial = direct == "spatial" || (direct == "mixed" && rng.chance(0.5));
    if (!random_mode) {
      sh.qp_delta = 0;
      sh.num_ref_idx_active[0] = sh.num_ref_idx_active[1] = 1;
      sh.override = pps.num_ref_idx_default[0] != 1;
      sh.cabac_init_idc = 0;
      return;
    }
    sh.qp_delta = rng.range(-14, 10);
    sh.cabac_init_idc = rng.range(0, 2);
    if (pps.deblocking_control) {
      sh.disable_deblock = rng.range(0, 2);
      sh.alpha_div2 = rng.range(-6, 6);
      sh.beta_div2 = rng.range(-6, 6);
    }
    if (sh.type == 2) return;
    int nref = 0;
    for (const PicPtr& r : codec.dpb) nref += r->is_ref();
    if (nref == 0) fail("internal: an inter slice without references");
    bool differ = false;
    for (int l = 0; l < sh.lists(); l++) {
      sh.num_ref_idx_active[l] = rng.range(1, std::min(nref, 8));
      differ |= sh.num_ref_idx_active[l] != pps.num_ref_idx_default[l];
    }
    sh.override = differ || rng.chance(0.2);
    if (!sh.override)
      for (int l = 0; l < sh.lists(); l++) sh.num_ref_idx_active[l] = pps.num_ref_idx_default[l];
    for (int l = 0; l < sh.lists(); l++) {
      sh.mods[l].clear();
      sh.ref_mod_flag[l] = 0;
      if (!rng.chance(0.6)) continue;
      sh.ref_mod_flag[l] = 1;
      int mfn = 1 << sps.log2_max_frame_num, pred = sh.frame_num;
      int nm = rng.range(0, std::min(3, sh.num_ref_idx_active[l]));
      for (int k = 0; k < nm; k++) {
        const PicPtr& r = codec.dpb[rng.range(0, (int)codec.dpb.size() - 1)];
        RefMod m;
        if (r->ref_long) {
          m.idc = 2;
          m.val = r->long_idx;
        } else {
          int num = r->frame_num > sh.frame_num ? r->frame_num - mfn : r->frame_num;
          int target = ((num % mfn) + mfn) % mfn;
          if (rng.chance(0.5)) {
            int d = ((pred - target) % mfn + mfn) % mfn;
            m.idc = 0;
            m.val = (d ? d : mfn) - 1;
          } else {
            int d = ((target - pred) % mfn + mfn) % mfn;
            m.idc = 1;
            m.val = (d ? d : mfn) - 1;
          }
          pred = target;
        }
        sh.mods[l].push_back(m);
      }
      sh.mods[l].push_back(RefMod());
    }
    // a long-term reference as the co-located picture, when one is held
    std::vector<PicPtr> longs;
    for (const PicPtr& r : codec.dpb)
      if (r->ref_long) longs.push_back(r);
    double ltcol = o.getf("ltcol", 0.0);
    if (sh.type == 1 && !longs.empty() && ltcol > 0 && rng.chance(ltcol)) {
      RefMod m;
      m.idc = 2;
      m.val = longs[rng.range(0, (int)longs.size() - 1)]->long_idx;
      sh.ref_mod_flag[1] = 1;
      sh.mods[1] = {m, RefMod()};
    }
    bool bi = sh.type == 1;
    if ((pps.weighted_pred && !bi) || (pps.weighted_bipred_idc == 1 && bi)) {
      sh.luma_log2_wd = rng.range(0, 7);
      sh.chroma_log2_wd = rng.range(0, 7);
      // |v * w| + |o| << denom stays inside 16 bits, as FFmpeg's SIMD needs;
      // for two lists the sum of both (its biweight takes signed byte weights)
      int wmax = bi ? 48 : 64;
      auto omax = [&](int wd) { return bi ? std::min(127, (4000 >> wd) - 2) : std::min(127, 8000 >> wd); };
      for (int l = 0; l < sh.lists(); l++)
        for (int i = 0; i < sh.num_ref_idx_active[l]; i++) {
          sh.luma_flag[l][i] = rng.chance(0.7);
          sh.luma_w[l][i] = rng.range(-wmax, wmax);
          sh.luma_o[l][i] = rng.range(-omax(sh.luma_log2_wd), omax(sh.luma_log2_wd));
          sh.chroma_flag[l][i] = rng.chance(0.6);
          for (int c = 0; c < 2; c++) {
            sh.chroma_w[l][i][c] = rng.range(-wmax, wmax);
            sh.chroma_o[l][i][c] = rng.range(-omax(sh.chroma_log2_wd), omax(sh.chroma_log2_wd));
          }
        }
    }
  }

  // ------------------------------------------------- random syntax --
  int pick(const std::vector<int>& v) { return v[rng.range(0, (int)v.size() - 1)]; }
  std::vector<int> allowed_nxn(bool L, bool T, bool TL) {
    std::vector<int> v = {2};
    if (T) { v.push_back(0); v.push_back(3); v.push_back(7); }
    if (L) { v.push_back(1); v.push_back(8); }
    if (T && L && TL) { v.push_back(4); v.push_back(5); v.push_back(6); }
    return v;
  }
  int new_qp_delta() {
    if (!rng.chance(0.3)) return 0;
    int lo = std::max(-26, 8 - codec.qp), hi = std::min(25, 38 - codec.qp);
    return lo > hi ? 0 : rng.range(std::max(lo, -6), std::min(hi, 6));
  }
  int16_t random_level() {
    int r = rng.range(0, 99), v;
    if (r < 65) v = 1;
    else if (r < 85) v = rng.range(2, 3);
    else if (r < 97) v = rng.range(4, 15);
    else v = rng.range(16, 60);
    return (int16_t)(rng.chance(0.5) ? -v : v);
  }
  void random_block(int16_t* c, int first, int max, bool need_one) {
    for (int i = 0; i < max; i++) c[first + i] = 0;
    int r = rng.range(0, 9);
    int n = r < 2 ? 0 : r < 7 ? rng.range(1, 3) : rng.range(1, max);
    if (need_one && !n) n = 1;
    for (int k = 0; k < n; k++) {
      // low frequencies more often
      int i = std::min(max - 1, (int)(rng.range(0, max - 1) * (rng.chance(0.6) ? 0.4 : 1.0)));
      c[first + i] = random_level();
    }
  }
  void choose_random(Mb& m) {
    bool islice = codec.sh.type == 2;
    if (!islice && rng.chance(0.25)) {
      m.skip = 1;
      return;
    }
    if (islice || rng.chance(0.15)) choose_intra(m, islice);
    else if (codec.sh.type == 0) choose_inter(m);
    else choose_inter_b(m);
  }
  void choose_intra(Mb& m, bool islice) {
    Codec& c = codec;
    int r = rng.range(0, 99);
    bool t8 = c.p->transform_8x8;
    int pcm = (int)(o.getf("pcm", 0.03) * 100);
    m.kind = r < pcm ? IPCM : (t8 && r < 40) ? I8 : r < 65 ? I4 : I16;
    bool L = c.intra_ok(c.mbx - 1, c.mby), T = c.intra_ok(c.mbx, c.mby - 1),
         TL = c.intra_ok(c.mbx - 1, c.mby - 1);
    int base = islice ? 0 : codec.sh.type == 0 ? 5 : 23;
    if (m.kind == IPCM) {
      m.mb_type = base + 25;
      for (int k = 0; k < 384; k++) m.pcm[k] = (uint8_t)rng.range(1, 255);
      return;
    }
    std::vector<int> cm = {0};
    if (L) cm.push_back(1);
    if (T) cm.push_back(2);
    if (L && T && TL) cm.push_back(3);
    m.cmode = pick(cm);
    int cbpc = rng.range(0, 2);
    if (m.kind == I16) {
      std::vector<int> modes = {2};
      if (T) modes.push_back(0);
      if (L) modes.push_back(1);
      if (L && T && TL) modes.push_back(3);
      m.i16 = pick(modes);
      int luma = rng.chance(0.5);
      m.mb_type = base + 1 + m.i16 + 4 * cbpc + 12 * luma;
      m.cbp = (luma ? 15 : 0) | cbpc << 4;
    } else {
      m.mb_type = base;
      m.t8 = m.kind == I8;
      int n = m.kind == I8 ? 4 : 16;
      for (int k = 0; k < n; k++) {
        int bx, by;
        if (n == 16) { bx = kBlkRaster[k] & 3; by = kBlkRaster[k] >> 2; }
        else { bx = (k & 1) * 2; by = (k >> 1) * 2; }
        bool l, t, tl, tr;
        c.intra_avail(bx, by, n == 16 ? 4 : 8, l, t, tl, tr);
        m.ipred[k] = pick(allowed_nxn(l, t, tl));
      }
      m.cbp = rng.range(0, 15) | cbpc << 4;
    }
    m.qp_delta = new_qp_delta();
    random_levels(m, true);
  }
  // a random vector for a partition of the macroblock, within 12 samples
  // of the picture
  int random_mv(int j, int l) {
    Codec& c = codec;
    MbInfo* a = c.mbA();
    int lim = j ? 16 * mbh : 16 * mbw, pos = j ? 16 * c.mby : 16 * c.mbx;
    int lo = (-12 - pos) * 4, hi = (lim + 12 - pos - 16) * 4;
    int v;
    if (a && !a->intra && rng.chance(0.4)) v = a->mv[l][0][j] + rng.range(-3, 3);
    else if (rng.chance(0.5)) v = rng.range(-20, 20);
    else v = rng.range(std::max(lo, -256), std::min(hi, 256));
    return clip3(lo, hi, v);
  }
  void choose_inter(Mb& m) {
    Codec& c = codec;
    int nref = 0;
    for (const PicPtr& r : c.list[0]) nref += r != nullptr;
    int r = rng.range(0, 99);
    int t = r < 35 ? 0 : r < 50 ? 1 : r < 65 ? 2 : 3;
    if (t == 3 && !c.p->cabac && rng.chance(0.25)) t = 4;  // P_8x8ref0
    m.mb_type = t;
    int np = t == 0 ? 1 : t < 3 ? 2 : 4;
    bool small = false;
    for (int k = 0; k < 4; k++) {
      m.ref[0][k] = rng.range(0, nref - 1);
      m.sub[k] = t >= 3 ? rng.range(0, 3) : 0;
      small |= m.sub[k] != 0;
    }
    // partitions 0..np-1; sub-macroblock k's sub-partitions at 4 k + j
    for (int k = 0; k < np; k++) {
      int n = t >= 3 ? kSubParts[m.sub[k]][0] : 1;
      for (int i = 0; i < n; i++)
        for (int j = 0; j < 2; j++) m.mv[0][t >= 3 ? 4 * k + i : k][j] = random_mv(j, 0);
    }
    m.cbp = rng.range(0, 15) | rng.range(0, 2) << 4;
    if (rng.chance(0.2)) m.cbp = 0;
    m.t8 = c.p->transform_8x8 && (m.cbp & 15) && !small && rng.chance(0.5);
    m.kind = t == 0 ? P16x16 : t == 1 ? P16x8 : t == 2 ? P8x16 : P8x8;
    m.qp_delta = (m.cbp) ? new_qp_delta() : 0;
    random_levels(m, false);
  }
  // a B macroblock: B_Direct_16x16, the 16x16/16x8/8x16 types of every list
  // pairing, or B_8x8 with any sub_mb_type (B_Direct_8x8 among them)
  void choose_inter_b(Mb& m) {
    Codec& c = codec;
    int n[2] = {(int)c.list[0].size(), (int)c.list[1].size()};
    int r = rng.range(0, 99);
    int t = r < 10 ? 0 : r < 35 ? rng.range(1, 3) : r < 70 ? rng.range(4, 21) : 22;
    m.mb_type = t;
    bool infer = c.s->direct_8x8_inference != 0;
    bool small = t == 0 && !infer;
    for (int k = 0; k < 4; k++) {
      m.sub[k] = t == 22 ? rng.range(0, 12) : 0;
      if (t == 22) small |= m.sub[k] == 0 ? !infer : kBSubParts[m.sub[k]][0] > 1;
      for (int l = 0; l < 2; l++) m.ref[l][k] = rng.range(0, n[l] - 1);
    }
    for (int l = 0; l < 2; l++)
      for (int k = 0; k < 16; k++)
        for (int j = 0; j < 2; j++) m.mv[l][k][j] = random_mv(j, l);
    m.cbp = rng.range(0, 15) | rng.range(0, 2) << 4;
    if (rng.chance(0.2)) m.cbp = 0;
    m.t8 = c.p->transform_8x8 && (m.cbp & 15) && !small && rng.chance(0.5);
    m.kind = t == 22 ? P8x8 : kBTypes[t][0];
    m.qp_delta = (m.cbp) ? new_qp_delta() : 0;
    random_levels(m, false);
  }
  // coefficients for the coded blocks, kept small enough that every
  // transform stays inside 16 bits (FFmpeg's SIMD)
  void random_levels(Mb& m, bool intra) {
    memset(m.luma, 0, sizeof m.luma);
    memset(m.luma8, 0, sizeof m.luma8);
    memset(m.dc, 0, sizeof m.dc);
    memset(m.cdc, 0, sizeof m.cdc);
    memset(m.cac, 0, sizeof m.cac);
    int cbpl = m.cbp & 15, cbpc = m.cbp >> 4;
    bool cab = codec.p->cabac;
    for (int attempt = 0; attempt < 4; attempt++) {
      if (m.kind == I16) {
        random_block(m.dc, 0, 16, false);
        for (int k = 0; k < 16; k++) {
          if (cbpl) random_block(m.luma[k], 1, 15, false);
          else for (int i = 0; i < 16; i++) m.luma[k][i] = 0;
        }
      } else {
        for (int b8 = 0; b8 < 4; b8++) {
          bool coded = (cbpl >> b8) & 1;
          if (m.t8) {
            for (int i = 0; i < 64; i++) m.luma8[b8][i] = 0;
            if (coded) random_block(m.luma8[b8], 0, 64, cab);
          } else {
            for (int b4 = 0; b4 < 4; b4++) {
              if (coded) random_block(m.luma[b8 * 4 + b4], 0, 16, false);
              else for (int i = 0; i < 16; i++) m.luma[b8 * 4 + b4][i] = 0;
            }
          }
        }
      }
      for (int ch = 0; ch < 2; ch++) {
        if (cbpc) random_block(m.cdc[ch], 0, 4, false);
        else for (int i = 0; i < 4; i++) m.cdc[ch][i] = 0;
        for (int k = 0; k < 4; k++) {
          if (cbpc == 2) random_block(m.cac[ch][k], 1, 15, false);
          else for (int i = 0; i < 16; i++) m.cac[ch][k][i] = 0;
        }
      }
      if (safe(m, intra)) return;
    }
    // smaller levels: +-1, then at most one a block (safe at any QP)
    for (int keep = 16; keep >= 1; keep = keep > 1 ? 1 : 0) {
      auto thin = [&](int16_t* c, int n) {
        int kept = 0;
        for (int i = 0; i < n; i++)
          if (c[i]) c[i] = kept++ < keep ? (c[i] > 0 ? 1 : -1) : 0;
      };
      for (int k = 0; k < 16; k++) thin(m.luma[k], 16);
      for (int k = 0; k < 4; k++) thin(m.luma8[k], 64);
      thin(m.dc, 16);
      for (int ch = 0; ch < 2; ch++) {
        thin(m.cdc[ch], 4);
        for (int k = 0; k < 4; k++) thin(m.cac[ch][k], 16);
      }
      if (safe(m, intra)) return;
    }
    fail("internal: no safe coefficients at this QP");
  }
  bool block_ok(const int* d, int n) {
    long s = 0;
    for (int i = 0; i < n; i++) s += std::abs(d[i]);
    return s <= 8000;
  }
  bool safe(const Mb& m, bool intra) {
    Codec& c = codec;
    int q = (c.qp + m.qp_delta + 52) % 52, d[64];
    int cbpl = m.cbp & 15, cbpc = m.cbp >> 4;
    if (m.kind == I16) {
      int s = 0;
      for (int k = 0; k < 16; k++) s += std::abs(m.dc[k]);
      int ls = c.ls4[0][q % 6][0];
      long dcmax = q >= 36 ? ((long)s * ls) << (q / 6 - 6) : ((long)s * ls + (1 << (5 - q / 6))) >> (6 - q / 6);
      if (dcmax > 4000) return false;
      for (int k = 0; k < 16; k++) {
        c.scale4(m.luma[k], 0, q, (int)dcmax, d);
        if (!block_ok(d, 16)) return false;
      }
    } else if (m.t8) {
      for (int b8 = 0; b8 < 4; b8++)
        if ((cbpl >> b8) & 1) {
          c.scale8(m.luma8[b8], intra ? 0 : 1, q, d);
          if (!block_ok(d, 64)) return false;
        }
    } else {
      for (int k = 0; k < 16; k++) {
        c.scale4(m.luma[k], intra ? 0 : 3, q, kNoDc, d);
        if (!block_ok(d, 16)) return false;
      }
    }
    if (cbpc)
      for (int ch = 0; ch < 2; ch++) {
        int qc = c.chroma_qp(ch, q), list = (intra ? 1 : 4) + ch, s = 0;
        for (int k = 0; k < 4; k++) s += std::abs(m.cdc[ch][k]);
        long dcmax = ((long)s * c.ls4[list][qc % 6][0] << (qc / 6)) >> 5;
        if (dcmax > 4000) return false;
        for (int k = 0; k < 4; k++) {
          c.scale4(m.cac[ch][k], list, qc, (int)dcmax, d);
          if (!block_ok(d, 16)) return false;
        }
      }
    return true;
  }

  // ---------------------------------------------------- frames mode --
  void load_source(const uint8_t* bgr) {
    src.alloc(16 * mbw, 16 * mbh);
    int W = 16 * mbw, H = 16 * mbh;
    // BT.601 limited range, as FFmpeg's swscale converts BGR24 for an encoder
    for (int y = 0; y < H; y++) {
      const uint8_t* row = bgr + (size_t)std::min(y, height - 1) * width * 3;
      for (int x = 0; x < W; x++) {
        const uint8_t* px = row + 3 * std::min(x, width - 1);
        src.plane(0)[y * W + x] = clip8((int)std::lround(16 + (65.481 * px[2] + 128.553 * px[1] + 24.966 * px[0]) / 255.0));
      }
    }
    for (int y = 0; y < H / 2; y++)
      for (int x = 0; x < W / 2; x++) {
        double r = 0, g = 0, b = 0;
        for (int j = 0; j < 2; j++)
          for (int i = 0; i < 2; i++) {
            const uint8_t* px = bgr + ((size_t)std::min(2 * y + j, height - 1) * width + std::min(2 * x + i, width - 1)) * 3;
            b += px[0];
            g += px[1];
            r += px[2];
          }
        r /= 4; g /= 4; b /= 4;
        src.plane(1)[y * W / 2 + x] = clip8((int)std::lround(128 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255.0));
        src.plane(2)[y * W / 2 + x] = clip8((int)std::lround(128 + (112.0 * r - 93.786 * g - 18.214 * b) / 255.0));
      }
  }
  // forward 4x4 core transform of the residual x (raster) into w
  static void fdct4(const int* x, int* w) {
    int t[16];
    for (int i = 0; i < 4; i++) {
      const int* r = x + 4 * i;
      int s03 = r[0] + r[3], d03 = r[0] - r[3], s12 = r[1] + r[2], d12 = r[1] - r[2];
      t[4 * i] = s03 + s12;
      t[4 * i + 1] = 2 * d03 + d12;
      t[4 * i + 2] = s03 - s12;
      t[4 * i + 3] = d03 - 2 * d12;
    }
    for (int j = 0; j < 4; j++) {
      int s03 = t[j] + t[12 + j], d03 = t[j] - t[12 + j], s12 = t[4 + j] + t[8 + j], d12 = t[4 + j] - t[8 + j];
      w[j] = s03 + s12;
      w[4 + j] = 2 * d03 + d12;
      w[8 + j] = s03 - s12;
      w[12 + j] = d03 - 2 * d12;
    }
  }
  static int quant(int v, int mf, int f, int qbits) {
    int a = (std::abs(v) * mf + f) >> qbits;
    return v < 0 ? -a : a;
  }
  // the residual of a 4x4 block (source - prediction in the picture)
  void residual4(int c, int x, int y, int* out) {
    const Picture& cur = *codec.cur;
    int st = cur.stride(c);
    for (int j = 0; j < 4; j++)
      for (int i = 0; i < 4; i++)
        out[4 * j + i] = src.plane(c)[(y + j) * st + x + i] - cur.plane(c)[(y + j) * st + x + i];
  }
  // quantised luma (I16: DC apart) and chroma of the macroblock against the
  // prediction now in the picture; returns the coded block pattern
  int quantise(Mb& m, bool i16, int q) {
    int px = codec.mbx * 16, py = codec.mby * 16;
    int qbits = 15 + q / 6, fq = (1 << qbits) / (i16 ? 3 : 6);
    int cls[16];
    for (int r = 0; r < 16; r++) {
      int i = r >> 2, j = r & 3;
      cls[r] = (i % 2 == 0 && j % 2 == 0) ? 0 : (i % 2 && j % 2) ? 1 : 2;
    }
    int cbpl = 0, w[16], x[16], wdc[16];
    for (int k = 0; k < 16; k++) {
      int r = kBlkRaster[k];
      residual4(0, px + (r & 3) * 4, py + (r >> 2) * 4, x);
      fdct4(x, w);
      wdc[r] = w[0];
      bool any = false;
      for (int s = i16 ? 1 : 0; s < 16; s++) {
        int pos = kZigzag4[s];
        int l = quant(w[pos], kMF[q % 6][cls[pos]], fq, qbits);
        m.luma[k][s] = (int16_t)clip3(-2000, 2000, l);
        any |= l != 0;
      }
      if (i16) m.luma[k][0] = 0;
      if (any) cbpl |= 1 << (k >> 2);
    }
    if (i16) {
      int t[16], y[16];
      for (int i = 0; i < 4; i++) {
        int* r = wdc + 4 * i;
        t[4 * i] = r[0] + r[1] + r[2] + r[3];
        t[4 * i + 1] = r[0] + r[1] - r[2] - r[3];
        t[4 * i + 2] = r[0] - r[1] - r[2] + r[3];
        t[4 * i + 3] = r[0] - r[1] + r[2] - r[3];
      }
      for (int j = 0; j < 4; j++) {
        int a = t[j], b = t[4 + j], c = t[8 + j], d = t[12 + j];
        y[j] = (a + b + c + d) / 2;
        y[4 + j] = (a + b - c - d) / 2;
        y[8 + j] = (a - b - c + d) / 2;
        y[12 + j] = (a - b + c - d) / 2;
      }
      for (int s = 0; s < 16; s++)
        m.dc[s] = (int16_t)clip3(-2000, 2000, quant(y[kZigzag4[s]], kMF[q % 6][0], 2 * fq, qbits + 1));
      cbpl = cbpl ? 15 : 0;
    } else {
      // a lone small coefficient is not worth its bits
      for (int b8 = 0; b8 < 4; b8++) {
        int sum = 0;
        for (int b4 = 0; b4 < 4; b4++)
          for (int s = 0; s < 16; s++) sum += std::abs(m.luma[b8 * 4 + b4][s]);
        if (sum <= 1) {
          cbpl &= ~(1 << b8);
          for (int b4 = 0; b4 < 4; b4++) memset(m.luma[b8 * 4 + b4], 0, sizeof m.luma[0]);
        }
      }
    }
    int cbpc = 0;
    for (int ch = 0; ch < 2; ch++) {
      int qc = codec.chroma_qp(ch, q), qb = 15 + qc / 6, fc = (1 << qb) / (i16 ? 3 : 6);
      int dcw[4];
      for (int k = 0; k < 4; k++) {
        residual4(1 + ch, px / 2 + (k & 1) * 4, py / 2 + (k >> 1) * 4, x);
        fdct4(x, w);
        dcw[k] = w[0];
        m.cac[ch][k][0] = 0;
        for (int s = 1; s < 16; s++) {
          int pos = kZigzag4[s];
          int l = quant(w[pos], kMF[qc % 6][cls[pos]], fc, qb);
          m.cac[ch][k][s] = (int16_t)clip3(-2000, 2000, l);
          if (l) cbpc = 2;
        }
      }
      int f2[4] = {dcw[0] + dcw[1] + dcw[2] + dcw[3], dcw[0] - dcw[1] + dcw[2] - dcw[3],
                   dcw[0] + dcw[1] - dcw[2] - dcw[3], dcw[0] - dcw[1] - dcw[2] + dcw[3]};
      for (int k = 0; k < 4; k++) {
        m.cdc[ch][k] = (int16_t)clip3(-2000, 2000, quant(f2[k], kMF[qc % 6][0], 2 * fc, qb + 1));
        if (m.cdc[ch][k] && !cbpc) cbpc = 1;
      }
    }
    if (cbpc < 2)
      for (int ch = 0; ch < 2; ch++) memset(m.cac[ch], 0, sizeof m.cac[ch]);
    if (!cbpc)
      for (int ch = 0; ch < 2; ch++) memset(m.cdc[ch], 0, sizeof m.cdc[ch]);
    return cbpl | cbpc << 4;
  }
  long sad16(const uint8_t* a, int as, const uint8_t* b, int bs) {
    long s = 0;
    for (int y = 0; y < 16; y++)
      for (int x = 0; x < 16; x++) s += std::abs(a[y * as + x] - b[y * bs + x]);
    return s;
  }
  void choose_encode(Mb& m) {
    Codec& c = codec;
    bool islice = c.sh.type == 2;
    int px = c.mbx * 16, py = c.mby * 16, W = 16 * mbw;
    const uint8_t* s0 = src.plane(0) + (size_t)py * W + px;
    bool L = c.intra_ok(c.mbx - 1, c.mby), T = c.intra_ok(c.mbx, c.mby - 1),
         TL = c.intra_ok(c.mbx - 1, c.mby - 1);
    // the best allowed Intra16x16 mode by SAD against the source
    std::vector<int> modes = {2};
    if (T) modes.push_back(0);
    if (L) modes.push_back(1);
    if (L && T && TL) modes.push_back(3);
    uint8_t* d0 = c.pix(0, px, py);
    int best_mode = 2;
    long best_intra = 1L << 40;
    for (int md : modes) {
      c.pred16(md, d0, W, L, T, TL);
      long sad = sad16(d0, W, s0, W);
      if (sad < best_intra) { best_intra = sad; best_mode = md; }
    }
    // the best vector within `radius` integer samples of (cx, cy), and zero,
    // refined to half then quarter samples; its SAD plus a cost of the mvd
    auto search = [&](const Picture& ref, int cx, int cy, int radius, int best[2]) {
      uint8_t tmp[256];
      long best_sad = 1L << 40;
      auto try_mv = [&](int mx, int my) {
        long sad;
        int ix = px + (mx >> 2), iy = py + (my >> 2);
        if (!(mx & 3) && !(my & 3) && ix >= 0 && iy >= 0 && ix + 16 <= ref.w && iy + 16 <= ref.h) {
          sad = sad16(ref.plane(0) + (size_t)iy * ref.w + ix, ref.w, s0, W);
        } else {
          Codec::mc_luma(ref, px, py, 16, 16, mx, my, tmp, 16);
          sad = sad16(tmp, 16, s0, W);
        }
        sad += (std::abs(mx - cx) + std::abs(my - cy)) / 2;
        if (sad < best_sad) { best_sad = sad; best[0] = mx; best[1] = my; }
      };
      for (int dy = -radius; dy <= radius; dy++)
        for (int dx = -radius; dx <= radius; dx++) try_mv((cx & ~3) + 4 * dx, (cy & ~3) + 4 * dy);
      try_mv(0, 0);
      try_mv(cx, cy);
      for (int step = 2; step >= 1; step--) {
        int bx = best[0], by = best[1];
        for (int dy = -1; dy <= 1; dy++)
          for (int dx = -1; dx <= 1; dx++)
            if (dx || dy) try_mv(bx + step * dx, by + step * dy);
      }
      return best_sad;
    };
    if (c.sh.type == 0) {
      int smv[2], best[2] = {0, 0};
      c.skip_mv(smv);
      long best_sad = search(*c.list[0][0], smv[0], smv[1], 3, best);
      if (best_sad < best_intra + 256) {
        // the inter prediction into the picture, then its residual
        int ref[2] = {0, -1}, mv[2][2] = {{best[0], best[1]}, {0, 0}};
        c.predict_partition(0, 0, 16, 16, ref, mv);
        int cbp = quantise(m, false, c.qp);
        if (cbp == 0 && best[0] == smv[0] && best[1] == smv[1]) {
          m.skip = 1;
          return;
        }
        m.mb_type = 0;
        m.ref[0][0] = 0;
        m.mv[0][0][0] = best[0];
        m.mv[0][0][1] = best[1];
        m.cbp = cbp;
        m.qp_delta = 0;
        return;
      }
    } else if (c.sh.type == 1) {
      // B: the direct prediction (B_Skip or B_Direct_16x16), or 16x16 from
      // list 0, list 1 or both (the implicit or default average)
      MbInfo saved = c.ci();
      c.direct_motion(15);
      MbInfo direct_info = c.ci();
      c.predict_inter();
      long cost[4];  // direct, L0, L1, both
      cost[0] = sad16(d0, W, s0, W) - 64;
      c.ci() = saved;
      int best[2][2] = {{0, 0}, {0, 0}}, mode = 0;
      int ref[2] = {0, 0};
      if (cost[0] > 2 * 256) {  // the direct prediction within 2 a sample is taken as it is
        for (int l = 0; l < 2; l++) {
          int pred[2];
          c.mvp(0, 0, 16, 0, 0, 0, l, pred);
          cost[1 + l] = search(*c.list[l][0], pred[0], pred[1], 1, best[l]);
        }
        c.predict_partition(0, 0, 16, 16, ref, best);
        cost[3] = sad16(d0, W, s0, W) + 32;
        for (int k = 1; k < 4; k++)
          if (cost[k] < cost[mode]) mode = k;
      }
      if (cost[mode] < best_intra + 256) {
        if (mode == 0) {
          c.ci() = direct_info;
          c.predict_inter();
        } else if (mode < 3) {
          int r[2] = {mode == 1 ? 0 : -1, mode == 2 ? 0 : -1};
          c.predict_partition(0, 0, 16, 16, r, best);
        } else {
          c.predict_partition(0, 0, 16, 16, ref, best);
        }
        c.ci() = saved;
        int cbp = quantise(m, false, c.qp);
        m.cbp = cbp;
        m.qp_delta = 0;
        if (mode == 0) {
          m.skip = cbp == 0;
          m.mb_type = 0;
          return;
        }
        m.mb_type = mode;
        for (int l = 0; l < 2; l++) {
          m.ref[l][0] = 0;
          m.mv[l][0][0] = best[l][0];
          m.mv[l][0][1] = best[l][1];
        }
        return;
      }
    }
    c.pred16(best_mode, d0, W, L, T, TL);
    for (int k = 1; k < 3; k++) c.pred_chroma(0, c.pix(k, px / 2, py / 2), W / 2, L, T, TL);
    int cbp = quantise(m, true, c.qp);
    m.i16 = best_mode;
    m.cmode = 0;
    m.mb_type = (islice ? 0 : c.sh.type == 0 ? 5 : 23) + 1 + best_mode + 4 * (cbp >> 4) +
                12 * ((cbp & 15) ? 1 : 0);
    m.cbp = cbp;
    m.qp_delta = 0;
  }

  // --------------------------------------------------------------- mux --
  void release() {
    if (!f) return;
    if (!ended) flush_group();
    std::vector<uint8_t> avcc;
    bool avc3 = o.get("avc3", 0);
    avcc.push_back(1);
    avcc.push_back((uint8_t)sps.profile_idc);
    avcc.push_back((uint8_t)sps.constraint_flags);
    avcc.push_back((uint8_t)sps.level_idc);
    avcc.push_back((uint8_t)(0xFC | (length_size() - 1)));  // lengthSizeMinusOne
    bool sets = !avc3 && !param_refusal();
    avcc.push_back((uint8_t)(0xE0 | (sets ? 1 : 0)));
    if (sets) { put_be(avcc, sps_nal.size(), 2); avcc.insert(avcc.end(), sps_nal.begin(), sps_nal.end()); }
    avcc.push_back(sets ? 1 : 0);
    if (sets) { put_be(avcc, pps_nal.size(), 2); avcc.insert(avcc.end(), pps_nal.begin(), pps_nal.end()); }
    MoovSpec spec;
    spec.width = width;
    spec.height = height;
    spec.timescale = fps_num;
    spec.delta = fps_den;
    spec.entry_type = avc3 ? "avc3" : "avc1";
    spec.entry = visual_entry(width, height);
    box(spec.entry, "avcC", avcc);
    spec.sizes = sizes;
    spec.sync = sync;
    spec.mdat_start = mdat_start;
    spec.big = mdat_start + written > 0xFFFFFFFFull;
    spec.rotation = o.get("rotation", 0);
    // composition offsets as FFmpeg's muxer writes them for reordered
    // pictures: version 0 from a decode delay D (the most samples decoded
    // ahead of their display), with one edit from the first composition
    // time D; version 1 (negative_cts_offsets) the signed offsets, no edit
    bool reordered = false;
    for (size_t i = 0; i < sample_display.size(); i++) reordered |= sample_display[i] != (int)i;
    int version = o.get("ctts_version", 0);
    std::string edit = o.gets("edit", reordered && o.get("ctts", 1) && version == 0 ? "movenc" : "none");
    if (reordered && o.get("ctts", 1)) {
      int delay = 0;
      for (size_t i = 0; i < sample_display.size(); i++) delay = std::max(delay, (int)i - sample_display[i]);
      spec.ctts_version = version;
      for (size_t i = 0; i < sample_display.size(); i++)
        spec.ctts.push_back((sample_display[i] - (int)i + (version ? 0 : delay)) * fps_den);
      if (edit == "movenc") spec.edit_media_time = (int64_t)delay * fps_den;
    }
    if (edit != "none" && edit != "movenc") spec.edit_media_time = std::atoi(edit.c_str());
    std::vector<uint8_t> out = build_moov(spec);
    if (fwrite(out.data(), 1, out.size(), f) != out.size()) fail("write failed");
    std::vector<uint8_t> size;
    put_be(size, 16 + written, 8);
    if (fseeko(f, (off_t)(mdat_start - 8), SEEK_SET) != 0 || fwrite(size.data(), 1, 8, f) != 8)
      fail("write failed");
    if (fclose(f) != 0) { f = nullptr; fail("close failed"); }
    f = nullptr;
  }
};

}  // namespace

extern "C" {

// opts: "key=value;..." (Options); mode=random draws the syntax from seed,
// mode=frames codes the frames given to h264_writer_write
void* h264_writer_open(const char* path, int width, int height, int fps_num, int fps_den,
                       const char* opts, char* err, int errlen) {
  Writer* w = new Writer();
  try {
    w->open(path, width, height, fps_num, fps_den, opts);
    return w;
  } catch (const Error& e) {
    report(e, err, errlen);
    delete w;
    return nullptr;
  }
}

// bgr: height x width x 3 bytes (frames mode), or null (random mode)
int h264_writer_write(void* h, const uint8_t* bgr, char* err, int errlen) {
  try {
    static_cast<Writer*>(h)->write(bgr);
    return 0;
  } catch (const Error& e) {
    return report(e, err, errlen);
  }
}

// writes the moov box and closes the file; frees the writer
int h264_writer_close(void* h, char* err, int errlen) {
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
