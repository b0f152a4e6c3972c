// H.265 / HEVC test streams in MP4 for the port's tests and its smoke run:
// the port reads HEVC (hevc.cpp) but, like the JAX package, writes only mp4v,
// so this writer is reachable from io/hevc_streams.py alone. Built by
// monohair_tpu_torch/ops/_build.py (g++), called through ctypes.
//
// It drives hevc.h's syntax with the bit writer on, so the writer and the
// decoder share their tables, context derivation and candidate lists; every
// stream it writes is therefore held against FFmpeg's decoder
// (cv2.VideoCapture) in the tests, never only against hevc.cpp.
//
// Two modes:
// - random: syntax drawn from a seed, every decoded picture of it legal: the
//   coding quadtree down to 8x8, each part_mode (AMP too), skip, merge and
//   AMVP with every candidate kind, each intra mode and chroma mode, PCM,
//   the residual quadtree, coefficients (with escapes), transform skip,
//   sign data hiding, cu_qp_delta, transquant bypass, SAO parameters and
//   merges; per picture IDR, CRA or trailing NAL unit types, POCs out of
//   decode order in groups, the RPS (from the SPS, explicit or inter
//   predicted), pic_output_flag; per slice its type, reference list length
//   and modification, TMVP, weights, merge candidates, QP and chroma offsets,
//   deblocking override and offsets, SAO flags, filtering across slices.
// - frames: BGR frames in, an I/P stream of them out at a fixed QP: 16x16
//   coding units under CTBs of 16, 32 or 64 (the size given), intra 2Nx2N
//   (the best of planar, DC, horizontal and vertical), or in P pictures
//   skip/merge from the best merge candidate or AMVP from a small integer
//   search, each with a quantised residual.
// The MP4 (ftyp "isom" or "qt  ", mdat, moov with an hvc1 or hev1 sample
// entry and its hvcC) can carry a rotation in tkhd's matrix and the
// composition offsets of reordered pictures. The NAL units carry 4-byte
// lengths, or 1 or 2 (length_size). Options come as "key=value;..." (see
// io/hevc_streams.py).

#include <cmath>

#include "hevc.h"

namespace {

std::vector<uint8_t> nal_unit(int type, int tid, const std::vector<uint8_t>& rbsp) {
  return escape_rbsp({(uint8_t)(type << 1), (uint8_t)(tid + 1)}, rbsp);
}

struct Writer;

// ------------------------------------------------------------ random --
struct RandomChooser : Chooser {
  Hevc& c;
  Rng& rng;
  RandomChooser(Hevc& co, Rng& r) : c(co), rng(r) {}
  double p_split = 0.55, p_skip = 0.25, p_intra = 0.2, p_pcm = 0.08, p_bypass = 0.08;
  double p_merge = 0.4, p_tskip = 0.3, p_qp = 0.5;
  std::vector<int> slice_ends;  // CTB addresses that end a slice

  void sao(int, int, bool left_ok, bool up_ok, int& ml, int& mu, SaoParams& p) override {
    ml = left_ok && rng.chance(0.25);
    mu = !ml && up_ok && rng.chance(0.25);
    for (int k = 0; k < 2; k++) {
      p.type[k] = rng.range(0, 2);
      p.eo[k] = rng.range(0, 3);
    }
    p.type[2] = p.type[1];
    p.eo[2] = p.eo[1];
    for (int k = 0; k < 3; k++) {
      p.band[k] = rng.range(0, 31);
      for (int i = 0; i < 4; i++) {
        int a = rng.chance(0.3) ? 0 : rng.range(1, 7);
        p.offset[k][i] = rng.chance(0.5) ? -a : a;
      }
    }
  }
  int split_cu(int, int, int log2) override {
    return rng.chance(log2 >= 5 ? p_split + 0.2 : p_split);
  }
  void cu(int, int, int log2, CuChoice& ch) override {
    const SPS& s = *c.s;
    ch.bypass = rng.chance(p_bypass);
    bool inter_ok = c.sh.type == SLICE_P;
    ch.skip = inter_ok && rng.chance(p_skip);
    ch.intra = !inter_ok || rng.chance(p_intra);
    if (ch.intra) {
      ch.part = log2 == s.log2_min_cb && rng.chance(0.5) ? PNxN : P2Nx2N;
      ch.pcm = ch.part == P2Nx2N && rng.chance(p_pcm);
    } else {
      std::vector<int> parts = {P2Nx2N, P2NxN, PNx2N};
      if (s.amp && log2 > s.log2_min_cb) parts.insert(parts.end(), {P2NxnU, P2NxnD, PnLx2N, PnRx2N});
      if (log2 == s.log2_min_cb && log2 > 3) parts.push_back(PNxN);
      ch.part = parts[rng.range(0, (int)parts.size() - 1)];
    }
    ch.rqt_root_cbf = rng.chance(0.65);
  }
  void pcm_samples(int, int, int log2, uint8_t* smp) override {
    const SPS& s = *c.s;
    int n = 1 << log2, nl = n * n, nc = n * n / 2;
    int base = rng.range(0, 255);
    for (int i = 0; i < nl; i++)
      smp[i] = (uint8_t)(clip3(0, 255, base + rng.range(-40, 40)) >> (8 - s.pcm_bd));
    for (int i = 0; i < nc; i++) smp[nl + i] = (uint8_t)(rng.range(0, 255) >> (8 - s.pcm_bd_c));
  }
  int intra_mode(int, int, int) override { return rng.range(0, 34); }
  int chroma_mode(int, int, int) override { return rng.range(0, 4); }
  void pu(int x, int y, int pw, int ph, int, const Motion* cands, PuChoice& ch) override;
  int split_tf(int, int, int, int) override { return rng.chance(0.4); }
  int cbf(int comp, int, int, int, int) override { return rng.chance(comp ? 0.45 : 0.6); }
  int qp_delta(int, int) override {
    if (!rng.chance(p_qp)) return 0;
    return rng.chance(0.85) ? rng.range(-6, 6) : rng.range(-26, 25);
  }
  int transform_skip(int, int, int, int) override { return rng.chance(p_tskip); }
  void coeffs(int, int, int, int log2, int16_t* lv) override {
    int n = 1 << log2;
    int count = rng.chance(0.3) ? 1 : rng.range(1, std::min(24, n * n / 2));
    bool any = false;
    for (int k = 0; k < count; k++) {
      // low frequencies more often
      int lim = rng.chance(0.7) ? std::max(1, n / 4) : n;
      int x = rng.range(0, lim - 1), y = rng.range(0, lim - 1);
      int v;
      double r = (rng.next() >> 11) * (1.0 / 9007199254740992.0);
      if (r < 0.6) v = rng.range(1, 2);
      else if (r < 0.9) v = rng.range(3, 20);
      else if (r < 0.985) v = rng.range(21, 600);
      else v = rng.range(601, 32767);
      lv[y * n + x] = (int16_t)(rng.chance(0.5) ? -v : v);
      any = true;
    }
    if (!any) lv[0] = 1;
  }
  int end_of_slice(int ctb) override {
    return std::find(slice_ends.begin(), slice_ends.end(), ctb) != slice_ends.end();
  }
};

// ------------------------------------------------------------ frames --
// A small encoder over the shared decoding process: each 16x16 coding unit's
// decision and quantised residual are made when the coding unit starts, and
// the syntax calls read them back.
struct FramesChooser : Chooser {
  Hevc& c;
  const Picture& src;
  FramesChooser(Hevc& co, const Picture& s) : c(co), src(s) {}
  // the plan of the current coding unit
  int mode = 1;
  PuChoice pu_plan;
  int16_t lv[3][32 * 32];
  bool nz[3];

  void sao(int, int, bool, bool, int& ml, int& mu, SaoParams&) override { ml = mu = 0; }
  int split_cu(int, int, int log2) override { return log2 > 4; }
  void cu(int x0, int y0, int log2, CuChoice& ch) override;
  void pcm_samples(int, int, int, uint8_t*) override {}
  int intra_mode(int, int, int) override { return mode; }
  int chroma_mode(int, int, int) override { return 4; }
  void pu(int, int, int, int, int, const Motion*, PuChoice& ch) override { ch = pu_plan; }
  int split_tf(int, int, int, int) override { return 0; }
  int cbf(int comp, int, int, int, int) override { return nz[comp]; }
  int qp_delta(int, int) override { return 0; }
  int transform_skip(int, int, int, int) override { return 0; }
  void coeffs(int comp, int, int, int log2, int16_t* out) override {
    memcpy(out, lv[comp], sizeof(int16_t) << (2 * log2));
  }
  int end_of_slice(int) override { return 0; }

  int sad(int comp, int x0, int y0, int n, const uint8_t* pred, int pstride) const {
    const uint8_t* s8 = src.plane(comp);
    int stride = src.stride(comp), t = 0;
    for (int y = 0; y < n; y++)
      for (int x = 0; x < n; x++) t += std::abs(s8[(y0 + y) * stride + x0 + x] - pred[y * pstride + x]);
    return t;
  }
  // forward transform and quantisation of src - pred into levels; true if any
  bool quantise(int comp, int x0, int y0, int log2, const uint8_t* pred, int pstride, bool intra,
                int16_t* out);
  void predict_motion(int x0, int y0, int n, int mvx, int mvy, int ref, uint8_t* pred[3]);
};

// ------------------------------------------------------------ writer --
struct PicInfo {
  int poc;
  bool ref;
  int decode;
};

struct Writer {
  Options o;
  Rng rng{0};
  Hevc codec;
  FILE* f = nullptr;
  std::string path;
  bool random_mode = true;
  int width = 0, height = 0, cw = 0, ch = 0, fps_num = 30, fps_den = 1;
  VPS vps;
  SPS sps;
  std::vector<PPS> ppss;
  std::vector<uint8_t> vps_nal, sps_nal;
  std::vector<std::vector<uint8_t>> pps_nals;
  std::vector<uint32_t> sizes, sync;
  std::vector<int> sample_display;
  uint64_t mdat_start = 0, written = 0;
  std::string refuse;
  bool ended = false;
  int qp = 24;
  // the GOP structure: groups of up to `group` pictures whose last (by POC)
  // is coded first; an IRAP picture every `gop` pictures (0: only the first)
  int group = 1, gop = 0, max_refs = 2;
  std::vector<int> pending;  // POCs of the current group still to code
  int decoded = 0, since_irap = 0, irap_poc = 0, last_poc = 0, display_base = 0;
  std::vector<PicInfo> pics;  // reference pictures since the last IRAP (and it), decode order
  std::vector<int> foll;      // POCs before a CRA that its RPS keeps unused
  Picture src;

  ~Writer() {
    if (f) fclose(f);
  }

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
    qp = o.get("qp", 24);
    group = random_mode ? o.get("group", 1) : 1;
    gop = o.get("gop", 0);
    max_refs = std::max(1, o.get("refs", 2));
    if (group < 1 || group > 8) fail("group must be within 1..8");
    if (max_refs > 6) fail("refs must be within 1..6");
    build_params();
    f = fopen(p, "wb");
    if (!f) fail(std::string("cannot create ") + p);
    std::vector<uint8_t> head;
    std::string brand = o.get("quicktime", 0) ? "qt  " : "isom";
    put_be(head, brand == "qt  " ? 20 : 24, 4);
    head.insert(head.end(), {'f', 't', 'y', 'p'});
    head.insert(head.end(), brand.begin(), brand.end());
    put_be(head, 0x200, 4);
    head.insert(head.end(), brand.begin(), brand.end());
    if (brand != "qt  ") head.insert(head.end(), {'m', 'p', '4', '1'});
    put_be(head, 1, 4);
    head.insert(head.end(), {'m', 'd', 'a', 't'});
    put_be(head, 0, 8);  // 64-bit size, patched at release
    if (fwrite(head.data(), 1, head.size(), f) != head.size()) fail("write failed");
    mdat_start = head.size();
  }

  // an option, or (in random mode, when absent) a draw
  int pick(const char* key, int lo, int hi, int frames_value) {
    if (o.kv.count(key)) return o.get(key, 0);
    return random_mode ? rng.range(lo, hi) : frames_value;
  }
  bool chance(const char* key, double p, int frames_value) {
    if (o.kv.count(key)) return o.get(key, 0) != 0;
    return random_mode ? rng.chance(p) : frames_value != 0;
  }

  void random_scaling(ScalingList& sl) {
    sl.set_default();
    for (int s = 0; s < 4; s++)
      for (int m = 0; m < 6; m += s == 3 ? 3 : 1) {
        int r = rng.range(0, 2);
        int step = s == 3 ? 3 : 1;
        if (r == 0 || (r == 1 && m == 0)) {  // explicit
          sl.pred_mode[s][m] = 1;
          int n = std::min(64, 1 << (4 + (s << 1)));
          for (int i = 0; i < n; i++) sl.list[s][m][i] = (uint8_t)rng.range(4, 80);
          sl.dc[s][m] = rng.range(4, 80);
        } else {
          sl.pred_mode[s][m] = 0;
          int d = r == 1 ? rng.range(1, m / step) : 0;
          sl.pred_delta[s][m] = (uint8_t)d;
        }
      }
  }

  void build_params() {
    SPS& s = sps;
    s.id = 0;
    s.vps_id = 0;
    s.profile_idc = refuse == "main10" ? 2 : refuse == "rext" ? 4 : 1;
    int ctb = o.get("ctb", random_mode ? 16 << rng.range(0, 2) : 64);
    if (ctb != 16 && ctb != 32 && ctb != 64) fail("ctb must be 16, 32 or 64");
    s.ctb_log2 = ceil_log2(ctb);
    s.log2_min_cb = o.get("min_cb", random_mode && rng.chance(0.2) ? 4 : 3) == 16 ? 4 : 3;
    if (s.log2_min_cb > s.ctb_log2) s.log2_min_cb = s.ctb_log2;
    s.log2_diff_cb = s.ctb_log2 - s.log2_min_cb;
    s.log2_min_tb = 2;
    int max_tb = random_mode ? rng.range(3, std::min(5, s.ctb_log2)) : std::min(5, s.ctb_log2);
    if (o.kv.count("max_tb")) max_tb = std::min(ceil_log2(o.get("max_tb", 32)), std::min(5, s.ctb_log2));
    s.log2_diff_tb = max_tb - s.log2_min_tb;
    s.max_th_inter = random_mode ? rng.range(0, 2) : 0;
    s.max_th_intra = random_mode ? rng.range(0, 2) : 0;
    s.max_th_inter = std::min(s.max_th_inter, s.ctb_log2 - 2);
    s.max_th_intra = std::min(s.max_th_intra, s.ctb_log2 - 2);
    cw = (width + 7) / 8 * 8;
    ch = (height + 7) / 8 * 8;
    if (s.log2_min_cb == 4) {
      cw = (width + 15) / 16 * 16;
      ch = (height + 15) / 16 * 16;
    }
    s.width = cw;
    s.height = ch;
    int top = o.get("crop_top", 0), left = o.get("crop_left", 0);
    s.conf[0] = left;
    s.conf[1] = (cw - width) / 2 - left;
    s.conf[2] = top;
    s.conf[3] = (ch - height) / 2 - top;
    if (left || top) {  // the picture grows by the cropped margin
      s.width = cw = cw + (2 * (left + top) + 7) / 8 * 8;
      s.height = ch = ch + (2 * top + 7) / 8 * 8;
      s.conf[1] = (cw - width) / 2 - left;
      s.conf[3] = (ch - height) / 2 - top;
    }
    s.conf_win = s.conf[0] || s.conf[1] || s.conf[2] || s.conf[3];
    s.chroma_format_idc = refuse == "chroma422" ? 2 : 1;
    s.bit_depth = s.bit_depth_c = refuse == "bit_depth10" ? 10 : 8;
    s.log2_max_poc_lsb = pick("poc_bits", 4, 8, 8);
    int reorder = group - 1;
    s.max_sub_layers_minus1 = 0;
    s.ordering_info = rng.chance(0.5);
    s.max_reorder[0] = reorder + (random_mode && rng.chance(0.3) ? 1 : 0);
    s.max_dec_minus1[0] = std::min(15, max_refs + reorder + (random_mode ? rng.range(0, 2) : 0));
    s.max_dec_minus1[0] = std::max(s.max_dec_minus1[0], s.max_reorder[0]);
    s.max_latency_plus1[0] = random_mode ? rng.range(0, 3) : 0;
    s.scaling_enabled = chance("scaling", 0.3, 0);
    s.scaling_present = s.scaling_enabled && rng.chance(0.6);
    if (s.scaling_present) random_scaling(s.sl);
    else s.sl.set_default();
    s.amp = chance("amp", 0.6, 0);
    s.sao = chance("sao", 0.6, 0);
    s.pcm = chance("pcm", 0.4, 0);
    if (s.pcm) {
      s.pcm_bd = rng.range(5, 8);
      s.pcm_bd_c = rng.range(5, 8);
      int hi = std::min(s.ctb_log2, 5);
      s.log2_min_pcm = rng.range(3, hi);
      s.log2_diff_pcm = rng.range(0, hi - s.log2_min_pcm);
      s.pcm_loop_filter_disabled = rng.chance(0.5);
    }
    s.long_term = refuse == "long_term";
    s.temporal_mvp = chance("tmvp", 0.7, 1);
    s.strong_smoothing = chance("strong", 0.6, 1);
    // SPS short-term RPS: the steady-state sets of the GOP, some coded by inter prediction
    s.num_st_rps = o.kv.count("sps_rps") ? o.get("sps_rps", 1) : random_mode ? rng.range(0, 4) : 1;
    for (int i = 0; i < s.num_st_rps; i++) {
      StRps r;
      int k = random_mode ? rng.range(1, max_refs) : 1;
      r.num_neg = k;
      for (int j = 0; j < k; j++) {
        r.delta[j] = -(j + 1);
        r.used[j] = j == 0 || rng.chance(0.7);
      }
      if (i > 0 && random_mode && rng.chance(0.5) && inter_rps(r, s.st_rps[i - 1], 0))
        r.inter = 1;
      s.st_rps[i] = r;
    }
    s.vui = chance("vui", 0.5, 0) || o.kv.count("matrix") || o.kv.count("full_range") ||
            o.kv.count("primaries") || o.kv.count("transfer");
    if (s.vui) {
      s.aspect = rng.chance(0.5);
      s.signal_type = o.kv.count("matrix") || o.kv.count("full_range") || rng.chance(0.3);
      s.full_range = o.get("full_range", 0);
      s.colour_desc = o.kv.count("matrix") || o.kv.count("primaries") || o.kv.count("transfer");
      s.matrix = o.get("matrix", 2);
      s.primaries = o.get("primaries", 2);
      s.transfer = o.get("transfer", 2);
      s.chroma_loc = rng.chance(0.3);
      s.timing = o.get("hrd", 0) || rng.chance(0.3);
      s.hrd = o.get("hrd", 0);
      s.restriction = rng.chance(0.5);
    }
    Bits b;
    b.start_write();
    vps.max_sub_layers_minus1 = 0;
    vps.profile_idc = s.profile_idc;
    vps_syntax(b, vps);
    b.trailing();
    vps_nal = nal_unit(VPS_NUT, 0, b.out);
    b.start_write();
    sps_syntax(b, s, codec.vps);
    b.trailing();
    sps_nal = nal_unit(SPS_NUT, 0, b.out);
    codec.vps[0] = vps;
    codec.sps[0] = s;
    int npps = random_mode ? rng.range(1, 2) : 1;
    for (int i = 0; i < npps; i++) {
      PPS p;
      p.id = i;
      p.sps_id = 0;
      p.dependent_slices = refuse == "dependent_slice";
      p.output_flag_present = chance("output_flag", 0.3, 0);
      p.extra_bits = random_mode ? rng.range(0, 2) : 0;
      p.sign_hiding = chance("sign_hiding", 0.5, 0);
      p.cabac_init_present = chance("cabac_init", 0.5, 0);
      p.num_ref_default[0] = random_mode ? rng.range(1, 3) : 1;
      p.num_ref_default[1] = 1;
      p.init_qp = random_mode ? rng.range(18, 40) : qp;
      p.constrained_intra = s.log2_min_cb == 3 && chance("constrained_intra", 0.25, 0);
      p.transform_skip = chance("transform_skip", 0.5, 0);
      p.cu_qp_delta = chance("cu_qp_delta", 0.5, 0);
      p.diff_cu_qp_delta_depth = p.cu_qp_delta ? rng.range(0, s.log2_diff_cb) : 0;
      p.cb_qp_offset = chance("chroma_offsets", 0.4, 0) ? rng.range(-12, 12) : 0;
      p.cr_qp_offset = chance("chroma_offsets", 0.4, 0) ? rng.range(-12, 12) : 0;
      p.slice_chroma_offsets = chance("chroma_offsets", 0.4, 0);
      p.weighted_pred = chance("weighted", 0.3, 0);
      p.transquant_bypass = chance("bypass", 0.3, 0);
      p.tiles = refuse == "tiles";
      p.wpp = refuse == "wpp";
      p.lf_across_slices = chance("lf_across", 0.5, 1);
      p.deblock_control = chance("deblock", 0.6, 0);
      if (p.deblock_control) {
        p.deblock_override = rng.chance(0.7);
        p.deblock_disabled = rng.chance(0.2);
        p.beta_div2 = rng.range(-6, 6);
        p.tc_div2 = rng.range(-6, 6);
      }
      p.scaling_present = s.scaling_enabled && rng.chance(0.5);
      if (p.scaling_present) random_scaling(p.sl);
      p.lists_modification = chance("list_mod", 0.5, 0);
      p.log2_par_mrg = random_mode ? rng.range(2, std::min(4, s.ctb_log2)) : 2;
      p.header_extension = rng.chance(0.2) && random_mode;
      b.start_write();
      pps_syntax(b, p, codec.sps);
      b.trailing();
      pps_nals.push_back(nal_unit(PPS_NUT, 0, b.out));
      codec.pps[i] = p;
      ppss.push_back(p);
    }
  }

  // the inter-RPS syntax that codes `want` from `ref`, with its deltaRps; false if none does
  bool inter_rps(StRps& want, const StRps& ref, int delta_idx_minus1) {
    std::vector<int> cands;
    for (int i = 0; i < want.num(); i++) {
      cands.push_back(want.delta[i]);
      for (int j = 0; j < ref.num(); j++) cands.push_back(want.delta[i] - ref.delta[j]);
    }
    for (int d : cands) {
      if (!d) continue;
      bool ok = true;
      for (int i = 0; i < want.num() && ok; i++) {
        bool hit = want.delta[i] == d;
        for (int j = 0; j < ref.num(); j++) hit |= ref.delta[j] + d == want.delta[i];
        ok = hit;
      }
      if (!ok) continue;
      want.delta_rps = d;
      want.delta_idx_minus1 = delta_idx_minus1;
      int nd = ref.num();
      for (int j = 0; j <= nd; j++) {
        int dp = (j < nd ? ref.delta[j] : 0) + d;
        int at = -1;
        for (int i = 0; i < want.num(); i++)
          if (want.delta[i] == dp) at = i;
        want.use_delta[j] = at >= 0;
        want.used_by_curr[j] = at >= 0 ? want.used[at] : 0;
      }
      return true;
    }
    return false;
  }

  int length_size() const {
    int l = o.get("length_size", 4);
    if (l != 1 && l != 2 && l != 4) fail("length_size must be 1, 2 or 4");
    return l;
  }

  void write(const uint8_t* bgr) {
    if (ended) return;
    if (!random_mode) {
      if (!bgr) fail("frames mode needs frames");
      load_source(bgr);
    }
    code_picture();
  }

  // the next picture's POC and NAL unit type, by the GOP structure
  void next_poc(int& poc, int& type) {
    bool irap = decoded == 0 || (gop && since_irap >= gop && pending.empty());
    if (irap) {
      bool cra = decoded > 0 && (o.get("cra", 0) == 1 || (o.get("cra", 0) == 2 && rng.chance(0.5)));
      bool cra_first = decoded == 0 && o.get("cra", 0) == 3;
      if (cra || cra_first) {
        type = CRA;
        poc = decoded ? last_poc + 1 : rng.range(0, 4);
      } else {
        type = o.get("idr_n_lp", 0) && rng.chance(0.5) ? IDR_N_LP : IDR_W_RADL;
        poc = 0;
      }
      since_irap = 0;
      return;
    }
    if (pending.empty()) {
      int g = rng.range(1, group);
      int base = last_poc;
      pending.push_back(base + g);  // the anchor first
      std::vector<int> rest;
      for (int k = 1; k < g; k++) rest.push_back(base + k);
      for (size_t i = rest.size(); i > 1; i--) std::swap(rest[i - 1], rest[rng.range(0, (int)i - 1)]);
      pending.insert(pending.end(), rest.begin(), rest.end());
    }
    poc = pending.front();
    pending.erase(pending.begin());
    type = TRAIL_R;
    if (!random_mode) return;
    if (rng.chance(o.getf("nonref", 0.2))) type = TRAIL_N;
  }

  void code_picture() {
    int poc, type;
    next_poc(poc, type);
    bool irap = is_irap(type);
    // the RPS: the most recent references of this IRAP period
    StRps rps;
    std::vector<int> keep;
    if (!is_idr(type)) {
      if (type == CRA) {  // earlier pictures stay as unused references (for RASL pictures)
        for (const PicInfo& pi : pics)
          if (rng.chance(0.5)) keep.push_back(pi.poc);
      } else {
        for (int i = (int)pics.size() - 1; i >= 0 && (int)keep.size() < max_refs; i--)
          if (!(random_mode && rng.chance(0.1) && keep.size())) keep.push_back(pics[i].poc);
      }
    }
    std::vector<int> neg, pos;
    for (int k : keep) (k < poc ? neg : pos).push_back(k - poc);
    std::sort(neg.begin(), neg.end(), [](int a, int b) { return a > b; });
    std::sort(pos.begin(), pos.end());
    rps.num_neg = (int)neg.size();
    rps.num_pos = (int)pos.size();
    for (int i = 0; i < rps.num_neg; i++) rps.delta[i] = neg[i];
    for (int i = 0; i < rps.num_pos; i++) rps.delta[rps.num_neg + i] = pos[i];
    int used_count = 0;
    for (int i = 0; i < rps.num(); i++) {
      rps.used[i] = type != CRA && (!random_mode || rng.chance(0.75));
      used_count += rps.used[i];
    }
    if (type != CRA && rps.num() && !used_count) { rps.used[0] = 1; used_count = 1; }
    bool inter_pic = !irap && used_count > 0 && !o.get("intra_only", 0);
    if (refuse == "missing_ref" && decoded == 1) {
      rps.delta[rps.num_neg] = -100 + 0;
      rps.num_neg++;
      std::sort(rps.delta, rps.delta + rps.num_neg, [](int a, int b) { return a > b; });
      rps.used[rps.num_neg - 1] = 0;
    }

    // picture-level slice header choices
    const SPS& s = codec.sps[0];
    int pps_id = rng.range(0, (int)ppss.size() - 1);
    const PPS& pp = ppss[pps_id];
    SliceHeader base;
    base.nal_type = type;
    base.temporal_id = 0;
    base.pps_id = pps_id;
    base.pic_output = pp.output_flag_present ? (random_mode ? !rng.chance(o.getf("hidden_share", 0.2)) : 1) : 1;
    base.no_output_prior = irap && random_mode && rng.chance(o.getf("no_output_prior", 0.3));
    base.poc_lsb = poc & ((1 << s.log2_max_poc_lsb) - 1);
    // the RPS: an SPS set, explicit, or predicted from an SPS set
    int match = -1;
    for (int i = 0; i < s.num_st_rps; i++)
      if (s.st_rps[i].same(rps)) match = i;
    if (match >= 0 && (!random_mode || rng.chance(0.8))) {
      base.rps_sps = 1;
      base.rps_idx = match;
    } else {
      base.rps_sps = 0;
      base.rps_own = rps;
      if (s.num_st_rps && random_mode && rng.chance(o.getf("inter_rps_share", 0.6))) {
        int r = rng.range(0, s.num_st_rps - 1);
        StRps t = rps;
        if (inter_rps(t, s.st_rps[r], s.num_st_rps - 1 - r)) {
          t.inter = 1;
          base.rps_own = t;
        }
      }
    }
    base.tmvp = s.temporal_mvp && inter_pic && (random_mode ? rng.chance(0.7) : 1);
    int col_poc = 0;
    std::vector<int> curr;  // StCurrBefore then StCurrAfter
    for (int i = 0; i < rps.num(); i++)
      if (rps.used[i]) curr.push_back(poc + rps.delta[i]);
    if (base.tmvp) col_poc = curr[rng.range(0, (int)curr.size() - 1)];

    // slices: CTB addresses where they start
    int nctb = s.wctb * s.hctb;
    int nslices = std::min(nctb, random_mode ? rng.range(1, o.get("slices", 1)) : 1);
    std::vector<int> starts = {0};
    while ((int)starts.size() < nslices) {
      int a = rng.range(1, nctb - 1);
      if (std::find(starts.begin(), starts.end(), a) == starts.end()) starts.push_back(a);
    }
    std::sort(starts.begin(), starts.end());

    std::vector<uint8_t> sample;
    auto append = [&](const std::vector<uint8_t>& nal) {
      int l = length_size();
      if (nal.size() >= (1ull << (8 * l))) fail("NAL unit too long for length_size");
      put_be(sample, nal.size(), l);
      sample.insert(sample.end(), nal.begin(), nal.end());
    };
    bool inband = o.get("hev1", 0) || o.get("inband", 0);
    if (irap && inband) {
      append(vps_nal);
      append(sps_nal);
      for (const auto& pn : pps_nals) append(pn);
    }
    if (refuse == "leading" && decoded == 2) base.nal_type = type = 8;  // RASL_N
    std::unique_ptr<Chooser> chooser;
    RandomChooser* rc = nullptr;
    FramesChooser* fc = nullptr;
    if (random_mode) {
      rc = new RandomChooser(codec, rng);
      chooser.reset(rc);
      rc->p_skip = o.getf("skip", 0.25);
      rc->p_pcm = o.getf("pcm_share", 0.08);
      for (size_t i = 1; i < starts.size(); i++) rc->slice_ends.push_back(starts[i] - 1);
    } else {
      fc = new FramesChooser(codec, src);
      chooser.reset(fc);
    }
    codec.ch = chooser.get();
    for (size_t si = 0; si < starts.size(); si++) {
      SliceHeader h = base;
      h.first = si == 0;
      h.address = starts[si];
      h.type = inter_pic && (!random_mode || rng.chance(0.85)) ? SLICE_P : SLICE_I;
      if (!inter_pic) h.type = SLICE_I;
      if (refuse == "b_slice" && decoded == 1) h.type = SLICE_B;
      if (refuse == "dependent_slice" && si == 1) h.dependent = 1;
      h.sao_luma = s.sao && (!random_mode || rng.chance(0.8));
      h.sao_chroma = s.sao && (!random_mode || rng.chance(0.7));
      if (h.type == SLICE_P) {
        int total = (int)curr.size();
        h.num_ref_override = random_mode ? rng.chance(0.6) : 1;
        h.num_ref[0] = h.num_ref_override ? (random_mode ? rng.range(1, std::min(15, total + 1)) : 1)
                                          : pp.num_ref_default[0];
        h.mod_flag[0] = pp.lists_modification && total > 1 && rng.chance(o.getf("mod_share", 0.6));
        if (h.mod_flag[0])
          for (int i = 0; i < h.num_ref[0]; i++) h.list_entry[0][i] = rng.range(0, total - 1);
        // the list as the decoder builds it, so the collocated picture is in it
        auto entry_poc = [&](int i) {
          int k = h.mod_flag[0] ? h.list_entry[0][i] : i;
          return curr[k % total];
        };
        if (h.tmvp) {
          int at = -1;
          for (int i = 0; i < h.num_ref[0] && at < 0; i++)
            if (entry_poc(i) == col_poc) at = i;
          if (at < 0) {
            int k = (int)(std::find(curr.begin(), curr.end(), col_poc) - curr.begin());
            if (pp.lists_modification && total > 1) {
              if (!h.mod_flag[0]) {
                h.mod_flag[0] = 1;
                for (int i = 0; i < h.num_ref[0]; i++) h.list_entry[0][i] = i % total;
              }
              at = rng.range(0, h.num_ref[0] - 1);
              h.list_entry[0][at] = k;
            } else {
              h.num_ref_override = 1;
              h.num_ref[0] = std::max(h.num_ref[0], k + 1);
              at = k;
            }
          }
          h.col_ref_idx = at;
        }
        h.cabac_init = pp.cabac_init_present && rng.chance(0.5);
        h.max_merge = random_mode ? rng.range(1, 5) : 5;
        if (pp.weighted_pred) random_weights(h);
      }
      h.qp_delta = random_mode ? rng.range(-6, 6) : qp - pp.init_qp;
      if (pp.init_qp + h.qp_delta < 0 || pp.init_qp + h.qp_delta > 51) h.qp_delta = 0;
      if (pp.slice_chroma_offsets) {
        h.cb_offset = clip3(-12 - pp.cb_qp_offset, 12 - pp.cb_qp_offset, rng.range(-12, 12));
        h.cr_offset = clip3(-12 - pp.cr_qp_offset, 12 - pp.cr_qp_offset, rng.range(-12, 12));
      }
      if (pp.deblock_override && rng.chance(0.6)) {
        h.deblock_override = 1;
        // not in a picture's first slice: FFmpeg's offsets for it would depend
        // on its thread count (hevc.h: start_picture)
        h.deblock_disabled = si > 0 && rng.chance(o.getf("deblock_off_share", 0.25));
        h.beta_div2 = rng.range(-6, 6);
        h.tc_div2 = rng.range(-6, 6);
      }
      h.lf_across = rng.chance(0.5);
      Bits& b = codec.bits;
      b.start_write();
      const SPS* sp;
      const PPS* ppp;
      slice_header_syntax(b, h, codec.sps, codec.pps, sp, ppp);
      bool stop = refuse == "b_slice" && h.type == SLICE_B;
      stop |= refuse == "dependent_slice" && h.dependent;
      stop |= refuse == "missing_ref" && decoded == 1;
      stop |= refuse == "leading" && type == 8;
      if (!stop) {
        codec.set_slice(h, sp, ppp);
        if (h.first) {
          codec.start_picture();
          if (codec.poc != poc) fail("writer: POC " + std::to_string(poc) + " decodes as " +
                                     std::to_string(codec.poc));
        }
        codec.start_slice();
        codec.slice_data();
      } else {
        b.trailing();
        ended = true;
      }
      append(nal_unit(type, 0, b.out));
      if (stop) break;
    }
    codec.finish_picture();
    codec.ch = nullptr;
    codec.ready.clear();
    // the sample, and what the GOP keeps
    written += sample.size();
    if (fwrite(sample.data(), 1, sample.size(), f) != sample.size()) fail("write failed");
    sizes.push_back((uint32_t)sample.size());
    if (irap) sync.push_back((uint32_t)sizes.size());
    if (is_idr(type)) {
      display_base = decoded ? display_base + last_poc_max + 1 : 0;
      last_poc_max = 0;
    }
    last_poc_max = std::max(last_poc_max, poc);
    sample_display.push_back(display_base + poc);
    if (irap) pics.clear();  // trailing pictures reference nothing before an IRAP
    // the references that later pictures may keep: those in this RPS, and this picture
    std::vector<PicInfo> next;
    for (const PicInfo& pi : pics)
      if (std::find(keep.begin(), keep.end(), pi.poc) != keep.end()) next.push_back(pi);
    pics = next;
    if (type != TRAIL_N) pics.push_back({poc, true, decoded});
    if (poc > last_poc) last_poc = poc;
    if (is_idr(type)) last_poc = 0;
    decoded++;
    since_irap++;
  }
  int last_poc_max = 0;

  void random_weights(SliceHeader& h) {
    h.luma_denom = rng.range(0, 7);
    h.chroma_denom = rng.range(0, 7);
    for (int i = 0; i < h.num_ref[0]; i++) {
      h.lw_flag[i] = rng.chance(0.6);
      h.cw_flag[i] = rng.chance(0.6);
      h.dlw[i] = rng.range(-30, 30);
      h.lo[i] = rng.range(-40, 40);
      for (int j = 0; j < 2; j++) {
        h.dcw[i][j] = rng.range(-30, 30);
        h.dco[i][j] = rng.range(-200, 200);
      }
    }
  }

  // ------------------------------------------------ frames mode source --
  void load_source(const uint8_t* bgr) {
    src.alloc(cw, ch);
    // BT.601 limited range, as FFmpeg's swscale converts BGR24 for an encoder
    for (int y = 0; y < ch; y++) {
      const uint8_t* row = bgr + (size_t)std::min(y, height - 1) * width * 3;
      for (int x = 0; x < cw; x++) {
        const uint8_t* px = row + 3 * std::min(x, width - 1);
        src.y[(size_t)y * cw + x] = clip8((int)std::lround(16 + (65.481 * px[2] + 128.553 * px[1] + 24.966 * px[0]) / 255.0));
      }
    }
    for (int y = 0; y < ch / 2; y++)
      for (int x = 0; x < cw / 2; x++) {
        double r = 0, g = 0, b = 0;
        for (int j = 0; j < 2; j++)
          for (int i = 0; i < 2; i++) {
            const uint8_t* px = bgr + ((size_t)std::min(2 * y + j, height - 1) * width + std::min(2 * x + i, width - 1)) * 3;
            b += px[0];
            g += px[1];
            r += px[2];
          }
        r /= 4; g /= 4; b /= 4;
        src.cb[(size_t)y * cw / 2 + x] = clip8((int)std::lround(128 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255.0));
        src.cr[(size_t)y * cw / 2 + x] = clip8((int)std::lround(128 + (112.0 * r - 93.786 * g - 18.214 * b) / 255.0));
      }
  }

  void release() {
    if (!f) return;
    std::vector<uint8_t> hvcc;
    bool hev1 = o.get("hev1", 0);
    hvcc.push_back(1);                                   // configurationVersion
    hvcc.push_back((uint8_t)(sps.profile_idc & 31));     // profile space, tier, profile
    put_be(hvcc, 0x60000000u, 4);                        // compatibility flags (1 and 2)
    put_be(hvcc, 0x900000000000ull, 6);                  // progressive, frame-only
    hvcc.push_back(93);                                  // level
    put_be(hvcc, 0xF000, 2);                             // min_spatial_segmentation_idc
    hvcc.push_back(0xFC);                                // parallelismType
    hvcc.push_back(0xFC | 1);                            // chromaFormat
    hvcc.push_back(0xF8);                                // bitDepthLumaMinus8
    hvcc.push_back(0xF8);                                // bitDepthChromaMinus8
    put_be(hvcc, 0, 2);                                  // avgFrameRate
    hvcc.push_back((uint8_t)(0x08 | (length_size() - 1)));  // 1 temporal layer, lengthSizeMinusOne
    bool sets = !hev1;
    hvcc.push_back(sets ? 3 : 0);
    if (sets) {
      const std::vector<uint8_t>* one[2] = {&vps_nal, &sps_nal};
      int types[2] = {VPS_NUT, SPS_NUT};
      for (int k = 0; k < 2; k++) {
        hvcc.push_back((uint8_t)(0x80 | types[k]));
        put_be(hvcc, 1, 2);
        put_be(hvcc, one[k]->size(), 2);
        hvcc.insert(hvcc.end(), one[k]->begin(), one[k]->end());
      }
      hvcc.push_back((uint8_t)(0x80 | PPS_NUT));
      put_be(hvcc, pps_nals.size(), 2);
      for (const auto& pn : pps_nals) {
        put_be(hvcc, pn.size(), 2);
        hvcc.insert(hvcc.end(), pn.begin(), pn.end());
      }
    }
    MoovSpec spec;
    spec.width = width;
    spec.height = height;
    spec.timescale = fps_num;
    spec.delta = fps_den;
    spec.entry_type = hev1 ? "hev1" : "hvc1";
    spec.entry = visual_entry(width, height);
    box(spec.entry, "hvcC", hvcc);
    spec.sizes = sizes;
    spec.sync = sync;
    spec.mdat_start = mdat_start;
    spec.big = mdat_start + written > 0xFFFFFFFFull;
    spec.rotation = o.get("rotation", 0);
    // composition offsets of reordered pictures as FFmpeg's muxer writes
    // them (version 0 with one edit from the first composition time)
    std::vector<int> order(sample_display.size());
    for (size_t i = 0; i < order.size(); i++) order[i] = (int)i;
    std::sort(order.begin(), order.end(), [&](int a, int b) { return sample_display[a] < sample_display[b]; });
    std::vector<int> rank(order.size());
    for (size_t i = 0; i < order.size(); i++) rank[order[i]] = (int)i;
    bool reordered = false;
    for (size_t i = 0; i < rank.size(); i++) reordered |= rank[i] != (int)i;
    if (reordered && o.get("ctts", 1)) {
      int delay = 0;
      for (size_t i = 0; i < rank.size(); i++) delay = std::max(delay, (int)i - rank[i]);
      for (size_t i = 0; i < rank.size(); i++) spec.ctts.push_back((rank[i] - (int)i + delay) * fps_den);
      spec.edit_media_time = (int64_t)delay * fps_den;
    }
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

// a random prediction unit: a merge candidate whose vector stays near the
// picture, or a vector drawn near the picture coded against a predictor
void RandomChooser::pu(int x, int y, int pw, int ph, int, const Motion* cands, PuChoice& ch) {
  const SPS& s = *c.s;
  auto near = [&](int mvx, int mvy) {
    int rx = x + (mvx >> 2), ry = y + (mvy >> 2);
    return rx > -48 - pw && ry > -48 - ph && rx < s.width + 48 && ry < s.height + 48;
  };
  int n = c.sh.max_merge;
  if (rng.chance(p_merge)) {
    int idx = rng.range(0, n - 1);
    if (near(cands[idx].mv[0][0], cands[idx].mv[0][1])) {
      ch.merge = 1;
      ch.merge_idx = idx;
      return;
    }
  }
  ch.merge = 0;
  ch.ref_idx = rng.range(0, c.sh.num_ref[0] - 1);
  ch.mvp = rng.range(0, 1);
  int mvp[2];
  c.amvp_query(ch.ref_idx, ch.mvp, mvp);
  int tx, ty;
  if (rng.chance(0.3)) { tx = mvp[0] + rng.range(-3, 3); ty = mvp[1] + rng.range(-3, 3); }
  else {
    tx = rng.range((-40 - x) * 4, (s.width + 40 - x - pw) * 4);
    ty = rng.range((-40 - y) * 4, (s.height + 40 - y - ph) * 4);
  }
  if (!near(tx, ty)) { tx = 0; ty = 0; }
  ch.mvd[0] = tx - mvp[0];
  ch.mvd[1] = ty - mvp[1];
  if (std::abs(ch.mvd[0]) > 32767 || std::abs(ch.mvd[1]) > 32767) ch.mvd[0] = ch.mvd[1] = 0;
}

// ------------------------------------------------------------ frames --
void FramesChooser::predict_motion(int x0, int y0, int n, int mvx, int mvy, int ref, uint8_t* pred[3]) {
  static thread_local std::vector<int16_t> t;
  t.resize((size_t)n * n);
  const Picture& r = *c.list0[ref];
  c.mc_luma(r, x0, y0, n, n, mvx, mvy, t.data());
  for (int i = 0; i < n * n; i++) pred[0][i] = clip8((t[i] + 32) >> 6);
  for (int k = 1; k < 3; k++) {
    c.mc_chroma(r, k, x0 / 2, y0 / 2, n / 2, n / 2, mvx, mvy, t.data());
    for (int i = 0; i < n * n / 4; i++) pred[k][i] = clip8((t[i] + 32) >> 6);
  }
}

bool FramesChooser::quantise(int comp, int x0, int y0, int log2, const uint8_t* pred, int pstride,
                             bool intra, int16_t* out) {
  const Tables& T = tables();
  int n = 1 << log2, step = 32 >> log2;
  const uint8_t* s8 = src.plane(comp);
  int stride = src.stride(comp);
  int res[32 * 32], tmp[32 * 32];
  for (int y = 0; y < n; y++)
    for (int x = 0; x < n; x++) res[y * n + x] = s8[(y0 + y) * stride + x0 + x] - pred[y * pstride + x];
  // forward transform: columns then rows, shifts log2 - 1 and log2 + 6
  int s1 = log2 - 1, s2 = log2 + 6;
  for (int k = 0; k < n; k++)
    for (int x = 0; x < n; x++) {
      int64_t v = 0;
      for (int y = 0; y < n; y++) v += T.dct[k * step][y] * res[y * n + x];
      tmp[k * n + x] = (int)((v + (1 << (s1 - 1))) >> s1);
    }
  int q = comp ? (comp == 1 ? c.qp_cb : c.qp_cr) : c.qp_y;
  static const int kQuant[6] = {26214, 23302, 20560, 18396, 16384, 14564};
  int qbits = 21 + q / 6 - log2;
  int64_t offset = (int64_t)(intra ? 171 : 85) << (qbits - 9);
  bool any = false;
  for (int k = 0; k < n; k++)
    for (int l = 0; l < n; l++) {
      int64_t v = 0;
      for (int x = 0; x < n; x++) v += T.dct[l * step][x] * tmp[k * n + x];
      int coef = (int)((v + (1LL << (s2 - 1))) >> s2);
      int64_t a = ((int64_t)std::abs(coef) * kQuant[q % 6] + offset) >> qbits;
      int lvl = (int)std::min<int64_t>(a, 32767);
      out[k * n + l] = (int16_t)(coef < 0 ? -lvl : lvl);
      any |= lvl != 0;
    }
  return any;
}

void FramesChooser::cu(int x0, int y0, int log2, CuChoice& ch) {
  int n = 1 << log2;
  ch = CuChoice{};
  static thread_local std::vector<uint8_t> buf[3], best[3];
  for (int k = 0; k < 3; k++) {
    buf[k].resize((size_t)n * n);
    best[k].resize((size_t)n * n);
  }
  // intra: the best of planar, DC, horizontal and vertical by luma SAD (the
  // prediction is made in the picture, where the decoding process makes it again)
  Picture& cur = *c.cur;
  int best_sad = 1 << 30;
  mode = 1;
  const int modes[4] = {0, 1, 10, 26};
  for (int m : modes) {
    c.intra_pred(0, x0, y0, log2, m);
    int sd = 0;
    for (int y = 0; y < n; y++)
      for (int x = 0; x < n; x++)
        sd += std::abs(src.y[(size_t)(y0 + y) * src.w + x0 + x] - cur.y[(size_t)(y0 + y) * cur.w + x0 + x]);
    if (sd < best_sad) { best_sad = sd; mode = m; }
  }
  bool inter = c.sh.type == SLICE_P;
  int inter_sad = 1 << 30, mvx = 0, mvy = 0, merge_idx = -1;
  Motion cands[5];
  if (inter) {
    c.cu_part = P2Nx2N;
    c.merge_list(x0, y0, n, n, 0, cands);
    uint8_t* pr[3] = {buf[0].data(), buf[1].data(), buf[2].data()};
    for (int i = 0; i < c.sh.max_merge; i++) {
      predict_motion(x0, y0, n, cands[i].mv[0][0], cands[i].mv[0][1], cands[i].ref[0], pr);
      int sd = sad(0, x0, y0, n, buf[0].data(), n);
      if (sd < inter_sad) { inter_sad = sd; merge_idx = i; }
    }
    // an integer diamond search from zero and from the best candidate
    // (luma SAD straight from the reference where the block lies inside it)
    const Picture& ref = *c.list0[0];
    auto sad_at = [&](int vx, int vy) {
      int rx = x0 + (vx >> 2), ry = y0 + (vy >> 2);
      if (rx < 0 || ry < 0 || rx + n > ref.w || ry + n > ref.h) return 1 << 30;
      int t = 16;  // a little against coding a vector
      for (int y = 0; y < n; y++) {
        const uint8_t* a = &src.y[(size_t)(y0 + y) * src.w + x0];
        const uint8_t* b = &ref.y[(size_t)(ry + y) * ref.w + rx];
        for (int x = 0; x < n; x++) t += std::abs(a[x] - b[x]);
      }
      return t;
    };
    int starts[2][2] = {{0, 0}, {merge_idx >= 0 ? cands[merge_idx].mv[0][0] & ~3 : 0,
                                 merge_idx >= 0 ? cands[merge_idx].mv[0][1] & ~3 : 0}};
    for (auto& st : starts) {
      int bx = st[0], by = st[1], bs = sad_at(bx, by);
      for (int step = 16; step >= 4; step >>= 1)
        for (bool moved = true; moved;) {
          moved = false;
          const int d[4][2] = {{step, 0}, {-step, 0}, {0, step}, {0, -step}};
          for (const auto& dd : d) {
            int v = sad_at(bx + dd[0], by + dd[1]);
            if (v < bs) { bs = v; bx += dd[0]; by += dd[1]; moved = true; }
          }
        }
      if (bs < inter_sad) { inter_sad = bs; mvx = bx; mvy = by; merge_idx = -1; }
    }
  }
  if (!inter || best_sad < inter_sad) {
    ch.intra = 1;
    ch.part = P2Nx2N;
    // the residual of luma and chroma from their intra predictions
    c.intra_pred(0, x0, y0, log2, mode);
    nz[0] = quantise(0, x0, y0, log2, &cur.y[(size_t)y0 * cur.w + x0], cur.w, true, lv[0]);
    for (int k = 1; k < 3; k++) {
      c.intra_pred(k, x0 / 2, y0 / 2, log2 - 1, mode);
      nz[k] = quantise(k, x0 / 2, y0 / 2, log2 - 1, &cur.plane(k)[(size_t)(y0 / 2) * (cur.w / 2) + x0 / 2],
                       cur.w / 2, true, lv[k]);
    }
    return;
  }
  ch.intra = 0;
  ch.part = P2Nx2N;
  uint8_t* pr[3] = {best[0].data(), best[1].data(), best[2].data()};
  if (merge_idx >= 0) {
    pu_plan = PuChoice{};
    pu_plan.merge = 1;
    pu_plan.merge_idx = merge_idx;
    predict_motion(x0, y0, n, cands[merge_idx].mv[0][0], cands[merge_idx].mv[0][1], cands[merge_idx].ref[0], pr);
  } else {
    pu_plan = PuChoice{};
    pu_plan.merge = 0;
    pu_plan.ref_idx = 0;
    int l[2][2];
    c.amvp(x0, y0, n, n, 0, 0, l);
    int f = std::abs(mvx - l[1][0]) + std::abs(mvy - l[1][1]) < std::abs(mvx - l[0][0]) + std::abs(mvy - l[0][1]);
    pu_plan.mvp = f;
    pu_plan.mvd[0] = mvx - l[f][0];
    pu_plan.mvd[1] = mvy - l[f][1];
    predict_motion(x0, y0, n, mvx, mvy, 0, pr);
  }
  nz[0] = quantise(0, x0, y0, log2, best[0].data(), n, false, lv[0]);
  nz[1] = quantise(1, x0 / 2, y0 / 2, log2 - 1, best[1].data(), n / 2, false, lv[1]);
  nz[2] = quantise(2, x0 / 2, y0 / 2, log2 - 1, best[2].data(), n / 2, false, lv[2]);
  bool any = nz[0] || nz[1] || nz[2];
  ch.skip = merge_idx >= 0 && !any;
  ch.rqt_root_cbf = any;
}

}  // namespace

extern "C" {

// opts: "key=value;..."; mode=random draws the syntax from seed, mode=frames
// codes the frames given to hevc_writer_write
void* hevc_writer_open(const char* path, int width, int height, int fps_num, int fps_den,
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
int hevc_writer_write(void* h, const uint8_t* bgr, char* err, int errlen) {
  try {
    static_cast<Writer*>(h)->write(bgr);
    return 0;
  } catch (const Error& e) {
    return report(e, err, errlen);
  }
}

// writes the moov box and closes the file; frees the writer
int hevc_writer_close(void* h, char* err, int errlen) {
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
