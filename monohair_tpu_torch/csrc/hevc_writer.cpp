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
//   AMVP with every candidate kind, list 0, list 1 or bi-prediction in B
//   slices, each intra mode and chroma mode, PCM, the residual quadtree,
//   coefficients (with escapes), transform skip, sign data hiding,
//   cu_qp_delta, transquant bypass, SAO parameters and merges; per picture
//   IDR, CRA, trailing and RASL/RADL leading NAL unit types, POCs out of
//   decode order in groups, the RPS (from the SPS, explicit or inter
//   predicted), pic_output_flag; per slice its type, the lengths and
//   modification of both reference lists, mvd_l1_zero_flag, TMVP and its
//   collocated list, weights of both lists, merge candidates, QP and chroma
//   offsets, deblocking override and offsets, SAO flags, filtering across
//   slices; when asked for, WPP or tiles (their layout drawn) and
//   dependent slice segments, each slice segment's data coded before its
//   header so that the header carries its entry points.
// - frames: BGR frames in, an I/P or I/P/B stream of them out at a fixed
//   QP: 16x16 coding units under CTBs of 16, 32 or 64 (the size given),
//   intra 2Nx2N (the best of planar, DC, horizontal and vertical), or in P
//   and B pictures skip/merge from the best merge candidate or AMVP from a
//   small integer search in each list (in B pictures list 0, list 1 or the
//   average of both), each with a quantised residual; WPP, tiles and
//   slice segments as in random mode.
// The MP4 (ftyp "isom" or "qt  ", mdat, moov with an hvc1 or hev1 sample
// entry and its hvcC) can carry a rotation in tkhd's matrix and the
// composition offsets of reordered pictures. The NAL units carry 4-byte
// lengths, or 1 or 2 (length_size). Options come as "key=value;..." (see
// io/hevc_streams.py).

#include <cmath>
#include <deque>
#include <iterator>

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
  Rng& rng_bd;  // what only 9- and 10-bit streams draw
  RandomChooser(Hevc& co, Rng& r, Rng& r_bd) : c(co), rng(r), rng_bd(r_bd) {}
  // at more than 8 bits, half the PCM blocks sample one smooth surface over
  // the picture, gently curved (its second difference over 32 samples 4-40
  // levels), so that 32x32 intra blocks beside them reach the strong
  // smoothing threshold 1 << (bitDepth - 5) from both sides
  int field[4] = {-1, 0, 0, 0};  // level at the origin, slope across and down (/16), curvature
  double p_split = 0.55, p_skip = 0.25, p_intra = 0.2, p_pcm = 0.08, p_bypass = 0.08;
  double p_merge = 0.4, p_tskip = 0.3, p_qp = 0.5;

  void sao(int, int, bool left_ok, bool up_ok, int& ml, int& mu, SaoParams& p) override {
    ml = left_ok && rng.chance(0.25);
    mu = !ml && up_ok && rng.chance(0.25);
    for (int k = 0; k < 2; k++) {
      p.type[k] = rng.range(0, 2);
      p.eo[k] = rng.range(0, 3);
    }
    p.type[2] = p.type[1];
    p.eo[2] = p.eo[1];
    // sao_offset_abs up to (1 << (Min(bitDepth, 10) - 5)) - 1
    int most = (1 << (std::min(c.s->bit_depth, 10) - 5)) - 1;
    for (int k = 0; k < 3; k++) {
      p.band[k] = rng.range(0, 31);
      for (int i = 0; i < 4; i++) {
        int a = rng.chance(0.3) ? 0 : rng.range(1, most);
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
    bool inter_ok = c.sh.type != SLICE_I;
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
  void pcm_samples(int x0, int y0, int log2, Pel* smp) override {
    const SPS& s = *c.s;
    int n = 1 << log2, nl = n * n, nc = n * n / 2;
    int maxv = s.max_pel(), spread = 40 << (s.bit_depth - 8), base = rng.range(0, maxv);
    if (s.bit_depth > 8 && field[0] < 0) {
      field[0] = rng_bd.range(0, maxv / 2);
      field[1] = rng_bd.range(-8, 8);
      field[2] = rng_bd.range(-8, 8);
      field[3] = rng_bd.range(8, 80);
    }
    if (s.bit_depth > 8 && rng_bd.chance(0.5)) {
      for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++) {
          int64_t X = x0 + x, Y = y0 + y;
          int v = field[0] + (int)((X * field[1] + Y * field[2]) >> 4) +
                  (int)(((X * X + Y * Y) * field[3]) >> 12);
          smp[y * n + x] = (Pel)(clip3(0, maxv, v) >> (s.bit_depth - s.pcm_bd));
        }
    } else {
      for (int i = 0; i < nl; i++)
        smp[i] = (Pel)(clip3(0, maxv, base + rng.range(-spread, spread)) >> (s.bit_depth - s.pcm_bd));
    }
    for (int i = 0; i < nc; i++) smp[nl + i] = (Pel)(rng.range(0, maxv) >> (s.bit_depth_c - s.pcm_bd_c));
  }
  int intra_mode(int, int, int) override { return rng.range(0, 34); }
  int chroma_mode(int, int, int) override { return rng.range(0, 4); }
  void pu(int x, int y, int pw, int ph, int, const Motion* cands, PuChoice& ch) override;
  int split_tf(int, int, int, int) override { return rng.chance(0.4); }
  int cbf(int comp, int, int, int, int) override { return rng.chance(comp ? 0.45 : 0.6); }
  int qp_delta(int, int) override {
    if (!rng.chance(p_qp)) return 0;
    int half = c.s->qp_bd_offset() / 2;  // CuQpDeltaVal's range widens at more than 8 bits
    return rng.chance(0.85) ? rng.range(-6, 6) : rng.range(-(26 + half), 25 + half);
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
    // at more than 8 bits, now and then a level near the largest in a
    // transquant-bypass block: its residual then overflows 16 bits beside
    // the prediction, as FFmpeg adds it
    if (c.s->bit_depth > 8 && c.cu_bypass && rng_bd.chance(0.2))
      lv[rng_bd.range(0, n * n - 1)] = (int16_t)rng_bd.range(32000, 32767);
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
  void pcm_samples(int, int, int, Pel*) override {}
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

  int sad(int comp, int x0, int y0, int n, const Pel* pred, int pstride) const {
    const Pel* s8 = src.plane(comp);
    int stride = src.stride(comp), t = 0;
    for (int y = 0; y < n; y++)
      for (int x = 0; x < n; x++) t += std::abs(s8[(y0 + y) * stride + x0 + x] - pred[y * pstride + x]);
    return t;
  }
  // forward transform and quantisation of src - pred into levels; true if any
  bool quantise(int comp, int x0, int y0, int log2, const Pel* pred, int pstride, bool intra,
                int16_t* out);
  // the prediction of an n x n block with motion m (the decoding process's)
  void predict_motion(int x0, int y0, int n, const Motion& m, Pel* pred[3]) {
    int stride[3] = {n, n / 2, n / 2};
    c.predict_block(x0, y0, n, n, m, pred, stride);
  }
  // an integer diamond search of list l's first picture from zero and from
  // start; the vector and its luma SAD
  int search(int x0, int y0, int n, int l, const int* start, int* mv) const;
};

// ------------------------------------------------------------ writer --
// A picture the GOP structure asks for next: its POC, NAL unit type, display
// index, the leading pictures that follow an IRAP picture and, in frames
// mode, its frame and slice type
struct Job {
  int poc = 0, type = TRAIL_R, display = 0, lead = 0;
  int slice = -1;  // SLICE_I, SLICE_P or SLICE_B (frames mode); -1: drawn
  std::vector<uint8_t> bgr;
};

// what a picture that later pictures may name in their RPS is to them
enum PicKind { K_TRAIL, K_RASL, K_RADL, K_BEFORE_IRAP, K_GENERATED };
struct PicInfo {
  int poc, kind;
};

struct Writer {
  Options o;
  Rng rng{0};
  Rng rng_pps{0};  // the PPS's B-slice fields, drawn apart (streams without B slices stay as they were)
  Rng rng_par{0};  // tiles and slice segments, drawn apart likewise
  Rng rng_bd{0};   // what only 9- and 10-bit streams draw, apart likewise
  Rng rng_dv{0};   // the Dolby Vision RPU payloads, apart likewise
  int bit_depth = 8;
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
  // random mode: groups of up to `group` pictures whose last (by POC) is
  // coded first; an IRAP picture every `gop` pictures (0: only the first),
  // followed by up to `leading` leading pictures (RASL after a CRA, RADL
  // after an IDR_W_RADL)
  int group = 1, gop = 0, max_refs = 2, leading = 0;
  // frames mode: `bframes` B pictures between anchors, coded after the
  // anchor that follows them (with `pyramid` the middle one first, as a
  // reference); every `gop` frames the anchor is a CRA whose B pictures are
  // RASL (cra=1, an open GOP) or an IDR_W_RADL whose B pictures are RADL
  int bframes = 0, pyramid = 0;
  std::deque<Job> pending;  // the pictures of the current group still to code
  std::vector<Job> waiting;  // frames mode: frames in display order, not coded yet
  int frames_in = 0, irap_display = 0, idr_display = 0;
  int decoded = 0, since_irap = 0, last_poc = 0, display_base = 0, last_poc_max = 0;
  std::vector<PicInfo> pics;  // the pictures later ones may reference, decode order
  RaslRule ffmpeg_rasl;       // the RASL pictures FFmpeg skips: nothing may reference them
  bool held_generated = false;  // FFmpeg's DPB holds references generated for a starting CRA
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
    rng_pps = Rng((uint64_t)o.get("seed", 0) ^ 0x5bd1e995u);
    rng_par = Rng((uint64_t)o.get("seed", 0) ^ 0x27d4eb2fu);
    rng_bd = Rng((uint64_t)o.get("seed", 0) ^ 0x165667b1u);
    rng_dv = Rng((uint64_t)o.get("seed", 0) ^ 0x61c88647u);
    refuse = o.gets("refuse", "");
    bit_depth = o.get("bit_depth", 8);
    if (bit_depth < 8 || bit_depth > 10) fail("bit_depth must be 8, 9 or 10");
    qp = o.get("qp", 24);
    group = random_mode ? o.get("group", 1) : 1;
    gop = o.get("gop", 0);
    max_refs = std::max(1, o.get("refs", 2));
    leading = random_mode ? o.get("leading", 0) : 0;
    bframes = random_mode ? 0 : o.get("bframes", 0);
    pyramid = o.get("pyramid", 0);
    if (group < 1 || group > 8) fail("group must be within 1..8");
    if (max_refs > 6) fail("refs must be within 1..6");
    if (leading < 0 || leading > 6) fail("leading must be within 0..6");
    if (bframes < 0 || bframes > 4) fail("bframes must be within 0..4");
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
    bool deep = bit_depth > 8 || refuse == "bit_depth_mixed" || refuse == "bit_depth12";
    s.profile_idc = refuse == "rext" ? 4 : deep ? 2 : 1;
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
    s.bit_depth = s.bit_depth_c = refuse == "bit_depth12" ? 12 : bit_depth;
    if (refuse == "bit_depth_mixed") {
      s.bit_depth = 10;
      s.bit_depth_c = 8;
    }
    s.log2_max_poc_lsb = pick("poc_bits", 4, 8, 8);
    // pictures that may precede another in decode order and follow it in
    // output order: a group's, or an IRAP's leading pictures; two with a B
    // pyramid (the anchor and the middle B before the other B pictures)
    int reorder = random_mode ? std::max(group - 1, leading) : !bframes ? 0 : pyramid && bframes > 1 ? 2 : 1;
    s.max_sub_layers_minus1 = 0;
    s.ordering_info = rng.chance(0.5);
    s.max_reorder[0] = reorder + (random_mode && rng.chance(0.3) ? 1 : 0);
    s.max_dec_minus1[0] = std::min(15, max_refs + reorder + (random_mode ? rng.range(0, 2) : bframes ? 1 : 0));
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
      if (bit_depth > 8) {  // PCM depths up to the bit depth, or as given
        s.pcm_bd = rng_bd.range(5, bit_depth);
        s.pcm_bd_c = rng_bd.range(5, bit_depth);
      }
      if (o.kv.count("pcm_bd")) s.pcm_bd = s.pcm_bd_c = o.get("pcm_bd", 8);
      if (s.pcm_bd < 1 || s.pcm_bd > bit_depth) fail("pcm_bd must be within 1 and bit_depth");
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
            o.kv.count("primaries") || o.kv.count("transfer") || o.kv.count("chroma_loc_type");
    if (s.vui) {
      s.aspect = rng.chance(0.5);
      s.signal_type = o.kv.count("matrix") || o.kv.count("full_range") || rng.chance(0.3);
      s.full_range = o.get("full_range", 0);
      s.colour_desc = o.kv.count("matrix") || o.kv.count("primaries") || o.kv.count("transfer");
      s.matrix = o.get("matrix", 2);
      s.primaries = o.get("primaries", 2);
      s.transfer = o.get("transfer", 2);
      s.chroma_loc = rng.chance(0.3);
      if (o.kv.count("chroma_loc_type")) {  // 0 (left) to 5, or above (cv2: unspecified)
        s.chroma_loc = 1;
        s.chroma_loc_type = o.get("chroma_loc_type", 0);
      }
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
      p.dependent_slices = o.getf("dependent", 0) > 0;
      p.output_flag_present = chance("output_flag", 0.3, 0);
      p.extra_bits = random_mode ? rng.range(0, 2) : 0;
      p.sign_hiding = chance("sign_hiding", 0.5, 0);
      p.cabac_init_present = chance("cabac_init", 0.5, 0);
      p.num_ref_default[0] = random_mode ? rng.range(1, 3) : 1;
      bool bslices = o.getf("bslices", 0) > 0;
      p.num_ref_default[1] = random_mode && bslices ? rng_pps.range(1, 3) : 1;
      p.init_qp = random_mode ? rng.range(18, 40) : qp;
      // at more than 8 bits from -QpBdOffsetY, in the first PPS at or below
      // 0 (in another half the time), so that QpY goes below 0
      if (random_mode && bit_depth > 8)
        p.init_qp = !i || rng_bd.chance(0.5) ? rng_bd.range(-s.qp_bd_offset(), 0) : rng_bd.range(1, 40);
      p.constrained_intra = s.log2_min_cb == 3 && chance("constrained_intra", 0.25, 0);
      p.transform_skip = chance("transform_skip", 0.5, 0);
      p.cu_qp_delta = chance("cu_qp_delta", 0.5, 0);
      p.diff_cu_qp_delta_depth = p.cu_qp_delta ? rng.range(0, s.log2_diff_cb) : 0;
      p.cb_qp_offset = chance("chroma_offsets", 0.4, 0) ? rng.range(-12, 12) : 0;
      p.cr_qp_offset = chance("chroma_offsets", 0.4, 0) ? rng.range(-12, 12) : 0;
      p.slice_chroma_offsets = chance("chroma_offsets", 0.4, 0);
      p.weighted_pred = chance("weighted", 0.3, 0);
      p.weighted_bipred = o.kv.count("weighted_bipred") ? o.get("weighted_bipred", 0) != 0
                                                        : random_mode && bslices && rng_pps.chance(0.3);
      p.transquant_bypass = chance("bypass", 0.3, 0);
      p.wpp = o.get("wpp", 0) || refuse == "wpp_tiles";
      p.tiles = o.get("tiles", 0) || refuse == "wpp_tiles";
      if (p.tiles) draw_tiles(p, s);
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

  // the tile columns and rows (as given, else drawn), uniform or at drawn
  // widths and heights of one CTB or more, and loop_filter_across_tiles
  void draw_tiles(PPS& p, const SPS& s) {
    int W = s.wctb, H = s.hctb;
    if (W * H < 2) fail("tiles need a picture of two CTBs or more");
    p.tile_cols = o.kv.count("tile_cols") ? o.get("tile_cols", 1) : rng_par.range(1, std::min(W, 4));
    p.tile_rows = o.kv.count("tile_rows") ? o.get("tile_rows", 1) : rng_par.range(1, std::min(H, 4));
    if (p.tile_cols < 1 || p.tile_rows < 1 || p.tile_cols > W || p.tile_rows > H)
      fail("tile_cols and tile_rows must be within 1 and the picture's CTBs");
    if (p.tile_cols * p.tile_rows == 1) {
      if (o.kv.count("tile_cols") && o.kv.count("tile_rows")) fail("tiles need two tiles or more");
      (W > 1 ? p.tile_cols : p.tile_rows) = 2;
    }
    p.uniform = o.kv.count("uniform") ? o.get("uniform", 1) : rng_par.chance(0.5);
    // the sizes of all but the last of `parts` tiles along n CTBs: parts - 1 cuts
    auto sizes = [&](int n, int parts) {
      std::vector<int> cut;
      while ((int)cut.size() < parts - 1) {
        int c = rng_par.range(1, n - 1);
        if (std::find(cut.begin(), cut.end(), c) == cut.end()) cut.push_back(c);
      }
      std::sort(cut.begin(), cut.end());
      for (int i = (int)cut.size() - 1; i > 0; i--) cut[i] -= cut[i - 1];
      return cut;
    };
    if (!p.uniform) {
      p.col_w = sizes(W, p.tile_cols);
      p.row_h = sizes(H, p.tile_rows);
    }
    p.lf_across_tiles = o.kv.count("lf_across_tiles") ? o.get("lf_across_tiles", 1) : rng_par.chance(0.5);
  }

  // The slice segments of a picture: the tile-scan address where each
  // starts, and whether it is dependent. Without tiles, WPP or dependent
  // segments: up to `slices` slices (random mode) at drawn addresses. Else a
  // boundary comes at each CTB by chance, `slices` segments on average
  // (random mode: up to that many), each dependent by the share
  // `dependent`, where 6.3.1 and 7.4.7.1 let it be: a slice or a segment
  // holds whole tiles or lies in one, and under WPP one that starts inside
  // a CTB row ends in it (so a boundary comes where one must end).
  struct Segment {
    int ts;
    bool dependent;
  };
  std::vector<Segment> draw_segments(const PPS& pp) {
    const SPS& s = codec.sps[0];
    int n = s.wctb * s.hctb;
    std::vector<Segment> segs = {{0, false}};
    if (!pp.tiles && !pp.wpp && !pp.dependent_slices) {
      int nslices = std::min(n, random_mode ? rng.range(1, o.get("slices", 1)) : 1);
      std::vector<int> starts = {0};
      while ((int)starts.size() < nslices) {
        int a = rng.range(1, n - 1);
        if (std::find(starts.begin(), starts.end(), a) == starts.end()) starts.push_back(a);
      }
      std::sort(starts.begin(), starts.end());
      for (size_t i = 1; i < starts.size(); i++) segs.push_back({starts[i], false});
      return segs;
    }
    int want = random_mode ? rng_par.range(1, o.get("slices", 1)) : o.get("slices", 1);
    double p_cut = n > 1 ? (double)(want - 1) / (n - 1) : 0, p_dep = o.getf("dependent", 0);
    auto tile_start = [&](int t) { return t == 0 || t == n || pp.tile_id[t] != pp.tile_id[t - 1]; };
    auto row_start = [&](int t) { return t == n || pp.ts_to_rs[t] % s.wctb == 0; };
    // CTBs a to b - 1 may form a slice or a segment
    auto whole = [&](int a, int b) {
      if (pp.tiles && !(tile_start(a) && tile_start(b)) && pp.tile_id[a] != pp.tile_id[b - 1])
        return false;
      return !pp.wpp || row_start(a) || pp.ts_to_rs[a] / s.wctb == pp.ts_to_rs[b - 1] / s.wctb;
    };
    // one that starts at a and goes on past t - 1 breaks those rules
    auto must_end = [&](int a, int t) {
      return (pp.tiles && !tile_start(a) && tile_start(t)) || (pp.wpp && !row_start(a) && row_start(t));
    };
    int slice = 0, seg = 0;
    for (int t = 1; t < n; t++) {
      bool dep;
      if (must_end(slice, t)) dep = false;
      else if (must_end(seg, t) || rng_par.chance(p_cut)) dep = pp.dependent_slices && rng_par.chance(p_dep);
      else continue;
      if (!whole(seg, t) || (!dep && !whole(slice, t))) continue;
      segs.push_back({t, dep});
      seg = t;
      if (!dep) slice = t;
    }
    return segs;
  }

  // entry_point_offset_minus1 + 1 of each substream but the last: its bytes
  // in the NAL unit, emulation_prevention_three_bytes included (7.4.7.1).
  // The header before the data ends in a byte that is not 0, so the data
  // escapes alone as it does in the NAL unit.
  static std::vector<uint32_t> entry_offsets(const std::vector<uint8_t>& data,
                                             const std::vector<uint32_t>& starts) {
    std::vector<uint32_t> out;
    size_t k = 0, esc = 0, last = 0;
    int zeros = 0;
    for (size_t i = 0; k < starts.size(); i++) {
      if (i == starts[k]) {
        out.push_back((uint32_t)(esc - last));
        last = esc;
        k++;
      }
      if (i == data.size()) break;
      if (zeros >= 2 && data[i] <= 3) {
        esc++;
        zeros = 0;
      }
      esc++;
      zeros = data[i] == 0 ? zeros + 1 : 0;
    }
    return out;
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
    if (random_mode) {
      code_picture(next_job());
      return;
    }
    if (!bgr) fail("frames mode needs frames");
    Job j;
    j.display = frames_in++;
    j.bgr.assign(bgr, bgr + (size_t)width * height * 3);
    waiting.push_back(std::move(j));
    schedule(false);
  }

  // random mode: the next picture's POC and NAL unit type, by the GOP structure
  Job next_job() {
    Job j;
    // no IDR while the references generated for a CRA that starts the stream
    // are held (the decoder refuses it: FFmpeg keeps them past the IDR), in
    // what later pictures may name or in FFmpeg's DPB
    bool generated = held_generated || std::any_of(pics.begin(), pics.end(), [](const PicInfo& pi) {
                       return pi.kind == K_GENERATED;
                     });
    // the next anchor's POC may lie at most MaxPicOrderCntLsb / 2 above
    // prevTid0Pic's (8.3.1), which sub-layer non-reference pictures leave
    // behind: a smaller group then, or an IDR where even one picture would not
    int room = (1 << (codec.sps[0].log2_max_poc_lsb - 1)) - (last_poc - codec.poc_tid0);
    bool irap = decoded == 0 || (gop && since_irap >= gop && pending.empty() && !generated) ||
                (refuse == "idr_over_generated" && generated && pending.empty()) ||
                (pending.empty() && room < 1 && !generated);
    if (!irap) {
      if (pending.empty()) {
        int g = std::max(1, std::min(rng.range(1, group), room));
        int base = last_poc;
        Job a;
        a.poc = base + g;  // the anchor first
        pending.push_back(a);
        std::vector<int> rest;
        for (int k = 1; k < g; k++) rest.push_back(base + k);
        for (size_t i = rest.size(); i > 1; i--) std::swap(rest[i - 1], rest[rng.range(0, (int)i - 1)]);
        for (int r : rest) {
          Job b;
          b.poc = r;
          pending.push_back(b);
        }
      }
      j = pending.front();
      pending.pop_front();
      if (rng.chance(o.getf("nonref", 0.2))) j.type--;  // TRAIL_N, RASL_N, RADL_N
      return j;
    }
    int cra_opt = o.get("cra", 0);
    bool cra = decoded > 0 ? cra_opt == 1 || ((cra_opt == 2 || cra_opt == 4) && rng.chance(0.5))
                           : cra_opt >= 3;
    cra &= !decoded || room >= 1;  // a later CRA follows the pictures before it, within room
    j.type = cra ? CRA : o.get("idr_n_lp", 0) && rng.chance(0.5) ? IDR_N_LP : IDR_W_RADL;
    j.lead = leading && j.type != IDR_N_LP ? rng.range(0, leading) : 0;
    if (cra && decoded) j.lead = std::min(j.lead, room - 1);
    if (refuse == "idr_over_generated" && !decoded) j.lead = std::max(j.lead, 1);
    // the leading pictures: a CRA's RASL pictures between the pictures before
    // it and it; an IDR's RADL pictures before POC 0
    int first_lead;
    if (cra) {
      first_lead = decoded ? last_poc + 1 : rng.range(0, 4);
      j.poc = first_lead + j.lead;
      // a CRA that starts the stream: its RASL pictures name pictures before
      // it that the stream does not hold (the decoder generates them)
      if (!decoded && j.lead)
        for (int k = 1; k <= rng.range(1, 2); k++) pics.push_back({first_lead - k, K_GENERATED});
    } else {
      j.poc = 0;
      first_lead = -j.lead;
    }
    std::vector<int> lead;
    for (int k = 0; k < j.lead; k++) lead.push_back(first_lead + k);
    for (size_t i = lead.size(); i > 1; i--) std::swap(lead[i - 1], lead[rng.range(0, (int)i - 1)]);
    for (int q : lead) {
      Job b;
      b.poc = q;
      b.type = cra ? RASL_R : RADL_R;
      pending.push_back(b);
    }
    since_irap = 0;
    return j;
  }

  // frames mode: code the groups the frames so far complete (all at the end)
  void schedule(bool final) {
    while (!waiting.empty() && !ended) {
      if (decoded == 0) {
        Job j = std::move(waiting.front());
        waiting.erase(waiting.begin());
        j.type = IDR_W_RADL;
        j.slice = SLICE_I;
        irap_display = idr_display = j.display;
        code_picture(j);
        continue;
      }
      int n = std::min((int)waiting.size(), bframes + 1);
      if (n < bframes + 1 && !final) return;
      std::vector<Job> group_jobs(std::make_move_iterator(waiting.begin()),
                                  std::make_move_iterator(waiting.begin() + n));
      waiting.erase(waiting.begin(), waiting.begin() + n);
      Job& anchor = group_jobs.back();
      bool irap = gop && anchor.display - irap_display >= gop;
      bool open = irap && o.get("cra", 0);
      if (irap) irap_display = anchor.display;
      if (irap && !open) idr_display = anchor.display;
      anchor.type = !irap ? TRAIL_R : open ? CRA : IDR_W_RADL;
      anchor.slice = irap ? SLICE_I : SLICE_P;
      anchor.poc = anchor.display - idr_display;
      anchor.lead = irap ? n - 1 : 0;
      code_picture(anchor);
      int nb = n - 1, mid = pyramid && nb >= 2 ? (nb - 1) / 2 : -1;
      std::vector<int> order;
      if (mid >= 0) order.push_back(mid);
      for (int k = 0; k < nb; k++)
        if (k != mid) order.push_back(k);
      for (int k : order) {
        Job& b = group_jobs[k];
        b.poc = b.display - idr_display;
        b.slice = SLICE_B;
        int r = k == mid ? 1 : 0;  // the _R (reference) type, or the _N one
        b.type = (!irap ? TRAIL_N : open ? RASL_N : RADL_N) + r;
        code_picture(b);
      }
    }
  }

  void code_picture(const Job& j) {
    int poc = j.poc, type = j.type;
    if (!random_mode) load_source(j.bgr.data());
    bool irap = is_irap(type);
    bool rasl = type == RASL_N || type == RASL_R, radl = type == RADL_N || type == RADL_R;
    // what this picture may name in its RPS: a trailing picture nothing
    // before its IRAP picture in decode or output order, a RADL picture
    // its IRAP and RADL pictures, a RASL picture no RADL picture
    auto allowed = [&](int kind) {
      if (rasl) return kind != K_RADL;
      if (radl) return kind == K_TRAIL || kind == K_RADL;
      return kind == K_TRAIL;
    };
    // the RPS: the most recent references it may name
    StRps rps;
    std::vector<int> keep;
    if (!is_idr(type)) {
      if (type == CRA) {  // earlier pictures stay as unused references (for RASL pictures)
        for (const PicInfo& pi : pics)
          if (pi.kind == K_GENERATED ? !decoded : !random_mode || rng.chance(0.5))
            keep.push_back(pi.poc);
      } else {
        for (int i = (int)pics.size() - 1; i >= 0 && (int)keep.size() < max_refs; i--)
          if (allowed(pics[i].kind) && !(random_mode && rng.chance(0.1) && keep.size()))
            keep.push_back(pics[i].poc);
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
    // the used references in RefPicList0's order (StCurrBefore, StCurrAfter)
    // and in RefPicList1's (StCurrAfter, StCurrBefore)
    std::vector<int> curr[2];
    for (int i = 0; i < rps.num(); i++)
      if (rps.used[i]) curr[0].push_back(poc + rps.delta[i]);
    for (int pass = 0; pass < 2; pass++)
      for (int q : curr[0])
        if ((q > poc) == (pass == 0)) curr[1].push_back(q);
    // the collocated picture, the same in every slice of the picture: in
    // frames mode list 0's first in P pictures and list 1's in B pictures
    int col_poc = 0;
    if (base.tmvp)
      col_poc = random_mode ? curr[0][rng.range(0, (int)curr[0].size() - 1)]
                            : curr[j.slice == SLICE_B ? 1 : 0][0];

    std::vector<Segment> segs = draw_segments(pp);

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
    // the alternative transfer characteristics SEI (payload 147): in the
    // first access unit, every one (atc_aus=all), each IRAP's (irap), or
    // only the access unit of that number
    if (o.kv.count("atc_sei")) {
      std::string at = o.gets("atc_aus", "first");
      if (at == "all" || (at == "first" && !decoded) || (at == "irap" && irap) ||
          (at != "all" && at != "first" && at != "irap" && decoded == o.get("atc_aus", 0)))
        append(nal_unit(PREFIX_SEI_NUT, 0, sei_rbsp(147, {(uint8_t)o.get("atc_sei", 2)})));
    }
    // HDR10's static metadata SEIs in the first access unit: a mastering
    // display colour volume (137; BT.2020 primaries, D65, 1000 and 0.005
    // cd/m2) and a content light level (144; 1000 and 400 cd/m2)
    if (o.get("luminance_sei", 0) && !decoded) {
      std::vector<uint8_t> mdcv;
      for (int v : {8500, 39850, 6550, 2300, 35400, 14600, 15635, 16450}) put_be(mdcv, v, 2);
      put_be(mdcv, 10000000, 4);
      put_be(mdcv, 50, 4);
      append(nal_unit(PREFIX_SEI_NUT, 0, sei_rbsp(137, mdcv)));
      append(nal_unit(PREFIX_SEI_NUT, 0, sei_rbsp(144, {0x03, 0xE8, 0x01, 0x90})));
    }
    bool refused_type = (refuse == "bla" || refuse == "tsa_stsa") && decoded == 2;
    if (refused_type) base.nal_type = type = refuse == "bla" ? BLA_W_LP : TSA_N;
    std::unique_ptr<Chooser> chooser;
    RandomChooser* rc = nullptr;
    if (random_mode) {
      rc = new RandomChooser(codec, rng, rng_bd);
      chooser.reset(rc);
      rc->p_skip = o.getf("skip", 0.25);
      rc->p_pcm = o.getf("pcm_share", 0.08);
    } else {
      chooser.reset(new FramesChooser(codec, src));
    }
    for (size_t i = 1; i < segs.size(); i++) chooser->segment_ends.push_back(segs[i].ts - 1);
    codec.ch = chooser.get();
    double bshare = o.getf("bslices", 0);
    SliceHeader slice_h;  // the header of the slice's independent segment
    for (size_t si = 0; si < segs.size(); si++) {
      SliceHeader h = base;
      if (segs[si].dependent) {
        h = slice_h;
        h.dependent = 1;
      } else {
        if (!inter_pic) h.type = SLICE_I;
        else if (!random_mode) h.type = j.slice;
        else if (!rng.chance(0.85)) h.type = SLICE_I;
        else h.type = bshare > 0 && rng.chance(bshare) ? SLICE_B : SLICE_P;
        h.sao_luma = s.sao && (!random_mode || rng.chance(0.8));
        h.sao_chroma = s.sao && (!random_mode || rng.chance(0.7));
        if (h.type != SLICE_I) inter_slice(h, pp, curr, col_poc);
        h.qp_delta = random_mode ? rng.range(-6, 6) : qp - pp.init_qp;
        if (pp.init_qp + h.qp_delta < -s.qp_bd_offset() || pp.init_qp + h.qp_delta > 51) h.qp_delta = 0;
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
        slice_h = h;
      }
      h.first = si == 0;
      h.address = pp.ts_to_rs[segs[si].ts];
      h.entry.clear();
      Bits& b = codec.bits;
      const SPS* sp;
      const PPS* ppp;
      const SliceHeader prev = codec.sh;
      b.start_write();
      slice_header_syntax(b, h, codec.sps, codec.pps, sp, ppp, prev);
      bool stop = refused_type;
      stop |= refuse == "missing_ref" && decoded == 1;
      stop |= refuse == "wpp_tiles";  // the decoder refuses the PPS
      stop |= refuse == "bit_depth_mixed" || refuse == "bit_depth12";  // and these the SPS
      if (!stop) {
        // the data first, in an RBSP of its own: the header before it holds
        // the entry points of its substreams
        codec.set_slice(h, sp, ppp);
        if (h.first) {
          codec.start_picture();
          if (codec.poc != poc) fail("writer: POC " + std::to_string(poc) + " decodes as " +
                                     std::to_string(codec.poc));
        }
        codec.start_slice();
        b.start_write();
        codec.slice_data();
        std::vector<uint8_t> data = std::move(b.out);
        h.entry = entry_offsets(data, codec.subset_at);
        if (o.get("bad_entry", 0) && !h.entry.empty()) h.entry[0]++;  // a wrong one, for the tests
        b.start_write();
        slice_header_syntax(b, h, codec.sps, codec.pps, sp, ppp, prev);
        b.out.insert(b.out.end(), data.begin(), data.end());
      } else {
        b.trailing();
        ended = true;
      }
      append(nal_unit(type, 0, b.out));
      if (stop) break;
    }
    if (o.get("dv_rpu", 0)) append(dolby_rpu());
    codec.finish_picture();
    codec.ch = nullptr;
    codec.ready.clear();
    // the sample, and what the GOP keeps
    written += sample.size();
    if (fwrite(sample.data(), 1, sample.size(), f) != sample.size()) fail("write failed");
    sizes.push_back((uint32_t)sample.size());
    if (irap) sync.push_back((uint32_t)sizes.size());
    if (random_mode) {
      if (is_idr(type)) {  // an IDR's RADL pictures come before it
        display_base = (decoded ? display_base + last_poc_max + 1 : 0) + j.lead;
        last_poc_max = 0;
      }
      last_poc_max = std::max(last_poc_max, poc);
      sample_display.push_back(display_base + poc);
    } else {
      sample_display.push_back(j.display);
    }
    // the references that later pictures may keep: those in this RPS, and
    // this picture unless it is a sub-layer non-reference picture or a RASL
    // picture FFmpeg skips; what an IRAP picture keeps is before it
    bool skipped = ffmpeg_rasl.skip(type);
    std::vector<PicInfo> next;
    for (const PicInfo& pi : pics)
      if (std::find(keep.begin(), keep.end(), pi.poc) != keep.end())
        next.push_back({pi.poc, irap && pi.kind != K_GENERATED ? K_BEFORE_IRAP : pi.kind});
    pics = next;
    // FFmpeg applies no RPS of a RASL picture it skips: what it holds stays
    if (!skipped)
      held_generated = std::any_of(next.begin(), next.end(),
                                   [](const PicInfo& pi) { return pi.kind == K_GENERATED; });
    if ((irap || (type & 1)) && !skipped)
      pics.push_back({poc, rasl ? K_RASL : radl ? K_RADL : K_TRAIL});
    if (poc > last_poc) last_poc = poc;
    if (is_idr(type)) last_poc = 0;
    decoded++;
    since_irap++;
  }

  // the reference lists, TMVP and weights of a P or B slice, the collocated
  // picture col_poc placed in the list the slice takes it from
  void inter_slice(SliceHeader& h, const PPS& pp, const std::vector<int>* curr, int col_poc) {
    int total = (int)curr[0].size(), lists = h.type == SLICE_B ? 2 : 1;
    h.num_ref_override = random_mode ? rng.chance(0.6) : 1;
    for (int l = 0; l < lists; l++) {
      h.num_ref[l] = h.num_ref_override ? (random_mode ? rng.range(1, std::min(15, total + 1)) : 1)
                                        : pp.num_ref_default[l];
      h.mod_flag[l] = pp.lists_modification && total > 1 && rng.chance(o.getf("mod_share", 0.6));
      if (h.mod_flag[l])
        for (int i = 0; i < h.num_ref[l]; i++) h.list_entry[l][i] = rng.range(0, total - 1);
    }
    h.mvd_l1_zero = h.type == SLICE_B && random_mode && rng.chance(o.getf("mvd_l1_zero", 0.3));
    if (h.tmvp) {
      h.col_from_l0 = h.type != SLICE_B || (random_mode && !rng.chance(o.getf("col_l1", 0.5)));
      int X = h.col_from_l0 ? 0 : 1;
      // the list as the decoder builds it, so the collocated picture is in it
      auto entry_poc = [&](int i) {
        int k = h.mod_flag[X] ? h.list_entry[X][i] : i;
        return curr[X][k % total];
      };
      int at = -1;
      for (int i = 0; i < h.num_ref[X] && at < 0; i++)
        if (entry_poc(i) == col_poc) at = i;
      if (at < 0) {
        int k = (int)(std::find(curr[X].begin(), curr[X].end(), col_poc) - curr[X].begin());
        if (pp.lists_modification && total > 1) {
          if (!h.mod_flag[X]) {
            h.mod_flag[X] = 1;
            for (int i = 0; i < h.num_ref[X]; i++) h.list_entry[X][i] = i % total;
          }
          at = rng.range(0, h.num_ref[X] - 1);
          h.list_entry[X][at] = k;
        } else {
          h.num_ref_override = 1;
          h.num_ref[X] = std::max(h.num_ref[X], k + 1);
          at = k;
        }
      }
      h.col_ref_idx = at;
    }
    h.cabac_init = pp.cabac_init_present && rng.chance(0.5);
    h.max_merge = random_mode ? rng.range(1, 5) : 5;
    if ((h.type == SLICE_P && pp.weighted_pred) || (h.type == SLICE_B && pp.weighted_bipred))
      random_weights(h);
  }

  // the weights and offsets; at more than 8 bits the offsets over their
  // whole range (the decoder scales them by 1 << (bitDepth - 8))
  void random_weights(SliceHeader& h) {
    bool deep = bit_depth > 8;
    h.luma_denom = rng.range(0, 7);
    h.chroma_denom = rng.range(0, 7);
    for (int l = 0; l < (h.type == SLICE_B ? 2 : 1); l++)
      for (int i = 0; i < h.num_ref[l]; i++) {
        h.lw_flag[l][i] = rng.chance(0.6);
        h.cw_flag[l][i] = rng.chance(0.6);
        h.dlw[l][i] = rng.range(-30, 30);
        h.lo[l][i] = deep ? rng.range(-128, 127) : rng.range(-40, 40);
        for (int k = 0; k < 2; k++) {
          h.dcw[l][i][k] = rng.range(-30, 30);
          h.dco[l][i][k] = deep ? rng.range(-512, 511) : rng.range(-200, 200);
        }
      }
  }

  // ------------------------------------------------ frames mode source --
  // BT.601 limited range, as FFmpeg's swscale converts BGR24 for an encoder;
  // at more than 8 bits scaled up from the exact values, with a pattern of
  // +-1 in the lowest bit on luma, so that a decoder that drops it shows
  void load_source(const uint8_t* bgr) {
    src.alloc(cw, ch, bit_depth);
    const int up = bit_depth - 8, maxv = (1 << bit_depth) - 1;
    auto level = [&](double v, int detail) {
      return clip_pel((int)std::lround(v * (1 << up)) + (up ? detail : 0), maxv);
    };
    for (int y = 0; y < ch; y++) {
      const uint8_t* row = bgr + (size_t)std::min(y, height - 1) * width * 3;
      for (int x = 0; x < cw; x++) {
        const uint8_t* px = row + 3 * std::min(x, width - 1);
        src.y[(size_t)y * cw + x] =
            level(16 + (65.481 * px[2] + 128.553 * px[1] + 24.966 * px[0]) / 255.0, (x + 2 * y) % 3 - 1);
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
        src.cb[(size_t)y * cw / 2 + x] = level(128 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255.0, 0);
        src.cr[(size_t)y * cw / 2 + x] = level(128 + (112.0 * r - 93.786 * g - 18.214 * b) / 255.0, 0);
      }
  }

  // An RPU-shaped NAL unit of type 62 as Dolby Vision streams end each
  // access unit with: the prefix 0x19, rpu_type 2, rpu_format 18, random
  // bytes, a CRC-32 (MPEG-2) of what follows the prefix and the final
  // 0x80. The decoders skip it; it is not meant to parse as metadata.
  std::vector<uint8_t> dolby_rpu() {
    std::vector<uint8_t> body = {0x08, 0x09};  // rpu_type 2, rpu_format 0x12, ...
    int n = rng_dv.range(8, 40);
    for (int i = 0; i < n; i++) body.push_back((uint8_t)rng_dv.range(0, 255));
    uint32_t crc = 0xFFFFFFFFu;
    for (uint8_t v : body)
      for (int k = 7; k >= 0; k--) {
        bool bit = ((crc >> 31) ^ (v >> k)) & 1;
        crc = (crc << 1) ^ (bit ? 0x04C11DB7u : 0);
      }
    std::vector<uint8_t> rbsp = {0x19};
    rbsp.insert(rbsp.end(), body.begin(), body.end());
    put_be(rbsp, crc, 4);
    rbsp.push_back(0x80);
    return nal_unit(DOLBY_RPU_NUT, 0, rbsp);
  }

  void release() {
    if (!f) return;
    if (!random_mode) schedule(true);
    std::vector<uint8_t> hvcc;
    bool hev1 = o.get("hev1", 0);
    // the bit depths as given (hvcc_bd: a wrong one, for the decoder's check)
    int hvcc_bd = o.get("hvcc_bd", sps.bit_depth);
    hvcc.push_back(1);                                   // configurationVersion
    hvcc.push_back((uint8_t)(sps.profile_idc & 31));     // profile space, tier, profile
    put_be(hvcc, sps.profile_idc == 2 ? 0x20000000u : 0x60000000u, 4);  // compatibility: 1 and 2, or 2
    put_be(hvcc, 0x900000000000ull, 6);                  // progressive, frame-only
    hvcc.push_back(93);                                  // level
    put_be(hvcc, 0xF000, 2);                             // min_spatial_segmentation_idc
    hvcc.push_back(0xFC);                                // parallelismType
    hvcc.push_back(0xFC | 1);                            // chromaFormat
    hvcc.push_back((uint8_t)(0xF8 | ((hvcc_bd - 8) & 7)));             // bitDepthLumaMinus8
    hvcc.push_back((uint8_t)(0xF8 | ((sps.bit_depth_c - 8) & 7)));     // bitDepthChromaMinus8
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
    std::string dv_entry = o.gets("dv_entry", "");
    if (!dv_entry.empty() && dv_entry != "dvh1" && dv_entry != "dvhe") fail("dv_entry must be dvh1 or dvhe");
    spec.entry_type = !dv_entry.empty() ? (dv_entry == "dvh1" ? "dvh1" : "dvhe") : hev1 ? "hev1" : "hvc1";
    spec.entry = visual_entry(width, height);
    box(spec.entry, "hvcC", hvcc);
    if (o.kv.count("dvcc")) {  // DOVIDecoderConfigurationRecord: dvcC up to profile 7, dvvC above
      int profile = o.get("dvcc", 8);
      int compat = profile == 8 ? 4 : profile == 7 ? 6 : 0;  // HLG; HDR10; none
      std::vector<uint8_t> dv = {1, 0};  // version 1.0
      put_be(dv, ((uint32_t)profile << 9) | (6u << 3) | (1u << 2) | ((profile == 7) << 1) | 1u, 2);  // level 6, rpu, el, bl
      dv.push_back((uint8_t)(compat << 4));
      put_be(dv, 0, 19);
      box(spec.entry, profile <= 7 ? "dvcC" : "dvvC", dv);
    }
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

// a random prediction unit: a merge candidate whose vectors stay near the
// picture, or list 0, list 1 or both (not in 8x4 and 4x8 blocks) with vectors
// drawn near the picture, each coded against a predictor (list 1's is the
// predictor itself in a bi-predicted unit under mvd_l1_zero_flag)
void RandomChooser::pu(int x, int y, int pw, int ph, int, const Motion* cands, PuChoice& ch) {
  const SPS& s = *c.s;
  auto near = [&](int mvx, int mvy) {
    int rx = x + (mvx >> 2), ry = y + (mvy >> 2);
    return rx > -48 - pw && ry > -48 - ph && rx < s.width + 48 && ry < s.height + 48;
  };
  int n = c.sh.max_merge;
  if (rng.chance(p_merge)) {
    int idx = rng.range(0, n - 1);
    const Motion& m = cands[idx];
    bool ok = true;
    for (int l = 0; l < 2; l++) ok &= !((m.pred >> l) & 1) || near(m.mv[l][0], m.mv[l][1]);
    if (ok) {
      ch.merge = 1;
      ch.merge_idx = idx;
      return;
    }
  }
  ch.merge = 0;
  ch.idc = c.sh.type != SLICE_B ? PRED_L0 : rng.range(0, pw + ph == 12 ? 1 : 2);
  for (int l = 0; l < 2; l++) {
    if (ch.idc == (l ? PRED_L0 : PRED_L1)) continue;
    ch.ref_idx[l] = rng.range(0, c.sh.num_ref[l] - 1);
    ch.mvp[l] = rng.range(0, 1);
    int mvp[2];
    c.amvp_query(l, ch.ref_idx[l], ch.mvp[l], mvp);
    if (l == 1 && ch.idc == PRED_BI && c.sh.mvd_l1_zero) {
      if (!near(mvp[0], mvp[1])) ch.idc = PRED_L0;
      continue;
    }
    int tx, ty;
    if (rng.chance(0.3)) { tx = mvp[0] + rng.range(-3, 3); ty = mvp[1] + rng.range(-3, 3); }
    else {
      tx = rng.range((-40 - x) * 4, (s.width + 40 - x - pw) * 4);
      ty = rng.range((-40 - y) * 4, (s.height + 40 - y - ph) * 4);
    }
    if (!near(tx, ty)) { tx = 0; ty = 0; }
    ch.mvd[l][0] = tx - mvp[0];
    ch.mvd[l][1] = ty - mvp[1];
    if (std::abs(ch.mvd[l][0]) > 32767 || std::abs(ch.mvd[l][1]) > 32767) ch.mvd[l][0] = ch.mvd[l][1] = 0;
  }
}

// ------------------------------------------------------------ frames --
int FramesChooser::search(int x0, int y0, int n, int l, const int* start, int* mv) const {
  // luma SAD straight from the reference where the block lies inside it
  const Picture& ref = *c.list[l][0];
  auto sad_at = [&](int vx, int vy) {
    int rx = x0 + (vx >> 2), ry = y0 + (vy >> 2);
    if (rx < 0 || ry < 0 || rx + n > ref.w || ry + n > ref.h) return 1 << 30;
    int t = 16;  // a little against coding a vector
    for (int y = 0; y < n; y++) {
      const Pel* a = &src.y[(size_t)(y0 + y) * src.w + x0];
      const Pel* b = &ref.y[(size_t)(ry + y) * ref.w + rx];
      for (int x = 0; x < n; x++) t += std::abs(a[x] - b[x]);
    }
    return t;
  };
  int best = 1 << 30;
  int starts[2][2] = {{0, 0}, {start[0] & ~3, start[1] & ~3}};
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
    if (bs < best) { best = bs; mv[0] = bx; mv[1] = by; }
  }
  return best;
}

bool FramesChooser::quantise(int comp, int x0, int y0, int log2, const Pel* pred, int pstride,
                             bool intra, int16_t* out) {
  const Tables& T = tables();
  int n = 1 << log2, step = 32 >> log2, bd = c.s->bit_depth;
  const Pel* s8 = src.plane(comp);
  int stride = src.stride(comp);
  int res[32 * 32], tmp[32 * 32];
  for (int y = 0; y < n; y++)
    for (int x = 0; x < n; x++) res[y * n + x] = s8[(y0 + y) * stride + x0 + x] - pred[y * pstride + x];
  // forward transform: columns then rows, shifts log2 + bitDepth - 9 and log2 + 6
  int s1 = log2 + bd - 9, s2 = log2 + 6;
  for (int k = 0; k < n; k++)
    for (int x = 0; x < n; x++) {
      int64_t v = 0;
      for (int y = 0; y < n; y++) v += T.dct[k * step][y] * res[y * n + x];
      tmp[k * n + x] = (int)((v + (1 << (s1 - 1))) >> s1);
    }
  // Qp' (with QpBdOffset); the quantiser's shift 14 + Qp' / 6 + 15 - bitDepth - log2
  int q = (comp ? (comp == 1 ? c.qp_cb : c.qp_cr) : c.qp_y) + c.s->qp_bd_offset();
  static const int kQuant[6] = {26214, 23302, 20560, 18396, 16384, 14564};
  int qbits = 29 - bd + q / 6 - log2;
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
  static thread_local std::vector<Pel> buf[3], best[3];
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
  // inter: the best merge candidate, or the best of an integer diamond
  // search in each list's first picture (from zero and from the best
  // candidate's vector) and, in B slices, of the average of the two
  bool inter = c.sh.type != SLICE_I, bslice = c.sh.type == SLICE_B;
  int inter_sad = 1 << 30, merge_idx = -1;
  Motion cands[5], found;
  if (inter) {
    c.cu_part = P2Nx2N;
    c.merge_list(x0, y0, n, n, 0, cands);
    Pel* pr[3] = {buf[0].data(), buf[1].data(), buf[2].data()};
    for (int i = 0; i < c.sh.max_merge; i++) {
      predict_motion(x0, y0, n, cands[i], pr);
      int sd = sad(0, x0, y0, n, buf[0].data(), n);
      if (sd < inter_sad) { inter_sad = sd; merge_idx = i; }
    }
    Motion one[2];
    for (int l = 0; l < (bslice ? 2 : 1); l++) {
      int start[2] = {0, 0};
      if (merge_idx >= 0 && ((cands[merge_idx].pred >> l) & 1)) {
        start[0] = cands[merge_idx].mv[l][0];
        start[1] = cands[merge_idx].mv[l][1];
      }
      int mv[2] = {0, 0}, sd = search(x0, y0, n, l, start, mv);
      one[l].pred = (uint8_t)(1 << l);
      one[l].ref[l] = 0;
      one[l].mv[l][0] = (int16_t)mv[0];
      one[l].mv[l][1] = (int16_t)mv[1];
      if (sd < inter_sad) { inter_sad = sd; merge_idx = -1; found = one[l]; }
    }
    if (bslice) {
      Motion bi = one[0];
      bi.pred = 3;
      bi.ref[1] = 0;
      bi.mv[1][0] = one[1].mv[1][0];
      bi.mv[1][1] = one[1].mv[1][1];
      predict_motion(x0, y0, n, bi, pr);
      int sd = sad(0, x0, y0, n, buf[0].data(), n) + 32;
      if (sd < inter_sad) { inter_sad = sd; merge_idx = -1; found = bi; }
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
  Pel* pr[3] = {best[0].data(), best[1].data(), best[2].data()};
  pu_plan = PuChoice{};
  if (merge_idx >= 0) {
    pu_plan.merge = 1;
    pu_plan.merge_idx = merge_idx;
    predict_motion(x0, y0, n, cands[merge_idx], pr);
  } else {
    pu_plan.merge = 0;
    pu_plan.idc = found.pred == 3 ? PRED_BI : found.pred == 2 ? PRED_L1 : PRED_L0;
    for (int l = 0; l < 2; l++) {
      if (!((found.pred >> l) & 1)) continue;
      int p[2][2], mvx = found.mv[l][0], mvy = found.mv[l][1];
      c.amvp(x0, y0, n, n, 0, l, 0, p);
      int f = std::abs(mvx - p[1][0]) + std::abs(mvy - p[1][1]) < std::abs(mvx - p[0][0]) + std::abs(mvy - p[0][1]);
      pu_plan.mvp[l] = f;
      pu_plan.mvd[l][0] = mvx - p[f][0];
      pu_plan.mvd[l][1] = mvy - p[f][1];
    }
    predict_motion(x0, y0, n, found, pr);
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
