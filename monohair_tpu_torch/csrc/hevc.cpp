// H.265 / HEVC video in MP4/QuickTime on the host: the port's counterpart of
// the FFmpeg decoder that cv2.VideoCapture reads a phone's HEVC video with in
// the JAX package. Built by monohair_tpu_torch/ops/_build.py (g++), called
// through ctypes by monohair_tpu_torch/io/video.py.
//
// Demuxer: mp4.h's; the first video track's sample entry is hvc1 or hev1,
// or Dolby Vision's dvh1 or dvhe (read as FFmpeg reads them: HEVC, the
// base layer), whose hvcC carries the NAL length size (1, 2 or 4 bytes) and
// the VPS, SPS and PPS (hvc1 and dvh1 carry them there only, hev1 and dvhe
// may also send them in band). A Dolby Vision configuration box (dvcC or
// dvvC) is read for its profile: 8, whose base layer any HEVC decoder
// shows, is taken; the others (5: IPT-PQ-c2 with no compatible base layer,
// 7: two layers) are refused by name. The RPU NAL units (type 62) are
// counted and skipped, as FFmpeg's output takes nothing from them. Each
// sample is one access unit.
//
// Decoder: hevc.h. H.265 defines every output sample in integers, so the
// YUV planes are FFmpeg's, at 8, 9 or 10 bits; the frame is cropped to the
// conformance window and converted to BGR24 as swscale converts yuv420p, or
// yuv420p9/yuv420p10, for cv2 (mp4.h), with the VUI's matrix_coefficients
// and video_full_range_flag as cv2 hands them to swscale, then rotated by the
// display matrix. Where cv2's swscale manages the colours (BT.2020
// primaries, the HLG transfer) the frame goes through mp4.h's three passes
// and 3D LUT instead (yuv420_managed_to_bgr), at 8, 9 and 10 bits. The
// transfer is the VUI's, or the last alternative transfer characteristics
// SEI's (payload 147) from the picture of its access unit on, as FFmpeg
// hands it to cv2 (it persists, and an SEI naming no transfer or
// "unspecified" changes nothing); a frame left unspecified takes the last
// SEI's read when it is output. hvcC's bit depths are read and each SPS
// that disagrees with them is counted (FFmpeg decodes by the SPS). What cv2
// converts otherwise is refused by name, as for H.264: a left crop, other
// primaries, PQ and the transfers not held with BT.2020 primaries, the GBR,
// YCgCo and BT.2020 constant-luminance matrices, mastering display and
// content light level SEIs beside a managed conversion. Frames leave in the
// order FFmpeg hands them to cv2 (hevc.h: Hevc::output_frames), the rest
// flushed at the end of the stream; the RASL pictures FFmpeg skips (hevc.h:
// RaslRule) are neither decoded nor output. NAL units of layers above 0 are
// skipped, as FFmpeg skips them unless asked for another view.
//
// Bit parsing is serial, so this stays on the host, as FFmpeg does in the
// JAX package.

#include "hevc.h"

namespace {

struct Reader {
  Movie movie;
  Hevc codec;
  size_t next = 0;
  int length_size = 4;
  int width = 0, height = 0;  // cropped, before rotation
  int coded_w = 0, coded_h = 0, bit_depth = 0;
  int hvcc_bit_depth[2] = {8, 8};  // hvcC's bitDepthLumaMinus8 + 8 and bitDepthChromaMinus8 + 8
  bool eos = false;
  bool skipping = false;  // the slices of a RASL picture FFmpeg skips
  int sei_transfer = -1;  // the last alternative transfer characteristics SEI's, -1 before one
  bool luminance_sei = false;  // a mastering display or content light level SEI seen
  std::vector<uint8_t> bgr;

  void open(const char* path) {
    movie.open(path);
    const Track& t = movie.track;
    if (t.entry != "hvc1" && t.entry != "hev1" && t.entry != "dvh1" && t.entry != "dvhe")
      unsupported("sample entry '" + t.entry +
                  "' (the port reads mp4v, MPEG-4 Part 2; avc1/avc3, H.264; hvc1/hev1/dvh1/dvhe, HEVC)");
    if (!t.dovi.empty()) {
      if (t.dovi.size() < 5) fail("short Dolby Vision configuration box");
      int profile = t.dovi[2] >> 1;
      if (profile != 8)
        unsupported("Dolby Vision profile " + std::to_string(profile) +
                    " (only profile 8, whose base layer cv2 shows as HEVC, is read)");
    }
    const std::vector<uint8_t>& c = t.hvcc;
    if (c.empty())
      unsupported("sample entry '" + t.entry + "' without an hvcC box (no HEVC configuration)");
    if (c.size() < 23) fail("short hvcC box");
    if (c[0] != 1) fail("hvcC configurationVersion " + std::to_string(c[0]));
    hvcc_bit_depth[0] = (c[17] & 7) + 8;
    hvcc_bit_depth[1] = (c[18] & 7) + 8;
    length_size = (c[21] & 3) + 1;
    if (length_size == 3) fail("hvcC lengthSizeMinusOne 2");
    size_t pos = 23;
    for (int a = 0; a < c[22]; a++) {
      if (pos + 3 > c.size()) fail("truncated hvcC");
      int count = be16(&c[pos + 1]);
      pos += 3;
      for (int i = 0; i < count; i++) {
        if (pos + 2 > c.size()) fail("truncated hvcC");
        size_t len = be16(&c[pos]);
        pos += 2;
        if (pos + len > c.size()) fail("truncated hvcC");
        nal(&c[pos], len);
        pos += len;
      }
    }
    // hev1 without sets in its hvcC: the first in-band SPS gives the size
    for (size_t i = 0; i < movie.samples.size() && !coded_w; i++) {
      std::vector<uint8_t> s = movie.read_sample(i);
      for_each_nal(s, [&](const uint8_t* d, size_t n) {
        if (n > 1 && ((d[0] >> 1) & 63) <= SPS_NUT && ((d[0] >> 1) & 63) >= VPS_NUT) nal(d, n);
      });
    }
    if (!coded_w) fail("no sequence parameter set");
  }

  template <class F>
  void for_each_nal(const std::vector<uint8_t>& s, F f) {
    size_t pos = 0;
    while (pos < s.size()) {
      if (pos + length_size > s.size()) fail("truncated NAL unit length");
      size_t len = 0;
      for (int k = 0; k < length_size; k++) len = (len << 8) | s[pos + k];
      pos += length_size;
      if (pos + len > s.size()) fail("NAL unit runs past its sample");
      f(&s[pos], len);
      pos += len;
    }
  }

  void nal(const uint8_t* d, size_t n) {
    if (n < 2) return;
    if (d[0] & 0x80) fail("forbidden_zero_bit set");
    int type = (d[0] >> 1) & 63, layer = ((d[0] & 1) << 5) | (d[1] >> 3), tid = (d[1] & 7) - 1;
    if (tid < 0) fail("nuh_temporal_id_plus1 0");
    if (layer) return;
    if (type == EOS_NUT) {
      eos = true;
      codec.rasl = RaslRule{};
      return;
    }
    bool vcl = type < 32;
    if (vcl && (type > CRA || (type > RASL_R && type < BLA_W_LP))) return;  // reserved
    if (type >= BLA_W_LP && type <= BLA_N_LP) unsupported("BLA pictures");
    if (type >= TSA_N && type <= STSA_R)
      unsupported("TSA/STSA pictures (temporal sub-layer switching)");
    if (type == PREFIX_SEI_NUT) return sei(d + 2, n - 2);
    if (type == DOLBY_RPU_NUT) {
      codec.stats[S_DOLBY_RPU]++;
      return;
    }
    if (type > PPS_NUT) return;  // AUD, suffix SEI, filler
    std::vector<uint8_t> rbsp = unescape(d + 2, n - 2, &codec.ep);
    Bits& b = codec.bits;
    b.start_read(rbsp.data(), rbsp.size());
    if (type == VPS_NUT) {
      VPS v;
      vps_syntax(b, v);
      codec.vps[v.id] = v;
      return;
    }
    if (type == SPS_NUT) {
      SPS s;
      sps_syntax(b, s, codec.vps);
      check_output(s);
      colour_plan(s, sei_transfer);
      int cw = s.width - 2 * (s.conf[0] + s.conf[1]), ch = s.height - 2 * (s.conf[2] + s.conf[3]);
      if (!coded_w) {
        coded_w = s.width;
        coded_h = s.height;
        width = cw;
        height = ch;
        bit_depth = s.bit_depth;
      } else if (s.width != coded_w || s.height != coded_h || cw != width || ch != height) {
        unsupported("a change of picture size within the stream");
      } else if (s.bit_depth != bit_depth) {
        unsupported("a change of bit depth within the stream");
      }
      // FFmpeg decodes by the SPS and reads nothing of hvcC's bit depths:
      // one that disagrees is counted, not refused
      if (s.bit_depth != hvcc_bit_depth[0] || s.bit_depth_c != hvcc_bit_depth[1])
        codec.stats[S_HVCC_MISMATCH]++;
      if (s.bit_depth > 8 && ch < 10)
        unsupported("a picture of " + std::to_string(ch) + " rows at " + std::to_string(s.bit_depth) +
                    " bits (swscale converts fewer than 10 rows through its bilinear paths)");
      codec.sps[s.id] = s;
      return;
    }
    if (type == PPS_NUT) {
      PPS p;
      pps_syntax(b, p, codec.sps);
      codec.pps[p.id] = p;
      return;
    }
    if (!coded_w) fail("slice before any sequence parameter set");
    SliceHeader h;
    h.nal_type = type;
    h.temporal_id = tid;
    const SPS* s;
    const PPS* p;
    slice_header_syntax(b, h, codec.sps, codec.pps, s, p, codec.sh);
    if (h.first) {
      if (codec.cur) codec.finish_picture();
      if (eos && type == CRA) unsupported("a CRA picture after an end of sequence NAL unit");
      if (is_irap(type)) eos = false;
      skipping = false;
    } else if (skipping) {
      return;
    } else if (!codec.cur) {
      fail("slice segment of a picture whose first slice is missing");
    }
    codec.set_slice(h, s, p);
    if (s->width != coded_w || s->height != coded_h)
      unsupported("a change of picture size within the stream");
    if (h.first) {
      if (codec.skip_rasl()) {
        skipping = true;
        return;
      }
      codec.start_picture();
      colour_plan(*s, sei_transfer);
      codec.cur->transfer = sei_transfer;
    }
    codec.start_slice();
    codec.slice_data();
  }

  // what cv2 shows of a picture depends on more than its samples here:
  // refused by name where the conversion was not held against cv2
  static void check_output(const SPS& s) {
    if (s.conf[0])
      unsupported("conf_win_left_offset " + std::to_string(s.conf[0]) +
                  " (FFmpeg keeps the planes aligned and cv2 then rescales the frame)");
  }

  // How cv2 converts a picture of this SPS whose frame carries transfer
  // (an SEI's, or -1: the VUI's): plainly (swscale's yuv2rgb, or its general
  // scaler at 9 and 10 bits), or through the 3D LUT from BT.2020 primaries
  // and/or HLG; refused by name where not held against cv2.
  struct ColourPlan {
    bool managed = false, bt2020 = false, hlg = false;
    int matrix = 2;
  };
  ColourPlan colour_plan(const SPS& s, int transfer) const {
    auto in = [](int v, std::initializer_list<int> ok) {
      for (int k : ok)
        if (v == k) return true;
      return false;
    };
    const bool colour = s.vui && s.signal_type && s.colour_desc;
    const int prim = colour ? s.primaries : 2, trc = transfer >= 0 ? transfer : colour ? s.transfer : 2;
    const std::string from = transfer >= 0 ? " from the alternative transfer characteristics SEI" : "";
    ColourPlan c;
    c.matrix = colour ? s.matrix : 2;
    if (!in(c.matrix, {1, 2, 3, 4, 5, 6, 7, 9}))
      unsupported("matrix_coefficients " + std::to_string(c.matrix) +
                  (c.matrix == 10 ? " (BT.2020 constant luminance: cv2's swscale does not convert it)" : ""));
    const bool sdr = in(trc, {1, 2, 4, 5, 6, 7, 8, 13, 14});
    if (in(prim, {1, 2, 4, 5, 6, 7}) && sdr) return c;
    c.managed = true;
    c.bt2020 = prim == 9;
    c.hlg = trc == 18;
    if (trc == 16)
      unsupported("transfer_characteristics 16" + from +
                  " (PQ: cv2 tone-maps it by the mastering display and content light level SEIs; not held)");
    if (!in(prim, {1, 2, 4, 5, 6, 7, 9}))
      unsupported("colour_primaries " + std::to_string(prim) + " (cv2 maps the gamut)");
    if (!sdr && trc != 18)
      unsupported("transfer_characteristics " + std::to_string(trc) + from +
                  " (cv2 tone-maps it, or cannot convert it; not held)");
    if (prim == 9 && !c.hlg && !in(trc, {1, 2, 6, 14}))
      unsupported("colour_primaries 9 with transfer_characteristics " + std::to_string(trc) + from +
                  " (cv2 maps the gamut through that transfer's EOTF; held: BT.1886's 1, 6, 14, and HLG)");
    if (c.hlg && !in(prim, {1, 2, 9}))
      unsupported("transfer_characteristics 18" + from + " with colour_primaries " + std::to_string(prim) +
                  " (held with BT.709 and BT.2020 primaries)");
    if (luminance_sei)
      unsupported("a mastering display colour volume or content light level SEI with BT.2020 primaries or "
                  "HLG (cv2 maps the colours by its luminance; not held)");
    const int rows = s.height - 2 * (s.conf[2] + s.conf[3]);
    if (rows < 10)
      unsupported("a picture of " + std::to_string(rows) +
                  " rows with BT.2020 primaries or HLG (swscale converts fewer than 10 rows through its "
                  "bilinear paths)");
    return c;
  }

  // SEI messages of a prefix SEI NAL unit: the alternative transfer
  // characteristics (147), and whether the luminance SEIs (137, 144) came
  void sei(const uint8_t* d, size_t n) {
    std::vector<uint8_t> r = unescape(d, n);
    size_t pos = 0;
    auto byte_sum = [&]() {
      int v = 0;
      while (pos < r.size() && r[pos] == 0xFF) v += r[pos++];
      if (pos >= r.size()) fail("truncated SEI message");
      return v + r[pos++];
    };
    while (pos + 1 < r.size() || (pos < r.size() && r[pos] != 0x80)) {
      const int type = byte_sum(), size = byte_sum();
      if (pos + size > r.size()) fail("SEI payload runs past its NAL unit");
      if (type == 147 && size >= 1) {
        codec.stats[S_ATC_SEI]++;
        // FFmpeg takes a value that names a transfer, unspecified aside
        if (r[pos] <= 18 && r[pos] != 2) sei_transfer = r[pos];
      }
      if (type == 137 || type == 144) luminance_sei = true;
      pos += size;
    }
  }

  void decode_sample(size_t i) {
    std::vector<uint8_t> s = movie.read_sample(i);
    for_each_nal(s, [&](const uint8_t* d, size_t n) { nal(d, n); });
    if (codec.cur) codec.finish_picture();
  }

  // 1 with a BGR frame in out (cropped, rotated as the display matrix says), 0 at the end
  int next_frame(uint8_t* out) {
    while (codec.ready.empty() && next < movie.samples.size()) decode_sample(next++);
    if (codec.ready.empty()) codec.flush_output();
    if (codec.ready.empty()) return 0;
    PicPtr pic = codec.ready.front();
    codec.ready.erase(codec.ready.begin());
    const SPS& s = *codec.s;
    int x0 = 2 * s.conf[0], y0 = 2 * s.conf[2];
    uint8_t* dst = out;
    if (movie.rotation) {
      bgr.resize((size_t)width * height * 3);
      dst = bgr.data();
    }
    // the transfer its frame carries to cv2: the SEI's in effect at its
    // decoding, else the VUI's; one still unspecified takes the decoder's at
    // output, the last SEI's read by then (cv2's frames show both)
    int transfer = pic->transfer;
    const bool colour = s.vui && s.signal_type && s.colour_desc;
    if ((transfer >= 0 ? transfer : colour ? s.transfer : 2) == 2 && sei_transfer >= 0) transfer = sei_transfer;
    const ColourPlan c = colour_plan(s, transfer);
    const int matrix = c.matrix;
    bool full = s.vui && s.signal_type && s.full_range;
    const Pel* Y = pic->y.data() + (size_t)y0 * pic->w + x0;
    const Pel* U = pic->cb.data() + (size_t)(y0 / 2) * (pic->w / 2) + x0 / 2;
    const Pel* V = pic->cr.data() + (size_t)(y0 / 2) * (pic->w / 2) + x0 / 2;
    // FFmpeg reports the left chroma location for 4:2:0 without the VUI's
    const int loc = s.vui && s.chroma_loc ? s.chroma_loc_type : 0;
    if (c.managed) {
      yuv420_managed_to_bgr(Y, pic->w, U, V, pic->w / 2, width, height, s.bit_depth, dst, matrix, full, loc,
                            colour_lut(c.bt2020, c.hlg));
      codec.stats[S_MANAGED]++;
    } else if (s.bit_depth > 8)
      yuv420_high_to_bgr(Y, pic->w, U, V, pic->w / 2, width, height, s.bit_depth, dst, matrix, full, loc);
    else
      yuv420_to_bgr(Y, pic->w, U, V, pic->w / 2, width, height, dst, yuv2rgb_coefficients(matrix, full));
    if (movie.rotation) rotate_bgr(dst, width, height, movie.rotation, out);
    return 1;
  }
};

}  // namespace

extern "C" {

// info = {frames, width, height, fps numerator, fps denominator}; width and
// height as displayed (cropped, then rotated by the display matrix)
void* hevc_open(const char* path, int64_t* info, char* err, int errlen) {
  Reader* r = new Reader();
  try {
    r->open(path);
    const Movie& m = r->movie;
    bool swap = m.rotation == 90 || m.rotation == 270;
    info[0] = (int64_t)m.samples.size();
    info[1] = swap ? r->height : r->width;
    info[2] = swap ? r->width : r->height;
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
int hevc_read(void* h, uint8_t* out, char* err, int errlen) {
  try {
    return static_cast<Reader*>(h)->next_frame(out);
  } catch (const Error& e) {
    return report(e, err, errlen);
  }
}

void hevc_close(void* h) { delete static_cast<Reader*>(h); }

// the 3D LUT of cv2's colour management from BT.2020 primaries (bt2020)
// and/or HLG (hlg) to BT.709 at BT.1886: 65^3 nodes (b, g, r) of 16-bit R,
// G, B into out; built once in the process
void hevc_colour_lut(int bt2020, int hlg, uint16_t* out) {
  const ColourLut& l = colour_lut(bt2020 != 0, hlg != 0);
  memcpy(out, l.node.data(), l.node.size() * sizeof(uint16_t));
}

// what the frames decoded so far used (Stat order); returns the count
int hevc_stats(void* h, int64_t* out) {
  const Hevc& c = static_cast<Reader*>(h)->codec;
  for (int i = 0; i < kStatCount; i++) out[i] = c.stats[i];
  return kStatCount;
}

}  // extern "C"
