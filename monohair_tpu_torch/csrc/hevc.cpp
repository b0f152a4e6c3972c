// H.265 / HEVC video in MP4/QuickTime on the host: the port's counterpart of
// the FFmpeg decoder that cv2.VideoCapture reads a phone's HEVC video with in
// the JAX package. Built by monohair_tpu_torch/ops/_build.py (g++), called
// through ctypes by monohair_tpu_torch/io/video.py.
//
// Demuxer: mp4.h's; the first video track's sample entry is hvc1 or hev1,
// whose hvcC carries the NAL length size (1, 2 or 4 bytes) and the VPS, SPS
// and PPS (hvc1 carries them there only, hev1 may also send them in band).
// Each sample is one access unit.
//
// Decoder: hevc.h. H.265 defines every output sample in integers, so the
// YUV planes are FFmpeg's; the frame is cropped to the conformance window and
// converted to BGR24 as swscale converts yuv420p for cv2 (mp4.h), with the
// VUI's matrix_coefficients and video_full_range_flag as cv2 hands them to
// swscale, then rotated by the display matrix. What cv2 converts otherwise is
// refused by name, as for H.264: a left crop, BT.2020 or other primaries,
// PQ/HLG transfers, the GBR, YCgCo and BT.2020 matrices. Frames leave in the
// order FFmpeg hands them to cv2 (hevc.h: Hevc::output_frames), the rest
// flushed at the end of the stream. NAL units of layers above 0 are skipped,
// as FFmpeg skips them unless asked for another view.
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
  int coded_w = 0, coded_h = 0;
  bool eos = false;
  std::vector<uint8_t> bgr;

  void open(const char* path) {
    movie.open(path);
    const Track& t = movie.track;
    if (t.entry != "hvc1" && t.entry != "hev1")
      unsupported("sample entry '" + t.entry +
                  "' (the port reads mp4v, MPEG-4 Part 2; avc1/avc3, H.264; hvc1/hev1, HEVC)");
    const std::vector<uint8_t>& c = t.hvcc;
    if (c.empty())
      unsupported("sample entry '" + t.entry + "' without an hvcC box (no HEVC configuration)");
    if (c.size() < 23) fail("short hvcC box");
    if (c[0] != 1) fail("hvcC configurationVersion " + std::to_string(c[0]));
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
    if (type == EOS_NUT) { eos = true; return; }
    bool vcl = type < 32;
    if (vcl && (type > CRA || (type > RASL_R && type < BLA_W_LP))) return;  // reserved
    if (type >= RADL_N && type <= RASL_R)
      unsupported("RASL/RADL leading pictures (NAL unit type " + std::to_string(type) + ")");
    if (type >= BLA_W_LP && type <= BLA_N_LP) unsupported("BLA pictures");
    if (type >= TSA_N && type <= STSA_R)
      unsupported("TSA/STSA pictures (temporal sub-layer switching)");
    if (type > PPS_NUT) return;  // AUD, SEI, filler
    std::vector<uint8_t> rbsp = unescape(d + 2, n - 2);
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
      int cw = s.width - 2 * (s.conf[0] + s.conf[1]), ch = s.height - 2 * (s.conf[2] + s.conf[3]);
      if (!coded_w) {
        coded_w = s.width;
        coded_h = s.height;
        width = cw;
        height = ch;
      } else if (s.width != coded_w || s.height != coded_h || cw != width || ch != height) {
        unsupported("a change of picture size within the stream");
      }
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
    slice_header_syntax(b, h, codec.sps, codec.pps, s, p);
    if (h.first) {
      if (codec.cur) codec.finish_picture();
      if (eos && type == CRA) unsupported("a CRA picture after an end of sequence NAL unit");
      if (is_irap(type)) eos = false;
    } else if (!codec.cur) {
      fail("slice segment of a picture whose first slice is missing");
    }
    codec.set_slice(h, s, p);
    if (s->width != coded_w || s->height != coded_h)
      unsupported("a change of picture size within the stream");
    if (h.first) codec.start_picture();
    codec.start_slice();
    codec.slice_data();
  }

  // what cv2 shows of a picture depends on more than its samples here:
  // refused by name where the conversion was not held against cv2
  static void check_output(const SPS& s) {
    if (s.conf[0])
      unsupported("conf_win_left_offset " + std::to_string(s.conf[0]) +
                  " (FFmpeg keeps the planes aligned and cv2 then rescales the frame)");
    if (!(s.vui && s.signal_type && s.colour_desc)) return;
    auto in = [](int v, std::initializer_list<int> ok) {
      for (int k : ok)
        if (v == k) return true;
      return false;
    };
    if (!in(s.matrix, {1, 2, 3, 4, 5, 6, 7}))
      unsupported("matrix_coefficients " + std::to_string(s.matrix));
    if (!in(s.primaries, {1, 2, 4, 5, 6, 7}))
      unsupported("colour_primaries " + std::to_string(s.primaries) + " (cv2 maps the gamut)");
    if (!in(s.transfer, {1, 2, 4, 5, 6, 7, 8, 13, 14}))
      unsupported("transfer_characteristics " + std::to_string(s.transfer) + " (cv2 tone-maps)");
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
    bool colour = s.vui && s.signal_type && s.colour_desc;
    yuv420_to_bgr(pic->y.data() + (size_t)y0 * pic->w + x0, pic->w,
                  pic->cb.data() + (size_t)(y0 / 2) * (pic->w / 2) + x0 / 2,
                  pic->cr.data() + (size_t)(y0 / 2) * (pic->w / 2) + x0 / 2, pic->w / 2, width,
                  height, dst,
                  yuv2rgb_coefficients(colour ? s.matrix : 2, s.vui && s.signal_type && s.full_range));
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

// what the frames decoded so far used (Stat order); returns the count
int hevc_stats(void* h, int64_t* out) {
  const Hevc& c = static_cast<Reader*>(h)->codec;
  for (int i = 0; i < kStatCount; i++) out[i] = c.stats[i];
  return kStatCount;
}

}  // extern "C"
