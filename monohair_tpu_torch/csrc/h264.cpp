// H.264 video in MP4/QuickTime on the host: the port's counterpart of the
// FFmpeg decoder that cv2.VideoCapture reads a phone's video with in the JAX
// package. Built by monohair_tpu_torch/ops/_build.py (g++), called through
// ctypes by monohair_tpu_torch/io/video.py.
//
// Demuxer: mp4.h's; the first video track's sample entry is avc1 or avc3,
// whose avcC carries the NAL length size (1, 2 or 4 bytes) and, for avc1, the
// parameter sets (avc3 sends them in band; in-band sets that repeat before
// each IDR are taken as they come). Each sample is one access unit.
//
// Decoder: h264.h. H.264 defines every output sample in integers, so the
// YUV planes are FFmpeg's; the frame is cropped as frame_cropping says and
// converted to BGR24 as swscale converts yuv420p for cv2 (mp4.h), with the
// VUI's matrix_coefficients and video_full_range_flag as cv2 hands them to
// swscale (the BT.2020 matrix among them), then rotated by the display
// matrix. What cv2 converts otherwise is refused by name: a left crop
// (FFmpeg aligns the planes and cv2 then rescales), BT.2020 or other
// primaries (gamut mapping), PQ/HLG transfers (tone mapping), from the VUI
// or from an alternative transfer characteristics SEI (which replaces the
// VUI's in FFmpeg's frames), the GBR, YCgCo and BT.2020 constant-luminance
// matrices. Frames leave in the
// order FFmpeg hands them to cv2: held back by the reorder delay that the
// container's composition offsets (ctts) and the VUI's
// max_num_reorder_frames give, and without the VUI by the delay FFmpeg
// learns from the POCs it sees, dropping the pictures that come too late as
// it does; the last ones are flushed at the end of the stream.
//
// Bit parsing is serial, so this stays on the host, as FFmpeg does in the
// JAX package.

#include "h264.h"

namespace {

struct Reader {
  Movie movie;
  Codec codec;
  size_t next = 0;
  int length_size = 4;
  int width = 0, height = 0;  // cropped, before rotation
  int coded_w = 0, coded_h = 0;
  std::vector<uint8_t> bgr;

  void open(const char* path) {
    movie.open(path);
    const Track& t = movie.track;
    if (t.entry != "avc1" && t.entry != "avc3")
      unsupported("sample entry '" + t.entry +
                  "' (the port reads mp4v, MPEG-4 Part 2; avc1/avc3, H.264; hvc1/hev1, HEVC)");
    const std::vector<uint8_t>& c = t.avcc;
    if (c.size() < 7) fail("missing or short avcC box");
    if (c[0] != 1) fail("avcC configurationVersion " + std::to_string(c[0]));
    length_size = (c[4] & 3) + 1;
    if (length_size == 3) fail("avcC lengthSizeMinusOne 2");
    size_t pos = 5;
    for (int set = 0; set < 2; set++) {
      if (pos >= c.size()) fail("truncated avcC");
      int count = set == 0 ? c[pos] & 31 : c[pos];
      pos++;
      for (int i = 0; i < count; i++) {
        if (pos + 2 > c.size()) fail("truncated avcC");
        size_t len = be16(&c[pos]);
        pos += 2;
        if (pos + len > c.size()) fail("truncated avcC");
        nal(&c[pos], len);
        pos += len;
      }
    }
    // avc3 without sets in its avcC: the first in-band SPS gives the size
    for (size_t i = 0; i < movie.samples.size() && !coded_w; i++) {
      std::vector<uint8_t> s = movie.read_sample(i);
      for_each_nal(s, [&](const uint8_t* d, size_t n) {
        if (n && (d[0] & 31) == 7) nal(d, n);
      });
    }
    if (!coded_w) fail("no sequence parameter set");
    codec.has_b_frames = movie.video_delay;
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
    if (n < 1) return;
    if (d[0] & 0x80) fail("forbidden_zero_bit set");
    int ref_idc = (d[0] >> 5) & 3, type = d[0] & 31;
    if (type >= 2 && type <= 4)
      unsupported("data partitioning (NAL unit type " + std::to_string(type) + ")");
    if (type == 6) return sei(d + 1, n - 1);
    if (type != 1 && type != 5 && type != 7 && type != 8) return;  // AUD, ...
    std::vector<uint8_t> rbsp = unescape(d + 1, n - 1);
    Bits& b = codec.bits;
    b.start_read(rbsp.data(), rbsp.size());
    if (type == 7) {
      SPS s;
      sps_syntax(b, s);
      check_output(s);
      int w = 16 * s.mbw, h = 16 * s.mbh;
      int cw = w - 2 * (s.crop[0] + s.crop[1]), ch = h - 2 * (s.crop[2] + s.crop[3]);
      if (!coded_w) {
        coded_w = w;
        coded_h = h;
        width = cw;
        height = ch;
      } else if (w != coded_w || h != coded_h || cw != width || ch != height) {
        unsupported("a change of picture size within the stream");
      }
      codec.sps[s.id] = s;
      return;
    }
    if (type == 8) {
      PPS p;
      pps_syntax(b, p, codec.sps);
      codec.pps[p.id] = p;
      return;
    }
    if (!coded_w) fail("slice before any sequence parameter set");
    SliceHeader h;
    h.nal_type = type;
    h.nal_ref_idc = ref_idc;
    if (type == 5 && !ref_idc) fail("IDR picture with nal_ref_idc 0");
    const SPS* s;
    const PPS* p;
    slice_header_syntax(b, h, codec.sps, codec.pps, s, p);
    if (codec.cur && h.first_mb == 0) codec.finish_picture();
    codec.sh = h;
    codec.s = s;
    codec.p = p;
    if (16 * s->mbw != coded_w || 16 * s->mbh != coded_h)
      unsupported("a change of picture size within the stream");
    if (!codec.cur) codec.start_picture();
    codec.start_slice();
    codec.slice_data();
  }

  // what cv2 shows of a picture depends on more than its samples here:
  // refused by name where the conversion was not held against cv2
  static void check_output(const SPS& s) {
    if (s.crop[0])
      unsupported("frame_crop_left_offset " + std::to_string(s.crop[0]) +
                  " (FFmpeg keeps the planes aligned and cv2 then rescales the frame)");
    if (!(s.vui_present && s.signal_type && s.colour_desc)) return;
    auto in = [](int v, std::initializer_list<int> ok) {
      for (int k : ok)
        if (v == k) return true;
      return false;
    };
    if (!in(s.matrix, {1, 2, 3, 4, 5, 6, 7, 9}))
      unsupported("matrix_coefficients " + std::to_string(s.matrix));
    if (!in(s.primaries, {1, 2, 4, 5, 6, 7}))
      unsupported("colour_primaries " + std::to_string(s.primaries) + " (cv2 maps the gamut)");
    if (!in(s.transfer, {1, 2, 4, 5, 6, 7, 8, 13, 14}))
      unsupported("transfer_characteristics " + std::to_string(s.transfer) + " (cv2 tone-maps)");
  }

  // SEI messages: the alternative transfer characteristics (147) replace
  // the VUI's transfer in FFmpeg's frames from their access unit on (an SEI
  // naming no transfer or "unspecified" aside); those cv2 converts as it
  // converts the VUI's are taken, the others refused by name
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
        const int v = r[pos];
        bool sdr = false;
        for (int k : {1, 2, 4, 5, 6, 7, 8, 13, 14}) sdr |= v == k;
        if (v <= 18 && !sdr)
          unsupported("transfer_characteristics " + std::to_string(v) +
                      " from the alternative transfer characteristics SEI (cv2 tone-maps)");
      }
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
    int x0 = 2 * s.crop[0], y0 = 2 * s.crop[2];
    uint8_t* dst = out;
    if (movie.rotation) {
      bgr.resize((size_t)width * height * 3);
      dst = bgr.data();
    }
    yuv420_to_bgr(pic->plane(0) + (size_t)y0 * pic->w + x0, pic->w,
                  pic->plane(1) + (size_t)(y0 / 2) * (pic->w / 2) + x0 / 2,
                  pic->plane(2) + (size_t)(y0 / 2) * (pic->w / 2) + x0 / 2, pic->w / 2, width,
                  height, dst,
                  yuv2rgb_coefficients(s.vui_present && s.signal_type && s.colour_desc ? s.matrix : 2,
                                       s.vui_present && s.signal_type && s.full_range));
    if (movie.rotation) rotate_bgr(dst, width, height, movie.rotation, out);
    return 1;
  }
};

}  // namespace

extern "C" {

// info = {frames, width, height, fps numerator, fps denominator}; width and
// height as displayed (cropped, then rotated by the display matrix)
void* h264_open(const char* path, int64_t* info, char* err, int errlen) {
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
int h264_read(void* h, uint8_t* out, char* err, int errlen) {
  try {
    return static_cast<Reader*>(h)->next_frame(out);
  } catch (const Error& e) {
    return report(e, err, errlen);
  }
}

void h264_close(void* h) { delete static_cast<Reader*>(h); }

// what the frames decoded so far used (Stat order); returns the count
int h264_stats(void* h, int64_t* out) {
  const Codec& c = static_cast<Reader*>(h)->codec;
  for (int i = 0; i < kStatCount; i++) out[i] = c.stats[i];
  return kStatCount;
}

}  // extern "C"
