// The MP4/QuickTime container on the host, shared by the video codecs
// (mp4v.cpp: MPEG-4 Part 2, h264.cpp: H.264, hevc.cpp: H.265, and the H.264
// and H.265 test-stream writers). Each codec is its own library, so everything here has
// internal linkage.
//
// Demuxer: ISO-BMFF and QuickTime (brands such as isom/mp42 or "qt  "; moov
// before or after mdat). The first track whose handler is "vide", whatever
// tracks come before it; its first sample entry (mp4v with its esds, avc1 or
// avc3 with its avcC, hvc1 or hev1 with its hvcC, or any other, which the
// reader refuses by name); samples
// through stts/stsc/stsz/stco|co64, and ctts (versions 0 and 1) for the
// composition times of reordered pictures. An edit list is applied when it is
// one that FFmpeg's muxer writes: the identity (one edit of the whole media
// from time 0 at rate 1), or, for a track with composition offsets, one edit
// at rate 1 from the smallest composition time, so that no sample falls
// before it or after its end; any other is refused by name. From ctts comes
// the reorder delay that FFmpeg's demuxer guesses (video_delay), which sets
// where its H.264 decoder starts to hold pictures back. The display matrix, the track's
// (tkhd) times the movie's (mvhd) as FFmpeg composes them, gives the rotation
// that cv2.VideoCapture applies (CAP_PROP_ORIENTATION_AUTO): 0, 90, 180 or
// 270 degrees clockwise. A matrix that is no such rotation (another angle, a
// mirror, a shear) is refused by name.
//
// Also here: the moov box the writers emit, YUV 4:2:0 -> BGR24 as swscale
// converts it for cv2 (8-bit, and 9- or 10-bit), and the rotation of a BGR
// frame.

#pragma once

#include <algorithm>
#include <array>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

namespace {

struct Error {
  int code;  // 1 malformed or I/O, 2 unsupported
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Error{1, msg}; }
[[noreturn]] void unsupported(const std::string& msg) { throw Error{2, msg}; }

int report(const Error& e, char* err, int errlen) {
  if (err && errlen > 0) snprintf(err, errlen, "%s", e.msg.c_str());
  return e.code == 2 ? -2 : -1;
}

inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (p[1] << 16) | (p[2] << 8) | p[3];
}
uint64_t be64(const uint8_t* p) { return (uint64_t(be32(p)) << 32) | be32(p + 4); }
uint16_t be16(const uint8_t* p) { return (uint16_t)((p[0] << 8) | p[1]); }

// --------------------------------------------------------------- demux --
struct Sample {
  uint64_t offset;
  uint32_t size;
};

struct Track {
  std::string handler, entry;
  uint32_t timescale = 0;
  uint64_t duration = 0;
  std::vector<uint8_t> dsi;   // mp4v: the esds DecoderSpecificInfo
  int esds_object_type = -1;
  std::vector<uint8_t> avcc;  // avc1/avc3: the avcC box's payload
  std::vector<uint8_t> hvcc;  // hvc1/hev1: the hvcC box's payload
  int entry_w = 0, entry_h = 0;
  int32_t matrix[9] = {0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000};
  std::vector<std::array<int64_t, 3>> elst;  // segment duration, media time, rate (16.16)
  std::vector<std::pair<uint32_t, uint32_t>> stts;  // count, delta
  std::vector<std::pair<uint32_t, int32_t>> ctts;   // count, composition offset
  int ctts_version = 0;
  std::vector<std::array<uint32_t, 3>> stsc;        // first, per chunk, desc
  std::vector<uint32_t> stsz;
  uint32_t stsz_fixed = 0, stsz_count = 0;
  std::vector<uint64_t> chunks;
};

// Descriptor length of an esds: up to four 7-bit groups
size_t desc_len(const uint8_t*& p, const uint8_t* end) {
  size_t n = 0;
  for (int i = 0; i < 4 && p < end; i++) {
    uint8_t b = *p++;
    n = (n << 7) | (b & 0x7F);
    if (!(b & 0x80)) break;
  }
  return n;
}

void parse_esds(const uint8_t* p, const uint8_t* end, Track& t) {
  p += 4;  // version, flags
  while (p + 2 <= end) {
    int tag = *p++;
    size_t n = desc_len(p, end);
    const uint8_t* body = p;
    if (body + n > end) n = end - body;
    if (tag == 3) {  // ES_Descriptor
      const uint8_t* q = body + 2;
      int flags = *q++;
      if (flags & 0x80) q += 2;
      if (flags & 0x40) q += 1 + *q;
      if (flags & 0x20) q += 2;
      p = q;  // its sub-descriptors follow
      continue;
    }
    if (tag == 4) {  // DecoderConfigDescriptor
      t.esds_object_type = body[0];
      p = body + 13;
      continue;
    }
    if (tag == 5) t.dsi.assign(body, body + n);  // DecoderSpecificInfo
    p = body + n;
  }
}

struct Movie;
void parse_boxes(const uint8_t* p, const uint8_t* end, Track& t, Movie& m);

struct Movie {
  FILE* f = nullptr;
  uint64_t fsize = 0;
  std::string brand;
  int32_t mvhd_matrix[9] = {0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000};
  uint32_t movie_timescale = 1000;
  std::vector<Track> tracks;
  Track track;  // the first video track
  std::vector<Sample> samples;
  uint64_t total_delta = 0;
  std::vector<int64_t> cts;  // composition time of each sample (decode order)
  int video_delay = 0;       // FFmpeg's mov_estimate_video_delay
  int rotation = 0;  // clockwise degrees, as cv2 rotates the frames

  ~Movie() {
    if (f) fclose(f);
  }

  void open(const char* path) {
    f = fopen(path, "rb");
    if (!f) fail(std::string("cannot open ") + path);
    fseek(f, 0, SEEK_END);
    fsize = (uint64_t)ftello(f);
    uint64_t pos = 0;
    std::vector<uint8_t> moov;
    bool first = false;
    while (pos + 8 <= fsize) {
      uint8_t h[16];
      fseeko(f, (off_t)pos, SEEK_SET);
      if (fread(h, 1, 8, f) != 8) fail("truncated box header");
      uint64_t size = be32(h);
      size_t head = 8;
      if (size == 1) {
        if (fread(h + 8, 1, 8, f) != 8) fail("truncated box header");
        size = be64(h + 8);
        head = 16;
      } else if (size == 0) {
        size = fsize - pos;
      }
      if (size < head) fail("box of size < 8");
      if (pos == 0) {
        if (memcmp(h + 4, "ftyp", 4) != 0 && memcmp(h + 4, "moov", 4) != 0 &&
            memcmp(h + 4, "mdat", 4) != 0 && memcmp(h + 4, "free", 4) != 0 &&
            memcmp(h + 4, "wide", 4) != 0)
          fail("not an ISO base media (MP4) or QuickTime file");
        first = true;
      }
      if (memcmp(h + 4, "ftyp", 4) == 0 && size >= head + 4) {
        char b[4];
        if (fread(b, 1, 4, f) != 4) fail("truncated ftyp");
        brand.assign(b, 4);
      }
      if (memcmp(h + 4, "moov", 4) == 0) {
        if (pos + size > fsize) fail("truncated moov");
        moov.resize(size - head);
        if (fread(moov.data(), 1, moov.size(), f) != moov.size()) fail("truncated moov");
      }
      pos += size;
    }
    if (!first || moov.empty()) fail("no moov box (not a complete MP4 file)");
    Track root;
    parse_boxes(moov.data(), moov.data() + moov.size(), root, *this);
    const Track* video = nullptr;
    for (const Track& t : tracks)
      if (t.handler == "vide") { video = &t; break; }
    if (!video) fail("no video track");
    track = *video;
    build_samples();
    check_edits();
    rotation = display_rotation();
  }

  void build_samples() {
    const Track& t = track;
    uint32_t count = t.stsz_fixed ? t.stsz_count : (uint32_t)t.stsz.size();
    size_t k = 0;
    for (size_t c = 0; c < t.chunks.size() && k < count; c++) {
      uint32_t per = 0;
      for (const auto& e : t.stsc)
        if (e[0] <= c + 1) per = e[1];
      uint64_t off = t.chunks[c];
      for (uint32_t j = 0; j < per && k < count; j++, k++) {
        uint32_t sz = t.stsz_fixed ? t.stsz_fixed : t.stsz[k];
        if (off + sz > fsize) fail("sample past the end of the file");
        samples.push_back({off, sz});
        off += sz;
      }
    }
    if (k != count) fail("sample table lists more samples than its chunks hold");
    int64_t dts = 0;
    size_t e = 0, used = 0, ce = 0, cused = 0;
    for (size_t i = 0; i < samples.size(); i++) {
      int64_t off = 0;
      if (ce < t.ctts.size()) {
        off = t.ctts[ce].second;
        if (++cused >= t.ctts[ce].first) { ce++; cused = 0; }
      }
      cts.push_back(dts + off);
      while (e < t.stts.size() && used >= t.stts[e].first) { e++; used = 0; }
      if (e < t.stts.size()) { dts += t.stts[e].second; used++; }
    }
    for (const auto& s : t.stts) total_delta += (uint64_t)s.first * s.second;
    estimate_video_delay();
  }

  // mov_estimate_video_delay: the most pictures decoded before one that
  // follow it in composition order, over a window of 17
  void estimate_video_delay() {
    const int kMax = 16;
    if (track.ctts.empty()) return;
    size_t n = 0;
    for (const auto& c : track.ctts) n += c.first;
    n = std::min(n, cts.size());
    int64_t buf[kMax + 1];
    for (int64_t& v : buf) v = INT64_MIN;
    int start = 0;
    for (size_t i = 0; i < n; i++) {
      int j = start;
      start = start + 1 == kMax + 1 ? 0 : start + 1;
      buf[j] = cts[i];
      int swaps = 0;
      while (j != start) {
        int r = j - 1 < 0 ? kMax : j - 1;
        if (buf[j] >= buf[r]) break;
        std::swap(buf[j], buf[r]);
        swaps++;
        j = r;
      }
      video_delay = std::max(video_delay, swaps);
    }
  }

  // The edit lists FFmpeg's muxer writes: the identity (one edit of the media
  // from time 0 at rate 1), which changes nothing, and for a track with
  // composition offsets one edit at rate 1 from the smallest composition
  // time that reaches past the last one, which shifts the presentation times
  // and drops no frame. FFmpeg's rules for the others (empty edits, an edit
  // that starts inside or ends before the frames, several edits) are not
  // written out.
  void check_edits() const {
    const auto& e = track.elst;
    if (e.empty()) return;
    int64_t first = cts.empty() ? 0 : *std::min_element(cts.begin(), cts.end());
    int64_t last = cts.empty() ? 0 : *std::max_element(cts.begin(), cts.end());
    auto refuse = [&](const std::string& why) {
      unsupported("edit list (" + std::to_string(e.size()) + " edits, the first from media time " +
                  std::to_string(e[0][1]) + "): " + why);
    };
    if (e.size() != 1 || e[0][2] != 0x10000) refuse("only one edit at rate 1 is applied");
    if (e[0][1] == 0) return;
    if (track.ctts.empty() || e[0][1] != first)
      refuse("only the identity edit list, or one from the smallest composition time, is applied");
    if (track.ctts_version == 1) refuse("composition offsets of ctts version 1 with an edit");
    int64_t end = e[0][1] + (int64_t)std::llround((double)e[0][0] * track.timescale / movie_timescale);
    if (last >= end) refuse("it ends before the last frame");
  }

  // The track matrix times the movie matrix (row vectors, as FFmpeg composes
  // them), then the angle cv2 rotates by: atan2(b, a) in degrees.
  int display_rotation() const {
    const int32_t* t = track.matrix;
    const int32_t* v = mvhd_matrix;
    double m[4];
    for (int i = 0; i < 2; i++)
      for (int j = 0; j < 2; j++)
        m[2 * i + j] = ((double)t[3 * i] * v[j] + (double)t[3 * i + 1] * v[3 + j]) / 65536.0 /
                       65536.0;
    double a = m[0], b = m[1], c = m[2], d = m[3];
    if (b == 0 && c == 0 && a > 0 && d > 0 && a == d) return 0;
    if (a == 0 && d == 0 && b > 0 && c < 0 && b == -c) return 90;
    if (b == 0 && c == 0 && a < 0 && d < 0 && a == d) return 180;
    if (a == 0 && d == 0 && b < 0 && c > 0 && c == -b) return 270;
    char buf[160];
    snprintf(buf, sizeof buf, "display matrix [%g %g; %g %g]: %s", a, b, c, d,
             a * d - b * c < 0 ? "it mirrors the frames"
                               : "not a rotation by a multiple of 90 degrees");
    unsupported(buf);
  }

  std::vector<uint8_t> read_sample(size_t i) {
    std::vector<uint8_t> s(samples[i].size);
    fseeko(f, (off_t)samples[i].offset, SEEK_SET);
    if (fread(s.data(), 1, s.size(), f) != s.size()) fail("truncated sample");
    return s;
  }
};

void read_matrix(const uint8_t* p, int32_t* m) {
  for (int i = 0; i < 9; i++) m[i] = (int32_t)be32(p + 4 * i);
}

void parse_box(const std::string& type, const uint8_t* b, const uint8_t* e, Track& t, Movie& mv) {
  size_t n = e - b;
  if (type == "moov" || type == "mdia" || type == "minf" || type == "stbl" || type == "edts") {
    parse_boxes(b, e, t, mv);
  } else if (type == "trak") {
    Track nt;
    parse_boxes(b, e, nt, mv);
    mv.tracks.push_back(std::move(nt));
  } else if (type == "mvhd" && n >= 100) {
    read_matrix(b + (b[0] == 1 ? 48 : 36), mv.mvhd_matrix);
    mv.movie_timescale = be32(b + (b[0] == 1 ? 20 : 12));
    if (!mv.movie_timescale) fail("mvhd timescale 0");
  } else if (type == "tkhd" && n >= 76) {
    size_t off = b[0] == 1 ? 52 : 40;
    if (n >= off + 36) read_matrix(b + off, t.matrix);
  } else if (type == "elst" && n >= 8) {
    bool v1 = b[0] == 1;
    uint32_t cnt = be32(b + 4);
    size_t w = v1 ? 20 : 12;
    if (8 + (uint64_t)cnt * w > n) fail("truncated elst");
    for (uint32_t i = 0; i < cnt; i++) {
      const uint8_t* q = b + 8 + w * i;
      int64_t dur = v1 ? (int64_t)be64(q) : be32(q);
      int64_t media = v1 ? (int64_t)be64(q + 8) : (int64_t)(int32_t)be32(q + 4);
      int64_t rate = (int32_t)be32(q + (v1 ? 16 : 8));
      t.elst.push_back({dur, media, rate});
    }
  } else if (type == "mdhd" && n >= 24) {
    if (b[0] == 1 && n >= 32) { t.timescale = be32(b + 20); t.duration = be64(b + 24); }
    else { t.timescale = be32(b + 12); t.duration = be32(b + 16); }
  } else if (type == "hdlr" && n >= 12) {
    t.handler.assign((const char*)b + 8, 4);
  } else if (type == "stsd" && n >= 16) {
    const uint8_t* q = b + 8;  // the first sample entry
    uint32_t size = be32(q);
    t.entry.assign((const char*)q + 4, 4);
    if (q + size > e || size < 86) return;
    t.entry_w = be16(q + 32);
    t.entry_h = be16(q + 34);
    const uint8_t* c = q + 86;  // the visual sample entry's child boxes
    while (c + 8 <= q + size) {
      uint32_t cs = be32(c);
      if (cs < 8 || c + cs > q + size) break;
      if (memcmp(c + 4, "esds", 4) == 0) parse_esds(c + 8, c + cs, t);
      if (memcmp(c + 4, "avcC", 4) == 0) t.avcc.assign(c + 8, c + cs);
      if (memcmp(c + 4, "hvcC", 4) == 0) t.hvcc.assign(c + 8, c + cs);
      c += cs;
    }
  } else if (type == "stts" && n >= 8) {
    uint32_t cnt = be32(b + 4);
    if (8 + (uint64_t)cnt * 8 > n) fail("truncated stts");
    for (uint32_t i = 0; i < cnt; i++) t.stts.push_back({be32(b + 8 + 8 * i), be32(b + 12 + 8 * i)});
  } else if (type == "ctts" && n >= 8) {
    uint32_t cnt = be32(b + 4);
    if (8 + (uint64_t)cnt * 8 > n) fail("truncated ctts");
    t.ctts_version = b[0];
    for (uint32_t i = 0; i < cnt; i++) {
      uint32_t off = be32(b + 12 + 8 * i);
      // version 0 offsets are unsigned; FFmpeg reads both as signed
      t.ctts.push_back({be32(b + 8 + 8 * i), (int32_t)off});
    }
  } else if (type == "stsc" && n >= 8) {
    uint32_t cnt = be32(b + 4);
    if (8 + (uint64_t)cnt * 12 > n) fail("truncated stsc");
    for (uint32_t i = 0; i < cnt; i++)
      t.stsc.push_back({be32(b + 8 + 12 * i), be32(b + 12 + 12 * i), be32(b + 16 + 12 * i)});
  } else if (type == "stsz" && n >= 12) {
    t.stsz_fixed = be32(b + 4);
    t.stsz_count = be32(b + 8);
    if (!t.stsz_fixed) {
      if (12 + (uint64_t)t.stsz_count * 4 > n) fail("truncated stsz");
      for (uint32_t i = 0; i < t.stsz_count; i++) t.stsz.push_back(be32(b + 12 + 4 * i));
    }
  } else if ((type == "stco" || type == "co64") && n >= 8) {
    uint32_t cnt = be32(b + 4);
    int w = type == "stco" ? 4 : 8;
    if (8 + (uint64_t)cnt * w > n) fail("truncated " + type);
    for (uint32_t i = 0; i < cnt; i++)
      t.chunks.push_back(w == 4 ? be32(b + 8 + 4 * i) : be64(b + 8 + 8 * i));
  }
}

void parse_boxes(const uint8_t* p, const uint8_t* end, Track& t, Movie& mv) {
  while (p + 8 <= end) {
    uint64_t size = be32(p);
    size_t head = 8;
    if (size == 1) {
      if (p + 16 > end) fail("truncated box header");
      size = be64(p + 8);
      head = 16;
    } else if (size == 0) {
      size = end - p;
    }
    if (size < head || p + size > end) fail("box runs past its parent");
    parse_box(std::string((const char*)p + 4, 4), p + head, p + size, t, mv);
    p += size;
  }
}

// ------------------------------------------------------------------ mux --
void put_be(std::vector<uint8_t>& v, uint64_t x, int n) {
  for (int i = n - 1; i >= 0; i--) v.push_back((uint8_t)(x >> (8 * i)));
}

void box(std::vector<uint8_t>& out, const char* type, const std::vector<uint8_t>& body) {
  put_be(out, body.size() + 8, 4);
  out.insert(out.end(), type, type + 4);
  out.insert(out.end(), body.begin(), body.end());
}

// The header of a visual sample entry (ISO/IEC 14496-12 VisualSampleEntry)
std::vector<uint8_t> visual_entry(int width, int height) {
  std::vector<uint8_t> entry;
  put_be(entry, 0, 6); put_be(entry, 1, 2); put_be(entry, 0, 16);
  put_be(entry, width, 2); put_be(entry, height, 2);
  put_be(entry, 0x480000, 4); put_be(entry, 0x480000, 4); put_be(entry, 0, 4);
  put_be(entry, 1, 2); put_be(entry, 0, 32); put_be(entry, 0x18, 2); put_be(entry, 0xFFFF, 2);
  return entry;
}

struct MoovSpec {
  int width = 0, height = 0, timescale = 0, delta = 0;
  const char* entry_type = "mp4v";
  std::vector<uint8_t> entry;  // the sample entry's payload (visual_entry + children)
  std::vector<uint32_t> sizes;
  std::vector<uint32_t> sync;  // 1-based numbers of the sync samples
  uint64_t mdat_start = 0;     // the one chunk's offset
  bool big = false;            // co64 chunk offsets
  int rotation = 0;            // clockwise degrees in tkhd's matrix
  int64_t edit_media_time = -2;  // >= -1: one edit of the whole track from this media time
  std::vector<int32_t> ctts;     // composition offsets by sample, none when empty
  int ctts_version = 0;
};

// moov with one video track whose samples lie in one chunk
std::vector<uint8_t> build_moov(const MoovSpec& s) {
  uint64_t n = s.sizes.size();
  uint64_t dur = n * (uint64_t)s.delta;
  uint64_t dur_ms = (uint64_t)((double)dur * 1000.0 / s.timescale + 0.5);
  const uint32_t ident[9] = {0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000};
  uint32_t tk[9];
  memcpy(tk, ident, sizeof tk);
  const uint32_t one = 0x10000, neg = (uint32_t)-0x10000;
  if (s.rotation == 90) { tk[0] = 0; tk[1] = one; tk[3] = neg; tk[4] = 0; tk[6] = s.height << 16; }
  if (s.rotation == 180) { tk[0] = neg; tk[4] = neg; tk[6] = s.width << 16; tk[7] = s.height << 16; }
  if (s.rotation == 270) { tk[0] = 0; tk[1] = neg; tk[3] = one; tk[4] = 0; tk[7] = s.width << 16; }
  std::vector<uint8_t> mvhd, tkhd, mdhd, hdlr, vmhd, dref, url, stsd, stts, stss, stsc, stsz,
      stco;
  put_be(mvhd, 0, 4); put_be(mvhd, 0, 4); put_be(mvhd, 0, 4);
  put_be(mvhd, 1000, 4); put_be(mvhd, dur_ms, 4);
  put_be(mvhd, 0x10000, 4); put_be(mvhd, 0x100, 2); put_be(mvhd, 0, 10);
  for (uint32_t m : ident) put_be(mvhd, m, 4);
  put_be(mvhd, 0, 24); put_be(mvhd, 2, 4);
  put_be(tkhd, 3, 4); put_be(tkhd, 0, 4); put_be(tkhd, 0, 4); put_be(tkhd, 1, 4);
  put_be(tkhd, 0, 4); put_be(tkhd, dur_ms, 4); put_be(tkhd, 0, 8);
  put_be(tkhd, 0, 2); put_be(tkhd, 0, 2); put_be(tkhd, 0, 2); put_be(tkhd, 0, 2);
  for (uint32_t m : tk) put_be(tkhd, m, 4);
  put_be(tkhd, (uint64_t)s.width << 16, 4); put_be(tkhd, (uint64_t)s.height << 16, 4);
  put_be(mdhd, 0, 4); put_be(mdhd, 0, 4); put_be(mdhd, 0, 4);
  put_be(mdhd, s.timescale, 4); put_be(mdhd, dur, 4); put_be(mdhd, 0x55C4, 2); put_be(mdhd, 0, 2);
  put_be(hdlr, 0, 4); put_be(hdlr, 0, 4); hdlr.insert(hdlr.end(), {'v', 'i', 'd', 'e'});
  put_be(hdlr, 0, 12);
  const char name[] = "VideoHandler";
  hdlr.insert(hdlr.end(), name, name + sizeof(name));
  put_be(vmhd, 1, 4); put_be(vmhd, 0, 8);
  put_be(url, 1, 4);
  put_be(dref, 0, 4); put_be(dref, 1, 4); box(dref, "url ", url);
  put_be(stsd, 0, 4); put_be(stsd, 1, 4); box(stsd, s.entry_type, s.entry);
  put_be(stts, 0, 4); put_be(stts, n ? 1 : 0, 4);
  if (n) { put_be(stts, n, 4); put_be(stts, s.delta, 4); }
  put_be(stss, 0, 4); put_be(stss, s.sync.size(), 4);
  for (uint32_t v : s.sync) put_be(stss, v, 4);
  put_be(stsc, 0, 4); put_be(stsc, n ? 1 : 0, 4);
  if (n) { put_be(stsc, 1, 4); put_be(stsc, n, 4); put_be(stsc, 1, 4); }
  put_be(stsz, 0, 4); put_be(stsz, 0, 4); put_be(stsz, n, 4);
  for (uint32_t v : s.sizes) put_be(stsz, v, 4);
  put_be(stco, 0, 4); put_be(stco, n ? 1 : 0, 4);
  if (n) put_be(stco, s.mdat_start, s.big ? 8 : 4);
  std::vector<uint8_t> stbl, minf, dinf, mdia, trak, moov, out;
  box(stbl, "stsd", stsd); box(stbl, "stts", stts);
  if (s.sync.size() != n) box(stbl, "stss", stss);
  if (!s.ctts.empty()) {  // run-length coded
    std::vector<uint8_t> ctts, runs;
    uint32_t count = 0;
    for (size_t i = 0; i < s.ctts.size(); i++) {
      count++;
      if (i + 1 == s.ctts.size() || s.ctts[i + 1] != s.ctts[i]) {
        put_be(runs, count, 4);
        put_be(runs, (uint32_t)s.ctts[i], 4);
        count = 0;
      }
    }
    put_be(ctts, (uint64_t)s.ctts_version << 24, 4); put_be(ctts, runs.size() / 8, 4);
    ctts.insert(ctts.end(), runs.begin(), runs.end());
    box(stbl, "ctts", ctts);
  }
  box(stbl, "stsc", stsc); box(stbl, "stsz", stsz); box(stbl, s.big ? "co64" : "stco", stco);
  box(dinf, "dref", dref);
  box(minf, "vmhd", vmhd); box(minf, "dinf", dinf); box(minf, "stbl", stbl);
  box(mdia, "mdhd", mdhd); box(mdia, "hdlr", hdlr); box(mdia, "minf", minf);
  box(trak, "tkhd", tkhd);
  if (s.edit_media_time >= -1) {
    std::vector<uint8_t> elst, edts;
    put_be(elst, 0, 4); put_be(elst, 1, 4);
    put_be(elst, dur_ms, 4); put_be(elst, (uint32_t)(int32_t)s.edit_media_time, 4);
    put_be(elst, 0x10000, 4);
    box(edts, "elst", elst);
    box(trak, "edts", edts);
  }
  box(trak, "mdia", mdia);
  box(moov, "mvhd", mvhd); box(moov, "trak", trak);
  box(out, "moov", moov);
  return out;
}

// ------------------------------------------------------ YUV -> BGR24 --
// swscale's x86 yuv2rgb as cv2 converts the decoder's yuv420p frames: Y, U,
// V scaled by 8, the offsets (16 x 8 for Y at limited range, 128 x 8 for U
// and V) removed, multiplied by 16-bit coefficients (pmulhw: the product's
// high half), summed and saturated to 0..255; chroma replicated over 2x2
// pixels. The coefficients are ff_yuv2rgb_c_init_tables' for the matrix and
// range the stream signals (cv2 hands them to swscale); by default BT.601 at
// limited range.
struct Yuv2Rgb {
  int yc, yoff, vr, ub, ug, vg;
};

// ff_yuv2rgb_coeffs: {crv, cbu, cgu, cgv} by matrix_coefficients 0..10
const int32_t kYuvMatrices[11][4] = {
    {117489, 138438, 13975, 34925}, {117489, 138438, 13975, 34925},
    {104597, 132201, 25675, 53279}, {104597, 132201, 25675, 53279},
    {104448, 132798, 24759, 53109}, {104597, 132201, 25675, 53279},
    {104597, 132201, 25675, 53279}, {117579, 136230, 16907, 35559},
    {0, 0, 0, 0},                   {110013, 140363, 12277, 42626},
    {110013, 140363, 12277, 42626}};

inline int round16(int64_t f) {
  int64_t r = (f + (1 << 15)) >> 16;
  return (int)(r < -0x8000 ? -0x8000 : r > 0x7FFF ? 0x7FFF : r);
}

Yuv2Rgb yuv2rgb_coefficients(int matrix, bool full_range) {
  const int32_t* m = kYuvMatrices[matrix >= 0 && matrix <= 10 ? matrix : 2];
  int64_t crv = m[0], cbu = m[1], cgu = -(int64_t)m[2], cgv = -(int64_t)m[3];
  int64_t cy = 1 << 16, oy = 0;
  if (!full_range) {
    cy = cy * 255 / 219;
    oy = 16 << 16;
  } else {
    crv = crv * 224 / 255;
    cbu = cbu * 224 / 255;
    cgu = cgu * 224 / 255;
    cgv = cgv * 224 / 255;
  }
  return {round16(cy * (1 << 13)), round16(oy * (1 << 3)), round16(crv * (1 << 13)),
          round16(cbu * (1 << 13)), round16(cgu * (1 << 13)), round16(cgv * (1 << 13))};
}

// The chroma terms are computed once a row pair, then added to each pixel's
// luma term (the same integers as the per-pixel sums). The samples are 8-bit,
// in bytes or (HEVC's planes) in 16-bit words.
template <class T>
void yuv420_to_bgr(const T* Y, int ys, const T* U, const T* V, int cs, int width, int height,
                   uint8_t* out, const Yuv2Rgb& k = yuv2rgb_coefficients(2, false)) {
  const int yc = k.yc, yoff = k.yoff, ub = k.ub, ug = k.ug, vg = k.vg, vrc = k.vr;
  std::vector<int> cbv((width + 1) / 2), cgv((width + 1) / 2), crv((width + 1) / 2);
  int *cb = cbv.data(), *cg = cgv.data(), *cr = crv.data();
  for (int y = 0; y < height; y++) {
    if (!(y & 1)) {
      const T* ur = U + (size_t)(y >> 1) * cs;
      const T* vr = V + (size_t)(y >> 1) * cs;
      for (int x = 0; x < (width + 1) / 2; x++) {
        int u = ur[x] * 8 - 1024, v = vr[x] * 8 - 1024;
        cb[x] = (u * ub) >> 16;
        cg[x] = ((u * ug) >> 16) + ((v * vg) >> 16);
        cr[x] = (v * vrc) >> 16;
      }
    }
    const T* yr = Y + (size_t)y * ys;
    uint8_t* o = out + (size_t)y * width * 3;
    for (int x = 0; x < width; x++) {
      int yy = ((yr[x] * 8 - yoff) * yc) >> 16;
      o[3 * x] = clip8(yy + cb[x >> 1]);
      o[3 * x + 1] = clip8(yy + cg[x >> 1]);
      o[3 * x + 2] = clip8(yy + cr[x >> 1]);
    }
  }
}

// ---------------------------------------- YUV 4:2:0 at 9 or 10 bits -> BGR24 --
// What cv2 does with the decoder's yuv420p10le or yuv420p9le frames, read
// off cv2's own frames value by value (PCM pictures of chosen samples): no
// unscaled converter of swscale takes these formats, so they go through its
// general scaler (SWS_BICUBIC, as cv2 asks for), on x86 as follows.
// - Luma: unscaled, as 15-bit intermediates Y << (15 - bitDepth).
// - Chroma, across: the rows keep their width. swscale places the chroma of
//   packed RGB output in the centre of each pair of pixels and the input's
//   where the frame's chroma location says (FFmpeg's HEVC decoder: the VUI's
//   chroma_sample_loc_type_top_field, else left, for 4:2:0): co-sited on the
//   left (types 0, 2, 4), the output lies a quarter chroma sample to the
//   right, and a bicubic filter (B 0, C 0.6) of 4 taps with 14-bit
//   coefficients as initFilter makes them (sws_filter) interpolates it;
//   centred (1, 3, 5, and the unspecified types above 5), the filter is
//   one tap. The sum is shifted down by bitDepth - 1 (truncated, at most
//   32767) into 15 bits. Each output chroma sample serves two pixels: no
//   full chroma interpolation.
// - Chroma, down: upsampled 2x by the same kernel (4 taps, 12-bit
//   coefficients) from the input's rows, centred between two luma rows
//   (types 0, 1), on the upper one (2, 3) or the lower one (4, 5); the
//   picture's edge rows stand in for those beyond it.
// - All rows but the last two: the MMX vertical filter and yuv2rgb (x86
//   yuv2bgr24_X): each tap's product's high half (pmulhw) summed, plus a
//   rounder of 4, gives 8 times the 8-bit value (luma: (Y15 >> 4) + 4), and
//   the 16-bit arithmetic of the 8-bit converter above turns it into B, G
//   and R, saturated. No dither.
// - The last two rows: swscale switches to its C vertical scaler there
//   (yuv2bgr24_X_c): Y, U and V rounded to 8 bits ((sum + (1 << 18)) >> 19)
//   and looked up in ff_yuv2rgb_c_init_tables' tables, whose limited-range
//   luma lies up to 2.3 levels below the exact conversion.
// Limited and full range, and the matrices, come in as for 8 bits: the same
// coefficients (yuv2rgb_coefficients), and the tables from them.

// initFilter (libswscale/utils.c) for the bicubic kernel as the two calls
// below need it: unscaled (one tap), the same size at another position, or
// upscaling (inc <= 1 << 16, in 1/65536 input samples). For each of dst
// outputs, the first input sample of its taps and their coefficients,
// normalised to one; src_pos and dst_pos are the first sample's position in
// 1/256 of a sample from the edge, as get_local_pos gives them.
struct SwsFilter {
  int size = 0;
  std::vector<int> pos, coeff;
};
SwsFilter sws_filter(int64_t inc, int src, int dst, int align, int one, int src_pos, int dst_pos) {
  const int64_t fone = 1LL << 54, B = 0, C = (int64_t)(0.6 * (1 << 24));
  const bool unscaled = std::abs(inc - 0x10000) < 10 && src_pos == dst_pos;
  // 1 + the bicubic size factor, at most src - 2
  const int size = unscaled ? 1 : std::max(std::min(5, src - 2), 1);
  std::vector<int> pos(dst);
  std::vector<int64_t> f((size_t)dst * size, 0);
  int64_t x_dst_in_src = ((dst_pos * inc) >> 7) - ((src_pos * 0x10000LL) >> 7);
  for (int i = 0; i < dst && unscaled; i++) {
    pos[i] = i;
    f[i] = fone;
  }
  for (int i = 0; i < dst && !unscaled; i++, x_dst_in_src += 2 * inc) {
    int xx = (int)((x_dst_in_src - (size - 2) * (1LL << 16)) / (1 << 17));
    pos[i] = xx;
    for (int j = 0; j < size; j++, xx++) {
      int64_t d = std::llabs((int64_t)xx * (1 << 17) - x_dst_in_src) << 13;
      if (d >= 1LL << 31) continue;  // 0 beyond two samples
      int64_t dd = (d * d) >> 30, ddd = (dd * d) >> 30;
      f[(size_t)i * size + j] =
          d < 1LL << 30 ? (12 * (1 << 24) - 9 * B - 6 * C) * ddd + (-18 * (1 << 24) + 12 * B + 6 * C) * dd +
                              (6 * (1 << 24) - 2 * B) * (1 << 30)
                        : (-B - 6 * C) * ddd + (6 * B + 30 * C) * dd + (-12 * B - 48 * C) * d +
                              (8 * B + 24 * C) * (1 << 30);
    }
  }
  // drop near-zero taps: from the left by moving the filter on, from the right by size
  int min_size = 0;
  for (int i = dst - 1; i >= 0; i--) {
    int64_t* fi = &f[(size_t)i * size];
    int keep = size;
    int64_t cut = 0;
    for (int j = 0; j < size; j++) {
      cut += std::llabs(fi[0]);
      if (cut > 0.002 * fone) break;
      if (i < dst - 1 && pos[i] >= pos[i + 1]) break;
      for (int k = 1; k < size; k++) fi[k - 1] = fi[k];
      fi[size - 1] = 0;
      pos[i]++;
    }
    cut = 0;
    for (int j = size - 1; j > 0; j--) {
      cut += std::llabs(fi[j]);
      if (cut > 0.002 * fone) break;
      keep--;
    }
    min_size = std::max(min_size, keep);
  }
  const int out_size = (min_size + align - 1) & ~(align - 1);
  std::vector<int64_t> g((size_t)dst * out_size, 0);
  for (int i = 0; i < dst; i++)
    for (int j = 0; j < std::min(out_size, size); j++) g[(size_t)i * out_size + j] = f[(size_t)i * size + j];
  // the borders: taps before the first sample or after the last fold onto it
  for (int i = 0; i < dst; i++) {
    int64_t* gi = &g[(size_t)i * out_size];
    if (pos[i] < 0) {
      for (int j = 1; j < out_size; j++) {
        int left = std::max(j + pos[i], 0);
        gi[left] += gi[j];
        gi[j] = 0;
      }
      pos[i] = 0;
    }
    if (pos[i] + out_size > src) {
      int shift = pos[i] + std::min(out_size - src, 0);
      int64_t acc = 0;
      for (int j = out_size - 1; j >= 0; j--)
        if (pos[i] + j >= src) {
          acc += gi[j];
          gi[j] = 0;
        }
      for (int j = out_size - 1; j >= 0; j--) gi[j] = j < shift ? 0 : gi[j - shift];
      pos[i] -= shift;
      gi[src - 1 - pos[i]] += acc;
    }
  }
  // normalised to one, each rounding error carried to the next tap
  SwsFilter out;
  out.size = out_size;
  out.pos = pos;
  out.coeff.assign((size_t)dst * out_size, 0);
  for (int i = 0; i < dst; i++) {
    const int64_t* gi = &g[(size_t)i * out_size];
    int64_t sum = 0, error = 0;
    for (int j = 0; j < out_size; j++) sum += gi[j];
    sum = (sum + one / 2) / one;
    for (int j = 0; j < out_size; j++) {
      int64_t v = gi[j] + error;
      int64_t iv = v >= 0 ? (v + (sum >> 1)) / sum : (v - (sum >> 1)) / sum;  // ROUNDED_DIV
      out.coeff[(size_t)i * out_size + j] = (int)iv;
      error = v - iv * sum;
    }
  }
  return out;
}

// ff_yuv2rgb_c_init_tables for 24-bit output: the luma table and, by U or
// V, the offsets into it (rV, gU, bU) and the green offset by V (gV)
struct Yuv2RgbTables {
  static const int kHeadroom = 512;  // YUVRGB_TABLE_HEADROOM and its luma counterpart
  std::vector<uint8_t> y;
  int rv[256 + 2 * kHeadroom], gu[256 + 2 * kHeadroom], bu[256 + 2 * kHeadroom],
      gv[256 + 2 * kHeadroom];
  Yuv2RgbTables(int matrix, bool full_range) {
    const int32_t* m = kYuvMatrices[matrix >= 0 && matrix <= 10 ? matrix : 2];
    int64_t crv = m[0], cbu = m[1], cgu = -(int64_t)m[2], cgv = -(int64_t)m[3];
    int64_t cy = 1 << 16, oy = 0;
    if (!full_range) {
      cy = cy * 255 / 219;
      oy = 16 << 16;
    } else {
      crv = crv * 224 / 255;
      cbu = cbu * 224 / 255;
      cgu = cgu * 224 / 255;
      cgv = cgv * 224 / 255;
    }
    crv = (crv * (1 << 16) + 0x8000) / cy;
    cbu = (cbu * (1 << 16) + 0x8000) / cy;
    cgu = (cgu * (1 << 16) + 0x8000) / cy;
    cgv = (cgv * (1 << 16) + 0x8000) / cy;
    const int yoffs = (full_range ? 384 : 326) + kHeadroom;
    y.resize(1024 + 2 * kHeadroom);
    int64_t yb = -(384LL << 16) - kHeadroom * cy - oy;
    for (uint8_t& v : y) {
      v = clip8((int)((yb + 0x8000) >> 16));
      yb += cy;
    }
    for (int i = 0; i < 256 + 2 * kHeadroom; i++) {
      int64_t c = clip8(i - kHeadroom);
      rv[i] = yoffs - (int)(crv >> 9) + (int)((c * crv) >> 16);
      gu[i] = yoffs - (int)(cgu >> 9) + (int)((c * cgu) >> 16);
      bu[i] = yoffs - (int)(cbu >> 9) + (int)((c * cbu) >> 16);
      gv[i] = -(int)(cgv >> 9) + (int)((c * cgv) >> 16);
    }
  }
};

// Y, U, V of bit_depth (9 or 10) bits, U and V at half the width and height,
// into (height, width, 3) BGR bytes as above; height of 10 rows or more
// (below that swscale takes its bilinear vertical paths); loc is the chroma
// location type (chroma_sample_loc_type)
void yuv420_high_to_bgr(const uint16_t* Y, int ys, const uint16_t* U, const uint16_t* V, int cs,
                        int width, int height, int bit_depth, uint8_t* out, int matrix,
                        bool full_range, int loc) {
  const int cw = (width + 1) / 2, ch = (height + 1) / 2, sh = bit_depth - 1;
  const Yuv2Rgb k = yuv2rgb_coefficients(matrix, full_range);
  // the input chroma's place in the luma grid, in 1/256 of a luma sample, by
  // type (left, centre, top left, top, bottom left, bottom; the centre when
  // unspecified), then as get_local_pos turns it
  static const int kLocX[6] = {0, 128, 0, 128, 0, 128}, kLocY[6] = {128, 128, 0, 0, 256, 256};
  const bool known = loc >= 0 && loc <= 5;
  const int xpos = known ? kLocX[loc] : 128, ypos = known ? kLocY[loc] : 128;
  const SwsFilter hf = sws_filter((((int64_t)cw << 16) + (cw >> 1)) / cw, cw, cw, 4, 1 << 14,
                                  (xpos + 128) >> 1, 128);
  const SwsFilter vf = sws_filter((((int64_t)ch << 16) + (height >> 1)) / height, ch, height, 2,
                                  1 << 12, (ypos + 128) >> 1, 128);
  // the chroma rows scaled across, 15-bit (a tap past the row's end has
  // coefficient 0: it reads the last sample)
  std::vector<int> at((size_t)cw * hf.size);
  for (int x = 0; x < cw; x++)
    for (int j = 0; j < hf.size; j++) at[(size_t)x * hf.size + j] = std::min(hf.pos[x] + j, cw - 1);
  std::vector<int16_t> u15((size_t)ch * cw), v15((size_t)ch * cw);
  for (int r = 0; r < ch; r++) {
    const uint16_t* ur = U + (size_t)r * cs;
    const uint16_t* vr = V + (size_t)r * cs;
    for (int x = 0; x < cw; x++) {
      const int* c = &hf.coeff[(size_t)x * hf.size];
      const int* a = &at[(size_t)x * hf.size];
      int su = 0, sv = 0;
      for (int j = 0; j < hf.size; j++) {
        su += ur[a[j]] * c[j];
        sv += vr[a[j]] * c[j];
      }
      u15[(size_t)r * cw + x] = (int16_t)std::min(su >> sh, 32767);
      v15[(size_t)r * cw + x] = (int16_t)std::min(sv >> sh, 32767);
    }
  }
  std::unique_ptr<Yuv2RgbTables> tab;
  std::vector<int> cu(cw), cv(cw), tb(cw), tg(cw), tr(cw);
  for (int y = 0; y < height; y++) {
    const uint16_t* yr = Y + (size_t)y * ys;
    uint8_t* o = out + (size_t)y * width * 3;
    const int* vc = &vf.coeff[(size_t)y * vf.size];
    const int16_t* ur = &u15[(size_t)vf.pos[y] * cw];
    const int16_t* vr = &v15[(size_t)vf.pos[y] * cw];
    if (y < height - 2) {  // MMX: pmulhw sums with the rounder, then yuv2rgb
      std::fill(cu.begin(), cu.end(), 4 - 1024);
      std::fill(cv.begin(), cv.end(), 4 - 1024);
      for (int j = 0; j < vf.size; j++) {
        const int c = vc[j];
        const int16_t* uj = ur + (size_t)j * cw;
        const int16_t* vj = vr + (size_t)j * cw;
        for (int x = 0; x < cw; x++) {
          cu[x] += (uj[x] * c) >> 16;
          cv[x] += (vj[x] * c) >> 16;
        }
      }
      for (int x = 0; x < cw; x++) {
        tb[x] = (cu[x] * k.ub) >> 16;
        tg[x] = ((cu[x] * k.ug) >> 16) + ((cv[x] * k.vg) >> 16);
        tr[x] = (cv[x] * k.vr) >> 16;
      }
      const int up = 15 - bit_depth;
      for (int x = 0; x < width; x++) {
        int yy = ((((yr[x] << up) >> 4) + 4 - k.yoff) * k.yc) >> 16;
        o[3 * x] = clip8(yy + tb[x >> 1]);
        o[3 * x + 1] = clip8(yy + tg[x >> 1]);
        o[3 * x + 2] = clip8(yy + tr[x >> 1]);
      }
    } else {  // C: 8-bit values through the tables
      if (!tab) tab.reset(new Yuv2RgbTables(matrix, full_range));
      const Yuv2RgbTables& t = *tab;
      const int hr = Yuv2RgbTables::kHeadroom;
      for (int x = 0; x < cw; x++) {
        int su = 1 << 18, sv = 1 << 18;
        for (int j = 0; j < vf.size; j++) {
          su += ur[(size_t)j * cw + x] * vc[j];
          sv += vr[(size_t)j * cw + x] * vc[j];
        }
        cu[x] = su >> 19;
        cv[x] = sv >> 19;
      }
      for (int x = 0; x < width; x++) {
        int y8 = (((yr[x] << (15 - bit_depth)) * 4096) + (1 << 18)) >> 19;
        int u = cu[x >> 1] + hr, v = cv[x >> 1] + hr;
        o[3 * x] = t.y[t.bu[u] + y8];
        o[3 * x + 1] = t.y[t.gu[u] + t.gv[v] + y8];
        o[3 * x + 2] = t.y[t.rv[v] + y8];
      }
    }
  }
}

// A (h, w, 3) frame rotated clockwise by deg into out ((w, h, 3) for 90/270),
// as cv2.rotate does for the display matrix.
void rotate_bgr(const uint8_t* src, int w, int h, int deg, uint8_t* out) {
  if (deg == 0) { memcpy(out, src, (size_t)w * h * 3); return; }
  int ow = deg == 180 ? w : h, oh = deg == 180 ? h : w;
  for (int r = 0; r < oh; r++) {
    uint8_t* o = out + (size_t)r * ow * 3;
    for (int c = 0; c < ow; c++) {
      int sy, sx;
      if (deg == 90) { sy = h - 1 - c; sx = r; }
      else if (deg == 180) { sy = h - 1 - r; sx = w - 1 - c; }
      else { sy = c; sx = w - 1 - r; }
      const uint8_t* s = src + ((size_t)sy * w + sx) * 3;
      o[3 * c] = s[0];
      o[3 * c + 1] = s[1];
      o[3 * c + 2] = s[2];
    }
  }
}

}  // namespace

extern "C" {

// The first video track's sample entry (4 characters and a NUL into entry);
// 0, or a negative error code with the message in err.
int mp4_sample_entry(const char* path, char* entry, char* err, int errlen) {
  try {
    Movie m;
    m.open(path);
    snprintf(entry, 5, "%s", m.track.entry.c_str());
    return 0;
  } catch (const Error& e) {
    return report(e, err, errlen);
  }
}

}  // extern "C"
