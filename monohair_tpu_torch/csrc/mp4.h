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
#include <atomic>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
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
  std::vector<uint8_t> hvcc;  // hvc1/hev1/dvh1/dvhe: the hvcC box's payload
  std::vector<uint8_t> dovi;  // a Dolby Vision dvcC/dvvC box's payload
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
      if (memcmp(c + 4, "dvcC", 4) == 0 || memcmp(c + 4, "dvvC", 4) == 0) t.dovi.assign(c + 8, c + cs);
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

// -------------------------- HDR and wide gamut: cv2's colour management --
// What cv2 returns for a frame whose colour primaries are BT.2020 (9) or
// whose transfer is HLG (18), read off cv2's frames value by value (random
// and PCM pictures of chosen samples, and the stages one at a time through
// the library cv2 bundles). cv2 hands the decoder's frame to swscale's frame
// API with its colour tags and asks for BGR24 with none; swscale infers the
// output's colours (BT.709 primaries when the input's are not 1, 4-7; a
// transfer of BT.709 at 0..203 cd/m2 for HLG, else the input's), and where
// the two differ it converts in three passes:
// 1. YUV -> 16-bit RGB (RGBA64) by the general scaler's C code: luma and
//    chroma widened to 19 bits, the output chroma sited where the input's is
//    (so across it is one tap, and down 4 taps of the bicubic kernel), then
//    yuv2rgba64_X with the 16-bit yuv2rgb coefficients of the frame's matrix
//    and range (yuv420_to_rgb48).
// 2. A 3D LUT of 65^3 nodes, each 16-bit RGB, interpolated tetrahedrally in
//    integers (lut_apply). Built in floating point (ColourLut, after
//    FFmpeg's libswscale/cms.c, intent relative colorimetric, its default):
//    each node's RGB through the input's EOTF (BT.1886 from 203 cd/m2, or
//    HLG's with a 1000 cd/m2 display, in double), to LMS (Hunt-Pointer-
//    Estevez with 4% crosstalk) and IPT over PQ; a black point adaptation
//    of I with hull-based desaturation; out-of-gamut colours pulled to the
//    gamut along an exponential curve (gamma 1.8, scaled) towards the
//    gamut's most saturated colour of that hue (a golden-section search,
//    taken from the hue before the tone map); then back through the
//    output's inverse EOTF to x * 65534 + 0.5. PQ's EOTF here is the
//    1025-entry table below with linear interpolation, its OETF powf.
// 3. 16-bit RGB -> BGR24 by the general scaler with full chroma in and out
//    (rgb48_to_bgr): RGB to YUV by swscale's hard-coded BT.601 table at
//    limited range, the chroma re-sited from where the input frame's
//    chroma location says to the centre (across and down: bicubic, 4 taps,
//    or unscaled), then yuv2rgb_full with the frame's matrix at limited
//    range: a colour shift cv2 shows for every matrix but BT.601.
// Every sample of every pass is an integer of swscale's but the LUT's
// construction: that is float and double arithmetic, compiled here without
// fused multiply-add (as FFmpeg's x86-64 build has none), and glibc's powf,
// sinf, cosf, atan2f (the IPT hue and chroma), and pow, exp, log10 (the
// EOTFs): the same functions of the same glibc give the same bits, which
// the tests hold by the three LUTs' SHA-256 and the smoke run by the
// HLG LUT's on the card's host (glibc 2.39 there, 2.36 here: the same).

#pragma GCC push_options
#pragma GCC optimize("fp-contract=off")

struct Mat3 {
  float m[3][3];
};

// a = a * b, in float
void mat3_mul(Mat3& a, const Mat3& b) {
  const Mat3 t = a;
  for (int i = 0; i < 3; i++)
    for (int r = 0; r < 3; r++)
      a.m[r][i] = t.m[r][0] * b.m[0][i] + t.m[r][1] * b.m[1][i] + t.m[r][2] * b.m[2][i];
}

// the inverse through the adjugate, in double
void mat3_invert(Mat3& mat) {
  const double m00 = mat.m[0][0], m01 = mat.m[0][1], m02 = mat.m[0][2], m10 = mat.m[1][0],
               m11 = mat.m[1][1], m12 = mat.m[1][2], m20 = mat.m[2][0], m21 = mat.m[2][1],
               m22 = mat.m[2][2];
  const double a[3][3] = {{m11 * m22 - m21 * m12, -(m01 * m22 - m21 * m02), m01 * m12 - m11 * m02},
                          {-(m10 * m22 - m20 * m12), m00 * m22 - m20 * m02, -(m00 * m12 - m10 * m02)},
                          {m10 * m21 - m20 * m11, -(m00 * m21 - m20 * m01), m00 * m11 - m10 * m01}};
  const double det = 1.0 / (m00 * a[0][0] + m10 * a[0][1] + m20 * a[0][2]);
  for (int r = 0; r < 3; r++)
    for (int c = 0; c < 3; c++) mat.m[r][c] = (float)(det * a[r][c]);
}

// CIE xy of the white point and the R, G, B primaries (libavutil's
// rationals over 100000)
struct Primaries {
  double x[4], y[4];
};
const Primaries kBt709 = {{0.3127, 0.64, 0.30, 0.15}, {0.3290, 0.33, 0.60, 0.06}};
const Primaries kBt2020 = {{0.3127, 0.708, 0.170, 0.131}, {0.3290, 0.292, 0.797, 0.046}};

Mat3 rgb_to_xyz(const Primaries& p) {
  float X[4], Z[4], S[3];
  for (int k = 0; k < 4; k++) {
    const int i = k ? k - 1 : 3;
    X[i] = (float)(p.x[k] / p.y[k]);
    Z[i] = (float)((1 - p.x[k] - p.y[k]) / p.y[k]);
  }
  Mat3 out;
  for (int i = 0; i < 3; i++) {
    out.m[0][i] = X[i];
    out.m[1][i] = 1;
    out.m[2][i] = Z[i];
  }
  mat3_invert(out);
  for (int i = 0; i < 3; i++) S[i] = out.m[i][0] * X[3] + out.m[i][1] * 1 + out.m[i][2] * Z[3];
  for (int i = 0; i < 3; i++) {
    out.m[0][i] = S[i] * X[i];
    out.m[1][i] = S[i] * 1;
    out.m[2][i] = S[i] * Z[i];
  }
  return out;
}

Mat3 rgb_to_lms(const Primaries& p) {
  const Mat3 hpe = {{{0.40024f, 0.70760f, -0.08081f}, {-0.22630f, 1.16532f, 0.04570f}, {0.0f, 0.0f, 0.91822f}}};
  const float c = 0.04f;
  Mat3 m = {{{1 - 2 * c, c, c}, {c, 1 - 2 * c, c}, {c, c, 1 - 2 * c}}};
  mat3_mul(m, hpe);
  mat3_mul(m, rgb_to_xyz(p));
  return m;
}

// ST 2084 (PQ) EOTF in cd/m2 at 1024 steps of the signal, the last twice:
// FFmpeg's table (its values, not recomputed: they differ from a double
// evaluation by up to 2.5 ulp)
const float kPqEotf[1025] = {
    0x0p+0f, 0x1.53172p-15f, 0x1.12f724p-13f, 0x1.131cf2p-12f, 0x1.c479eap-12f, 0x1.4e379ep-11f,
    0x1.cd47f4p-11f, 0x1.2fb40cp-10f, 0x1.8257d4p-10f, 0x1.dea4dap-10f, 0x1.225bbep-9f,
    0x1.5a589p-9f, 0x1.975b82p-9f, 0x1.d978bep-9f, 0x1.1062d8p-8f, 0x1.36ac64p-8f, 0x1.5fa4b4p-8f,
    0x1.8b57dcp-8f, 0x1.b9d23cp-8f, 0x1.eb209ep-8f, 0x1.0fa7fep-7f, 0x1.2b36d6p-7f, 0x1.484394p-7f,
    0x1.66d526p-7f, 0x1.86f28p-7f, 0x1.a8a2cep-7f, 0x1.cbed38p-7f, 0x1.f0d91cp-7f, 0x1.0bb6eep-6f,
    0x1.1fd982p-6f, 0x1.34d814p-6f, 0x1.4ab686p-6f, 0x1.6178b8p-6f, 0x1.7922ap-6f, 0x1.91b842p-6f,
    0x1.ab3dap-6f, 0x1.c5b6d4p-6f, 0x1.e12802p-6f, 0x1.fd956p-6f, 0x1.0d818ep-5f, 0x1.1cbacp-5f,
    0x1.2c7872p-5f, 0x1.3cbcd6p-5f, 0x1.4d8a18p-5f, 0x1.5ee27ap-5f, 0x1.70c83cp-5f, 0x1.833dacp-5f,
    0x1.96450ep-5f, 0x1.a9e0bap-5f, 0x1.be130cp-5f, 0x1.d2de68p-5f, 0x1.e8452ep-5f, 0x1.fe49dp-5f,
    0x1.0a776p-4f, 0x1.161b4p-4f, 0x1.2211c2p-4f, 0x1.2e5c2ep-4f, 0x1.3afbcap-4f, 0x1.47f1e6p-4f,
    0x1.553fc6p-4f, 0x1.62e6c2p-4f, 0x1.70e82cp-4f, 0x1.7f4562p-4f, 0x1.8dffb8p-4f, 0x1.9d1892p-4f,
    0x1.ac915p-4f, 0x1.bc6b5cp-4f, 0x1.cca81cp-4f, 0x1.dd490ap-4f, 0x1.ee4f84p-4f, 0x1.ffbd0ap-4f,
    0x1.08c98ap-3f, 0x1.11e99p-3f, 0x1.1b3f54p-3f, 0x1.24cb9cp-3f, 0x1.2e8f2cp-3f, 0x1.388accp-3f,
    0x1.42bf3cp-3f, 0x1.4d2d4cp-3f, 0x1.57d5c6p-3f, 0x1.62b97cp-3f, 0x1.6dd938p-3f, 0x1.7935dp-3f,
    0x1.84d01ap-3f, 0x1.90a8ecp-3f, 0x1.9cc11ap-3f, 0x1.a91982p-3f, 0x1.b5b2fep-3f, 0x1.c28e7p-3f,
    0x1.cfacb8p-3f, 0x1.dd0ebap-3f, 0x1.eab55ap-3f, 0x1.f8a18ap-3f, 0x1.036a12p-2f, 0x1.0aa70ep-2f,
    0x1.12083p-2f, 0x1.198dfp-2f, 0x1.2138cap-2f, 0x1.290936p-2f, 0x1.30ffb2p-2f, 0x1.391ccp-2f,
    0x1.4160d4p-2f, 0x1.49cc74p-2f, 0x1.52602p-2f, 0x1.5b1c5ap-2f, 0x1.6401a6p-2f, 0x1.6d1088p-2f,
    0x1.764988p-2f, 0x1.7fad3p-2f, 0x1.893cp-2f, 0x1.92f686p-2f, 0x1.9cdd5p-2f, 0x1.a6f0e8p-2f,
    0x1.b131dcp-2f, 0x1.bba0bep-2f, 0x1.c63e1cp-2f, 0x1.d10a8cp-2f, 0x1.dc069cp-2f, 0x1.e732e4p-2f,
    0x1.f28ff8p-2f, 0x1.fe1e72p-2f, 0x1.04ef76p-1f, 0x1.0ae9p-1f, 0x1.10fc24p-1f, 0x1.172936p-1f,
    0x1.1d707ep-1f, 0x1.23d25p-1f, 0x1.2a4efcp-1f, 0x1.30e6d6p-1f, 0x1.379a2ep-1f, 0x1.3e695ap-1f,
    0x1.4554acp-1f, 0x1.4c5c7cp-1f, 0x1.53811cp-1f, 0x1.5ac2e6p-1f, 0x1.62222ep-1f, 0x1.699f58p-1f,
    0x1.713aacp-1f, 0x1.78f48cp-1f, 0x1.80cd52p-1f, 0x1.88c55ap-1f, 0x1.90ddp-1f, 0x1.9914a2p-1f,
    0x1.a16c9ep-1f, 0x1.a9e554p-1f, 0x1.b27f24p-1f, 0x1.bb3a6cp-1f, 0x1.c41792p-1f, 0x1.cd16f8p-1f,
    0x1.d639p-1f, 0x1.df7e0ep-1f, 0x1.e8e68ap-1f, 0x1.f272e4p-1f, 0x1.fc236ep-1f, 0x1.02fc4cp+0f,
    0x1.07f96cp+0f, 0x1.0d0944p+0f, 0x1.122c0ep+0f, 0x1.1762p+0f, 0x1.1cab4ep+0f, 0x1.220832p+0f,
    0x1.2778e6p+0f, 0x1.2cfd9cp+0f, 0x1.329692p+0f, 0x1.3843fep+0f, 0x1.3e061cp+0f, 0x1.43dd24p+0f,
    0x1.49c952p+0f, 0x1.4fcaeap+0f, 0x1.55e218p+0f, 0x1.5c0f22p+0f, 0x1.625242p+0f, 0x1.68abb6p+0f,
    0x1.6f1bbcp+0f, 0x1.75a296p+0f, 0x1.7c4082p+0f, 0x1.82f5bep+0f, 0x1.89c28ap+0f, 0x1.90a72ap+0f,
    0x1.97a3dep+0f, 0x1.9eb8e8p+0f, 0x1.a5e68ep+0f, 0x1.ad2d1p+0f, 0x1.b48cb2p+0f, 0x1.bc05c2p+0f,
    0x1.c39876p+0f, 0x1.cb451cp+0f, 0x1.d30bfap+0f, 0x1.daed56p+0f, 0x1.e2e97cp+0f, 0x1.eb00bp+0f,
    0x1.f3333ep+0f, 0x1.fb816ep+0f, 0x1.01f5c6p+1f, 0x1.0638f2p+1f, 0x1.0a8a6p+1f, 0x1.0eea38p+1f,
    0x1.13589ep+1f, 0x1.17d5bcp+1f, 0x1.1c61b6p+1f, 0x1.20fcbcp+1f, 0x1.25a6eap+1f, 0x1.2a606ep+1f,
    0x1.2f2972p+1f, 0x1.34021ep+1f, 0x1.38ea9cp+1f, 0x1.3de316p+1f, 0x1.42ebb4p+1f, 0x1.4804a4p+1f,
    0x1.4d2e1p+1f, 0x1.526824p+1f, 0x1.57b30ap+1f, 0x1.5d0efp+1f, 0x1.627c02p+1f, 0x1.67fa6ep+1f,
    0x1.6d8a5ep+1f, 0x1.732c0ap+1f, 0x1.78df94p+1f, 0x1.7ea52ep+1f, 0x1.847d08p+1f, 0x1.8a6754p+1f,
    0x1.90644p+1f, 0x1.9673fap+1f, 0x1.9c96b8p+1f, 0x1.a2cca8p+1f, 0x1.a915fcp+1f, 0x1.af72e4p+1f,
    0x1.b5e398p+1f, 0x1.bc6848p+1f, 0x1.c30128p+1f, 0x1.c9ae6ap+1f, 0x1.d07044p+1f, 0x1.d746f2p+1f,
    0x1.de329cp+1f, 0x1.e5337ep+1f, 0x1.ec49cep+1f, 0x1.f375c4p+1f, 0x1.fab796p+1f, 0x1.0107bep+2f,
    0x1.04bed8p+2f, 0x1.088134p+2f, 0x1.0c4efp+2f, 0x1.102828p+2f, 0x1.140cfap+2f, 0x1.17fd82p+2f,
    0x1.1bf9ep+2f, 0x1.20022ep+2f, 0x1.24168ep+2f, 0x1.283722p+2f, 0x1.2c63fep+2f, 0x1.309d48p+2f,
    0x1.34e32p+2f, 0x1.3935ap+2f, 0x1.3d94eep+2f, 0x1.420128p+2f, 0x1.467a6ep+2f, 0x1.4b00ep+2f,
    0x1.4f94ap+2f, 0x1.5435dp+2f, 0x1.58e49p+2f, 0x1.5da102p+2f, 0x1.626b4ap+2f, 0x1.674388p+2f,
    0x1.6c29ep+2f, 0x1.711e76p+2f, 0x1.76216cp+2f, 0x1.7b32e6p+2f, 0x1.80530ap+2f, 0x1.8581f8p+2f,
    0x1.8abfdap+2f, 0x1.900cdp+2f, 0x1.956902p+2f, 0x1.9ad4ap+2f, 0x1.a04fbap+2f, 0x1.a5da82p+2f,
    0x1.ab751ep+2f, 0x1.b11fb4p+2f, 0x1.b6da6cp+2f, 0x1.bca57p+2f, 0x1.c280e6p+2f, 0x1.c86cf4p+2f,
    0x1.ce69c6p+2f, 0x1.d47784p+2f, 0x1.da9658p+2f, 0x1.e0c66cp+2f, 0x1.e707e8p+2f, 0x1.ed5afap+2f,
    0x1.f3bfcap+2f, 0x1.fa3684p+2f, 0x1.005faap+3f, 0x1.03ad32p+3f, 0x1.0703f2p+3f, 0x1.0a64p+3f,
    0x1.0dcd72p+3f, 0x1.11405ep+3f, 0x1.14bcdep+3f, 0x1.184306p+3f, 0x1.1bd2eep+3f, 0x1.1f6caep+3f,
    0x1.23106p+3f, 0x1.26be18p+3f, 0x1.2a75fp+3f, 0x1.2e3802p+3f, 0x1.320466p+3f, 0x1.35db3ap+3f,
    0x1.39bc8cp+3f, 0x1.3da878p+3f, 0x1.419f1cp+3f, 0x1.45a09p+3f, 0x1.49acecp+3f, 0x1.4dc44ep+3f,
    0x1.51e6dp+3f, 0x1.561488p+3f, 0x1.5a4d94p+3f, 0x1.5e9212p+3f, 0x1.62e21ap+3f, 0x1.673dc4p+3f,
    0x1.6ba536p+3f, 0x1.701882p+3f, 0x1.7497cap+3f, 0x1.792328p+3f, 0x1.7dbabap+3f, 0x1.825e9ep+3f,
    0x1.870efp+3f, 0x1.8bcbccp+3f, 0x1.909554p+3f, 0x1.956ba4p+3f, 0x1.9a4edap+3f, 0x1.9f3f12p+3f,
    0x1.a43c6ep+3f, 0x1.a9471p+3f, 0x1.ae5f12p+3f, 0x1.b38496p+3f, 0x1.b8b7bep+3f, 0x1.bdf8a4p+3f,
    0x1.c3477p+3f, 0x1.c8a448p+3f, 0x1.ce0f3cp+3f, 0x1.d38874p+3f, 0x1.d91016p+3f, 0x1.dea64p+3f,
    0x1.e44b16p+3f, 0x1.e9febap+3f, 0x1.efc15p+3f, 0x1.f592fcp+3f, 0x1.fb73dep+3f, 0x1.00b20ep+4f,
    0x1.03b1eep+4f, 0x1.06b99ep+4f, 0x1.09c934p+4f, 0x1.0ce0cp+4f, 0x1.100058p+4f, 0x1.13280ap+4f,
    0x1.1657ecp+4f, 0x1.19901p+4f, 0x1.1cd08cp+4f, 0x1.20197p+4f, 0x1.236adp+4f, 0x1.26c4c4p+4f,
    0x1.2a275ap+4f, 0x1.2d92acp+4f, 0x1.3106cap+4f, 0x1.3483cap+4f, 0x1.3809cp+4f, 0x1.3b98c4p+4f,
    0x1.3f30e6p+4f, 0x1.42d24p+4f, 0x1.467ce6p+4f, 0x1.4a30f2p+4f, 0x1.4dee6ep+4f, 0x1.51b57ap+4f,
    0x1.558624p+4f, 0x1.59608cp+4f, 0x1.5d44c2p+4f, 0x1.6132dep+4f, 0x1.652afap+4f, 0x1.692d28p+4f,
    0x1.6d3984p+4f, 0x1.715024p+4f, 0x1.75712p+4f, 0x1.799c8ep+4f, 0x1.7dd288p+4f, 0x1.821328p+4f,
    0x1.865e82p+4f, 0x1.8ab4b4p+4f, 0x1.8f15d2p+4f, 0x1.9381fap+4f, 0x1.97f944p+4f, 0x1.9c7bc6p+4f,
    0x1.a109ap+4f, 0x1.a5a2e6p+4f, 0x1.aa47b8p+4f, 0x1.aef82cp+4f, 0x1.b3b46p+4f, 0x1.b87c6cp+4f,
    0x1.bd506ep+4f, 0x1.c23082p+4f, 0x1.c71cc2p+4f, 0x1.cc1548p+4f, 0x1.d11a34p+4f, 0x1.d62bacp+4f,
    0x1.db49b6p+4f, 0x1.e0747cp+4f, 0x1.e5ac1ap+4f, 0x1.eaf0acp+4f, 0x1.f04252p+4f, 0x1.f5a12ap+4f,
    0x1.fb0d5p+4f, 0x1.004372p+5f, 0x1.030702p+5f, 0x1.05d168p+5f, 0x1.08a2b4p+5f, 0x1.0b7af6p+5f,
    0x1.0e5a3cp+5f, 0x1.114096p+5f, 0x1.142e18p+5f, 0x1.1722cep+5f, 0x1.1a1ecap+5f, 0x1.1d221ep+5f,
    0x1.202cd8p+5f, 0x1.233f0cp+5f, 0x1.2658cap+5f, 0x1.297a22p+5f, 0x1.2ca326p+5f, 0x1.2fd3e8p+5f,
    0x1.330c78p+5f, 0x1.364ceap+5f, 0x1.39954ep+5f, 0x1.3ce5b8p+5f, 0x1.403e3ap+5f, 0x1.439ee6p+5f,
    0x1.4707cep+5f, 0x1.4a790cp+5f, 0x1.4df2a4p+5f, 0x1.5174b2p+5f, 0x1.54ff4ap+5f, 0x1.58927cp+5f,
    0x1.5c2e5ep+5f, 0x1.5fd302p+5f, 0x1.63807ep+5f, 0x1.6736e4p+5f, 0x1.6af64ap+5f, 0x1.6ebec4p+5f,
    0x1.729066p+5f, 0x1.766b46p+5f, 0x1.7a4f76p+5f, 0x1.7e3d1p+5f, 0x1.823424p+5f, 0x1.8634ccp+5f,
    0x1.8a3f1ap+5f, 0x1.8e5328p+5f, 0x1.927108p+5f, 0x1.9698d2p+5f, 0x1.9aca9ep+5f, 0x1.9f068p+5f,
    0x1.a34c8ep+5f, 0x1.a79ce4p+5f, 0x1.abf796p+5f, 0x1.b05cbap+5f, 0x1.b4cc6ap+5f, 0x1.b946bcp+5f,
    0x1.bdcbccp+5f, 0x1.c25baep+5f, 0x1.c6f67cp+5f, 0x1.cb9c58p+5f, 0x1.d04d48p+5f, 0x1.d5096ep+5f,
    0x1.d9d0e6p+5f, 0x1.dea3c6p+5f, 0x1.e3822ap+5f, 0x1.e86c2cp+5f, 0x1.ed61e4p+5f, 0x1.f2637p+5f,
    0x1.f770e6p+5f, 0x1.fc8a66p+5f, 0x1.00d804p+6f, 0x1.0370f4p+6f, 0x1.061012p+6f, 0x1.08b568p+6f,
    0x1.0b610ap+6f, 0x1.0e13p+6f, 0x1.10cb5ep+6f, 0x1.138a2ep+6f, 0x1.164f82p+6f, 0x1.191b64p+6f,
    0x1.1bede8p+6f, 0x1.1ec71ap+6f, 0x1.21a70ap+6f, 0x1.248dc8p+6f, 0x1.277b6p+6f, 0x1.2a6fe6p+6f,
    0x1.2d6b66p+6f, 0x1.306dfp+6f, 0x1.337796p+6f, 0x1.368866p+6f, 0x1.39a072p+6f, 0x1.3cbfcep+6f,
    0x1.3fe68p+6f, 0x1.4314ap+6f, 0x1.464a3ap+6f, 0x1.498764p+6f, 0x1.4ccc2cp+6f, 0x1.5018a2p+6f,
    0x1.536cdcp+6f, 0x1.56c8e6p+6f, 0x1.5a2cd6p+6f, 0x1.5d98bcp+6f, 0x1.610ca8p+6f, 0x1.6488bp+6f,
    0x1.680ce2p+6f, 0x1.6b9954p+6f, 0x1.6f2e16p+6f, 0x1.72cb3cp+6f, 0x1.7670d8p+6f, 0x1.7a1efep+6f,
    0x1.7dd5cp+6f, 0x1.819532p+6f, 0x1.855d68p+6f, 0x1.892e76p+6f, 0x1.8d086ep+6f, 0x1.90eb66p+6f,
    0x1.94d77p+6f, 0x1.98cca2p+6f, 0x1.9ccb1p+6f, 0x1.a0d2dp+6f, 0x1.a4e3f4p+6f, 0x1.a8fe96p+6f,
    0x1.ad22c6p+6f, 0x1.b1509cp+6f, 0x1.b5882ep+6f, 0x1.b9c99p+6f, 0x1.be14dap+6f, 0x1.c26a24p+6f,
    0x1.c6c97ep+6f, 0x1.cb3304p+6f, 0x1.cfa6cap+6f, 0x1.d424eap+6f, 0x1.d8ad7ap+6f, 0x1.dd409p+6f,
    0x1.e1de44p+6f, 0x1.e686bp+6f, 0x1.eb39eap+6f, 0x1.eff80cp+6f, 0x1.f4c12ap+6f, 0x1.f99576p+6f,
    0x1.fe74dep+6f, 0x1.01afc8p+7f, 0x1.042ad4p+7f, 0x1.06ab9ep+7f, 0x1.093232p+7f, 0x1.0bbeap+7f,
    0x1.0e50f2p+7f, 0x1.10e936p+7f, 0x1.13877ap+7f, 0x1.162bcep+7f, 0x1.18d63ap+7f, 0x1.1b86dp+7f,
    0x1.1e3d9ep+7f, 0x1.20faaep+7f, 0x1.23be12p+7f, 0x1.2687d6p+7f, 0x1.295808p+7f, 0x1.2c2ebap+7f,
    0x1.2f0bf6p+7f, 0x1.31efcep+7f, 0x1.34da4ep+7f, 0x1.37cb8ap+7f, 0x1.3ac38ap+7f, 0x1.3dc262p+7f,
    0x1.40c82p+7f, 0x1.43d4d2p+7f, 0x1.46e88cp+7f, 0x1.4a035ap+7f, 0x1.4d254cp+7f, 0x1.504e74p+7f,
    0x1.537eep+7f, 0x1.56b6a4p+7f, 0x1.59f5ccp+7f, 0x1.5d3c6ap+7f, 0x1.608a9p+7f, 0x1.63e04ep+7f,
    0x1.673db6p+7f, 0x1.6aa2d8p+7f, 0x1.6e0fc6p+7f, 0x1.71849p+7f, 0x1.75014ap+7f, 0x1.788606p+7f,
    0x1.7c12d2p+7f, 0x1.7fa7c4p+7f, 0x1.8344eep+7f, 0x1.86ea6p+7f, 0x1.8a983p+7f, 0x1.8e4e6ep+7f,
    0x1.920d3p+7f, 0x1.95d484p+7f, 0x1.99a482p+7f, 0x1.9d7d3cp+7f, 0x1.a15ec6p+7f, 0x1.a54932p+7f,
    0x1.a93c96p+7f, 0x1.ad3904p+7f, 0x1.b13e94p+7f, 0x1.b54d56p+7f, 0x1.b96562p+7f, 0x1.bd86ccp+7f,
    0x1.c1b1aap+7f, 0x1.c5e61p+7f, 0x1.ca2412p+7f, 0x1.ce6bdap+7f, 0x1.d2bd5ap+7f, 0x1.d718b6p+7f,
    0x1.db7e0cp+7f, 0x1.dfed6ap+7f, 0x1.e466ecp+7f, 0x1.e8eaa8p+7f, 0x1.ed78b2p+7f, 0x1.f21126p+7f,
    0x1.f6b418p+7f, 0x1.fb61ap+7f, 0x1.000ceap+8f, 0x1.026e6ap+8f, 0x1.04d558p+8f, 0x1.0741cp+8f,
    0x1.09b3b2p+8f, 0x1.0c2b36p+8f, 0x1.0ea85ep+8f, 0x1.112b32p+8f, 0x1.13b3cp+8f, 0x1.164216p+8f,
    0x1.18d64p+8f, 0x1.1b704cp+8f, 0x1.1e1048p+8f, 0x1.20b63ep+8f, 0x1.23624p+8f, 0x1.261458p+8f,
    0x1.28cc94p+8f, 0x1.2b8b04p+8f, 0x1.2e4fb6p+8f, 0x1.311ab6p+8f, 0x1.33ec14p+8f, 0x1.36c3dcp+8f,
    0x1.39a22p+8f, 0x1.3c86ecp+8f, 0x1.3f725p+8f, 0x1.42645ap+8f, 0x1.455d1ap+8f, 0x1.485c9ep+8f,
    0x1.4b62f6p+8f, 0x1.4e7032p+8f, 0x1.51846p+8f, 0x1.549f92p+8f, 0x1.57c1d6p+8f, 0x1.5aeb3ep+8f,
    0x1.5e1bd6p+8f, 0x1.6153b2p+8f, 0x1.6492e2p+8f, 0x1.67d976p+8f, 0x1.6b277ep+8f, 0x1.6e7d0ep+8f,
    0x1.71da32p+8f, 0x1.753fp+8f, 0x1.78ab86p+8f, 0x1.7c1fd6p+8f, 0x1.7f9c02p+8f, 0x1.83201ep+8f,
    0x1.86ac3ap+8f, 0x1.8a4068p+8f, 0x1.8ddcbcp+8f, 0x1.918146p+8f, 0x1.952e18p+8f, 0x1.98e348p+8f,
    0x1.9ca0e8p+8f, 0x1.a0671ap+8f, 0x1.a435d2p+8f, 0x1.a80d36p+8f, 0x1.abed54p+8f, 0x1.afd644p+8f,
    0x1.b3c81ap+8f, 0x1.b7c2eap+8f, 0x1.bbc6c6p+8f, 0x1.bfd3c6p+8f, 0x1.c3e9fcp+8f, 0x1.c8097ep+8f,
    0x1.cc3262p+8f, 0x1.d064bcp+8f, 0x1.d4a0a4p+8f, 0x1.d8e62cp+8f, 0x1.dd356cp+8f, 0x1.e18e7ap+8f,
    0x1.e5f16cp+8f, 0x1.ea5e58p+8f, 0x1.eed558p+8f, 0x1.f3567ep+8f, 0x1.f7e1e4p+8f, 0x1.fc77a2p+8f,
    0x1.008be8p+9f, 0x1.02e142p+9f, 0x1.053beap+9f, 0x1.079beep+9f, 0x1.0a015ap+9f, 0x1.0c6c3ap+9f,
    0x1.0edc9ap+9f, 0x1.115286p+9f, 0x1.13ce0ep+9f, 0x1.164f3ap+9f, 0x1.18d61ap+9f, 0x1.1b62bcp+9f,
    0x1.1df52ap+9f, 0x1.208d74p+9f, 0x1.232ba4p+9f, 0x1.25cfccp+9f, 0x1.2879f6p+9f, 0x1.2b2a32p+9f,
    0x1.2de08ep+9f, 0x1.309d16p+9f, 0x1.335fdap+9f, 0x1.3628e6p+9f, 0x1.38f84cp+9f, 0x1.3bce16p+9f,
    0x1.3eaa56p+9f, 0x1.418d1cp+9f, 0x1.447674p+9f, 0x1.47666ep+9f, 0x1.4a5d18p+9f, 0x1.4d5a84p+9f,
    0x1.505ecp+9f, 0x1.5369dcp+9f, 0x1.567be8p+9f, 0x1.5994f2p+9f, 0x1.5cb50ep+9f, 0x1.5fdc48p+9f,
    0x1.630ab4p+9f, 0x1.66406p+9f, 0x1.697d5ep+9f, 0x1.6cc1bep+9f, 0x1.700d92p+9f, 0x1.7360f8p+9f,
    0x1.76bbe6p+9f, 0x1.7a1e7cp+9f, 0x1.7d88ccp+9f, 0x1.80fae6p+9f, 0x1.8474dep+9f, 0x1.87f6c4p+9f,
    0x1.8b80acp+9f, 0x1.8f12a8p+9f, 0x1.92accap+9f, 0x1.964f26p+9f, 0x1.99f9dp+9f, 0x1.9dacd8p+9f,
    0x1.a16852p+9f, 0x1.a52c54p+9f, 0x1.a8f8fp+9f, 0x1.acce3ap+9f, 0x1.b0ac48p+9f, 0x1.b4932ap+9f,
    0x1.b882fap+9f, 0x1.bc7bc8p+9f, 0x1.c07daap+9f, 0x1.c488b8p+9f, 0x1.c89d02p+9f, 0x1.ccbaa4p+9f,
    0x1.d0e1aep+9f, 0x1.d51238p+9f, 0x1.d94c58p+9f, 0x1.dd9024p+9f, 0x1.e1ddb4p+9f, 0x1.e6351ep+9f,
    0x1.ea9676p+9f, 0x1.ef01d8p+9f, 0x1.f37758p+9f, 0x1.f7f70ep+9f, 0x1.fc8114p+9f, 0x1.008abep+10f,
    0x1.02da34p+10f, 0x1.052ef4p+10f, 0x1.07890cp+10f, 0x1.09e88ap+10f, 0x1.0c4d78p+10f,
    0x1.0eb7ep+10f, 0x1.1127d8p+10f, 0x1.139d64p+10f, 0x1.161896p+10f, 0x1.189978p+10f,
    0x1.1b201ap+10f, 0x1.1dac88p+10f, 0x1.203edp+10f, 0x1.22d7p+10f, 0x1.257526p+10f,
    0x1.28194ep+10f, 0x1.2ac388p+10f, 0x1.2d73e2p+10f, 0x1.302a6ap+10f, 0x1.32e72ep+10f,
    0x1.35aa4p+10f, 0x1.3873aap+10f, 0x1.3b437cp+10f, 0x1.3e19c6p+10f, 0x1.40f69ap+10f,
    0x1.43dap+10f, 0x1.46c41p+10f, 0x1.49b4ep+10f, 0x1.4cac6ap+10f, 0x1.4faacap+10f,
    0x1.52b00ep+10f, 0x1.55bc4ap+10f, 0x1.58cf8ap+10f, 0x1.5be9e2p+10f, 0x1.5f0b62p+10f,
    0x1.623418p+10f, 0x1.656418p+10f, 0x1.689b74p+10f, 0x1.6bda3ap+10f, 0x1.6f208p+10f,
    0x1.726e52p+10f, 0x1.75c3c8p+10f, 0x1.7920fp+10f, 0x1.7c85dcp+10f, 0x1.7ff2a4p+10f,
    0x1.836752p+10f, 0x1.86e3fep+10f, 0x1.8a68bap+10f, 0x1.8df59ap+10f, 0x1.918abp+10f,
    0x1.95281p+10f, 0x1.98cdccp+10f, 0x1.9c7bfcp+10f, 0x1.a032bp+10f, 0x1.a3f1fep+10f,
    0x1.a7b9fap+10f, 0x1.ab8abap+10f, 0x1.af645p+10f, 0x1.b346d4p+10f, 0x1.b7325ap+10f,
    0x1.bb26f4p+10f, 0x1.bf24cp+10f, 0x1.c32bcep+10f, 0x1.c73c32p+10f, 0x1.cb560ap+10f,
    0x1.cf7964p+10f, 0x1.d3a65cp+10f, 0x1.d7dd08p+10f, 0x1.dc1d7ep+10f, 0x1.e067d8p+10f,
    0x1.e4bc2ap+10f, 0x1.e91a9p+10f, 0x1.ed831cp+10f, 0x1.f1f5eep+10f, 0x1.f67318p+10f,
    0x1.fafab8p+10f, 0x1.ff8ce4p+10f, 0x1.0214dap+11f, 0x1.0468a4p+11f, 0x1.06c1d8p+11f,
    0x1.092088p+11f, 0x1.0b84bep+11f, 0x1.0dee88p+11f, 0x1.105df2p+11f, 0x1.12d30ep+11f,
    0x1.154de4p+11f, 0x1.17ce88p+11f, 0x1.1a5502p+11f, 0x1.1ce164p+11f, 0x1.1f73bap+11f,
    0x1.220c14p+11f, 0x1.24aa8ap+11f, 0x1.274f16p+11f, 0x1.29f9d2p+11f, 0x1.2caacap+11f,
    0x1.2f6212p+11f, 0x1.321fb4p+11f, 0x1.34e3c4p+11f, 0x1.37ae4ep+11f, 0x1.3a7f66p+11f,
    0x1.3d5716p+11f, 0x1.403572p+11f, 0x1.431a8ap+11f, 0x1.46066cp+11f, 0x1.48f92cp+11f,
    0x1.4bf2d8p+11f, 0x1.4ef382p+11f, 0x1.51fb38p+11f, 0x1.550a1p+11f, 0x1.58201ap+11f,
    0x1.5b3d66p+11f, 0x1.5e6204p+11f, 0x1.618e0ap+11f, 0x1.64c188p+11f, 0x1.67fc9p+11f,
    0x1.6b3f36p+11f, 0x1.6e898cp+11f, 0x1.71dba2p+11f, 0x1.75358ep+11f, 0x1.789762p+11f,
    0x1.7c0132p+11f, 0x1.7f7312p+11f, 0x1.82ed14p+11f, 0x1.866f4cp+11f, 0x1.89f9dp+11f,
    0x1.8d8cb4p+11f, 0x1.91280ap+11f, 0x1.94cbeap+11f, 0x1.987866p+11f, 0x1.9c2d96p+11f,
    0x1.9feb8ep+11f, 0x1.a3b264p+11f, 0x1.a7822ep+11f, 0x1.ab5bp+11f, 0x1.af3cf2p+11f,
    0x1.b3281cp+11f, 0x1.b71c9p+11f, 0x1.bb1a6ap+11f, 0x1.bf21cp+11f, 0x1.c332a6p+11f,
    0x1.c74d38p+11f, 0x1.cb718cp+11f, 0x1.cf9fbap+11f, 0x1.d3d7dap+11f, 0x1.d81a06p+11f,
    0x1.dc6656p+11f, 0x1.e0bce2p+11f, 0x1.e51dc6p+11f, 0x1.e9891ap+11f, 0x1.edfef8p+11f,
    0x1.f27f7ap+11f, 0x1.f70abcp+11f, 0x1.fba0d6p+11f, 0x1.0020f2p+12f, 0x1.027702p+12f,
    0x1.04d2bp+12f, 0x1.0733fap+12f, 0x1.099af4p+12f, 0x1.0c07aep+12f, 0x1.0e7a36p+12f,
    0x1.10f29ap+12f, 0x1.1370eap+12f, 0x1.15f534p+12f, 0x1.187f88p+12f, 0x1.1b0ff2p+12f,
    0x1.1da686p+12f, 0x1.20435p+12f, 0x1.22e65ep+12f, 0x1.258fc4p+12f, 0x1.283f9p+12f,
    0x1.2af5d2p+12f, 0x1.2db29ap+12f, 0x1.3075f8p+12f, 0x1.333ffep+12f, 0x1.3610bcp+12f,
    0x1.38e842p+12f, 0x1.3bc6a2p+12f, 0x1.3eabeep+12f, 0x1.419836p+12f, 0x1.448b8cp+12f,
    0x1.478604p+12f, 0x1.4a87acp+12f, 0x1.4d9098p+12f, 0x1.50a0dcp+12f, 0x1.53b888p+12f,
    0x1.56d7bp+12f, 0x1.59fe68p+12f, 0x1.5d2cc2p+12f, 0x1.6062dp+12f, 0x1.63a0a8p+12f,
    0x1.66e65ap+12f, 0x1.6a34p+12f, 0x1.6d89a8p+12f, 0x1.70e76cp+12f, 0x1.744d5cp+12f,
    0x1.77bb8ep+12f, 0x1.7b3218p+12f, 0x1.7eb11p+12f, 0x1.82388ap+12f, 0x1.85c89cp+12f,
    0x1.89615ap+12f, 0x1.8d02dep+12f, 0x1.90ad3cp+12f, 0x1.94608cp+12f, 0x1.981ce4p+12f,
    0x1.9be25ap+12f, 0x1.9fb108p+12f, 0x1.a38902p+12f, 0x1.a76a64p+12f, 0x1.ab5544p+12f,
    0x1.af49bap+12f, 0x1.b347dep+12f, 0x1.b74fccp+12f, 0x1.bb619ap+12f, 0x1.bf7d62p+12f,
    0x1.c3a34p+12f, 0x1.c7d34cp+12f, 0x1.cc0d9ep+12f, 0x1.d05256p+12f, 0x1.d4a19cp+12f,
    0x1.d8fb6ap+12f, 0x1.dd5fecp+12f, 0x1.e1cf3ep+12f, 0x1.e6497cp+12f, 0x1.eacec2p+12f,
    0x1.ef5f2ep+12f, 0x1.f3fadcp+12f, 0x1.f8a1e8p+12f, 0x1.fd547p+12f, 0x1.01094ap+13f,
    0x1.036e38p+13f, 0x1.05d91p+13f, 0x1.0849e4p+13f, 0x1.0ac0c2p+13f, 0x1.0d3dbap+13f,
    0x1.0fc0dep+13f, 0x1.124a3ap+13f, 0x1.14d9e2p+13f, 0x1.176fe4p+13f, 0x1.1a0c52p+13f,
    0x1.1caf3ap+13f, 0x1.1f58b2p+13f, 0x1.2208c8p+13f, 0x1.24bf8cp+13f, 0x1.277d12p+13f,
    0x1.2a416cp+13f, 0x1.2d0caap+13f, 0x1.2fdedep+13f, 0x1.32b81ep+13f, 0x1.359878p+13f,
    0x1.388p+13f, 0x1.388p+13f,
};

float pq_eotf(float x) {
  const float idx = fminf(fmaxf(x, 0.0f), 1.0f) * 1023.0f;
  const int i = (int)floorf(idx);
  const float f = idx - i;
  return kPqEotf[i] * (1.0f - f) + kPqEotf[i + 1] * f;
}

float pq_oetf(float nits) {
  const float xpow = powf(fmaxf(nits * 1e-4f, 0.0f), 0.1593017578125f);
  return powf((0.8359375f + 18.8515625f * xpow) / (1.0f + 18.6875f * xpow), 78.84375f);
}

struct Ipt {
  float I, P, T;
};
struct Ich {
  float I, C, h;
};
Ich ipt_to_ich(Ipt c) { return {c.I, sqrtf(c.P * c.P + c.T * c.T), atan2f(c.T, c.P)}; }
// polar to IPT with the hue's cosine and sine at hand (the searches below
// keep the hue)
Ipt ich_to_ipt(Ich c, float cos_h, float sin_h) { return {c.I, c.C * cos_h, c.C * sin_h}; }

void ipt_to_lms_pq(Ipt c, float& l, float& m, float& s) {
  l = c.I + 0.0975689f * c.P + 0.205226f * c.T;
  m = c.I - 0.1138760f * c.P + 0.133217f * c.T;
  s = c.I + 0.0326151f * c.P - 0.676887f * c.T;
}

Ipt rgb_to_ipt(const float rgb[3], const Mat3& m) {
  float lms[3];
  for (int r = 0; r < 3; r++)
    lms[r] = pq_oetf(m.m[r][0] * rgb[0] + m.m[r][1] * rgb[1] + m.m[r][2] * rgb[2]);
  return {0.4000f * lms[0] + 0.4000f * lms[1] + 0.2000f * lms[2],
          4.4550f * lms[0] - 4.8510f * lms[1] + 0.3960f * lms[2],
          0.8056f * lms[0] + 0.3572f * lms[1] - 1.1628f * lms[2]};
}

void ipt_to_rgb(Ipt c, const Mat3& m, float rgb[3]) {
  float lp, mp, sp;
  ipt_to_lms_pq(c, lp, mp, sp);
  const float l = pq_eotf(lp), mm = pq_eotf(mp), s = pq_eotf(sp);
  for (int r = 0; r < 3; r++) rgb[r] = m.m[r][0] * l + m.m[r][1] * mm + m.m[r][2] * s;
}

// a display: its primaries' matrices, luminance range (cd/m2) and the PQ
// levels of its ends
struct Gamut {
  Mat3 to_lms, from_lms;
  float Lb, Lw, Imin, Imax;
};

Gamut make_gamut(const Primaries& p, float Lb, float Lw) {
  Gamut g;
  g.to_lms = rgb_to_lms(p);
  g.from_lms = g.to_lms;
  mat3_invert(g.from_lms);
  g.Lb = Lb;
  g.Lw = Lw;
  g.Imin = pq_oetf(Lb);
  g.Imax = pq_oetf(Lw);
  return g;
}

bool in_gamut(Ipt c, const Gamut& g) {
  float lp, mp, sp;
  ipt_to_lms_pq(c, lp, mp, sp);
  if (lp < g.Imin || lp > g.Imax || mp < g.Imin || mp > g.Imax || sp < g.Imin || sp > g.Imax)
    return false;
  float rgb[3];
  ipt_to_rgb(c, g.from_lms, rgb);
  const float lo = g.Lb - 1e-4f, hi = g.Lw + 1e-2f;
  return rgb[0] >= lo && rgb[0] <= hi && rgb[1] >= lo && rgb[1] <= hi && rgb[2] >= lo && rgb[2] <= hi;
}

const float kMaxDelta = 5e-5f;

// the largest in-gamut chroma at intensity I and hue h, bisected in [Cmin, Cmax]
Ich desaturate_to(float I, float h, float Cmin, float Cmax, const Gamut& g) {
  if (I <= g.Imin) return {g.Imin, 0, h};
  if (I >= g.Imax) return {g.Imax, 0, h};
  const float max_di = I * kMaxDelta, cos_h = cosf(h), sin_h = sinf(h);
  Ich r = {I, (Cmin + Cmax) / 2, h};
  do {
    if (in_gamut(ich_to_ipt(r, cos_h, sin_h), g)) Cmin = r.C;
    else Cmax = r.C;
    r.C = (Cmin + Cmax) / 2;
  } while (Cmax - Cmin > max_di);
  return r;
}

// the most saturated in-gamut colour of hue h: a golden-section search over I
Ich saturate(float h, const Gamut& g) {
  const float invphi = 0.6180339887498948f, invphi2 = 0.38196601125010515f;
  Ich lo = {g.Imin, 0, h}, hi = {g.Imax, 0, h};
  float de = hi.I - lo.I;
  Ich a = desaturate_to(lo.I + invphi2 * de, h, 0.0f, 0.5f, g);
  Ich b = desaturate_to(lo.I + invphi * de, h, 0.0f, 0.5f, g);
  while (de > kMaxDelta) {
    de *= invphi;
    if (a.C > b.C) {
      hi = b;
      b = a;
      a = desaturate_to(lo.I + invphi2 * de, h, lo.C - kMaxDelta, 0.5f, g);
    } else {
      lo = a;
      a = b;
      b = desaturate_to(lo.I + invphi * de, h, hi.C - kMaxDelta, 0.5f, g);
    }
  }
  return a.C > b.C ? a : b;
}

Ich mix_exp(Ich c, float x, float gamma, float base) {
  return {base + (c.I - base) * powf(x, gamma), c.C * x, c.h};
}

// relative colorimetric: an out-of-gamut colour moved along an exponential
// curve towards the peak of hue (swscale takes it from the colour before
// the tone map) until it is inside
Ipt clip_gamma(Ipt ipt, float gamma, const Gamut& g, float hue) {
  float lo = 0.0f, hi = 1.0f, x = 0.5f;
  const float max_di = fmaxf(ipt.I * kMaxDelta, 1e-7f);
  if (ipt.I <= g.Imin) return {g.Imin, 0, 0};
  if (in_gamut(ipt, g)) return ipt;
  const Ich ich = ipt_to_ich(ipt), peak = saturate(hue, g);
  const float Irel = fmaxf((ich.I - g.Imin) / (peak.I - g.Imin), 0.0f), cos_h = cosf(ich.h),
              sin_h = sinf(ich.h);
  gamma = gamma * powf(Irel, 3) * fminf(ich.C / peak.C, 1.0f);
  do {
    if (in_gamut(ich_to_ipt(mix_exp(ich, x, gamma, peak.I), cos_h, sin_h), g)) lo = x;
    else hi = x;
    x = (lo + hi) / 2.0f;
  } while (hi - lo > max_di);
  return ich_to_ipt(mix_exp(ich, x, gamma, peak.I), cos_h, sin_h);
}

float gamut_hull(float I) { return ((I - 6.0f) * I + 9.0f) * I; }

// libavutil's EOTFs, in double: BT.1886 (its black at Lb) and its inverse,
// and HLG's (the inverse OETF, then the OOTF on BT.2020 luma)
void eotf_bt1886(double Lw, double Lb, double c[3]) {
  const double lw = pow(Lw, 1.0 / 2.4), lb = pow(Lb, 1.0 / 2.4);
  const double a = pow(lw - lb, 2.4), b = lb / (lw - lb);
  for (int i = 0; i < 3; i++) c[i] = a * pow(std::max(c[i] + b, 0.0), 2.4);
}
void eotf_bt1886_inv(double Lw, double Lb, double c[3]) {
  const double lw = pow(Lw, 1.0 / 2.4), lb = pow(Lb, 1.0 / 2.4);
  const double a = pow(lw - lb, 2.4), b = lb / (lw - lb);
  for (int i = 0; i < 3; i++) c[i] = pow(c[i] / a, 1.0 / 2.4) - b;
}
void eotf_hlg(double Lw, double Lb, double c[3]) {
  const double a = 0.17883277, b = 0.28466892, cc = 0.55991073;
  const double gamma = std::max(1.2 + 0.42 * log10(Lw / 1000.0), 1.0);
  const double beta = sqrt(3 * pow(Lb / Lw, 1 / gamma));
  for (int i = 0; i < 3; i++) {
    const double e = (1 - beta) * c[i] + beta;
    c[i] = 0.0 > e ? 0.0 : e <= 0.5 ? e * e / 3.0 : (exp((e - cc) / a) + b) / 12.0;
  }
  const double luma = 0.2627 * c[0] + 0.6780 * c[1] + 0.0593 * c[2];
  for (int i = 0; i < 3; i++) c[i] = Lw * pow(luma, gamma - 1) * c[i];
}

// The 3D LUT from a source (primaries 1 or 9, transfer BT.1886 or HLG) to
// BT.709 at BT.1886 from 203 cd/m2; nodes (b, g, r) of 16-bit R, G, B
struct ColourLut {
  static const int kSize = 65;
  std::vector<uint16_t> node;  // kSize^3 x 3

  ColourLut(bool bt2020, bool hlg) : node((size_t)kSize * kSize * kSize * 3) {
    const float src_lw = hlg ? 1000.0f : 203.0f;
    const Gamut src = make_gamut(bt2020 ? kBt2020 : kBt709, 0.0f, src_lw);
    const Gamut dst = make_gamut(kBt709, 0.0f, 203.0f);
    const float scale = src.Imax / (src.Imax - src.Imin) / (dst.Imax / (dst.Imax - dst.Imin));
    const float offset = dst.Imin - src.Imin * scale;
    // planes of B across the host's cores, whatever OMP_NUM_THREADS says:
    // each node is its own computation, so the order changes no bit
    std::atomic<int> next_plane{0};
    auto work = [&]() {
     for (int bx; (bx = next_plane++) < kSize;) {
      const float B = bx / (kSize - 1.0f);
      for (int gx = 0; gx < kSize; gx++) {
        const float G = gx / (kSize - 1.0f);
        for (int rx = 0; rx < kSize; rx++) {
          double c[3] = {rx / (kSize - 1.0f), G, B};
          if (hlg) eotf_hlg(src.Lw, src.Lb, c);
          else eotf_bt1886(src.Lw, src.Lb, c);
          const float rgb_in[3] = {(float)c[0], (float)c[1], (float)c[2]};
          Ipt ipt = rgb_to_ipt(rgb_in, src.to_lms);
          const float hue = atan2f(ipt.T, ipt.P);
          const float I = scale * ipt.I + offset;
          const float desat = fminf(ipt.I / I, gamut_hull(I) / gamut_hull(ipt.I));
          ipt = clip_gamma({I, ipt.P * desat, ipt.T * desat}, 1.80f, dst, hue);
          float rgb[3];
          ipt_to_rgb(ipt, dst.from_lms, rgb);
          for (int k = 0; k < 3; k++) c[k] = rgb[k];
          eotf_bt1886_inv(dst.Lw, dst.Lb, c);
          uint16_t* o = &node[3 * (((size_t)bx * kSize + gx) * kSize + rx)];
          for (int k = 0; k < 3; k++) {
            const float v = (float)c[k] * 65534.0f + 0.5f;
            o[k] = (uint16_t)(v < 0 ? 0 : v > 65535 ? 65535 : (int)v);
          }
        }
      }
     }
    };
    std::vector<std::thread> pool(std::max(1u, std::min(16u, std::thread::hardware_concurrency())) - 1);
    for (std::thread& t : pool) t = std::thread(work);
    work();
    for (std::thread& t : pool) t.join();
  }
};

#pragma GCC pop_options

// one LUT for each source, built once in the process
const ColourLut& colour_lut(bool bt2020, bool hlg) {
  static std::mutex lock;
  static std::unique_ptr<ColourLut> luts[2][2];
  std::lock_guard<std::mutex> hold(lock);
  std::unique_ptr<ColourLut>& l = luts[bt2020][hlg];
  if (!l) l.reset(new ColourLut(bt2020, hlg));
  return *l;
}

// tetrahedral interpolation of n RGB triples in place, 10 fraction bits
void lut_apply(const ColourLut& lut, uint16_t* rgb, size_t n) {
  const int S = ColourLut::kSize;
  const uint16_t* L = lut.node.data();
  auto at = [&](int b, int g, int r) { return L + 3 * (((size_t)b * S + g) * S + r); };
  for (size_t i = 0; i < n; i++) {
    uint16_t* c = rgb + 3 * i;
    const int rx = c[0] >> 10, gx = c[1] >> 10, bx = c[2] >> 10;
    const int rf = c[0] & 1023, gf = c[1] & 1023, bf = c[2] & 1023;
    const int rn = std::min(rx + 1, S - 1), gn = std::min(gx + 1, S - 1), bn = std::min(bx + 1, S - 1);
    const uint16_t *v0 = at(bx, gx, rx), *v1 = at(bn, gn, rn), *v2, *v3;
    int x, y, z;
    if (rf > gf) {
      if (gf > bf) { x = rf; y = gf; z = bf; v2 = at(bx, gx, rn); v3 = at(bx, gn, rn); }
      else if (rf > bf) { x = rf; y = bf; z = gf; v2 = at(bx, gx, rn); v3 = at(bn, gx, rn); }
      else { x = bf; y = rf; z = gf; v2 = at(bn, gx, rx); v3 = at(bn, gx, rn); }
    } else {
      if (bf > gf) { x = bf; y = gf; z = rf; v2 = at(bn, gx, rx); v3 = at(bn, gn, rx); }
      else if (bf > rf) { x = gf; y = bf; z = rf; v2 = at(bx, gn, rx); v3 = at(bn, gn, rx); }
      else { x = gf; y = rf; z = bf; v2 = at(bx, gn, rx); v3 = at(bx, gn, rn); }
    }
    const int a = 1024 - x, b = x - y, cc = y - z, d = z;
    for (int k = 0; k < 3; k++) c[k] = (uint16_t)((a * v0[k] + b * v2[k] + cc * v3[k] + d * v1[k]) >> 10);
  }
}

// the chroma's place by chroma_sample_loc_type (left, centre, top left,
// top, bottom left, bottom; unspecified: the centre), in 1/256 of a luma
// sample, as swscale's frame API sites it
void chroma_site(int loc, int& x, int& y) {
  static const int kLocX[6] = {0, 128, 0, 128, 0, 128}, kLocY[6] = {128, 128, 0, 0, 256, 256};
  const bool known = loc >= 0 && loc <= 5;
  x = known ? kLocX[loc] : 128;
  y = known ? kLocY[loc] : 128;
}

// Pass 1: 4:2:0 samples of bit_depth (8-10) bits -> (height, width, 3)
// 16-bit RGB, as yuv2rgba64_X with 19-bit intermediates; height >= 10
void yuv420_to_rgb48(const uint16_t* Y, int ys, const uint16_t* U, const uint16_t* V, int cs, int width,
                     int height, int bit_depth, uint16_t* out, int matrix, bool full_range, int loc) {
  const int cw = (width + 1) / 2, ch = (height + 1) / 2, up = 19 - bit_depth;
  int xpos, ypos;
  chroma_site(loc, xpos, ypos);
  const SwsFilter vf = sws_filter((((int64_t)ch << 16) + (height >> 1)) / height, ch, height, 2, 1 << 12,
                                  (ypos + 128) >> 1, ypos + 128);
  const int32_t* m = kYuvMatrices[matrix >= 0 && matrix <= 10 ? matrix : 2];
  int64_t crv = m[0], cbu = m[1], cgu = -(int64_t)m[2], cgv = -(int64_t)m[3], cy = 1 << 16, oy = 0;
  if (!full_range) {
    cy = cy * 255 / 219;
    oy = 16 << 16;
  } else {
    crv = crv * 224 / 255;
    cbu = cbu * 224 / 255;
    cgu = cgu * 224 / 255;
    cgv = cgv * 224 / 255;
  }
  const int yc = round16(cy * (1 << 13)), yoff = round16(oy * (1 << 9)), vr = round16(crv * (1 << 13)),
            ub = round16(cbu * (1 << 13)), ug = round16(cgu * (1 << 13)), vg = round16(cgv * (1 << 13));
  auto clip16 = [](int v) { return (uint16_t)(v < 0 ? 0 : v > 65535 ? 65535 : v); };
#pragma omp parallel for schedule(static)
  for (int y = 0; y < height; y++) {
    const int* vc = &vf.coeff[(size_t)y * vf.size];
    const uint16_t* yr = Y + (size_t)y * ys;
    uint16_t* o = out + (size_t)y * width * 3;
    for (int i = 0; i < cw; i++) {
      int u = -(128 << 23), v = -(128 << 23);
      for (int j = 0; j < vf.size; j++) {
        const size_t r = (size_t)std::min(vf.pos[y] + j, ch - 1) * cs + i;
        u += (int)((unsigned)(U[r] << up) * (unsigned)vc[j]);
        v += (int)((unsigned)(V[r] << up) * (unsigned)vc[j]);
      }
      u >>= 14;
      v >>= 14;
      const int R = v * vr, G = v * vg + u * ug, B = u * ub;
      for (int k = 0; k < 2 && 2 * i + k < width; k++) {
        const unsigned acc = -0x40000000u + ((unsigned)yr[2 * i + k] << up) * 4096u;
        const int l = ((((int)acc >> 14) + 0x10000) - yoff) * yc + (1 << 13) - (1 << 29);
        uint16_t* p = o + 3 * (2 * i + k);
        p[0] = clip16(((R + l) >> 14) + (1 << 15));
        p[1] = clip16(((G + l) >> 14) + (1 << 15));
        p[2] = clip16(((B + l) >> 14) + (1 << 15));
      }
    }
  }
}

// Pass 3: (height, width, 3) 16-bit RGB -> BGR24, chroma re-sited from loc
// to the centre; height >= 10
void rgb48_to_bgr(const uint16_t* rgb, int width, int height, uint8_t* out, int matrix, int loc) {
  const int S = 15;  // RGB2YUV_SHIFT; swscale's BT.601 table for ff_yuv2rgb_coeffs[SWS_CS_DEFAULT]
  const int ry = (int)(0.299 * 219 / 255 * (1 << S) + 0.5), gy = (int)(0.587 * 219 / 255 * (1 << S) + 0.5),
            by = (int)(0.114 * 219 / 255 * (1 << S) + 0.5), ru = -(int)(0.169 * 224 / 255 * (1 << S) + 0.5),
            gu = -(int)(0.331 * 224 / 255 * (1 << S) + 0.5), bu = (int)(0.500 * 224 / 255 * (1 << S) + 0.5),
            rv = (int)(0.500 * 224 / 255 * (1 << S) + 0.5), gv = -(int)(0.419 * 224 / 255 * (1 << S) + 0.5),
            bv = -(int)(0.081 * 224 / 255 * (1 << S) + 0.5);
  int xpos, ypos;
  chroma_site(loc, xpos, ypos);
  const SwsFilter hf = sws_filter(0x10000, width, width, 4, 1 << 14, xpos + 128, 128);
  const SwsFilter vf = sws_filter(0x10000, height, height, 2, 1 << 12, ypos + 128, 128);
  const SwsFilter lf = sws_filter(0x10000, height, height, 2, 1 << 12, 128, 128);
  // rgb64ToY / rgb64ToUV, then scaled across into 15 bits
  std::vector<int16_t> y15((size_t)width * height), u15((size_t)width * height), v15((size_t)width * height);
#pragma omp parallel for schedule(static)
  for (int r = 0; r < height; r++) {
    std::vector<int> u16(width), v16(width);
    const uint16_t* p = rgb + (size_t)r * width * 3;
    for (int x = 0; x < width; x++) {
      const unsigned R = p[3 * x], G = p[3 * x + 1], B = p[3 * x + 2];
      const unsigned yv = (uint16_t)((ry * R + gy * G + by * B + (0x2001u << (S - 1))) >> S);
      y15[(size_t)r * width + x] = (int16_t)std::min((int)(yv * 16384) >> 15, 32767);
      u16[x] = (uint16_t)((ru * R + gu * G + bu * B + (0x10001u << (S - 1))) >> S);
      v16[x] = (uint16_t)((rv * R + gv * G + bv * B + (0x10001u << (S - 1))) >> S);
    }
    for (int x = 0; x < width; x++) {
      int su = 0, sv = 0;
      for (int j = 0; j < hf.size; j++) {
        const int a = std::min(hf.pos[x] + j, width - 1), c = hf.coeff[(size_t)x * hf.size + j];
        su += u16[a] * c;
        sv += v16[a] * c;
      }
      u15[(size_t)r * width + x] = (int16_t)std::min(su >> 15, 32767);
      v15[(size_t)r * width + x] = (int16_t)std::min(sv >> 15, 32767);
    }
  }
  // yuv2rgb_full_X (its _2 where both vertical filters are two taps gives
  // the same integers: those filters are whole taps here)
  const int32_t* m = kYuvMatrices[matrix >= 0 && matrix <= 10 ? matrix : 2];
  const int64_t cy = (1 << 16) * 255 / 219, oy = 16 << 16;
  const int yc = round16(cy * (1 << 13)), yoff = round16(oy * (1 << 9)), vr = round16((int64_t)m[0] * (1 << 13)),
            ub = round16((int64_t)m[1] * (1 << 13)), ug = round16(-(int64_t)m[2] * (1 << 13)),
            vg = round16(-(int64_t)m[3] * (1 << 13));
  auto clip30 = [](int v) { return (v & ~((1 << 30) - 1)) ? (~v >> 31) & ((1 << 30) - 1) : v; };
#pragma omp parallel for schedule(static)
  for (int y = 0; y < height; y++) {
    uint8_t* o = out + (size_t)y * width * 3;
    const int* vc = &vf.coeff[(size_t)y * vf.size];
    const int* lc = &lf.coeff[(size_t)y * lf.size];
    for (int x = 0; x < width; x++) {
      int Yv = 1 << 9, Uv = (1 << 9) - (128 << 19), Vv = Uv;
      for (int j = 0; j < lf.size; j++) Yv += y15[(size_t)(lf.pos[y] + j) * width + x] * lc[j];
      for (int j = 0; j < vf.size; j++) {
        Uv += u15[(size_t)(vf.pos[y] + j) * width + x] * vc[j];
        Vv += v15[(size_t)(vf.pos[y] + j) * width + x] * vc[j];
      }
      Yv >>= 10;
      Uv >>= 10;
      Vv >>= 10;
      const unsigned l = (unsigned)((Yv - yoff) * yc + (1 << 21));
      int R = (int)(l + (unsigned)Vv * (unsigned)vr);
      int G = (int)(l + (unsigned)Vv * (unsigned)vg + (unsigned)Uv * (unsigned)ug);
      int B = (int)(l + (unsigned)Uv * (unsigned)ub);
      if ((R | G | B) & 0xC0000000) {
        R = clip30(R);
        G = clip30(G);
        B = clip30(B);
      }
      o[3 * x] = (uint8_t)(B >> 22);
      o[3 * x + 1] = (uint8_t)(G >> 22);
      o[3 * x + 2] = (uint8_t)(R >> 22);
    }
  }
}

// the three passes: 4:2:0 at 8-10 bits through the LUT into BGR24
void yuv420_managed_to_bgr(const uint16_t* Y, int ys, const uint16_t* U, const uint16_t* V, int cs,
                           int width, int height, int bit_depth, uint8_t* out, int matrix,
                           bool full_range, int loc, const ColourLut& lut) {
  std::vector<uint16_t> rgb((size_t)width * height * 3);
  yuv420_to_rgb48(Y, ys, U, V, cs, width, height, bit_depth, rgb.data(), matrix, full_range, loc);
  const size_t rows = 64;
#pragma omp parallel for schedule(static)
  for (int r = 0; r < height; r += (int)rows)
    lut_apply(lut, rgb.data() + (size_t)r * width * 3, (size_t)width * std::min<size_t>(rows, height - r));
  rgb48_to_bgr(rgb.data(), width, height, out, matrix, loc);
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
