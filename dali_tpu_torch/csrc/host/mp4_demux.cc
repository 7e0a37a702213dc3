// ISO base media file format (ISO/IEC 14496-12) demuxer for the host video
// stack: the sample table of the first video track, in any box order (an
// encoder may write ``mdat`` before ``moov``), with the stream values the
// frame-accurate reader needs — the average frame rate, the frame count and
// the start time — derived as libavformat's mov demuxer derives them (fps =
// timescale * samples / sum of stts durations; frames = the stts count).
//
// Only MPEG-4 Part 2 video (``mp4v``, object type 0x20) is decoded; other
// codecs in MP4 and containers other than MP4 and AVI (avi_demux.cc) are
// reported as unsupported, naming them (ROADMAP item 8b).

#include <unistd.h>

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <string>

#include "video.h"

namespace video {
namespace {

struct Reader {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;
  bool bad = false;
  Reader(const uint8_t* p_, size_t n_) : p(p_), n(n_) {}
  bool has(size_t k) const { return !bad && pos + k <= n; }
  uint32_t u8() {
    if (!has(1)) { bad = true; return 0; }
    return p[pos++];
  }
  uint32_t u16() { uint32_t a = u8(); return (a << 8) | u8(); }
  uint32_t u32() { uint32_t a = u16(); return (a << 16) | u16(); }
  uint64_t u64() { uint64_t a = u32(); return (a << 32) | u32(); }
  void skip(size_t k) {
    if (!has(k)) { bad = true; pos = n; return; }
    pos += k;
  }
};

struct Box {
  uint32_t type;
  size_t body;  // offset of the body
  size_t end;   // offset just past the box
};

constexpr uint32_t fourcc(const char* s) {
  return (uint32_t(uint8_t(s[0])) << 24) | (uint32_t(uint8_t(s[1])) << 16) |
         (uint32_t(uint8_t(s[2])) << 8) | uint32_t(uint8_t(s[3]));
}

// Reads the box header at ``r.pos`` within [.., end); false at the end or
// on a header that does not fit.
bool next_box(Reader& r, size_t end, Box* b) {
  if (r.pos + 8 > end) return false;
  size_t start = r.pos;
  uint64_t size = r.u32();
  b->type = r.u32();
  if (size == 1) {
    if (r.pos + 8 > end) return false;
    size = r.u64();
  } else if (size == 0) {
    size = end - start;
  }
  if (size < r.pos - start || size > end - start) return false;
  b->body = r.pos;
  b->end = start + size;
  return true;
}

struct TrackBoxes {
  bool video = false;
  int64_t timescale = 0, duration = 0;
  uint32_t codec = 0;
  int oti = -1;  // esds objectTypeIndication
  std::vector<uint8_t> config;
  std::vector<std::pair<uint32_t, int32_t>> stts, ctts;
  std::vector<uint32_t> stss;
  bool has_stss = false;
  struct Stsc { uint32_t first, per_chunk; };
  std::vector<Stsc> stsc;
  uint32_t uniform_size = 0, sample_count = 0;
  std::vector<uint32_t> sizes;
  std::vector<uint64_t> chunks;
  bool stz2 = false;
  std::vector<std::pair<int64_t, int64_t>> edits;  // (segment duration, media time)
};

// Expandable descriptor length of ISO/IEC 14496-1.
uint32_t desc_len(Reader& r) {
  uint32_t len = 0;
  for (int i = 0; i < 4; i++) {
    uint32_t c = r.u8();
    len = (len << 7) | (c & 0x7f);
    if (!(c & 0x80)) break;
  }
  return len;
}

void parse_esds(Reader r, size_t end, TrackBoxes* t) {
  r.skip(4);  // version, flags
  while (r.has(2) && r.pos < end) {
    uint32_t tag = r.u8();
    uint32_t len = desc_len(r);
    size_t body = r.pos;
    if (tag == 0x03) {  // ES_Descriptor: descend into it
      r.skip(2);
      uint32_t flags = r.u8();
      if (flags & 0x80) r.skip(2);
      if (flags & 0x40) r.skip(r.u8());
      if (flags & 0x20) r.skip(2);
      continue;
    }
    if (tag == 0x04) {  // DecoderConfigDescriptor: its DecSpecificInfo follows inside
      t->oti = int(r.u8());
      r.skip(12);
      continue;
    }
    if (tag == 0x05) {
      if (body + len <= end && body + len <= r.n)
        t->config.assign(r.p + body, r.p + body + len);
      return;
    }
    r.pos = body;
    r.skip(len);
  }
}

void parse_stbl(Reader& r, size_t end, TrackBoxes* t) {
  Box b;
  while (next_box(r, end, &b)) {
    Reader q(r.p, b.end);
    q.pos = b.body;
    switch (b.type) {
      case fourcc("stsd"): {
        q.skip(4);
        uint32_t count = q.u32();
        Box e;
        if (count >= 1 && next_box(q, b.end, &e)) {
          t->codec = e.type;
          Reader v(r.p, e.end);
          v.pos = e.body;
          // reserved, data_reference_index, predefined, width, height,
          // resolutions, frame_count, compressor, depth, predefined
          v.skip(78);
          Box c;
          while (!v.bad && next_box(v, e.end, &c)) {
            if (c.type == fourcc("esds")) {
              Reader d(r.p, c.end);
              d.pos = c.body;
              parse_esds(d, c.end, t);
            }
            v.pos = c.end;
          }
        }
        break;
      }
      case fourcc("stts"): {
        q.skip(4);
        uint32_t n = q.u32();
        for (uint32_t i = 0; i < n && q.has(8); i++) {
          uint32_t c = q.u32();
          t->stts.push_back({c, int32_t(q.u32())});
        }
        break;
      }
      case fourcc("ctts"): {
        q.skip(4);
        uint32_t n = q.u32();
        for (uint32_t i = 0; i < n && q.has(8); i++) {
          uint32_t c = q.u32();
          t->ctts.push_back({c, int32_t(q.u32())});
        }
        break;
      }
      case fourcc("stss"): {
        q.skip(4);
        uint32_t n = q.u32();
        t->has_stss = true;
        for (uint32_t i = 0; i < n && q.has(4); i++) t->stss.push_back(q.u32());
        break;
      }
      case fourcc("stsc"): {
        q.skip(4);
        uint32_t n = q.u32();
        for (uint32_t i = 0; i < n && q.has(12); i++) {
          uint32_t first = q.u32(), per = q.u32();
          q.u32();
          t->stsc.push_back({first, per});
        }
        break;
      }
      case fourcc("stsz"): {
        q.skip(4);
        t->uniform_size = q.u32();
        t->sample_count = q.u32();
        if (!t->uniform_size)
          for (uint32_t i = 0; i < t->sample_count && q.has(4); i++) t->sizes.push_back(q.u32());
        break;
      }
      case fourcc("stz2"):
        t->stz2 = true;
        break;
      case fourcc("stco"): {
        q.skip(4);
        uint32_t n = q.u32();
        for (uint32_t i = 0; i < n && q.has(4); i++) t->chunks.push_back(q.u32());
        break;
      }
      case fourcc("co64"): {
        q.skip(4);
        uint32_t n = q.u32();
        for (uint32_t i = 0; i < n && q.has(8); i++) t->chunks.push_back(q.u64());
        break;
      }
      default:
        break;
    }
    r.pos = b.end;
  }
}

void parse_container(Reader& r, size_t end, TrackBoxes* t);

void parse_trak_box(Reader& r, const Box& b, TrackBoxes* t) {
  Reader q(r.p, b.end);
  q.pos = b.body;
  switch (b.type) {
    case fourcc("mdia"):
    case fourcc("minf"):
    case fourcc("edts"):
      parse_container(q, b.end, t);
      break;
    case fourcc("stbl"):
      parse_stbl(q, b.end, t);
      break;
    case fourcc("mdhd"): {
      uint32_t version = q.u8();
      q.skip(3);
      if (version == 1) {
        q.skip(16);
        t->timescale = q.u32();
        t->duration = int64_t(q.u64());
      } else {
        q.skip(8);
        t->timescale = q.u32();
        t->duration = q.u32();
      }
      break;
    }
    case fourcc("hdlr"):
      q.skip(8);
      t->video = q.u32() == fourcc("vide");
      break;
    case fourcc("elst"): {
      uint32_t version = q.u8();
      q.skip(3);
      uint32_t n = q.u32();
      for (uint32_t i = 0; i < n && q.has(version == 1 ? 20 : 12); i++) {
        int64_t dur = version == 1 ? int64_t(q.u64()) : int64_t(q.u32());
        int64_t mt = version == 1 ? int64_t(q.u64()) : int64_t(int32_t(q.u32()));
        q.skip(4);  // media rate
        t->edits.push_back({dur, mt});
      }
      break;
    }
    default:
      break;
  }
}

void parse_container(Reader& r, size_t end, TrackBoxes* t) {
  Box b;
  while (next_box(r, end, &b)) {
    parse_trak_box(r, b, t);
    r.pos = b.end;
  }
}

const char* codec_name(uint32_t c) {
  switch (c) {
    case fourcc("avc1"): case fourcc("avc3"): return "H.264";
    case fourcc("hvc1"): case fourcc("hev1"): return "HEVC";
    case fourcc("av01"): return "AV1";
    case fourcc("vp08"): return "VP8";
    case fourcc("vp09"): return "VP9";
    case fourcc("jpeg"): case fourcc("mjpa"): case fourcc("mjpb"): return "Motion JPEG";
    case fourcc("s263"): case fourcc("h263"): return "H.263";
    default: return nullptr;
  }
}

// Recognises a container other than ISO BMFF that libavformat opens.
const char* other_container(const uint8_t* d, size_t n) {
  if (n >= 4 && d[0] == 0 && d[1] == 0 && d[2] == 1 && (d[3] == 0xb0 || d[3] <= 0x2f))
    return "raw MPEG-4 Part 2 elementary stream";
  if (n >= 3 && !memcmp(d, "FLV", 3)) return "FLV";
  if (n >= 4 && !memcmp(d, "OggS", 4)) return "Ogg";
  return nullptr;
}

// What the top-level boxes of a file give: whether it is ISO BMFF at all,
// and the tracks of its ``moov`` boxes.
struct TopLevel {
  bool iso = false, moov = false;
  int64_t movie_timescale = 0;
  std::vector<TrackBoxes> traks;
};

bool is_iso_box(uint32_t type) {
  return type == fourcc("ftyp") || type == fourcc("mdat") || type == fourcc("free") ||
         type == fourcc("skip") || type == fourcc("wide") || type == fourcc("moov");
}

// Parses the ``moov`` box ``b``, whose offsets index ``data``.
void parse_moov(const uint8_t* data, const Box& b, TopLevel* top) {
  top->moov = true;
  Reader q(data, b.end);
  q.pos = b.body;
  Box t;
  while (next_box(q, b.end, &t)) {
    if (t.type == fourcc("mvhd")) {
      Reader m(data, t.end);
      m.pos = t.body;
      uint32_t version = m.u8();
      m.skip(3 + (version == 1 ? 16 : 8));
      top->movie_timescale = m.u32();
    }
    if (t.type == fourcc("trak")) {
      TrackBoxes tb;
      Reader s(data, t.end);
      s.pos = t.body;
      parse_container(s, t.end, &tb);
      top->traks.push_back(std::move(tb));
    }
    q.pos = t.end;
  }
}

// The track of a parsed file; ``head`` holds the file's first bytes (to
// name another container), ``file_size`` bounds the sample count.
int finish(const TopLevel& top, const uint8_t* head, size_t head_n, uint64_t file_size,
           Track* track, std::string* msg) {
  const bool iso = top.iso, moov = top.moov;
  const int64_t movie_timescale = top.movie_timescale;
  const std::vector<TrackBoxes>& traks = top.traks;
  if (!iso) {
    const char* other = other_container(head, head_n);
    if (other) {
      *msg = std::string(other) +
             " input: the port reads MP4 (ISO BMFF), AVI, Matroska, MPEG-PS, MPEG-TS and "
                           "MPEG-1/2 elementary streams, ROADMAP.md Queue 1 item 8b";
      return kUnsupported;
    }
    *msg = "not a video file";
    return kInvalid;
  }
  if (!moov) {
    *msg = "moov box not found";
    return kInvalid;
  }
  const TrackBoxes* v = nullptr;
  for (const auto& t : traks)
    if (t.video) { v = &t; break; }
  if (!v) {
    *msg = "no video track";
    return kInvalid;
  }
  if (v->codec != fourcc("mp4v") || (v->oti >= 0 && v->oti != 0x20)) {
    const char* name = codec_name(v->codec);
    std::string what;
    if (name) what = name;
    else if (v->codec == fourcc("mp4v")) what = "MPEG-4 object type " + std::to_string(v->oti);
    else {
      char cc[5] = {char(v->codec >> 24), char(v->codec >> 16), char(v->codec >> 8),
                    char(v->codec), 0};
      what = std::string("'") + cc + "'";
    }
    *msg = what + " video in MP4: the port decodes MPEG-4 Part 2 only, ROADMAP.md Queue 1 item 8b";
    return kUnsupported;
  }
  if (v->stz2) {
    *msg = "compact sample sizes (stz2): ROADMAP.md Queue 1 item 8b";
    return kUnsupported;
  }
  // every sample holds a byte at least: a larger count is damage
  if (v->timescale <= 0 || v->chunks.empty() || v->stsc.empty() || v->sample_count == 0 ||
      v->sample_count > file_size) {
    *msg = "empty or damaged sample table";
    return kInvalid;
  }
  // sample offsets and sizes from the chunk map
  std::vector<Sample>& out = track->samples;
  out.clear();
  uint32_t si = 0;
  for (size_t c = 0; c < v->chunks.size() && si < v->sample_count; c++) {
    uint32_t chunk_no = uint32_t(c + 1);
    uint32_t per = 0;
    for (const auto& e : v->stsc)
      if (e.first <= chunk_no) per = e.per_chunk;
    int64_t off = int64_t(v->chunks[c]);
    for (uint32_t k = 0; k < per && si < v->sample_count; k++, si++) {
      int64_t size = v->uniform_size ? v->uniform_size
                                     : (si < v->sizes.size() ? v->sizes[si] : 0);
      out.push_back({off, size, 0, 0, !v->has_stss, false});
      off += size;
    }
  }
  // timestamps
  int64_t dts = 0, dur_sum = 0, count_sum = 0;
  size_t s = 0;
  for (const auto& e : v->stts) {
    for (uint32_t k = 0; k < e.first && s < out.size(); k++, s++) {
      out[s].dts = dts;
      dts += e.second;
    }
    dur_sum += int64_t(e.first) * e.second;
    count_sum += e.first;
  }
  for (; s < out.size(); s++) out[s].dts = dts;
  s = 0;
  for (const auto& e : v->ctts)
    for (uint32_t k = 0; k < e.first && s < out.size(); k++, s++) out[s].pts = e.second;
  for (auto& smp : out) smp.pts += smp.dts;
  for (uint32_t k : v->stss)
    if (k >= 1 && k <= out.size()) out[k - 1].key = true;
  // one edit that starts the presentation at media time M shifts the
  // timeline by -M, and the samples from its end on are decoded but not
  // shown; other edit lists are item 8b
  int64_t shift = 0, edit_end = INT64_MAX;
  if (v->edits.size() > 1 || (v->edits.size() == 1 && v->edits[0].second < 0)) {
    *msg = "edit lists other than one media segment: ROADMAP.md Queue 1 item 8b";
    return kUnsupported;
  }
  if (v->edits.size() == 1) {
    shift = v->edits[0].second;
    if (movie_timescale > 0 && v->edits[0].first > 0) {
      // av_rescale: to the media timescale, rounded to nearest
      __int128 num = (__int128)v->edits[0].first * v->timescale;
      edit_end = int64_t((num + movie_timescale / 2) / movie_timescale);
    }
  }
  for (auto& smp : out) {
    smp.discard = smp.pts - shift >= edit_end;
    smp.pts -= shift;
    smp.dts -= shift;
    if (smp.pts < 0) {
      *msg = "an edit list that drops leading samples: ROADMAP.md Queue 1 item 8b";
      return kUnsupported;
    }
  }
  track->timescale = v->timescale;
  track->duration = v->duration;
  track->nb_frames = count_sum;
  track->start_time = out.empty() ? 0 : out[0].pts;
  track->fps = (dur_sum > 0 && count_sum > 0)
                   ? double(v->timescale) * double(count_sum) / double(dur_sum)
                   : 0.0;
  track->config = v->config;
  return kOk;
}

}  // namespace

int demux_mp4(const uint8_t* data, size_t n, Track* track, std::string* msg) {
  Reader r(data, n);
  Box b;
  TopLevel top;
  while (next_box(r, n, &b)) {
    if (is_iso_box(b.type)) top.iso = true;
    if (b.type == fourcc("moov")) parse_moov(data, b, &top);
    r.pos = b.end;
  }
  return finish(top, data, n, n, track, msg);
}

bool read_at(int fd, uint64_t pos, uint8_t* dst, size_t k) {
  size_t done = 0;
  while (done < k) {
    ssize_t r = pread(fd, dst + done, k - done, off_t(pos + done));
    if (r < 0 && errno == EINTR) continue;
    if (r <= 0) return false;
    done += size_t(r);
  }
  return true;
}

int demux_mp4_fd(int fd, uint64_t size, Track* track, std::string* msg) {
  uint8_t head[512];
  const size_t head_n = size_t(size < sizeof(head) ? size : sizeof(head));
  if (!read_at(fd, 0, head, head_n)) {
    *msg = "cannot read the file";
    return kInvalid;
  }
  // the top-level box headers, as ``next_box`` reads them; only ``moov``
  // is read whole
  TopLevel top;
  std::vector<uint8_t> moov;
  uint64_t pos = 0;
  while (pos + 8 <= size) {
    uint8_t h[16];
    if (!read_at(fd, pos, h, 8)) break;
    uint64_t box = (uint64_t(h[0]) << 24) | (uint64_t(h[1]) << 16) | (uint64_t(h[2]) << 8) | h[3];
    uint32_t type = (uint32_t(h[4]) << 24) | (uint32_t(h[5]) << 16) | (uint32_t(h[6]) << 8) | h[7];
    uint64_t header = 8;
    if (box == 1) {
      if (pos + 16 > size || !read_at(fd, pos + 8, h + 8, 8)) break;
      box = 0;
      for (int i = 8; i < 16; i++) box = (box << 8) | h[i];
      header = 16;
    } else if (box == 0) {
      box = size - pos;
    }
    if (box < header || box > size - pos) break;
    if (is_iso_box(type)) top.iso = true;
    if (type == fourcc("moov")) {
      moov.resize(size_t(box));
      if (!read_at(fd, pos, moov.data(), moov.size())) break;
      parse_moov(moov.data(), Box{type, size_t(header), size_t(box)}, &top);
    }
    pos += box;
  }
  return finish(top, head, head_n, size, track, msg);
}

bool is_mp4(const uint8_t* head, size_t n) {
  return n >= 8 && is_iso_box(fourcc(reinterpret_cast<const char*>(head + 4)));
}

}  // namespace video
