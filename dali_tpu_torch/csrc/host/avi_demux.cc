// AVI (RIFF) demuxer for the host video stack: the packets of the first
// video stream, with the stream values the frame-accurate reader needs, as
// libavformat 5.1's avi demuxer (avidec.c) gives them:
//   * the stream headers of ``hdrl``: ``strh`` (dwScale, dwRate, dwStart,
//     dwLength) and ``strf`` (a BITMAPINFOHEADER: the frame size, the
//     compression FourCC, which is the codec tag, and the bytes after it,
//     which are the extradata); scale or rate 0 take avih's frame period,
//     else 1/25 s;
//   * fps = dwRate / dwScale (avg_frame_rate), the frame count dwLength;
//   * the packets in file order, as its reader walks ``movi``: ``##dc`` /
//     ``##db`` chunks of the stream, into ``LIST rec`` groupings and on into
//     the ``RIFF AVIX`` extensions of an OpenDML file, skipping ``JUNK``,
//     ``ix##`` / ``##ix`` and other streams' chunks; a zero-size chunk is
//     no packet but takes its frame slot;
//   * the keyframe flags of its index: OpenDML (``indx`` super index and
//     its ``ix##`` standard indexes) when the stream has one, else ``idx1``
//     (AVIIF_KEYFRAME) with its offsets taken relative to ``movi`` or
//     absolute by avidec's guess (the first entry against the first
//     packet); without an index every packet is a keyframe.
// The samples stay on disk: only the headers, the indexes and the chunk
// headers of ``movi`` are read.

#include <algorithm>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include "video.h"

namespace video {
namespace {

struct Src {
  const uint8_t* mem;
  int fd;
  uint64_t size;
  bool read(uint64_t pos, uint8_t* dst, size_t k) const {
    if (pos > size || k > size - pos) return false;
    if (mem) {
      memcpy(dst, mem + pos, k);
      return true;
    }
    return read_at(fd, pos, dst, k);
  }
};

inline uint32_t rl32(const uint8_t* p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) | (uint32_t(p[3]) << 24);
}
inline uint16_t rl16(const uint8_t* p) { return uint16_t(p[0] | (p[1] << 8)); }
inline uint64_t rl64(const uint8_t* p) { return uint64_t(rl32(p)) | (uint64_t(rl32(p + 4)) << 32); }

// avidec's get_stream_idx: two decimal digits, else 100
int stream_idx(uint32_t t) {
  int a = int(t & 0xff), b = int((t >> 8) & 0xff);
  if (a >= '0' && a <= '9' && b >= '0' && b <= '9') return (a - '0') * 10 + (b - '0');
  return 100;
}

struct Header {
  int nb_streams = 0;
  int video = -1;  // stream number of the first video stream
  uint32_t frame_period = 0;
  uint32_t scale = 0, rate = 0, start = 0, length = 0;
  uint32_t codec_tag = 0;
  int32_t width = 0, height = 0;
  int bits = 0;
  std::vector<uint8_t> extradata;
  uint64_t indx_pos = 0;  // the video stream's OpenDML super index
  uint64_t movi_list = 0, movi_end = 0;  // offset of the 'movi' fourcc, end of its LIST
};

bool parse_strl(const Src& src, uint64_t pos, uint64_t end, Header* h) {
  int stream = -1;
  bool is_video = false;
  uint8_t b[64];
  while (pos + 8 <= end) {
    if (!src.read(pos, b, 8)) return false;
    uint32_t t = rl32(b), size = rl32(b + 4);
    uint64_t body = pos + 8;
    uint64_t next = body + uint64_t(size) + (size & 1);
    if (t == riff_fourcc("strh")) {
      stream = h->nb_streams++;
      if (size >= 36 && src.read(body, b, 36)) {
        is_video = rl32(b) == riff_fourcc("vids") && h->video < 0;
        if (is_video) {
          h->video = stream;
          h->scale = rl32(b + 20);
          h->rate = rl32(b + 24);
          h->start = rl32(b + 28);
          h->length = rl32(b + 32);
        }
      }
    } else if (t == riff_fourcc("strf") && is_video && stream == h->video) {
      if (size >= 20 && src.read(body, b, 20)) {
        h->width = int32_t(rl32(b + 4));
        h->height = int32_t(rl32(b + 8));
        h->codec_tag = rl32(b + 16);
        h->bits = b[14] | (b[15] << 8);
      }
      if (size > 40 && body + size <= src.size) {
        h->extradata.resize(size - 40);
        if (!src.read(body + 40, h->extradata.data(), h->extradata.size())) h->extradata.clear();
      }
    } else if (t == riff_fourcc("indx") && is_video && stream == h->video) {
      h->indx_pos = body;
    }
    pos = next;
  }
  return true;
}

bool parse_header(const Src& src, Header* h, std::string* msg) {
  uint8_t b[12];
  if (!src.read(0, b, 12) || rl32(b) != riff_fourcc("RIFF") ||
      rl32(b + 8) != riff_fourcc("AVI ")) {
    *msg = "not an AVI file";
    return false;
  }
  uint64_t riff_end = std::min<uint64_t>(8 + uint64_t(rl32(b + 4)), src.size);
  uint64_t pos = 12;
  while (pos + 8 <= riff_end) {
    if (!src.read(pos, b, 12)) break;
    uint32_t t = rl32(b), size = rl32(b + 4);
    uint64_t body = pos + 8;
    uint64_t next = body + uint64_t(size) + (size & 1);
    if (t == riff_fourcc("LIST") && size >= 4) {
      uint32_t list = rl32(b + 8);
      if (list == riff_fourcc("movi")) {
        h->movi_list = body;
        h->movi_end = std::min<uint64_t>(next, src.size);
        return true;
      }
      if (list == riff_fourcc("hdrl")) {
        // avih, then one LIST strl a stream
        uint64_t p = body + 4, e = std::min<uint64_t>(body + size, src.size);
        while (p + 8 <= e) {
          uint8_t c[12];
          if (!src.read(p, c, 8)) break;
          uint32_t ct = rl32(c), cs = rl32(c + 4);
          if (ct == riff_fourcc("avih") && cs >= 4 && src.read(p + 8, c, 4))
            h->frame_period = rl32(c);
          if (ct == riff_fourcc("LIST") && cs >= 4 && src.read(p + 8, c + 8, 4) &&
              rl32(c + 8) == riff_fourcc("strl"))
            parse_strl(src, p + 12, std::min<uint64_t>(p + 8 + cs, e), h);
          p += 8 + uint64_t(cs) + (cs & 1);
        }
      }
    }
    pos = next;
  }
  *msg = "AVI without a movi list";
  return false;
}

// The keyframe flag of each indexed chunk, by the offset of its header.
using KeyMap = std::unordered_map<uint64_t, bool>;

// avidec's read_odml_index: a super index (type 0) of standard indexes
// (type 1, entries of offset to the chunk's data and size, bit 31 set for
// a frame that is not a keyframe).
bool read_odml(const Src& src, uint64_t pos, int depth, KeyMap* keys) {
  uint8_t b[24];
  if (depth > 4 || !src.read(pos, b, 24)) return false;
  int longs = rl16(b), sub = b[2], type = b[3];
  uint32_t n = rl32(b + 4);
  uint64_t base = rl64(b + 12);
  if (sub || type > 1 || (type && longs != 2)) return false;
  if (base >= src.size && type) {
    if (base >> 32 == (base & 0xffffffffu) && (base & 0xffffffffu) < src.size &&
        src.size <= 0xffffffffu)
      base &= 0xffffffffu;
    else
      return false;
  }
  uint64_t p = pos + 24;
  const size_t es = type ? 8 : 16;
  if (uint64_t(n) * es > src.size) return false;
  std::vector<uint8_t> e(size_t(n) * es);
  if (!src.read(p, e.data(), e.size())) return false;
  for (uint32_t i = 0; i < n; i++) {
    const uint8_t* q = e.data() + size_t(i) * es;
    if (type) {
      uint32_t len = rl32(q + 4);
      (*keys)[rl32(q) + base - 8] = !(len & 0x80000000u);
    } else if (!read_odml(src, rl64(q) + 8, depth + 1, keys)) {
      return false;
    }
  }
  return true;
}

// avidec's avi_read_idx1, for the video stream: the first entry's offset
// against the first packet decides whether the offsets count from 'movi'.
void read_idx1(const Src& src, const Header& h, uint64_t first_packet, KeyMap* keys) {
  uint64_t pos = h.movi_end;
  uint8_t b[8];
  while (pos + 8 <= src.size && src.read(pos, b, 8)) {
    uint32_t t = rl32(b), size = rl32(b + 4);
    if (t == riff_fourcc("idx1")) {
      uint32_t n = size / 16;
      if (!n || uint64_t(n) * 16 > src.size - pos - 8) return;
      std::vector<uint8_t> e(size_t(n) * 16);
      if (!src.read(pos + 8, e.data(), e.size())) return;
      bool first = true, anykey = false;
      int64_t offset = 0;
      std::vector<uint64_t> seen;
      for (uint32_t i = 0; i < n; i++) {
        const uint8_t* q = e.data() + size_t(i) * 16;
        uint32_t ck = rl32(q), flags = rl32(q + 4);
        uint64_t off = rl32(q + 8);
        int idx = stream_idx(ck);
        if (idx >= h.nb_streams) continue;
        if (((ck >> 16) & 0xff) == 'p' && ((ck >> 24) & 0xff) == 'c') continue;
        if (first && first_packet) {
          if (h.movi_list + 4 != off || off + 500 > first_packet)
            offset = int64_t(first_packet) - int64_t(off);
          first = false;
        }
        anykey |= (flags & 0x10) != 0;
        if (idx == h.video && rl32(q + 12)) (*keys)[uint64_t(int64_t(off) + offset)] = flags & 0x10;
      }
      if (!anykey)  // avidec then marks each stream's first entry a keyframe
        for (auto& kv : *keys) kv.second = false;
      return;
    }
    pos += 8 + uint64_t(size) + (size & 1);
  }
}

}  // namespace

int demux_avi_src(const uint8_t* mem, int fd, uint64_t size, Track* track, std::string* msg) {
  Src src{mem, fd, size};
  Header h;
  if (!parse_header(src, &h, msg)) return kInvalid;
  if (h.video < 0) {
    *msg = "no video stream";
    return kInvalid;
  }
  if (!h.scale || !h.rate) {
    h.scale = h.frame_period ? h.frame_period : 1;
    h.rate = h.frame_period ? 1000000 : 25;
  }
  // the packets, as avidec's reader walks movi
  std::vector<Sample>& out = track->samples;
  out.clear();
  std::vector<uint64_t> headers;  // chunk header offset of each packet
  int64_t slot = h.start;
  uint64_t first_packet = 0;
  uint64_t pos = h.movi_list + 4;
  uint8_t b[12];
  while (pos + 8 <= src.size && src.read(pos, b, 8)) {
    uint32_t t = rl32(b), sz = rl32(b + 4);
    if (t == riff_fourcc("LIST") || t == riff_fourcc("RIFF")) {
      pos += 12;  // into 'rec ' groupings and the AVIX extensions' movi
      continue;
    }
    uint64_t next = pos + 8 + uint64_t(sz) + (sz & 1);
    int idx = stream_idx(t);
    const int c2 = int((t >> 16) & 0xff), c3 = int(t >> 24);
    bool index_chunk = (c2 == 'i' && c3 == 'x') || ((t & 0xffff) == ('i' | ('x' << 8)));
    if (idx < h.nb_streams && !index_chunk && t != riff_fourcc("JUNK")) {
      if (!first_packet) first_packet = pos;
      if (idx == h.video && !(c2 == 'p' && c3 == 'c')) {
        if (sz > 0) {
          if (uint64_t(sz) > src.size - pos - 8) break;  // cut by the end of the file
          out.push_back({int64_t(pos + 8), int64_t(sz), slot, slot, true, false});
          headers.push_back(pos);
        }
        slot++;
      }
    }
    pos = next;
  }
  KeyMap keys;
  bool indexed = h.indx_pos && read_odml(src, h.indx_pos, 0, &keys) && !keys.empty();
  if (!indexed) {
    keys.clear();
    read_idx1(src, h, first_packet, &keys);
    indexed = !keys.empty();
  }
  if (indexed) {
    for (size_t i = 0; i < out.size(); i++) {
      auto it = keys.find(headers[i]);
      out[i].key = it != keys.end() && it->second;
    }
    if (!out.empty()) {
      bool any = false;
      for (auto& s : out) any |= s.key;
      if (!any) out[0].key = true;
    }
  }
  track->container = kAvi;
  track->codec_tag = h.codec_tag;
  track->width = h.width;
  track->height = h.height < 0 ? -h.height : h.height;
  track->bits = h.bits;
  track->timescale = h.rate;
  track->start_time = h.start;
  track->nb_frames = h.length;
  track->duration = slot - int64_t(h.start);
  track->fps = double(h.rate) / double(h.scale);
  track->config = std::move(h.extradata);
  return kOk;
}

int demux_avi(const uint8_t* data, size_t n, Track* track, std::string* msg) {
  return demux_avi_src(data, -1, n, track, msg);
}

int demux_avi_fd(int fd, uint64_t size, Track* track, std::string* msg) {
  return demux_avi_src(nullptr, fd, size, track, msg);
}

bool is_avi(const uint8_t* head, size_t n) {
  return n >= 12 && !memcmp(head, "RIFF", 4) && !memcmp(head + 8, "AVI ", 4);
}

}  // namespace video
