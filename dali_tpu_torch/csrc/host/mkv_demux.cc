// Matroska (EBML) demuxer for the host video stack: the frames of the first
// video track, with the stream values the frame-accurate reader needs, as
// libavformat 5.1's matroska demuxer (matroskadec.c) gives them:
//   * EBML variable-length IDs and sizes; a Segment or Cluster of unknown
//     size (all ones, as a live writer leaves it) ends at the end of the
//     file or at the first element that cannot be its child; elements the
//     demuxer does not read are skipped;
//   * Info: TimestampScale (1 ms by default) and the Segment Duration, a
//     float, which gives the file's duration in microseconds
//     (Duration * TimestampScale / 1000, truncated); the frame count comes
//     from it, as libavformat counts no frames in Matroska;
//   * Tracks: the first video track's CodecID, CodecPrivate (the
//     extradata; for V_MS/VFW/FOURCC a BITMAPINFOHEADER, whose FourCC picks
//     the codec and whose tail is the extradata), pixel size,
//     DefaultDuration (avg_frame_rate = 10^9 / DefaultDuration reduced to
//     terms of at most 30000) and one ContentEncoding (header stripping or
//     zlib; bzlib and LZO are left to item 8b);
//   * Clusters: a Cluster Timestamp plus a block's signed 16-bit offset is
//     the pts of its first frame (a V_MS/VFW/FOURCC track's dts), in units
//     of TimestampScale; a SimpleBlock's flag, or a BlockGroup without a
//     ReferenceBlock, marks a key frame; the three lacings (Xiph, EBML,
//     fixed) split a block into frames, each after the first timed one lace
//     duration later (BlockDuration, else DefaultDuration times the laces,
//     spread over them) or left without a timestamp.
// The frames stay on disk: a sample is a lace's place in the file, which a
// read decodes (ContentEncoding) as it takes it.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "inflate.h"
#include "video.h"

namespace video {
namespace {

constexpr uint32_t kEbmlId = 0x1a45dfa3, kDocType = 0x4282, kSegment = 0x18538067,
                   kInfo = 0x1549a966, kTimestampScale = 0x2ad7b1, kDuration = 0x4489,
                   kTracks = 0x1654ae6b, kTrackEntry = 0xae, kTrackNumber = 0xd7,
                   kTrackType = 0x83, kCodecId = 0x86, kCodecPrivate = 0x63a2,
                   kDefaultDuration = 0x23e383, kTrackTimestampScale = 0x23314f, kVideo = 0xe0,
                   kPixelWidth = 0xb0, kPixelHeight = 0xba, kContentEncodings = 0x6d80,
                   kContentEncoding = 0x6240, kEncodingScope = 0x5032, kEncodingType = 0x5033,
                   kContentCompression = 0x5034, kCompAlgo = 0x4254, kCompSettings = 0x4255,
                   kCluster = 0x1f43b675, kClusterTimestamp = 0xe7, kSimpleBlock = 0xa3,
                   kBlockGroup = 0xa0, kBlock = 0xa1, kBlockDuration = 0x9b,
                   kReferenceBlock = 0xfb;
constexpr uint64_t kUnknown = ~uint64_t(0);

// The children a Cluster of unknown size may hold; any other element ends it
bool cluster_child(uint32_t id) {
  return id == kClusterTimestamp || id == kSimpleBlock || id == kBlockGroup || id == 0xa7 ||
         id == 0xab || id == 0xaf || id == 0x5854 || id == 0xec || id == 0xbf;
}

struct Element {
  uint32_t id;
  uint64_t body, size;  // size kUnknown: to the end of its parent
};

// An element header at ``pos`` (before ``end``): an ID of 1-4 bytes and a
// size of 1-8
bool element(BlockReader& in, uint64_t pos, uint64_t end, Element* e) {
  end = std::min(end, in.size);
  const size_t n = size_t(std::min<uint64_t>(12, end > pos ? end - pos : 0));
  const uint8_t* p = in.at(pos, n);
  if (!p || n < 2) return false;
  int il = 1;
  while (il <= 4 && !(p[0] & (0x80 >> (il - 1)))) il++;
  if (il > 4 || size_t(il) >= n) return false;
  uint32_t id = 0;
  for (int i = 0; i < il; i++) id = (id << 8) | p[i];
  const uint8_t first = p[il];
  int sl = 1;
  while (sl <= 8 && !(first & (0x80 >> (sl - 1)))) sl++;
  if (sl > 8 || size_t(il + sl) > n) return false;
  uint64_t size = first & (0xff >> sl);
  for (int i = 1; i < sl; i++) size = (size << 8) | p[il + i];
  // a size of all ones is unknown
  if (size + 1 == uint64_t(1) << (7 * sl)) size = kUnknown;
  e->id = id;
  e->body = pos + uint64_t(il + sl);
  e->size = size;
  return true;
}

uint64_t read_uint(BlockReader& in, const Element& e) {
  if (e.size > 8) return 0;
  const uint8_t* p = in.at(e.body, size_t(e.size));
  uint64_t v = 0;
  for (uint64_t i = 0; p && i < e.size; i++) v = (v << 8) | p[i];
  return v;
}

double read_float(BlockReader& in, const Element& e) {
  const uint8_t* p = e.size == 4 || e.size == 8 ? in.at(e.body, size_t(e.size)) : nullptr;
  if (!p) return 0.0;
  uint64_t bits = 0;
  for (uint64_t i = 0; i < e.size; i++) bits = (bits << 8) | p[i];
  if (e.size == 4) {
    const uint32_t b32 = uint32_t(bits);
    float f;
    memcpy(&f, &b32, 4);
    return f;
  }
  double d;
  memcpy(&d, &bits, 8);
  return d;
}

std::vector<uint8_t> read_bytes(BlockReader& in, const Element& e) {
  if (e.size == kUnknown || e.size > (uint64_t(1) << 26)) return {};
  const uint8_t* p = in.at(e.body, size_t(e.size));
  return p ? std::vector<uint8_t>(p, p + e.size) : std::vector<uint8_t>();
}

// An EBML variable-length number in a block's bytes (the track number and
// EBML lace sizes): its length, or 0 when it does not fit
int vint(const uint8_t* p, size_t n, uint64_t* v) {
  if (!n || !p[0]) return 0;
  int len = 1;
  while (!(p[0] & (0x80 >> (len - 1)))) len++;
  if (size_t(len) > n) return 0;
  *v = p[0] & (0xff >> len);
  for (int i = 1; i < len; i++) *v = (*v << 8) | p[i];
  return len;
}

// av_reduce: num/den in lowest terms, or its best approximation with terms
// of at most ``max``
void av_reduce(int64_t* dn, int64_t* dd, int64_t num, int64_t den, int64_t max) {
  int64_t a0n = 0, a0d = 1, a1n = 1, a1d = 0;
  int64_t a = num < 0 ? -num : num, b = den < 0 ? -den : den;
  while (b) {
    const int64_t t = a % b;
    a = b;
    b = t;
  }
  if (a) {
    num = (num < 0 ? -num : num) / a;
    den = (den < 0 ? -den : den) / a;
  }
  if (num <= max && den <= max) {
    a1n = num;
    a1d = den;
    den = 0;
  }
  while (den) {
    const uint64_t x = uint64_t(num / den);
    const int64_t next_den = num - den * int64_t(x);
    const int64_t a2n = int64_t(x) * a1n + a0n, a2d = int64_t(x) * a1d + a0d;
    if (a2n > max || a2d > max) {
      uint64_t y = x;
      if (a1n) y = uint64_t((max - a0n) / a1n);
      if (a1d) y = std::min(y, uint64_t((max - a0d) / a1d));
      if (den * (2 * int64_t(y) * a1d + a0d) > num * a1d) {
        a1n = int64_t(y) * a1n + a0n;
        a1d = int64_t(y) * a1d + a0d;
      }
      break;
    }
    a0n = a1n;
    a0d = a1d;
    a1n = a2n;
    a1d = a2d;
    num = den;
    den = next_den;
  }
  *dn = a1n;
  *dd = a1d;
}

struct MkvTrack {
  uint64_t number = 0;
  uint64_t type = 0;
  std::string codec;
  std::vector<uint8_t> priv;
  uint64_t default_duration = 0;
  double time_scale = 1.0;
  uint64_t width = 0, height = 0;
  int encodings = 0;
  uint64_t enc_scope = 1, enc_type = 0, comp_algo = 0;
  std::vector<uint8_t> comp_settings;
};

void parse_encoding(BlockReader& in, const Element& enc, MkvTrack* t) {
  t->encodings++;
  Element e;
  const uint64_t end = enc.body + enc.size;
  for (uint64_t pos = enc.body; pos < end && element(in, pos, end, &e); pos = e.body + e.size) {
    if (e.size == kUnknown) break;
    if (e.id == kEncodingScope) t->enc_scope = read_uint(in, e);
    else if (e.id == kEncodingType) t->enc_type = read_uint(in, e);
    else if (e.id == kContentCompression) {
      Element c;
      for (uint64_t q = e.body; q < e.body + e.size && element(in, q, e.body + e.size, &c);
           q = c.body + c.size) {
        if (c.size == kUnknown) break;
        if (c.id == kCompAlgo) t->comp_algo = read_uint(in, c);
        else if (c.id == kCompSettings) t->comp_settings = read_bytes(in, c);
      }
    }
  }
}

MkvTrack parse_track(BlockReader& in, const Element& entry) {
  MkvTrack t;
  Element e;
  const uint64_t end = entry.body + entry.size;
  for (uint64_t pos = entry.body; pos < end && element(in, pos, end, &e); pos = e.body + e.size) {
    if (e.size == kUnknown) break;
    switch (e.id) {
      case kTrackNumber: t.number = read_uint(in, e); break;
      case kTrackType: t.type = read_uint(in, e); break;
      case kCodecId: {
        const std::vector<uint8_t> s = read_bytes(in, e);
        t.codec.assign(s.begin(), s.end());
        t.codec = t.codec.c_str();  // a string element may end in zeros
        break;
      }
      case kCodecPrivate: t.priv = read_bytes(in, e); break;
      case kDefaultDuration: t.default_duration = read_uint(in, e); break;
      case kTrackTimestampScale:
        t.time_scale = read_float(in, e);
        if (!(t.time_scale >= 0.01)) t.time_scale = 1.0;  // as matroskadec.c assumes
        break;
      case kVideo: {
        Element v;
        for (uint64_t q = e.body; q < e.body + e.size && element(in, q, e.body + e.size, &v);
             q = v.body + v.size) {
          if (v.size == kUnknown) break;
          if (v.id == kPixelWidth) t.width = read_uint(in, v);
          else if (v.id == kPixelHeight) t.height = read_uint(in, v);
        }
        break;
      }
      case kContentEncodings: {
        Element c;
        for (uint64_t q = e.body; q < e.body + e.size && element(in, q, e.body + e.size, &c);
             q = c.body + c.size) {
          if (c.size == kUnknown) break;
          if (c.id == kContentEncoding) parse_encoding(in, c, &t);
        }
        break;
      }
      default: break;
    }
  }
  return t;
}

// What the port names an unported video CodecID, with its ROADMAP item
std::string unported(const std::string& codec, bool webm) {
  std::string what = "'" + codec + "'", item = "8b";
  if (codec == "V_VP8" || codec == "V_VP9" || codec == "V_AV1") {
    what = codec == "V_VP8" ? "VP8" : (codec == "V_VP9" ? "VP9" : "AV1");
    item = "8b(f)";
  } else if (codec == "V_MPEG4/ISO/AVC") {
    what = "H.264";
    item = "8b(e)";
  } else if (codec == "V_MPEGH/ISO/HEVC") {
    what = "HEVC";
  }
  return what + " video in " + (webm ? "WebM" : "Matroska") +
         ": the port reads MPEG-4 Part 2, MPEG-1/2, Motion JPEG, FFV1 and the "
         "V_MS/VFW/FOURCC forms it reads in AVI from Matroska; " + what +
         " is ROADMAP.md Queue 1 item " + item;
}

// The demuxer's walk over the Clusters, collecting the video track's frames
struct Walk {
  BlockReader& in;
  MkvTrack video;
  Track* track;
  uint64_t time_scale;  // TimestampScale in ns
  int64_t cluster_time = -1;

  // One Block or SimpleBlock of ``len`` bytes at ``pos``; ``key`` -1 takes
  // the SimpleBlock's flag
  void block(uint64_t pos, uint64_t len, int key, uint64_t block_duration) {
    const uint8_t* h = in.at(pos, size_t(std::min<uint64_t>(len, 12)));
    if (!h) return;
    uint64_t num;
    const int nl = vint(h, size_t(std::min<uint64_t>(len, 12)), &num);
    if (!nl || num != video.number || len < uint64_t(nl) + 3) return;
    const int16_t block_time = int16_t((h[nl] << 8) | h[nl + 1]);
    const int flags = h[nl + 2];
    if (key < 0) key = (flags & 0x80) != 0;
    int64_t timecode = kNoPts;
    const double cluster_tb = double(cluster_time) / video.time_scale;
    if (cluster_time >= 0 && (block_time >= 0 || cluster_time >= -block_time) && cluster_tb < 9e18)
      timecode = int64_t(uint64_t(cluster_tb)) + block_time;
    uint64_t data = pos + uint64_t(nl) + 3;
    uint64_t size = len - uint64_t(nl) - 3;
    std::vector<uint64_t> laces;
    const int lacing = (flags & 0x06) >> 1;
    if (!lacing) {
      laces.push_back(size);
    } else {
      // matroska_parse_laces
      if (!size) return;
      const uint8_t* p = in.at(data, size_t(size));
      if (!p) return;
      const int count = p[0] + 1;
      size_t off = 1;
      uint64_t left = size - 1, total = 0;
      if (lacing == 1) {
        for (int i = 0; i < count - 1; i++) {
          uint64_t s = 0;
          uint8_t b;
          do {
            if (left <= total) return;
            b = p[off++];
            left--;
            total += b;
            s += b;
          } while (b == 0xff);
          laces.push_back(s);
        }
        if (left < total) return;
        laces.push_back(left - total);
      } else if (lacing == 2) {
        if (left % uint64_t(count)) return;
        for (int i = 0; i < count; i++) laces.push_back(left / uint64_t(count));
      } else {
        uint64_t v;
        int k = vint(p + off, size_t(left), &v);
        if (!k || v > 0x7fffffff) return;
        laces.push_back(v);
        total = v;
        off += size_t(k);
        left -= uint64_t(k);
        for (int i = 1; i < count - 1; i++) {
          k = vint(p + off, size_t(left), &v);
          if (!k) return;
          const int64_t d = int64_t(v) - ((int64_t(1) << (7 * k - 1)) - 1);
          const int64_t s = int64_t(laces.back()) + d;
          if (s < 0 || s > 0x7fffffff) return;
          laces.push_back(uint64_t(s));
          total += uint64_t(s);
          off += size_t(k);
          left -= uint64_t(k);
        }
        if (left < total) return;
        laces.push_back(left - total);
      }
      data += off;
    }
    if (!block_duration && video.default_duration)
      block_duration = video.default_duration * laces.size() / time_scale;
    const uint64_t n = laces.size();
    for (uint64_t i = 0; i < n; i++) {
      const int64_t lace_duration =
          int64_t(block_duration * (i + 1) / n) - int64_t(block_duration * i / n);
      Sample s{int64_t(data), int64_t(laces[i]), kNoPts, kNoPts, i == 0 && key, false};
      (track->ms_compat ? s.dts : s.pts) = timecode;
      track->samples.push_back(s);
      if (timecode != kNoPts) timecode = lace_duration ? timecode + lace_duration : kNoPts;
      data += laces[i];
    }
  }

  void group(const Element& g) {
    Element e;
    const uint64_t end = g.body + g.size;
    uint64_t bpos = 0, blen = 0, duration = 0;
    bool have = false, referenced = false;
    for (uint64_t pos = g.body; pos < end && element(in, pos, end, &e); pos = e.body + e.size) {
      if (e.size == kUnknown) break;
      if (e.id == kBlock) {
        bpos = e.body;
        blen = e.size;
        have = true;
      } else if (e.id == kBlockDuration) {
        duration = read_uint(in, e);
      } else if (e.id == kReferenceBlock) {
        referenced = true;
      }
    }
    if (have && blen) block(bpos, blen, referenced ? 0 : 1, duration);
  }

  // The Cluster at ``c``; returns where the walk goes on
  uint64_t cluster(const Element& c, uint64_t seg_end) {
    const bool unknown = c.size == kUnknown;
    const uint64_t end = unknown ? seg_end : std::min(seg_end, c.body + c.size);
    cluster_time = -1;
    Element e;
    uint64_t pos = c.body;
    while (pos < end && element(in, pos, end, &e)) {
      if (unknown && !cluster_child(e.id)) return pos;
      if (e.size == kUnknown) return end;
      if (e.id == kClusterTimestamp) cluster_time = int64_t(read_uint(in, e));
      else if (e.id == kSimpleBlock) block(e.body, e.size, -1, 0);
      else if (e.id == kBlockGroup) group(e);
      pos = e.body + e.size;
    }
    return end;
  }
};

}  // namespace

bool is_mkv(const uint8_t* d, size_t n) {
  return n >= 4 && d[0] == 0x1a && d[1] == 0x45 && d[2] == 0xdf && d[3] == 0xa3;
}

int demux_mkv_fd(int fd, const uint8_t* mem, uint64_t size, Track* track, std::string* msg) {
  BlockReader in{fd, mem, size};
  in.block = size_t(1) << 16;
  Element e;
  if (!element(in, 0, size, &e) || e.id != kEbmlId || e.size == kUnknown) {
    *msg = "not a video file";
    return kInvalid;
  }
  std::string doctype = "matroska";
  {
    Element c;
    for (uint64_t pos = e.body; pos < e.body + e.size && element(in, pos, e.body + e.size, &c);
         pos = c.body + c.size) {
      if (c.size == kUnknown) break;
      if (c.id == kDocType) {
        const std::vector<uint8_t> s = read_bytes(in, c);
        doctype.assign(s.begin(), s.end());
        doctype = doctype.c_str();
      }
    }
  }
  const bool webm = doctype == "webm";
  // the Segment
  uint64_t pos = e.body + e.size;
  while (element(in, pos, size, &e) && e.id != kSegment) {
    if (e.size == kUnknown) break;
    pos = e.body + e.size;
  }
  if (e.id != kSegment) {
    *msg = "no Matroska segment";
    return kInvalid;
  }
  const uint64_t seg_end = e.size == kUnknown ? size : std::min(size, e.body + e.size);
  uint64_t time_scale = 1000000;
  double duration = 0.0;
  std::vector<MkvTrack> tracks;
  const MkvTrack* video = nullptr;
  Walk walk{in, MkvTrack(), track, time_scale};
  bool tracks_read = false;
  pos = e.body;
  while (pos < seg_end && element(in, pos, seg_end, &e)) {
    if (e.id == kCluster) {
      if (!video) break;
      walk.time_scale = time_scale;
      pos = walk.cluster(e, seg_end);
      continue;
    }
    if (e.size == kUnknown) break;
    if (e.id == kInfo) {
      Element c;
      for (uint64_t q = e.body; q < e.body + e.size && element(in, q, e.body + e.size, &c);
           q = c.body + c.size) {
        if (c.size == kUnknown) break;
        if (c.id == kTimestampScale) time_scale = read_uint(in, c);
        else if (c.id == kDuration) duration = read_float(in, c);
      }
      if (!time_scale) time_scale = 1000000;
    } else if (e.id == kTracks && !tracks_read) {
      tracks_read = true;
      Element c;
      for (uint64_t q = e.body; q < e.body + e.size && element(in, q, e.body + e.size, &c);
           q = c.body + c.size) {
        if (c.size == kUnknown) break;
        if (c.id == kTrackEntry) tracks.push_back(parse_track(in, c));
      }
      for (const MkvTrack& t : tracks)
        if (t.type == 1 && t.number) {
          video = &t;
          break;
        }
      if (!video) {
        *msg = "no video track in the Matroska file";
        return kInvalid;
      }
      // the codec, as matroska_parse_tracks maps the CodecID
      const MkvTrack& v = *video;
      const std::string& id = v.codec;
      track->container = kMkv;
      track->width = int(v.width);
      track->height = int(v.height);
      track->config = v.priv;
      if (id == "V_MS/VFW/FOURCC") {
        if (v.priv.size() < 40) {
          *msg = "V_MS/VFW/FOURCC track without a BITMAPINFOHEADER";
          return kInvalid;
        }
        track->ms_compat = true;
        track->bits = v.priv[14] | (v.priv[15] << 8);
        track->codec_tag = uint32_t(v.priv[16]) | (uint32_t(v.priv[17]) << 8) |
                           (uint32_t(v.priv[18]) << 16) | (uint32_t(v.priv[19]) << 24);
        track->config.assign(v.priv.begin() + 40, v.priv.end());
      } else if (id == "V_MPEG4/ISO/ASP" || id == "V_MPEG4/ISO/SP" || id == "V_MPEG4/ISO/AP") {
        track->codec_tag = riff_fourcc("MP4V");
        track->es_codec = kEsMpeg4;
      } else if (id == "V_MPEG1" || id == "V_MPEG2") {
        track->codec_tag = riff_fourcc(id == "V_MPEG1" ? "MPG1" : "MPG2");
        track->es_codec = kEsMpeg12;
      } else if (id == "V_MJPEG") {
        track->codec_tag = riff_fourcc("MJPG");
      } else if (id == "V_FFV1") {
        track->codec_tag = riff_fourcc("FFV1");
      } else {
        *msg = unported(id, webm);
        return kUnsupported;
      }
      // one ContentEncoding: a compression the decoder undoes on every frame
      if (v.encodings == 1 && v.enc_type == 0) {
        if (v.comp_algo == 1 || v.comp_algo == 2) {
          *msg = std::string(v.comp_algo == 1 ? "bzlib" : "LZO") +
                 "-compressed Matroska frames: the port reads header stripping and zlib; the "
                 "rest is ROADMAP.md Queue 1 item 8b";
          return kUnsupported;
        }
        if (v.comp_algo == 0 || v.comp_algo == 3) {
          if ((v.enc_scope & 2) && !track->config.empty() &&
              !mkv_decode_frame(v.comp_algo, v.comp_settings, track->config.data(),
                                track->config.size(), &track->config)) {
            *msg = "damaged compressed CodecPrivate";
            return kInvalid;
          }
          if ((v.enc_scope & 1) && (v.comp_algo == 0 || !v.comp_settings.empty())) {
            track->content_comp = int(v.comp_algo);
            track->comp_settings = v.comp_settings;
          }
        }
      }
      walk.video = v;
    }
    pos = e.body + e.size;
  }
  if (!video) {
    *msg = tracks_read ? "no video track in the Matroska file" : "no Matroska tracks";
    return kInvalid;
  }
  const MkvTrack& v = *video;
  // the time base: TimestampScale ns (times the track's scale) over 10^9 s
  int64_t num, den;
  const double tb_ns = double(time_scale) * v.time_scale;
  av_reduce(&num, &den, tb_ns >= 1 && tb_ns < 4294967296.0 ? int64_t(uint32_t(tb_ns)) : 1000000,
            1000000000, 0x7fffffff);
  track->tb_num = num;
  track->timescale = den;
  if (v.default_duration) {
    const uint64_t div = v.default_duration <= uint64_t(INT64_MAX) ? 1 : 2;
    int64_t fn, fd;
    av_reduce(&fn, &fd, int64_t(1000000000 / div), int64_t(v.default_duration / div), 30000);
    track->fps = fd ? double(fn) / double(fd) : 0.0;
  }
  track->nb_frames = 0;
  const double us = duration * double(time_scale) * 1000 / 1000000;
  track->format_duration = us > 0 && us < 9e18 ? int64_t(us) : kNoPts;
  track->start_time = kNoPts;
  for (const Sample& s : track->samples) {
    const int64_t t = track->ms_compat ? s.dts : s.pts;
    if (t != kNoPts) {
      track->start_time = t;
      break;
    }
  }
  if (track->samples.empty()) {
    *msg = "no frames of the video track in the Matroska file";
    return kInvalid;
  }
  return kOk;
}

bool mkv_decode_frame(uint64_t algo, const std::vector<uint8_t>& settings, const uint8_t* p,
                      size_t n, std::vector<uint8_t>* out) {
  if (algo == 3) {
    std::vector<uint8_t> r(settings);
    r.insert(r.end(), p, p + n);
    *out = std::move(r);
    return true;
  }
  // zlib: matroska_decode_buffer inflates into a buffer three times larger
  // each time it fills, up to 10^7 bytes
  size_t cap = n;
  std::vector<uint8_t> r;
  do {
    cap *= 3;
    r.resize(cap);
    size_t got = 0;
    const int st = dali_inflate::inflate_zlib(p, n, r.data(), cap, &got);
    if (st == dali_inflate::kEnd) {
      r.resize(got);
      *out = std::move(r);
      return true;
    }
    if (st != dali_inflate::kFull) return false;
  } while (cap < 10000000);
  return false;
}

}  // namespace video
