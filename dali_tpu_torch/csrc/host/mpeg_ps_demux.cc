// MPEG program stream (ISO/IEC 13818-1 / 11172-1) demuxer for the host
// video stack, and what the MPEG demuxers share: the split of an MPEG-1/2
// (or, in TS, MPEG-4 Part 2) elementary stream into the decoder's packets
// with their timestamps, and the stream duration, as libavformat 5.1 gives
// them:
//   * the program stream (mpeg.c): pack headers in both the MPEG-1 and the
//     MPEG-2 form, system headers, and the PES packets of the first video
//     stream (0xE0-0xEF) with their PTS and DTS (a PTS alone is also the
//     DTS); padding, private and audio streams are skipped;
//   * the split (mpegvideo_parser.c, ff_mpeg1_find_frame_end; for MPEG-4
//     Part 2 ff_mpeg4_find_frame_end): a packet ends at the first start
//     code that is not a slice after the picture's slices (a sequence end
//     code stays with it), fed one PES packet at a time as parse_packet
//     feeds av_parser_parse2;
//   * the timestamps (av_parser_parse2, ff_fetch_timestamp): a PES
//     packet's PTS and DTS go to the first picture whose picture start code
//     lies in it (or, at the start of a packet, to the packet), each used
//     once; compute_pkt_fields then fills the missing ones (an I- or
//     P-picture without a DTS takes the last anchor's PTS, a B-picture
//     without a PTS the running DTS) from each packet's duration
//     (1 + repeat_pict frames of the sequence's rate);
//   * the stream duration (estimate_timings_from_pts): the PES timestamps
//     of the file's last 250000 bytes (doubling back while none has one)
//     give the largest PTS plus one frame, less the first picture's PTS.
// A raw elementary stream (``00 00 01 B3``) is split the same way; it has
// no timestamps.

#include <algorithm>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "video.h"

namespace video {
namespace {

constexpr int64_t kRelativeBase = INT64_MAX - (int64_t(1) << 48);
inline bool is_relative(int64_t ts) { return ts > kRelativeBase - (int64_t(1) << 48); }

// ff_mpeg12_frame_rate_tab
constexpr int kFrameRate[16][2] = {{0, 0},   {24000, 1001}, {24, 1}, {25, 1}, {30000, 1001},
                                   {30, 1},  {50, 1},       {60000, 1001}, {60, 1}, {15, 1},
                                   {5, 1},   {10, 1},       {12, 1}, {15, 1}, {0, 0}, {0, 0}};

struct Parsed {
  int64_t offset, size, pts, dts;
  int64_t next_pts, next_dts;  // the PES timestamps of the parser call it came out of
  int type;
  int64_t duration;  // in 90 kHz ticks, as compute_frame_duration gives it
  int has_b_frames;  // the codec context's value after the parser's headers
  bool mpeg2;        // the parser has read a sequence extension
};

struct PesInfo {
  int64_t pos, size, pts;
};

}  // namespace

struct MpegEsSplitter::Impl {
  int codec;
  int64_t timescale;
  PictureSink* sink;
  // av_parser_parse2's state
  bool fetched_offset = false, fetch = true;
  int64_t cur_offset = 0, next_frame_offset = 0, frame_offset = 0;
  int start_index = 0;
  int64_t fr_offset[16] = {}, fr_end[16] = {}, fr_pts[16], fr_dts[16];
  int64_t pts = kNoPts, dts = kNoPts;
  // ParseContext
  uint32_t state = 0xffffffffu;
  int frame_start_found = 0;
  int64_t frame_begin = -1;  // the offset of the packet being assembled
  std::vector<uint8_t> head;  // its bytes so far, to head_end
  int64_t head_end = -1;
  // the codec context as the parser updates it
  int fr_num = 0, fr_den = 0, ticks = 1, has_b_frames = 0, progressive_sequence = 0;
  bool mpeg2 = false;
  // bit/s: the first sequence header's, and the one the parser sets (a
  // frame whose picture states its vbv_delay, or an MPEG-1 rate below the
  // variable-rate code)
  int64_t seq_bit_rate = -1, parser_bit_rate = 0;
  std::vector<Parsed> out;
  std::vector<PesInfo> pes;

  Impl(int c, int64_t ts, PictureSink* k) : codec(c), timescale(ts), sink(k) {
    for (int i = 0; i < 16; i++) fr_pts[i] = fr_dts[i] = kNoPts;
  }

  // ff_fetch_timestamp
  void fetch_timestamp(int64_t off, bool remove, bool fuzzy) {
    if (!fuzzy) {
      dts = pts = kNoPts;
    }
    for (int i = 0; i < 16; i++) {
      if (cur_offset + off >= fr_offset[i] &&
          (frame_offset < fr_offset[i] || (!frame_offset && !next_frame_offset)) && fr_end[i]) {
        if (!fuzzy || fr_dts[i] != kNoPts) {
          dts = fr_dts[i];
          pts = fr_pts[i];
        }
        if (remove) fr_offset[i] = INT64_MAX;
        if (cur_offset + off < fr_end[i]) break;
      }
    }
  }

  // avpriv_find_start_code from index i: the index after the code's last
  // byte (or n), ``st`` the last four bytes
  static int find_start_code(const uint8_t* buf, int i, int n, uint32_t* st) {
    while (i < n) {
      const uint32_t tmp = *st << 8;
      *st = tmp | buf[i++];
      if (tmp == 0x100) return i;
    }
    return n;
  }

  // ff_mpeg1_find_frame_end / ff_mpeg4_find_frame_end
  int find_frame_end(const uint8_t* buf, int n) {
    uint32_t st = state;
    if (codec == kEsMpeg4) {
      int i = 0;
      bool vop = frame_start_found != 0;
      if (!vop) {
        for (; i < n; i++) {
          st = (st << 8) | buf[i];
          if (st == 0x1b6) {
            i++;
            vop = true;
            break;
          }
        }
      }
      if (vop) {
        if (n == 0) return 0;
        for (; i < n; i++) {
          st = (st << 8) | buf[i];
          if ((st & 0xffffff00u) == 0x100) {
            frame_start_found = 0;
            state = 0xffffffffu;
            return i - 3;
          }
        }
      }
      frame_start_found = vop;
      state = st;
      return -100;  // END_NOT_FOUND
    }
    if (n == 0) return 0;
    int& ffs = frame_start_found;
    for (int i = 0; i < n; i++) {
      if (ffs & 1) {
        if (st == 0x1b5 && (buf[i] & 0xf0) != 0x80) {
          ffs--;
        } else if (st == 0x1b5 + 2) {
          if ((buf[i] & 3) == 3) ffs = 0;
          else ffs = (ffs + 1) & 3;
        }
        st++;
      } else {
        i = find_start_code(buf, i, n, &st) - 1;
        if (ffs == 0 && st >= 0x101 && st <= 0x1af) {
          i++;
          ffs = 4;
        }
        if (st == 0x1b7) {
          ffs = 0;
          state = 0xffffffffu;
          return i + 1;
        }
        if (ffs == 2 && st == 0x1b3) ffs = 0;
        if (ffs < 4 && st == 0x1b5) ffs++;
        if (ffs == 4 && (st & 0xffffff00u) == 0x100) {
          if (st < 0x101 || st > 0x1af) {
            ffs = 0;
            state = 0xffffffffu;
            return i - 3;
          }
        }
        if (ffs == 0 && st == 0x100) fetch_timestamp(i - 3, true, i > 3);
      }
    }
    state = st;
    return -100;
  }

  // mpegvideo_extract_headers (mpeg4video: the VOP type): the picture type
  // and repeat_pict of a packet, updating the codec context
  void extract_headers(const uint8_t* b, size_t n, int* type, int* repeat_pict) {
    *repeat_pict = 0;
    int64_t br = 0;
    int vbv_delay = 0;
    size_t i = 0;
    bool slice = false;
    while (i + 3 < n && !slice) {
      if (!(b[i] == 0 && b[i + 1] == 0 && b[i + 2] == 1)) {
        i++;
        continue;
      }
      const int code = b[i + 3];
      const uint8_t* p = b + i + 4;
      const size_t left = n - (i + 4);
      i += 4;
      if (codec == kEsMpeg4) {
        if (code == 0xb6 && left >= 1) {
          const int t = p[0] >> 6;
          *type = t == 0 ? 1 : (t == 1 ? 2 : (t == 2 ? 3 : 4));
          return;
        }
        continue;
      }
      if (code == 0x00) {
        if (left >= 2) *type = (p[1] >> 3) & 7;
        if (left >= 4) vbv_delay = ((p[1] & 7) << 13) | (p[2] << 5) | (p[3] >> 3);
      } else if (code == 0xb3) {
        if (left >= 7) {
          const int idx = p[3] & 15;
          br = (p[4] << 10) | (p[5] << 2) | (p[6] >> 6);
          if (seq_bit_rate < 0) seq_bit_rate = br * 400;
          fr_num = kFrameRate[idx][0];
          fr_den = kFrameRate[idx][1];
          ticks = 1;
          mpeg2 = false;
        }
      } else if (code == 0xb5) {
        if (left < 1) continue;
        const int ext = p[0] >> 4;
        if (ext == 1 && left >= 6) {
          const int ext_n = (p[5] >> 5) & 3, ext_d = p[5] & 0x1f;
          progressive_sequence = p[1] & (1 << 3);
          has_b_frames = !(p[5] >> 7);
          if (fr_den) {
            fr_num *= ext_n + 1;
            fr_den *= ext_d + 1;
          }
          ticks = 2;
          mpeg2 = true;
          br = (br & 0x3ffff) | (int64_t(((p[2] & 0x1f) << 7) | (p[3] >> 1)) << 18);
        } else if (ext == 8 && left >= 5) {
          const int tff = p[3] & (1 << 7), rff = p[3] & (1 << 1), prog = p[4] & (1 << 7);
          *repeat_pict = 1;
          if (rff) {
            if (progressive_sequence) *repeat_pict = tff ? 5 : 3;
            else if (prog) *repeat_pict = 2;
          }
        }
      } else if (code >= 0x01 && code <= 0xaf) {
        slice = true;
      }
    }
    if (codec == kEsMpeg12 && br && ((!mpeg2 && br != 0x3ffff) || vbv_delay != 0xffff) &&
        !parser_bit_rate)
      parser_bit_rate = br * 400;
  }

  // ff_compute_frame_duration with the parser: the codec rate (ticks per
  // frame, repeat_pict), in the stream's time base rounded down
  int64_t frame_duration(int repeat_pict) const {
    if (codec == kEsMpeg4 || fr_num <= 0 || fr_den <= 0) return 0;
    const int64_t num = int64_t(fr_den) * (1 + repeat_pict), den = int64_t(fr_num) * ticks;
    return num * timescale / den;
  }

  void output(int64_t end, int64_t call_pts, int64_t call_dts) {
    const int64_t size = end - frame_begin;
    if (size <= 0) return;
    int type = 0, repeat_pict = 0;
    const size_t hn = std::min<size_t>(head.size(), size_t(size));
    extract_headers(head.data(), hn, &type, &repeat_pict);
    out.push_back({frame_begin, size, pts, dts, call_pts, call_dts, type,
                   frame_duration(repeat_pict), has_b_frames, mpeg2});
    sink->picture(head.data(), hn, type == 1);
    head.erase(head.begin(), head.begin() + long(hn));
    frame_begin = end;
    if (head_end < end) head_end = end;
  }

  // one av_parser_parse2 call on buf[0, n): the bytes it consumed. Offsets
  // count the stream's bytes from 0 (libavformat's from the first packet's
  // file position: the same comparisons).
  int parse(const uint8_t* buf, int n, int64_t p_pts, int64_t p_dts) {
    if (!fetched_offset) {
      next_frame_offset = cur_offset = 0;
      fetched_offset = true;
      frame_begin = head_end = cur_offset;
    }
    if (p_pts != kNoPts || p_dts != kNoPts) {
      const int i = (start_index + 1) & 15;
      start_index = i;
      fr_offset[i] = cur_offset;
      fr_end[i] = cur_offset + n;
      fr_pts[i] = p_pts;
      fr_dts[i] = p_dts;
    }
    if (fetch) {
      fetch = false;
      fetch_timestamp(0, false, false);
    }
    // the bytes of the packet being assembled
    if (head_end < cur_offset + n) {
      const int64_t from = std::max(head_end, cur_offset) - cur_offset;
      head.insert(head.end(), buf + from, buf + n);
      head_end = cur_offset + n;
    }
    const int next = find_frame_end(buf, n);
    int index;
    if (next == -100) {
      index = n;  // the packet goes on
    } else {
      output(cur_offset + next, p_pts, p_dts);
      // ff_combine_frame: a start code begun in the previous call goes
      // back into the state the next call starts from
      for (int j = 0; j < -next && size_t(j) < head.size(); j++)
        state = (state << 8) | head[size_t(j)];
      frame_offset = next_frame_offset;
      next_frame_offset = cur_offset + next;
      fetch = true;
      index = next;
    }
    if (index < 0) index = 0;
    cur_offset += index;
    return index;
  }

  void feed(const uint8_t* p, size_t n, int64_t p_pts, int64_t p_dts, int64_t pos) {
    pes.push_back({pos, int64_t(n), p_pts});
    // parse_packet: the PES's timestamps go with its first call only
    int64_t t_pts = p_pts, t_dts = p_dts;
    size_t done = 0;
    while (done < n) {
      const int len = parse(p + done, int(n - done), t_pts, t_dts);
      t_pts = t_dts = kNoPts;
      done += size_t(len);
    }
  }

  void flush() {
    if (!fetched_offset) return;
    if (fetch) {
      fetch = false;
      fetch_timestamp(0, false, false);
    }
    output(cur_offset, kNoPts, kNoPts);
  }
};

namespace {

// compute_pkt_fields for one stream with a parser, as read_frame_internal
// runs it on each packet (the wrap and H.264 rules left out), and
// update_initial_timestamps's start_time
struct PktFields {
  int64_t cur_dts = kRelativeBase, first_dts = kNoPts;
  int64_t last_ip_pts = kNoPts, last_ip_duration = 0;
  int64_t last_dts_order = kNoPts;
  int ordered = 0, misordered = 0;
  int has_b_frames = 0;
  int64_t start_time = kNoPts;

  void initial(int64_t d, int64_t p) {
    if (first_dts != kNoPts || d == kNoPts || cur_dts == kNoPts || is_relative(d)) return;
    first_dts = d - (cur_dts - kRelativeBase);
    cur_dts = d;
    const int64_t shift = first_dts - kRelativeBase;
    if (p != kNoPts && is_relative(p)) p += shift;
    if (start_time == kNoPts) start_time = p;
  }

  void run(Parsed* k) {
    const int64_t next_dts = k->next_dts, next_pts = k->next_pts;
    if (k->dts != kNoPts) {
      if (k->dts == k->pts && last_dts_order != kNoPts) {
        if (last_dts_order <= k->dts) ordered++;
        else misordered++;
        if (ordered + misordered > 250) {
          ordered >>= 1;
          misordered >>= 1;
        }
      }
      last_dts_order = k->dts;
      if (ordered < 8 * misordered && k->dts == k->pts) k->dts = kNoPts;
    }
    if (k->type == 3 && !has_b_frames) has_b_frames = 1;
    const int delay = has_b_frames;
    bool delayed = delay && k->type != 3;
    if (delay == 1 && k->dts == k->pts && k->dts != kNoPts && delayed) k->dts = kNoPts;
    if (k->dts != kNoPts && k->pts != kNoPts && k->pts > k->dts) delayed = true;
    if (delay <= 1) {
      if (delayed) {
        if (k->dts == kNoPts) k->dts = last_ip_pts;
        initial(k->dts, k->pts);
        if (k->dts == kNoPts) k->dts = cur_dts;
        if (last_ip_duration == 0) last_ip_duration = k->duration;
        if (k->dts != kNoPts) cur_dts = k->dts + last_ip_duration;
        if (k->dts != kNoPts && k->pts == kNoPts && last_ip_duration > 0 &&
            uint64_t(cur_dts) - uint64_t(next_dts) + 1 <= 2 && next_dts != next_pts &&
            next_pts != kNoPts)
          k->pts = next_dts;
        last_ip_duration = k->duration;
        last_ip_pts = k->pts;
      } else if (k->pts != kNoPts || k->dts != kNoPts || k->duration > 0) {
        if (k->pts == kNoPts) k->pts = k->dts;
        initial(k->pts, k->pts);
        if (k->pts == kNoPts) k->pts = cur_dts;
        k->dts = k->pts;
        if (k->pts != kNoPts) cur_dts = k->pts + k->duration;
      }
    }
    if (k->dts != kNoPts && k->dts > cur_dts) cur_dts = k->dts;
    if (k->dts != kNoPts && is_relative(k->dts)) k->dts -= kRelativeBase;
    if (k->pts != kNoPts && is_relative(k->pts)) k->pts -= kRelativeBase;
  }
};

}  // namespace

MpegEsSplitter::MpegEsSplitter(int codec, int64_t timescale, PictureSink* sink)
    : impl_(new Impl(codec, timescale, sink)) {}
MpegEsSplitter::~MpegEsSplitter() { delete impl_; }

void MpegEsSplitter::feed(const uint8_t* p, size_t n, int64_t pts, int64_t dts, int64_t pos) {
  impl_->feed(p, n, pts, dts, pos);
}

int64_t MpegEsSplitter::pending() const { return impl_->fetched_offset ? impl_->frame_begin : 0; }
size_t MpegEsSplitter::pictures() const { return impl_->out.size(); }
int64_t MpegEsSplitter::picture_offset(size_t i) const { return impl_->out[i].offset; }

void MpegEsSplitter::finish(uint64_t file_size, Track* track) {
  Impl& s = *impl_;
  s.flush();
  track->timescale = s.timescale;
  track->es_codec = s.codec;
  // has_b_frames: the parser sets it from an MPEG-2 sequence extension
  // (!low_delay); for MPEG-1 the decoder avformat_find_stream_info runs on
  // the first packet sets it (!low_delay, 1) after that packet; a B-picture
  // sets it
  PktFields f;
  for (size_t i = 0; i < s.out.size(); i++) {
    Parsed& k = s.out[i];
    if (s.codec == kEsMpeg12) {
      const int hb = k.mpeg2 ? k.has_b_frames : (i > 0 ? 1 : 0);
      f.has_b_frames = std::max(f.has_b_frames, hb);
    }
    f.run(&k);
  }
  track->samples.clear();
  for (const Parsed& k : s.out)
    track->samples.push_back({k.offset, k.size, k.dts, k.pts, k.type == 1, false});
  track->start_time = f.start_time;
  track->nb_frames = 0;
  // fps: the sequence's rate; MPEG-4 Part 2: the pictures' PTS steps
  // (estimate_timings_from_pts gives each packet one frame of that rate)
  double fps = 0.0;
  int64_t frame_ticks = 0;
  if (s.codec == kEsMpeg12 && s.fr_num > 0 && s.fr_den > 0) {
    fps = double(s.fr_num) / double(s.fr_den);
    frame_ticks = int64_t(s.fr_den) * s.timescale / s.fr_num;
  } else {
    std::vector<int64_t> ts;
    for (const Parsed& k : s.out)
      if (k.pts != kNoPts) ts.push_back(k.pts);
    std::sort(ts.begin(), ts.end());
    if (ts.size() >= 2) {
      std::vector<int64_t> steps;
      for (size_t i = 1; i < ts.size(); i++)
        if (ts[i] > ts[i - 1]) steps.push_back(ts[i] - ts[i - 1]);
      if (!steps.empty()) {
        std::nth_element(steps.begin(), steps.begin() + long(steps.size() / 2), steps.end());
        const int64_t step = steps[steps.size() / 2];
        fps = double(s.timescale) / double(step);
        frame_ticks = step;
      }
    }
  }
  track->fps = fps;
  track->duration = 0;
  if (s.timescale != 90000) {
    // an elementary stream (no timestamps): estimate_timings_from_bit_rate,
    // an MPEG-1 stream's from its sequence header, an MPEG-2 stream's from
    // the parser, which takes it only beside a stated vbv_delay (a
    // constant rate)
    const int64_t rate = s.mpeg2 ? s.parser_bit_rate : s.seq_bit_rate;
    if (rate > 0)
      track->duration = int64_t((__int128(file_size) * 8 * s.timescale + rate / 2) / rate);
    return;
  }
  // estimate_timings_from_pts
  const int64_t base = f.start_time != kNoPts ? f.start_time : f.first_dts;
  if (base != kNoPts && file_size > 0) {
    bool found = false;
    int64_t duration = kNoPts, last_duration = 0;
    int retry = 0;
    while (true) {
      const bool is_end = found;
      int64_t offset = int64_t(file_size) - (int64_t(250000) << retry);
      if (offset < 0) offset = 0;
      int64_t read_size = 0;
      const int64_t limit = int64_t(250000) << std::max(retry - 1, 0);
      for (const PesInfo& q : s.pes) {
        if (q.pos < offset) continue;
        if (read_size >= limit) break;
        read_size += q.size;
        if (q.pts == kNoPts) continue;
        const int64_t d = q.pts + frame_ticks - base;
        found = true;
        if (d > 0) {
          if (duration == kNoPts || last_duration <= 0 ||
              (duration < d && std::llabs(d - last_duration) < int64_t(60) * s.timescale))
            duration = d;
          last_duration = d;
        }
      }
      if (!(!is_end && offset && ++retry <= 6)) break;
    }
    if (duration != kNoPts) track->duration = duration;
  }
}

namespace {

inline uint16_t rb16(const uint8_t* p) { return uint16_t((p[0] << 8) | p[1]); }


}  // namespace

int64_t pes_timestamp(const uint8_t* p) {
  return (int64_t(p[0] >> 1) & 7) << 30 | int64_t(rb16(p + 1) >> 1) << 15 |
         int64_t(rb16(p + 3) >> 1);
}

const uint8_t* BlockReader::at(uint64_t pos, size_t k) {
  if (pos > size || k > size - pos) return nullptr;
  if (mem) return mem + pos;
  if (pos < buf_pos || pos + k > buf_pos + buf.size()) {
    const size_t got = size_t(std::min<uint64_t>(std::max(k, block), size - pos));
    buf.resize(got);
    if (!read_at(fd, pos, buf.data(), got)) return nullptr;
    buf_pos = pos;
  }
  return buf.data() + (pos - buf_pos);
}

namespace {

// mpeg.c's check_pes at a start code's id byte ``p``
bool check_pes(const uint8_t* p, const uint8_t* end) {
  const bool pes2 = (p[3] & 0xc0) == 0x80 && (p[4] & 0xc0) != 0x40 &&
                    ((p[4] & 0xc0) == 0x00 || (p[4] >> 6) == (p[6] >> 4));
  for (p += 3; p < end && *p == 0xff; p++) {
  }
  if ((*p & 0xc0) == 0x40) p += 2;
  bool pes1;
  if ((*p & 0xf0) == 0x20) pes1 = p[0] & p[2] & p[4] & 1;
  else if ((*p & 0xf0) == 0x30) pes1 = p[0] & p[2] & p[4] & p[5] & p[7] & p[9] & 1;
  else pes1 = *p == 0x0f;
  return pes1 || pes2;
}

}  // namespace

int mpegps_probe(const uint8_t* b, size_t n) {
  // the probe buffer's zero padding: the checks read a few bytes past it
  std::vector<uint8_t> pad(b, b + n);
  pad.resize(n + 64, 0);
  const uint8_t* buf = pad.data();
  const uint8_t* end = buf + n;
  uint32_t code = 0xffffffffu;
  int sys = 0, pspack = 0, priv1 = 0, vid = 0, audio = 0, invalid = 0, score = 0;
  int64_t endpes = 0;
  for (int64_t i = 0; i < int64_t(n); i++) {
    code = (code << 8) + buf[i];
    if ((code & 0xffffff00u) != 0x100) continue;
    const int len = buf[i + 1] << 8 | buf[i + 2];
    const bool pes = endpes <= i && check_pes(buf + i, end);
    const bool pack = (buf[i + 1] & 0xcc) == 0x44 || (buf[i + 2] & 0x01);
    if (code == 0x1bb) {
      sys++;
    } else if (code == 0x1ba && pack) {
      pspack++;
    } else if ((code & 0xf0) == 0xe0 && pes) {
      endpes = i + len;
      vid++;
    } else if ((code & 0xe0) == 0xc0 && pes) {
      audio++;
      i += len;
    } else if (code == 0x1bd && pes) {
      priv1++;
      i += len;
    } else if (code == 0x1fd && pes) {
      vid++;
    } else if ((code & 0xf0) == 0xe0 && !pes) {
      invalid++;
    } else if ((code & 0xe0) == 0xc0 && !pes) {
      invalid++;
    } else if (code == 0x1bd && !pes) {
      invalid++;
    }
  }
  if (vid + audio > invalid + 1) score = 25;
  if (sys > invalid && sys * 9 <= pspack * 10)
    return (audio > 12 || vid > 3 || pspack > 2) ? 52 : 25 + (audio + vid + pspack > 1);
  if (pspack > invalid && (priv1 + vid + audio) * 10 >= pspack * 9) return pspack > 2 ? 52 : 25;
  if ((!!vid ^ !!audio) && (audio > 4 || vid > 1) && !sys && !pspack && n > 2048 &&
      vid + audio > invalid)
    return (audio > 12 || vid > 6 + 2 * invalid) ? 52 : 25;
  return score;
}

bool is_mpeg_es(const uint8_t* d, size_t n) {
  return n >= 4 && d[0] == 0 && d[1] == 0 && d[2] == 1 && d[3] == 0xb3;
}

namespace {

// One step of the program stream's walk from ``*pos`` (mpegps_read_packet):
// 0 at the end of the file; 1 past a PES packet of the video stream
// ``*video_id`` (the first video stream's id when -1) that starts at
// ``*start``, with its payload at ``*payload`` (``*len`` bytes, 0 when its
// PES header is damaged) and its PTS and DTS; 2 past anything else (a pack
// or system header, padding, another stream).
int ps_step(BlockReader& in, uint64_t* pos, int* video_id, uint64_t* start, uint64_t* payload,
            size_t* len, int64_t* pts, int64_t* dts) {
  while (true) {
    // the next start code
    const uint8_t* h = in.at(*pos, 4);
    if (!h) return 0;
    if (!(h[0] == 0 && h[1] == 0 && h[2] == 1)) {
      ++*pos;
      continue;
    }
    const int id = h[3];
    if (id == 0xba) {
      const uint8_t* p = in.at(*pos + 4, 10);
      if (!p) return 0;
      if ((p[0] & 0xc0) == 0x40) *pos += 14 + (p[9] & 7);  // MPEG-2
      else *pos += 12;                                      // MPEG-1
      return 2;
    }
    if (id == 0xb9) {  // program end
      *pos += 4;
      return 2;
    }
    if (id < 0xbb) {
      *pos += 1;
      continue;
    }
    const uint8_t* lp = in.at(*pos + 4, 2);
    if (!lp) return 0;
    const uint64_t n = rb16(lp), body = *pos + 6;
    *start = *pos;
    *pos = body + n;
    if (id == 0xbb || id == 0xbe || id == 0xbf) return 2;  // system header, padding, private 2
    if (id < 0xe0 || id > 0xef) return 2;                  // not video
    if (*video_id < 0) *video_id = id;
    if (id != *video_id) return 2;
    const uint8_t* p = in.at(body, size_t(n));
    if (!p) return 0;  // a packet cut by the end of the file
    // mpegps_read_pes_header
    *len = 0;
    *pts = *dts = kNoPts;
    size_t k = 0, left = size_t(n);
    int c = 0;
    while (true) {
      if (left < 1) return 1;
      c = p[k++];
      left--;
      if (c != 0xff) break;
    }
    if ((c & 0xc0) == 0x40) {
      if (left < 2) return 1;
      c = p[k + 1];
      k += 2;
      left -= 2;
    }
    if ((c & 0xe0) == 0x20) {
      if (left < 4) return 1;
      *pts = *dts = pes_timestamp(p + k - 1);
      k += 4;
      left -= 4;
      if (c & 0x10) {
        if (left < 5) return 1;
        *dts = pes_timestamp(p + k);
        k += 5;
        left -= 5;
      }
    } else if ((c & 0xc0) == 0x80) {
      if (left < 2) return 1;
      const int flags = p[k], hlen = p[k + 1];
      k += 2;
      left -= 2;
      if (size_t(hlen) > left) return 1;
      if ((flags & 0x80) && hlen >= 5) {
        *pts = *dts = pes_timestamp(p + k);
        if ((flags & 0x40) && hlen >= 10) *dts = pes_timestamp(p + k + 5);
      }
      k += size_t(hlen);
      left -= size_t(hlen);
    } else if (c != 0xf) {
      *pts = *dts = kNoPts;
      return 1;
    }
    *payload = body + k;
    *len = left;
    return 1;
  }
}

}  // namespace

int demux_mpeg_ps_fd(int fd, const uint8_t* mem, uint64_t size, Track* track, std::string* msg,
                     PictureSink* sink) {
  BlockReader in{fd, mem, size};
  track->es_codec = kEsMpeg12;
  MpegEsSplitter split(kEsMpeg12, 90000, sink);
  int video_id = -1;
  uint64_t pos = 0, start = 0, payload = 0;
  size_t len = 0;
  int64_t es = 0, pts = kNoPts, dts = kNoPts;
  // The pieces: the PES packet each picture starts in. ``recent`` holds the
  // packets from the one the next picture starts in (the split's pending
  // offset) on, with their payload sizes.
  std::vector<std::pair<EsPiece, int64_t>> recent;
  size_t seen = 0;
  auto keep = [&](int64_t o) {
    for (const auto& q : recent)
      if (q.first.es_offset <= o && o < q.first.es_offset + q.second) {
        if (track->pieces.empty() || track->pieces.back().es_offset < q.first.es_offset)
          track->pieces.push_back(q.first);
        return;
      }
  };
  int r;
  while ((r = ps_step(in, &pos, &video_id, &start, &payload, &len, &pts, &dts)) != 0) {
    if (r != 1 || len == 0) continue;
    const uint8_t* p = in.at(payload, len);
    if (!p) break;
    recent.push_back({{es, int64_t(start), 0}, int64_t(len)});
    split.feed(p, len, pts, dts, int64_t(start));
    es += int64_t(len);
    for (; seen < split.pictures(); seen++) keep(split.picture_offset(seen));
    const int64_t next = split.pending();
    size_t drop = 0;
    while (drop < recent.size() && recent[drop].first.es_offset + recent[drop].second <= next)
      drop++;
    recent.erase(recent.begin(), recent.begin() + long(drop));
  }
  keep(split.pending());  // the last picture, which the end of the stream hands on
  if (video_id < 0) {
    *msg = "no MPEG video stream in the program stream";
    return kInvalid;
  }
  track->container = kMpegPs;
  track->es_id = video_id;
  split.finish(size, track);
  if (track->samples.empty()) {
    *msg = "no pictures in the program stream";
    return kInvalid;
  }
  return kOk;
}

int demux_mpeg_es_fd(int fd, const uint8_t* mem, uint64_t size, Track* track, std::string* msg,
                     PictureSink* sink) {
  BlockReader in{fd, mem, size};
  track->es_codec = kEsMpeg12;
  MpegEsSplitter split(kEsMpeg12, 1200000, sink);
  // the raw demuxer's 1024-byte reads, without timestamps
  for (uint64_t pos = 0; pos < size; pos += 1024) {
    const size_t k = size_t(std::min<uint64_t>(1024, size - pos));
    const uint8_t* p = in.at(pos, k);
    if (!p) break;
    split.feed(p, k, kNoPts, kNoPts, int64_t(pos));
  }
  track->container = kMpegEs;
  track->pieces.push_back({0, 0, 0});
  split.finish(size, track);
  if (track->samples.empty()) {
    *msg = "no pictures in the elementary stream";
    return kInvalid;
  }
  return kOk;
}

bool ts_read_es(BlockReader* in, const Track& t, size_t piece, int64_t from, int64_t n,
                uint8_t* dst);

bool read_es(BlockReader* in, const Track& t, int64_t from, int64_t n, uint8_t* dst) {
  const auto& pieces = t.pieces;
  auto it = std::upper_bound(pieces.begin(), pieces.end(), from,
                             [](int64_t o, const EsPiece& q) { return o < q.es_offset; });
  if (it == pieces.begin() || from < 0 || n < 0) return false;
  --it;
  if (t.container == kMpegEs) {
    const uint8_t* p = in->at(uint64_t(from), size_t(n));
    if (!p) return false;
    memcpy(dst, p, size_t(n));
    return true;
  }
  if (t.container == kMpegTs) return ts_read_es(in, t, size_t(it - pieces.begin()), from, n, dst);
  // MPEG-PS: the walk from the packet the bytes start in
  uint64_t pos = uint64_t(it->file_offset), start = 0, payload = 0;
  size_t len = 0;
  int64_t at = it->es_offset, pts, dts, got = 0;
  int video_id = t.es_id, r;
  while (got < n && (r = ps_step(*in, &pos, &video_id, &start, &payload, &len, &pts, &dts)) != 0) {
    if (r != 1 || len == 0) continue;
    const int64_t lo = std::max(at, from), hi = std::min(at + int64_t(len), from + n);
    if (hi > lo) {
      const uint8_t* p = in->at(payload + uint64_t(lo - at), size_t(hi - lo));
      if (!p) return false;
      memcpy(dst + (lo - from), p, size_t(hi - lo));
      got += hi - lo;
    }
    at += int64_t(len);
  }
  return got == n;
}

}  // namespace video
