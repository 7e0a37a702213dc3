// MPEG transport stream (ISO/IEC 13818-1) demuxer for the host video stack,
// as libavformat 5.1's mpegts demuxer reads a file: 188-byte packets, the
// program association table (PID 0) and the first program's map table, the
// adaptation fields, and the PES packets of the map's first video stream
// reassembled from the packets that carry its PID (a packet with
// payload_unit_start begins one, the next such packet or the end of the
// file ends it), with their PTS and DTS. Stream types 0x01 and 0x02
// (MPEG-1/2 video) and 0x10 (MPEG-4 Part 2) are read; the PES packets go
// through the split and timestamps of ``MpegEsSplitter``
// (mpeg_ps_demux.cc). 192- and 204-byte packets and other video stream
// types are ROADMAP.md Queue 1 item 8b.

#include <algorithm>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "video.h"

namespace video {
namespace {

constexpr int kPacket = 188;
// libavformat's default probesize, the bytes its header scan reads
constexpr uint64_t kProbeSize = 5000000;

const char* stream_type_name(int t) {
  switch (t) {
    case 0x1b: return "H.264";
    case 0x24: return "HEVC";
    case 0x42: return "AVS";
    case 0xea: return "VC-1";
    case 0xd1: return "Dirac";
    case 0x33: return "VVC";
    default: return nullptr;
  }
}

// A PES packet being reassembled
struct Pes {
  std::vector<uint8_t> data;
  int64_t pos = -1;  // its first packet's position
};

// A PSI section being reassembled
struct Section {
  std::vector<uint8_t> data;
  bool open = false;
};

// A 188-byte packet: where it starts, its PID, payload_unit_start and its
// payload (null when it carries none)
struct TsPacket {
  uint64_t pos;
  int pid;
  bool start;
  const uint8_t* payload;
  size_t n;
};

// One step of the walk over the packets from ``*pos`` (a byte other than
// the sync byte is skipped): 0 at the end of the file, else 1 past a packet
// (its payload valid until the next read of ``in``).
int ts_step(BlockReader& in, uint64_t* pos, TsPacket* k) {
  while (*pos + kPacket <= in.size) {
    const uint8_t* p = in.at(*pos, kPacket);
    if (!p) return 0;
    if (p[0] != 0x47) {
      // lost sync: the next sync byte
      ++*pos;
      continue;
    }
    k->pos = *pos;
    *pos += kPacket;
    k->pid = ((p[1] & 0x1f) << 8) | p[2];
    k->start = p[1] & 0x40;
    k->payload = nullptr;
    k->n = 0;
    const int afc = (p[3] >> 4) & 3;
    if (!(afc & 1)) return 1;  // no payload
    size_t off = 4;
    if (afc & 2) off += 1 + size_t(p[4]);
    if (off >= size_t(kPacket)) return 1;
    k->payload = p + off;
    k->n = size_t(kPacket) - off;
    return 1;
  }
  return 0;
}

}  // namespace

// mpegts.c's analyze: the sync bytes at the most frequent offset modulo
// ``step``, less a tenth of those elsewhere past ten times as many (with
// ``probe``, only bytes whose packet would carry a payload or an adaptation
// field count; FFmpeg reads the PID of that test at the buffer's start)
int ts_analyze(const uint8_t* b, size_t n, int step, bool probe) {
  std::vector<int> stat(size_t(step), 0);
  int all = 0, best = 0;
  const int pid = n >= 3 ? ((b[1] << 8) | b[2]) & 0x1fff : 0;
  for (size_t i = 0; i + 3 < n; i++) {
    if (b[i] != 0x47) continue;
    if (probe && pid != 0x1fff && !(b[i + 3] & 0x30)) continue;
    const int x = ++stat[i % size_t(step)];
    all++;
    best = std::max(best, x);
  }
  return best - std::max(all - 10 * best, 0) / 10;
}

int mpegts_probe(const uint8_t* b, size_t n) {
  const int check = int(n / 204);
  if (!check) return 0;
  int sum = 0, maxscore = 0;
  for (int i = 0; i < check; i += 100) {
    const size_t left = size_t(std::min(check - i, 100));
    int score = 0;
    for (const int step : {188, 192, 204})
      score = std::max(score, ts_analyze(b + size_t(step) * size_t(i), size_t(step) * left,
                                         step, true));
    sum += score;
    maxscore = std::max(maxscore, score);
  }
  sum = sum * 10 / check;
  maxscore = maxscore * 10 / 100;
  if (check > 10 && sum > 6) return 100 + sum - 10;
  if (check >= 10 && (sum > 6 || maxscore > 6)) return 50 + sum - 10;
  return sum > 6 ? 2 : 0;
}

int demux_mpeg_ts_fd(int fd, const uint8_t* mem, uint64_t size, Track* track, std::string* msg,
                     PictureSink* sink) {
  BlockReader in{fd, mem, size};
  {
    // get_packet_size: 188, else 192 (M2TS) or 204, the size whose sync
    // bytes in the first 8 KiB outscore the median of the three (by 5 more
    // in a shorter file); none: the open fails
    const size_t n = size_t(std::min<uint64_t>(size, 8192));
    const uint8_t* h = in.at(0, n);
    const int s188 = h ? ts_analyze(h, n, 188, false) : 0,
              s192 = h ? ts_analyze(h, n, 192, false) : 0,
              s204 = h ? ts_analyze(h, n, 204, false) : 0;
    const int margin = std::max(std::min(s188, s192), std::min(std::max(s188, s192), s204)) +
                       (n < 8192 ? 5 : 0);
    if (s188 <= margin) {
      if (s192 > margin || s204 > margin) {
        *msg = "MPEG-TS with 192- or 204-byte packets: the port reads 188-byte packets; the "
               "rest is ROADMAP.md Queue 1 item 8b";
        return kUnsupported;
      }
      *msg = "not a video file";
      return kInvalid;
    }
  }
  int pmt_pid = -1, video_pid = -1;
  std::string other;  // a video stream type the port does not read
  std::vector<int> declared;  // the PIDs of the program maps' streams
  Section pat, pmt;
  Pes pes;
  std::unique_ptr<MpegEsSplitter> split;
  int64_t es = 0;

  auto emit = [&]() {
    if (pes.data.size() < 9 || !split) {
      pes = Pes();
      return;
    }
    const uint8_t* d = pes.data.data();
    int64_t pts = kNoPts, dts = kNoPts;
    size_t hdr = 0;
    if (d[0] == 0 && d[1] == 0 && d[2] == 1) {
      const int sid = d[3];
      if (sid == 0xbc || sid == 0xbe || sid == 0xbf || sid == 0xf0 || sid == 0xf1 ||
          sid == 0xff || sid == 0xf2 || sid == 0xf8) {
        hdr = 6;
      } else {
        const int flags = d[7], hlen = d[8];
        hdr = 9 + size_t(hlen);
        if ((flags & 0x80) && hlen >= 5 && hdr <= pes.data.size()) {
          pts = dts = pes_timestamp(d + 9);
          if ((flags & 0x40) && hlen >= 10) dts = pes_timestamp(d + 14);
        }
      }
    } else {
      pes = Pes();
      return;
    }
    if (hdr < pes.data.size()) {
      // the ES bytes' place in the file: the walk from the PES's first packet
      track->pieces.push_back({es, pes.pos, int64_t(hdr)});
      es += int64_t(pes.data.size() - hdr);
      split->feed(d + hdr, pes.data.size() - hdr, pts, dts, pes.pos);
    }
    pes = Pes();
  };

  // a section's bytes from table_id through the CRC: section_length + 3
  auto parse_pat = [&]() {
    const auto& s = pat.data;
    if (s.size() < 8 || s[0] != 0x00) return;
    const size_t len = std::min<size_t>(((s[1] & 0x0f) << 8) | s[2], s.size() - 3);
    if (len < 9) return;  // shorter than its fixed fields and the CRC
    for (size_t k = 8; k + 4 <= 3 + len - 4 && pmt_pid < 0; k += 4) {
      const int program = (s[k] << 8) | s[k + 1];
      if (program != 0) pmt_pid = ((s[k + 2] & 0x1f) << 8) | s[k + 3];
    }
  };
  auto parse_pmt = [&]() {
    const auto& s = pmt.data;
    if (s.size() < 16 || s[0] != 0x02 || video_pid >= 0) return;
    const size_t len = ((s[1] & 0x0f) << 8) | s[2];
    if (len < 13) return;  // shorter than its fixed fields and the CRC
    // the stream loop ends before the CRC, within the bytes there are
    const size_t end = std::min<size_t>(3 + len, s.size()) - 4;
    size_t k = 12 + (((s[10] & 0x0f) << 8) | s[11]);
    while (k + 5 <= end) {
      const int type = s[k], pid = ((s[k + 1] & 0x1f) << 8) | s[k + 2];
      const size_t info = ((s[k + 3] & 0x0f) << 8) | s[k + 4];
      declared.push_back(pid);
      if (type == 0x01 || type == 0x02 || type == 0x10) {
        video_pid = pid;
        track->es_codec = type == 0x10 ? kEsMpeg4 : kEsMpeg12;  // the header pass reads it
        split.reset(new MpegEsSplitter(type == 0x10 ? kEsMpeg4 : kEsMpeg12, 90000, sink));
        return;
      }
      if (other.empty() && stream_type_name(type)) other = stream_type_name(type);
      k += 5 + info;
    }
  };

  // No video stream in a program map of the scan (a stream cut after its
  // last repeat, a damaged map): libavformat then takes each PID that no
  // map declared and whose packets start a PES as a stream of its own
  // (auto_guess), a video stream id (0xE0-0xEF) as video whose codec it
  // probes from the payload
  bool auto_guess = false;
  auto guess = [&](const uint8_t* pay, size_t n, int pid) {
    if (n < 4 || pay[0] || pay[1] || pay[2] != 1 || (pay[3] & 0xf0) != 0xe0) return;
    if (std::find(declared.begin(), declared.end(), pid) != declared.end()) return;
    int codec = kEsMpeg12;
    for (size_t i = 0; i + 3 < n; i++)
      if (!pay[i] && !pay[i + 1] && pay[i + 2] == 1 &&
          (pay[i + 3] == 0xb6 || (pay[i + 3] & 0xf0) == 0x20))
        codec = kEsMpeg4;
    video_pid = pid;
    track->es_codec = codec;
    split.reset(new MpegEsSplitter(codec, 90000, sink));
  };
  // mpegts_read_header: a scan of the first probesize bytes for the
  // program tables, then the packets from the start of the file again (a
  // PES before the first PAT/PMT counts once its PID is known; the PES
  // buffers start empty, so the first PES whose start is seen is the
  // first read)
  uint64_t pos = 0;
  TsPacket k;
  for (bool scan : {true, false}) {
    pos = 0;
    auto_guess = !scan && video_pid < 0;
    while (ts_step(in, &pos, &k)) {
      if (scan && (video_pid >= 0 || k.pos >= kProbeSize)) break;
      if (!k.payload) continue;
      const uint8_t* pay = k.payload;
      const size_t n = k.n;
      const int pid = k.pid;
      if (pid == 0 || (pmt_pid >= 0 && pid == pmt_pid)) {
        Section& s = pid == 0 ? pat : pmt;
        if (k.start) {
          const size_t ptr = pay[0];
          if (1 + ptr >= n) continue;
          s.data.assign(pay + 1 + ptr, pay + n);
          s.open = true;
        } else if (s.open) {
          s.data.insert(s.data.end(), pay, pay + n);
        }
        if (s.open && s.data.size() >= 3 &&
            s.data.size() >= 3 + size_t(((s.data[1] & 0x0f) << 8) | s.data[2])) {
          s.open = false;
          if (pid == 0) parse_pat();
          else parse_pmt();
        }
        continue;
      }
      if (!scan && auto_guess && video_pid < 0 && k.start) guess(pay, n, pid);
      if (scan || video_pid < 0 || pid != video_pid) continue;
      if (k.start) {
        emit();
        pes.pos = int64_t(k.pos);
      } else if (pes.pos < 0) {
        continue;  // the middle of a PES whose start was not seen
      }
      pes.data.insert(pes.data.end(), pay, pay + n);
    }
  }
  emit();
  if (video_pid < 0) {
    if (!other.empty()) {
      *msg = other + " video in MPEG-TS: the port reads MPEG-1/2 and MPEG-4 Part 2 video in "
                     "MPEG-TS; " + other + " is ROADMAP.md Queue 1 item 8b";
      return kUnsupported;
    }
    *msg = "no video stream in the transport stream";
    return kInvalid;
  }
  track->container = kMpegTs;
  track->es_id = video_pid;
  track->psi_pid = pmt_pid;
  split->finish(size, track);
  if (track->samples.empty()) {
    *msg = "no pictures in the transport stream";
    return kInvalid;
  }
  return kOk;
}

// The walk of read_es over a TS: from piece ``i``'s first packet through
// the packets of the video PID, each piece's PES header skipped, to the next
// piece at each PES start.
bool ts_read_es(BlockReader* in, const Track& t, size_t i, int64_t from, int64_t n,
                uint8_t* dst) {
  const auto& pieces = t.pieces;
  uint64_t pos = uint64_t(pieces[i].file_offset);
  int64_t at = pieces[i].es_offset, skip = pieces[i].skip, got = 0;
  bool first = true;
  TsPacket k;
  while (got < n) {
    if (!ts_step(*in, &pos, &k)) return false;
    if (!k.payload || k.pid == 0 || k.pid == t.psi_pid || k.pid != t.es_id) continue;
    if (k.start && !first) {
      // the PES ends: the next piece (a PES the demuxer dropped has none)
      if (++i == pieces.size() || pieces[i].es_offset != at) return false;
      pos = uint64_t(pieces[i].file_offset);
      skip = pieces[i].skip;
      first = true;
      continue;
    }
    first = false;
    size_t use = k.n, off = 0;
    if (skip > 0) {
      off = size_t(std::min<int64_t>(skip, int64_t(use)));
      skip -= int64_t(off);
      use -= off;
    }
    const int64_t lo = std::max(at, from), hi = std::min(at + int64_t(use), from + n);
    if (hi > lo) {
      memcpy(dst + (lo - from), k.payload + off + (lo - at), size_t(hi - lo));
      got += hi - lo;
    }
    at += int64_t(use);
  }
  return true;
}

}  // namespace video
